// Kernel T1: the per-tet strain + volume force, launched on its own.
//
// Replaces (JAX): pies_tpu/constraints/projections.py:311
// tet_force12_fused_cols (with _compute_d_flat and math3d.svd3x3_flat).
//
// On the main path it computes the first PD iteration's local step from the
// predicted positions; kernel T2 then runs the remaining iterations with the
// same device function in registers.  It is also the projections module's
// own parity check on the card.
//
// Bound: compute.  One thread per tet reads 48 bytes of positions and 120
// bytes of tet parameters, and does about 1.5k flops (8 Jacobi sweeps, the
// Gram-Schmidt completion, 10 volume-correction steps).  The design keeps
// everything in registers and reads the parameter columns coalesced
// ([9, C] and [12, C] rows: neighbouring threads read neighbouring words).
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): blockIdx.y
// is the member b; its nodes start at b*n, its latch is failed[2b] and its
// forces are out[b] of [members, 12, C]; the tet parameters are shared.
#include <cuda_runtime.h>

#include "tet_force.cuh"

namespace {

__global__ void __launch_bounds__(128)
    tet_force12_kernel(const float* __restrict__ x, pies::TetBatchPtrs b,
                       float* __restrict__ out, int c, int n,
                       const int* __restrict__ failed) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= c) return;
  const size_t member = blockIdx.y;
  if (failed != nullptr && failed[2 * member] != 0) return;
  x += member * n * 3;
  out += member * 12 * c;
  float p[4][3];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d) p[a][d] = x[(size_t)(4 * t + a) * 3 + d];
  pies::TetParams tp;
  pies::load_tet(b, t, tp);
  float f[12];
  pies::tet_force12(p, tp, f);
#pragma unroll
  for (int r = 0; r < 12; ++r) out[(size_t)r * c + t] = f[r];
}

}  // namespace

extern "C" int pies_tet_force12(const float* x, const float* qinv,
                                const float* g, const float* slo,
                                const float* shi, const float* sw,
                                const float* vlo, const float* vhi,
                                const float* vw, float* out, int c, int n,
                                const int* failed, int members, void* stream) {
  if (c > 0 && members > 0) {
    pies::TetBatchPtrs b{qinv, g, slo, shi, sw, vlo, vhi, vw, c};
    const int threads = 128;
    const dim3 blocks((c + threads - 1) / threads, members);
    tet_force12_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        x, b, out, c, n, failed);
  }
  return (int)cudaGetLastError();
}

// T1's compiled resources on the current device: out[0] registers a thread,
// out[1] local (spill and stack) bytes a thread, out[2] blocks of 128
// threads an SM keeps resident.  Returns a CUDA error code.
extern "C" int pies_tet_force12_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, (const void*)tet_force12_kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)tet_force12_kernel,
                                                      128, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = per_sm;
  return (int)err;
}
