// Kernel T10: one application of the generic PD system on a shared-node
// tet mesh, one thread per node.
//
// Replaces (JAX): pies_tpu/solver/assembly.py:448 apply_system in its
// assembled-ELL form: the diagonal (mass/h^2 + static_diag) x (:470), the
// position pins p.w x[p.idx] (:488-490) and the strain + volume sum
// acc = sum_m coef[:, m] x[nbr[:, m]] in slot order (:503-512); and the
// p.Ap reduction of pies_tpu/solver/assembly.py:701 pcg_solve, fused as a
// per-block partial (cg_reduce.cuh).
//
// static_diag is the floor weight wf of kernel T3 (W_STATIC * count *
// active); the JAX package adds a zero point-triangle diagonal to it when
// self-contact is off, which changes nothing.  The pins come folded into a
// dense per-node weight (topology.pin_weights).
//
// Bound: device memory.  Per node it reads m = 15 neighbour ids and
// coefficients (120 bytes), x, mass, the floor and pin weights (24 bytes)
// and writes y (12 bytes): ~17 MB per apply at 110,592 nodes, ~5 us at
// 3.35 TB/s; the neighbours' x rows come from L2.  The ELL is stored
// slot-major ([m, N]) so that neighbouring threads read neighbouring words,
// and a row is a node, so there are no atomics and the order of every sum
// is the JAX package's.
#include <cuda_runtime.h>

#include "cg_reduce.cuh"

namespace {

__global__ void __launch_bounds__(pies::kCgBlock)
    ell_matvec_kernel(const float* __restrict__ x,
                      const float* __restrict__ mass,
                      const float* __restrict__ wf,
                      const float* __restrict__ pin_w,
                      const int* __restrict__ nbr,
                      const float* __restrict__ coef, int m,
                      float* __restrict__ y, float* __restrict__ part, int n,
                      float h2, const int* __restrict__ failed,
                      pies::CgGate gate) {
  __shared__ float sm[pies::kCgBlock];
  if (failed[0] != 0) return;
  float rz;
  if (!pies::cg_active(gate, sm, &rz)) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (i < n) {
    float xi[3], acc[3], yi[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) xi[d] = x[(size_t)i * 3 + d];
    const int j0 = nbr[i];
    const float c0 = coef[i];
#pragma unroll
    for (int d = 0; d < 3; ++d) acc[d] = c0 * x[(size_t)j0 * 3 + d];
    for (int s = 1; s < m; ++s) {
      const int j = nbr[(size_t)s * n + i];
      const float c = coef[(size_t)s * n + i];
#pragma unroll
      for (int d = 0; d < 3; ++d) acc[d] = acc[d] + c * x[(size_t)j * 3 + d];
    }
    const float dg = mass[i] / h2 + wf[i];
#pragma unroll
    for (int d = 0; d < 3; ++d) yi[d] = dg * xi[d];
    if (pin_w != nullptr) {
      const float pw = pin_w[i];
#pragma unroll
      for (int d = 0; d < 3; ++d) yi[d] = yi[d] + pw * xi[d];
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      yi[d] = yi[d] + acc[d];
      y[(size_t)i * 3 + d] = yi[d];
    }
    v = xi[0] * yi[0] + xi[1] * yi[1] + xi[2] * yi[2];
  }
  if (part != nullptr) {
    const float s = pies::block_sum(v, sm);
    if (threadIdx.x == 0) part[blockIdx.x] = s;
  }
}

}  // namespace

// y = A x; with `part` non-null also the per-block partials of x.y.  With
// `trips` non-null the launch is CG trip `trip` and is gated (cg_reduce.cuh).
extern "C" int pies_ell_matvec(const float* x, const float* mass,
                               const float* wf, const float* pin_w,
                               const int* nbr, const float* coef, int m,
                               float* y, float* part, int n, float h2,
                               const int* failed, const int* trips,
                               const float* prz, const float* prz0, int trip,
                               int early_exit, float rtol2, void* stream) {
  if (n > 0) {
    const int blocks = (n + pies::kCgBlock - 1) / pies::kCgBlock;
    pies::CgGate gate{trips, prz, prz0, blocks, trip, early_exit, rtol2};
    ell_matvec_kernel<<<blocks, pies::kCgBlock, 0, (cudaStream_t)stream>>>(
        x, mass, wf, pin_w, nbr, coef, m, y, part, n, h2, failed, gate);
  }
  return (int)cudaGetLastError();
}
