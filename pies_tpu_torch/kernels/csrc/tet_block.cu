// Kernel T22: the factor of the disjoint-tet block preconditioner of the
// generic path's CG, one thread per 4-node block, once per substep.
//
// Replaces (JAX): pies_tpu/solver/assembly.py:602 tet_block_factor, called
// from pies_tpu/solver/pd.py:140-147 when the block layout (tet_block6)
// covers the capacity: a tet soup off the tet-column path (full contact
// coupling, or tet_cols=False).  The solve with the factor,
// assembly.py:633 tet_block_apply, runs inside kernel T11's init and update
// stages (pcg.cu, tet_block.cuh's tet_block_precond), so a CG trip stays
// three launches.
//
// factors f32[10, K] (column-major: column c of block t at c*K + t) from
// the substep's full system diagonal diag f32[N] (mass/h^2 + stiffness +
// the contacts' and the floor's diagonals, after kernel T7's setup) and the
// static off-diagonals block6 f32[6, K].  Blocks of padding have zero
// off-diagonals: their factor is the plain diagonal's.
//
// Ensembles (the factor under jax.vmap, pies_tpu/parallel/ensemble.py:41):
// blockIdx.y is the member b of `members`; block6 is the shared topology's,
// b's diagonal starts at b*4K, its factors at b*10*K and its latch at
// failed[2b].
//
// Bound: device memory, 40 bytes read and 40 written per block (80 per 4
// nodes): ~2.5 MB and ~0.75 us at 500,000 nodes and 3.35 TB/s; ~40
// operations per block.
#include <cuda_runtime.h>

#include "tet_block.cuh"

namespace {

__global__ void __launch_bounds__(256)
    tet_block_factor_kernel(const float* __restrict__ diag,
                            const float* __restrict__ block6,
                            float* __restrict__ factors, int k,
                            const int* __restrict__ failed) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= k) return;
  const int mb = blockIdx.y;
  if (failed[2 * mb] != 0) return;
  diag += (size_t)mb * 4 * k;
  factors += (size_t)mb * pies::kTetBlockCols * k;
  float d[4], b6[6];
#pragma unroll
  for (int a = 0; a < 4; ++a) d[a] = diag[(size_t)4 * t + a];
#pragma unroll
  for (int r = 0; r < 6; ++r) b6[r] = block6[(size_t)r * k + t];
  const pies::TetBlock f = pies::tet_block_factor(d, b6);
  const float cols[pies::kTetBlockCols] = {f.l10, f.l20, f.l30, f.l21, f.l31,
                                          f.l32, f.i00, f.i11, f.i22, f.i33};
#pragma unroll
  for (int c = 0; c < pies::kTetBlockCols; ++c) factors[(size_t)c * k + t] = cols[c];
}

}  // namespace

extern "C" int pies_tet_block_factor(const float* diag, const float* block6,
                                     float* factors, int k, const int* failed,
                                     int members, void* stream) {
  if (k > 0 && members > 0) {
    const int threads = 256;
    const dim3 grid((k + threads - 1) / threads, members);
    tet_block_factor_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        diag, block6, factors, k, failed);
  }
  return (int)cudaGetLastError();
}
