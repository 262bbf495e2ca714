// Kernel T11: the vector stages of the generic path's Jacobi-PCG, one
// thread per node.
//
// Replaces (JAX): pies_tpu/solver/assembly.py:656 pcg_solve with the Jacobi
// preconditioner 1/diag (diag from system_diag :577, which kernel T3
// computes) or, on a disjoint tet soup, the block preconditioner
// precond_fn = tet_block_apply (:633; the factor is kernel T22's, the
// solve tet_block.cuh's, four lanes of a warp per block), the while_loop exit (i < cg_iterations) & (rz > rtol^2 rz0)
// (:711-720), the residual sqrt(sum r^2) (:725), and the mask re-select of
// pies_tpu/solver/pd.py:195.
//
// A solve is init, then cg_iterations trips of (T10 A.p, update,
// direction), all enqueued by the host with no sync:
//   init       r = b - A x0, z = M^-1 r, p = z, x = x0; partials of r.z
//              (twice: rz_0 is kept for the exit test) and r.r; trips = 0;
//   update     alpha = rz / max(pAp, 1e-30) if pAp > 0 else 0 from T10's
//              partials; x += alpha p where mask > 0 (the re-select, done
//              per trip: x is read by nothing else), r -= alpha Ap,
//              z = M^-1 r; partials of r.z (the other row of the pair)
//              and r.r;
//   direction  beta = rz_new / max(rz, 1e-30) if rz > 0 else 0; p = z +
//              beta p; block 0 writes trips = i + 1.
// Ranks (the domain CG of pies_tpu/parallel/domain.py:612-656, its dots
// psum'd over the devices): the stages run over this rank's P_r blocks of
// owned nodes, write their partials at `offset` = r P_r of buffers of
// `parts` = R P_r, and every total (the gate's r.z and rz_0, p.Ap, r.z_new)
// sums all `parts`: torch.distributed gathers each buffer in place between
// the stages (parallel/ranks.py), so every rank sums the same partials in
// the same order and leaves the loop at the same trip.  A single device has
// parts = P_r and offset 0.
//
// Every stage of a trip first evaluates the gate of cg_reduce.cuh, so the
// trips after the while_loop's exit change nothing and `trips` ends as the
// while_loop's trip count.  The residual partials are those of the last
// trip that ran.  With the latch (failed slot 0) set, init writes zero
// partials and every stage returns at once.
//
// Ensembles (pcg_solve under jax.vmap, pies_tpu/parallel/ensemble.py:41):
// blockIdx.y is the member b of `members`.  Its vectors start at b*N*3,
// its diag and mask at b*N, its block factors at b*10*(N/4), its partials
// at b*P (r.z at b*2*P), its trip count at trips[b] and its latch at
// failed[2b]; each member passes its own gate (cg_reduce.cuh), so its trip
// count and result are those of its single-scene solve.  A trip stays
// three launches at any member count.
//
// Bound: device memory, ~92 bytes per node for update and 36 for direction
// (x, r, z, p, Ap, diag, mask), ~14 MB per trip at 110,592 nodes with
// T10's ~17 MB.  The design keeps the three dot products in fixed-order
// block partials (no atomics) and puts alpha, beta and the exit test on
// the device, so a whole solve is one stream of launches.
#include <cuda_runtime.h>

#include "cg_reduce.cuh"
#include "tet_block.cuh"

namespace {

using pies::kCgBlock;

// z = M^-1 r at node i: the Jacobi 1/diag, or with `factors` (f32[10, K]
// from kernel T22) the disjoint-tet block solve.  Every thread of the
// block calls it (the block form trades rows between lanes).
__device__ __forceinline__ void precondition(const float* __restrict__ factors,
                                             const float* __restrict__ diag, int n,
                                             int i, const float ri[3], float zi[3]) {
  if (factors != nullptr) {
    pies::tet_block_precond(factors, n, i, ri, zi);
  } else if (i < n) {
    const float inv = 1.0f / diag[i];
#pragma unroll
    for (int d = 0; d < 3; ++d) zi[d] = inv * ri[d];
  }
}

__global__ void __launch_bounds__(kCgBlock)
    cg_init_kernel(const float* __restrict__ b, const float* __restrict__ y,
                   const float* __restrict__ x0,
                   const float* __restrict__ diag,
                   const float* __restrict__ factors, float* __restrict__ r,
                   float* __restrict__ z, float* __restrict__ p,
                   float* __restrict__ x, float* __restrict__ prz,
                   float* __restrict__ prz0, float* __restrict__ prr,
                   int* __restrict__ trips, int n,
                   const int* __restrict__ failed, int parts, int offset) {
  __shared__ float sm[kCgBlock];
  const int mb = blockIdx.y;
  const size_t v = (size_t)mb * n * 3, at = (size_t)offset + blockIdx.x;
  b += v, y += v, x0 += v, r += v, z += v, p += v, x += v;
  diag += (size_t)mb * n;
  if (factors != nullptr) factors += (size_t)mb * pies::kTetBlockCols * (n / 4);
  prz += (size_t)mb * 2 * parts, prz0 += (size_t)mb * parts, prr += (size_t)mb * parts;
  trips += mb;
  failed += 2 * mb;
  if (blockIdx.x == 0 && threadIdx.x == 0) *trips = 0;
  if (failed[0] != 0) {
    if (threadIdx.x == 0) prr[at] = prz[at] = prz0[at] = 0.0f;
    return;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float ri[3] = {0.0f, 0.0f, 0.0f}, zi[3] = {0.0f, 0.0f, 0.0f};
  if (i < n) {
#pragma unroll
    for (int d = 0; d < 3; ++d) ri[d] = b[(size_t)i * 3 + d] - y[(size_t)i * 3 + d];
  }
  precondition(factors, diag, n, i, ri, zi);
  float vz = 0.0f, vr = 0.0f;
  if (i < n) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const size_t j = (size_t)i * 3 + d;
      r[j] = ri[d];
      z[j] = zi[d];
      p[j] = zi[d];
      x[j] = x0[j];
    }
    vz = ri[0] * zi[0] + ri[1] * zi[1] + ri[2] * zi[2];
    vr = ri[0] * ri[0] + ri[1] * ri[1] + ri[2] * ri[2];
  }
  const float sz = pies::block_sum(vz, sm);
  const float sr = pies::block_sum(vr, sm);
  if (threadIdx.x == 0) {
    prz[at] = sz;
    prz0[at] = sz;
    prr[at] = sr;
  }
}

__global__ void __launch_bounds__(kCgBlock)
    cg_update_kernel(float* __restrict__ x, const float* __restrict__ p,
                     const float* __restrict__ ap, float* __restrict__ r,
                     float* __restrict__ z, const float* __restrict__ diag,
                     const float* __restrict__ factors,
                     const float* __restrict__ mask, float* prz,
                     const float* __restrict__ pap, float* __restrict__ prr,
                     int n, const int* __restrict__ failed,
                     pies::CgGate all) {
  __shared__ float sm[kCgBlock];
  const int mb = blockIdx.y;
  if (failed[2 * mb] != 0) return;
  const pies::CgGate gate = all.member(mb);
  float rz;
  if (!pies::cg_active(gate, sm, &rz)) return;
  const size_t v = (size_t)mb * n * 3;
  x += v, p += v, ap += v, r += v, z += v;
  diag += (size_t)mb * n, mask += (size_t)mb * n;
  if (factors != nullptr) factors += (size_t)mb * pies::kTetBlockCols * (n / 4);
  prz += (size_t)mb * 2 * gate.parts;
  pap += (size_t)mb * gate.parts, prr += (size_t)mb * gate.parts;
  const float p_ap = pies::finalize(pap, gate.parts, sm);
  const float alpha = p_ap > 0.0f ? rz / pies::max_keep_nan(p_ap, 1e-30f) : 0.0f;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float ri[3] = {0.0f, 0.0f, 0.0f}, zi[3] = {0.0f, 0.0f, 0.0f};
  if (i < n) {
    const bool live = mask[i] > 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const size_t j = (size_t)i * 3 + d;
      if (live) x[j] = x[j] + alpha * p[j];
      ri[d] = r[j] - alpha * ap[j];
      r[j] = ri[d];
    }
  }
  precondition(factors, diag, n, i, ri, zi);
  float vz = 0.0f, vr = 0.0f;
  if (i < n) {
#pragma unroll
    for (int d = 0; d < 3; ++d) z[(size_t)i * 3 + d] = zi[d];
    vz = ri[0] * zi[0] + ri[1] * zi[1] + ri[2] * zi[2];
    vr = ri[0] * ri[0] + ri[1] * ri[1] + ri[2] * ri[2];
  }
  const float sz = pies::block_sum(vz, sm);
  const float sr = pies::block_sum(vr, sm);
  if (threadIdx.x == 0) {
    const size_t at = (size_t)gate.offset + blockIdx.x;
    prz[(size_t)((gate.trip + 1) & 1) * gate.parts + at] = sz;
    prr[at] = sr;
  }
}

__global__ void __launch_bounds__(kCgBlock)
    cg_direction_kernel(float* __restrict__ p, const float* __restrict__ z,
                        int* trips, int n, const int* __restrict__ failed,
                        pies::CgGate all) {
  __shared__ float sm[kCgBlock];
  const int mb = blockIdx.y;
  if (failed[2 * mb] != 0) return;
  const pies::CgGate gate = all.member(mb);
  float rz;
  if (!pies::cg_active(gate, sm, &rz)) return;
  p += (size_t)mb * n * 3, z += (size_t)mb * n * 3;
  trips += mb;
  const float rz_new = pies::finalize(
      gate.prz + (size_t)((gate.trip + 1) & 1) * gate.parts, gate.parts, sm);
  const float beta = rz > 0.0f ? rz_new / pies::max_keep_nan(rz, 1e-30f) : 0.0f;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const size_t j = (size_t)i * 3 + d;
      p[j] = z[j] + beta * p[j];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *trips = gate.trip + 1;
}

inline dim3 grid_for(int n, int members) {
  return dim3((n + kCgBlock - 1) / kCgBlock, members);
}

// This launch's blocks fit at `offset` of `parts` partials.
inline bool parts_fit(dim3 grid, int parts, int offset) {
  return offset >= 0 && (long long)offset + grid.x <= (long long)parts;
}

}  // namespace

extern "C" int pies_cg_init(const float* b, const float* y, const float* x0,
                            const float* diag, const float* factors, float* r,
                            float* z, float* p,
                            float* x, float* prz, float* prz0, float* prr,
                            int* trips, int n, const int* failed,
                            int members, int parts, int offset, void* stream) {
  if (n > 0 && members > 0) {
    const dim3 grid = grid_for(n, members);
    if (!parts_fit(grid, parts, offset)) return (int)cudaErrorInvalidValue;
    cg_init_kernel<<<grid, kCgBlock, 0, (cudaStream_t)stream>>>(
        b, y, x0, diag, factors, r, z, p, x, prz, prz0, prr, trips, n, failed, parts, offset);
  }
  return (int)cudaGetLastError();
}

extern "C" int pies_cg_update(float* x, const float* p, const float* ap,
                              float* r, float* z, const float* diag,
                              const float* factors, const float* mask, float* prz,
                              const float* prz0, const float* pap, float* prr,
                              const int* trips, int n, int trip,
                              int early_exit, float rtol2, const int* failed,
                              int members, int parts, int offset, void* stream) {
  if (n > 0 && members > 0) {
    const dim3 grid = grid_for(n, members);
    if (!parts_fit(grid, parts, offset)) return (int)cudaErrorInvalidValue;
    pies::CgGate gate{trips, prz, prz0, parts, trip, early_exit, rtol2, offset};
    cg_update_kernel<<<grid, kCgBlock, 0, (cudaStream_t)stream>>>(
        x, p, ap, r, z, diag, factors, mask, prz, pap, prr, n, failed, gate);
  }
  return (int)cudaGetLastError();
}

extern "C" int pies_cg_direction(float* p, const float* z, const float* prz,
                                 const float* prz0, int* trips, int n,
                                 int trip, int early_exit, float rtol2,
                                 const int* failed, int members, int parts, int offset,
                                 void* stream) {
  if (n > 0 && members > 0) {
    const dim3 grid = grid_for(n, members);
    if (!parts_fit(grid, parts, offset)) return (int)cudaErrorInvalidValue;
    pies::CgGate gate{trips, prz, prz0, parts, trip, early_exit, rtol2, offset};
    cg_direction_kernel<<<grid, kCgBlock, 0, (cudaStream_t)stream>>>(
        p, z, trips, n, failed, gate);
  }
  return (int)cudaGetLastError();
}
