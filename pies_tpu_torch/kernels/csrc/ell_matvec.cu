// Kernel T10: one application of the generic PD system, one thread per
// node, over the assembled operator.
//
// Replaces (JAX): pies_tpu/solver/assembly.py:448 apply_system: the
// diagonal (mass/h^2 + static_diag) x (:470); the terms whose A^T A is the
// identity, folded into one weight per node (topology.static_weights): the
// position pins (:488-490), the bends (:547-549) and the shape and goal
// members (:551-554); and the off-diagonal terms, assembled on the host in
// float64 (topology.assemble_operator): the distance constraints' weighted
// graph Laplacian (:479-486, which the JAX package scatters per constraint)
// and the strain + volume sum acc = sum_m coef[:, m] x[nbr[:, m]] in slot
// order (:503-512, and :397 _tet_ata_flat where no ELL exists); and the
// p.Ap reduction of pies_tpu/solver/assembly.py:701 pcg_solve, fused as a
// per-block partial (cg_reduce.cuh).  On a banded (element-major) tet soup
// the tets are not in the assembled operator: their w G^T G is the seven
// diagonals `band` f32[7, N] of :493-502 (tet_band), applied as
// sum_d band[3 + d][i] x[i + d] with the wrap-around of jnp.roll, in the JAX
// order: the diagonal, then for d = 1, 2, 3 the +d term and the -d term.
//
// static_diag (`wf`) is the floor weight of kernel T3 (W_STATIC * count *
// active; kernel T24's per-entry sum on the entry-list floor), with the
// point-triangle contacts' diagonal added by kernel T7 where contacts are
// live (recentered coupling, :466-469).  Under full coupling the contacts'
// whole blocks are applied instead, after every other term (:559-574,
// kernel T23's device function pt_full_add), then the edge-edge contacts'
// (kernel T26's edge_add, edge_terms.cuh).  A pure tet soup off the
// tet-column path has the band and an ELL of width 0.
//
// The operator is ELL, slot-major ([m, N], so that neighbouring threads
// read neighbouring words; m = 0 for a scene with diagonal terms only),
// while no row has more than 64 entries, and CSR beyond (a row per thread,
// its columns ascending, as the ELL's slots are).  A row is a node, so
// there are no atomics and the order of every sum is fixed.
//
// Ensembles (apply_system under jax.vmap, pies_tpu/parallel/ensemble.py:41):
// blockIdx.y is the member b of `members`.  The operator (ELL or CSR), the
// static weight and the band are the shared topology's; b's x and y start
// at b*N*3, its mass and dense diagonal at b*N, its partials at b*P, its
// latch at failed[2b], and a CG trip passes b's own gate (cg_reduce.cuh).
// The point-triangle contacts' blocks under full coupling (T23) are b's own
// (PtFull::member), and so are the edge contacts' (T26, EdgeTerms::member).
//
// Bound: device memory.  Per node it reads m neighbour ids and
// coefficients (8 m bytes), x, mass, the floor and static weights (24
// bytes) and writes y (12 bytes): ~17 MB per apply at 110,592 nodes and
// m = 15, ~5 us at 3.35 TB/s; the neighbours' x rows come from L2.
#include <cuda_runtime.h>

#include "cg_reduce.cuh"
#include "edge_terms.cuh"
#include "pt_full.cuh"

namespace {

// kCsr: `nbr` and `coef` are the CSR columns and values and `row_start` the
// rows' starts; else they are the slot-major ELL of width m.
template <bool kCsr>
__global__ void __launch_bounds__(pies::kCgBlock)
    ell_matvec_kernel(const float* __restrict__ x,
                      const float* __restrict__ mass,
                      const float* __restrict__ wf,
                      const float* __restrict__ static_w,
                      const float* __restrict__ band,
                      const int* __restrict__ row_start,
                      const int* __restrict__ nbr,
                      const float* __restrict__ coef, int m,
                      float* __restrict__ y, float* __restrict__ part, int n,
                      float h2, const int* __restrict__ failed,
                      pies::CgGate all, pies::PtFull pt, pies::EdgeTerms et) {
  __shared__ float sm[pies::kCgBlock];
  const int mb = blockIdx.y;
  if (failed[2 * mb] != 0) return;
  const pies::CgGate gate = all.member(mb);
  float rz;
  if (!pies::cg_active(gate, sm, &rz)) return;
  x += (size_t)mb * n * 3, y += (size_t)mb * n * 3;
  mass += (size_t)mb * n, wf += (size_t)mb * n;
  if (part != nullptr) part += (size_t)mb * gridDim.x;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float v = 0.0f;
  if (i < n) {
    float xi[3], acc[3], yi[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) xi[d] = x[(size_t)i * 3 + d];
    acc[0] = acc[1] = acc[2] = 0.0f;
    // The first term starts the sum, the others are added in slot order.
    if (kCsr) {
      const int e0 = row_start[i], e1 = row_start[i + 1];
      for (int e = e0; e < e1; ++e) {
        const int j = nbr[e];
        const float c = coef[e];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float t = c * x[(size_t)j * 3 + d];
          acc[d] = e == e0 ? t : acc[d] + t;
        }
      }
    } else if (m > 0) {
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
    }
    const float dg = mass[i] / h2 + wf[i];
#pragma unroll
    for (int d = 0; d < 3; ++d) yi[d] = dg * xi[d];
    if (static_w != nullptr) {
      const float pw = static_w[i];
#pragma unroll
      for (int d = 0; d < 3; ++d) yi[d] = yi[d] + pw * xi[d];
    }
    if (band != nullptr) {
      float bacc[3];
      const float b0 = band[(size_t)3 * n + i];
#pragma unroll
      for (int d = 0; d < 3; ++d) bacc[d] = b0 * xi[d];
      for (int dd = 1; dd <= 3; ++dd) {
        const int up = i + dd < n ? i + dd : i + dd - n;
        const int dn = i - dd >= 0 ? i - dd : i - dd + n;
        const float bu = band[(size_t)(3 + dd) * n + i];
        const float bd = band[(size_t)(3 - dd) * n + i];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          bacc[d] = bacc[d] + bu * x[(size_t)up * 3 + d];
          bacc[d] = bacc[d] + bd * x[(size_t)dn * 3 + d];
        }
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) yi[d] = yi[d] + bacc[d];
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) yi[d] = yi[d] + acc[d];
    // Full contact coupling (kernel T23, pt_full.cuh): the contacts' blocks.
    if (pt.pt_idx != nullptr) pies::pt_full_add<false>(pt.member(mb, n), x, i, yi);
    if (et.edge_idx != nullptr) pies::edge_add<false>(et.member(mb, n), x, i, yi);  // T26
#pragma unroll
    for (int d = 0; d < 3; ++d) y[(size_t)i * 3 + d] = yi[d];
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
// With `row_start` non-null the operator is CSR, else ELL of width m; with
// `band` non-null the seven tet diagonals are applied before it; with
// `pt_idx` non-null (full contact coupling) the contacts' blocks after it,
// through T7's incidence (`pt_start`, `pt_entries`; each member's own), and
// with `edge_idx` non-null the edge contacts' blocks after those, through
// T26's (each member's own).
extern "C" int pies_ell_matvec(const float* x, const float* mass,
                               const float* wf, const float* static_w,
                               const float* band,
                               const int* row_start, const int* nbr,
                               const float* coef, int m,
                               float* y, float* part, int n, float h2,
                               const int* failed, const int* trips,
                               const float* prz, const float* prz0, int trip,
                               int early_exit, float rtol2, const int* pt_idx,
                               const float* pt_mask, const int* pt_count,
                               const int* pt_start, const int* pt_entries, int cap,
                               const int* edge_idx, const float* edge_mask,
                               const int* edge_count, const int* e_start,
                               const int* e_entries, const float* ed,
                               const float* e_inv_mass, int e_mode, float e_thickness,
                               int e_cap, int members, void* stream) {
  if (n > 0 && members > 0) {
    const dim3 blocks((n + pies::kCgBlock - 1) / pies::kCgBlock, members);
    pies::CgGate gate{trips, prz, prz0, (int)blocks.x, trip, early_exit, rtol2};
    pies::PtFull pt{pt_idx, pt_mask, pt_count, pt_start, pt_entries, cap, 0.0f};
    pies::EdgeTerms et{edge_idx, edge_mask, edge_count, e_start, e_entries, ed,
                       e_inv_mass, e_mode, e_thickness, e_cap};
    if (row_start != nullptr)
      ell_matvec_kernel<true><<<blocks, pies::kCgBlock, 0, (cudaStream_t)stream>>>(
          x, mass, wf, static_w, band, row_start, nbr, coef, m, y, part, n, h2,
          failed, gate, pt, et);
    else
      ell_matvec_kernel<false><<<blocks, pies::kCgBlock, 0, (cudaStream_t)stream>>>(
          x, mass, wf, static_w, band, row_start, nbr, coef, m, y, part, n, h2,
          failed, gate, pt, et);
  }
  return (int)cudaGetLastError();
}
