// Kernel T9: the tet local step and the force assembly of one PD iteration
// on the generic path, in two stages.
//
// Replaces (JAX): pies_tpu/constraints/projections.py:280
// tet_force12_fused and :210 tet_force12 with the gather of
// collision/batches.py:188 gather_cols (stage 1, on the device functions of
// kernel T1), and pies_tpu/solver/assembly.py:188 assemble_force on this
// path: the per-node sum of every family's scatter (:218-278), the pin force
// f + position_force_dense (:232-238) and the dense floor term
// f + wf p_static (:329-331), with collision/batches.py:216
// project_static_dense (stage 2).
//
// Stage 1, one thread per tet: gather the 4 corners through idx, compute
// the force (kind 0: strain + volume combined on shared tets; 1: strain
// alone; 2: volume alone), write it as rows k = a*C + t of blocks
// f32[4C, 3] (the JAX scatter's update layout; one 12-byte row per (tet,
// corner) for stage 2 to read).
// Stage 2, one thread per node: force = ((msn + pin) + the node's rows of
// the row buffer, added in ascending row index) + wf * static, with
// static = (x, max(y, plane), z) the floor projection (the plane is y = 0
// in quirk mode).  The buffer holds the rows of all families (distance,
// tets, bends, shape and goal members: kernels T12, T13 and stage 1 fill
// it) in assemble_force's order, each family's in its scatter's update
// order, so ascending index is the order in which the JAX package adds
// them; the node -> row incidence (topology.row_incidence) fixes it, so
// there are no float atomics and kernel and twin agree bit for bit.  (In
// the JAX package the pin force is added after the distance rows; here it
// comes first, folded into the start value.)  With point-triangle contacts
// under recentered coupling (:288-303) a node with contact entries then adds
// kernel T7's contact force and the lag term ptd * x, in that order, before
// the floor term; the arrays are read nowhere else.  Under full coupling
// (:282-287) a node adds instead w A^T A p over its contact entries, p the
// stack projection (kernel T23's device function, pt_full.cuh).  With
// edge-edge contacts (kernel T26, edge_terms.cuh; :305-318) a node with
// edge entries adds ed * x to the lag term off full coupling (the lag is
// (ptd + ed) x, pd.py:91-99), then, after the point-triangle terms, each
// entry's w A^T A q (q the stack projection under full coupling, its
// displacement otherwise); with node-node contacts (kernel T27,
// node_contacts.cuh; :320-325) then each live pair's w p.  On the
// entry-list floor (:332-334) the floor term is w * static per corner entry
// (kernel T24's, floor_entries.cuh) instead of wf * static.
//
// Ensembles (the local step and assemble_force under jax.vmap,
// pies_tpu/parallel/ensemble.py:41): blockIdx.y is the member b of
// `members`.  The tets, the row incidence and the pin force are the shared
// topology's; b's positions, inertia term, force and static projection
// start at b*N*3, its floor weight at b*N, its rows at b*S*3 (S the row
// buffer's member stride, which stage 1 writes a part of) and its latch at
// failed[2b].  The point-triangle terms are per member too: T7's force
// [b] of [members, N, 3], its lag ptd, incidence row_start and count at
// b*N, b*(N+1) and b, T23's contacts and incidence (PtFull::member), and
// the entry-list floor's static_mask row (FloorEntries::member); the corner
// incidence is shared.  So are the edge-edge and node-node terms: T26's
// contacts and incidence (EdgeTerms::member) and T27's pair lists
// (NodeTerms::member) are b's own.
//
// Bound: device memory.  The function needs the tet ids and 27 parameter
// floats per tet (124 B; ~77 MB at 622,938 tets) and 52 B per node (x, msn
// and wf read, force and static written; ~5.8 MB at 110,592 nodes), plus
// the dense pin force when there are pins: ~83 MB, ~25 us at 3.35 TB/s.
// The ~1.5k float32 operations per tet take ~14 us at 67 TFLOP/s.  Stage
// 1's corner gathers hit L2 (x is 1.3 MB) and its parameter reads are
// coalesced ([9, C] and [12, C] rows); the incidence (~10 MB read) and
// the 30 MB blocks round trip between the stages are the design's extra
// cost.
#include <cuda_runtime.h>

#include "edge_terms.cuh"
#include "floor_entries.cuh"
#include "node_contacts.cuh"
#include "pt_full.cuh"
#include "tet_force.cuh"

namespace {

__global__ void __launch_bounds__(128)
    tet_force12_gather_kernel(const float* __restrict__ x,
                              const int* __restrict__ idx,
                              pies::TetBatchPtrs b, float* __restrict__ blocks,
                              int c, int kind,
                              const int* __restrict__ failed, int n,
                              int stride) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= c) return;
  const int mb = blockIdx.y;
  if (failed[2 * mb] != 0) return;
  x += (size_t)mb * n * 3;
  blocks += (size_t)mb * stride * 3;
  const int4 q = reinterpret_cast<const int4*>(idx)[t];
  const int id[4] = {q.x, q.y, q.z, q.w};
  float p[4][3];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d) p[a][d] = x[(size_t)id[a] * 3 + d];
  pies::TetParams tp;
  pies::load_tet(b, t, tp);
  float f[12];
  if (kind == 0)
    pies::tet_force12(p, tp, f);
  else
    pies::tet_force12_single(p, tp, kind == 1, f);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d) blocks[((size_t)a * c + t) * 3 + d] = f[3 * a + d];
}

__global__ void __launch_bounds__(256)
    assemble_force_kernel(const float* __restrict__ x,
                          const float* __restrict__ msn,
                          const float* __restrict__ pin,
                          const float* __restrict__ wf,
                          const int* __restrict__ row_start,
                          const int* __restrict__ entries,
                          const float* __restrict__ blocks,
                          float* __restrict__ force, float* __restrict__ stat,
                          int n, int stride, float plane,
                          const int* __restrict__ failed,
                          const float* __restrict__ ptd,
                          const float* __restrict__ contact,
                          const int* __restrict__ pt_start,
                          const int* __restrict__ pt_count,
                          pies::PtFull full, pies::FloorEntries fl,
                          pies::EdgeTerms et, pies::NodeTerms nt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int mb = blockIdx.y;
  if (failed[2 * mb] != 0) return;
  const size_t v = (size_t)mb * n * 3;
  x += v, msn += v, force += v, stat += v;
  wf += (size_t)mb * n;
  blocks += (size_t)mb * stride * 3;
  if (ptd != nullptr) {
    ptd += (size_t)mb * n;
    contact += v;
    pt_start += (size_t)mb * (n + 1);
    pt_count += mb;
  }
  full = full.member(mb, n);
  fl = fl.member(mb);
  et = et.member(mb, n);
  nt = nt.member(mb, n);
  float f[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const size_t j = (size_t)i * 3 + d;
    f[d] = pin != nullptr ? msn[j] + pin[j] : msn[j];
  }
  const int e1 = row_start[i + 1];
  for (int e = row_start[i]; e < e1; ++e) {
    const size_t k = (size_t)entries[e] * 3;
#pragma unroll
    for (int d = 0; d < 3; ++d) f[d] = f[d] + blocks[k + d];
  }
  // The recentered coupling's contact force and lag term (ptd + ed) x.
  bool lag_on = false;
  float lag = 0.0f;
  if (ptd != nullptr && pt_count[0] > 0 && pt_start[i + 1] > pt_start[i]) {
#pragma unroll
    for (int d = 0; d < 3; ++d) f[d] = f[d] + contact[(size_t)i * 3 + d];
    lag = ptd[i];
    lag_on = true;
  }
  if (!(et.mode & pies::kEdgeFull) && pies::edge_incident(et, i)) {
    lag = lag + et.ed[i];
    lag_on = true;
  }
  if (lag_on) {
#pragma unroll
    for (int d = 0; d < 3; ++d) f[d] = f[d] + lag * x[(size_t)i * 3 + d];
  }
  // Full contact coupling (kernel T23, pt_full.cuh): the stacked force.
  if (full.pt_idx != nullptr) pies::pt_full_add<true>(full, x, i, f);
  if (et.edge_idx != nullptr) pies::edge_add<true>(et, x, i, f);  // kernel T26
  if (nt.pi != nullptr) pies::node_add(nt, x, i, f);  // kernel T27
  const float y = x[(size_t)i * 3 + 1];
  const float s[3] = {x[(size_t)i * 3], y < plane ? plane : y, x[(size_t)i * 3 + 2]};
  if (fl.start != nullptr) {
    pies::floor_entry_force(fl, i, s, f);  // the entry-list floor (T24)
  } else {
    const float w = wf[i];
#pragma unroll
    for (int d = 0; d < 3; ++d) f[d] = f[d] + w * s[d];
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const size_t j = (size_t)i * 3 + d;
    force[j] = f[d];
    stat[j] = s[d];
  }
}

}  // namespace

extern "C" int pies_tet_force12_gather(const float* x, const int* idx,
                                       const float* qinv, const float* g,
                                       const float* slo, const float* shi,
                                       const float* sw, const float* vlo,
                                       const float* vhi, const float* vw,
                                       float* blocks, int c, int kind,
                                       const int* failed, int n, int stride,
                                       int members, void* stream) {
  if (c > 0 && members > 0) {
    pies::TetBatchPtrs b{qinv, g, slo, shi, sw, vlo, vhi, vw, c};
    const int threads = 128;
    const dim3 grid((c + threads - 1) / threads, members);
    tet_force12_gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        x, idx, b, blocks, c, kind, failed, n, stride);
  }
  return (int)cudaGetLastError();
}

extern "C" int pies_assemble_force(const float* x, const float* msn,
                                   const float* pin, const float* wf,
                                   const int* row_start, const int* entries,
                                   const float* blocks, float* force,
                                   float* stat, int n, float plane,
                                   const int* failed, const float* ptd,
                                   const float* contact, const int* pt_start,
                                   const int* pt_count, const int* pt_idx,
                                   const float* pt_mask, const int* pt_entries,
                                   int cap, float thickness,
                                   const int* corner_start,
                                   const int* corner_entries,
                                   const float* static_mask, int n_entries,
                                   const int* edge_idx,
                                   const float* edge_mask, const int* edge_count,
                                   const int* e_start, const int* e_entries, const float* ed,
                                   const float* e_inv_mass, int e_mode, float e_thickness,
                                   int e_cap, const int* nn_pi, const int* nn_pj,
                                   const int* nn_row_off, const int* nn_inc_start,
                                   const int* nn_inc_pair, const int* nn_lim,
                                   const float* nn_radius, const float* nn_inv_mass, int nn_cap,
                                   int nn_width, int stride,
                                   int members, void* stream) {
  if (n > 0 && members > 0) {
    const int threads = 256;
    pies::PtFull full{pt_idx, pt_mask, pt_count, pt_start, pt_entries, cap, thickness};
    pies::FloorEntries fl{corner_start, corner_entries, static_mask, n_entries};
    pies::EdgeTerms et{edge_idx, edge_mask, edge_count, e_start, e_entries, ed,
                       e_inv_mass, e_mode, e_thickness, e_cap};
    pies::NodeTerms nt{nn_pi,  nn_pj,     nn_row_off,  nn_inc_start, nn_inc_pair,
                       nn_lim, nn_radius, nn_inv_mass, nn_cap,       nn_width};
    const dim3 grid((n + threads - 1) / threads, members);
    assemble_force_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        x, msn, pin, wf, row_start, entries, blocks, force, stat, n, stride, plane,
        failed, ptd, contact, pt_start, pt_count, full, fl, et, nt);
  }
  return (int)cudaGetLastError();
}
