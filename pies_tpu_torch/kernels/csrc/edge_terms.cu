// Kernel T26: the edge-edge contacts' setup, once per substep
// (StepConfig.enable_edge_collisions).  Its terms run as device functions
// (edge_terms.cuh) inside T8's stabilization passes, T9's stage 2 and T10.
//
// Replaces (JAX): pies_tpu/solver/assembly.py:371-380 edge_collision_diag
// and the edge part of system_diag (:577-598), with their places in
// pies_tpu/solver/pd.py:91-99 (the edges' diagonal in static_diag and in
// the lag term pt_diag off full coupling).
//
// Stages, back to back on one stream (as T7's, pt_coupling.cu):
//  (a) the node incidence of the live contacts: entry e = 4 i + a is column
//      a of contact i (the order of the JAX package's scatters over
//      edge_idx); an atomic count per node, an exclusive scan
//      (compact.cuh), an atomic fill, and each node's list put in ascending
//      e by the node's first position ("leader") thread;
//  (b) per leader: ed = sum of 1e6 mask (A^T A)_aa over its entries; the
//      system diagonal ((((m/h^2 + stiffness) + ptd) + each entry's term in
//      turn) + nnd) + floor, the JAX order (ptd where the node has
//      point-triangle entries, T7's; nnd where it has live node pairs,
//      T27's); the operator's dense diagonal (floor + nnd), plus (ptd + ed)
//      off full coupling, into the array T7 and T27 wrote.
// Nodes without entries are not written.
//
// Everything exits at once when the failure latch (slot 0) is set or the
// device contact count is 0; launches cover the static 4 cap entries.
//
// Bound: bytes over the live contacts: 16 bytes of indices and the mask
// per contact, and per incident node its incidence and five diagonals.
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y is the member b of `members`: its contacts and count,
// its nodes' masses and diagonals from b*n, T7's and T27's lists and
// results, its degree, incidence and diagonal rows and its latch
// (Es::member); the scan takes one segment per member.  The stiffness
// diagonal is the shared topology's.
#include <cuda_runtime.h>

#include "compact.cuh"
#include "edge_terms.cuh"
#include "node_contacts.cuh"

namespace {

__constant__ float kAtaDiag[4] = {3.0f, 1.0f, 1.0f, 1.0f};

struct Es {
  const int* edge_idx;
  const float* edge_mask;
  const int* count;
  const float* mass;
  const float* stiffness;
  const float* wf;
  float* diag;
  float* static_diag;  // may be null
  const int* pt_start;  // T7's incidence and count, may be null
  const int* pt_count;
  const float* ptd;
  const int* nn_row_off;  // T20's lists and T27's results, may be null
  const int* nn_inc_start;
  const int* nn_inc_pair;
  const int* nn_lim;
  const float* nnd;
  int* deg;
  int* row_start;
  int* entries;
  int* nodes;
  float* ed;
  const int* failed;
  int n, cap, full, nn_width;
  float h2;

  // The view of member b: every per-member array offset to its row.
  __device__ __forceinline__ Es member(int b) const {
    Es m = *this;
    const size_t bb = b, nn = n, c = cap;
    m.edge_idx += bb * c * 4;
    m.edge_mask += bb * c;
    m.count += bb;
    m.mass += bb * nn;
    m.wf += bb * nn;
    m.diag += bb * nn;
    if (m.static_diag != nullptr) m.static_diag += bb * nn;
    if (m.pt_start != nullptr) m.pt_start += bb * (nn + 1);
    if (m.pt_count != nullptr) m.pt_count += bb;
    if (m.ptd != nullptr) m.ptd += bb * nn;
    if (m.nn_lim != nullptr) {
      m.nn_row_off += bb * (nn + 1);
      m.nn_inc_start += bb * (nn + 1);
      m.nn_inc_pair += bb * (size_t)nn_width;
      m.nn_lim += bb;
      m.nnd += bb * nn;
    }
    m.deg += bb * nn;
    m.row_start += bb * (nn + 1);
    m.entries += bb * 4 * c;
    m.nodes += bb * 4 * c;
    m.ed += bb * nn;
    m.failed += 2 * bb;
    return m;
  }
};

__device__ __forceinline__ bool live_entry(const Es& p, int t, int* node) {
  if (p.failed[0] != 0 || t >= 4 * p.cap) return false;
  if ((t >> 2) >= p.count[0]) return false;
  *node = p.edge_idx[t];
  return true;
}

__global__ void __launch_bounds__(pies::kBlock) es_degree_kernel(Es p0) {
  const Es p = p0.member(blockIdx.y);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int node;
  if (live_entry(p, t, &node)) atomicAdd(&p.deg[node], 1);
}

__global__ void __launch_bounds__(pies::kBlock) es_fill_kernel(Es p0) {
  const Es p = p0.member(blockIdx.y);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int node;
  if (!live_entry(p, t, &node)) return;
  const int pos = p.row_start[node] + atomicSub(&p.deg[node], 1) - 1;
  p.entries[pos] = t;
  p.nodes[pos] = node;
}

__global__ void __launch_bounds__(pies::kBlock) es_node_kernel(Es p0) {
  const Es p = p0.member(blockIdx.y);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (p.failed[0] != 0 || p.count[0] == 0 || t >= p.row_start[p.n]) return;
  const int node = p.nodes[t];
  if (p.row_start[node] != t) return;
  const int len = p.row_start[node + 1] - t;
  int* e = p.entries + t;
  for (int i = 1; i < len; ++i) {  // ascending entry order
    const int v = e[i];
    int j = i - 1;
    while (j >= 0 && e[j] > v) {
      e[j + 1] = e[j];
      --j;
    }
    e[j + 1] = v;
  }
  const bool pt = p.pt_start != nullptr && p.pt_count[0] > 0 &&
                  p.pt_start[node + 1] > p.pt_start[node];
  float acc = p.mass[node] / p.h2 + p.stiffness[node];
  if (pt) acc = acc + p.ptd[node];
  float ed = 0.0f;
  for (int j = 0; j < len; ++j) {
    const float term = (pies::kWEdge * p.edge_mask[e[j] >> 2]) * kAtaDiag[e[j] & 3];
    ed = ed + term;
    acc = acc + term;
  }
  const float wf = p.wf[node];
  float sd = wf;
  if (p.nn_lim != nullptr) {
    int i0, i1, j0, j1;
    pies::node_lists(p.nn_row_off, p.nn_inc_start, p.nn_inc_pair, p.nn_lim[0], node, &i0, &i1,
                     &j0, &j1);
    if (i1 > i0 || j1 > j0) {
      acc = acc + p.nnd[node];
      sd = wf + p.nnd[node];
    }
  }
  p.ed[node] = ed;
  p.diag[node] = acc + wf;
  if (p.static_diag != nullptr) {
    if (!p.full) sd = sd + (pt ? p.ptd[node] + ed : ed);
    p.static_diag[node] = sd;
  }
}

}  // namespace

extern "C" int pies_edge_setup(const int* edge_idx, const float* edge_mask, const int* count,
                               const float* mass, const float* stiffness, const float* wf,
                               float* diag, float* static_diag, const int* pt_start,
                               const int* pt_count, const float* ptd, const int* nn_row_off,
                               const int* nn_inc_start, const int* nn_inc_pair,
                               const int* nn_lim, const float* nnd, int* deg, int* row_start,
                               int* partial, int* entries, int* nodes, float* ed,
                               const int* failed, int n, int cap, int full, int nn_width,
                               float h2, int members, void* stream) {
  if (n <= 0 || cap < 0 || nn_width < 0 || members <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Es p{edge_idx,  edge_mask,  count,        mass,        stiffness, wf,      diag,
       static_diag, pt_start, pt_count,     ptd,         nn_row_off, nn_inc_start,
       nn_inc_pair, nn_lim,   nnd,          deg,         row_start, entries, nodes,
       ed,        failed,     n,            cap,         full,      nn_width, h2};
  const dim3 blocks(pies::tiles(4 * cap), members);
  es_degree_kernel<<<blocks, pies::kBlock, 0, s>>>(p);
  pies::exclusive_scan_i32(deg, row_start, n, partial, s, nullptr, members);
  es_fill_kernel<<<blocks, pies::kBlock, 0, s>>>(p);
  es_node_kernel<<<blocks, pies::kBlock, 0, s>>>(p);
  return (int)cudaGetLastError();
}
