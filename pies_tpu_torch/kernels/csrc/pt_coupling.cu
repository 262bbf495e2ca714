// Kernel T7: point-triangle coupling of the PD iterations.
//
// Replaces (JAX): pies_tpu/solver/tetcols.py:194-260 pt_force_cols and the
// contact terms of substep_cols (:306-349), with solver/assembly.py:357-368
// point_tri_collision_diag and the point-triangle part of system_diag
// (:577-599).
//
// Once per substep (pies_pt_coupling_setup):
//  (a) the node incidence of the live contacts: entry e = a*cap + i is
//      column a of contact i; an atomic count per node, an exclusive scan
//      (compact.cuh), an atomic fill, and each node's list put in ascending
//      e by the node's first position ("leader") thread.  Ascending e is the
//      order in which the JAX package's CPU scatter of idx.T.reshape(-1)
//      adds, so every per-node sum below is that sum, with no float atomic;
//  (b) per leader: ptd = sum of w*mask*AtA[a][a] and the diagonal
//      ((m/h^2 + stiffness) + ptd) + floor, the JAX order; for the generic
//      path also the operator's dense diagonal floor + ptd (solver/pd.py:
//      81-99 static_diag), into an array the wrapper preset to the floor
//      weight.
// Per PD iteration (pies_pt_force): per leader, each incident contact's
// point push-out from the current iterate (recomputed per incident node, a
// contact has 4) and sum of (w*mask*AtA[a][0]) * delta; T2 then adds
// ptd*x + contact after the floor term.  Nodes without entries are not
// written: T2 reads neither array there.
//
// Everything exits at once when the failure latch (slot 0) is set or the
// device contact count is 0; launches cover the static 4*cap entries.
//
// Bound: bytes over the live contacts: per iteration 4 positions per
// incident entry and one force row per incident node.
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y is the member b, with its contacts [b] of [members,
// cap, 4] (node ids local to the member), its nodes from b*n, its latch
// failed[2b], and its own incidence: degrees, the scan (one segment per
// member, gated on the member's contact count), row_start [b] of [members,
// n + 1] and entries and nodes [b] of [members, 4 cap], all local to the
// member.  So each member's per-node sums are a single-scene run's.  The
// stiffness diagonal is shared.
#include <cuda_runtime.h>

#include "compact.cuh"

namespace {

constexpr float kWPointTri = 1.0e4f;  // CollisionConstraint.h:33
__constant__ float kAtaDiag[4] = {3.0f, 1.0f, 1.0f, 1.0f};
__constant__ float kAtaCol0[4] = {3.0f, -1.0f, -1.0f, -1.0f};

struct Pc {
  const int* pt_idx;
  const float* pt_mask;
  const int* pt_count;
  const float* mass;
  const float* stiffness;
  const float* wf;
  float* diag;
  int* deg;
  int* row_start;
  int* entries;
  int* nodes;
  float* ptd;
  float* static_diag;  // may be null
  const int* failed;
  int n, cap;
  float h2;
};

// The view of member blockIdx.y: every per-member array offset to its row.
__device__ __forceinline__ Pc member_view(Pc p) {
  const size_t b = blockIdx.y;
  p.pt_idx += b * p.cap * 4;
  p.pt_mask += b * p.cap;
  p.pt_count += b;
  p.mass += b * p.n;
  p.wf += b * p.n;
  p.diag += b * p.n;
  p.deg += b * p.n;
  p.row_start += b * (p.n + 1);
  p.entries += b * 4 * p.cap;
  p.nodes += b * 4 * p.cap;
  p.ptd += b * p.n;
  if (p.static_diag != nullptr) p.static_diag += b * p.n;
  p.failed += 2 * b;
  return p;
}

__device__ __forceinline__ bool live_entry(const Pc& p, int t, int* node) {
  if (p.failed[0] != 0 || t >= 4 * p.cap) return false;
  const int a = t / p.cap, i = t - a * p.cap;
  if (i >= p.pt_count[0]) return false;
  *node = p.pt_idx[(size_t)i * 4 + a];
  return true;
}

__global__ void __launch_bounds__(pies::kBlock) pc_degree_kernel(Pc p0) {
  const Pc p = member_view(p0);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int node;
  if (live_entry(p, t, &node)) atomicAdd(&p.deg[node], 1);
}

__global__ void __launch_bounds__(pies::kBlock) pc_fill_kernel(Pc p0) {
  const Pc p = member_view(p0);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int node;
  if (!live_entry(p, t, &node)) return;
  const int pos = p.row_start[node] + atomicSub(&p.deg[node], 1) - 1;
  p.entries[pos] = t;
  p.nodes[pos] = node;
}

// The leader of node n is the thread at position row_start[n].
__device__ __forceinline__ bool leader(const int* row_start, const int* nodes,
                                       int n_nodes, int t, int* node, int* len) {
  if (t >= row_start[n_nodes]) return false;
  *node = nodes[t];
  if (row_start[*node] != t) return false;
  *len = row_start[*node + 1] - t;
  return true;
}

__global__ void __launch_bounds__(pies::kBlock) pc_node_kernel(Pc p0) {
  const Pc p = member_view(p0);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (p.failed[0] != 0 || p.pt_count[0] == 0) return;
  int node, len;
  if (!leader(p.row_start, p.nodes, p.n, t, &node, &len)) return;
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
  float acc = 0.0f;
  for (int j = 0; j < len; ++j) {
    const int a = e[j] / p.cap, i = e[j] - a * p.cap;
    acc = acc + (kWPointTri * p.pt_mask[i]) * kAtaDiag[a];
  }
  p.ptd[node] = acc;
  p.diag[node] = ((p.mass[node] / p.h2 + p.stiffness[node]) + acc) + p.wf[node];
  if (p.static_diag != nullptr) p.static_diag[node] = p.wf[node] + acc;
}

struct Pf {
  const float* x;
  const int* pt_idx;
  const float* pt_mask;
  const int* pt_count;
  const int* row_start;
  const int* entries;
  const int* nodes;
  float* contact;
  const int* failed;
  int n, cap;
  float thickness;
};

__device__ __forceinline__ Pf member_view(Pf p) {
  const size_t b = blockIdx.y;
  p.x += b * p.n * 3;
  p.pt_idx += b * p.cap * 4;
  p.pt_mask += b * p.cap;
  p.pt_count += b;
  p.row_start += b * (p.n + 1);
  p.entries += b * 4 * p.cap;
  p.nodes += b * 4 * p.cap;
  p.contact += b * p.n * 3;
  p.failed += 2 * b;
  return p;
}

__global__ void __launch_bounds__(pies::kBlock) pc_force_kernel(Pf p0) {
  const Pf p = member_view(p0);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (p.failed[0] != 0 || p.pt_count[0] == 0) return;
  int node, len;
  if (!leader(p.row_start, p.nodes, p.n, t, &node, &len)) return;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 0; j < len; ++j) {
    const int ent = p.entries[t + j];
    const int a = ent / p.cap, i = ent - a * p.cap;
    const int* idx = p.pt_idx + (size_t)i * 4;
    float q[4][3];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d) q[c][d] = p.x[(size_t)idx[c] * 3 + d];
    float e1[3], e2[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      e1[d] = q[2][d] - q[1][d];
      e2[d] = q[3][d] - q[1][d];
    }
    float nx = e1[1] * e2[2] - e1[2] * e2[1];
    float ny = e1[2] * e2[0] - e1[0] * e2[2];
    float nz = e1[0] * e2[1] - e1[1] * e2[0];
    const float nn = sqrtf(nx * nx + ny * ny + nz * nz);
    const float inv = 1.0f / (nn < 1e-20f ? 1e-20f : nn);
    nx = nx * inv;
    ny = ny * inv;
    nz = nz * inv;
    const float ndp =
        nx * (q[0][0] - q[1][0]) + ny * (q[0][1] - q[1][1]) + nz * (q[0][2] - q[1][2]);
    const float disp = ndp < p.thickness ? p.thickness - ndp : 0.0f;
    const float w = (kWPointTri * p.pt_mask[i]) * kAtaCol0[a];
    acc[0] = acc[0] + w * (disp * nx);
    acc[1] = acc[1] + w * (disp * ny);
    acc[2] = acc[2] + w * (disp * nz);
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) p.contact[(size_t)node * 3 + d] = acc[d];
}

}  // namespace

extern "C" int pies_pt_coupling_setup(
    const int* pt_idx, const float* pt_mask, const int* pt_count, const float* mass,
    const float* stiffness, const float* wf, float* diag, int* deg, int* row_start,
    int* partial, int* entries, int* nodes, float* ptd, float* static_diag,
    const int* failed, int n, int cap, float h2, int members, void* stream) {
  if (n > 0 && cap > 0 && members > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    Pc p{pt_idx, pt_mask, pt_count, mass, stiffness, wf, diag, deg, row_start,
         entries, nodes, ptd, static_diag, failed, n, cap, h2};
    const dim3 blocks(pies::tiles(4 * cap), members);
    pc_degree_kernel<<<blocks, pies::kBlock, 0, s>>>(p);
    pies::exclusive_scan_i32(deg, row_start, n, partial, s, pt_count, members, 1);
    pc_fill_kernel<<<blocks, pies::kBlock, 0, s>>>(p);
    pc_node_kernel<<<blocks, pies::kBlock, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" int pies_pt_force(const float* x, const int* pt_idx, const float* pt_mask,
                             const int* pt_count, const int* row_start,
                             const int* entries, const int* nodes, float* contact,
                             const int* failed, int n, int cap, float thickness,
                             int members, void* stream) {
  if (n > 0 && cap > 0 && members > 0) {
    Pf p{x, pt_idx, pt_mask, pt_count, row_start, entries, nodes, contact, failed,
         n, cap, thickness};
    pc_force_kernel<<<dim3(pies::tiles(4 * cap), members), pies::kBlock, 0,
                      (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
