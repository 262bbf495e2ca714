// Kernel T8: the contact part of a PD substep's tail.
//
// Replaces (JAX): pies_tpu/collision/batches.py:478-549 stabilize_point_tri
// / stabilize_point_tri_acc and pies_tpu/solver/pd.py:330-406 (the contact
// branch of _finish_substep: stabilization passes with the floor snap
// between them) with :526-586 point_tri_friction_acc.  With edge-edge
// contacts each pass also runs kernel T26's edge stabilization
// (batches.py:422-476, edge_terms.cuh) between the point-triangle push-out
// and the snap.
//
// Stage 1, per stabilization pass: per contact, the mass-weighted push-out
// of the point and of the triangle's corners from the current positions
// (CollisionConstraint.cpp:126-162); per node, through T7's incidence (its
// entries in the JAX package's scatter order, no float atomics), the
// count-averaged sum added to x and prev, and without edge contacts the
// floor snap to the stale static projection.  With edge contacts: per edge
// contact, its four columns' push-out from the positions the point-triangle
// step left (CollisionConstraint.cpp:316-400); per node (every node), the
// count-averaged sum of its edge entries in the JAX package's edge_idx.T
// order (column, then contact) added to x and prev, then the snap at the
// nodes with entries of either kind.
// Stage 2: the same two steps for the friction and restitution impulses
// (Solver.cpp:431-471) at the velocity the tail computes, plus the
// node-node friction's impulse (kernel T27) when given; the count-averaged
// impulse goes to `fric`, which T4 adds before the floor friction.  Only
// nodes with contact entries are read or written; T4 snaps and updates the
// rest.
//
// Accumulate-only mode (`acc` not null, one pass, one kind; the domain
// decomposition's stabilize_point_tri_acc, stabilize_edge_edge_acc and
// point_tri_friction_acc, pies_tpu/parallel/domain.py:878-953): the
// chosen stage's per-node sums of its entries' records and their count go
// to acc f32[N, 4] (the caller zeroes it; only nodes with entries are
// written), and nothing is averaged, applied or snapped: the domain sums
// the slabs' accumulators across the halo before it averages.
//
// Everything exits at once when the failure latch (slot 0) is set, and
// each kind's stages when its device contact count is 0.
//
// Bound: bytes over the live contacts (4 gathered rows and one 32-byte
// record per contact per pass; an edge contact 64 bytes of records).
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y is the member b, with its nodes from b*n (x, prev,
// the static projection, the floor flags, the masses, the friction
// impulse), its contacts, T7's incidence and the records [b] of their
// [members, ...] arrays, and its latch failed[2b]; with edge contacts (off
// the tet-column path) also its edge contacts, T26's incidence
// (EdgeTerms::member) and its edge records [b] of [members, 4 ecap, 4].
#include <cuda_runtime.h>

#include "compact.cuh"
#include "edge_terms.cuh"

namespace {

constexpr int kRec = 8;  // per-contact record: point xyz, corner xyz, count

struct Pt {
  float* x;
  float* prev;
  const float* stat;
  const float* floor_active;
  const int* pt_idx;
  const float* pt_mask;
  const int* pt_count;
  const int* row_start;
  const int* entries;
  const int* nodes;
  pies::EdgeTerms edges;  // edge_idx null without edge contacts
  const float* nn_imp;  // may be null
  const float* inv_mass;
  const float* mass;
  const float* mask;
  float* rec;
  float* erec;  // [4 ecap, 4]: per edge entry, push xyz and count
  float* fric;
  float* acc;  // accumulate-only mode: f32[N, 4] sums and counts, or null
  const int* failed;
  int n, cap, ecap;
  float thickness, h, damping, gravity, friction, static_threshold;
};

// The view of member blockIdx.y: every per-member array offset to its row.
__device__ __forceinline__ Pt member_view(Pt p) {
  const size_t b = blockIdx.y;
  p.x += b * p.n * 3;
  p.prev += b * p.n * 3;
  p.stat += b * p.n * 3;
  p.floor_active += b * p.n;
  if (p.pt_idx != nullptr) {
    p.pt_idx += b * p.cap * 4;
    p.pt_mask += b * p.cap;
    p.pt_count += b;
    p.row_start += b * (p.n + 1);
    p.entries += b * 4 * p.cap;
    p.nodes += b * 4 * p.cap;
  }
  p.edges = p.edges.member(b, p.n);
  p.erec += b * p.ecap * 16;
  if (p.nn_imp != nullptr) p.nn_imp += b * p.n * 3;
  p.inv_mass += b * p.n;
  p.mass += b * p.n;
  p.mask += b * p.n;
  p.rec += b * p.cap * kRec;
  p.fric += b * p.n * 3;
  if (p.acc != nullptr) p.acc += b * p.n * 4;
  p.failed += 2 * b;
  return p;
}

__device__ __forceinline__ bool contact_live(const Pt& p, int i) {
  return p.pt_idx != nullptr && p.failed[0] == 0 && i < p.pt_count[0];
}

__device__ __forceinline__ void load4(const float* a, const int* idx, float q[4][3]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int d = 0; d < 3; ++d) q[c][d] = a[(size_t)idx[c] * 3 + d];
}

// n = (c-b) x (d-b) / max(|n|, 1e-20), one division per component.
__device__ __forceinline__ void unit_normal(const float q[4][3], float n[3]) {
  float e1[3], e2[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    e1[d] = q[2][d] - q[1][d];
    e2[d] = q[3][d] - q[1][d];
  }
  const float nx = e1[1] * e2[2] - e1[2] * e2[1];
  const float ny = e1[2] * e2[0] - e1[0] * e2[2];
  const float nz = e1[0] * e2[1] - e1[1] * e2[0];
  float nn = sqrtf(nx * nx + ny * ny + nz * nz);
  nn = nn < 1e-20f ? 1e-20f : nn;
  n[0] = nx / nn;
  n[1] = ny / nn;
  n[2] = nz / nn;
}

__global__ void __launch_bounds__(pies::kBlock) stab_contact_kernel(Pt p0) {
  const Pt p = member_view(p0);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.cap || !contact_live(p, i)) return;
  const int* idx = p.pt_idx + (size_t)i * 4;
  float q[4][3], n[3];
  load4(p.x, idx, q);
  unit_normal(q, n);
  const float ndp = n[0] * (q[0][0] - q[1][0]) + n[1] * (q[0][1] - q[1][1]) +
                    n[2] * (q[0][2] - q[1][2]);
  const bool active = ndp < p.thickness && p.pt_mask[i] > 0.0f;
  const float push = active ? p.thickness - ndp : 0.0f;
  const float im0 = p.inv_mass[idx[0]];
  const float w_tri = p.inv_mass[idx[1]] + p.inv_mass[idx[2]] + p.inv_mass[idx[3]];
  const float w_sum = im0 + w_tri;
  const float inv_w = 1.0f / (w_sum < 1e-20f ? 1e-20f : w_sum);
  float* r = p.rec + (size_t)i * kRec;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float disp = push * n[d];
    r[d] = disp * (im0 * inv_w);
    r[3 + d] = -disp * (w_tri * inv_w);
  }
  r[6] = active ? 1.0f : 0.0f;
}

// Per node: sum its entries' records in entry order (column 0 takes the
// point's share, columns 1-3 the corners') and their count.
__device__ __forceinline__ bool node_sum(const Pt& p, int t, int* node, float acc[4]) {
  if (p.pt_idx == nullptr || p.failed[0] != 0 || p.pt_count[0] == 0 || t >= p.row_start[p.n])
    return false;
  *node = p.nodes[t];
  if (p.row_start[*node] != t) return false;
  const int len = p.row_start[*node + 1] - t;
  acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
  for (int j = 0; j < len; ++j) {
    const int ent = p.entries[t + j];
    const int a = ent / p.cap, i = ent - a * p.cap;
    const float* r = p.rec + (size_t)i * kRec + (a == 0 ? 0 : 3);
    acc[0] = acc[0] + r[0];
    acc[1] = acc[1] + r[1];
    acc[2] = acc[2] + r[2];
    acc[3] = acc[3] + p.rec[(size_t)i * kRec + 6];
  }
  return true;
}

// node_sum averaged by the count; in accumulate-only mode the sums go to
// acc instead and it returns false.
__device__ __forceinline__ bool node_average(const Pt& p, int t, int* node, float avg[3]) {
  float acc[4];
  if (!node_sum(p, t, node, acc)) return false;
  if (p.acc != nullptr) {
#pragma unroll
    for (int d = 0; d < 4; ++d) p.acc[(size_t)*node * 4 + d] = acc[d];
    return false;
  }
  const float c = acc[3] < 1.0f ? 1.0f : acc[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) avg[d] = acc[d] / c;
  return true;
}

__global__ void __launch_bounds__(pies::kBlock) stab_node_kernel(Pt p0) {
  const Pt p = member_view(p0);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int node;
  float delta[3];
  if (!node_average(p, t, &node, delta)) return;
  // With edge contacts the snap follows their step (edge_node_kernel).
  const bool snap = p.edges.edge_idx == nullptr && p.floor_active[node] > 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const size_t j = (size_t)node * 3 + d;
    p.prev[j] = p.prev[j] + delta[d];
    p.x[j] = snap ? p.stat[j] : p.x[j] + delta[d];
  }
}

// Per edge contact: its four columns' stabilization records.
__global__ void __launch_bounds__(pies::kBlock) edge_stab_kernel(Pt p0) {
  const Pt p = member_view(p0);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.ecap || p.failed[0] != 0 || i >= p.edges.count[0]) return;
  float r[4][4];
  pies::stabilize_edge(p.edges, p.x, i, r);
  float* out = p.erec + (size_t)i * 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[a * 4 + c] = r[a][c];
}

// Per node: its edge entries' records summed column by column (the
// edge_idx.T order), count-averaged into x and prev; then the floor snap
// at nodes with entries of either kind.
__global__ void __launch_bounds__(pies::kBlock) edge_node_kernel(Pt p0) {
  const Pt p = member_view(p0);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n || p.failed[0] != 0) return;
  const pies::EdgeTerms& e = p.edges;
  const int s0 = e.row_start[i], s1 = e.row_start[i + 1];
  const bool e_on = s1 > s0;
  if (e_on) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int a = 0; a < 4; ++a)
      for (int q = s0; q < s1; ++q) {
        const int ent = e.entries[q];
        if ((ent & 3) != a) continue;
        const float* r = p.erec + (size_t)ent * 4;
        acc[0] = acc[0] + r[0];
        acc[1] = acc[1] + r[1];
        acc[2] = acc[2] + r[2];
        acc[3] = acc[3] + r[3];
      }
    if (p.acc != nullptr) {
#pragma unroll
      for (int d = 0; d < 4; ++d) p.acc[(size_t)i * 4 + d] = acc[d];
      return;
    }
    const float c = acc[3] < 1.0f ? 1.0f : acc[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const size_t j = (size_t)i * 3 + d;
      const float delta = acc[d] / c;
      p.prev[j] = p.prev[j] + delta;
      p.x[j] = p.x[j] + delta;
    }
  }
  if (p.acc != nullptr) return;
  const bool pt_on = p.pt_idx != nullptr && p.pt_count[0] > 0 &&
                     p.row_start[i + 1] > p.row_start[i];
  if ((e_on || pt_on) && p.floor_active[i] > 0.0f) {
#pragma unroll
    for (int d = 0; d < 3; ++d) p.x[(size_t)i * 3 + d] = p.stat[(size_t)i * 3 + d];
  }
}

// The tail's velocity ((1-damping)(x-prev)/h + h f/m) mask with gravity
// f = (0, -g m mask, 0), as T4 computes it, plus the node-node friction's
// impulse when given.
__device__ __forceinline__ void velocity(const Pt& p, int node, float v[3]) {
  const float m = p.mask[node];
  const float keep = 1.0f - p.damping;
  const float f[3] = {0.0f, -p.gravity * p.mass[node] * m, 0.0f};
  const float im = p.inv_mass[node];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const size_t j = (size_t)node * 3 + d;
    v[d] = (keep * (p.x[j] - p.prev[j]) / p.h + p.h * f[d] * im) * m;
    if (p.nn_imp != nullptr) v[d] = v[d] + p.nn_imp[j];
  }
}

__global__ void __launch_bounds__(pies::kBlock) fric_contact_kernel(Pt p0) {
  const Pt p = member_view(p0);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.cap || !contact_live(p, i)) return;
  const int* idx = p.pt_idx + (size_t)i * 4;
  float q[4][3], v[4][3], n[3];
  load4(p.x, idx, q);
#pragma unroll
  for (int c = 0; c < 4; ++c) velocity(p, idx[c], v[c]);
  unit_normal(q, n);
  float rel[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) rel[d] = v[0][d] - (v[1][d] + v[2][d] + v[3][d]) / 3.0f;
  const float vdn = rel[0] * n[0] + rel[1] * n[1] + rel[2] * n[2];
  float perp[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) perp[d] = rel[d] - vdn * n[d];
  const float perp_norm = sqrtf(perp[0] * perp[0] + perp[1] * perp[1] + perp[2] * perp[2]);
  const float fr = perp_norm < p.static_threshold ? 1.0f : p.friction;
  const float im0 = p.inv_mass[idx[0]];
  const float w_tri = p.inv_mass[idx[1]] + p.inv_mass[idx[2]] + p.inv_mass[idx[3]];
  float w_sum = im0 + w_tri;
  w_sum = w_sum < 1e-20f ? 1e-20f : w_sum;
  const float restitution = 1.1f * ((vdn > 0.0f) ? 0.0f : vdn);
  const float mk = p.pt_mask[i];
  float* r = p.rec + (size_t)i * kRec;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float dv = (-fr * perp[d] - restitution * n[d]) * mk;
    r[d] = dv * (im0 / w_sum);
    r[3 + d] = -dv * (w_tri / w_sum);
  }
  r[6] = mk;
}

__global__ void __launch_bounds__(pies::kBlock) fric_node_kernel(Pt p0) {
  const Pt p = member_view(p0);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int node;
  float impulse[3];
  if (!node_average(p, t, &node, impulse)) return;
#pragma unroll
  for (int d = 0; d < 3; ++d) p.fric[(size_t)node * 3 + d] = impulse[d];
}

}  // namespace

extern "C" int pies_pt_tail(float* x, float* prev, const float* stat,
                            const float* floor_active, const int* pt_idx,
                            const float* pt_mask, const int* pt_count,
                            const int* row_start, const int* entries,
                            const int* nodes, const int* edge_idx, const float* edge_mask,
                            const int* edge_count, const int* e_row_start,
                            const int* e_entries, const float* nn_imp,
                            const float* inv_mass, const float* mass, const float* mask,
                            float* rec, float* erec, float* fric, float* acc,
                            const int* failed, int n,
                            int cap, int ecap, int passes, int stages, int quirks,
                            float thickness, float h, float damping, float gravity,
                            float friction, float static_threshold, int members,
                            void* stream) {
  if (n <= 0 || cap < 0 || ecap < 0 || members <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool pt = pt_idx != nullptr && cap > 0, edge = edge_idx != nullptr && ecap > 0;
  const pies::EdgeTerms edges{edge ? edge_idx : nullptr, edge_mask, edge_count, e_row_start,
                              e_entries, nullptr, inv_mass, quirks ? pies::kEdgeQuirks : 0,
                              thickness, ecap};
  Pt p{x,        prev,     stat,    floor_active, pt_idx,   pt_mask, pt_count, row_start,
       entries,  nodes,    edges,   nn_imp,       inv_mass, mass,    mask,     rec,
       erec,     fric,     acc,     failed,       n,        cap,     ecap,     thickness, h,
       damping,  gravity,  friction, static_threshold};
  const dim3 bc(pies::tiles(cap), members), bn(pies::tiles(4 * cap), members);
  if (stages & 1) {
    for (int k = 0; k < passes; ++k) {
      if (pt) {
        stab_contact_kernel<<<bc, pies::kBlock, 0, s>>>(p);
        stab_node_kernel<<<bn, pies::kBlock, 0, s>>>(p);
      }
      if (edge) {
        edge_stab_kernel<<<dim3(pies::tiles(ecap), members), pies::kBlock, 0, s>>>(p);
        edge_node_kernel<<<dim3(pies::tiles(n), members), pies::kBlock, 0, s>>>(p);
      }
    }
  }
  if ((stages & 2) && pt) {
    fric_contact_kernel<<<bc, pies::kBlock, 0, s>>>(p);
    fric_node_kernel<<<bn, pies::kBlock, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
