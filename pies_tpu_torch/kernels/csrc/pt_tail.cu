// Kernel T8: the contact part of a PD substep's tail.
//
// Replaces (JAX): pies_tpu/collision/batches.py:478-549 stabilize_point_tri
// / stabilize_point_tri_acc and pies_tpu/solver/pd.py:316-406 (the contact
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
// Bound: bytes over the live contacts (4 gathered rows and one 32-byte
// record per contact per pass; an edge contact 64 bytes of records): under
// a microsecond on the 500k soup's contact state (~2.4k contacts, 8,910
// incident nodes).  What holds it is latency: each stage is a chain of
// dependent gathers, and each stage must wait for the one before it, whose
// results it reads.  The earlier design was two launches a stage (10 on the
// main path), the contact stages over the static `cap` threads and the
// node stages over 4 cap threads, each testing whether it leads its node's
// entries: ~4 us a launch of launch and drain latency.
//
// This design: one cooperative launch a call (coop.cuh), a grid of G
// blocks a member all resident, at most one block an SM for all members (a
// thread for each of the main path's items).  The stages run in order
// inside it with a grid barrier between two.  Contacts are walked up to
// the device count, the point-triangle stages' nodes over T7's ascending
// list of incident nodes (node_list[: node_count]), the edge stages' over
// every node, each thread striding over its member's items.  A thread
// loads its first contact's corners, inverse masses and mask, and its
// first listed node's entries, floor flag and static projection, once a
// call, so that a stage is one round of gathers.  On the main path (4
// passes and the friction) that is 10 stages and 9 barriers, ~2.9 us a
// stage on an H100: the barrier and one round of gathers from L2 set it.
//
// Measured on an H100 and not kept (PERF.md §6), each slower: a
// thread-block cluster a member with the cluster's barrier; one barrier a
// pass, each contact's thread recomputing its corners' positions (more
// dependent gathers a thread a stage); no barrier, each contact and node
// waiting on progress flags of the items it reads (the polls and fences
// cost more than the barriers they replace).
//
// Everything exits at once when the failure latch (slot 0) is set, and
// each kind's stages when its device contact count is 0 (every thread
// still passes every barrier).
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): blockIdx.y
// (after member0) is the member b, with its nodes from b*n (x, prev, the
// static projection, the floor flags, the masses, the friction impulse),
// its contacts, T7's incidence and node list and the records [b] of their
// [members, ...] arrays, and its latch failed[2b]; with edge contacts (off
// the tet-column path) also its edge contacts, T26's incidence
// (EdgeTerms::member) and its edge records [b] of [members, 4 ecap, 4].
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "coop.cuh"
#include "edge_terms.cuh"

namespace {

constexpr int kRec = 8;  // a contact's record: point xyz, corner xyz, count
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 1;
constexpr int kKept = 4;  // a listed node's entries kept in registers

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
  const int* node_list;
  const int* node_count;
  pies::EdgeTerms edges;  // edge_idx null without edge contacts
  const float* nn_imp;  // may be null
  const float* inv_mass;
  const float* mass;
  const float* mask;
  float* rec;   // [cap, kRec]
  float* erec;  // [4 ecap, 4]: per edge entry, push xyz and count
  float* fric;
  float* acc;  // accumulate-only mode: f32[N, 4] sums and counts, or null
  const int* failed;
  int n, cap, ecap;
  float thickness, h, damping, gravity, friction, static_threshold;
  int member0;  // the member of blockIdx.y = 0 (a launch covers a chunk of them)
};

// The view of member member0 + blockIdx.y: every per-member array offset to
// its row.
__device__ __forceinline__ Pt member_view(Pt p) {
  const size_t b = p.member0 + blockIdx.y;
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
    p.node_list += b * 4 * p.cap;
    p.node_count += b;
  }
  p.edges = p.edges.member((int)b, p.n);
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

// A contact's invariants across the stages of a call: its corners and
// their inverse masses' shares, its mask.
struct Contact {
  int i, idx[4];
  float im0, w_tri, mask;
};

__device__ __forceinline__ Contact load_contact(const Pt& p, int i) {
  Contact ct;
  ct.i = i;
#pragma unroll
  for (int c = 0; c < 4; ++c) ct.idx[c] = p.pt_idx[(size_t)i * 4 + c];
  ct.im0 = p.inv_mass[ct.idx[0]];
  ct.w_tri = p.inv_mass[ct.idx[1]] + p.inv_mass[ct.idx[2]] + p.inv_mass[ct.idx[3]];
  ct.mask = p.pt_mask[i];
  return ct;
}

// The contact's stabilization record at its corners' positions q.
__device__ __forceinline__ void stab_record(const Pt& p, const Contact& ct, const float q[4][3],
                                            float* r) {
  float n[3];
  unit_normal(q, n);
  const float ndp = n[0] * (q[0][0] - q[1][0]) + n[1] * (q[0][1] - q[1][1]) +
                    n[2] * (q[0][2] - q[1][2]);
  const bool active = ndp < p.thickness && ct.mask > 0.0f;
  const float push = active ? p.thickness - ndp : 0.0f;
  const float w_sum = ct.im0 + ct.w_tri;
  const float inv_w = 1.0f / (w_sum < 1e-20f ? 1e-20f : w_sum);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float disp = push * n[d];
    r[d] = disp * (ct.im0 * inv_w);
    r[3 + d] = -disp * (ct.w_tri * inv_w);
  }
  r[6] = active ? 1.0f : 0.0f;
}

// The tail's velocity ((1-damping)(x-prev)/h + h f/m) mask with gravity
// f = (0, -g m mask, 0), as T4 computes it, plus the node-node friction's
// impulse when given, at the node's position x and previous position pr.
__device__ __forceinline__ void velocity(const Pt& p, int node, const float x[3],
                                         const float pr[3], float v[3]) {
  const float m = p.mask[node];
  const float keep = 1.0f - p.damping;
  const float f[3] = {0.0f, -p.gravity * p.mass[node] * m, 0.0f};
  const float im = p.inv_mass[node];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    v[d] = (keep * (x[d] - pr[d]) / p.h + p.h * f[d] * im) * m;
    if (p.nn_imp != nullptr) v[d] = v[d] + p.nn_imp[(size_t)node * 3 + d];
  }
}

// The contact's friction and restitution record at its corners' positions
// q and previous positions pr.
__device__ __forceinline__ void fric_record(const Pt& p, const Contact& ct, const float q[4][3],
                                            const float pr[4][3], float* r) {
  float v[4][3], n[3];
#pragma unroll
  for (int c = 0; c < 4; ++c) velocity(p, ct.idx[c], q[c], pr[c], v[c]);
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
  float w_sum = ct.im0 + ct.w_tri;
  w_sum = w_sum < 1e-20f ? 1e-20f : w_sum;
  const float restitution = 1.1f * ((vdn > 0.0f) ? 0.0f : vdn);
  const float mk = ct.mask;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float dv = (-fr * perp[d] - restitution * n[d]) * mk;
    r[d] = dv * (ct.im0 / w_sum);
    r[3 + d] = -dv * (ct.w_tri / w_sum);
  }
  r[6] = mk;
}

// A listed node's invariants: its entries' record offsets (column 0 the
// point's share, columns 1-3 the corners'; the first kKept of them), its
// floor snap and static projection.
struct Node {
  int node, start, len, rec[kKept];
  bool snap;
  float stat[3];
};

__device__ __forceinline__ int rec_offset(const Pt& p, int ent) {
  const int a = ent / p.cap, i = ent - a * p.cap;
  return i * kRec + (a == 0 ? 0 : 3);
}

__device__ __forceinline__ Node load_node(const Pt& p, int node) {
  Node nd;
  nd.node = node;
  nd.start = p.row_start[node];
  nd.len = p.row_start[node + 1] - nd.start;
#pragma unroll
  for (int j = 0; j < kKept; ++j)
    nd.rec[j] = j < nd.len ? rec_offset(p, p.entries[nd.start + j]) : 0;
  // (with edge contacts the snap follows their step: edge_node)
  nd.snap = p.edges.edge_idx == nullptr && p.floor_active[node] > 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) nd.stat[d] = p.stat[(size_t)node * 3 + d];
  return nd;
}

__device__ __forceinline__ void add_record(const Pt& p, int off, float acc[4]) {
  const float* r = p.rec + off;
  acc[0] = acc[0] + r[0];
  acc[1] = acc[1] + r[1];
  acc[2] = acc[2] + r[2];
  acc[3] = acc[3] + p.rec[off - off % kRec + 6];
}

// The node's records summed in entry order with their count.
__device__ __forceinline__ void node_sum(const Pt& p, const Node& nd, float acc[4]) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
#pragma unroll
  for (int j = 0; j < kKept; ++j)
    if (j < nd.len) add_record(p, nd.rec[j], acc);
  for (int j = kKept; j < nd.len; ++j) add_record(p, rec_offset(p, p.entries[nd.start + j]), acc);
}

__device__ __forceinline__ void load3(const float* a, int node, float v[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) v[d] = a[(size_t)node * 3 + d];
}

__device__ __forceinline__ void load4(const float* a, const int* idx, float q[4][3]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) load3(a, idx[c], q[c]);
}

// A stage's per-node sums: averaged into x and prev, with the
// floor snap; in accumulate-only mode written to acc instead.
__device__ __forceinline__ void stab_node(const Pt& p, const Node& nd) {
  float acc[4];
  node_sum(p, nd, acc);
  if (p.acc != nullptr) {
#pragma unroll
    for (int d = 0; d < 4; ++d) p.acc[(size_t)nd.node * 4 + d] = acc[d];
    return;
  }
  const float c = acc[3] < 1.0f ? 1.0f : acc[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const size_t j = (size_t)nd.node * 3 + d;
    const float delta = acc[d] / c;
    p.prev[j] = p.prev[j] + delta;
    p.x[j] = nd.snap ? nd.stat[d] : p.x[j] + delta;
  }
}

__device__ __forceinline__ void fric_node(const Pt& p, const Node& nd) {
  float acc[4];
  node_sum(p, nd, acc);
  if (p.acc != nullptr) {
#pragma unroll
    for (int d = 0; d < 4; ++d) p.acc[(size_t)nd.node * 4 + d] = acc[d];
    return;
  }
  const float c = acc[3] < 1.0f ? 1.0f : acc[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) p.fric[(size_t)nd.node * 3 + d] = acc[d] / c;
}

__device__ __forceinline__ void stab_contact(const Pt& p, const Contact& ct) {
  float q[4][3];
  load4(p.x, ct.idx, q);
  stab_record(p, ct, q, p.rec + (size_t)ct.i * kRec);
}

__device__ __forceinline__ void fric_contact(const Pt& p, const Contact& ct) {
  float q[4][3], pr[4][3];
  load4(p.x, ct.idx, q);
  load4(p.prev, ct.idx, pr);
  fric_record(p, ct, q, pr, p.rec + (size_t)ct.i * kRec);
}

// Edge contact i's four columns' stabilization records.
__device__ __forceinline__ void edge_stab(const Pt& p, int i) {
  float r[4][4];
  pies::stabilize_edge(p.edges, p.x, i, r);
  float* out = p.erec + (size_t)i * 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[a * 4 + c] = r[a][c];
}

// Node i's edge entries' records summed column by column (the edge_idx.T
// order), count-averaged into x and prev; then the floor snap at nodes
// with entries of either kind.
__device__ __forceinline__ void edge_node(const Pt& p, int i) {
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

// Every stage of a call in order, a grid barrier between two (the stages
// depend on the call's arguments only, so every thread passes the same
// barriers); a thread's first contact and first listed node keep their
// invariants in registers across the stages.
__global__ void __launch_bounds__(kThreads) pt_tail_kernel(Pt p0, int passes, int stages) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const Pt p = member_view(p0);
  const int first = blockIdx.x * blockDim.x + threadIdx.x, stride = gridDim.x * blockDim.x;
  const bool pt = p.pt_idx != nullptr, edge = p.edges.edge_idx != nullptr;
  const bool off = p.failed[0] != 0;
  const int count = pt && !off ? p.pt_count[0] : 0;
  const int listed = count > 0 ? p.node_count[0] : 0;
  const int ecount = edge && !off ? p.edges.count[0] : 0;
  const int enodes = edge && !off ? p.n : 0;
  const bool own_c = first < count, own_n = first < listed;
  Contact ct{};
  Node nd{};
  if (own_c) ct = load_contact(p, first);
  if (own_n) nd = load_node(p, p.node_list[first]);
  bool ran = false;
  if (stages & 1) {
    for (int k = 0; k < passes; ++k) {
      if (pt) {
        if (ran) grid.sync();
        ran = true;
        if (own_c) stab_contact(p, ct);
        for (int i = first + stride; i < count; i += stride) stab_contact(p, load_contact(p, i));
        grid.sync();
        if (own_n) stab_node(p, nd);
        for (int q = first + stride; q < listed; q += stride)
          stab_node(p, load_node(p, p.node_list[q]));
      }
      if (edge) {
        if (ran) grid.sync();
        ran = true;
        for (int i = first; i < ecount; i += stride) edge_stab(p, i);
        grid.sync();
        for (int i = first; i < enodes; i += stride) edge_node(p, i);
      }
    }
  }
  if ((stages & 2) && pt) {
    if (ran) grid.sync();
    if (own_c) fric_contact(p, ct);
    for (int i = first + stride; i < count; i += stride) fric_contact(p, load_contact(p, i));
    grid.sync();
    if (own_n) fric_node(p, nd);
    for (int q = first + stride; q < listed; q += stride)
      fric_node(p, load_node(p, p.node_list[q]));
  }
}

int resident[pies::kMaxDevices];

}  // namespace

extern "C" int pies_pt_tail(float* x, float* prev, const float* stat,
                            const float* floor_active, const int* pt_idx,
                            const float* pt_mask, const int* pt_count,
                            const int* row_start, const int* entries,
                            const int* node_list, const int* node_count, const int* edge_idx,
                            const float* edge_mask, const int* edge_count,
                            const int* e_row_start, const int* e_entries,
                            const float* nn_imp, const float* inv_mass, const float* mass,
                            const float* mask, float* rec, float* erec, float* fric, float* acc,
                            const int* failed, int n,
                            int cap, int ecap, int passes, int stages, int quirks,
                            float thickness, float h, float damping, float gravity,
                            float friction, float static_threshold, int members,
                            void* stream) {
  if (n <= 0 || cap < 0 || ecap < 0 || members <= 0) return (int)cudaErrorInvalidValue;
  const bool pt = pt_idx != nullptr && cap > 0, edge = edge_idx != nullptr && ecap > 0;
  if (pt && (node_list == nullptr || node_count == nullptr)) return (int)cudaErrorInvalidValue;
  const bool stab = (stages & 1) && passes > 0 && (pt || edge);
  if (!stab && !((stages & 2) && pt)) return (int)cudaGetLastError();  // (no stage to run)
  const pies::EdgeTerms edges{edge ? edge_idx : nullptr, edge_mask, edge_count, e_row_start,
                              e_entries, nullptr, inv_mass, quirks ? pies::kEdgeQuirks : 0,
                              thickness, ecap};
  Pt p{x,          prev,       stat,     floor_active, pt ? pt_idx : nullptr, pt_mask,
       pt_count,   row_start,  entries,  node_list,    node_count, edges,    nn_imp,
       inv_mass,   mass,       mask,     rec,          erec,       fric,     acc,
       failed,     n,          cap,      ecap,         thickness,  h,        damping,
       gravity,    friction,   static_threshold, 0};
  void* args[] = {&p, &passes, &stages};
  // A grid of G blocks a member, at most kBlocksPerSm an SM for all members
  // and at most a thread an item of the largest stage; members past what
  // one launch keeps resident in further launches, each over the next chunk.
  int items = 1;
  if (pt) items = std::max(items, std::max(cap, std::min(4 * cap, n)));
  if (edge) items = std::max(items, std::max(ecap, n));
  const void* kernel = (const void*)pt_tail_kernel;
  const int grid = pies::coop_blocks(kernel, kThreads, resident, members,
                                     (items + kThreads - 1) / kThreads, kBlocksPerSm);
  const int chunk = grid > 0 ? pies::coop_members(kernel, kThreads, resident, grid) : 0;
  if (chunk <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  for (; p.member0 < members; p.member0 += chunk) {
    const int rest = members - p.member0;
    const cudaError_t err = cudaLaunchCooperativeKernel(
        kernel, dim3(grid, rest < chunk ? rest : chunk), dim3(kThreads), args, 0,
        (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
