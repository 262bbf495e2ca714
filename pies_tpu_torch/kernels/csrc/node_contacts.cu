// Kernel T27: the PD node-node contacts (StepConfig.enable_node_collisions)
// over kernel T20's freshly built pair prefix.
//
// Replaces (JAX): pies_tpu/collision/broadphase.py:1975-2015
// detect_node_node_pairs (the cap of the pair prefix), pies_tpu/solver/
// assembly.py:382-394 node_node_diag with its places in pd.py:83-89
// (static_diag) and assembly.py:577-598 (system_diag), and pies_tpu/
// solver/pd.py:438-508 _node_node_friction / node_node_friction_acc (with
// the reference's static-branch sign, FIDELITY.md #18).  The projection,
// which T9's stage 2 adds to the force, is node_contacts.cuh's.
//
// Once per substep (pies_node_setup), a thread per node: lim = min(count,
// cap); at a node with live pairs the pairs' diagonal nnd = sum of 1e5 over
// its entries, the system diagonal (((m/h^2 + stiffness) + ptd) + nnd) +
// floor and the operator's dense diagonal (floor + nnd) + ptd (ptd, T7's,
// only where the node has point-triangle entries, and in the operator only
// off full coupling).  Kernel T26 then overwrites the nodes with edge
// entries, adding its own terms.
// In the tail (pies_node_friction): a thread per live pair, its friction
// impulses at the velocity the tail computes, ((1 - damping)(x - prev)/h +
// h f/m) mask, and the touching count (an integer atomic); then a thread
// per node, its impulses summed in the JAX package's nn_idx.T order (its
// pairs as the first node, then as the second) and count-averaged, written
// at every node (zero without a touching pair).  T8's point-triangle
// friction and T4 add it to the velocity.  In the accumulate-only mode
// (`acc` not null; the domain decomposition's node_node_friction_acc,
// pies_tpu/parallel/domain.py:932-942) the node stage writes the sums and
// the count, f32[N, 4], and averages nothing: the domain sums the slabs'
// accumulators across the halo first.
//
// Everything returns at once when the failure latch (slot 0) is set.
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y is the member b of `members`: its T20 lists (pairs of
// `width` slots, incidence rows of n + 1), its nodes' masses, radii,
// positions and diagonals from b*n, T7's incidence and count, its records,
// impulses, touching count and latch (Ns::member, Nf::member).  The
// stiffness diagonal is the shared topology's.
//
// Bound: bytes.  Setup reads T20's lists (~12 bytes per pair and node);
// the friction reads two nodes' positions, velocities' inputs and radii
// per pair (~80 bytes) and writes a 32-byte record, then 12 bytes per node.
#include <cuda_runtime.h>

#include "node_contacts.cuh"

namespace {

constexpr int kThreads = 256;

struct Ns {
  const int* pi;
  const int* count;
  const int* row_off;
  const int* inc_start;
  const int* inc_pair;
  const float* mass;
  const float* stiffness;
  const float* wf;
  float* diag;
  float* static_diag;  // may be null
  const int* pt_start;  // T7's incidence and count, may be null
  const int* pt_count;
  const float* ptd;
  int* lim;
  float* nnd;
  const int* failed;
  int n, cap, recentered, width;
  float h2;

  __device__ __forceinline__ Ns member(int b) const {
    Ns m = *this;
    const size_t bb = b, nn = n, w = width;
    m.pi += bb * w;
    m.count += bb;
    m.row_off += bb * (nn + 1);
    m.inc_start += bb * (nn + 1);
    m.inc_pair += bb * w;
    m.mass += bb * nn;
    m.wf += bb * nn;
    m.diag += bb * nn;
    if (m.static_diag != nullptr) m.static_diag += bb * nn;
    if (m.pt_start != nullptr) m.pt_start += bb * (nn + 1);
    if (m.pt_count != nullptr) m.pt_count += bb;
    if (m.ptd != nullptr) m.ptd += bb * nn;
    m.lim += bb;
    m.nnd += bb * nn;
    m.failed += 2 * bb;
    return m;
  }
};

__global__ void __launch_bounds__(kThreads) node_setup_kernel(Ns p0) {
  const Ns p = p0.member(blockIdx.y);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (p.failed[0] != 0) {
    if (i == 0) p.lim[0] = 0;
    return;
  }
  const int count = p.count[0];
  const int lim = count < p.cap ? count : p.cap;
  if (i == 0) p.lim[0] = lim;
  if (i >= p.n) return;
  int i0, i1, j0, j1;
  pies::node_lists(p.row_off, p.inc_start, p.inc_pair, lim, i, &i0, &i1, &j0, &j1);
  const int k = (i1 - i0) + (j1 - j0);
  if (k == 0) return;
  float nnd = 0.0f;
  for (int e = 0; e < k; ++e) nnd = nnd + pies::kWNodeNode;
  const bool pt = p.pt_start != nullptr && p.pt_count[0] > 0 &&
                  p.pt_start[i + 1] > p.pt_start[i];
  float base = p.mass[i] / p.h2 + p.stiffness[i];
  if (pt) base = base + p.ptd[i];
  p.nnd[i] = nnd;
  p.diag[i] = (base + nnd) + p.wf[i];
  if (p.static_diag != nullptr) {
    float sd = p.wf[i] + nnd;
    if (p.recentered && pt) sd = sd + p.ptd[i];
    p.static_diag[i] = sd;
  }
}

struct Nf {
  const float* x;
  const float* prev;
  const float* inv_mass;
  const float* mass;
  const float* mask;
  const float* radius;
  const int* pi;
  const int* pj;
  const int* row_off;
  const int* inc_start;
  const int* inc_pair;
  const int* lim;
  float* rec;  // [rows, 8]: a's impulse, b's impulse, touching
  float* imp;
  float* acc;  // accumulate-only mode: f32[N, 4], or null
  int* touching;
  const int* failed;
  int n, rows, width;
  float h, damping, gravity, friction, static_threshold;

  __device__ __forceinline__ Nf member(int b) const {
    Nf m = *this;
    const size_t bb = b, nn = n, w = width;
    m.x += bb * nn * 3;
    m.prev += bb * nn * 3;
    m.inv_mass += bb * nn;
    m.mass += bb * nn;
    m.mask += bb * nn;
    m.radius += bb * nn;
    m.pi += bb * w;
    m.pj += bb * w;
    m.row_off += bb * (nn + 1);
    m.inc_start += bb * (nn + 1);
    m.inc_pair += bb * w;
    m.lim += bb;
    m.rec += bb * rows * 8;
    m.imp += bb * nn * 3;
    if (m.acc != nullptr) m.acc += bb * nn * 4;
    m.touching += bb;
    m.failed += 2 * bb;
    return m;
  }
};

// The tail's velocity of a node (pd.base_velocity, T8's velocity()).
__device__ __forceinline__ void velocity(const Nf& p, int node, float v[3]) {
  const float m = p.mask[node];
  const float keep = 1.0f - p.damping;
  const float f[3] = {0.0f, -p.gravity * p.mass[node] * m, 0.0f};
  const float im = p.inv_mass[node];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const size_t j = (size_t)node * 3 + d;
    v[d] = (keep * (p.x[j] - p.prev[j]) / p.h + p.h * f[d] * im) * m;
  }
}

__device__ __forceinline__ float norm3(const float v[3]) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

__global__ void __launch_bounds__(kThreads) friction_pair_kernel(Nf p0) {
  const Nf p = p0.member(blockIdx.y);
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (p.failed[0] != 0 || q >= p.rows || q >= p.lim[0]) return;
  const int a = p.pi[q], b = p.pj[q];
  float diff[3], va[3], vb[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) diff[d] = p.x[(size_t)b * 3 + d] - p.x[(size_t)a * 3 + d];
  const float dist = norm3(diff);
  const bool touching = dist <= p.radius[a] + p.radius[b];
  const float dd = pies::max_keep_nan(dist, 1e-20f);
  float n[3], rel[3], perp[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) n[d] = diff[d] / dd;
  velocity(p, a, va);
  velocity(p, b, vb);
#pragma unroll
  for (int d = 0; d < 3; ++d) rel[d] = vb[d] - va[d];
  const float vdn = rel[0] * n[0] + rel[1] * n[1] + rel[2] * n[2];
#pragma unroll
  for (int d = 0; d < 3; ++d) perp[d] = rel[d] - vdn * n[d];
  const float fr = norm3(perp) < p.static_threshold ? -1.0f : p.friction;
  const float w_sum = pies::max_keep_nan(p.inv_mass[a] + p.inv_mass[b], 1e-20f);
  const float m = touching ? 1.0f : 0.0f;
  const float sa = p.inv_mass[a] / w_sum, sb = p.inv_mass[b] / w_sum;
  float* r = p.rec + (size_t)q * 8;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float fp = fr * perp[d];
    r[d] = (fp * sa) * m;
    r[3 + d] = (-fp * sb) * m;
  }
  r[6] = m;
  if (touching) atomicAdd(p.touching, 1);
}

__global__ void __launch_bounds__(kThreads) friction_node_kernel(Nf p0) {
  const Nf p = p0.member(blockIdx.y);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (p.failed[0] != 0 || i >= p.n) return;
  const int lim = p.lim[0] < p.rows ? p.lim[0] : p.rows;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (lim > 0) {
    int i0, i1, j0, j1;
    pies::node_lists(p.row_off, p.inc_start, p.inc_pair, lim, i, &i0, &i1, &j0, &j1);
    for (int q = i0; q < i1; ++q) {
      const float* r = p.rec + (size_t)q * 8;
      acc[0] = acc[0] + r[0];
      acc[1] = acc[1] + r[1];
      acc[2] = acc[2] + r[2];
      acc[3] = acc[3] + r[6];
    }
    for (int e = j0; e < j1; ++e) {
      const float* r = p.rec + (size_t)p.inc_pair[e] * 8;
      acc[0] = acc[0] + r[3];
      acc[1] = acc[1] + r[4];
      acc[2] = acc[2] + r[5];
      acc[3] = acc[3] + r[6];
    }
  }
  if (p.acc != nullptr) {
#pragma unroll
    for (int d = 0; d < 4; ++d) p.acc[(size_t)i * 4 + d] = acc[d];
    return;
  }
  const float c = acc[3] < 1.0f ? 1.0f : acc[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) p.imp[(size_t)i * 3 + d] = acc[d] / c;
}

inline int blocks(int n) { return n > 0 ? (n + kThreads - 1) / kThreads : 1; }

}  // namespace

extern "C" int pies_node_setup(const int* pi, const int* count, const int* row_off,
                               const int* inc_start, const int* inc_pair, const float* mass,
                               const float* stiffness, const float* wf, float* diag,
                               float* static_diag, const int* pt_start, const int* pt_count,
                               const float* ptd, int* lim, float* nnd, const int* failed,
                               int n, int cap, int recentered, int width, float h2, int members,
                               void* stream) {
  if (n <= 0 || cap < 0 || width < 0 || members <= 0) return (int)cudaErrorInvalidValue;
  Ns p{pi,       count,    row_off, inc_start, inc_pair, mass,   stiffness, wf,         diag,
       static_diag, pt_start, pt_count, ptd,   lim,      nnd,    failed,    n,          cap,
       recentered, width, h2};
  node_setup_kernel<<<dim3(blocks(n), members), kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int pies_node_friction(const float* x, const float* prev, const float* inv_mass,
                                  const float* mass, const float* mask, const float* radius,
                                  const int* pi, const int* pj, const int* row_off,
                                  const int* inc_start, const int* inc_pair, const int* lim,
                                  float* rec, float* imp, float* acc, int* touching,
                                  const int* failed,
                                  int n, int rows, int width, float h, float damping,
                                  float gravity, float friction, float static_threshold,
                                  int members, void* stream) {
  if (n <= 0 || rows < 0 || width < 0 || members <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Nf p{x,    prev,  inv_mass, mass, mask,   radius,  pi,       pj,      row_off,
       inc_start, inc_pair, lim, rec, imp, acc, touching, failed, n, rows, width, h, damping,
       gravity, friction, static_threshold};
  cudaMemsetAsync(touching, 0, (size_t)members * sizeof(int), s);
  if (rows > 0) friction_pair_kernel<<<dim3(blocks(rows), members), kThreads, 0, s>>>(p);
  friction_node_kernel<<<dim3(blocks(n), members), kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
