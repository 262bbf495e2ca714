// Kernel T27's device functions: the PD node-node contacts over kernel
// T20's pair prefix (node_pairs.cu), shared by T27's own launches
// (node_contacts.cu) and the force term it adds to T9's stage 2
// (tet_force_nodes.cu).
//
// Replaces (JAX): pies_tpu/collision/broadphase.py:1975-2015
// detect_node_node_pairs (the pair prefix truncated to the cap: the first
// lim = min(count, cap) pairs are live), pies_tpu/collision/batches.py:
// 248-284 project_node_node and pies_tpu/solver/assembly.py:320-325 the
// pairs' force (w p per node, w = 1e5).
//
// T20 builds, per node, the pairs where it is the first node (a contiguous
// range of the i-major prefix: row_off) and those where it is the second
// (inc_pair[inc_start ...], ascending).  Live pairs are those below lim, a
// prefix of both lists.  The JAX package scatters nn_idx row-major (pair p,
// then its column) for the force and the diagonal, and nn_idx.T for the
// friction: the first is the two lists merged by pair, the second the
// first list then the second.  Every float operation follows the plain
// twins (collision/batches.py project_node_node, node_friction_pairs).
//
// Ensembles: the kernels pass member b's view (NodeTerms::member): its
// pair lists of `width` slots, incidence rows of N + 1, live count, radii
// and inverse masses, all local to the member.
#pragma once

#include <cuda_runtime.h>

#include "nan_math.cuh"

namespace pies {

constexpr float kWNodeNode = 1.0e5f;  // CollisionConstraint (CollisionConstraint.h:14)

struct NodeTerms {
  const int* pi;  // [NB] T20's i-major pair prefix
  const int* pj;
  const int* row_off;    // [N + 1] node n is the i of pairs row_off[n] ..
  const int* inc_start;  // [N + 1] and the j of pairs inc_pair[inc_start[n] ..]
  const int* inc_pair;
  const int* lim;  // live pairs (device scalar), min(count, cap)
  const float* radius;
  const float* inv_mass;
  int cap;
  int width;  // pair slots of a member's lists (pi, pj, inc_pair)

  // Member b's view, for n nodes a member (no-op without pairs).
  __device__ __forceinline__ NodeTerms member(int b, int n) const {
    NodeTerms m = *this;
    if (m.pi == nullptr) return m;
    const size_t bb = b, w = width;
    m.pi += bb * w;
    m.pj += bb * w;
    m.row_off += bb * (n + 1);
    m.inc_start += bb * (n + 1);
    m.inc_pair += bb * w;
    m.lim += bb;
    m.radius += bb * n;
    m.inv_mass += bb * n;
    return m;
  }
};

// Node n's live pairs: as the first node [*i0, *i1), as the second
// inc_pair[*j0, *j1).
__device__ __forceinline__ void node_lists(const int* row_off, const int* inc_start,
                                           const int* inc_pair, int lim, int n, int* i0,
                                           int* i1, int* j0, int* j1) {
  *i0 = row_off[n];
  const int ie = row_off[n + 1];
  *i1 = ie < lim ? ie : lim;
  if (*i1 < *i0) *i1 = *i0;
  *j0 = inc_start[n];
  int j = *j0;
  const int je = inc_start[n + 1];
  while (j < je && inc_pair[j] < lim) ++j;
  *j1 = j;
}

// project_node_node for pair p; writes the projection of its column c.
__device__ __forceinline__ void project_pair(const float* __restrict__ x, const float* radius,
                                             const float* inv_mass, int a_node, int b_node,
                                             int c, float out[3]) {
  float a[3], b[3], diff[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    a[d] = x[(size_t)a_node * 3 + d];
    b[d] = x[(size_t)b_node * 3 + d];
    diff[d] = b[d] - a[d];
  }
  const float dist_sq = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
  const float r = radius[a_node] + radius[b_node];
  const float ov = dist_sq < r * r ? 1.0f : 0.0f;
  const float dist = sqrtf(max_keep_nan(dist_sq, 0.0f));
  const float disp_len = r - dist;
  const float dd = max_keep_nan(dist, 1e-20f);
  float disp[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    disp[d] = dist > 1e-5f ? (disp_len * diff[d]) / dd : (d == 0 ? disp_len : 0.0f);
  const float w_sum = max_keep_nan(inv_mass[a_node] + inv_mass[b_node], 1e-20f);
  if (c == 0) {
    const float s = inv_mass[a_node] / w_sum;
#pragma unroll
    for (int d = 0; d < 3; ++d) out[d] = a[d] - (ov * disp[d]) * s;
  } else {
    const float s = inv_mass[b_node] / w_sum;
#pragma unroll
    for (int d = 0; d < 3; ++d) out[d] = b[d] + (ov * disp[d]) * s;
  }
}

// v_i += w p over node i's live pairs, in pair order (the force).
__device__ __forceinline__ void node_add(const NodeTerms& t, const float* __restrict__ x, int i,
                                         float v[3]) {
  const int lim = t.lim[0];
  if (lim <= 0) return;
  int i0, i1, j0, j1;
  node_lists(t.row_off, t.inc_start, t.inc_pair, lim, i, &i0, &i1, &j0, &j1);
  int pa = i0, pb = j0;
  while (pa < i1 || pb < j1) {
    const int qa = pa < i1 ? pa : 0x7fffffff;
    const int qb = pb < j1 ? t.inc_pair[pb] : 0x7fffffff;
    const bool first = qa < qb;
    const int p = first ? qa : qb;
    if (first) ++pa; else ++pb;
    float proj[3];
    project_pair(x, t.radius, t.inv_mass, t.pi[p], t.pj[p], first ? 0 : 1, proj);
#pragma unroll
    for (int d = 0; d < 3; ++d) v[d] = v[d] + kWNodeNode * proj[d];
  }
}

}  // namespace pies
