// Kernel T26's device functions: the edge-edge contact terms, shared by
// T26's own launches (edge_terms.cu), the stabilization pass it adds to
// T8 (pt_tail.cu), and the terms it adds to T9's stage 2 (the force,
// tet_force_nodes.cu) and T10 (the operator under full coupling,
// ell_matvec.cu), as T23's are (pt_full.cuh).  T25's CCD (edge_ccd.cu)
// uses the closest-point parameters.
//
// Replaces (JAX): pies_tpu/collision/narrowphase.py:239-294
// _segment_closest_uv; pies_tpu/collision/batches.py:331-379
// _edge_edge_closest_disp, :381-420 project_edge_edge (with its sign
// quirk), :422-476 stabilize_edge_edge / stabilize_edge_edge_acc;
// pies_tpu/solver/assembly.py:305-318 the edge force (w A^T A p under full
// coupling, w A^T A (p - x) under recentered), :559-574 the edge blocks of
// the operator (full coupling).  A is the point-triangle differential
// matrix (ATA_DIFF4), w = 1e6 * mask.
//
// Every float operation follows the plain twins (collision/narrowphase.py
// segment_closest_uv, collision/batches.py edge_closest_disp,
// project_edge_edge, stabilize_edges, ata_rows; solver/assembly.py
// edge_force_rows, edge_operator_rows) in order, so with -fmad=false kernel
// and twin agree bit for bit.  A node adds its entries e = 4 i + a (column
// a of contact i) in T26's incidence, ascending: the order of the JAX
// package's scatters over edge_idx; the stabilization pass sums them in
// column-major order (a, then i), the order of its scatter over
// edge_idx.T.  A contact is recomputed by each of its four nodes.
//
// Ensembles: the kernels pass member b's view (EdgeTerms::member): its
// contacts [b] of [members, cap, 4], mask, count, T26's incidence rows [b]
// of [members, N + 1] and [members, 4 cap], its diagonal and inverse
// masses, all local to the member.
#pragma once

#include <cuda_runtime.h>

#include "nan_math.cuh"
#include "pt_full.cuh"

namespace pies {

constexpr float kWEdge = 1.0e6f;  // EdgeCollisionConstraint (CollisionConstraint.h:56)
constexpr int kEdgeFull = 1;      // EdgeTerms::mode: full coupling
constexpr int kEdgeQuirks = 2;    // EdgeTerms::mode: the reference's quirks

struct EdgeTerms {
  const int* edge_idx;    // [E, 4]: (a, b | c, d)
  const float* edge_mask;  // [E]
  const int* count;       // live contacts (device scalar)
  const int* row_start;   // [N + 1] T26's row-major incidence
  const int* entries;
  const float* ed;        // [N] the edges' diagonal (at nodes with entries)
  const float* inv_mass;
  int mode;
  float thickness;
  int cap;  // contact slots of a member

  // Member b's view, for n nodes a member (no-op without contacts).
  __device__ __forceinline__ EdgeTerms member(int b, int n) const {
    EdgeTerms m = *this;
    if (m.edge_idx == nullptr) return m;
    const size_t bb = b;
    m.edge_idx += bb * cap * 4;
    m.edge_mask += bb * cap;
    m.count += bb;
    m.row_start += bb * (n + 1);
    m.entries += bb * 4 * cap;
    if (m.ed != nullptr) m.ed += bb * n;
    m.inv_mass += bb * n;
    return m;
  }
};

__device__ __forceinline__ float edge_dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// x clamped to [0, 1], a NaN kept (torch.clamp, jnp.clip).
__device__ __forceinline__ float clamp01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// segment_closest_uv: the segments [0, ab] and [ac, ad].
__device__ __forceinline__ void segment_closest_uv(const float ab[3], const float ac[3],
                                                   const float ad[3], float* u_out,
                                                   float* v_out, bool* degenerate) {
  float cd[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) cd[d] = ad[d] - ac[d];
  const float ab_sq = edge_dot3(ab, ab), cd_sq = edge_dot3(cd, cd);
  const float ab_cd = edge_dot3(ab, cd), ac_ab = edge_dot3(ac, ab), ac_cd = edge_dot3(ac, cd);
  const float det = ab_sq * -cd_sq + ab_cd * ab_cd;
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  const float u_n = (ac_ab * -cd_sq + ab_cd * ac_cd) * inv_det;
  const float v_n = (ab_sq * ac_cd - ac_ab * ab_cd) * inv_det;
  const float u0 = 0.0f, u1 = ab_sq, v0 = ac_ab, v1 = edge_dot3(ad, ab);
  const bool flip0 = u0 > u1, flip1 = v0 > v1;
  const float u_lo = nan_min(u0, u1), u_hi = nan_max(u0, u1);
  const float v_lo = nan_min(v0, v1), v_hi = nan_max(v0, v1);
  const float mid = u_lo > v_lo ? (u_lo + v_hi) * 0.5f : (v_lo + u_hi) * 0.5f;
  const float u_mid =
      u_lo == u_hi ? 0.5f : (mid - u_lo) / (u_hi == u_lo ? 1.0f : u_hi - u_lo);
  const float v_mid =
      v_lo == v_hi ? 0.5f : (mid - v_lo) / (v_hi == v_lo ? 1.0f : v_hi - v_lo);
  const bool dis_a = u_lo >= v_hi, dis_b = v_lo >= u_hi;
  const float u_par =
      dis_a ? (flip0 ? 1.0f : 0.0f) : (dis_b ? (flip0 ? 0.0f : 1.0f) : u_mid);
  const float v_par =
      dis_a ? (flip1 ? 0.0f : 1.0f) : (dis_b ? (flip1 ? 1.0f : 0.0f) : v_mid);
  *degenerate = det == 0.0f;
  *u_out = clamp01(*degenerate ? u_par : u_n);
  *v_out = clamp01(*degenerate ? v_par : v_n);
}

// edge_closest_disp for a contact's rows q[4][3] and inverse masses im[4]:
// the activity, disp = (thickness - dist) n and the weights w[4].
__device__ __forceinline__ bool edge_closest_disp(const float q[4][3], const float im[4],
                                                  float thickness, bool quirks,
                                                  float disp[3], float w[4]) {
  float ab[3], ac[3], ad[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    ab[d] = q[1][d] - q[0][d];
    ac[d] = q[2][d] - q[0][d];
    ad[d] = q[3][d] - q[0][d];
  }
  float u, v;
  bool degenerate;
  segment_closest_uv(ab, ac, ad, &u, &v, &degenerate);
  if (quirks) {
    u = degenerate ? u : 0.0f;
    v = degenerate ? v : 0.0f;
  }
  float n[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) n[d] = u * ab[d] - (ac[d] + v * (ad[d] - ac[d]));
  const float dist = sqrtf(edge_dot3(n, n));
  const float dn = max_keep_nan(dist, 1e-20f);
  const float iu = 1.0f - u, iv = 1.0f - v;
  const float s =
      ((im[0] * (iu * iu) + im[1] * (u * u)) + im[2] * (iv * iv)) + im[3] * (v * v);
#pragma unroll
  for (int d = 0; d < 3; ++d) disp[d] = (thickness - dist) * (n[d] / dn);
  const float inv_s = 1.0f / max_keep_nan(s, 1e-20f);
  w[0] = (im[0] * iu) * inv_s;
  w[1] = (im[1] * u) * inv_s;
  w[2] = (im[2] * iv) * inv_s;
  w[3] = (im[3] * v) * inv_s;
  return dist < thickness && s > 0.0f;
}

__device__ __forceinline__ void gather_edge(const float* __restrict__ x, const int* idx,
                                            const float* __restrict__ inv_mass, float q[4][3],
                                            float im[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int d = 0; d < 3; ++d) q[c][d] = x[(size_t)idx[c] * 3 + d];
    im[c] = inv_mass[idx[c]];
  }
}

// project_edge_edge: q becomes the projection (full coupling) or its
// displacement (recentered); quirk mode keeps the reference's sign.
__device__ __forceinline__ void project_edge(float q[4][3], const float im[4], float thickness,
                                             bool quirks, bool stack) {
  float disp[3], w[4];
  const bool active = edge_closest_disp(q, im, thickness, quirks, disp, w);
  const float am = active ? 1.0f : 0.0f;
  const float sign = quirks ? -1.0f : 1.0f;
  const float sw[4] = {sign * w[0], sign * w[1], -sign * w[2], -sign * w[3]};
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float delta = (sw[c] * disp[d]) * am;
      q[c][d] = stack ? q[c][d] + delta : delta;
    }
}

// The stabilization values of contact i: rec[4][4] rows (push xyz, count)
// of its columns a = 0..3 (stabilize_edges).
__device__ __forceinline__ void stabilize_edge(const EdgeTerms& e, const float* __restrict__ x,
                                               int i, float rec[4][4]) {
  const int* idx = e.edge_idx + (size_t)i * 4;
  float q[4][3], im[4], disp[3], w[4];
  gather_edge(x, idx, e.inv_mass, q, im);
  const bool active = edge_closest_disp(q, im, e.thickness, (e.mode & kEdgeQuirks) != 0,
                                        disp, w);
  const float am = (active && e.edge_mask[i] > 0.0f) ? 1.0f : 0.0f;
  const float sgn[4] = {1.0f, 1.0f, -1.0f, -1.0f};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float sw = sgn[a] * w[a];
#pragma unroll
    for (int d = 0; d < 3; ++d) rec[a][d] = (sw * disp[d]) * am;
    rec[a][3] = am;
  }
}

// v_i += w (A^T A q)[a] over node i's edge entries: q the contact's rows
// of x (kForce = false: the operator), or under full coupling its stack
// projection and otherwise its displacement (kForce = true: the force).
// Nothing without live contacts.
template <bool kForce>
__device__ __forceinline__ void edge_add(const EdgeTerms& e, const float* __restrict__ x,
                                         int i, float v[3]) {
  if (e.count[0] <= 0) return;
  const int e1 = e.row_start[i + 1];
  for (int p = e.row_start[i]; p < e1; ++p) {
    const int ent = e.entries[p];
    const int k = ent >> 2, a = ent & 3;
    const int* idx = e.edge_idx + (size_t)k * 4;
    float q[4][3], im[4];
    gather_edge(x, idx, e.inv_mass, q, im);
    if (kForce)
      project_edge(q, im, e.thickness, (e.mode & kEdgeQuirks) != 0, (e.mode & kEdgeFull) != 0);
    float row[3];
    ata_row(a, q, row);
    const float w = kWEdge * e.edge_mask[k];
#pragma unroll
    for (int d = 0; d < 3; ++d) v[d] = v[d] + w * row[d];
  }
}

// Whether node i has edge entries.
__device__ __forceinline__ bool edge_incident(const EdgeTerms& e, int i) {
  return e.edge_idx != nullptr && e.row_start[i + 1] > e.row_start[i];
}

}  // namespace pies
