// The point-triangle tests shared by the narrowphase kernels T6 and T15:
// phase 1's proximity / crossing decision per (corner, face) combo, phase 2's
// continuous test (the coplanarity cubic and the containment at its earliest
// root); and T15's proximity-first compaction of lanes.
//
// Replaces (JAX): pies_tpu/collision/narrowphase.py:39-207
// (point_triangle_ccd_cols, point_triangle_phase1_face,
// _barycentric_inside_c), ops/cubic.py (earliest_root_in_unit_interval and
// the closed-form cubic) and broadphase.py:1293 (_compact_pairs_prox_first).
//
// Every float operation follows the plain twins (collision/narrowphase.py,
// ops/cubic.py) in order; with -fmad=false and IEEE division kernel and twin
// agree bit for bit on the card, powf/acosf/cosf included (same libdevice).
#pragma once

#include <cuda_runtime.h>

#include "compact.cuh"

// Everything is internal to each translation unit that includes this file.
namespace {

constexpr float kTwoPi3 = 2.0943951023931953f;
constexpr float kFourPi3 = 4.1887902047863905f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float det3(V3 a, V3 b, V3 c) { return dot(a, cross(b, c)); }
__device__ __forceinline__ V3 lerp(V3 a, V3 d, float t) {
  return {a.x + t * d.x, a.y + t * d.y, a.z + t * d.z};
}
// max(x, lo) / min(x, hi) keeping a NaN, as torch.clamp and jnp.clip do.
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ V3 normalize(V3 v) {
  const float inv = 1.0f / clamp_lo(sqrtf(dot(v, v)), 1e-20f);
  return {v.x * inv, v.y * inv, v.z * inv};
}
__device__ __forceinline__ float sgn(float x) { return (float)((x > 0.0f) - (x < 0.0f)); }
__device__ __forceinline__ float cbrt_ref(float x) {
  return sgn(x) * powf(fabsf(x), 1.0f / 3.0f);
}
__device__ __forceinline__ V3 load3(const float* a, int node) {
  return {a[(size_t)node * 3], a[(size_t)node * 3 + 1], a[(size_t)node * 3 + 2]};
}

// Cramer's rule for [ab ac n] beta = ap and the interior test.
__device__ bool inside(V3 ab, V3 ac, V3 n, V3 ap) {
  const float det = det3(ab, ac, n);
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  const float bx = det3(ap, ac, n) * inv_det;
  const float by = det3(ab, ap, n) * inv_det;
  return det != 0.0f && bx >= 0.0f && bx <= 1.0f && by >= 0.0f && by <= 1.0f &&
         bx + by <= 1.0f;
}

// Two clamped Newton steps (ops/cubic.py:_newton_polish).
__device__ float newton_polish(float a, float b, float c, float d, float t) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float f = ((a * t + b) * t + c) * t + d;
    const float fp = (3.0f * a * t + 2.0f * b) * t + c;
    const float t_new = t - f / (fabsf(fp) < 1e-20f ? 1e-20f : fp);
    t = clamp(isfinite(t_new) ? t_new : t, 0.0f, 1.0f);
  }
  return t;
}

// earliest_root_in_unit_interval: the degree is chosen by exact zero tests
// (the reference's), the cubic in closed form.
__device__ bool earliest_root(float a, float b, float c, float d, float* t_out) {
  *t_out = 0.0f;
  if (a != 0.0f) {
    const float inv_a = 1.0f / a;
    const float p = b * inv_a, q = c * inv_a, r = d * inv_a;
    const float p2 = p * p;
    const float big_a = q - p2 / 3.0f;
    const float big_b = (2.0f * p2 * p - 9.0f * p * q + 27.0f * r) / 27.0f;
    const float shift = -p / 3.0f;
    const float disc = big_b * big_b / 4.0f + big_a * big_a * big_a / 27.0f;
    float roots[3];
    int n_roots;
    if (disc > 0.0f) {
      const float sq = sqrtf(clamp_lo(disc, 0.0f));
      const float half_b = -big_b / 2.0f;
      roots[0] = (cbrt_ref(half_b + sq) + cbrt_ref(half_b - sq)) + shift;
      n_roots = 1;
    } else {
      const float m = 2.0f * sqrtf(clamp_lo(-big_a / 3.0f, 1e-30f));
      const float am = big_a * m;
      const float guard = fabsf(am) < 1e-30f ? 1e-30f : 0.0f;
      const float arg = clamp(3.0f * big_b / (am + guard), -1.0f, 1.0f);
      const float theta = acosf(arg) / 3.0f;
      roots[0] = m * cosf(theta) + shift;
      roots[1] = m * cosf(theta - kTwoPi3) + shift;
      roots[2] = m * cosf(theta - kFourPi3) + shift;
      n_roots = 3;
    }
    float t = __int_as_float(0x7f800000);  // +inf
    for (int i = 0; i < n_roots; ++i)
      if (roots[i] >= 0.0f && roots[i] <= 1.0f && roots[i] < t) t = roots[i];
    if (!isfinite(t)) return false;
    *t_out = newton_polish(a, b, c, d, t);
    return true;
  }
  if (b != 0.0f) {
    // Quadratic, with the reference's quirk: if the (-c - sqrt)/2b root is
    // past 1 it gives up without trying the other.
    const float disc = c * c - 4.0f * b * d;
    const float sq = sqrtf(clamp_lo(disc, 0.0f));
    const float den = 2.0f * b;
    const float t1 = (-c - sq) / den;
    const float t2 = (-c + sq) / den;
    const float tq = t1 < 0.0f ? t2 : t1;
    const bool found = disc >= 0.0f && t1 <= 1.0f && tq >= 0.0f && tq <= 1.0f;
    *t_out = found ? tq : 0.0f;
    return found;
  }
  if (c != 0.0f) {
    const float tl = -d / c;
    const bool found = tl >= 0.0f && tl <= 1.0f;
    *t_out = found ? tl : 0.0f;
    return found;
  }
  return d == 0.0f;
}

// pointTriangleCCD (CollisionDetection.cpp:227-302), column form.
__device__ bool point_triangle_ccd(V3 ap0, V3 ab0, V3 ac0, V3 ap1, V3 ab1, V3 ac1,
                                   float thr) {
  const V3 n0 = normalize(cross(ab0, ac0));
  const V3 n1 = normalize(cross(ab1, ac1));
  const float ndp0 = dot(n0, ap0);
  const float ndp1 = dot(n1, ap1);
  if (ndp0 * ndp1 >= 0.0f)
    return ndp1 >= 0.0f && ndp1 < thr && inside(ab1, ac1, n1, ap1);
  const V3 apd = sub(ap1, ap0), abd = sub(ab1, ab0), acd = sub(ac1, ac0);
  const float c3 = det3(apd, abd, acd);
  const float c2 = det3(ap0, abd, acd) + det3(apd, ab0, acd) + det3(apd, abd, ac0);
  const float c1 = det3(ap0, ab0, acd) + det3(ap0, abd, ac0) + det3(apd, ab0, ac0);
  const float c0 = det3(ap0, ab0, ac0);
  float t;
  if (!earliest_root(c3, c2, c1, c0, &t)) return false;
  const V3 apt = lerp(ap0, apd, t), abt = lerp(ab0, abd, t), act = lerp(ac0, acd, t);
  return inside(abt, act, normalize(cross(abt, act)), apt);
}

// Phase 1's per-face terms (point_triangle_phase1_face): a face's corners
// before (p*) and now (n*), computed once for all the points tested
// against it.
struct FaceFrame {
  V3 b0, b1, cross0, n1, cx_acn, cx_nab;
  float inv_det;
  bool ok;
};

__device__ __forceinline__ FaceFrame face_frame(V3 p0, V3 p1, V3 p2, V3 n0, V3 n1_, V3 n2) {
  FaceFrame f;
  f.b0 = p0;
  f.b1 = n0;
  const V3 ab0 = sub(p1, p0), ac0 = sub(p2, p0);
  const V3 ab1 = sub(n1_, n0), ac1 = sub(n2, n0);
  f.cross0 = cross(ab0, ac0);
  f.n1 = normalize(cross(ab1, ac1));
  f.cx_acn = cross(ac1, f.n1);
  const float det = dot(ab1, f.cx_acn);
  f.inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  f.ok = det != 0.0f;
  f.cx_nab = cross(f.n1, ab1);
  return f;
}

// One point (before, now) against a face: *prox when it ends within thr over
// the face without having crossed its plane, *crossed when it crossed.
__device__ __forceinline__ void phase1_point(const FaceFrame& f, V3 own_p, V3 own_n,
                                             float thr, bool* prox, bool* crossed) {
  const V3 ap0 = sub(own_p, f.b0), ap1 = sub(own_n, f.b1);
  const float c_start = dot(ap0, f.cross0);
  const float ndp1 = dot(f.n1, ap1);
  const bool no_cross = c_start * ndp1 >= 0.0f;
  const float bx = dot(ap1, f.cx_acn) * f.inv_det;
  const float by = dot(ap1, f.cx_nab) * f.inv_det;
  const bool in = f.ok && bx >= 0.0f && bx <= 1.0f && by >= 0.0f && by <= 1.0f &&
                  bx + by <= 1.0f;
  *prox = no_cross && ndp1 >= 0.0f && ndp1 < thr && in;
  *crossed = !no_cross;
}

// Class of a lane for the prox-first compaction, packed for one 64-bit scan:
// low word counts proximity lanes, high word crossing-only lanes.
__device__ __forceinline__ long long lane_class(unsigned prox, unsigned cross) {
  return prox != 0 ? 1LL : (cross != 0 ? (1LL << 32) : 0LL);
}

// Stage (b) of T15, every thread of the block: lane l with a
// bit goes to the pair buffer, proximity lanes first, then crossing-only
// lanes, each by lane id, into min(pcap, lanes) slots.  `part` is this
// block's scanned class count, totals[0] the class counts of all lanes;
// lane 0 writes the live slot count to totals[2] and ORs the latch when the
// proximity lanes alone exceed the buffer.
__device__ __forceinline__ void compact_lane(int l, int lanes, int pcap,
                                             const unsigned* bits_prox,
                                             const unsigned* bits_cross, long long part,
                                             long long* totals, int* pair_buf,
                                             int* overflow) {
  unsigned prox_bits = 0, cross_bits = 0;
  if (l < lanes) {
    prox_bits = bits_prox[l];
    cross_bits = bits_cross[l];
  }
  long long tile;
  const long long ex = pies::block_exclusive_scan(lane_class(prox_bits, cross_bits), &tile);
  const long long at = part + ex;
  const long long tot = totals[0];
  const long long n_prox = tot & 0xffffffffLL, n_cross = tot >> 32;
  const long long slots = pcap < lanes ? pcap : lanes;
  long long pos = -1;
  if (prox_bits != 0)
    pos = at & 0xffffffffLL;
  else if (cross_bits != 0)
    pos = n_prox + (at >> 32);
  if (pos >= 0 && pos < slots) pair_buf[pos] = l;
  if (l == 0) {
    const long long n_any = n_prox + n_cross;
    totals[2] = n_any < slots ? n_any : slots;
    if (n_prox > slots) atomicOr(overflow, 1);
  }
}

}  // namespace
