// Kernel T6: the point-triangle narrowphase on the packed-body layout.
//
// Replaces (JAX): pies_tpu/collision/broadphase.py:385-644
// (_detect_point_tri_bodies_packed's phase1, phase2 and decode), with
// narrowphase.py:39-207 (point_triangle_ccd_cols, point_triangle_phase1_face,
// _barycentric_inside_c), ops/cubic.py (earliest_root_in_unit_interval and
// the closed-form cubic), _compact_pairs_prox_first (:1293) and
// _compact_by_sort (:1271).
//
// Stages, back to back on one stream, each a no-op when the failure latch
// (slot 0) is set:
//  (a) one thread per (body, slot) lane whose cached pair is live: the e
//      faces of the candidate body against the m corners of the own body,
//      giving a proximity bitmask (decided contacts) and a crossing bitmask
//      (points that crossed a face's plane); per-block class counts;
//  (b) scan of the counts; every lane with a bit scatters its id to the
//      pair buffer: proximity lanes first, then crossing-only lanes, each by
//      lane id (a stable compaction into 2*cap slots); the latch when the
//      proximity lanes alone exceed the buffer;
//  (c) phase 2 on compacted lanes with crossing bits only: the coplanarity
//      cubic and the containment test at its earliest root; per-block
//      counts of hit combos;
//  (d) scan; each hit combo, in (buffer slot, combo) order, becomes contact
//      [a, b, c, d] in the first cap slots; the rest of the buffer is
//      zeroed and the device count written.
// No host sync: the kernels read the device counts and exit past them.
//
// Every float operation follows the plain twin (collision/narrowphase.py,
// ops/cubic.py) in order; with -fmad=false and IEEE division the two agree
// bit for bit on the card, powf/acosf/cosf included (same libdevice).
//
// Bound: gathers and compute.  Phase 1 reads two 96-byte rows per lane (2M
// lanes at 500k particles) and does ~1.2k flops; phase 2 about 8
// transcendentals per crossing combo on the few compacted lanes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"

namespace {

constexpr int kMaxNodes = 8;
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

struct Np {
  const float* x;
  const float* prev;
  const float* tri_mask;
  const int* pairs;
  const int* valid;
  const int* faces;  // [e, 3] local corners
  unsigned* bits_prox;
  unsigned* bits_cross;
  int* pair_buf;
  unsigned* pbits;
  long long* part1;  // per-block class counts of stage (a)
  long long* part2;  // per-block hit counts of stage (c)
  long long* totals;  // [0] packed class counts, [1] hits, [2] live buffer slots
  int* pt_idx;
  float* pt_mask;
  int* pt_count;
  int* overflow;
  const int* failed;
  int k, m, e, off, nb, cap, pcap, lanes;
  float thr;
};

__device__ __forceinline__ V3 load3(const float* a, int node) {
  return {a[(size_t)node * 3], a[(size_t)node * 3 + 1], a[(size_t)node * 3 + 2]};
}

__device__ __forceinline__ bool body_live(const Np& p, int b) {
  for (int j = 0; j < p.e; ++j)
    if (p.tri_mask[(size_t)b * p.e + j] > 0.0f) return true;
  return false;
}

// Class of a lane for the prox-first compaction, packed for one 64-bit scan:
// low word counts proximity lanes, high word crossing-only lanes.
__device__ __forceinline__ long long lane_class(unsigned prox, unsigned cross) {
  return prox != 0 ? 1LL : (cross != 0 ? (1LL << 32) : 0LL);
}

__global__ void __launch_bounds__(pies::kBlock) np_phase1_kernel(Np p) {
  if (p.failed[0] != 0) return;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned prox_bits = 0, cross_bits = 0;
  if (l < p.lanes) {
    const int b = l / p.nb;
    const int other = p.pairs[l];
    if (p.valid[l] != 0 && other != b && body_live(p, b)) {
      V3 own_p[kMaxNodes], own_n[kMaxNodes], oth_p[kMaxNodes], oth_n[kMaxNodes];
      for (int c = 0; c < p.m; ++c) {
        own_p[c] = load3(p.prev, p.off + b * p.m + c);
        own_n[c] = load3(p.x, p.off + b * p.m + c);
        oth_p[c] = load3(p.prev, p.off + other * p.m + c);
        oth_n[c] = load3(p.x, p.off + other * p.m + c);
      }
      for (int f = 0; f < p.e; ++f) {
        const int i0 = p.faces[3 * f], i1 = p.faces[3 * f + 1], i2 = p.faces[3 * f + 2];
        const V3 b0 = oth_p[i0], b1 = oth_n[i0];
        const V3 ab0 = sub(oth_p[i1], b0), ac0 = sub(oth_p[i2], b0);
        const V3 ab1 = sub(oth_n[i1], b1), ac1 = sub(oth_n[i2], b1);
        const V3 cross0 = cross(ab0, ac0);
        const V3 n1 = normalize(cross(ab1, ac1));
        const V3 cx_acn = cross(ac1, n1);
        const float det = dot(ab1, cx_acn);
        const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
        const bool ok = det != 0.0f;
        const V3 cx_nab = cross(n1, ab1);
        for (int c = 0; c < p.m; ++c) {
          const V3 ap0 = sub(own_p[c], b0), ap1 = sub(own_n[c], b1);
          const float c_start = dot(ap0, cross0);
          const float ndp1 = dot(n1, ap1);
          const bool no_cross = c_start * ndp1 >= 0.0f;
          const float bx = dot(ap1, cx_acn) * inv_det;
          const float by = dot(ap1, cx_nab) * inv_det;
          const bool in = ok && bx >= 0.0f && bx <= 1.0f && by >= 0.0f && by <= 1.0f &&
                          bx + by <= 1.0f;
          const unsigned bit = 1u << (c * p.e + f);
          if (no_cross && ndp1 >= 0.0f && ndp1 < p.thr && in) prox_bits |= bit;
          if (!no_cross) cross_bits |= bit;
        }
      }
    }
    p.bits_prox[l] = prox_bits;
    p.bits_cross[l] = cross_bits;
  }
  long long tile;
  pies::block_exclusive_scan(lane_class(prox_bits, cross_bits), &tile);
  if (threadIdx.x == 0) p.part1[blockIdx.x] = tile;
}

__global__ void __launch_bounds__(pies::kBlock) np_compact_kernel(Np p) {
  if (p.failed[0] != 0) return;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned prox_bits = 0, cross_bits = 0;
  if (l < p.lanes) {
    prox_bits = p.bits_prox[l];
    cross_bits = p.bits_cross[l];
  }
  long long tile;
  const long long ex = pies::block_exclusive_scan(lane_class(prox_bits, cross_bits), &tile);
  const long long at = p.part1[blockIdx.x] + ex;
  const long long tot = p.totals[0];
  const long long n_prox = tot & 0xffffffffLL, n_cross = tot >> 32;
  const long long slots = p.pcap < p.lanes ? p.pcap : p.lanes;
  long long pos = -1;
  if (prox_bits != 0)
    pos = at & 0xffffffffLL;
  else if (cross_bits != 0)
    pos = n_prox + (at >> 32);
  if (pos >= 0 && pos < slots) p.pair_buf[pos] = l;
  if (l == 0) {
    const long long n_any = n_prox + n_cross;
    p.totals[2] = n_any < slots ? n_any : slots;
    if (n_prox > slots) atomicOr(p.overflow, 1);
  }
}

__global__ void __launch_bounds__(pies::kBlock) np_phase2_kernel(Np p) {
  if (p.failed[0] != 0) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned hit_bits = 0;
  if (i < (int)p.totals[2]) {
    const int l = p.pair_buf[i];
    hit_bits = p.bits_prox[l];
    const unsigned cross_bits = p.bits_cross[l];
    if (cross_bits != 0) {
      const int b = l / p.nb, other = p.pairs[l];
      V3 oth_p[kMaxNodes], oth_n[kMaxNodes];
      for (int c = 0; c < p.m; ++c) {
        oth_p[c] = load3(p.prev, p.off + other * p.m + c);
        oth_n[c] = load3(p.x, p.off + other * p.m + c);
      }
      for (int c = 0; c < p.m; ++c) {
        const V3 own_p = load3(p.prev, p.off + b * p.m + c);
        const V3 own_n = load3(p.x, p.off + b * p.m + c);
        for (int f = 0; f < p.e; ++f) {
          const unsigned bit = 1u << (c * p.e + f);
          if (!(cross_bits & bit)) continue;
          const int i0 = p.faces[3 * f], i1 = p.faces[3 * f + 1], i2 = p.faces[3 * f + 2];
          const V3 b0 = oth_p[i0], b1 = oth_n[i0];
          if (point_triangle_ccd(sub(own_p, b0), sub(oth_p[i1], b0), sub(oth_p[i2], b0),
                                 sub(own_n, b1), sub(oth_n[i1], b1), sub(oth_n[i2], b1),
                                 p.thr))
            hit_bits |= bit;
        }
      }
    }
    p.pbits[i] = hit_bits;
  }
  long long tile;
  pies::block_exclusive_scan((long long)__popc(hit_bits), &tile);
  if (threadIdx.x == 0) p.part2[blockIdx.x] = tile;
}

__global__ void __launch_bounds__(pies::kBlock) np_decode_kernel(Np p) {
  if (p.failed[0] != 0) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned hit_bits = i < (int)p.totals[2] ? p.pbits[i] : 0u;
  long long tile;
  long long pos =
      p.part2[blockIdx.x] + pies::block_exclusive_scan((long long)__popc(hit_bits), &tile);
  const long long total = p.totals[1];
  const int count = (int)(total < p.cap ? total : p.cap);
  if (hit_bits != 0) {
    const int l = p.pair_buf[i];
    const int b = l / p.nb, other = p.pairs[l];
    for (int combo = 0; combo < p.m * p.e && pos < p.cap; ++combo) {
      if (!(hit_bits & (1u << combo))) continue;
      const int c = combo / p.e, f = combo - (combo / p.e) * p.e;
      int* row = p.pt_idx + pos * 4;
      row[0] = p.off + b * p.m + c;
      for (int r = 0; r < 3; ++r) row[1 + r] = p.off + other * p.m + p.faces[3 * f + r];
      ++pos;
    }
  }
  if (i < p.cap) {
    p.pt_mask[i] = i < count ? 1.0f : 0.0f;
    if (i >= count)
      for (int r = 0; r < 4; ++r) p.pt_idx[(size_t)i * 4 + r] = 0;
  }
  if (i == 0) p.pt_count[0] = count;
}

}  // namespace

extern "C" int pies_pt_narrowphase(
    const float* x, const float* prev, const float* tri_mask, const int* pairs,
    const int* valid, const int* faces, int* bits, int* pair_buf, int* pbits,
    long long* partial, long long* totals, int* pt_idx, float* pt_mask,
    int* pt_count, int* overflow, const int* failed, int k, int m, int e, int off,
    int nb, int cap, float thr, void* stream) {
  if (k > 0 && m > 0 && m <= kMaxNodes && m * e <= 32 && cap > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int lanes = k * nb, pcap = 2 * cap;
    const int b1 = pies::tiles(lanes), b2 = pies::tiles(pcap);
    Np p{x, prev, tri_mask, pairs, valid, faces,
         (unsigned*)bits, (unsigned*)bits + lanes, pair_buf, (unsigned*)pbits,
         partial, partial + b1, totals, pt_idx, pt_mask, pt_count, overflow, failed,
         k, m, e, off, nb, cap, pcap, lanes, thr};
    np_phase1_kernel<<<b1, pies::kBlock, 0, s>>>(p);
    pies::scan_partials_kernel<long long><<<1, 1024, 0, s>>>(p.part1, b1, totals, nullptr);
    np_compact_kernel<<<b1, pies::kBlock, 0, s>>>(p);
    np_phase2_kernel<<<b2, pies::kBlock, 0, s>>>(p);
    pies::scan_partials_kernel<long long><<<1, 1024, 0, s>>>(p.part2, b2, totals + 1,
                                                             nullptr);
    np_decode_kernel<<<b2, pies::kBlock, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
