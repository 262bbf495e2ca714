// Kernel T25: the narrowphase of the edge-edge detection: each
// (triangle, candidate slot) pair's 3 x 3 edge combos CCD-tested, the hits
// compacted in the JAX package's combo-major order and decoded.
//
// Replaces (JAX): pies_tpu/collision/broadphase.py:1485-1548 (the pair
// filter, the nine edge_edge_ccd tests, the combo-major compaction capped
// at max_edge_contacts, the decode into edge_idx and edge_mask), with
// narrowphase.py:239-342 (_segment_closest_uv, edge_edge_ccd, the
// hard-coded 0.5 proximity, the quirk's u = v = 0) and ops/cubic.py.  The
// candidates are kernel T16's in its cell-list mode (tri_candidates.cu):
// each row a packed ascending prefix of `count` slots of width nb.
//
// A lane is one pair l = triangle * nb + slot.  A pair is live when the
// slot holds a candidate with a larger id that shares no node with the
// triangle, and, with the emit mask `emit` (broadphase.py:1499-1500; the
// domain decomposition's owned triangles), the triangle emits.  Combo c =
// 3 e1 + e2 tests edge e1 of the triangle against edge e2 of the
// candidate (edges (0,1), (1,2), (2,0)), relative to the first edge's
// start before and now.  Hit h = (combo, pair) is numbered c * P + l (P
// pairs): the JAX package's loop, combo outer, pairs inner.  The first
// `cap` hits are the contacts; the JAX package drops the rest without a
// latch, and `hits` counts them all.
//
// Stages, back to back on one stream; every stage but the last returns at
// once when the failure latch (slot 0) is set or T16 filled no candidate
// slot (flags[0] == 0):
//  (a) a thread per pair: the nine tests, as nine bits of a 16-bit word;
//  (b) per block of pairs, its hits of each combo (nine block scans); a
//      single-block scan of the 9 x blocks sums in combo-major order (the
//      total in the last word); then each hit's slot, its prefix in that
//      order, decoded to (a, b | c, d) with mask 1 where below the cap (no
//      float or ordering atomics: every order comes from scans);
//  (c) per contact slot: the count min(hits, cap), the hits, and zeros
//      past the count.
//
// Bound: bytes.  A pair reads its slot (4 bytes) and, when live, two
// triangles' corners at two times (72 bytes, mostly from L2) and writes a
// 2-byte word; the nine CCDs are ~2,000 float operations per live pair.
// Most lanes are empty (a row holds a few candidates of nb = 32 slots).
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y is the member b of `members`: its nodes from b*n, its
// candidate rows and counts (T16's [b]), its gate flags[b*8], lane bits,
// block partials [b] of [members, 9 nt] and total, its contact buffer [b]
// of [members, cap, 4] with its count and hits, and its latch (Ec::member).
// The scan of block sums takes one block per member, gated on that
// member's filled count, so each member's contact order is a single-scene
// run's.  A lane index counts one member's pairs; member offsets are
// 64-bit.  The triangles are shared.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ccd.cuh"
#include "compact.cuh"
#include "edge_terms.cuh"

namespace {

__constant__ int kEdgeA[3] = {0, 1, 2};
__constant__ int kEdgeB[3] = {1, 2, 0};

struct Ec {
  const float* x;
  const float* prev;
  const int* tris;
  const int* cand;
  const int* count;
  const int* flags;
  uint16_t* bits;
  int* partial;  // [9 nt] a member: per combo, the block sums
  int* total;    // the member's hits (the scan's sum)
  int* edge_idx;
  float* edge_mask;
  int* edge_count;
  int* edge_hits;
  const int* failed;
  const float* emit;  // f32[t] or null: a row whose entry is 0 queries nothing
  int t, nb, cap, pairs, nt, quirks, n;

  // The view of member b: every per-member array offset to its row.
  __device__ __forceinline__ Ec member(int b) const {
    Ec m = *this;
    const size_t bb = b;
    m.x += bb * n * 3;
    m.prev += bb * n * 3;
    m.cand += bb * pairs;
    m.count += bb * t;
    m.flags += bb * 8;
    m.bits += bb * pairs;
    m.partial += bb * 9 * nt;
    m.total += bb;
    m.edge_idx += bb * cap * 4;
    m.edge_mask += bb * cap;
    m.edge_count += bb;
    m.edge_hits += bb;
    m.failed += 2 * bb;
    return m;
  }
};

__device__ __forceinline__ bool gated(const Ec& g) {
  return g.failed[0] != 0 || g.flags[0] == 0;
}

__device__ __forceinline__ void to3(V3 v, float o[3]) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
}

// v / max(|v|, 1e-20), a division per component (_safe_normalize).
__device__ __forceinline__ V3 div_normalize(V3 v) {
  const float nn = pies::max_keep_nan(sqrtf(dot(v, v)), 1e-20f);
  return {v.x / nn, v.y / nn, v.z / nn};
}

// edge_edge_ccd (narrowphase.py:296-342), relative to the first edge's
// start: before (*0) and now (*1).
__device__ bool edge_edge_ccd(V3 ab0, V3 ac0, V3 ad0, V3 ab1, V3 ac1, V3 ad1, bool quirk) {
  float ab[3], ac[3], ad[3];
  to3(ab1, ab);
  to3(ac1, ac);
  to3(ad1, ad);
  float u, v;
  bool degenerate;
  pies::segment_closest_uv(ab, ac, ad, &u, &v, &degenerate);
  if (quirk) {
    u = degenerate ? u : 0.0f;
    v = degenerate ? v : 0.0f;
  }
  const V3 q0 = {u * ab1.x, u * ab1.y, u * ab1.z};
  const V3 q1 = lerp(ac1, sub(ad1, ac1), v);
  const V3 dq = sub(q0, q1);
  if (sqrtf(dot(dq, dq)) < 0.5f) return true;  // CollisionDetection.cpp:372

  const V3 abd = sub(ab1, ab0), acd = sub(ac1, ac0), add = sub(ad1, ad0);
  const float c3 = det3(abd, acd, add);
  const float c2 = det3(ab0, acd, add) + det3(abd, ac0, add) + det3(abd, acd, ad0);
  const float c1 = det3(ab0, ac0, add) + det3(ab0, acd, ad0) + det3(abd, ac0, ad0);
  const float c0 = det3(ab0, ac0, ad0);
  float t;
  if (!earliest_root(c3, c2, c1, c0, &t)) return false;
  const V3 abt = lerp(ab0, abd, t), act = lerp(ac0, acd, t), adt = lerp(ad0, add, t);
  const V3 cdt = sub(adt, act);
  const V3 ncdt = {-cdt.x, -cdt.y, -cdt.z};
  const V3 nt = div_normalize(cross(abt, cdt));
  const float det = det3(abt, ncdt, nt);
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  const float uu = det3(act, ncdt, nt) * inv_det;
  const float vv = det3(abt, act, nt) * inv_det;
  return det != 0.0f && uu >= 0.0f && uu <= 1.0f && vv >= 0.0f && vv <= 1.0f;
}

// (a) the nine tests of a pair.
__global__ void __launch_bounds__(pies::kBlock) ecc_ccd_kernel(Ec g0) {
  const Ec g = g0.member(blockIdx.y);
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= g.pairs || gated(g)) return;
  const int r = l / g.nb, slot = l - r * g.nb;
  unsigned bits = 0;
  if (slot < g.count[r] && (g.emit == nullptr || g.emit[r] > 0.0f)) {
    const int o = g.cand[l];
    const int w[3] = {g.tris[r * 3], g.tris[r * 3 + 1], g.tris[r * 3 + 2]};
    const int v[3] = {g.tris[o * 3], g.tris[o * 3 + 1], g.tris[o * 3 + 2]};
    bool shares = false;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) shares = shares || w[a] == v[b];
    if (o > r && !shares) {
      for (int e1 = 0; e1 < 3; ++e1) {
        const int na = w[kEdgeA[e1]], nb_ = w[kEdgeB[e1]];
        const V3 p0 = load3(g.prev, na), p1 = load3(g.x, na);
        const V3 ab0 = sub(load3(g.prev, nb_), p0), ab1 = sub(load3(g.x, nb_), p1);
        for (int e2 = 0; e2 < 3; ++e2) {
          const int nc = v[kEdgeA[e2]], nd = v[kEdgeB[e2]];
          const V3 ac0 = sub(load3(g.prev, nc), p0), ad0 = sub(load3(g.prev, nd), p0);
          const V3 ac1 = sub(load3(g.x, nc), p1), ad1 = sub(load3(g.x, nd), p1);
          if (edge_edge_ccd(ab0, ac0, ad0, ab1, ac1, ad1, g.quirks != 0))
            bits |= 1u << (e1 * 3 + e2);
        }
      }
    }
  }
  g.bits[l] = (uint16_t)bits;
}

// (b1) each block's hits of each combo.
__global__ void __launch_bounds__(pies::kBlock) ecc_tile_sums_kernel(Ec g0) {
  const Ec g = g0.member(blockIdx.y);
  if (gated(g)) return;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned bits = l < g.pairs ? g.bits[l] : 0u;
  for (int c = 0; c < 9; ++c) {
    int tile;
    pies::block_exclusive_scan((int)((bits >> c) & 1u), &tile);
    if (threadIdx.x == 0) g.partial[c * g.nt + blockIdx.x] = tile;
  }
}

// (b3) each hit into its contact slot, decoded.
__global__ void __launch_bounds__(pies::kBlock) ecc_scatter_kernel(Ec g0) {
  const Ec g = g0.member(blockIdx.y);
  if (gated(g)) return;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned bits = l < g.pairs ? g.bits[l] : 0u;
  const int r = l / g.nb;
  for (int c = 0; c < 9; ++c) {
    const int hit = (int)((bits >> c) & 1u);
    int tile;
    const int ex = pies::block_exclusive_scan(hit, &tile);
    if (!hit) continue;
    const int pos = g.partial[c * g.nt + blockIdx.x] + ex;
    if (pos >= g.cap) continue;
    const int o = g.cand[l];
    const int e1 = c / 3, e2 = c - 3 * e1;
    int4 v;
    v.x = g.tris[r * 3 + kEdgeA[e1]];
    v.y = g.tris[r * 3 + kEdgeB[e1]];
    v.z = g.tris[o * 3 + kEdgeA[e2]];
    v.w = g.tris[o * 3 + kEdgeB[e2]];
    reinterpret_cast<int4*>(g.edge_idx)[pos] = v;
    g.edge_mask[pos] = 1.0f;
  }
}

// (c) the counts and the empty tail of the contact buffer.
__global__ void __launch_bounds__(pies::kBlock) ecc_finish_kernel(Ec g0) {
  const Ec g = g0.member(blockIdx.y);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int total = gated(g) ? 0 : g.total[0];
  const int n = total < g.cap ? total : g.cap;
  if (i == 0) {
    g.edge_count[0] = n;
    g.edge_hits[0] = total;
  }
  if (i >= n && i < g.cap) {
    reinterpret_cast<int4*>(g.edge_idx)[i] = make_int4(0, 0, 0, 0);
    g.edge_mask[i] = 0.0f;
  }
}

}  // namespace

extern "C" int pies_edge_ccd(const float* x, const float* prev, const int* tris,
                             const int* cand, const int* count, const int* flags,
                             uint16_t* bits, int* partial, int* edge_idx, float* edge_mask,
                             int* edge_count, int* edge_hits, const int* failed,
                             const float* emit, int t, int nb,
                             int cap, int quirks, int n, int members, void* stream) {
  if (t <= 0 || nb <= 0 || cap < 0 || n <= 0 || members <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int pairs = t * nb;
  const int nt = pies::tiles(pairs);
  // partial: [members, 9 nt] block sums, then the members' totals [members].
  int* total = partial + (size_t)members * 9 * nt;
  Ec g{x,         prev,       tris,       cand,   count,   flags, bits, partial, total,
       edge_idx,  edge_mask,  edge_count, edge_hits, failed, emit, t,  nb,   cap,     pairs,
       nt,        quirks,     n};
  const dim3 lanes(nt, members);
  ecc_ccd_kernel<<<lanes, pies::kBlock, 0, st>>>(g);
  ecc_tile_sums_kernel<<<lanes, pies::kBlock, 0, st>>>(g);
  pies::scan_segments_kernel<int><<<members, 1024, 0, st>>>(partial, 9 * nt, total, 1, flags, 8);
  ecc_scatter_kernel<<<lanes, pies::kBlock, 0, st>>>(g);
  ecc_finish_kernel<<<dim3(pies::tiles(cap), members), pies::kBlock, 0, st>>>(g);
  return (int)cudaGetLastError();
}
