// Kernel T17: the CCD stage of the per-triangle point-triangle branches:
// each of a triangle's three corners tested against each of its candidate
// triangles, the hits compacted in the JAX package's order and decoded.
//
// Replaces (JAX): pies_tpu/collision/broadphase.py:1769-1900
// (_ccd_and_compact after its prefilter), with narrowphase.py:210-237
// (point_triangle_ccd) and ops/cubic.py.  The CCD itself is ccd.cuh's
// point_triangle_ccd, shared with T6 and T15.
//
// A lane is one (triangle, candidate slot) pair, numbered in the JAX
// package's chunk-major order: the slot axis is cut into chunks of
// chunk = min(8, nb) slots (padded to a multiple of the chunk), and lane
// l = (chunk i, triangle r, slot in chunk j) = i * (t * chunk) + r * chunk
// + j.  A hit is (lane, corner), in that order; the first `cap` hits are
// the contacts, whatever the width nb (slots past a row's count are empty).
//
// Stages, back to back on one stream; every stage but the last returns at
// once when the failure latch (slot 0) is set or T16 filled no candidate
// slot (flags[0] == 0, the JAX package's lax.cond on jnp.any(ov)):
//  (a) a thread per lane: a live pair that is not the triangle itself and
//      shares no node with it has each own corner CCD-tested against the
//      candidate, relative to the candidate's first node (Solver.cpp:
//      777-788); the corner hits as three bits in a byte;
//  (b) the hits per block, a single-block scan of the block sums (the
//      total in the last word), then each lane's exclusive prefix: a lane's
//      hits go to consecutive contact slots, decoded to [a, b, c, d] with
//      mask 1 (no float or ordering atomics: every order comes from scans);
//  (c) per contact slot: the count (hits, capped) and zeros past it.
//
// Bound: bytes.  A lane reads its slot (4 bytes) and, when live, two
// triangles' corners at two times (72 bytes, mostly from L2); the CCD is
// ~200 float operations per corner, 3 corners.  Most lanes are empty on a
// calm scene (a row holds a few candidates of nb slots).
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y is the member b: its nodes from b*n, its candidate
// rows and counts (T16's [b]), its gate flags[b*8], lane hits, block
// partials and total, its contact buffer [b] of [members, cap, 4] with
// pt_count[b], and its latch.  The scan of block sums takes one block per
// member, gated on that member's filled count, so each member's contact
// order is a single-scene run's.  The triangles are shared.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ccd.cuh"
#include "compact.cuh"

namespace {

struct Cc {
  const float* x;
  const float* prev;
  const int* tris;
  const int* cand;
  const int* count;
  const int* flags;
  uint8_t* hits;
  int* partial;
  int* total;  // the hits of all lanes (the scan's sum)
  int* pt_idx;
  float* pt_mask;
  int* pt_count;
  const int* failed;
  int t, nb, chunk, cap, lanes, n_tiles, n;
  float thr;
};

// The view of member blockIdx.y: every per-member array offset to its row.
__device__ __forceinline__ Cc member_view(Cc g) {
  const size_t b = blockIdx.y;
  g.x += b * g.n * 3;
  g.prev += b * g.n * 3;
  g.cand += b * g.t * (size_t)g.nb;
  g.count += b * g.t;
  g.flags += b * 8;
  g.hits += b * g.lanes;
  g.partial += b * g.n_tiles;
  g.total += b;
  g.pt_idx += b * g.cap * 4;
  g.pt_mask += b * g.cap;
  g.pt_count += b;
  g.failed += 2 * b;
  return g;
}

__device__ __forceinline__ bool gated(const Cc& g) {
  return g.failed[0] != 0 || g.flags[0] == 0;
}

// The (triangle, slot) of lane l, and whether it holds a candidate.
__device__ __forceinline__ bool lane_pair(const Cc& g, int l, int* r, int* slot) {
  const int per_chunk = g.t * g.chunk;
  const int i = l / per_chunk, rem = l - i * per_chunk;
  *r = rem / g.chunk;
  *slot = i * g.chunk + (rem - *r * g.chunk);
  return *slot < g.nb && *slot < g.count[*r];
}

// (a) the three corner tests of a lane.
__global__ void __launch_bounds__(pies::kBlock) tcc_ccd_kernel(Cc g0) {
  const Cc g = member_view(g0);
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= g.lanes || gated(g)) return;
  int r, slot;
  unsigned bits = 0;
  if (lane_pair(g, l, &r, &slot)) {
    const int o = g.cand[(size_t)r * g.nb + slot];
    const int w0 = g.tris[r * 3], w1 = g.tris[r * 3 + 1], w2 = g.tris[r * 3 + 2];
    const int o0 = g.tris[o * 3], o1 = g.tris[o * 3 + 1], o2 = g.tris[o * 3 + 2];
    const bool shares = w0 == o0 || w0 == o1 || w0 == o2 || w1 == o0 || w1 == o1 ||
                        w1 == o2 || w2 == o0 || w2 == o1 || w2 == o2;
    if (o != r && !shares) {
      const V3 b0 = load3(g.prev, o0), b1 = load3(g.x, o0);
      const V3 ab0 = sub(load3(g.prev, o1), b0), ac0 = sub(load3(g.prev, o2), b0);
      const V3 ab1 = sub(load3(g.x, o1), b1), ac1 = sub(load3(g.x, o2), b1);
      const int own[3] = {w0, w1, w2};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const V3 ap0 = sub(load3(g.prev, own[c]), b0);
        const V3 ap1 = sub(load3(g.x, own[c]), b1);
        if (point_triangle_ccd(ap0, ab0, ac0, ap1, ab1, ac1, g.thr)) bits |= 1u << c;
      }
    }
  }
  g.hits[l] = (uint8_t)bits;
}

__device__ __forceinline__ int lane_hits(const Cc& g, int l) {
  return l < g.lanes ? __popc((unsigned)g.hits[l]) : 0;
}

// (b1) the hits of each block of lanes.
__global__ void __launch_bounds__(pies::kBlock) tcc_tile_sums_kernel(Cc g0) {
  const Cc g = member_view(g0);
  if (gated(g)) return;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  int tile;
  pies::block_exclusive_scan(lane_hits(g, l), &tile);
  if (threadIdx.x == 0) g.partial[blockIdx.x] = tile;
}

// (b3) each lane's hits into their contact slots, decoded.
__global__ void __launch_bounds__(pies::kBlock) tcc_scatter_kernel(Cc g0) {
  const Cc g = member_view(g0);
  if (gated(g)) return;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = lane_hits(g, l);
  int tile;
  const int ex = pies::block_exclusive_scan(n, &tile);
  if (n == 0) return;
  int pos = g.partial[blockIdx.x] + ex;
  int r, slot;
  lane_pair(g, l, &r, &slot);
  const int o = g.cand[(size_t)r * g.nb + slot];
  const unsigned bits = g.hits[l];
  for (int c = 0; c < 3; ++c) {
    if (!(bits & (1u << c))) continue;
    if (pos < g.cap) {
      int4 v;
      v.x = g.tris[r * 3 + c];
      v.y = g.tris[o * 3];
      v.z = g.tris[o * 3 + 1];
      v.w = g.tris[o * 3 + 2];
      reinterpret_cast<int4*>(g.pt_idx)[pos] = v;
      g.pt_mask[pos] = 1.0f;
    }
    ++pos;
  }
}

// (c) the count and the empty tail of the contact buffer.
__global__ void __launch_bounds__(pies::kBlock) tcc_finish_kernel(Cc g0) {
  const Cc g = member_view(g0);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int total = gated(g) ? 0 : g.total[0];
  const int n = total < g.cap ? total : g.cap;
  if (i == 0) g.pt_count[0] = n;
  if (i >= n && i < g.cap) {
    reinterpret_cast<int4*>(g.pt_idx)[i] = make_int4(0, 0, 0, 0);
    g.pt_mask[i] = 0.0f;
  }
}

}  // namespace

extern "C" int pies_tri_ccd(const float* x, const float* prev, const int* tris,
                            const int* cand, const int* count, const int* flags,
                            uint8_t* hits, int* partial, int* pt_idx, float* pt_mask,
                            int* pt_count, const int* failed, int t, int nb, int chunk, int cap,
                            float thr, int n, int members, void* stream) {
  if (t <= 0 || nb <= 0 || chunk <= 0 || cap <= 0 || n <= 0 || members <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int padded = (nb + chunk - 1) / chunk * chunk;
  const int lanes = t * padded;
  const int nt = pies::tiles(lanes);
  // partial [members, nt] block sums, then the members' totals [members].
  int* total = partial + (size_t)members * nt;
  Cc g{x,      prev,    tris,    cand,    count, flags, hits, partial, total, pt_idx,
       pt_mask, pt_count, failed, t,      nb,    chunk, cap,  lanes,   nt,    n,
       thr};
  const dim3 lb(nt, members);
  tcc_ccd_kernel<<<lb, pies::kBlock, 0, st>>>(g);
  tcc_tile_sums_kernel<<<lb, pies::kBlock, 0, st>>>(g);
  pies::scan_segments_kernel<int><<<members, 1024, 0, st>>>(partial, nt, total, 1, flags, 8);
  tcc_scatter_kernel<<<lb, pies::kBlock, 0, st>>>(g);
  tcc_finish_kernel<<<dim3(pies::tiles(cap), members), pies::kBlock, 0, st>>>(g);
  return (int)cudaGetLastError();
}
