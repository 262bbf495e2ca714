// Kernel T5: the packed-body broadphase with its temporal pair cache.
//
// Replaces (JAX): pies_tpu/collision/broadphase.py:210
// _detect_point_tri_bodies_packed (its build_pairs :267 and the cache),
// with grid.py:33-187,254-359 (table_size_for, cell_hash, aabb_cell_slots,
// build_grid, query_buckets, gather_entries), _insertion_slots (:1333) and
// _aabb_prefilter_pack (:1641); it also covers the bucket lookup that
// scripts/ab_pallas_lookup.py:95 benchmarks (table[idx] per queried cell).
// The cell hash, the insertion cells and the query window are grid.cuh's,
// shared by T5 and T14.
//
// What it computes (the plain twin's, unchanged):
//  (a) per body: swept AABB over prev and now in cell units +- slack, the
//      oversize latch, and the cache test max(|x-ref|, |prev-ref|) > slack
//      (a NaN anywhere makes the test false, as jnp.max does);
//  (b) when a rebuild is due (a stale cache or a node past the slack): up
//      to 8 insertion cells a body, reference hash in uint32, masked to the
//      table; a count per slot, their exclusive scan, each bucket filled;
//      a bucket's entries are read in entry order (item*8 + slot): the
//      order of the JAX package's stable sort;
//  (c) per body: query cells of [lo-1, hi] (<= cells_cap, range cap 8),
//      counts capped at entries_cap, the latch at a bucket of >= 127 (the
//      packed table's saturation; > 1000 in the unpacked mode) or a total
//      > 1000, up to bmax candidates in query order, the own body dropped,
//      the exact and slack AABB tiers, dedup by (tier, id), packed into nb
//      slots; the cache row, the reference positions, fresh and overflow.
//
// Bound: bytes.  At 500k particles (125k bodies) a call without a rebuild
// must read x, prev and ref (18 MB) and the triangle mask (2 MB): ~6 us at
// 3.35 TB/s; a rebuild also writes the reference and the cache rows (~22
// MB more, ~12.5 us in all, the grid's own traffic not counted).  The
// earlier design was nine launches and three fills a call, whatever the
// call did (30 us without a rebuild: a launch and a drain a stage, the
// bounds' flags ORed by every body on one word), and a query of one thread
// a body with its candidates and keys in 768 bytes of local memory and an
// insertion sort (127 us of a 177 us rebuild).
//
// This design is one cooperative launch a call (coop.cuh): G blocks a
// member, all resident, passing grid barriers between stages:
//  (a) a thread a body (a tet's 48-byte rows read as float4s, its mask as
//      one): bounds, kept in registers, and the member's flags, ORed once
//      a block; one barrier.  Every block then reads its member's rebuild
//      decision, and the launch ends there unless some member of the
//      launch rebuilds (the main path's common call: one kernel, one
//      barrier, no bounds written).  A member that does not rebuild, or is
//      latched, branches around every later stage and still passes every
//      barrier;
//  (b) the bounds written ([k][2] float4), the count; barrier; each
//      block's tile of slots summed; barrier; each block's prefix from the
//      tile sums before it, its tile scanned; barrier; the fill, each
//      entry's position from its slot's start and an atomic decrement of
//      the count (which leaves the counts zero for the next call), and the
//      reference positions copied; barrier;
//  (c) the query, a group of kGroup = 8 lanes a body, four bodies a warp,
//      the rows taken a block at a time from a counter (blocks with cheap
//      bodies take more): lanes take the query cells, the capped counts go
//      through a scan over the group, so the first bmax candidates land in
//      query order in the group's shared row; a cell taken whole is copied
//      in any order (every order gives the same rows after the sort), a
//      cell cut by entries_cap or bmax gives its smallest entries (the head
//      of the twin's stably sorted bucket), so no stage orders the buckets;
//      lanes test the candidates and form (tier, id) keys, a bitonic sort
//      across the group orders them, a neighbour compare drops duplicates,
//      a ballot prefix packs them into the nb slots; barrier; fresh and
//      overflow.
// No memset, no host copy, no host read; the wrapper allocates nothing.
// The rebuilt flag goes to the cache's own word (rebuilt[b], written on
// every call, 0 for a latched member).  The scratch (counts, starts, tile
// sums, entries, bounds, flag words, the query's row counter) is one
// int32 buffer a member kept across calls: the counts are left zero by
// the fill, the row counter is zeroed in stage (a), and the flag words
// come in two sets used by alternate calls, each call zeroing the other
// set (a member's epoch word says which).  What still holds it (measured on the H100): a call without
// a rebuild takes ~9 us against the ~6 us of bytes (stage (a) ~7 us, its
// barrier ~2.5); a rebuild ~100 us, its query ~57 us, bound by the
// instruction throughput of its per-cell work (~27 cells a body: hash,
// start and entry gathers, scan) with 32 warps an SM at 64 registers, and
// its six barriers ~2.5 us each.
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): member
// member0 + blockIdx.y runs all of the above on its own: its nodes from
// b*n, its cache row (pairs, valid, ref, fresh), its own table, bounds,
// flag words, overflow word and latch.  No member ever reads another's
// table, so no pair joins bodies of two members, and each member's
// rebuild, order and latches are those of a single-scene run.  The
// triangle mask is shared.  Members past what one launch keeps resident go
// to further launches over the next chunks of members.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"
#include "coop.cuh"
#include "grid.cuh"

namespace {

constexpr int kMaxNodes = 8;
constexpr int kMaxCand = 64;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;  // (64 registers a thread at most)
constexpr int kGroup = 8;        // lanes of a body's query
constexpr int kFlagWords = 8;
constexpr int kNextRow = 1 + 2 * kFlagWords;  // control: epoch, two flag sets, next row
constexpr int kCtl = kNextRow + 1;
constexpr int kRowsTaken = 1;  // query rows a warp of a block takes at a time
constexpr unsigned kNoKey = 0xffffffffu;

// A member's scratch words: count[h] | start[h + 1] | tile sums[grid] |
// entries[8k] | (to 16 bytes) bounds [k][2] float4 (lo xyz, hi xyz) |
// control[kCtl], rounded up to 16 bytes.
__host__ __device__ inline size_t box_offset(int k, int h, int grid) {
  return ((size_t)h + (h + 1) + grid + (size_t)kSlotsPerBody * k + 3) & ~(size_t)3;
}

__host__ __device__ inline size_t work_words(int k, int h, int grid) {
  return (box_offset(k, h, grid) + 8 * (size_t)k + kCtl + 3) & ~(size_t)3;
}

struct Geo {
  const float* x;
  const float* prev;
  const float* tri_mask;
  int* pairs;
  int* valid;
  float* ref;
  int* fresh;
  int* rebuilt;  // [members]: 1 when this call rebuilt the member's pairs
  int* work;
  int* overflow;
  const int* failed;
  int* count;
  int* start;
  int* tiles;
  int* entries;
  float4* box;  // [k][2]: lo, hi of a body (w unused)
  int* ctl;
  size_t words;
  int k, m, e, off, nb, bmax, cells_cap, entries_cap, h, unpacked, n;
  int member0;  // the member of blockIdx.y = 0 (a launch covers a chunk of them)
  float cell, slack, slack_c, margin, exact_margin, size_limit;
};

// The view of member b: every per-member array offset to its row.
__device__ __forceinline__ Geo member_view(Geo g, int b) {
  g.x += (size_t)b * g.n * 3;
  g.prev += (size_t)b * g.n * 3;
  g.pairs += (size_t)b * g.k * g.nb;
  g.valid += (size_t)b * g.k * g.nb;
  g.ref += (size_t)b * g.k * g.m * 3;
  g.fresh += b;
  g.rebuilt += b;
  g.overflow += b;
  g.failed += 2 * b;
  int* w = g.work + (size_t)b * g.words;
  g.count = w;
  g.start = w + g.h;
  g.tiles = g.start + g.h + 1;
  g.entries = g.tiles + gridDim.x;
  g.box = reinterpret_cast<float4*>(w + box_offset(g.k, g.h, gridDim.x));
  g.ctl = reinterpret_cast<int*>(g.box + (size_t)2 * g.k);
  return g;
}

__device__ __forceinline__ bool body_live(const Geo& g, int b) {
  if (g.e == 4 && (reinterpret_cast<uintptr_t>(g.tri_mask) & 15) == 0) {  // (a tet: one load)
    const float4 v = reinterpret_cast<const float4*>(g.tri_mask)[b];
    return v.x > 0.0f || v.y > 0.0f || v.z > 0.0f || v.w > 0.0f;
  }
  for (int j = 0; j < g.e; ++j)
    if (g.tri_mask[(size_t)b * g.e + j] > 0.0f) return true;
  return false;
}

// Body b's bounds, as written in stage (a).
__device__ __forceinline__ void body_box(const Geo& g, int b, float lo[3], float hi[3]) {
  const float4 l = g.box[2 * b], h = g.box[2 * b + 1];
  lo[0] = l.x;
  lo[1] = l.y;
  lo[2] = l.z;
  hi[0] = h.x;
  hi[1] = h.y;
  hi[2] = h.z;
}

// Body b's insertion cells (grid.cuh's insertion_cells on the bounds held
// here as float4s).
__device__ __forceinline__ int body_cells(const Geo& g, int b, int home[3]) {
  float lo[3], hi[3];
  body_box(g, b, lo, hi);
  return insertion_cells(lo, hi, 0, home);
}

// The OR of v over the block (every thread gets it; every thread calls it).
__device__ __forceinline__ int block_or(int v) {
  __shared__ int s_or;
  if (threadIdx.x == 0) s_or = 0;
  __syncthreads();
  v = (int)__reduce_or_sync(0xffffffffu, (unsigned)v);
  if ((threadIdx.x & 31) == 0 && v != 0) atomicOr(&s_or, v);
  __syncthreads();
  const int r = s_or;
  __syncthreads();
  return r;
}

// The sum of v over the block (every thread gets it; every thread calls it).
__device__ __forceinline__ int block_sum(int v) {
  int total;
  pies::block_exclusive_scan(v, &total);
  return total;
}

// Component i of a body's rows (float4-aligned), whose float4s are q.
__device__ __forceinline__ float comp(const float4* q, int i) {
  const float4 v = q[i >> 2];
  const int c = i & 3;
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// (a) body b's bounds, to box_lo and box_hi; returns its flag bits
// (1 << Flag).  M is the body's node count when known at compile time (4,
// a tet, whose rows are read as three float4s an array when `vec`), else 0
// (g.m).
template <int M>
__device__ __forceinline__ int body_bounds(const Geo& g, int b, bool vec, float4& box_lo,
                                           float4& box_hi) {
  const int m = M > 0 ? M : g.m;
  const size_t n0 = (size_t)g.off + (size_t)b * m;
  float xv[M > 0 ? 3 * M : 1], pv[M > 0 ? 3 * M : 1], rv[M > 0 ? 3 * M : 1];
  if (M > 0) {
    if (vec) {
      const float4* qx = reinterpret_cast<const float4*>(g.x + n0 * 3);
      const float4* qp = reinterpret_cast<const float4*>(g.prev + n0 * 3);
      const float4* qr = reinterpret_cast<const float4*>(g.ref + (size_t)b * m * 3);
      float4 ax[M > 0 ? 3 * M / 4 : 1], ap[M > 0 ? 3 * M / 4 : 1], ar[M > 0 ? 3 * M / 4 : 1];
#pragma unroll
      for (int i = 0; i < (M > 0 ? 3 * M / 4 : 0); ++i) {
        ax[i] = qx[i];
        ap[i] = qp[i];
        ar[i] = qr[i];
      }
#pragma unroll
      for (int i = 0; i < 3 * M; ++i) {
        xv[i] = comp(ax, i);
        pv[i] = comp(ap, i);
        rv[i] = comp(ar, i);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 3 * M; ++i) {
        xv[i] = g.x[n0 * 3 + i];
        pv[i] = g.prev[n0 * 3 + i];
        rv[i] = g.ref[(size_t)b * m * 3 + i];
      }
    }
  }
  float xmin[3], xmax[3], pmin[3], pmax[3];
  bool exceed = false, nan = false;
#pragma unroll
  for (int j = 0; j < m; ++j) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float xj = M > 0 ? xv[3 * j + d] : g.x[(n0 + j) * 3 + d];
      const float pj = M > 0 ? pv[3 * j + d] : g.prev[(n0 + j) * 3 + d];
      const float r = M > 0 ? rv[3 * j + d] : g.ref[((size_t)b * m + j) * 3 + d];
      if (j == 0) {
        xmin[d] = xmax[d] = xj;
        pmin[d] = pmax[d] = pj;
      } else {
        xmin[d] = nan_min(xmin[d], xj);
        xmax[d] = nan_max(xmax[d], xj);
        pmin[d] = nan_min(pmin[d], pj);
        pmax[d] = nan_max(pmax[d], pj);
      }
      const float dx = fabsf(xj - r), dp = fabsf(pj - r);
      if (dx != dx || dp != dp)
        nan = true;
      else if (dx > g.slack || dp > g.slack)
        exceed = true;
    }
  }
  const bool live = body_live(g, b);
  bool too_big = false;
  float lo[3], hi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = nan_min(xmin[d], pmin[d]) / g.cell - g.slack_c;
    hi[d] = nan_max(xmax[d], pmax[d]) / g.cell + g.slack_c;
    if (!live) lo[d] = hi[d] = 0.0f;
    too_big = too_big || (hi[d] - lo[d]) > g.size_limit;
  }
  box_lo = make_float4(lo[0], lo[1], lo[2], 0.0f);
  box_hi = make_float4(hi[0], hi[1], hi[2], 0.0f);
  return (too_big && live ? 1 << kSizeOver : 0) | (exceed ? 1 << kExceed : 0) |
         (nan ? 1 << kNan : 0);
}

// Whether a member with this latch, cache word and flag set rebuilds.
__device__ __forceinline__ bool rebuilds(int failed, int fresh, const int* flags) {
  return failed == 0 && (fresh == 0 || (flags[kExceed] != 0 && flags[kNan] == 0));
}

// Ascending bitonic sort of W * R keys held by a group of W lanes (a
// power of two dividing 32), element i in lane i % W of the group, register
// i / W; `gl` is the lane's index in its group.  Every lane of the warp
// calls it.
template <int W, int R>
__device__ __forceinline__ void group_sort(unsigned (&v)[R], int gl) {
#pragma unroll
  for (int size = 2; size <= W * R; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool up = ((gl + W * r) & size) == 0;
        if (stride >= W) {  // (registers r and r + stride / W of this lane)
          const int rs = stride / W;
          if ((r & rs) == 0) {
            const unsigned a = v[r], b = v[r + rs];
            v[r] = up ? min(a, b) : max(a, b);
            v[r + rs] = up ? max(a, b) : min(a, b);
          }
        } else {
          const unsigned o = __shfl_xor_sync(0xffffffffu, v[r], stride, W);
          const bool lower = (gl & stride) == 0;
          v[r] = lower == up ? min(v[r], o) : max(v[r], o);
        }
      }
    }
  }
}

// A cell's candidates into the row from position `at`: its bucket's first
// `need` entries in entry order (all `c` of them in any order when need ==
// c: they are sorted later, so the order changes nothing), as item ids.
__device__ __forceinline__ void gather_cell(const int* e, int c, int need, int* out) {
  if (need == c) {
    for (int j0 = 0; j0 < c; j0 += 4) {
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = j0 + u < c ? e[j0 + u] : 0;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + u < c) out[j0 + u] = v[u] / kSlotsPerBody;
    }
    return;
  }
  int last = -1;  // (entries are unique: each selection is the next larger one)
  for (int i = 0; i < need; ++i) {
    int best = 0x7fffffff;
    for (int j = 0; j < c; ++j) {
      const int v = e[j];
      if (v > last && v < best) best = v;
    }
    out[i] = best / kSlotsPerBody;
    last = best;
  }
}

// (c) the query, gather, prefilter and pack of body b (b >= k: none) by a
// group of W lanes, R candidates a lane (W * R >= bmax); every lane of the
// warp calls it, each group with its own body.  Returns the row's flag bits
// (gather, narrow and exact latches), the same in every lane of the group.
// `cand` is the group's shared row of kMaxCand ints.
template <int W, int R>
__device__ int query_body(const Geo& g, int b, int* cand) {
  const int lane = threadIdx.x & 31, gl = lane & (W - 1), base_lane = lane & ~(W - 1);
  const unsigned gmask = (0xffffffffu >> (32 - W)) << base_lane;
  const bool row = b < g.k;
  float qlo[3], lo[3] = {0.0f, 0.0f, 0.0f}, hi[3] = {0.0f, 0.0f, 0.0f};
  if (row) body_box(g, b, lo, hi);
#pragma unroll
  for (int d = 0; d < 3; ++d) qlo[d] = lo[d] - 1.0f;
  const bool live = row && body_live(g, b);
  int base[3], len[3];
  const int total_cells = live ? cell_range(qlo, hi, kRangeCap, base, len) : 0;
  const int n_cells = total_cells < g.cells_cap ? total_cells : g.cells_cap;
  const int lyz = live && len[1] * len[2] > 1 ? len[1] * len[2] : 1;
  const int lz = live && len[2] > 1 ? len[2] : 1;
  const float inv_yz = __frcp_rn((float)lyz), inv_z = __frcp_rn((float)lz);

  // The cells, W at a time, a lane each; each lane's capped count placed by
  // a scan over the group, its candidates written to the row in query order.
  int total = 0;
  bool over = false;
  const int rounds = (int)__reduce_max_sync(0xffffffffu, (unsigned)n_cells);
  for (int r = 0; r < rounds; r += W) {
    const int s = r + gl;
    int c = 0, ct = 0, st = 0;
    if (s < n_cells) {
      // (s = (dx·len_y + dy)·len_z + dz by float quotients of small
      // integers: (s + 0.5) / l lies at least 1/128 from an integer)
      const int dx = (int)(((float)s + 0.5f) * inv_yz), rem = s - dx * lyz;
      const int dy = (int)(((float)rem + 0.5f) * inv_z), dz = rem - dy * lz;
      const int slot = cell_slot(base[0] + dx, base[1] + dy, base[2] + dz, g.h);
      st = g.start[slot];
      c = g.start[slot + 1] - st;
      over = over || (g.unpacked ? c > kHardCap : c >= kSaturated);
      ct = c < g.entries_cap ? c : g.entries_cap;
    }
    int incl = ct;
#pragma unroll
    for (int o = 1; o < W; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o, W);
      if (gl >= o) incl += y;
    }
    const int at = total + incl - ct;
    const int room = g.bmax - at;
    const int need = ct < room ? ct : (room > 0 ? room : 0);
    if (need > 0) gather_cell(g.entries + st, c, need, cand + at);
    total += __shfl_sync(0xffffffffu, incl, W - 1, W);
  }
  const bool gather_over =
      (__ballot_sync(0xffffffffu, over) & gmask) != 0 || total > kHardCap;
  __syncwarp();
  const int n_cand = total < g.bmax ? total : g.bmax;

  // Tier 0: exact overlap, 1: slack-only overlap (bit 31); the own
  // candidate dropped.
  unsigned key[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = gl + W * r;
    key[r] = kNoKey;
    if (i < n_cand) {
      const int c = cand[i] < g.k - 1 ? cand[i] : g.k - 1;
      if (c != b) {
        float clo[3], chi[3];
        body_box(g, c, clo, chi);
        bool ov = true, ex = true;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float alo = clo[d], ahi = chi[d];
          ov = ov && (alo <= hi[d] + g.margin) && (ahi >= lo[d] - g.margin);
          ex = ex && (alo <= hi[d] + g.exact_margin) && (ahi >= lo[d] - g.exact_margin);
        }
        if (ex || ov) key[r] = (ex ? 0u : 0x80000000u) | (unsigned)c;
      }
    }
  }
  __syncwarp();  // (the row is the next body's)
  group_sort<W, R>(key, gl);

  // Duplicates dropped by a neighbour compare; the rest ranked by a ballot
  // prefix into the nb slots.
  const unsigned below = (1u << lane) - 1u;
  int n_unique = 0, n_exact = 0, rank[R];
  bool uniq[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned up1 = __shfl_up_sync(0xffffffffu, key[r], 1, W);
    const unsigned last = r > 0 ? __shfl_sync(0xffffffffu, key[r > 0 ? r - 1 : 0], W - 1, W)
                                : 0u;
    const unsigned before = gl > 0 ? up1 : last;
    uniq[r] = key[r] != kNoKey && (gl + W * r == 0 || key[r] != before);
    const unsigned bu = __ballot_sync(0xffffffffu, uniq[r]) & gmask;
    const unsigned be = __ballot_sync(0xffffffffu, uniq[r] && (key[r] >> 31) == 0) & gmask;
    rank[r] = n_unique + __popc(bu & below);
    n_unique += __popc(bu);
    n_exact += __popc(be);
  }
  if (row) {
    int* prow = g.pairs + (size_t)b * g.nb;
    int* vrow = g.valid + (size_t)b * g.nb;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (uniq[r] && rank[r] < g.nb) prow[rank[r]] = (int)(key[r] & 0x7fffffffu);
    for (int j = gl; j < g.nb; j += W) {
      if (j >= n_unique) prow[j] = 0;
      vrow[j] = j < n_unique ? 1 : 0;
    }
  }
  return (gather_over ? 1 << kGatherOver : 0) | (n_unique > g.nb ? 1 << kNarrowOver : 0) |
         (n_exact > g.nb ? 1 << kExactOver : 0);
}

// The query stage: groups of kGroup lanes, each a body at a time (a row:
// a body a group of a warp).  A block takes kRowsTaken rows a warp at a
// time from the member's counter, so that blocks with cheap bodies take
// more, and its warps work on neighbouring bodies at once, whose cells
// and candidates the SM's L1 then holds.  Every thread of the block calls
// it.
template <int R>
__device__ int query_rows(const Geo& g, int* cand_warp) {
  constexpr int per_warp = 32 / kGroup;
  constexpr int taken = kRowsTaken * kWarps;
  __shared__ int s_row;
  const int warp = threadIdx.x >> 5, group = (threadIdx.x & 31) / kGroup;
  const int rows = (g.k + per_warp - 1) / per_warp;
  int bits = 0;
  for (;;) {
    if (threadIdx.x == 0) s_row = atomicAdd(&g.ctl[kNextRow], taken);
    __syncthreads();
    const int q0 = s_row;
    __syncthreads();  // (s_row is the next take's)
    if (q0 >= rows) break;
    const int q1 = min(q0 + taken, rows);
    for (int q = q0 + warp; q < q1; q += kWarps)
      bits |= query_body<kGroup, R>(g, q * per_warp + group, cand_warp + group * kMaxCand);
  }
  return bits;
}

// ORs a block's flag bits into the member's flag words.
__device__ __forceinline__ void flag_block(int* flags, int bits) {
  if (threadIdx.x == 0)
    for (int f = 0; f < kFlagWords; ++f)
      if (bits & (1 << f)) atomicOr(&flags[f], 1);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) bp_kernel(Geo g0) {
  namespace cg = cooperative_groups;
  // (the member's view in shared memory, not in registers)
  __shared__ Geo s_geo;
  if (threadIdx.x == 0) s_geo = member_view(g0, g0.member0 + blockIdx.y);
  __syncthreads();
  const Geo& g = s_geo;
  const int t = threadIdx.x, warp = t >> 5;
  const int n_blocks = gridDim.x, stride = n_blocks * kThreads;
  const bool dead = g.failed[0] != 0;
  // Every member's epoch is the number of calls made on this scratch (all
  // the same): its parity picks the flag set of this call.
  const int epoch = g.ctl[0];
  int* flags = g.ctl + 1 + kFlagWords * (epoch & 1);
  if (blockIdx.x == 0 && t < kFlagWords) g.ctl[1 + kFlagWords * ((epoch & 1) ^ 1) + t] = 0;
  if (blockIdx.x == 0 && t == 0) g.ctl[kNextRow] = 0;  // (the query's row counter)

  // (a) bounds and flags.
  int bits = 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(g.x + (size_t)g.off * 3) |
                     reinterpret_cast<uintptr_t>(g.prev + (size_t)g.off * 3) |
                     reinterpret_cast<uintptr_t>(g.ref)) & 15) == 0;
  // (with a thread a body, its bounds wait in registers for the decision;
  // a call without a rebuild writes none)
  const int own = blockIdx.x * kThreads + t;
  const bool held = g.k <= stride;
  float4 own_lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), own_hi = own_lo;
  for (int b = own; !dead && b < g.k; b += stride) {
    bits |= g.m == 4 ? body_bounds<4>(g, b, vec, own_lo, own_hi)
                     : body_bounds<0>(g, b, false, own_lo, own_hi);
    if (!held) {
      g.box[2 * b] = own_lo;
      g.box[2 * b + 1] = own_hi;
    }
  }
  bits = block_or(bits);
  if (!dead) flag_block(flags, bits);
  cg::this_grid().sync();

  const bool rb = rebuilds(g.failed[0], g.fresh[0], flags);
  if (blockIdx.x == 0 && t == 0) {
    g.rebuilt[0] = rb ? 1 : 0;
    g.ctl[0] = epoch + 1;
  }
  int any = 0;
  for (int j = t; j < (int)gridDim.y; j += kThreads) {
    const Geo o = member_view(g0, g0.member0 + j);
    any |= rebuilds(o.failed[0], o.fresh[0], o.ctl + 1 + kFlagWords * (epoch & 1)) ? 1 : 0;
  }
  if (!__syncthreads_or(any)) return;  // (the whole launch: no member rebuilds)
  if (rb && held && own < g.k) {  // (read back by this thread in (b), by others after)
    g.box[2 * own] = own_lo;
    g.box[2 * own + 1] = own_hi;
  }

  // (b) count.
  if (rb) {
    for (int b = blockIdx.x * kThreads + t; b < g.k; b += stride) {
      if (!body_live(g, b)) continue;
      int home[3];
      const int ins = body_cells(g, b, home);
      for (int s = 0; s < kSlotsPerBody; ++s)
        if (ins & (1 << s)) atomicAdd(&g.count[slot_of(home, s, g.h)], 1);
    }
  }
  cg::this_grid().sync();

  // The exclusive scan of the counts: each block's tile summed, then each
  // block's prefix from the tile sums before it and its tile scanned.
  const int tile = (g.h + n_blocks - 1) / n_blocks;
  const int s0 = min(blockIdx.x * tile, g.h), s1 = min(s0 + tile, g.h);
  if (rb) {
    int sum = 0;
    for (int s = s0 + t; s < s1; s += kThreads) sum += g.count[s];
    sum = block_sum(sum);
    if (t == 0) g.tiles[blockIdx.x] = sum;
  }
  cg::this_grid().sync();
  if (rb) {
    int before = 0, all = 0;
    for (int j = t; j < n_blocks; j += kThreads) {
      const int v = g.tiles[j];
      all += v;
      if (j < (int)blockIdx.x) before += v;
    }
    before = block_sum(before);
    all = block_sum(all);
    int carry = before;
    for (int base = s0; base < s1; base += kThreads) {
      const int s = base + t;
      int tile_sum;
      const int ex = pies::block_exclusive_scan(s < s1 ? g.count[s] : 0, &tile_sum);
      if (s < s1) g.start[s] = carry + ex;
      carry += tile_sum;
    }
    if (blockIdx.x == 0 && t == 0) g.start[g.h] = all;
  }
  cg::this_grid().sync();

  // Fill: each entry at its slot's start plus its count decremented (the
  // counts end at zero, as the next call needs them); the cache's
  // reference positions.
  if (rb) {
    for (int b = blockIdx.x * kThreads + t; b < g.k; b += stride) {
      if (!body_live(g, b)) continue;
      int home[3];
      const int ins = body_cells(g, b, home);
      for (int s = 0; s < kSlotsPerBody; ++s) {
        if (!(ins & (1 << s))) continue;
        const int slot = slot_of(home, s, g.h);
        g.entries[g.start[slot] + atomicSub(&g.count[slot], 1) - 1] = b * kSlotsPerBody + s;
      }
    }
    const int nf = g.k * g.m * 3;
    for (int i = blockIdx.x * kThreads + t; i < nf; i += stride)
      g.ref[i] = g.x[(size_t)g.off * 3 + i];
  }
  cg::this_grid().sync();

  // (c) the query, a group of kGroup lanes a body.
  __shared__ int s_cand[kWarps][32 / kGroup * kMaxCand];
  if (rb) {
    const int q_bits = g.bmax <= 32 ? query_rows<32 / kGroup>(g, s_cand[warp])
                                    : query_rows<kMaxCand / kGroup>(g, s_cand[warp]);
    flag_block(flags, block_or(q_bits));
  }
  cg::this_grid().sync();

  // Freshness and the capacity latch.
  if (rb && blockIdx.x == 0 && t == 0) {
    g.fresh[0] = flags[kNarrowOver] != 0 ? 0 : 1;
    if (flags[kSizeOver] | flags[kGatherOver] | flags[kExactOver]) atomicOr(g.overflow, 1);
  }
}

int resident[pies::kMaxDevices];

}  // namespace

// Blocks per member of T5's grid for k bodies a member: up to a group of
// lanes a body, kBlocksPerSm blocks an SM for all members (0: an error).
extern "C" int pies_body_broadphase_grid(int members, int k) {
  return pies::coop_blocks((const void*)bp_kernel, kThreads, resident, members,
                           k > 0 ? (k + kThreads / kGroup - 1) / (kThreads / kGroup) : 1,
                           kBlocksPerSm);
}

// Scratch int32 words a member of T5's call takes for k bodies, a table of
// h slots and a grid of `grid` blocks a member.
extern "C" int pies_body_broadphase_words(int k, int h, int grid) {
  const size_t w = work_words(k, h, grid);
  return w < 0x7fffffff ? (int)w : -1;
}

extern "C" int pies_body_broadphase(
    const float* x, const float* prev, const float* tri_mask, int* pairs, int* valid,
    float* ref, int* fresh, int* rebuilt, int* work, int* overflow, const int* failed, int k,
    int m, int e, int off, int nb, int bmax, int cells_cap, int entries_cap, int h,
    int unpacked, int grid,
    float cell, float slack, float slack_c, float margin, float exact_margin,
    float size_limit, int n, int members, void* stream) {
  if (k <= 0 || m <= 0 || m > kMaxNodes || bmax > kMaxCand || nb <= 0 || members <= 0 ||
      h <= 0 || (h & (h - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int chunk =
      grid > 0 ? pies::coop_members((const void*)bp_kernel, kThreads, resident, grid) : 0;
  if (chunk <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  Geo g{x,        prev,    tri_mask, pairs,   valid,   ref,     fresh,   rebuilt,
        work,     overflow, failed,  nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr, work_words(k, h, grid)};
  g.k = k;
  g.m = m;
  g.e = e;
  g.off = off;
  g.nb = nb;
  g.bmax = bmax;
  g.cells_cap = cells_cap;
  g.entries_cap = entries_cap;
  g.h = h;
  g.unpacked = unpacked;
  g.n = n;
  g.member0 = 0;
  g.cell = cell;
  g.slack = slack;
  g.slack_c = slack_c;
  g.margin = margin;
  g.exact_margin = exact_margin;
  g.size_limit = size_limit;
  void* args[] = {&g};
  for (; g.member0 < members; g.member0 += chunk) {
    const int rest = members - g.member0;
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)bp_kernel, dim3(grid, rest < chunk ? rest : chunk), dim3(kThreads), args, 0,
        (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
