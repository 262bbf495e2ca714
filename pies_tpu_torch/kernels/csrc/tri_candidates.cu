// Kernel T16: the candidate stage of the per-triangle point-triangle
// branches, one front end per branch, each ending in a packed row of
// candidate triangles per triangle (ascending, duplicates dropped) and the
// latch words.
//
// Replaces (JAX): pies_tpu/collision/broadphase.py:104-207
// (_detect_point_tri_allpairs up to its CCD), :1088-1166
// (_detect_point_tri_bodies up to its CCD), :1358-1428
// (_celllist_candidates), :1551-1626 (_detect_point_tri_reference up to its
// CCD), :1257 (_tri_swept_aabb) and :1641-1766 (_aabb_prefilter_pack with
// one tier and dedup), with grid.py:33-187,254-411 (aabb_cell_slots,
// build_grid, gather_candidates).  The cell hash, the home-cell insertion
// and the bucket ordering are grid.cuh's, shared with T5 and T14.
//
// Modes (the branch the JAX package's dispatch picks):
//  0 all-pairs: every triangle's swept box against every other's, with the
//    CCD margin; live, self and shared-node pairs dropped; a warp per row
//    streams the columns through shared memory in tiles and packs its
//    overlaps in ascending column order with one ballot per 32 columns (no
//    sort).  Latch: a row with more than nb overlaps (narrow_over).
//  1 cell list: home-cell insertion (two corners on an oversize axis) into
//    a table of table_size_for(2T) slots; each row queries the cells of
//    [lo - 1, hi] (range cap 8); the oversize latch at 2 - margin.
//  2 bodies: the cell list over body boxes (the union of a body's live
//    triangles), packed into nbb body slots, then expanded arithmetically
//    to each member triangle's row (body b -> triangles b*e .. b*e+e-1).
//  3 reference: multi-cell insertion (range cap 50) and queries (range cap
//    20) over max_cells_per_tri slots, each range latch set when a row's
//    cells do not fit; a table of min(table_size_for(T*S, 1), 2^22).
// The grid modes gather up to `raw` candidates per row in query-cell order
// (entries_cap per bucket; the latch at a bucket of >= 127 entries, or past
// 1000 with an unpacked table, or a row total past 1000), keep those whose
// box overlaps the row's with the margin, drop repeats and write the
// survivors' ids ascending into the row's first slots (the JAX package's
// (tier, id) sort with one tier); the latch when more survive than fit.
//
// Stages, back to back on one stream; each returns at once when the
// failure latch (slot 0) is set, and the row stages then write empty rows:
//  (a) per triangle: swept box over prev and now of its corners, each
//      coordinate divided by the cell (IEEE division, as the JAX package
//      divides); the table's counts and cursors zeroed; the oversize latch;
//  (b) bodies only: per body, the box over its live triangles;
//  (c) per live item: its insertion cells counted into their table slots;
//  (d) exclusive scan of the counts (compact.cuh); fill each bucket through
//      an atomic cursor, then order its first entries_cap entries by entry
//      index (item*S + slot), the order of the JAX package's stable sort;
//  (e) a warp per row: query, gather, margin test, dedup and pack;
//  (f) bodies only: a warp per triangle expands its body's row;
//  (g) one thread: the capacity latch into `overflow`.
// flags[0] counts the candidate slots filled over all rows; kernel T17
// does nothing when it is 0 (the JAX package's lax.cond on jnp.any(ov)).
//
// The emit mask (`emit`, f32[T], may be null; broadphase.py:152-153,
// :1410-1411, :1595-1596): a triangle whose entry is 0 still inserts and
// serves as a candidate but queries nothing, so its row is empty; the
// latches it would set on insertion and, in reference mode, on its query
// range stay as without the mask.  The domain decomposition
// (pies_tpu/parallel/domain.py) passes each slab's owned triangles, so
// that every contact is emitted by exactly one slab.  Not in mode 2.
//
// Bound: bytes for the grid modes (positions, the grid and the rows:
// ~100 bytes a triangle), operations for all-pairs (T^2 box tests of ~20
// integer and float comparisons each; at 26,508 rows, 7e8 tests).
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y is the member b, and each member runs its branch on
// its own: its nodes from b*n, its own table (count, cursor, start,
// entries), bounds, body rows, candidate rows and counts, flag words
// (flags[b*8]: the filled count and the latches, all-pairs' n2 latch
// among them), overflow word and latch.  The triangles and their mask are
// shared.  So each member's candidate rows, and the gate T17 reads, are a
// single-scene run's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"
#include "grid.cuh"

namespace {

constexpr int kMaxRaw = 1024;
constexpr int kMaxCells = 512;
constexpr int kQueryWarps = 4;
constexpr int kPairWarps = 8;
constexpr int kTile = 256;  // all-pairs columns staged per block and tile
constexpr int kRefInsertCap = 50;
constexpr int kRefQueryCap = 20;
constexpr int kDead = 0x7fffffff;

enum Mode { kAllPairs = 0, kCellList = 1, kBodies = 2, kReference = 3 };
// The flag words (collision/broadphase.py TRI_FLAGS).
enum TriFlag {
  kFilled = 0,
  kTriSizeOver = 1,
  kTriGatherOver = 2,
  kTriExactOver = 3,
  kTriNarrowOver = 4,
  kInsOver = 5,
  kQueryOver = 6,
};

struct Tc {
  const float* x;
  const float* prev;
  const int* tris;
  const float* tri_mask;
  int* count_h;
  int* cursor;
  int* start;
  int* entries;
  float* lo;  // [t + k, 3]: triangle boxes, then body boxes
  float* hi;
  int* bodies;
  int* n_bodies;
  int* cand;
  int* count;
  int* flags;
  int* overflow;
  const int* failed;
  const float* emit;  // may be null
  int mode, t, k, e, s, cells_cap, entries_cap, raw, nbb, nb, h, unpacked, n;
  float cell, margin, size_limit;
};

// The view of member blockIdx.y: every per-member array offset to its row.
__device__ __forceinline__ Tc member_view(Tc g) {
  const size_t b = blockIdx.y;
  const size_t hh = g.h > 0 ? g.h : 1;
  g.x += b * g.n * 3;
  g.prev += b * g.n * 3;
  g.count_h += b * hh;
  g.cursor += b * hh;
  g.start += b * (hh + 1);
  g.entries += b * (g.k * g.s > 0 ? (size_t)g.k * g.s : 1);
  g.lo += b * 6 * (size_t)(g.t + g.k);
  g.hi += b * 6 * (size_t)(g.t + g.k);
  g.bodies += b * g.k * (size_t)(g.nbb > 0 ? g.nbb : 1);
  g.n_bodies += b * g.k;
  g.cand += b * g.t * (size_t)g.nb;
  g.count += b * g.t;
  g.flags += b * 8;
  g.overflow += b;
  g.failed += 2 * b;
  return g;
}

__device__ __forceinline__ bool tri_live(const Tc& g, int r) { return g.tri_mask[r] > 0.0f; }
__device__ __forceinline__ bool tri_emits(const Tc& g, int r) {
  return g.emit == nullptr || g.emit[r] > 0.0f;
}

// The items of the grid: triangles, or bodies in mode 2 (their boxes after
// the triangles').
__device__ __forceinline__ int n_items(const Tc& g) { return g.mode == kBodies ? g.k : g.t; }
__device__ __forceinline__ int item_base(const Tc& g) { return g.mode == kBodies ? g.t : 0; }

__device__ __forceinline__ bool item_live(const Tc& g, int i) {
  if (g.mode != kBodies) return tri_live(g, i);
  for (int j = 0; j < g.e; ++j)
    if (tri_live(g, i * g.e + j)) return true;
  return false;
}

// (a) triangle boxes, the table zeroed, the oversize latch (cell list).
__global__ void __launch_bounds__(pies::kBlock) tc_bounds_kernel(Tc g0) {
  const Tc g = member_view(g0);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (g.failed[0] != 0) return;
  for (int i = r; i < g.h; i += gridDim.x * blockDim.x) g.count_h[i] = g.cursor[i] = 0;
  if (r >= g.t) return;
  float lo[3], hi[3];
  for (int j = 0; j < 3; ++j) {
    const size_t node = (size_t)g.tris[r * 3 + j];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float xv = g.x[node * 3 + d] / g.cell;
      const float pv = g.prev[node * 3 + d] / g.cell;
      const float a = nan_min(xv, pv), b = nan_max(xv, pv);
      lo[d] = j == 0 ? a : nan_min(lo[d], a);
      hi[d] = j == 0 ? b : nan_max(hi[d], b);
    }
  }
  bool too_big = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    g.lo[r * 3 + d] = lo[d];
    g.hi[r * 3 + d] = hi[d];
    too_big = too_big || (hi[d] - lo[d]) > g.size_limit;
  }
  if (g.mode == kCellList && too_big && tri_live(g, r)) atomicOr(&g.flags[kTriSizeOver], 1);
}

// (b) body boxes over their live triangles, 0 for a dead body.
__global__ void __launch_bounds__(pies::kBlock) tc_body_bounds_kernel(Tc g0) {
  const Tc g = member_view(g0);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.k || g.failed[0] != 0) return;
  const float big = 3.0e38f;
  float lo[3] = {big, big, big}, hi[3] = {-big, -big, -big};
  bool live = false;
  for (int j = 0; j < g.e; ++j) {
    const int r = b * g.e + j;
    if (!tri_live(g, r)) continue;
    live = true;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = nan_min(lo[d], g.lo[r * 3 + d]);
      hi[d] = nan_max(hi[d], g.hi[r * 3 + d]);
    }
  }
  bool too_big = false;
  float* blo = g.lo + (size_t)(g.t + b) * 3;
  float* bhi = g.hi + (size_t)(g.t + b) * 3;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    if (!live) lo[d] = hi[d] = 0.0f;
    blo[d] = lo[d];
    bhi[d] = hi[d];
    too_big = too_big || (hi[d] - lo[d]) > g.size_limit;
  }
  if (too_big && live) atomicOr(&g.flags[kTriSizeOver], 1);
}

// (c) an item's insertion cells counted, or (with `start`) filled.
__device__ __forceinline__ void insert_item(const Tc& g, int i, bool fill) {
  const float* lo = g.lo + (size_t)item_base(g) * 3;
  const float* hi = g.hi + (size_t)item_base(g) * 3;
  if (g.mode != kReference) {
    if (fill)
      fill_row(lo, hi, i, g.h, g.start, g.cursor, g.entries);
    else
      count_row(lo, hi, i, g.h, g.count_h);
    return;
  }
  int base[3], len[3];
  const int total = cell_range(lo + i * 3, hi + i * 3, kRefInsertCap, base, len);
  if (!fill && total > g.s) atomicOr(&g.flags[kInsOver], 1);
  const int n = total < g.s ? total : g.s;
  for (int s = 0; s < n; ++s) {
    const int slot = range_slot(base, len, s, g.h);
    if (fill)
      g.entries[g.start[slot] + atomicAdd(&g.cursor[slot], 1)] = i * g.s + s;
    else
      atomicAdd(&g.count_h[slot], 1);
  }
}

__global__ void __launch_bounds__(pies::kBlock) tc_count_kernel(Tc g0) {
  const Tc g = member_view(g0);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items(g) || g.failed[0] != 0 || !item_live(g, i)) return;
  insert_item(g, i, false);
}

__global__ void __launch_bounds__(pies::kBlock) tc_fill_kernel(Tc g0) {
  const Tc g = member_view(g0);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items(g) || g.failed[0] != 0 || !item_live(g, i)) return;
  insert_item(g, i, true);
}

__global__ void __launch_bounds__(pies::kBlock) tc_order_kernel(Tc g0) {
  const Tc g = member_view(g0);
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= g.h || g.failed[0] != 0) return;
  order_bucket(g.entries + g.start[slot], g.count_h[slot], g.entries_cap);
}

// The tail of every grid row, all lanes of the warp: keys[0, n_key) hold
// the surviving candidate ids in gather order.  Repeats are dropped, each
// first occurrence is ranked among the others by id, and the first `narrow`
// go to out[rank]; the rest of the row is zeroed.  Returns the unique count
// (every lane).
__device__ int pack_keys(int* keys, int n_key, int* out, int narrow) {
  const unsigned full = 0xffffffffu;
  // Mark every key that repeats an earlier one (bit u: key lane + 32 u).
  unsigned dup = 0;
  for (int i = threadIdx.x & 31, u = 0; i < n_key; i += 32, ++u) {
    const int v = keys[i];
    for (int j = 0; j < i; ++j)
      if (keys[j] == v) {
        dup |= 1u << u;
        break;
      }
  }
  __syncwarp();
  for (int i = threadIdx.x & 31, u = 0; i < n_key; i += 32, ++u)
    if (dup & (1u << u)) keys[i] = kDead;
  __syncwarp();
  int n_unique = 0;
  for (int i = threadIdx.x & 31; i < n_key; i += 32) {
    const int v = keys[i];
    if (v == kDead) continue;
    int rank = 0;
    for (int j = 0; j < n_key; ++j) rank += keys[j] < v ? 1 : 0;
    if (rank < narrow) out[rank] = v;
    ++n_unique;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n_unique += __shfl_xor_sync(full, n_unique, o);
  for (int j = (threadIdx.x & 31) + n_unique; j < narrow; j += 32) out[j] = 0;
  __syncwarp();
  return n_unique;
}

// Does the box of item c (bounds lo, hi) overlap the row's box, with the
// margin, on every axis?
__device__ __forceinline__ bool overlaps(const float* lo, const float* hi, int c,
                                         const float rlo_m[3], const float rhi_m[3]) {
  bool ov = true;
#pragma unroll
  for (int d = 0; d < 3; ++d)
    ov = ov && (lo[c * 3 + d] <= rhi_m[d]) && (hi[c * 3 + d] >= rlo_m[d]);
  return ov;
}

// (e) a warp per grid row: query, gather, margin test, pack.
__global__ void __launch_bounds__(32 * kQueryWarps) tc_query_kernel(Tc g0) {
  const Tc g = member_view(g0);
  __shared__ int s_key[kQueryWarps][kMaxRaw];
  __shared__ int s_off[kQueryWarps][kMaxCells];
  __shared__ int s_start[kQueryWarps][kMaxCells];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kQueryWarps + warp;
  const int items = n_items(g);
  if (r >= items) return;
  const bool bodies = g.mode == kBodies;
  const int narrow = bodies ? g.nbb : g.nb;
  int* out = bodies ? g.bodies + (size_t)r * g.nbb : g.cand + (size_t)r * g.nb;
  if (g.failed[0] != 0 || !item_live(g, r)) {
    for (int j = lane; j < narrow; j += 32) out[j] = 0;
    if (lane == 0) (bodies ? g.n_bodies : g.count)[r] = 0;
    return;
  }
  int* key = s_key[warp];
  int* off = s_off[warp];
  int* st = s_start[warp];
  const unsigned full = 0xffffffffu;
  const float* lo = g.lo + (size_t)item_base(g) * 3;
  const float* hi = g.hi + (size_t)item_base(g) * 3;

  float qlo[3], qhi[3], rlo_m[3], rhi_m[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float l = lo[r * 3 + d], u = hi[r * 3 + d];
    qlo[d] = g.mode == kReference ? l : l - 1.0f;
    qhi[d] = u;
    rlo_m[d] = l - g.margin;
    rhi_m[d] = u + g.margin;
  }
  int base[3], len[3];
  const int total_cells =
      cell_range(qlo, qhi, g.mode == kReference ? kRefQueryCap : kRangeCap, base, len);
  const int n_cells = total_cells < g.cells_cap ? total_cells : g.cells_cap;
  if (g.mode == kReference && total_cells > g.cells_cap && lane == 0)
    atomicOr(&g.flags[kQueryOver], 1);
  if (!bodies && !tri_emits(g, r)) {
    for (int j = lane; j < narrow; j += 32) out[j] = 0;
    if (lane == 0) g.count[r] = 0;
    return;
  }

  // A lane per query cell: the bucket's start and capped count.
  bool over = false;
  for (int s = lane; s < n_cells; s += 32) {
    const int slot = range_slot(base, len, s, g.h);
    const int c = g.count_h[slot];
    over = over || (g.unpacked ? c > kHardCap : c >= kSaturated);
    st[s] = g.start[slot];
    off[s] = c < g.entries_cap ? c : g.entries_cap;
  }
  __syncwarp();
  if (lane == 0) {  // inclusive offsets, in query order
    int run = 0;
    for (int s = 0; s < n_cells; ++s) {
      run += off[s];
      off[s] = run;
    }
  }
  __syncwarp();
  const int total = n_cells > 0 ? off[n_cells - 1] : 0;
  over = __any_sync(full, over);
  if (lane == 0 && (over || total > kHardCap)) atomicOr(&g.flags[kTriGatherOver], 1);
  const int n_raw = total < g.raw ? total : g.raw;

  // A lane per raw candidate; survivors compacted in gather order.
  int n_key = 0;
  for (int j0 = 0; j0 < n_raw; j0 += 32) {
    const int j = j0 + lane;
    bool keep = false;
    int cand = 0;
    if (j < n_raw) {
      int a = 0, b = n_cells - 1;  // the first cell whose inclusive offset exceeds j
      while (a < b) {
        const int m = (a + b) >> 1;
        if (off[m] > j)
          b = m;
        else
          a = m + 1;
      }
      const int entry = st[a] + j - (a > 0 ? off[a - 1] : 0);
      cand = g.entries[entry] / g.s;
      cand = cand < items - 1 ? cand : items - 1;
      keep = overlaps(lo, hi, cand, rlo_m, rhi_m);
    }
    const unsigned ballot = __ballot_sync(full, keep);
    if (keep) key[n_key + __popc(ballot & ((1u << lane) - 1u))] = cand;
    n_key += __popc(ballot);
  }
  __syncwarp();
  const int n_unique = pack_keys(key, n_key, out, narrow);
  const int n_out = n_unique < narrow ? n_unique : narrow;
  if (lane == 0) {
    if (n_unique > narrow) atomicOr(&g.flags[kTriExactOver], 1);
    if (bodies) {
      g.n_bodies[r] = n_out;
    } else {
      g.count[r] = n_out;
      atomicAdd(&g.flags[kFilled], n_out);
    }
  }
}

// (f) bodies: a warp per triangle packs its body's row, expanded to
// triangles, that overlap its own box.
__global__ void __launch_bounds__(32 * kQueryWarps) tc_expand_kernel(Tc g0) {
  const Tc g = member_view(g0);
  __shared__ int s_key[kQueryWarps][kMaxRaw];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kQueryWarps + warp;
  if (r >= g.t) return;
  int* out = g.cand + (size_t)r * g.nb;
  if (g.failed[0] != 0 || !tri_live(g, r)) {
    for (int j = lane; j < g.nb; j += 32) out[j] = 0;
    if (lane == 0) g.count[r] = 0;
    return;
  }
  int* key = s_key[warp];
  const unsigned full = 0xffffffffu;
  float rlo_m[3], rhi_m[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    rlo_m[d] = g.lo[r * 3 + d] - g.margin;
    rhi_m[d] = g.hi[r * 3 + d] + g.margin;
  }
  const int b = r / g.e;
  const int n_raw = g.n_bodies[b] * g.e;
  int n_key = 0;
  for (int j0 = 0; j0 < n_raw; j0 += 32) {
    const int j = j0 + lane;
    bool keep = false;
    int cand = 0;
    if (j < n_raw) {
      cand = g.bodies[(size_t)b * g.nbb + j / g.e] * g.e + j % g.e;
      keep = overlaps(g.lo, g.hi, cand, rlo_m, rhi_m);
    }
    const unsigned ballot = __ballot_sync(full, keep);
    if (keep) key[n_key + __popc(ballot & ((1u << lane) - 1u))] = cand;
    n_key += __popc(ballot);
  }
  __syncwarp();
  const int n_unique = pack_keys(key, n_key, out, g.nb);
  const int n_out = n_unique < g.nb ? n_unique : g.nb;
  if (lane == 0) {
    if (n_unique > g.nb) atomicOr(&g.flags[kTriExactOver], 1);
    g.count[r] = n_out;
    atomicAdd(&g.flags[kFilled], n_out);
  }
}

// Mode 0: a warp per row, kPairWarps rows per block; the columns' boxes,
// corners and liveness staged in shared memory kTile at a time.
__global__ void __launch_bounds__(32 * kPairWarps) tc_allpairs_kernel(Tc g0) {
  const Tc g = member_view(g0);
  __shared__ float c_lo[kTile][3], c_hi[kTile][3];
  __shared__ int c_tri[kTile][3];
  __shared__ int c_live[kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kPairWarps + warp;
  const bool failed = g.failed[0] != 0;
  const bool row_ok = r < g.t && !failed && tri_live(g, r) && tri_emits(g, r);
  const unsigned full = 0xffffffffu;
  float rlo_m[3] = {0.0f, 0.0f, 0.0f}, rhi_m[3] = {0.0f, 0.0f, 0.0f};
  int rt[3] = {0, 0, 0};
  if (row_ok) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      rlo_m[d] = g.lo[r * 3 + d] - g.margin;
      rhi_m[d] = g.hi[r * 3 + d] + g.margin;
      rt[d] = g.tris[r * 3 + d];
    }
  }
  int* out = g.cand + (size_t)r * g.nb;
  int n = 0;
  if (!failed) {
    for (int c0 = 0; c0 < g.t; c0 += kTile) {
      __syncthreads();
      for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        const int c = c0 + i;
        const bool in = c < g.t;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          c_lo[i][d] = in ? g.lo[c * 3 + d] : 0.0f;
          c_hi[i][d] = in ? g.hi[c * 3 + d] : 0.0f;
          c_tri[i][d] = in ? g.tris[c * 3 + d] : 0;
        }
        c_live[i] = in && tri_live(g, c) ? 1 : 0;
      }
      __syncthreads();
      if (!row_ok) continue;
      for (int i0 = 0; i0 < kTile && c0 + i0 < g.t; i0 += 32) {
        const int i = i0 + lane;
        const int c = c0 + i;
        bool ov = c_live[i] != 0 && c != r;
#pragma unroll
        for (int d = 0; d < 3; ++d) ov = ov && c_lo[i][d] <= rhi_m[d] && c_hi[i][d] >= rlo_m[d];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b) ov = ov && rt[a] != c_tri[i][b];
        const unsigned ballot = __ballot_sync(full, ov);
        const int pos = n + __popc(ballot & ((1u << lane) - 1u));
        if (ov && pos < g.nb) out[pos] = c;
        n += __popc(ballot);
      }
    }
  }
  if (r >= g.t) return;
  const int n_out = n < g.nb ? n : g.nb;
  for (int j = lane + n_out; j < g.nb; j += 32) out[j] = 0;
  if (lane == 0) {
    g.count[r] = n_out;
    if (!failed) {
      if (n > g.nb) atomicOr(&g.flags[kTriNarrowOver], 1);
      atomicAdd(&g.flags[kFilled], n_out);
    }
  }
}

// (g) the capacity latch.
__global__ void tc_finish_kernel(Tc g0) {
  const Tc g = member_view(g0);
  if (g.failed[0] != 0) return;
  int any = 0;
  for (int f = kTriSizeOver; f < 8; ++f) any |= g.flags[f];
  if (any) atomicOr(g.overflow, 1);
}

}  // namespace

extern "C" int pies_tri_candidates(
    const float* x, const float* prev, const int* tris, const float* tri_mask, int* count_h,
    int* cursor, int* start, int* partial, int* entries, float* bounds, int* bodies,
    int* n_bodies, int* cand, int* count, int* flags, int* overflow, const int* failed,
    const float* emit, int mode, int t, int k, int e, int s, int cells_cap, int entries_cap,
    int raw, int nbb, int nb, int h, int unpacked, float cell, float margin, float size_limit,
    int n, int members, void* stream) {
  const bool grid = mode != kAllPairs;
  if (t > 0 && nb > 0 && n > 0 && members > 0 && mode >= kAllPairs && mode <= kReference &&
      (!grid || (raw <= kMaxRaw && cells_cap <= kMaxCells && h > 0 && s > 0)) &&
      (mode != kBodies || (e > 0 && k * e == t && nbb > 0 && nbb * e <= kMaxRaw &&
                           emit == nullptr))) {
    cudaStream_t st = (cudaStream_t)stream;
    // bounds [members, 2, t + k, 3]: a member's triangle and body boxes, lo then hi.
    Tc g{x,      prev,        tris,     tri_mask, count_h,   cursor, start,
         entries, bounds,     bounds + (size_t)3 * (t + k),  bodies, n_bodies,
         cand,   count,       flags,    overflow, failed,    emit,   mode,   t,
         k,      e,           s,        cells_cap, entries_cap, raw, nbb,
         nb,     h,           unpacked, n,        cell,      margin, size_limit};
    tc_bounds_kernel<<<dim3(pies::tiles(t), members), pies::kBlock, 0, st>>>(g);
    if (mode == kAllPairs) {
      tc_allpairs_kernel<<<dim3((t + kPairWarps - 1) / kPairWarps, members), 32 * kPairWarps, 0,
                           st>>>(g);
    } else {
      const int items = mode == kBodies ? k : t;
      const dim3 ib(pies::tiles(items), members);
      if (mode == kBodies)
        tc_body_bounds_kernel<<<dim3(pies::tiles(k), members), pies::kBlock, 0, st>>>(g);
      tc_count_kernel<<<ib, pies::kBlock, 0, st>>>(g);
      pies::exclusive_scan_i32(count_h, start, h, partial, st, nullptr, members, 0);
      tc_fill_kernel<<<ib, pies::kBlock, 0, st>>>(g);
      tc_order_kernel<<<dim3(pies::tiles(h), members), pies::kBlock, 0, st>>>(g);
      tc_query_kernel<<<dim3((items + kQueryWarps - 1) / kQueryWarps, members),
                        32 * kQueryWarps, 0, st>>>(g);
      if (mode == kBodies)
        tc_expand_kernel<<<dim3((t + kQueryWarps - 1) / kQueryWarps, members),
                           32 * kQueryWarps, 0, st>>>(g);
    }
    tc_finish_kernel<<<dim3(1, members), 1, 0, st>>>(g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
