// Kernel T14: the super-body broadphase with its temporal pair cache, for
// any triangle scene: a packed prefix of uniform bodies and one "loose" row
// per remaining triangle, every row's corner nodes in a table.
//
// Replaces (JAX): pies_tpu/collision/broadphase.py:710-849
// (_detect_point_tri_super's build_pairs and the cache), with
// grid.py:33-187,254-359 (table_size_for, cell_hash, aabb_cell_slots,
// build_grid, query_buckets, gather_entries), _insertion_slots (:1333) and
// _aabb_prefilter_pack (:1641).
// The cell hash, the insertion cells and the bucket ordering are grid.cuh's,
// shared by T5 and T14.
//
// Stages, back to back on one stream; each returns at once when the failure
// latch (slot 0) is set, and every stage after (a) when no rebuild is due:
//  (a) per node: the cache test max(|x-ref|, |prev-ref|) > slack over all
//      nodes (a NaN anywhere makes the test false, as jnp.max does);
//  (b) when a rebuild is due: the grid's counts and cursors zeroed; per row,
//      the swept AABB over prev and now of its corners (read through the
//      corner table; padding corners repeat corner 0 and cannot widen it) in
//      cell units +- slack, and the oversize latch;
//  (c) per row: the rebuild flag; up to 8 insertion cells, reference hash
//      in uint32, masked to the table; an atomic count per slot;
//  (d) exclusive scan of the counts (compact.cuh); fill each bucket through
//      an atomic cursor, then order each bucket's first entries_cap entries
//      by entry index (row*8 + slot): the order of the JAX package's stable
//      sort, whatever order the atomics gave;
//  (e) one warp per row: the query cells of [lo - margin - 1, hi + margin]
//      (<= cells_cap, range cap 8), a lane per cell; counts capped at
//      entries_cap, the latch at a bucket of >= 127 (the packed table's
//      saturation) or a total > 1000, and the latch of a truncated gather
//      (total > bmax); up to bmax raw candidates in query order, a lane per
//      candidate: the own row and the rows sharing a node (the row's adj
//      list, in shared memory) dropped, then the exact and slack AABB tiers;
//      the survivors' (tier, id) keys are compacted into shared memory,
//      duplicates marked, each first occurrence ranked among the others and
//      written to its slot of the nb-wide cache row;
//  (f) per node: the cache reference; one thread: fresh and overflow.
//
// Bound: gathers and integer work.  At 144,602 rows (510,000 nodes) a
// rebuild reads 12 MB of positions and the 2.3 MB corner table, writes and
// reads ~12 MB of grid, reads the 37 MB adj table and writes the 74 MB
// cache; a substep without rebuild reads 18 MB (x, prev, ref) and exits.
// A warp per row, because a row's 512 raw candidates, 64 neighbours and the
// rank sort of its survivors do not fit one thread's registers: the keys
// live in 4 KB of shared memory per warp.  The rank sort is quadratic in a
// row's survivors (a handful on most rows).
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y is the member b, and each member runs all of the above
// on its own, as T5 does: its nodes from b*n, its cache (pairs and valid [b]
// of [members, k, nb], ref [b] of [members, n, 3], fresh[b]), its own hash
// table (count, cursor, start, entries over the same h slots), its bounds,
// flag words, overflow word and latch.  So no pair joins rows of two
// members, and each member's rebuild, order and latches are those of a
// single-scene run.  The corner and adj tables are shared.
#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"
#include "grid.cuh"

namespace {

constexpr int kMaxCorners = 8;
constexpr int kMaxRaw = 512;
constexpr int kMaxCells = 64;
constexpr int kMaxAdj = 64;
constexpr int kWarpsPerBlock = 4;
constexpr long long kDead = 0x7fffffffffffffffLL;

struct Geo {
  const float* x;
  const float* prev;
  const int* corners;
  const int* adj;  // may be null
  int* pairs;
  int* valid;
  float* ref;
  int* fresh;
  int* count;
  int* cursor;
  int* start;
  int* entries;
  float* lo;
  float* hi;
  int* flags;
  int* overflow;
  const int* failed;
  int n, k, live_k, w, a, nb, bmax, cells_cap, entries_cap, h, unpacked;
  float cell, slack, slack_c, margin, exact_margin, size_limit;
};

// The view of member blockIdx.y: every per-member array offset to its row.
__device__ __forceinline__ Geo member_view(Geo g) {
  const size_t b = blockIdx.y;
  g.x += b * g.n * 3;
  g.prev += b * g.n * 3;
  g.pairs += b * g.k * g.nb;
  g.valid += b * g.k * g.nb;
  g.ref += b * g.n * 3;
  g.fresh += b;
  g.count += b * g.h;
  g.cursor += b * g.h;
  g.start += b * (g.h + 1);
  g.entries += b * kSlotsPerBody * g.k;
  g.lo += b * 6 * g.k;
  g.hi += b * 6 * g.k;
  g.flags += b * 8;
  g.overflow += b;
  g.failed += 2 * b;
  return g;
}

// (a) the displacement test over all nodes.
__global__ void __launch_bounds__(pies::kBlock) sb_disp_kernel(Geo g0) {
  const Geo g = member_view(g0);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.n || g.failed[0] != 0) return;
  bool exceed = false, nan = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float r = g.ref[(size_t)i * 3 + d];
    const float dx = fabsf(g.x[(size_t)i * 3 + d] - r);
    const float dp = fabsf(g.prev[(size_t)i * 3 + d] - r);
    if (dx != dx || dp != dp)
      nan = true;
    else if (dx > g.slack || dp > g.slack)
      exceed = true;
  }
  if (exceed) atomicOr(&g.flags[kExceed], 1);
  if (nan) atomicOr(&g.flags[kNan], 1);
}

// (b) bounds and the oversize latch.
__global__ void __launch_bounds__(pies::kBlock) sb_bounds_kernel(Geo g0) {
  const Geo g = member_view(g0);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (g.failed[0] != 0 || !rebuild_due(g.fresh, g.flags)) return;
  for (int i = b; i < g.h; i += gridDim.x * blockDim.x) g.count[i] = g.cursor[i] = 0;
  if (b >= g.k) return;
  float xmin[3], xmax[3], pmin[3], pmax[3];
  for (int j = 0; j < g.w; ++j) {
    const size_t node = (size_t)g.corners[(size_t)b * g.w + j];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float xv = g.x[node * 3 + d];
      const float pv = g.prev[node * 3 + d];
      if (j == 0) {
        xmin[d] = xmax[d] = xv;
        pmin[d] = pmax[d] = pv;
      } else {
        xmin[d] = nan_min(xmin[d], xv);
        xmax[d] = nan_max(xmax[d], xv);
        pmin[d] = nan_min(pmin[d], pv);
        pmax[d] = nan_max(pmax[d], pv);
      }
    }
  }
  const bool live = b < g.live_k;
  bool too_big = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float lo = nan_min(xmin[d], pmin[d]) / g.cell - g.slack_c;
    float hi = nan_max(xmax[d], pmax[d]) / g.cell + g.slack_c;
    if (!live) lo = hi = 0.0f;
    too_big = too_big || (hi - lo) > g.size_limit;
    g.lo[b * 3 + d] = lo;
    g.hi[b * 3 + d] = hi;
  }
  if (too_big && live) atomicOr(&g.flags[kSizeOver], 1);
}

// (c) the rebuild flag and the per-slot counts.
__global__ void __launch_bounds__(pies::kBlock) sb_count_kernel(Geo g0) {
  const Geo g = member_view(g0);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.k || g.failed[0] != 0) return;
  const bool rebuild = rebuild_due(g.fresh, g.flags);
  if (b == 0) g.flags[kRebuild] = rebuild ? 1 : 0;
  if (!rebuild || b >= g.live_k) return;
  count_row(g.lo, g.hi, b, g.h, g.count);
}

// (d) fill each bucket (any order), then order its head.
__global__ void __launch_bounds__(pies::kBlock) sb_fill_kernel(Geo g0) {
  const Geo g = member_view(g0);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.live_k || g.failed[0] != 0 || g.flags[kRebuild] == 0) return;
  fill_row(g.lo, g.hi, b, g.h, g.start, g.cursor, g.entries);
}

__global__ void __launch_bounds__(pies::kBlock) sb_order_kernel(Geo g0) {
  const Geo g = member_view(g0);
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= g.h || g.failed[0] != 0 || g.flags[kRebuild] == 0) return;
  order_bucket(g.entries + g.start[slot], g.count[slot], g.entries_cap);
}

// (e) query, gather, drops, prefilter, dedup, pack: one warp per row.
__global__ void __launch_bounds__(32 * kWarpsPerBlock) sb_query_kernel(Geo g0) {
  const Geo g = member_view(g0);
  __shared__ long long s_key[kWarpsPerBlock][kMaxRaw];
  __shared__ int s_off[kWarpsPerBlock][kMaxCells];
  __shared__ int s_start[kWarpsPerBlock][kMaxCells];
  __shared__ int s_adj[kWarpsPerBlock][kMaxAdj];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= g.k || g.failed[0] != 0 || g.flags[kRebuild] == 0) return;
  int* prow = g.pairs + (size_t)b * g.nb;
  int* vrow = g.valid + (size_t)b * g.nb;
  if (b >= g.live_k) {
    for (int j = lane; j < g.nb; j += 32) prow[j] = vrow[j] = 0;
    return;
  }
  long long* key = s_key[warp];
  int* off = s_off[warp];
  int* st = s_start[warp];
  int* adj = s_adj[warp];
  const unsigned full = 0xffffffffu;

  float lo[3], hi[3];
  int base[3], len[3];
  bool in_cap = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = g.lo[b * 3 + d];
    hi[d] = g.hi[b * 3 + d];
    const float qlo = lo[d] - g.margin - 1.0f;
    const float qhi = hi[d] + g.margin;
    base[d] = (int)floorf(qlo);
    len[d] = (int)(ceilf(qhi) - floorf(qlo));
    len[d] = len[d] < 1 ? 1 : len[d];
    in_cap = in_cap && len[d] <= kRangeCap;
  }
  if (!in_cap) len[0] = len[1] = len[2] = 0;
  const int total_cells = len[0] * len[1] * len[2];
  const int n_cells = total_cells < g.cells_cap ? total_cells : g.cells_cap;
  const int lyz = len[1] * len[2] > 1 ? len[1] * len[2] : 1;
  const int lz = len[2] > 1 ? len[2] : 1;

  // A lane per query cell: the bucket's start and capped count.
  bool over = false;
  for (int s = lane; s < n_cells; s += 32) {
    const int dx = s / lyz, rem = s - dx * lyz;
    const int dy = rem / lz, dz = rem - dy * lz;
    const int slot = cell_slot(base[0] + dx, base[1] + dy, base[2] + dz, g.h);
    const int c = g.count[slot];
    over = over || (g.unpacked ? c > kHardCap : c >= kSaturated);
    st[s] = g.start[slot];
    off[s] = c < g.entries_cap ? c : g.entries_cap;
  }
  for (int j = lane; j < g.a; j += 32) adj[j] = g.adj[(size_t)b * g.a + j];
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
  if (lane == 0) {
    if (over || total > kHardCap) atomicOr(&g.flags[kGatherOver], 1);
    if (total > g.bmax) atomicOr(&g.flags[kTruncOver], 1);
  }
  const int n_raw = total < g.bmax ? total : g.bmax;

  // A lane per raw candidate; survivors' keys compacted in candidate order.
  int n_key = 0;
  for (int j0 = 0; j0 < n_raw; j0 += 32) {
    const int j = j0 + lane;
    bool keep = false;
    long long kv = 0;
    if (j < n_raw) {
      int c = 0;
      while (off[c] <= j) ++c;  // the cell of raw slot j
      const int entry = st[c] + j - (c > 0 ? off[c - 1] : 0);
      int cand = g.entries[entry] / kSlotsPerBody;
      cand = cand < g.k - 1 ? cand : g.k - 1;
      keep = cand != b;
      for (int t = 0; keep && t < g.a; ++t) keep = cand != adj[t];
      if (keep) {
        bool ov = true, ex = true;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float alo = g.lo[cand * 3 + d], ahi = g.hi[cand * 3 + d];
          ov = ov && (alo <= hi[d] + g.margin) && (ahi >= lo[d] - g.margin);
          ex = ex && (alo <= hi[d] + g.exact_margin) && (ahi >= lo[d] - g.exact_margin);
        }
        keep = ex || ov;
        kv = ((long long)(ex ? 0 : 1) << 32) | (long long)cand;
      }
    }
    const unsigned ballot = __ballot_sync(full, keep);
    if (keep) key[n_key + __popc(ballot & ((1u << lane) - 1u))] = kv;
    n_key += __popc(ballot);
  }
  __syncwarp();

  // Mark every key that repeats an earlier one (the tier is a function of
  // the id, so equal ids have equal keys).
  unsigned dup = 0;  // bit t: key lane + 32 t is a repeat
  for (int i = lane, t = 0; i < n_key; i += 32, ++t) {
    const long long v = key[i];
    for (int j = 0; j < i; ++j)
      if (key[j] == v) {
        dup |= 1u << t;
        break;
      }
  }
  __syncwarp();
  for (int i = lane, t = 0; i < n_key; i += 32, ++t)
    if (dup & (1u << t)) key[i] = kDead;
  __syncwarp();

  // Rank each first occurrence among the others: its slot by (tier, id).
  int n_unique = 0, n_exact = 0;
  for (int i = lane; i < n_key; i += 32) {
    const long long v = key[i];
    if (v == kDead) continue;
    int rank = 0;
    for (int j = 0; j < n_key; ++j) rank += key[j] < v ? 1 : 0;
    if (rank < g.nb) prow[rank] = (int)(v & 0xffffffffLL);
    ++n_unique;
    if ((v >> 32) == 0) ++n_exact;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    n_unique += __shfl_xor_sync(full, n_unique, o);
    n_exact += __shfl_xor_sync(full, n_exact, o);
  }
  for (int j = lane; j < g.nb; j += 32) {
    if (j >= n_unique) prow[j] = 0;
    vrow[j] = j < n_unique ? 1 : 0;
  }
  if (lane == 0) {
    if (n_unique > g.nb) atomicOr(&g.flags[kNarrowOver], 1);
    if (n_exact > g.nb) atomicOr(&g.flags[kExactOver], 1);
  }
}

// (f) the cache reference, freshness and the capacity latch.
__global__ void __launch_bounds__(pies::kBlock) sb_finish_kernel(Geo g0) {
  const Geo g = member_view(g0);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (g.failed[0] != 0 || g.flags[kRebuild] == 0) return;
  if (t < g.n) {
#pragma unroll
    for (int d = 0; d < 3; ++d) g.ref[(size_t)t * 3 + d] = g.x[(size_t)t * 3 + d];
  }
  if (t == 0) {
    g.fresh[0] = g.flags[kNarrowOver] != 0 ? 0 : 1;
    if (g.flags[kSizeOver] | g.flags[kGatherOver] | g.flags[kExactOver] |
        g.flags[kTruncOver])
      atomicOr(g.overflow, 1);
  }
}

}  // namespace

extern "C" int pies_super_broadphase(
    const float* x, const float* prev, const int* corners, const int* adj,
    int* pairs, int* valid, float* ref, int* fresh, int* count, int* cursor,
    int* start, int* partial, int* entries, float* bounds, int* flags,
    int* overflow, const int* failed, int n, int k, int live_k, int w, int a,
    int nb, int bmax, int cells_cap, int entries_cap, int h, int unpacked,
    float cell, float slack, float slack_c, float margin, float exact_margin,
    float size_limit, int members, void* stream) {
  if (n > 0 && k > 0 && w > 0 && w <= kMaxCorners && bmax <= kMaxRaw &&
      cells_cap <= kMaxCells && a <= kMaxAdj && members > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    Geo g{x,     prev,    corners, adj,   pairs,   valid,    ref,
          fresh, count,   cursor,  start, entries, bounds,   bounds + (size_t)3 * k,
          flags, overflow, failed, n,     k,       live_k,   w,
          adj != nullptr ? a : 0,  nb,    bmax,    cells_cap, entries_cap,
          h,     unpacked, cell,   slack, slack_c, margin,   exact_margin,
          size_limit};
    const dim3 kb(pies::tiles(k), members), nb_(pies::tiles(n), members);
    sb_disp_kernel<<<nb_, pies::kBlock, 0, s>>>(g);
    sb_bounds_kernel<<<kb, pies::kBlock, 0, s>>>(g);
    sb_count_kernel<<<kb, pies::kBlock, 0, s>>>(g);
    pies::exclusive_scan_i32(count, start, h, partial, s, flags + kRebuild, members, 8);
    sb_fill_kernel<<<kb, pies::kBlock, 0, s>>>(g);
    sb_order_kernel<<<dim3(pies::tiles(h), members), pies::kBlock, 0, s>>>(g);
    sb_query_kernel<<<dim3((k + kWarpsPerBlock - 1) / kWarpsPerBlock, members),
                      32 * kWarpsPerBlock, 0, s>>>(g);
    sb_finish_kernel<<<nb_, pies::kBlock, 0, s>>>(g);
  }
  return (int)cudaGetLastError();
}
