// Kernel T5: the packed-body broadphase with its temporal pair cache.
//
// Replaces (JAX): pies_tpu/collision/broadphase.py:241-383
// (_detect_point_tri_bodies_packed's build_pairs and the cache), with
// grid.py:33-187,254-359 (table_size_for, cell_hash, aabb_cell_slots,
// build_grid, query_buckets, gather_entries), _insertion_slots (:1333) and
// _aabb_prefilter_pack (:1641); it also covers the bucket lookup that
// scripts/ab_pallas_lookup.py:95 benchmarks (table[idx] per queried cell).
// The cell hash, the insertion cells and the bucket ordering are grid.cuh's,
// shared by T5 and T14.
//
// Stages, back to back on one stream; each returns at once when the failure
// latch (slot 0) is set, and every stage after (a) when no rebuild is due:
//  (a) per body: swept AABB over prev and now in cell units +- slack, the
//      oversize latch, and the cache test max(|x-ref|, |prev-ref|) > slack
//      (a NaN anywhere makes the test false, as jnp.max does);
//  (b) per body: the rebuild flag; up to 8 insertion cells, reference hash
//      in uint32, masked to the table; an atomic count per slot;
//  (c) exclusive scan of the counts (compact.cuh);
//  (d) fill each bucket through an atomic cursor, then order each bucket's
//      first entries_cap entries by entry index (item*8 + slot): the order
//      of the JAX package's stable sort, whatever order the atomics gave;
//  (e) per body: query cells of [lo-1, hi] (<= cells_cap, range cap 8),
//      counts capped at entries_cap, the latch at a bucket of >= 127 (the
//      packed table's saturation) or a total > 1000, up to bmax candidates
//      in query order, the own body dropped, the exact and slack AABB tiers,
//      dedup by (tier, id), packed into nb slots; writes the cache row;
//  (f) per body node: the cache reference; one thread: fresh and overflow.
//
// Bound: gathers and integer work.  At 500k particles (125k bodies) a
// rebuild reads the 8 MB of positions and writes/reads ~10 MB of grid; a
// substep without rebuild reads 12 MB (x, prev, ref) and exits.  The design
// is one thread per body with its candidates in registers and local memory.
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y is the member b, and each member runs all of the above
// on its own: its nodes from b*n, its cache row (pairs, valid, ref, fresh),
// its own hash table (count, cursor, start, entries over the same h slots),
// its bounds, flag words, overflow word and latch.  No member ever reads
// another's table, so no pair joins bodies of two members, and each member's
// rebuild, order and latches are those of a single-scene run.  The triangle
// mask is shared.
#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"
#include "grid.cuh"

namespace {

constexpr int kMaxNodes = 8;
constexpr int kMaxCand = 64;

struct Geo {
  const float* x;
  const float* prev;
  const float* tri_mask;
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
  int k, m, e, off, nb, bmax, cells_cap, entries_cap, h, unpacked, n;
  float cell, slack, slack_c, margin, exact_margin, size_limit;
};

// The view of member blockIdx.y: every per-member array offset to its row.
__device__ __forceinline__ Geo member_view(Geo g) {
  const size_t b = blockIdx.y;
  g.x += b * g.n * 3;
  g.prev += b * g.n * 3;
  g.pairs += b * g.k * g.nb;
  g.valid += b * g.k * g.nb;
  g.ref += b * g.k * g.m * 3;
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

__device__ __forceinline__ bool body_live(const Geo& g, int b) {
  for (int j = 0; j < g.e; ++j)
    if (g.tri_mask[(size_t)b * g.e + j] > 0.0f) return true;
  return false;
}

// (a) bounds, oversize latch, displacement test.
__global__ void __launch_bounds__(pies::kBlock) bp_bounds_kernel(Geo g0) {
  const Geo g = member_view(g0);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.k || g.failed[0] != 0) return;
  const size_t n0 = (size_t)g.off + (size_t)b * g.m;
  float xmin[3], xmax[3], pmin[3], pmax[3];
  bool exceed = false, nan = false;
  for (int j = 0; j < g.m; ++j) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float xv = g.x[(n0 + j) * 3 + d];
      const float pv = g.prev[(n0 + j) * 3 + d];
      if (j == 0) {
        xmin[d] = xmax[d] = xv;
        pmin[d] = pmax[d] = pv;
      } else {
        xmin[d] = nan_min(xmin[d], xv);
        xmax[d] = nan_max(xmax[d], xv);
        pmin[d] = nan_min(pmin[d], pv);
        pmax[d] = nan_max(pmax[d], pv);
      }
      const float r = g.ref[((size_t)b * g.m + j) * 3 + d];
      const float dx = fabsf(xv - r), dp = fabsf(pv - r);
      if (dx != dx || dp != dp)
        nan = true;
      else if (dx > g.slack || dp > g.slack)
        exceed = true;
    }
  }
  const bool live = body_live(g, b);
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
  if (exceed) atomicOr(&g.flags[kExceed], 1);
  if (nan) atomicOr(&g.flags[kNan], 1);
}

// (b) the rebuild flag and the per-slot counts.
__global__ void __launch_bounds__(pies::kBlock) bp_count_kernel(Geo g0) {
  const Geo g = member_view(g0);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.k || g.failed[0] != 0) return;
  const bool rebuild = rebuild_due(g.fresh, g.flags);
  if (b == 0) g.flags[kRebuild] = rebuild ? 1 : 0;
  if (!rebuild || !body_live(g, b)) return;
  count_row(g.lo, g.hi, b, g.h, g.count);
}

// (d) fill each bucket (any order), then (d2) order its head.
__global__ void __launch_bounds__(pies::kBlock) bp_fill_kernel(Geo g0) {
  const Geo g = member_view(g0);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.k || g.failed[0] != 0 || g.flags[kRebuild] == 0) return;
  if (!body_live(g, b)) return;
  fill_row(g.lo, g.hi, b, g.h, g.start, g.cursor, g.entries);
}

__global__ void __launch_bounds__(pies::kBlock) bp_order_kernel(Geo g0) {
  const Geo g = member_view(g0);
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= g.h || g.failed[0] != 0 || g.flags[kRebuild] == 0) return;
  order_bucket(g.entries + g.start[slot], g.count[slot], g.entries_cap);
}

// (e) query, gather, prefilter, pack.
__global__ void __launch_bounds__(128) bp_query_kernel(Geo g0) {
  const Geo g = member_view(g0);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.k || g.failed[0] != 0 || g.flags[kRebuild] == 0) return;
  int* prow = g.pairs + (size_t)b * g.nb;
  int* vrow = g.valid + (size_t)b * g.nb;
  if (!body_live(g, b)) {
    for (int j = 0; j < g.nb; ++j) prow[j] = vrow[j] = 0;
    return;
  }
  float lo[3], hi[3];
  int base[3], len[3];
  bool in_cap = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = g.lo[b * 3 + d];
    hi[d] = g.hi[b * 3 + d];
    const float q = lo[d] - 1.0f;
    base[d] = (int)floorf(q);
    len[d] = (int)(ceilf(hi[d]) - floorf(q));
    len[d] = len[d] < 1 ? 1 : len[d];
    in_cap = in_cap && len[d] <= kRangeCap;
  }
  if (!in_cap) len[0] = len[1] = len[2] = 0;
  const int total_cells = len[0] * len[1] * len[2];
  const int n_cells = total_cells < g.cells_cap ? total_cells : g.cells_cap;
  const int lyz = len[1] * len[2] > 1 ? len[1] * len[2] : 1;
  const int lz = len[2] > 1 ? len[2] : 1;

  int cand[kMaxCand];
  int n_cand = 0, total = 0;
  bool over = false;
  for (int s = 0; s < n_cells; ++s) {
    const int dx = s / lyz, rem = s - dx * lyz;
    const int dy = rem / lz, dz = rem - dy * lz;
    const int slot = cell_slot(base[0] + dx, base[1] + dy, base[2] + dz, g.h);
    const int c = g.count[slot];
    over = over || (g.unpacked ? c > kHardCap : c >= kSaturated);
    const int ct = c < g.entries_cap ? c : g.entries_cap;
    const int st = g.start[slot];
    for (int j = 0; j < ct && total + j < g.bmax; ++j)
      cand[n_cand++] = g.entries[st + j] / kSlotsPerBody;
    total += ct;
  }
  if (over || total > kHardCap) atomicOr(&g.flags[kGatherOver], 1);

  // Tier 0: exact overlap, 1: slack-only overlap; dead candidates dropped.
  long long key[kMaxCand];
  int n_key = 0;
  for (int i = 0; i < n_cand; ++i) {
    const int c = cand[i] < g.k - 1 ? cand[i] : g.k - 1;
    if (c == b) continue;
    bool ov = true, ex = true;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float alo = g.lo[c * 3 + d], ahi = g.hi[c * 3 + d];
      ov = ov && (alo <= hi[d] + g.margin) && (ahi >= lo[d] - g.margin);
      ex = ex && (alo <= hi[d] + g.exact_margin) && (ahi >= lo[d] - g.exact_margin);
    }
    if (ex || ov) key[n_key++] = ((long long)(ex ? 0 : 1) << 32) | (long long)c;
  }
  for (int i = 1; i < n_key; ++i) {  // insertion sort by (tier, id)
    const long long v = key[i];
    int j = i - 1;
    while (j >= 0 && key[j] > v) {
      key[j + 1] = key[j];
      --j;
    }
    key[j + 1] = v;
  }
  int n_unique = 0, n_exact = 0;
  for (int i = 0; i < n_key; ++i) {
    if (i > 0 && key[i] == key[i - 1]) continue;
    if (n_unique < g.nb) prow[n_unique] = (int)(key[i] & 0xffffffffLL);
    ++n_unique;
    if ((key[i] >> 32) == 0) ++n_exact;
  }
  for (int j = 0; j < g.nb; ++j) {
    if (j >= n_unique) prow[j] = 0;
    vrow[j] = j < n_unique ? 1 : 0;
  }
  if (n_unique > g.nb) atomicOr(&g.flags[kNarrowOver], 1);
  if (n_exact > g.nb) atomicOr(&g.flags[kExactOver], 1);
}

// (f) the cache reference, freshness and the capacity latch.
__global__ void __launch_bounds__(pies::kBlock) bp_finish_kernel(Geo g0) {
  const Geo g = member_view(g0);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (g.failed[0] != 0 || g.flags[kRebuild] == 0) return;
  if (t < g.k * g.m) {
#pragma unroll
    for (int d = 0; d < 3; ++d)
      g.ref[(size_t)t * 3 + d] = g.x[((size_t)g.off + t) * 3 + d];
  }
  if (t == 0) {
    g.fresh[0] = g.flags[kNarrowOver] != 0 ? 0 : 1;
    if (g.flags[kSizeOver] | g.flags[kGatherOver] | g.flags[kExactOver])
      atomicOr(g.overflow, 1);
  }
}

}  // namespace

extern "C" int pies_body_broadphase(
    const float* x, const float* prev, const float* tri_mask, int* pairs,
    int* valid, float* ref, int* fresh, int* count, int* cursor, int* start,
    int* partial, int* entries, float* bounds, int* flags, int* overflow,
    const int* failed, int k, int m, int e, int off, int nb, int bmax,
    int cells_cap, int entries_cap, int h, int unpacked, float cell,
    float slack, float slack_c, float margin, float exact_margin,
    float size_limit, int n, int members, void* stream) {
  if (k > 0 && m > 0 && m <= kMaxNodes && bmax <= kMaxCand && members > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    Geo g{x,     prev,    tri_mask, pairs,        valid,    ref,
          fresh, count,   cursor,   start,        entries,  bounds,
          bounds + (size_t)3 * k,   flags,        overflow, failed,
          k,     m,       e,        off,          nb,       bmax,
          cells_cap,      entries_cap,            h,        unpacked, n,
          cell,  slack,   slack_c,  margin,       exact_margin, size_limit};
    const dim3 kb(pies::tiles(k), members);
    bp_bounds_kernel<<<kb, pies::kBlock, 0, s>>>(g);
    bp_count_kernel<<<kb, pies::kBlock, 0, s>>>(g);
    pies::exclusive_scan_i32(count, start, h, partial, s, flags + kRebuild, members, 8);
    bp_fill_kernel<<<kb, pies::kBlock, 0, s>>>(g);
    bp_order_kernel<<<dim3(pies::tiles(h), members), pies::kBlock, 0, s>>>(g);
    bp_query_kernel<<<dim3((k + 127) / 128, members), 128, 0, s>>>(g);
    bp_finish_kernel<<<dim3(pies::tiles(k * m), members), pies::kBlock, 0, s>>>(g);
  }
  return (int)cudaGetLastError();
}
