// Kernel T29: the broadphase's candidate occupancy and oversize counts, the
// count modes of the front ends of T5 (the packed-body grid, query and
// gather) and T16 (all-pairs and the cell list).
//
// Replaces (JAX): pies_tpu/collision/broadphase.py:1183-1253
// candidate_occupancy (with :1257 _tri_swept_aabb, :1333 _insertion_slots,
// :1358 _celllist_candidates up to its gather, grid.py build_grid,
// aabb_cell_slots and gather_candidates' counts) and
// pies_tpu/diagnostics.py:151-169 (broadphase_health's oversize and
// latching counts).
//
// Rows are triangles, or bodies of e triangles where the scene has a body
// stride (mode 0; a body's box is the union of its live triangles', 0 for a
// dead body).  Each row's count is what its front end would gather, without
// gathering it:
//  0 bodies, 2 cell list: the rows' insertion cells (grid.cuh: the home
//    cell, two corners on an oversize axis) counted into a table of
//    table_size_for(2 * rows) slots; a live row's query over the cells of
//    [lo - 1, hi] (range cap 8, at most cells_cap cells) totals
//    min(bucket count, entries_cap) over its cells, and its count is that
//    total capped at the budget (max_candidates_per_body, _per_tri): the
//    valid slots gather_candidates would fill;
//  1 all-pairs: the live rows other than itself whose swept box overlaps
//    its own with the CCD margin (shared nodes are not excluded, as in the
//    JAX function), uncapped; the budget is max_narrow_candidates.
// Then, over the rows: the largest count, the live rows' sum and number,
// and the live rows whose box spans more than 1 and more than 2 - margin
// cells on some axis.  All counts are integers (integer atomics for the
// table and the five words, which add up to the same value in any order),
// so kernel, twin and the JAX package agree exactly; the host forms the
// mean as a float32 sum over a float32 count, as the JAX package divides.
//
// Stages, back to back on one stream: (a) per triangle its swept box in
// cell units (IEEE division by the cell, as T16's stage (a)) and the table
// zeroed; (b) bodies only: per body the box over its live triangles; (c)
// grid modes: per live row its insertion cells counted; (d) per row its
// count and extent flags, reduced per warp and added into the five words.
//
// Bound: bytes for the grid modes (positions read once through the
// triangles, ~100 bytes a row with the table); all-pairs does rows^2 box
// tests (~20 comparisons and adds each).
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

constexpr int kBlock = 256;
enum Mode { kBodies = 0, kAllPairs = 1, kCellList = 2 };
enum Word { kCountMax = 0, kCountSum = 1, kLiveRows = 2, kOversize = 3, kLatching = 4 };

struct Occ {
  const float* x;
  const float* prev;
  const int* tris;
  const float* tri_mask;
  float* lo;  // [t + k, 3]: triangle boxes, then body boxes
  float* hi;
  int* table;
  int* out;
  int mode, t, k, e, cells_cap, entries_cap, budget, h;
  float cell, margin, size_limit;
};

__device__ __forceinline__ bool tri_live(const Occ& g, int r) { return g.tri_mask[r] > 0.0f; }
__device__ __forceinline__ int n_rows(const Occ& g) { return g.mode == kBodies ? g.k : g.t; }
__device__ __forceinline__ int row_base(const Occ& g) { return g.mode == kBodies ? g.t : 0; }

__device__ __forceinline__ bool row_live(const Occ& g, int i) {
  if (g.mode != kBodies) return tri_live(g, i);
  for (int j = 0; j < g.e; ++j)
    if (tri_live(g, i * g.e + j)) return true;
  return false;
}

// (a) triangle boxes; the table zeroed.
__global__ void __launch_bounds__(kBlock) occ_bounds_kernel(Occ g) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = r; i < g.h; i += gridDim.x * blockDim.x) g.table[i] = 0;
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
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    g.lo[r * 3 + d] = lo[d];
    g.hi[r * 3 + d] = hi[d];
  }
}

// (b) body boxes over their live triangles, 0 for a dead body.
__global__ void __launch_bounds__(kBlock) occ_body_bounds_kernel(Occ g) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= g.k) return;
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
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    g.lo[(size_t)(g.t + b) * 3 + d] = live ? lo[d] : 0.0f;
    g.hi[(size_t)(g.t + b) * 3 + d] = live ? hi[d] : 0.0f;
  }
}

// (c) a live row's insertion cells counted into their table slots.
__global__ void __launch_bounds__(kBlock) occ_insert_kernel(Occ g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows(g) || !row_live(g, i)) return;
  const size_t base = (size_t)row_base(g) * 3;
  count_row(g.lo + base, g.hi + base, i, g.h, g.table);
}

// A live row's candidate count on a grid: its query's capped total.
__device__ int grid_count(const Occ& g, const float* lo, const float* hi) {
  const float qlo[3] = {lo[0] - 1.0f, lo[1] - 1.0f, lo[2] - 1.0f};
  int base[3], len[3];
  const int cells = cell_range(qlo, hi, kRangeCap, base, len);
  const int n = cells < g.cells_cap ? cells : g.cells_cap;
  int total = 0;
  for (int s = 0; s < n; ++s) {
    const int c = g.table[range_slot(base, len, s, g.h)];
    total += c < g.entries_cap ? c : g.entries_cap;
  }
  return total < g.budget ? total : g.budget;
}

// A live row's all-pairs count: live rows other than itself whose box
// overlaps its own with the margin.
__device__ int pair_count(const Occ& g, int i, const float* lo, const float* hi) {
  float rlo[3], rhi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    rlo[d] = lo[d] - g.margin;
    rhi[d] = hi[d] + g.margin;
  }
  int count = 0;
  for (int j = 0; j < g.t; ++j) {
    if (j == i || !tri_live(g, j)) continue;
    const float* a = g.lo + (size_t)j * 3;
    const float* b = g.hi + (size_t)j * 3;
    if (a[0] <= rhi[0] && a[1] <= rhi[1] && a[2] <= rhi[2] && b[0] >= rlo[0] &&
        b[1] >= rlo[1] && b[2] >= rlo[2])
      ++count;
  }
  return count;
}

// (d) per row its count and extent flags, summed into the five words.
__global__ void __launch_bounds__(kBlock) occ_count_kernel(Occ g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int count = 0, live = 0, over = 0, latch = 0;
  if (i < n_rows(g) && row_live(g, i)) {
    const float* lo = g.lo + (size_t)(row_base(g) + i) * 3;
    const float* hi = g.hi + (size_t)(row_base(g) + i) * 3;
    live = 1;
    count = g.mode == kAllPairs ? pair_count(g, i, lo, hi) : grid_count(g, lo, hi);
    const float ext = nan_max(nan_max(hi[0] - lo[0], hi[1] - lo[1]), hi[2] - lo[2]);
    over = ext > 1.0f;
    latch = ext > g.size_limit;
  }
  const unsigned all = 0xffffffffu;
  const int w_max = (int)__reduce_max_sync(all, (unsigned)count);
  const int w_sum = (int)__reduce_add_sync(all, (unsigned)count);
  const int w_live = (int)__reduce_add_sync(all, (unsigned)live);
  const int w_over = (int)__reduce_add_sync(all, (unsigned)over);
  const int w_latch = (int)__reduce_add_sync(all, (unsigned)latch);
  if ((threadIdx.x & 31) == 0) {
    if (w_max) atomicMax(&g.out[kCountMax], w_max);
    if (w_sum) atomicAdd(&g.out[kCountSum], w_sum);
    if (w_live) atomicAdd(&g.out[kLiveRows], w_live);
    if (w_over) atomicAdd(&g.out[kOversize], w_over);
    if (w_latch) atomicAdd(&g.out[kLatching], w_latch);
  }
}

int blocks_for(int n) { return n > 0 ? (n + kBlock - 1) / kBlock : 0; }

}  // namespace

extern "C" int pies_occupancy(const float* x, const float* prev, const int* tris,
                              const float* tri_mask, float* bounds, int* table, int* out,
                              int mode, int t, int k, int e, int cells_cap, int entries_cap,
                              int budget, int h, float cell, float margin, float size_limit,
                              void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  Occ g{x, prev, tris, tri_mask, bounds, bounds + (size_t)(t + k) * 3, table, out,
        mode, t, k, e, cells_cap, entries_cap, budget, h, cell, margin, size_limit};
  const int rows = mode == kBodies ? k : t;
  const int zero_blocks = blocks_for(h);
  const int b_tris = blocks_for(t) > zero_blocks ? blocks_for(t) : zero_blocks;
  if (b_tris > 0) occ_bounds_kernel<<<b_tris, kBlock, 0, st>>>(g);
  if (mode == kBodies && k > 0) occ_body_bounds_kernel<<<blocks_for(k), kBlock, 0, st>>>(g);
  if (mode != kAllPairs && rows > 0) occ_insert_kernel<<<blocks_for(rows), kBlock, 0, st>>>(g);
  if (rows > 0) occ_count_kernel<<<blocks_for(rows), kBlock, 0, st>>>(g);
  return (int)cudaGetLastError();
}
