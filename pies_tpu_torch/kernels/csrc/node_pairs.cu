// Kernel T20: the node grid of the PBD node-node response and its temporal
// pair cache.
//
// Replaces (JAX): pies_tpu/collision/broadphase.py:1903
// _node_pair_candidates (node AABBs padded by 0.5 in grid_spacing cells,
// aabb_cell_slots with a range cap of 50, build_grid, gather_candidates,
// the per-row sort and dedup), :2018 _node_pair_prefix (the stable i-major
// compaction) and the drift-gated lax.cond of :2115 pbd_node_node_response
// around pies_tpu/state.py:65-92 NodePairCache.
//
// Stages, back to back on one stream; the cache is updated in place:
//  (a) a thread per node: |x - ref| past the slack, or a NaN, into two flag
//      words (zeroed just before);
//  (b) the decision, rebuild = !fresh || (exceed && !nan), written to the
//      device word `rebuilt` that every later stage reads and returns on:
//      a quiescent iteration runs no build stage and the host never waits;
//      on a rebuild: the table and the counts zeroed, ref = x;
//  (c) per live node: its box's cells (at most s) counted into their table
//      slots; exclusive scan (compact.cuh); fill each bucket through an
//      atomic cursor, then order its first entries_cap entries by entry
//      index (node*s + cell), the order of the JAX package's stable sort:
//      a thread per bucket of at most 32 entries (grid.cuh's order_bucket,
//      shared with T5, T14 and T16), a warp per larger bucket (a node's
//      padded box covers ~8 cells, so a bucket holds hundreds of entries at
//      the bench's density, too many for one thread's selection);
//  (d) a warp per live node, a lane per candidate slot (budget <= 32): the
//      gather in query-cell order (entries_cap per bucket, budget per row),
//      duplicates dropped, kept when j > i and j is live (and, with the
//      emit mask `emit`, broadphase.py:1966-1971, when i emits: the domain
//      decomposition's owned nodes), ranked by j; the row's count and, per
//      j, its count as the pair's second node;
//  (e) one exclusive scan over both counts (2N values): the i-major pair
//      offsets and the j-side list offsets;
//  (f) a thread per node: its pairs written at its offset (pi, pj), its
//      range row_off, and each pair's index into its j's list; the count and
//      fresh = 1; then each j list ordered ascending: the per-node incidence
//      of concat(pi, pj) in the JAX scatter's order, which kernel T21 sums
//      over until the next rebuild.
// Only counts use integer atomics; every order that decides a result comes
// from a scan or a sort, so reruns are bit-identical.
//
// Bound: device memory.  A rebuild reads the positions and writes about 27
// table entries per node plus the pair lists (~16 bytes per pair); a
// quiescent iteration reads 24 bytes per node.
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y is the member b of `members`, with its own nodes
// (positions, radii, mask from b*n), its own cache (pair lists of n*budget
// slots, count, ref, fresh, incidence, rebuild word) and its own scratch
// (hash table, bucket starts, entries, rows, counts, flag words, `big`
// list), each at b times its single-scene size (Np::member), and its latch
// failed[2b].  The two scans take one segment per member, gated on the
// member's rebuild word, so each member's pairs are its single-scene run's.
#include <cuda_runtime.h>

#include "compact.cuh"
#include "grid.cuh"

namespace {

constexpr int kNodeRangeCap = 50;
constexpr int kMaxNodeCells = 64;
constexpr int kPairWarps = 4;
constexpr int kSmallBucket = 32;  // larger buckets are ordered by a warp
constexpr int kMaxHead = 64;      // entries_cap a warp can order
constexpr int kBigBlocks = 264;   // two blocks of kPairWarps warps per SM

struct Np {
  const float* x;
  const float* radius;
  const float* mask;
  int* pi;
  int* pj;
  int* count;
  float* ref;
  int* fresh;
  int* row_off;
  int* inc_start;
  int* inc_pair;
  int* rebuilt;
  int* count_h;
  int* cursor;
  int* start;
  int* entries;
  int* rows;
  int* cnt2;
  int* off2;
  int* jcur;
  int* flags;
  int* big;  // [0]: how many; then the slots of the buckets a warp orders
  const int* failed;
  const float* emit;  // f32[n] or null: a pair is kept only where its i emits
  int n, s, entries_cap, budget, h;
  float spacing, slack;

  // Ints of the `big` list of a member.
  __host__ __device__ size_t big_stride() const {
    return 1 + (size_t)n * s / (kSmallBucket + 1);
  }

  // The view of member b: every per-member array offset to its row.
  __device__ __forceinline__ Np member(int b) const {
    Np m = *this;
    const size_t bb = b, nn = n, w = (size_t)n * budget, hh = h;
    m.x += bb * nn * 3;
    m.radius += bb * nn;
    m.mask += bb * nn;
    m.pi += bb * w;
    m.pj += bb * w;
    m.count += bb;
    m.ref += bb * nn * 3;
    m.fresh += bb;
    m.row_off += bb * (nn + 1);
    m.inc_start += bb * (nn + 1);
    m.inc_pair += bb * w;
    m.rebuilt += bb;
    m.count_h += bb * hh;
    m.cursor += bb * hh;
    m.start += bb * (hh + 1);
    m.entries += bb * nn * s;
    m.rows += bb * w;
    m.cnt2 += bb * 2 * nn;
    m.off2 += bb * (2 * nn + 1);
    m.jcur += bb * nn;
    m.flags += bb * 8;
    m.big += bb * big_stride();
    m.failed += 2 * bb;
    return m;
  }
};

// Node i's box in cell units and its range of cells (grid.cuh cell_range).
__device__ __forceinline__ int node_cells(const Np& g, int i, int base[3], int len[3]) {
  const float r = (g.radius[i] + 0.5f) / g.spacing;
  float lo[3], hi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float c = g.x[(size_t)i * 3 + d] / g.spacing;
    lo[d] = c - r;
    hi[d] = c + r;
  }
  const int total = cell_range(lo, hi, kNodeRangeCap, base, len);
  return total < g.s ? total : g.s;
}

__device__ __forceinline__ bool gated(const Np& g) { return g.rebuilt[0] == 0; }

// (a)
__global__ void __launch_bounds__(256) np_drift_kernel(Np g0) {
  const Np g = g0.member(blockIdx.y);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.n || g.failed[0] != 0) return;
  bool exceed = false, nan = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float dv = fabsf(g.x[(size_t)i * 3 + d] - g.ref[(size_t)i * 3 + d]);
    nan = nan || dv != dv;
    exceed = exceed || dv > g.slack;
  }
  if (exceed) atomicOr(&g.flags[kExceed], 1);
  if (nan) atomicOr(&g.flags[kNan], 1);
}

// (b)
__global__ void __launch_bounds__(256) np_prep_kernel(Np g0) {
  const Np g = g0.member(blockIdx.y);
  const bool due = g.failed[0] == 0 && rebuild_due(g.fresh, g.flags);
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid == 0) g.rebuilt[0] = due ? 1 : 0;
  if (!due) return;
  const int stride = gridDim.x * blockDim.x;
  for (int i = tid; i < g.h; i += stride) g.count_h[i] = g.cursor[i] = 0;
  for (int i = tid; i < 2 * g.n; i += stride) g.cnt2[i] = 0;
  if (tid == 0) g.big[0] = 0;
  for (int i = tid; i < g.n; i += stride) {
    g.jcur[i] = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) g.ref[(size_t)i * 3 + d] = g.x[(size_t)i * 3 + d];
  }
}

// (c) count, or fill, a live node's cells.
__global__ void __launch_bounds__(256) np_insert_kernel(Np g0, int fill) {
  const Np g = g0.member(blockIdx.y);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (gated(g) || i >= g.n || !(g.mask[i] > 0.0f)) return;
  int base[3], len[3];
  const int nc = node_cells(g, i, base, len);
  for (int k = 0; k < nc; ++k) {
    const int slot = range_slot(base, len, k, g.h);
    if (fill)
      g.entries[g.start[slot] + atomicAdd(&g.cursor[slot], 1)] = i * g.s + k;
    else
      atomicAdd(&g.count_h[slot], 1);
  }
}

__global__ void __launch_bounds__(256) np_order_kernel(Np g0) {
  const Np g = g0.member(blockIdx.y);
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (gated(g) || slot >= g.h) return;
  const int c = g.count_h[slot];
  if (c <= kSmallBucket)
    order_bucket(g.entries + g.start[slot], c, g.entries_cap);
  else
    g.big[1 + atomicAdd(&g.big[0], 1)] = slot;
}

// A warp per large bucket: its entries_cap smallest entries, ascending, into
// its first slots (entries are distinct; only those slots are ever read).
__global__ void __launch_bounds__(32 * kPairWarps) np_order_big_kernel(Np g0) {
  const Np g = g0.member(blockIdx.y);
  __shared__ int s_head[kPairWarps][kMaxHead];
  if (gated(g)) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  for (int b = blockIdx.x * kPairWarps + warp; b < g.big[0]; b += gridDim.x * kPairWarps) {
    const int slot = g.big[1 + b];
    int* e = g.entries + g.start[slot];
    const int c = g.count_h[slot];
    const int head = c < g.entries_cap ? c : g.entries_cap;
    int prev = -1;
    for (int i = 0; i < head; ++i) {
      int m = 0x7fffffff;
      for (int j = lane; j < c; j += 32) {
        const int v = e[j];
        if (v > prev && v < m) m = v;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const int other = __shfl_xor_sync(full, m, o);
        m = other < m ? other : m;
      }
      if (lane == 0) s_head[warp][i] = m;
      prev = m;
    }
    __syncwarp();
    for (int i = lane; i < head; i += 32) e[i] = s_head[warp][i];
    __syncwarp();
  }
}

// (d) a warp per node.
__global__ void __launch_bounds__(32 * kPairWarps) np_query_kernel(Np g0) {
  const Np g = g0.member(blockIdx.y);
  __shared__ int s_off[kPairWarps][kMaxNodeCells];
  __shared__ int s_start[kPairWarps][kMaxNodeCells];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kPairWarps + warp;
  if (gated(g) || r >= g.n || !(g.mask[r] > 0.0f)) return;
  const unsigned full = 0xffffffffu;
  int* off = s_off[warp];
  int* st = s_start[warp];
  int base[3], len[3];
  const int n_cells = node_cells(g, r, base, len);
  for (int k = lane; k < n_cells; k += 32) {
    const int slot = range_slot(base, len, k, g.h);
    const int c = g.count_h[slot];
    st[k] = g.start[slot];
    off[k] = c < g.entries_cap ? c : g.entries_cap;
  }
  __syncwarp();
  if (lane == 0) {  // inclusive offsets, in query order
    int run = 0;
    for (int k = 0; k < n_cells; ++k) {
      run += off[k];
      off[k] = run;
    }
  }
  __syncwarp();
  const int total = n_cells > 0 ? off[n_cells - 1] : 0;
  const int n_raw = total < g.budget ? total : g.budget;
  const bool valid = lane < n_raw;
  int cand = -1;
  if (valid) {
    int a = 0, b = n_cells - 1;  // the first cell whose inclusive offset exceeds lane
    while (a < b) {
      const int m = (a + b) >> 1;
      if (off[m] > lane)
        b = m;
      else
        a = m + 1;
    }
    cand = g.entries[st[a] + lane - (a > 0 ? off[a - 1] : 0)] / g.s;
    cand = cand < g.n - 1 ? cand : g.n - 1;
  }
  // A repeat of a lower lane's candidate is dropped; the rest are unique.
  bool dup = false;
  for (int m = 0; m < 32; ++m) {
    const int other = __shfl_sync(full, cand, m);
    dup = dup || (m < lane && valid && other == cand);
  }
  const bool ok = valid && !dup && cand > r && g.mask[cand] > 0.0f &&
                  (g.emit == nullptr || g.emit[r] > 0.0f);
  int rank = 0;
  const unsigned oks = __ballot_sync(full, ok);
  for (int m = 0; m < 32; ++m) {
    const int other = __shfl_sync(full, cand, m);
    rank += ((oks >> m) & 1u) && other < cand ? 1 : 0;
  }
  if (ok) {
    g.rows[(size_t)r * g.budget + rank] = cand;
    atomicAdd(&g.cnt2[g.n + cand], 1);
  }
  if (lane == 0) g.cnt2[r] = __popc(oks);
}

// (f) the pair prefix and the incidence.
__global__ void __launch_bounds__(256) np_scatter_kernel(Np g0) {
  const Np g = g0.member(blockIdx.y);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (gated(g) || r >= g.n) return;
  const int n = g.n;
  const int pairs = g.off2[n];
  const int base = g.off2[r];
  g.row_off[r] = base;
  g.inc_start[r] = g.off2[n + r] - pairs;
  if (r == n - 1) {
    g.row_off[n] = pairs;
    g.inc_start[n] = g.off2[2 * n] - pairs;
    g.count[0] = pairs;
    g.fresh[0] = 1;
  }
  const int rn = g.cnt2[r];
  for (int t = 0; t < rn; ++t) {
    const int k = base + t;
    const int j = g.rows[(size_t)r * g.budget + t];
    g.pi[k] = r;
    g.pj[k] = j;
    g.inc_pair[(g.off2[n + j] - pairs) + atomicAdd(&g.jcur[j], 1)] = k;
  }
}

__global__ void __launch_bounds__(256) np_jorder_kernel(Np g0) {
  const Np g = g0.member(blockIdx.y);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (gated(g) || r >= g.n) return;
  int* e = g.inc_pair + g.inc_start[r];
  const int c = g.inc_start[r + 1] - g.inc_start[r];
  for (int i = 1; i < c; ++i) {  // insertion sort: a node's list is short
    const int v = e[i];
    int j = i - 1;
    while (j >= 0 && e[j] > v) {
      e[j + 1] = e[j];
      --j;
    }
    e[j + 1] = v;
  }
}

}  // namespace

extern "C" int pies_node_pairs(const float* x, const float* radius, const float* mask, int* pi,
                               int* pj, int* count, float* ref, int* fresh, int* row_off,
                               int* inc_start, int* inc_pair, int* rebuilt, int* count_h,
                               int* cursor, int* start, int* partial, int* entries, int* rows,
                               int* cnt2, int* off2, int* jcur, int* flags, int* big,
                               const int* failed, const float* emit,
                               int n, int s, int entries_cap, int budget, int h, float spacing,
                               float slack, int members, void* stream) {
  if (n <= 0 || s <= 0 || s > kMaxNodeCells || budget <= 0 || budget > 32 || h <= 0 ||
      entries_cap <= 0 || entries_cap > kMaxHead || members <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Np g{x,      radius, mask,  pi,   pj,   count, ref,   fresh, row_off, inc_start,
       inc_pair, rebuilt, count_h, cursor, start, entries, rows, cnt2, off2, jcur,
       flags,  big,   failed, emit, n, s,  entries_cap, budget, h,  spacing, slack};
  cudaMemsetAsync(flags, 0, (size_t)members * 8 * sizeof(int), st);
  const dim3 nodes(pies::tiles(n), members);
  np_drift_kernel<<<nodes, pies::kBlock, 0, st>>>(g);
  const int wide = h > 2 * n ? h : 2 * n;
  const int prep_blocks = pies::tiles(wide) < 2048 ? pies::tiles(wide) : 2048;
  np_prep_kernel<<<dim3(prep_blocks, members), pies::kBlock, 0, st>>>(g);
  np_insert_kernel<<<nodes, pies::kBlock, 0, st>>>(g, 0);
  pies::exclusive_scan_i32(count_h, start, h, partial, st, rebuilt, members, 1);
  np_insert_kernel<<<nodes, pies::kBlock, 0, st>>>(g, 1);
  np_order_kernel<<<dim3(pies::tiles(h), members), pies::kBlock, 0, st>>>(g);
  np_order_big_kernel<<<dim3(kBigBlocks, members), 32 * kPairWarps, 0, st>>>(g);
  np_query_kernel<<<dim3((n + kPairWarps - 1) / kPairWarps, members), 32 * kPairWarps, 0,
                    st>>>(g);
  pies::exclusive_scan_i32(cnt2, off2, 2 * n, partial, st, rebuilt, members, 1);
  np_scatter_kernel<<<nodes, pies::kBlock, 0, st>>>(g);
  np_jorder_kernel<<<nodes, pies::kBlock, 0, st>>>(g);
  return (int)cudaGetLastError();
}
