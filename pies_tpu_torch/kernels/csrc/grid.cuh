// The hash-grid pieces shared by the broadphase kernels T5, T14, T16 and
// T20: the reference's cell hash, a row's insertion cells, a box's range of
// cells, the ordering of a bucket's head, and the flag words of a build.
//
// Replaces (JAX): pies_tpu/collision/grid.py:33-187 (cell_hash,
// aabb_cell_slots, build_grid) and broadphase.py:1333 (_insertion_slots).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "nan_math.cuh"

// Everything is internal to each translation unit that includes this file.
namespace {

constexpr int kSlotsPerBody = 8;
constexpr int kRangeCap = 8;
constexpr int kSaturated = 127;
constexpr int kHardCap = 1000;

// The flag words of one broadphase call (kTruncOver only on the super-body
// layout).
enum Flag {
  kExceed = 0,
  kNan = 1,
  kSizeOver = 2,
  kGatherOver = 3,
  kNarrowOver = 4,
  kExactOver = 5,
  kRebuild = 6,
  kTruncOver = 7,
};

using pies::nan_max;
using pies::nan_min;

// The reference's spatial hash (SpatialHash.h:28-34) in uint32: int32
// cells reinterpreted as two's complement, products wrapping.
__device__ __forceinline__ int cell_slot(int cx, int cy, int cz, int h) {
  const uint32_t v = ((uint32_t)cx * 92837111u) ^ ((uint32_t)cy * 689287499u) ^
                     ((uint32_t)cz * 283923481u);
  return (int)(v & (uint32_t)(h - 1));
}

// A rebuild is due when the cache is stale or some node moved past the
// slack (a NaN displacement anywhere makes that test false, as jnp.max does).
__device__ __forceinline__ bool rebuild_due(const int* fresh, const int* flags) {
  return fresh[0] == 0 || (flags[kExceed] != 0 && flags[kNan] == 0);
}

// Insertion cells of row b with bounds lo, hi f32[k, 3] in cell units: bit s
// of the result is set when slot s (offsets x = s>>2, y = s>>1 & 1, z = s & 1
// from the home cell floor(lo)) is inserted: every offset axis must be one
// where the row spans more than one cell.
__device__ __forceinline__ int insertion_cells(const float* lo, const float* hi, int b,
                                               int home[3]) {
  bool over[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float l = lo[b * 3 + d], h = hi[b * 3 + d];
    home[d] = (int)floorf(l);
    over[d] = (h - l) > 1.0f;
  }
  int bits = 0;
#pragma unroll
  for (int s = 0; s < kSlotsPerBody; ++s) {
    const int ox = (s >> 2) & 1, oy = (s >> 1) & 1, oz = s & 1;
    if ((ox == 0 || over[0]) && (oy == 0 || over[1]) && (oz == 0 || over[2]))
      bits |= 1 << s;
  }
  return bits;
}

__device__ __forceinline__ int slot_of(const int home[3], int s, int h) {
  return cell_slot(home[0] + ((s >> 2) & 1), home[1] + ((s >> 1) & 1),
                   home[2] + (s & 1), h);
}

// Row b's insertion cells counted into their table slots.
__device__ __forceinline__ void count_row(const float* lo, const float* hi, int b, int h,
                                          int* count) {
  int home[3];
  const int bits = insertion_cells(lo, hi, b, home);
  for (int s = 0; s < kSlotsPerBody; ++s)
    if (bits & (1 << s)) atomicAdd(&count[slot_of(home, s, h)], 1);
}

// Row b's entries (b*8 + s) written into their buckets through the atomic
// cursors, in whatever order the atomics give.
__device__ __forceinline__ void fill_row(const float* lo, const float* hi, int b, int h,
                                         const int* start, int* cursor, int* entries) {
  int home[3];
  const int bits = insertion_cells(lo, hi, b, home);
  for (int s = 0; s < kSlotsPerBody; ++s) {
    if (!(bits & (1 << s))) continue;
    const int slot = slot_of(home, s, h);
    const int pos = start[slot] + atomicAdd(&cursor[slot], 1);
    entries[pos] = b * kSlotsPerBody + s;
  }
}

// A box's grid cells, x-major (grid.py aabb_cell_slots): the base cell and
// the per-axis lengths, zero on every axis when one exceeds range_cap;
// returns the cell count before the cap of slots.
__device__ __forceinline__ int cell_range(const float* qlo, const float* qhi, int range_cap,
                                          int base[3], int len[3]) {
  bool in_cap = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    base[d] = (int)floorf(qlo[d]);
    len[d] = (int)(ceilf(qhi[d]) - floorf(qlo[d]));
    len[d] = len[d] < 1 ? 1 : len[d];
    in_cap = in_cap && len[d] <= range_cap;
  }
  if (!in_cap) len[0] = len[1] = len[2] = 0;
  return len[0] * len[1] * len[2];
}

__device__ __forceinline__ int range_slot(const int base[3], const int len[3], int s, int h) {
  const int lyz = len[1] * len[2] > 1 ? len[1] * len[2] : 1;
  const int lz = len[2] > 1 ? len[2] : 1;
  const int dx = s / lyz, rem = s - dx * lyz;
  const int dy = rem / lz, dz = rem - dy * lz;
  return cell_slot(base[0] + dx, base[1] + dy, base[2] + dz, h);
}

// Only the first entries_cap entries of a bucket are ever read: select them
// in ascending order (all of them when the bucket is that small), the order
// of the JAX package's stable sort.
__device__ __forceinline__ void order_bucket(int* e, int c, int entries_cap) {
  if (c < 2) return;
  const int head = c < entries_cap ? c : entries_cap;
  for (int i = 0; i < head; ++i) {
    int best = i;
    for (int j = i + 1; j < c; ++j)
      if (e[j] < e[best]) best = j;
    const int t = e[i];
    e[i] = e[best];
    e[best] = t;
  }
}

}  // namespace
