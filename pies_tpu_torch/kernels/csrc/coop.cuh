// Cooperative launches of the one-kernel stages (T6, T7's setup): a grid
// whose blocks are all resident at once, so that the kernel can pass a grid
// barrier (cooperative_groups' this_grid().sync()) between its stages
// instead of ending and launching again.
#pragma once

#include <cuda_runtime.h>

// Everything is internal to each translation unit that includes this file.
namespace pies {
namespace {

constexpr int kMaxDevices = 64;

// Streaming multiprocessors of the current device (cached per device).
inline int sm_count() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (cached[dev] == 0) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

// Blocks of `threads` threads of `kernel` that the current device keeps
// resident at once (0 on an error); `cache` holds one value per device.
inline int resident_blocks(const void* kernel, int threads, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (cache[dev] == 0) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0) !=
        cudaSuccess)
      return 0;
    cache[dev] = per_sm * sm_count();
  }
  return cache[dev];
}

// The grid's blocks per member: at most `want`, at most `per_sm` per SM for
// all `members` together but at least 1, and never more than stay resident;
// 0 on an error.
inline int coop_blocks(const void* kernel, int threads, int* cache, int members, int want,
                       int per_sm) {
  const int resident = resident_blocks(kernel, threads, cache);
  if (resident <= 0 || members <= 0) return 0;
  int total = sm_count() * per_sm;
  total = total < resident ? total : resident;
  int g = total / members;
  g = g > 1 ? g : 1;
  return want < g ? (want > 0 ? want : 1) : g;
}

// Members that one cooperative launch of `grid` blocks per member holds, all
// resident (0: not even one).  A launcher covers more members with several
// launches, each over the next chunk of them.
inline int coop_members(const void* kernel, int threads, int* cache, int grid) {
  const int resident = resident_blocks(kernel, threads, cache);
  return grid > 0 ? resident / grid : 0;
}

}  // namespace
}  // namespace pies
