// Block-level scans and the two-level exclusive scan shared by kernels
// T5-T7: the sorts, scans and compactions of the detection and of the node
// incidence are written here by hand (no CUB, no Thrust, no torch.sort on
// the device).  Integer atomics are used only for counts; every order that
// decides a result comes from a scan, so reruns are bit-identical.
//
// A compaction is three launches: each block of kBlock threads reduces its
// tile to one partial (block_exclusive_scan's total), one block scans the
// partials (scan_partials_kernel), and each block scans its tile again and
// adds its partial's prefix.
#pragma once

#include <cuda_runtime.h>

// Everything is internal to each translation unit that includes this file.
namespace pies {
namespace {

constexpr int kBlock = 256;  // threads per block of every scanned tile

// Exclusive prefix sum over the threads of a block (blockDim.x a multiple of
// 32, at most 1024); every thread must call it.  *total gets the block's
// sum in every thread.
template <typename T>
__device__ T block_exclusive_scan(T v, T* total) {
  __shared__ T warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < n_warps ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const T incl = x + (warp > 0 ? warp_sums[warp - 1] : T(0));
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return incl - v;
}

// Every scan kernel below returns at once when `gate` is given and *gate is
// 0 (a device flag: the caller's data-dependent early exit).
__device__ __forceinline__ bool gated_off(const int* gate) {
  return gate != nullptr && *gate == 0;
}

// In-place exclusive scan of data[0, n) by the calling block; the sum of
// all n values goes to *total when total is not null.
template <typename T>
__device__ void scan_range(T* data, int n, T* total) {
  __shared__ T carry;
  if (threadIdx.x == 0) carry = T(0);
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const T v = i < n ? data[i] : T(0);
    T tile;
    const T ex = block_exclusive_scan(v, &tile);
    if (i < n) data[i] = carry + ex;
    __syncthreads();
    if (threadIdx.x == 0) carry += tile;
    __syncthreads();
  }
  if (threadIdx.x == 0 && total != nullptr) *total = carry;
}

// In-place exclusive scan of data[0, n) by a single block.
template <typename T>
__global__ void scan_partials_kernel(T* data, int n, T* total, const int* gate) {
  if (gated_off(gate)) return;
  scan_range(data, n, total);
}

// One block per segment s (an ensemble member): the in-place exclusive scan
// of data[s*n, s*n + n), its sum to total[s*total_stride] (when total is not
// null), gated by gate[s*gate_stride].
template <typename T>
__global__ void scan_segments_kernel(T* data, int n, T* total, int total_stride,
                                     const int* gate, int gate_stride) {
  const int s = blockIdx.x;
  if (gated_off(gate == nullptr ? nullptr : gate + (size_t)s * gate_stride)) return;
  scan_range(data + (size_t)s * n, n,
             total == nullptr ? nullptr : total + (size_t)s * total_stride);
}

// Stage 1 of a two-level scan of an int array: each block's tile sum.
// Segment blockIdx.y reads in[y*n, y*n + n) and writes its row of partials.
__global__ void __launch_bounds__(kBlock)
    tile_sums_kernel(const int* __restrict__ in, int n, int* partial,
                     const int* gate, int gate_stride) {
  const size_t seg = blockIdx.y;
  if (gated_off(gate == nullptr ? nullptr : gate + seg * gate_stride)) return;
  in += seg * n;
  partial += seg * gridDim.x;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int tile;
  block_exclusive_scan(i < n ? in[i] : 0, &tile);
  if (threadIdx.x == 0) partial[blockIdx.x] = tile;
}

// Stage 3: out[i] = exclusive prefix of in[i] over the whole array (of
// segment blockIdx.y, whose out row holds n + 1 ints).
__global__ void __launch_bounds__(kBlock)
    tile_apply_kernel(const int* __restrict__ in, int n,
                      const int* __restrict__ partial, int* out,
                      const int* gate, int gate_stride) {
  const size_t seg = blockIdx.y;
  if (gated_off(gate == nullptr ? nullptr : gate + seg * gate_stride)) return;
  in += seg * n;
  partial += seg * gridDim.x;
  out += seg * (n + 1);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int tile;
  const int ex = block_exclusive_scan(i < n ? in[i] : 0, &tile);
  if (i < n) out[i] = partial[blockIdx.x] + ex;
}

inline int tiles(int n) { return n > 0 ? (n + kBlock - 1) / kBlock : 1; }

// out[0, n) = exclusive prefix sums of in[0, n), out[n] = the total.
// `partial` holds tiles(n) ints.  Three launches on `stream`, each a no-op
// when `gate` says so.  With `segments` > 1 (the members of an ensemble)
// the same for each segment s on its own: in[s*n, s*n + n) into
// out[s*(n+1), s*(n+1) + n + 1], partial[s*tiles(n), ...), gated by
// gate[s*gate_stride]; one segment is the plain scan.
inline void exclusive_scan_i32(const int* in, int* out, int n, int* partial,
                               cudaStream_t stream, const int* gate = nullptr,
                               int segments = 1, int gate_stride = 0) {
  const int nt = tiles(n);
  const dim3 grid(nt, segments);
  tile_sums_kernel<<<grid, kBlock, 0, stream>>>(in, n, partial, gate, gate_stride);
  scan_segments_kernel<int><<<segments, 1024, 0, stream>>>(partial, nt, out + n, n + 1, gate,
                                                           gate_stride);
  tile_apply_kernel<<<grid, kBlock, 0, stream>>>(in, n, partial, out, gate, gate_stride);
}

}  // namespace
}  // namespace pies
