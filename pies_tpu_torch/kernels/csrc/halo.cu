// Kernel T30: the halo exchange of the spatial domain decomposition, the
// slabs of one device and the outer bands that other ranks send, and the
// gather of the slabs' contact lists into the flat scene.
//
// Replaces (JAX): pies_tpu/parallel/domain.py:581 _halo_refresh and :596
// _halo_reduce (each two ppermutes between neighbouring slabs; between two
// ranks' slabs the ppermutes become the bands below), with the
// count-averaged applies that follow the reduced accumulators (:889-892,
// :903-911, :941-942, :952-953) and the p.Ap partials of the domain CG's
// psum'd dot (:620-632).
//
// Layout: D slabs of L owned nodes (f32[D, L, k], k = 1, 3 or 4) and their
// views of V = L + 2B slots (f32[D, V, k]): B halo slots copied from the
// left neighbour's tail, the L owned slots, B from the right neighbour's
// head.  The slabs of one device exchange by a gather between neighbouring
// slabs' rows.  Across ranks (pies_tpu_torch/parallel/ranks.py) a device
// holds D of the domain's slabs, and its two outer bands come from the
// neighbouring ranks (torch.distributed moves them, outside the kernel):
// `left` f32[B, k] stands in for slab -1 and `right` f32[B, k] for slab D;
// a missing band (the domain's first or last slab, a rank with no
// neighbour on that side) is zero, as ppermute with no source gives.
//
//  refresh   view[s, v] = own[s-1, L-B+v] (v < B), own[s, v-B],
//            own[s+1, v-B-L] (v >= B+L), where own[-1, L-B+v] = left[v]
//            (the left rank's last slab's tail) and own[D, v] = right[v]
//            (the right rank's first slab's head); with `zero_halo` the
//            halos are zero (the owned values embedded in the view);
//  reduce    own[s, i] = view[s, B+i], then + view[s+1, i-(L-B)] where
//            i >= L-B, then + view[s-1, B+L+i] where i < B: the JAX
//            package's own.at[l-b:].add(from_right).at[:b].add(from_left),
//            in that order (it matters where 2B > L); view[D, i] = right[i]
//            (the right rank's first slab's left-halo partials) and
//            view[-1, B+L+i] = left[i] (the left rank's last slab's
//            right-halo partials), added in the same order as an inner
//            neighbour's.  The bands a rank sends are view[0, :B] and
//            view[D-1, B+L:] (and own[0, :B], own[D-1, L-B:] for the
//            refresh): contiguous rows, sent as they lie.  Modes:
//              0 sum: the reduced values (k = 1, 3, 4);
//              1 apply: k = 4 accumulators (xyz sums, count), delta =
//                xyz / max(count, 1) added to x_own and prev_own in place,
//                then, with `active`, x_own = stat where active > 0 (the
//                floor snap of a stabilization pass); nothing when the
//                latch slot 0 is set;
//              2 average: k = 4 accumulators to xyz / max(count, 1);
//            with `part` (mode 0, k = 3) also the CG's block partials of
//            p.y over the flat owned index, cg_reduce.cuh's tree, which
//            kernel T11's update reads as T10's partials (across ranks
//            `part` points at this rank's slice of the gathered buffer);
//  merge     the slabs' contact lists i32[D, cap, w] (each a live prefix of
//            count[s], kept up to `keep` entries) into one list of the flat
//            scene (slab s's node ids + s V), slab after slab, the rest of
//            the D cap rows zero; the total count;
//  merge_pairs  the slabs' node-pair prefixes (kernel T20's caches, kept up
//            to `keep` pairs each) into one cache of the flat scene: the
//            pairs, the i-major offsets row_off clipped to the kept pairs,
//            the j-lists' starts at s W and their pair indices shifted by
//            the slab's offset, where a dropped pair or an empty slot reads
//            INT_MAX (node_contacts.cuh's node_lists stops at the first
//            index at or past the cap, and kept pairs come first in each
//            node's list).
//
// Bound: device memory; one pass over the values moved (refresh reads L k
// and writes V k floats a slab, reduce reads V k and writes L k, plus x and
// prev in the apply mode).  No atomics: every output has one writer.
#include <cuda_runtime.h>

#include <climits>

#include "cg_reduce.cuh"

namespace {

constexpr int kThreads = pies::kCgBlock;  // the reduce's partials need 256

struct Halo {
  int d, l, b, k;
  const float* left;   // f32[B, k] from the left rank, or null: zero
  const float* right;  // f32[B, k] from the right rank, or null: zero
  __device__ __forceinline__ int v() const { return l + 2 * b; }
};

__global__ void __launch_bounds__(kThreads)
    refresh_kernel(const float* __restrict__ own, float* __restrict__ view, Halo h,
                   int zero_halo) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int vv = h.v();
  if (g >= (long long)h.d * vv) return;
  const int s = (int)(g / vv), v = (int)(g - (long long)s * vv);
  int src_s = s, src_i = v - h.b;
  if (v < h.b) {
    src_s = s - 1;
    src_i = h.l - h.b + v;
  } else if (v >= h.b + h.l) {
    src_s = s + 1;
    src_i = v - h.b - h.l;
  }
  const bool halo = src_s != s;
  const float* src = own + ((size_t)src_s * h.l + src_i) * h.k;
  if (src_s < 0) src = h.left != nullptr ? h.left + (size_t)v * h.k : nullptr;
  if (src_s >= h.d) src = h.right != nullptr ? h.right + (size_t)src_i * h.k : nullptr;
  const bool zero = (halo && zero_halo) || src == nullptr;
  float* dst = view + (size_t)g * h.k;
  for (int c = 0; c < h.k; ++c) dst[c] = zero ? 0.0f : src[c];
}

// The reduced value of owned slot i of slab s, component c.
__device__ __forceinline__ float reduced(const float* __restrict__ view, const Halo& h,
                                         int s, int i, int c) {
  const int vv = h.v();
  float acc = view[((size_t)s * vv + h.b + i) * h.k + c];
  if (i >= h.l - h.b) {
    const int j = i - (h.l - h.b);
    const float fr = s + 1 < h.d     ? view[((size_t)(s + 1) * vv + j) * h.k + c]
                     : h.right != nullptr ? h.right[(size_t)j * h.k + c]
                                          : 0.0f;
    acc = acc + fr;
  }
  if (i < h.b) {
    const float fl = s > 0           ? view[((size_t)(s - 1) * vv + h.b + h.l + i) * h.k + c]
                     : h.left != nullptr ? h.left[(size_t)i * h.k + c]
                                         : 0.0f;
    acc = acc + fl;
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* __restrict__ view, float* __restrict__ out, Halo h, int mode,
                  const float* __restrict__ p, float* __restrict__ part, float* x_own,
                  float* prev_own, const float* __restrict__ active,
                  const float* __restrict__ stat, const int* __restrict__ failed) {
  __shared__ float sm[kThreads];
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)h.d * h.l;
  const bool in = g < total;
  const int s = in ? (int)(g / h.l) : 0, i = in ? (int)(g - (long long)s * h.l) : 0;
  if (mode == 1 || mode == 2) {
    if (!in || (mode == 1 && failed[0] != 0)) return;
    float a[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = reduced(view, h, s, i, c);
    const float cnt = a[3] < 1.0f ? 1.0f : a[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const size_t j = (size_t)g * 3 + c;
      const float delta = a[c] / cnt;
      if (mode == 2) {
        out[j] = delta;
      } else {
        prev_own[j] = prev_own[j] + delta;
        const float xn = x_own[j] + delta;
        x_own[j] = active != nullptr && active[g] > 0.0f ? stat[j] : xn;
      }
    }
    return;
  }
  float dot = 0.0f;
  if (in) {
    for (int c = 0; c < h.k; ++c) {
      const float y = reduced(view, h, s, i, c);
      out[(size_t)g * h.k + c] = y;
      if (part != nullptr) dot = c == 0 ? p[(size_t)g * 3] * y : dot + p[(size_t)g * 3 + c] * y;
    }
  }
  if (part == nullptr) return;  // (uniform over the launch)
  const float sum = pies::block_sum(dot, sm);
  if (threadIdx.x == 0) part[blockIdx.x] = sum;
}

// The exclusive prefix of the kept counts before slab s, and their total.
__device__ __forceinline__ void slab_prefix(const int* count, int d, int keep, int s, int* pre,
                                            int* total) {
  int run = 0;
  for (int t = 0; t < d; ++t) {
    if (t == s) *pre = run;
    const int c = count[t];
    run += c < keep ? c : keep;
  }
  *total = run;
}

__global__ void __launch_bounds__(kThreads)
    merge_kernel(const int* __restrict__ src, const float* __restrict__ src_mask,
                 const int* __restrict__ count, int d, int cap, int w, int keep, int v,
                 int* __restrict__ dst, float* __restrict__ dst_mask,
                 int* __restrict__ dst_count) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)d * cap) return;
  const int s = (int)(g / cap), e = (int)(g - (long long)s * cap);
  int pre = 0, total = 0;
  slab_prefix(count, d, keep, s, &pre, &total);
  const int kept = count[s] < keep ? count[s] : keep;
  if (e < kept) {
    const size_t to = (size_t)pre + e;
    for (int c = 0; c < w; ++c) dst[to * w + c] = src[(size_t)g * w + c] + s * v;
    dst_mask[to] = src_mask[g];
  }
  if (g >= total) {
    for (int c = 0; c < w; ++c) dst[(size_t)g * w + c] = 0;
    dst_mask[g] = 0.0f;
  }
  if (g == 0) dst_count[0] = total;
}

struct Pairs {
  const int* pi;
  const int* pj;
  const int* count;
  const int* row_off;
  const int* inc_start;
  const int* inc_pair;
  int* o_pi;
  int* o_pj;
  int* o_count;
  int* o_row_off;
  int* o_inc_start;
  int* o_inc_pair;
  int d, v, width, keep;
};

__global__ void __launch_bounds__(kThreads) merge_pairs_kernel(Pairs p) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long slots = (long long)p.d * p.width, nodes = (long long)p.d * p.v + 1;
  if (g < slots) {
    const int s = (int)(g / p.width), e = (int)(g - (long long)s * p.width);
    int pre = 0, total = 0;
    slab_prefix(p.count, p.d, p.keep, s, &pre, &total);
    const int kept = p.count[s] < p.keep ? p.count[s] : p.keep;
    if (e < kept) {
      p.o_pi[pre + e] = p.pi[g] + s * p.v;
      p.o_pj[pre + e] = p.pj[g] + s * p.v;
    }
    if (g >= total) p.o_pi[g] = p.o_pj[g] = 0;
    const int q = e < p.count[s] ? p.inc_pair[g] : INT_MAX;
    p.o_inc_pair[g] = q < kept ? q + pre : INT_MAX;
    if (g == 0) p.o_count[0] = total;
  }
  if (g < nodes) {
    if (g == nodes - 1) {
      int pre = 0, total = 0;
      slab_prefix(p.count, p.d, p.keep, 0, &pre, &total);
      p.o_row_off[g] = total;
      p.o_inc_start[g] = (int)slots;
    } else {
      const int s = (int)(g / p.v), i = (int)(g - (long long)s * p.v);
      int pre = 0, total = 0;
      slab_prefix(p.count, p.d, p.keep, s, &pre, &total);
      const int kept = p.count[s] < p.keep ? p.count[s] : p.keep;
      const int r = p.row_off[(size_t)s * (p.v + 1) + i];
      p.o_row_off[g] = (r < kept ? r : kept) + pre;
      p.o_inc_start[g] = p.inc_start[(size_t)s * (p.v + 1) + i] + s * p.width;
    }
  }
}

inline unsigned blocks(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int pies_halo_refresh(const float* own, float* view, int d, int l, int b, int k,
                                 int zero_halo, const float* left, const float* right,
                                 void* stream) {
  if (d <= 0 || l <= 0 || b < 0 || b > l || k <= 0) return (int)cudaErrorInvalidValue;
  const Halo h{d, l, b, k, left, right};
  refresh_kernel<<<blocks((long long)d * (l + 2 * b)), kThreads, 0, (cudaStream_t)stream>>>(
      own, view, h, zero_halo);
  return (int)cudaGetLastError();
}

extern "C" int pies_halo_reduce(const float* view, float* out, int d, int l, int b, int k,
                                int mode, const float* p, float* part, float* x_own,
                                float* prev_own, const float* active, const float* stat,
                                const int* failed, const float* left, const float* right,
                                void* stream) {
  if (d <= 0 || l <= 0 || b < 0 || b > l || k <= 0 || mode < 0 || mode > 2 ||
      (mode != 0 && k != 4) || (part != nullptr && (k != 3 || mode != 0)) ||
      (mode == 1 && (x_own == nullptr || prev_own == nullptr || failed == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Halo h{d, l, b, k, left, right};
  reduce_kernel<<<blocks((long long)d * l), kThreads, 0, (cudaStream_t)stream>>>(
      view, out, h, mode, p, part, x_own, prev_own, active, stat, failed);
  return (int)cudaGetLastError();
}

extern "C" int pies_halo_merge(const int* src, const float* src_mask, const int* count, int d,
                               int cap, int w, int keep, int v, int* dst, float* dst_mask,
                               int* dst_count, void* stream) {
  if (d <= 0 || cap <= 0 || w <= 0 || keep < 0 || v <= 0) return (int)cudaErrorInvalidValue;
  merge_kernel<<<blocks((long long)d * cap), kThreads, 0, (cudaStream_t)stream>>>(
      src, src_mask, count, d, cap, w, keep, v, dst, dst_mask, dst_count);
  return (int)cudaGetLastError();
}

extern "C" int pies_halo_merge_pairs(const int* pi, const int* pj, const int* count,
                                     const int* row_off, const int* inc_start,
                                     const int* inc_pair, int* o_pi, int* o_pj, int* o_count,
                                     int* o_row_off, int* o_inc_start, int* o_inc_pair, int d,
                                     int v, int width, int keep, void* stream) {
  if (d <= 0 || v <= 0 || width <= 0 || keep < 0) return (int)cudaErrorInvalidValue;
  const Pairs p{pi,   pj,   count, row_off, inc_start, inc_pair, o_pi, o_pj,
                o_count, o_row_off, o_inc_start, o_inc_pair, d, v, width, keep};
  const long long n = (long long)d * width > (long long)d * v + 1 ? (long long)d * width
                                                                  : (long long)d * v + 1;
  merge_pairs_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
