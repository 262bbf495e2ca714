// Kernel T19: the sequential forms of the PBD distance projection, in place
// on the positions.
//
// Replaces (JAX): pies_tpu/solver/pbd.py:91-123 (the chain scan, a lax.scan
// down the link axis of topology.ChainBatch) and :124-152 (the coloured
// Gauss-Seidel classes, projected class after class).
//
// Chains: a thread per chain walks its L links in order with the chase
// target (the just-moved node) in registers.  Every written node idx0 is
// written by no other link and no anchor is ever written, so each link reads
// its own node's pre-iteration position and the walk can update the nodes in
// place as it goes (the JAX package adds all deltas after the scan, which is
// the same arithmetic).  A padding link (w = 0) moves nothing: the kernel
// skips its write, where the JAX package adds its zero delta to node 0.
//
// Colours: one launch per colour class, a thread per constraint of the
// class.  No node repeats within a class, so its constraints read and write
// disjoint nodes; the next class must see every write of this one, a
// grid-wide dependency, and a launch boundary is the plain grid-wide barrier
// (the host's colouring has at most 63 classes).
//
// Each expression follows its plain twin (solver/pbd.py chain_scan_plain,
// color_classes_plain) with IEEE division and square root and no FMA.
//
// Bound: latency for the chains (L dependent steps of ~40 flops each, one
// 12-byte gather per step); device memory for the colours (~40 bytes per
// constraint).
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y is the member b of `members` (the last int argument),
// whose positions start at b*n and whose latch is failed[2b]; the chains and
// the classes serve every member.  The class loop stays on the host, one
// launch per class at any member count.  A single scene is a batch of one.
#include <cuda_runtime.h>

#include "pbd_link.cuh"

namespace {

// delta = w (-(rest - dist) dir) for the link from pa toward target tg.
__device__ __forceinline__ void link_delta(const float tg[3], const float pa[3], float rest,
                                           float w, float delta[3]) {
  float dir[3];
  const float disp = pies::pbd_link(tg, pa, rest, dir);
#pragma unroll
  for (int d = 0; d < 3; ++d) delta[d] = w * ((-disp) * dir[d]);
}

__global__ void __launch_bounds__(128)
    chain_kernel(float* __restrict__ x, const int* __restrict__ idx0,
                 const int* __restrict__ anchor, const float* __restrict__ rest,
                 const float* __restrict__ w, int c, int l, int n,
                 const int* __restrict__ failed) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  if (ch >= c || failed[2 * b] != 0) return;
  x += b * n * 3;
  float tg[3];
  const size_t a = (size_t)anchor[ch];
#pragma unroll
  for (int d = 0; d < 3; ++d) tg[d] = x[a * 3 + d];
  for (int k = 0; k < l; ++k) {
    const size_t e = (size_t)ch * l + k;
    const size_t i = (size_t)idx0[e];
    const float wk = w[e];
    float pa[3], delta[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) pa[d] = x[i * 3 + d];
    link_delta(tg, pa, rest[e], wk, delta);
#pragma unroll
    for (int d = 0; d < 3; ++d) tg[d] = pa[d] + delta[d];
    if (wk != 0.0f) {
#pragma unroll
      for (int d = 0; d < 3; ++d) x[i * 3 + d] = tg[d];
    }
  }
}

__global__ void __launch_bounds__(256)
    color_kernel(float* __restrict__ x, const int* __restrict__ idx,
                 const float* __restrict__ rest, const float* __restrict__ w, int s0, int e0,
                 int n, const int* __restrict__ failed) {
  const int t = s0 + blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  if (t >= e0 || failed[2 * b] != 0) return;
  x += b * n * 3;
  const size_t i0 = (size_t)idx[2 * t], i1 = (size_t)idx[2 * t + 1];
  float pa[3], pb[3], delta[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    pa[d] = x[i0 * 3 + d];
    pb[d] = x[i1 * 3 + d];
  }
  link_delta(pb, pa, rest[t], w[t], delta);
#pragma unroll
  for (int d = 0; d < 3; ++d) x[i0 * 3 + d] = pa[d] + delta[d];
}

}  // namespace

extern "C" int pies_pbd_chains(float* x, const int* idx0, const int* anchor, const float* rest,
                               const float* w, int c, int l, int n, const int* failed,
                               int members, void* stream) {
  if (c > 0 && l > 0 && members > 0)
    chain_kernel<<<dim3((c + 127) / 128, members), 128, 0, (cudaStream_t)stream>>>(
        x, idx0, anchor, rest, w, c, l, n, failed);
  return (int)cudaGetLastError();
}

extern "C" int pies_pbd_color_class(float* x, const int* idx, const float* rest, const float* w,
                                    int s0, int e0, int n, const int* failed, int members,
                                    void* stream) {
  if (e0 > s0 && members > 0)
    color_kernel<<<dim3((e0 - s0 + 255) / 256, members), 256, 0, (cudaStream_t)stream>>>(
        x, idx, rest, w, s0, e0, n, failed);
  return (int)cudaGetLastError();
}
