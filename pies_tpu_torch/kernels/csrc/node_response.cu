// Kernel T21: the PBD node-node response over the cached pair list.
//
// Replaces (JAX): pies_tpu/collision/broadphase.py:2035 _pair_response_acc
// (the 0.85-relaxed, mass-weighted push-apart of each touching pair and its
// friction impulse with the static threshold, summed per node as one
// [N, 6] (dx | dv) scatter over the rows concat(pi, pj)) and the update of
// :2182-2187 (x and vel of live nodes), without the TPU's width ladder:
// the work is the live pairs of kernel T20's cache, on the device.
//
// One launch, a thread per node: it walks its entries of concat(pi, pj) in
// T20's incidence (its pairs as i, then its pairs as j in ascending pair
// order: the order in which the JAX scatter adds them), computes each
// pair's terms and sums its own side, then writes x + dx and vel + dv (times
// the live mask) to new buffers: every node reads its neighbours' old
// positions and velocities.  Each pair's terms are computed twice, once per
// node, in the same float order, so both sides see the same values; a
// quiescent iteration is this one pass.  The touching pairs are counted
// (integer atomics, one per warp) for the run's counters.
//
// Each expression follows its plain twin (collision/broadphase.py
// pair_terms) with IEEE division and square root and no FMA.
//
// Bound: device memory: 36 bytes of node data per entry (two per pair),
// 24 bytes read and written per node.
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y is the member b of `members` (the last int argument),
// with its own nodes (from b*n), its own cache of T20 (pair lists of `slots`
// entries from b*slots, row_off and inc_start from b*(n+1)), its own
// outputs, its touching count touching[b] and its latch failed[2b].  A
// single scene is a batch of one.
#include <cuda_runtime.h>

#include "nan_math.cuh"

namespace {

using pies::max_keep_nan;

// The terms of pair (a, b) on node a's side (side 0) or node b's (side 1):
// (dx, dv) into out[6]; returns whether the pair touches.
__device__ __forceinline__ bool pair_side(const float* __restrict__ x,
                                          const float* __restrict__ vel,
                                          const float* __restrict__ radius,
                                          const float* __restrict__ inv_mass, int a, int b,
                                          int side, float friction, float static_thr,
                                          float out[6]) {
  float df[3], rl[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    df[d] = x[(size_t)b * 3 + d] - x[(size_t)a * 3 + d];
    rl[d] = vel[(size_t)b * 3 + d] - vel[(size_t)a * 3 + d];
  }
  const float dist = sqrtf(df[0] * df[0] + df[1] * df[1] + df[2] * df[2]);
  const float disp = (radius[a] + radius[b]) - dist;
  const bool touching = disp > 0.0f;
  const float inv_d = 1.0f / max_keep_nan(dist, 1e-20f);
  const bool ndeg = dist > 1e-5f;
  float dir[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) dir[d] = ndeg ? df[d] * inv_d : (d == 0 ? 1.0f : 0.0f);
  const float im_i = inv_mass[a], im_j = inv_mass[b];
  const float w_sum = max_keep_nan(im_i + im_j, 1e-20f);
  const float amp = touching ? 0.85f * disp : 0.0f;
  const float vdotn = rl[0] * dir[0] + rl[1] * dir[1] + rl[2] * dir[2];
  float pp[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) pp[d] = rl[d] - vdotn * dir[d];
  const float fr =
      sqrtf(pp[0] * pp[0] + pp[1] * pp[1] + pp[2] * pp[2]) < static_thr ? 1.0f : friction;
  const float f_amp = touching ? fr : 0.0f;
  const float s = side == 0 ? -amp * (im_i / w_sum) : amp * (im_j / w_sum);
  const float f = side == 0 ? -f_amp * (im_i / w_sum) : f_amp * (im_j / w_sum);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    out[d] = s * dir[d];
    out[3 + d] = f * pp[d];
  }
  return touching;
}

__global__ void __launch_bounds__(256)
    node_response_kernel(const float* __restrict__ x, const float* __restrict__ vel,
                         const float* __restrict__ radius, const float* __restrict__ inv_mass,
                         const float* __restrict__ mask, const int* __restrict__ pi,
                         const int* __restrict__ pj, const int* __restrict__ row_off,
                         const int* __restrict__ inc_start, const int* __restrict__ inc_pair,
                         float* __restrict__ x_out, float* __restrict__ vel_out,
                         int* __restrict__ touching, int n, int slots, float friction,
                         float static_thr, const int* __restrict__ failed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y, bn = b * n, bw = b * slots, bo = b * (n + 1);
  x += bn * 3;
  vel += bn * 3;
  radius += bn;
  inv_mass += bn;
  mask += bn;
  pi += bw;
  pj += bw;
  inc_pair += bw;
  row_off += bo;
  inc_start += bo;
  x_out += bn * 3;
  vel_out += bn * 3;
  touching += b;
  const bool on = i < n && failed[2 * b] == 0;
  int touched = 0;
  if (on) {
    float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, t[6];
    const int k1 = row_off[i + 1];
    for (int k = row_off[i]; k < k1; ++k) {
      touched += pair_side(x, vel, radius, inv_mass, i, pj[k], 0, friction, static_thr, t);
#pragma unroll
      for (int d = 0; d < 6; ++d) acc[d] = acc[d] + t[d];
    }
    const int q1 = inc_start[i + 1];
    for (int q = inc_start[i]; q < q1; ++q) {
      pair_side(x, vel, radius, inv_mass, pi[inc_pair[q]], i, 1, friction, static_thr, t);
#pragma unroll
      for (int d = 0; d < 6; ++d) acc[d] = acc[d] + t[d];
    }
    const float live = mask[i] > 0.0f ? 1.0f : 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const size_t j = (size_t)i * 3 + d;
      x_out[j] = x[j] + acc[d] * live;
      vel_out[j] = vel[j] + acc[3 + d] * live;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) touched += __shfl_xor_sync(0xffffffffu, touched, o);
  if ((threadIdx.x & 31) == 0 && touched > 0) atomicAdd(touching, touched);
}

}  // namespace

extern "C" int pies_node_response(const float* x, const float* vel, const float* radius,
                                  const float* inv_mass, const float* mask, const int* pi,
                                  const int* pj, const int* row_off, const int* inc_start,
                                  const int* inc_pair, float* x_out, float* vel_out,
                                  int* touching, int n, int slots, float friction,
                                  float static_thr, const int* failed, int members,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (members > 0) cudaMemsetAsync(touching, 0, sizeof(int) * members, st);
  if (n > 0 && members > 0)
    node_response_kernel<<<dim3((n + 255) / 256, members), 256, 0, st>>>(
        x, vel, radius, inv_mass, mask, pi, pj, row_off, inc_start, inc_pair, x_out, vel_out,
        touching, n, slots, friction, static_thr, failed);
  return (int)cudaGetLastError();
}
