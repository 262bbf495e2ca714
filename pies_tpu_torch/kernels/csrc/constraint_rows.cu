// Kernel T12: the local step of the distance and bend constraints of one PD
// iteration, one thread per constraint, each writing its constraint's force
// rows w A^T B p into the row buffer that kernel T9's stage 2 sums per node.
//
// Replaces (JAX): pies_tpu/constraints/projections.py:48
// project_distance_delta with the row construction of
// pies_tpu/solver/assembly.py:218-227 (half = 0.5 w (p0 - p1); update rows
// [+half; -half]), and pies_tpu/constraints/projections.py:359 project_bend
// with the weighting of pies_tpu/solver/assembly.py:269-271 (rows w p, row
// 4c + k for node k of bend c).
//
// The bend maths is bend.cuh's, shared with kernel T18.  Every expression
// is evaluated in the order of its plain twin
// (constraints/projections.py: project_distance_delta, project_bend) with
// IEEE division and square root and no FMA contraction, so the distance
// rows equal the twin's bit for bit; the bend rows differ from it by the
// roundoff of acosf against torch.acos.
//
// Ensembles (the local step under jax.vmap, pies_tpu/parallel/ensemble.py:41):
// blockIdx.y is the member b of `members`.  The constraints are the shared
// topology's; b's positions start at b*N*3, its inverse masses at b*N,
// its rows at b*S*3 (S the row buffer's member stride) and its latch at
// failed[2b].
//
// Bound: device memory.  A pair reads its 2 ids, rest and w (16 B) and
// writes 2 rows (24 B); a bend reads 4 ids, rest angle and w (24 B) and
// writes 4 rows (48 B).  The endpoint positions and inverse masses are
// gathered from x (12 B per node, read once from memory, then from L2).
#include <cuda_runtime.h>

#include "bend.cuh"

namespace {

__global__ void __launch_bounds__(256)
    distance_rows_kernel(const float* __restrict__ x,
                         const int* __restrict__ idx,
                         const float* __restrict__ rest,
                         const float* __restrict__ w, float* __restrict__ rows,
                         int c, const int* __restrict__ failed, int n, int stride) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= c) return;
  const int mb = blockIdx.y;
  if (failed[2 * mb] != 0) return;
  x += (size_t)mb * n * 3;
  rows += (size_t)mb * stride * 3;
  const int2 id = reinterpret_cast<const int2*>(idx)[t];
  float df[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    df[d] = x[(size_t)id.y * 3 + d] - x[(size_t)id.x * 3 + d];
  const float dist = sqrtf(df[0] * df[0] + df[1] * df[1] + df[2] * df[2]);
  const bool safe = dist > 1e-5f;
  const float inv = 1.0f / max_keep_nan(dist, 1e-20f);
  const float disp = rest[t] - dist;
  const float hw = 0.5f * w[t];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float dir = safe ? df[d] * inv : (d == 0 ? 1.0f : 0.0f);
    const float half = hw * -(df[d] + disp * dir);
    rows[(size_t)t * 3 + d] = half;
    rows[((size_t)c + t) * 3 + d] = -half;
  }
}

__global__ void __launch_bounds__(128)
    bend_rows_kernel(const float* __restrict__ x,
                     const float* __restrict__ inv_mass,
                     const int* __restrict__ idx,
                     const float* __restrict__ rest_angle,
                     const float* __restrict__ w, float* __restrict__ rows,
                     int c, const int* __restrict__ failed, int n, int stride) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= c) return;
  const int mb = blockIdx.y;
  if (failed[2 * mb] != 0) return;
  x += (size_t)mb * n * 3;
  inv_mass += (size_t)mb * n;
  rows += (size_t)mb * stride * 3;
  const int4 q4i = reinterpret_cast<const int4*>(idx)[t];
  const int id[4] = {q4i.x, q4i.y, q4i.z, q4i.w};
  float p[4][3], wim[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wim[k] = inv_mass[id[k]];
#pragma unroll
    for (int d = 0; d < 3; ++d) p[k][d] = x[(size_t)id[k] * 3 + d];
  }
  float out[4][3];
  bend_project(p, wim, rest_angle[t], out);
  const float wt = w[t];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int d = 0; d < 3; ++d) rows[((size_t)t * 4 + k) * 3 + d] = wt * out[k][d];
}

}  // namespace

extern "C" int pies_distance_rows(const float* x, const int* idx,
                                  const float* rest, const float* w,
                                  float* rows, int c, const int* failed, int n,
                                  int stride, int members, void* stream) {
  if (c > 0 && members > 0) {
    const int threads = 256;
    const dim3 grid((c + threads - 1) / threads, members);
    distance_rows_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        x, idx, rest, w, rows, c, failed, n, stride);
  }
  return (int)cudaGetLastError();
}

extern "C" int pies_bend_rows(const float* x, const float* inv_mass,
                              const int* idx, const float* rest_angle,
                              const float* w, float* rows, int c,
                              const int* failed, int n, int stride, int members,
                              void* stream) {
  if (c > 0 && members > 0) {
    const int threads = 128;
    const dim3 grid((c + threads - 1) / threads, members);
    bend_rows_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        x, inv_mass, idx, rest_angle, w, rows, c, failed, n, stride);
  }
  return (int)cudaGetLastError();
}
