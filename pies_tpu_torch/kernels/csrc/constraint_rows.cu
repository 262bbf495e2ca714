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
// Every expression is evaluated in the order of its plain twin
// (constraints/projections.py: project_distance_delta, project_bend) with
// IEEE division and square root and no FMA contraction, so the distance
// rows equal the twin's bit for bit; the bend rows differ from it by the
// roundoff of acosf against torch.acos.
//
// Bound: device memory.  A pair reads its 2 ids, rest and w (16 B) and
// writes 2 rows (24 B); a bend reads 4 ids, rest angle and w (24 B) and
// writes 4 rows (48 B).  The endpoint positions and inverse masses are
// gathered from x (12 B per node, read once from memory, then from L2).
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return (a != a) ? a : fmaxf(a, b);
}

__global__ void __launch_bounds__(256)
    distance_rows_kernel(const float* __restrict__ x,
                         const int* __restrict__ idx,
                         const float* __restrict__ rest,
                         const float* __restrict__ w, float* __restrict__ rows,
                         int c, const int* __restrict__ failed) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= c) return;
  if (failed[0] != 0) return;
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

__device__ __forceinline__ void cross3(const float u[3], const float v[3],
                                       float o[3]) {
  o[0] = u[1] * v[2] - u[2] * v[1];
  o[1] = u[2] * v[0] - u[0] * v[2];
  o[2] = u[0] * v[1] - u[1] * v[0];
}

__device__ __forceinline__ float norm3(const float u[3]) {
  return sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]);
}

// o = (cross(a, b) + cross(c, a) * d) / l
__device__ __forceinline__ void bend_term(const float a[3], const float b[3],
                                          const float c[3], float d, float l,
                                          float o[3]) {
  float ab[3], ca[3];
  cross3(a, b, ab);
  cross3(c, a, ca);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = (ab[k] + ca[k] * d) / l;
}

__global__ void __launch_bounds__(128)
    bend_rows_kernel(const float* __restrict__ x,
                     const float* __restrict__ inv_mass,
                     const int* __restrict__ idx,
                     const float* __restrict__ rest_angle,
                     const float* __restrict__ w, float* __restrict__ rows,
                     int c, const int* __restrict__ failed) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= c) return;
  if (failed[0] != 0) return;
  const int4 q4i = reinterpret_cast<const int4*>(idx)[t];
  const int id[4] = {q4i.x, q4i.y, q4i.z, q4i.w};
  float p[4][3], wim[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wim[k] = inv_mass[id[k]];
#pragma unroll
    for (int d = 0; d < 3; ++d) p[k][d] = x[(size_t)id[k] * 3 + d];
  }
  float p2[3], p3[3], p4[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    p2[d] = p[1][d] - p[0][d];
    p3[d] = p[2][d] - p[0][d];
    p4[d] = p[3][d] - p[0][d];
  }
  float c23[3], c24[3], n1[3], n2[3];
  cross3(p2, p3, c23);
  cross3(p2, p4, c24);
  const float l23 = max_keep_nan(norm3(c23), 1e-20f);
  const float l24 = max_keep_nan(norm3(c24), 1e-20f);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    n1[d] = c23[d] / l23;
    n2[d] = c24[d] / l24;
  }
  float dt = n1[0] * n2[0] + n1[1] * n2[1] + n1[2] * n2[2];
  // clip keeps a NaN, as jnp.clip and torch.clamp do.
  if (dt == dt) dt = fminf(fmaxf(dt, -1.0f), 1.0f);
  const float cc = acosf(dt) - rest_angle[t];

  float q[4][3], a[3], b[3];
  bend_term(p2, n2, n1, dt, l23, q[2]);
  bend_term(p2, n1, n2, dt, l24, q[3]);
  // q2 = (-(cross(p3, n2) + cross(n1, p3) d)) / l23
  //      - (cross(p4, n1) + cross(n2, p4) d) / l24
  {
    float ab[3], ca[3];
    cross3(p3, n2, ab);
    cross3(n1, p3, ca);
#pragma unroll
    for (int k = 0; k < 3; ++k) a[k] = (-(ab[k] + ca[k] * dt)) / l23;
    bend_term(p4, n1, n2, dt, l24, b);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    q[1][k] = a[k] - b[k];
    q[0][k] = -q[1][k] - q[2][k] - q[3][k];
  }
  const float w_sum = max_keep_nan(wim[0] + wim[1] + wim[2] + wim[3], 1e-20f);
  float q_sq = q[0][0] * q[0][0];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      if (k + d > 0) q_sq = q_sq + q[k][d] * q[k][d];
  const float num = sqrtf(max_keep_nan(1.0f - dt * dt, 0.0f)) * cc;
  const float scale = q_sq < 1e-5f ? 0.0f : num / max_keep_nan(q_sq, 1e-20f);
  const float wt = w[t];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float fac = 4.0f * wim[k] / w_sum;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      rows[((size_t)t * 4 + k) * 3 + d] =
          wt * (p[k][d] + ((-q[k][d]) * fac) * scale);
  }
}

}  // namespace

extern "C" int pies_distance_rows(const float* x, const int* idx,
                                  const float* rest, const float* w,
                                  float* rows, int c, const int* failed,
                                  void* stream) {
  if (c > 0) {
    const int threads = 256;
    distance_rows_kernel<<<(c + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(x, idx, rest, w, rows, c,
                                                   failed);
  }
  return (int)cudaGetLastError();
}

extern "C" int pies_bend_rows(const float* x, const float* inv_mass,
                              const int* idx, const float* rest_angle,
                              const float* w, float* rows, int c,
                              const int* failed, void* stream) {
  if (c > 0) {
    const int threads = 128;
    bend_rows_kernel<<<(c + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(x, inv_mass, idx, rest_angle, w,
                                               rows, c, failed);
  }
  return (int)cudaGetLastError();
}
