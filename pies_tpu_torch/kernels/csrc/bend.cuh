// The bend projection shared by kernels T12 (the PD force rows) and T18
// (the PBD Jacobi rows), with the small vector helpers it uses.
//
// Replaces (JAX): pies_tpu/constraints/projections.py:359 project_bend.
// Every expression is evaluated in the order of the plain twin
// (pies_tpu_torch/constraints/projections.py project_bend) with IEEE
// division and square root; the build has no FMA contraction.
#pragma once

#include <cuda_runtime.h>

#include "nan_math.cuh"

// Everything is internal to each translation unit that includes this file.
namespace {

using pies::max_keep_nan;

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

// The dihedral-angle projection of one bend (projections.py project_bend,
// Constraints.cpp:312-366): the projected positions out[k] of its four
// nodes p[k] with inverse masses wim[k] and rest angle `rest`.  Degenerate
// triangles (sum |q|^2 < 1e-5) leave the nodes where they are.
__device__ __forceinline__ void bend_project(const float p[4][3], const float wim[4], float rest,
                                             float out[4][3]) {
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
  const float cc = acosf(dt) - rest;

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
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float fac = 4.0f * wim[k] / w_sum;
#pragma unroll
    for (int d = 0; d < 3; ++d) out[k][d] = p[k][d] + ((-q[k][d]) * fac) * scale;
  }
}

}  // namespace
