// Per-tet strain + volume local step, shared by kernels T1 and T2.
//
// Replaces (JAX): pies_tpu/constraints/projections.py tet_force12_fused_cols
// with _compute_d_flat, and pies_tpu/ops/math3d.py svd3x3_flat /
// eigh3x3_flat / _jacobi_rotate_flat / det3x3_flat / _perp_flat.
//
// Every function here transcribes its plain twin in
// pies_tpu_torch/ops/math3d.py and constraints/projections.py operation for
// operation.  Conventions that differ from the C library are spelled out:
//   * sign(x) is jnp.sign: 0 at 0 (copysignf would give +-1), see sgnf();
//   * max(a, b) with a possible NaN in `a` keeps the NaN, as jnp.maximum and
//     torch.clamp_min do (fmaxf would drop it), see nanmax();
//   * 1/sqrt is IEEE 1.0f / sqrtf (no rsqrtf): the build uses neither
//     --use_fast_math nor approximate division or square root.
// The library is built with -fmad=false, so no a*b+c is contracted into an
// FMA and each expression rounds exactly as the twin's tensor ops do.
#pragma once

namespace pies {

constexpr int kJacobiSweeps = 8;
constexpr float kTiny = 1e-20f;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float sgnf(float x) {
  return (float)((x > 0.0f) - (x < 0.0f));
}

__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a) ? a : fmaxf(a, b);
}

__device__ __forceinline__ float det3(const float m[9]) {
  return m[0] * (m[4] * m[8] - m[5] * m[7]) -
         m[1] * (m[3] * m[8] - m[5] * m[6]) +
         m[2] * (m[3] * m[7] - m[4] * m[6]);
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// One Jacobi rotation zeroing s[p][q] of symmetric s; v <- v J.
__device__ __forceinline__ void jacobi_rotate(float s[9], float v[9], int p,
                                              int q) {
  const float app = s[3 * p + p], aqq = s[3 * q + q], apq = s[3 * p + q];
  const bool small = fabsf(apq) < kTiny;
  const float tau = (aqq - app) / (2.0f * (small ? kTiny : apq));
  float t = sgnf(tau) / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  t = small ? 0.0f : t;
  const float c = 1.0f / sqrtf(1.0f + t * t);
  const float sn = t * c;
#pragma unroll
  for (int r = 0; r < 3; ++r) {  // rows p, q
    const float sp = s[3 * p + r], sq = s[3 * q + r];
    s[3 * p + r] = c * sp - sn * sq;
    s[3 * q + r] = sn * sp + c * sq;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {  // cols p, q
    const float sp = s[3 * r + p], sq = s[3 * r + q];
    s[3 * r + p] = c * sp - sn * sq;
    s[3 * r + q] = sn * sp + c * sq;
  }
  s[3 * p + q] = 0.0f;
  s[3 * q + p] = 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float vp = v[3 * r + p], vq = v[3 * r + q];
    v[3 * r + p] = c * vp - sn * vq;
    v[3 * r + q] = sn * vp + c * vq;
  }
}

__device__ __forceinline__ void swap_if(float w[3], float v[9], int i, int j) {
  const bool d = w[i] < w[j];
  const float wi = w[i], wj = w[j];
  w[i] = d ? wj : wi;
  w[j] = d ? wi : wj;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float vi = v[3 * r + i], vj = v[3 * r + j];
    v[3 * r + i] = d ? vj : vi;
    v[3 * r + j] = d ? vi : vj;
  }
}

// Symmetric eigendecomposition: w descending, v's columns matching.
__device__ __forceinline__ void eigh3(float s[9], float w[3], float v[9]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = (i % 4 == 0) ? 1.0f : 0.0f;
#pragma unroll 1
  for (int sweep = 0; sweep < kJacobiSweeps; ++sweep) {
    jacobi_rotate(s, v, 0, 1);
    jacobi_rotate(s, v, 0, 2);
    jacobi_rotate(s, v, 1, 2);
  }
  w[0] = s[0];
  w[1] = s[4];
  w[2] = s[8];
  swap_if(w, v, 0, 1);
  swap_if(w, v, 1, 2);
  swap_if(w, v, 0, 1);
}

__device__ __forceinline__ void perp3(const float x[3], float out[3]) {
  const float ax0 = fabsf(x[0]), ax1 = fabsf(x[1]), ax2 = fabsf(x[2]);
  const bool use_x = (ax0 <= ax1) && (ax0 <= ax2);
  const bool use_y = !use_x && (ax1 <= ax2);
  const float e[3] = {use_x ? 1.0f : 0.0f, use_y ? 1.0f : 0.0f,
                      (!(use_x || use_y)) ? 1.0f : 0.0f};
  const float d = dot3(e, x);
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = e[i] - d * x[i];
  const float n = sqrtf(dot3(p, p));
  const float inv = 1.0f / nanmax(n, kEps);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = p[i] * inv;
}

__device__ __forceinline__ void normalize3(const float x[3], const float fb[3],
                                           float out[3]) {
  const float n = sqrtf(dot3(x, x));
  const bool ok = n > 1e-6f;
  const float inv = 1.0f / nanmax(n, kEps);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = ok ? x[i] * inv : fb[i];
}

// f = U diag(sigma) V^T, the contract of math3d.svd3x3_flat.
__device__ __forceinline__ void svd3(const float f[9], float u[9],
                                     float sigma[3], float v[9]) {
  float s[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      s[3 * i + k] = f[0 + i] * f[0 + k] + f[3 + i] * f[3 + k] +
                     f[6 + i] * f[6 + k];
  float w[3];
  eigh3(s, w, v);
#pragma unroll
  for (int k = 0; k < 3; ++k) sigma[k] = sqrtf(nanmax(w[k], 0.0f));

  float uc[3][3];  // uc[j] = column j of f v, divided by sigma_j
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float inv = 1.0f / nanmax(sigma[j], kEps);
#pragma unroll
    for (int r = 0; r < 3; ++r)
      uc[j][r] = (f[3 * r + 0] * v[0 + j] + f[3 * r + 1] * v[3 + j] +
                  f[3 * r + 2] * v[6 + j]) *
                 inv;
  }
  const float ex[3] = {1.0f, 0.0f, 0.0f};
  float u0[3], u1[3], u2[3], t[3], fb[3];
  normalize3(uc[0], ex, u0);
  const float d10 = dot3(uc[1], u0);
#pragma unroll
  for (int r = 0; r < 3; ++r) t[r] = uc[1][r] - d10 * u0[r];
  perp3(u0, fb);
  normalize3(t, fb, u1);
  const float d20 = dot3(uc[2], u0);
#pragma unroll
  for (int r = 0; r < 3; ++r) t[r] = uc[2][r] - d20 * u0[r];
  const float d21 = dot3(t, u1);
#pragma unroll
  for (int r = 0; r < 3; ++r) t[r] = t[r] - d21 * u1[r];
  const float detf = det3(f);
  const float detv = det3(v);
  const float sg = sgnf(detf * detv) + (detf == 0.0f ? 1.0f : 0.0f);
  fb[0] = (u0[1] * u1[2] - u0[2] * u1[1]) * sg;
  fb[1] = (u0[2] * u1[0] - u0[0] * u1[2]) * sg;
  fb[2] = (u0[0] * u1[1] - u0[1] * u1[0]) * sg;
  normalize3(t, fb, u2);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    u[3 * r + 0] = u0[r];
    u[3 * r + 1] = u1[r];
    u[3 * r + 2] = u2[r];
  }
}

// Volume correction: 10 fixed steps driving prod(sigma + d) into [lo, hi]
// (computeD, Constraints.cpp:186-203).
__device__ __forceinline__ void compute_d(const float sigma[3], float lo,
                                          float hi, float d[3]) {
  d[0] = d[1] = d[2] = 0.0f;
#pragma unroll 1
  for (int it = 0; it < 10; ++it) {
    const float s0 = sigma[0] + d[0], s1 = sigma[1] + d[1],
                s2 = sigma[2] + d[2];
    const float product = s0 * s1 * s2;
    const float omega = fminf(fmaxf(product, lo), hi);
    const float c = product - omega;
    const float g0 = s1 * s2, g1 = s0 * s2, g2 = s0 * s1;
    const float gg = g0 * g0 + g1 * g1 + g2 * g2;
    const float gd = g0 * d[0] + g1 * d[1] + g2 * d[2];
    const float scale = (gd - c) / nanmax(gg, 1e-20f);
    d[0] = scale * g0;
    d[1] = scale * g1;
    d[2] = scale * g2;
  }
}

// Per-tet parameters, read once per tet.
struct TetParams {
  float qinv[9];  // row-major (i, j) -> 3i+j
  float g[12];    // (j, a) -> 4j+a
  float slo, shi, sw, vlo, vhi, vw;
};

struct TetBatchPtrs {
  const float* qinv;  // [9, ld]
  const float* g;     // [12, ld]
  const float* slo;
  const float* shi;
  const float* sw;
  const float* vlo;
  const float* vhi;
  const float* vw;
  int ld;  // row stride of qinv / g (the batch capacity C)
};

__device__ __forceinline__ void load_tet(const TetBatchPtrs& b, int t,
                                         TetParams& tp) {
#pragma unroll
  for (int r = 0; r < 9; ++r) tp.qinv[r] = b.qinv[(size_t)r * b.ld + t];
#pragma unroll
  for (int r = 0; r < 12; ++r) tp.g[r] = b.g[(size_t)r * b.ld + t];
  tp.slo = b.slo[t];
  tp.shi = b.shi[t];
  tp.sw = b.sw[t];
  tp.vlo = b.vlo[t];
  tp.vhi = b.vhi[t];
  tp.vw = b.vw[t];
}

// The combined strain + volume force w_s A^T B p_s + w_v A^T B p_v of one
// tet, from its corner positions p[a][d]; out[3a + d].
__device__ __forceinline__ void tet_force12(const float p[4][3],
                                            const TetParams& tp,
                                            float out[12]) {
  float f[9];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float e0 = p[1][d] - p[0][d];
    const float e1 = p[2][d] - p[0][d];
    const float e2 = p[3][d] - p[0][d];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      f[3 * d + j] = e0 * tp.qinv[0 + j] + e1 * tp.qinv[3 + j] +
                     e2 * tp.qinv[6 + j];
  }
  float u[9], sigma[3], v[9];
  svd3(f, u, sigma, v);

  float ss[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) ss[k] = fminf(fmaxf(sigma[k], tp.slo), tp.shi);
  if (det3(f) < 0.0f) ss[2] = -ss[2];
  float dc[3];
  compute_d(sigma, tp.vlo, tp.vhi, dc);
  float sc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) sc[k] = tp.sw * ss[k] + tp.vw * (sigma[k] + dc[k]);

  float fh[9];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      fh[3 * d + j] = u[3 * d + 0] * sc[0] * v[3 * j + 0] +
                      u[3 * d + 1] * sc[1] * v[3 * j + 1] +
                      u[3 * d + 2] * sc[2] * v[3 * j + 2];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      out[3 * a + d] = tp.g[0 + a] * fh[3 * d + 0] +
                       tp.g[4 + a] * fh[3 * d + 1] +
                       tp.g[8 + a] * fh[3 * d + 2];
}

// One family's force w A^T B p of one tet (tet_force12 of
// pies_tpu/constraints/projections.py:210): strain clamps the singular
// values (the third negated on an inverted tet), volume corrects them; the
// weight multiplies last.  Reads the strain slots of `tp` for strain and
// the volume slots for volume.
__device__ __forceinline__ void tet_force12_single(const float p[4][3],
                                                   const TetParams& tp,
                                                   bool strain,
                                                   float out[12]) {
  float f[9];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float e0 = p[1][d] - p[0][d];
    const float e1 = p[2][d] - p[0][d];
    const float e2 = p[3][d] - p[0][d];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      f[3 * d + j] = e0 * tp.qinv[0 + j] + e1 * tp.qinv[3 + j] +
                     e2 * tp.qinv[6 + j];
  }
  float u[9], sigma[3], v[9];
  svd3(f, u, sigma, v);

  float sh[3];
  if (strain) {
#pragma unroll
    for (int k = 0; k < 3; ++k) sh[k] = fminf(fmaxf(sigma[k], tp.slo), tp.shi);
    if (det3(f) < 0.0f) sh[2] = -sh[2];
  } else {
    float dc[3];
    compute_d(sigma, tp.vlo, tp.vhi, dc);
#pragma unroll
    for (int k = 0; k < 3; ++k) sh[k] = sigma[k] + dc[k];
  }
  const float w = strain ? tp.sw : tp.vw;

  float fh[9];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      fh[3 * d + j] = u[3 * d + 0] * sh[0] * v[3 * j + 0] +
                      u[3 * d + 1] * sh[1] * v[3 * j + 1] +
                      u[3 * d + 2] * sh[2] * v[3 * j + 2];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      out[3 * a + d] = w * (tp.g[0 + a] * fh[3 * d + 0] +
                            tp.g[4 + a] * fh[3 * d + 1] +
                            tp.g[8 + a] * fh[3 * d + 2]);
}

}  // namespace pies
