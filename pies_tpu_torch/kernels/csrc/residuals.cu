// Kernel T28: the constraint residuals of the diagnostics.
//
// Replaces (JAX): pies_tpu/diagnostics.py:33-102 constraint_residuals, with
// math3d.svd3x3 / det3x3 (pies_tpu/ops/math3d.py:137,31).
//
// One launch per family present (distance, pins, strain, volume, bend), one
// thread per row, computes the row's violation times its live mask (w > 0):
//   distance |length - rest|; pins |x - target|; strain the largest
//   distance of F's singular values outside [lo, hi], F = edges * Q^-1;
//   volume det F outside [lo, hi]; bend |acos(clip(n1.n2)) - rest|.
// One more, one thread per node, takes the floor penetration max(-y, 0)
// and the speed |v|, each times the node mask.  Each block sums its 256
// values (and masks) by cg_reduce.cuh's pairwise tree into one partial; the
// speed's partial is the block's largest (NaN kept).  A final launch, one
// block per family, sums each family's partials in the fixed order of
// cg_reduce.cuh's finalize and divides by max(live rows, 1); its floor
// block also takes the largest speed.  No float atomics: the plain twin
// (diagnostics.py constraint_residuals_plain) repeats every sum in this
// order, and the two agree bit for bit.
//
// F and F^T F are fused multiply-add chains, fma(e2, q2k, fma(e1, q1k,
// e0 * q0k)): on the CPU XLA evaluates svd3x3's einsums as such chains
// (its dot), which is where svd3x3 and the _flat forms part.  The Jacobi
// sweeps are tet_force.cuh's (eigh3x3's formulas).  The build has no FMA
// contraction elsewhere (-fmad=false).
//
// Bound: bytes.  A tet row reads 64 bytes (ids, Q^-1, lo, hi, w) and 48
// bytes of positions; about 1,500 flops of Jacobi sweeps per strain row
// stay below the memory time at 67 TFLOP/s.
#include <cuda_runtime.h>

#include "cg_reduce.cuh"
#include "nan_math.cuh"
#include "tet_force.cuh"

namespace {

using pies::block_sum;
using pies::finalize;
using pies::kCgBlock;
using pies::max_keep_nan;
using pies::nan_max;
using pies::nan_min;

enum Family { kDistance = 0, kPosition = 1, kStrain = 2, kVolume = 3, kBend = 4, kNodes = 5 };
constexpr int kFamilies = 6;

struct Rows {
  const int* idx;
  const float* a;  // rest | target [c, 3] | qinv [9, c] | rest angle
  const float* lo;
  const float* hi;
  const float* w;
  int c;
};

__device__ __forceinline__ float norm3v(float x, float y, float z) {
  return sqrtf(x * x + y * y + z * z);
}

__device__ __forceinline__ void load3(const float* x, int node, float p[3]) {
  p[0] = x[(size_t)node * 3 + 0];
  p[1] = x[(size_t)node * 3 + 1];
  p[2] = x[(size_t)node * 3 + 2];
}

// F = edges * Q^-1 (row-major), each entry a fused chain over the edges.
__device__ __forceinline__ void gradient(const float* x, const Rows& r, int t, float f[9]) {
  float p[4][3];
#pragma unroll
  for (int a = 0; a < 4; ++a) load3(x, r.idx[(size_t)t * 4 + a], p[a]);
  float q[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) q[k] = r.a[(size_t)k * r.c + t];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float e0 = p[1][i] - p[0][i], e1 = p[2][i] - p[0][i], e2 = p[3][i] - p[0][i];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      f[3 * i + k] = __fmaf_rn(e2, q[6 + k], __fmaf_rn(e1, q[3 + k], e0 * q[k]));
  }
}

__device__ __forceinline__ float row_value(int family, const float* x, const Rows& r, int t) {
  switch (family) {
    case kDistance: {
      float a[3], b[3];
      load3(x, r.idx[(size_t)t * 2 + 0], a);
      load3(x, r.idx[(size_t)t * 2 + 1], b);
      return fabsf(norm3v(b[0] - a[0], b[1] - a[1], b[2] - a[2]) - r.a[t]);
    }
    case kPosition: {
      float a[3];
      load3(x, r.idx[t], a);
      return norm3v(a[0] - r.a[(size_t)t * 3 + 0], a[1] - r.a[(size_t)t * 3 + 1],
                    a[2] - r.a[(size_t)t * 3 + 2]);
    }
    case kStrain: {
      float f[9], s[9], w[3], v[9];
      gradient(x, r, t, f);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          s[3 * i + k] = __fmaf_rn(f[6 + i], f[6 + k], __fmaf_rn(f[3 + i], f[3 + k], f[i] * f[k]));
      pies::eigh3(s, w, v);
      float worst = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float sigma = sqrtf(max_keep_nan(w[k], 0.0f));
        const float viol = max_keep_nan(r.lo[t] - sigma, 0.0f) + max_keep_nan(sigma - r.hi[t], 0.0f);
        worst = k == 0 ? viol : nan_max(worst, viol);
      }
      return worst;
    }
    case kVolume: {
      float f[9];
      gradient(x, r, t, f);
      const float det = pies::det3(f);
      return max_keep_nan(r.lo[t] - det, 0.0f) + max_keep_nan(det - r.hi[t], 0.0f);
    }
    default: {  // kBend
      float p[4][3];
#pragma unroll
      for (int a = 0; a < 4; ++a) load3(x, r.idx[(size_t)t * 4 + a], p[a]);
      float e[3][3];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int d = 0; d < 3; ++d) e[j][d] = p[j + 1][d] - p[0][d];
      // n1 = cross(p2, p3), n2 = cross(p2, p4)
      float n1[3] = {e[0][1] * e[1][2] - e[0][2] * e[1][1], e[0][2] * e[1][0] - e[0][0] * e[1][2],
                     e[0][0] * e[1][1] - e[0][1] * e[1][0]};
      float n2[3] = {e[0][1] * e[2][2] - e[0][2] * e[2][1], e[0][2] * e[2][0] - e[0][0] * e[2][2],
                     e[0][0] * e[2][1] - e[0][1] * e[2][0]};
      const float l1 = max_keep_nan(norm3v(n1[0], n1[1], n1[2]), 1e-20f);
      const float l2 = max_keep_nan(norm3v(n2[0], n2[1], n2[2]), 1e-20f);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        n1[d] = n1[d] / l1;
        n2[d] = n2[d] / l2;
      }
      const float c = n1[0] * n2[0] + n1[1] * n2[1] + n1[2] * n2[2];
      return fabsf(acosf(nan_min(max_keep_nan(c, -1.0f), 1.0f)) - r.a[t]);
    }
  }
}

// One family's rows: per block the sums of value * mask and of mask.
__global__ void __launch_bounds__(kCgBlock)
    family_kernel(int family, const float* __restrict__ x, Rows r, float* __restrict__ psum,
                  float* __restrict__ pcnt) {
  __shared__ float sm[kCgBlock];
  const int t = blockIdx.x * kCgBlock + threadIdx.x;
  float v = 0.0f, m = 0.0f;
  if (t < r.c) {
    m = r.w[t] > 0.0f ? 1.0f : 0.0f;
    v = row_value(family, x, r, t) * m;
  }
  const float s = block_sum(v, sm);
  const float n = block_sum(m, sm);
  if (threadIdx.x == 0) {
    psum[blockIdx.x] = s;
    pcnt[blockIdx.x] = n;
  }
}

// Per node: floor penetration and speed, each times the node mask.
__global__ void __launch_bounds__(kCgBlock)
    nodes_kernel(const float* __restrict__ x, const float* __restrict__ vel,
                 const float* __restrict__ mask, int n, float* __restrict__ psum,
                 float* __restrict__ pcnt, float* __restrict__ pmax) {
  __shared__ float sm[kCgBlock];
  const int i = blockIdx.x * kCgBlock + threadIdx.x;
  float pen = 0.0f, m = 0.0f, speed = 0.0f;
  if (i < n) {
    m = mask[i];
    pen = max_keep_nan(-x[(size_t)i * 3 + 1], 0.0f) * m;
    speed = norm3v(vel[(size_t)i * 3], vel[(size_t)i * 3 + 1], vel[(size_t)i * 3 + 2]) * m;
  }
  const float s = block_sum(pen, sm);
  const float c = block_sum(m, sm);
  // The block's largest speed (0 past n, which no speed is below).
  __syncthreads();
  sm[threadIdx.x] = speed;
  __syncthreads();
  for (int k = kCgBlock / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) sm[threadIdx.x] = nan_max(sm[threadIdx.x], sm[threadIdx.x + k]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    psum[blockIdx.x] = s;
    pcnt[blockIdx.x] = c;
    pmax[blockIdx.x] = sm[0];
  }
}

struct Parts {
  int off[kFamilies];
  int p[kFamilies];
};

// Block f: family f's mean; the nodes' block also the largest speed.
__global__ void __launch_bounds__(kCgBlock)
    finish_kernel(Parts parts, const float* __restrict__ psum, const float* __restrict__ pcnt,
                  const float* __restrict__ pmax, float* __restrict__ out) {
  __shared__ float sm[kCgBlock];
  const int f = blockIdx.x;
  const int off = parts.off[f], p = parts.p[f];
  const float total = finalize(psum + off, p, sm);
  const float count = finalize(pcnt + off, p, sm);
  if (threadIdx.x == 0) out[f] = total / fmaxf(count, 1.0f);
  if (f != kNodes) return;
  // Speeds are >= 0 (or NaN, which nan_max keeps), so 0 starts the max.
  float best = 0.0f;
  for (int j = threadIdx.x; j < p; j += kCgBlock) best = nan_max(best, pmax[off + j]);
  __syncthreads();
  sm[threadIdx.x] = best;
  __syncthreads();
  for (int k = kCgBlock / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) sm[threadIdx.x] = nan_max(sm[threadIdx.x], sm[threadIdx.x + k]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[kFamilies] = sm[0];
}

}  // namespace

extern "C" int pies_constraint_residuals(
    const float* x, const float* vel, const float* node_mask, int n,
    const int* d_idx, const float* d_rest, const float* d_w, int nd,
    const int* p_idx, const float* p_target, const float* p_w, int np,
    const int* s_idx, const float* s_qinv, const float* s_lo, const float* s_hi,
    const float* s_w, int ns,
    const int* v_idx, const float* v_qinv, const float* v_lo, const float* v_hi,
    const float* v_w, int nv,
    const int* b_idx, const float* b_rest, const float* b_w, int nb,
    float* psum, float* pcnt, float* pmax, float* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Rows rows[kFamilies - 1] = {
      {d_idx, d_rest, nullptr, nullptr, d_w, nd},
      {p_idx, p_target, nullptr, nullptr, p_w, np},
      {s_idx, s_qinv, s_lo, s_hi, s_w, ns},
      {v_idx, v_qinv, v_lo, v_hi, v_w, nv},
      {b_idx, b_rest, nullptr, nullptr, b_w, nb},
  };
  Parts parts;
  int off = 0;
  for (int f = 0; f < kFamilies; ++f) {
    const int c = f == kNodes ? n : rows[f].c;
    parts.off[f] = off;
    parts.p[f] = (c + kCgBlock - 1) / kCgBlock;
    off += parts.p[f];
  }
  for (int f = 0; f < kNodes; ++f) {
    if (parts.p[f] == 0) continue;
    family_kernel<<<parts.p[f], kCgBlock, 0, st>>>(f, x, rows[f], psum + parts.off[f],
                                                   pcnt + parts.off[f]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts.p[kNodes] > 0) {
    nodes_kernel<<<parts.p[kNodes], kCgBlock, 0, st>>>(
        x, vel, node_mask, n, psum + parts.off[kNodes], pcnt + parts.off[kNodes],
        pmax + parts.off[kNodes]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  finish_kernel<<<kFamilies, kCgBlock, 0, st>>>(parts, psum, pcnt, pmax, out);
  return (int)cudaGetLastError();
}
