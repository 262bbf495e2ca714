// Kernel T18: the count-averaged Jacobi families of a PBD iteration, and the
// elementwise head, floor clamp and tail of a PBD substep.
//
// Replaces (JAX): pies_tpu/solver/pbd.py:32 _apply_jacobi with the
// projections it applies, projections.py:80 project_position, :25
// project_distance (its Jacobi form, pbd.py:153-160), :119 project_strain
// (with the recentring of pbd.py:162-174) and :359 project_bend; the
// advection head pbd.py:74-79, the floor clamp :187-191 and the velocity
// update, floor friction and failure latch :200-216.
//
// Stage 1 (pies_pbd_rows), a thread per constraint of one family: its slots'
// update rows w (projected - x[idx]) and live flags, f32[C k, 4].  Stage 2
// (pies_pbd_apply), a thread per node: the sum of its rows over the host's
// incidence (the entries in ascending (c, k) order, the order of the JAX
// scatter; no float atomics), then x += acc / max(count, 1), in place.  The
// SVD of the strain projection is tet_force.cuh's (kernel T1's), the bend
// projection bend.cuh's (kernel T12's).
//
// Every expression is evaluated in the order of its plain twin
// (constraints/projections.py jacobi_rows_plain, solver/pbd.py) with IEEE
// division and square root and, the build having -fmad=false, no FMA: the
// rows equal the twin's bit for bit but for acosf against torch.acos.
//
// Bound: device memory for position, distance and the elementwise stages (a
// few tens of bytes per row or node at a few flops), operations for strain
// (an 8-sweep Jacobi SVD, ~1.5k flops per tet).  The design is one coalesced
// pass per stage; the per-node sum reads 16 bytes per entry.
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y is the member b of `members` (the last int argument),
// with its own nodes (positions, velocities, masses, radii, mask from b*n),
// its own rows (stage 1 writes, stage 2 reads, C k rows from b*C*k) and its
// latch failed[2b], failed[2b+1]; the topology and its incidence serve every
// member.  The head folds each member's slot 1 into its slot 0, and the tail
// latches into its member's slot 1, so one member's failure freezes no
// other.  A single scene is a batch of one.
#include <cuda_runtime.h>

#include "bend.cuh"
#include "pbd_link.cuh"
#include "tet_force.cuh"

namespace {

enum Kind { kPosition = 0, kDistance = 1, kStrain = 2, kBend = 3 };

__device__ __forceinline__ void store_row(float* vals, size_t e, const float delta[3], bool live) {
  vals[e * 4 + 0] = live ? delta[0] : 0.0f;
  vals[e * 4 + 1] = live ? delta[1] : 0.0f;
  vals[e * 4 + 2] = live ? delta[2] : 0.0f;
  vals[e * 4 + 3] = live ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(128)
    pbd_rows_kernel(int kind, const float* __restrict__ x, const float* __restrict__ inv_mass,
                    const int* __restrict__ idx, const float* __restrict__ a,
                    const float* __restrict__ b, const float* __restrict__ c_hi,
                    const float* __restrict__ w_in, float* __restrict__ vals, int c, int n,
                    float w_scale, int recenter, const int* __restrict__ failed) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t m = blockIdx.y;  // the member
  failed += 2 * m;
  if (t >= c || failed[0] != 0) return;
  x += m * n * 3;
  inv_mass += m * n;
  vals += m * c * (kind == kStrain || kind == kBend ? 4 : 1) * 4;
  if (kind == kPosition) {
    const float w = w_in[t] * w_scale;
    const size_t i = (size_t)idx[t];
    float delta[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) delta[d] = w * (a[(size_t)t * 3 + d] - x[i * 3 + d]);
    store_row(vals, t, delta, w > 0.0f);
  } else if (kind == kDistance) {
    const float w = w_in[t];
    const size_t i0 = (size_t)idx[2 * t], i1 = (size_t)idx[2 * t + 1];
    float pa[3], pb[3], dir[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      pa[d] = x[i0 * 3 + d];
      pb[d] = x[i1 * 3 + d];
    }
    const float disp = pies::pbd_link(pb, pa, a[t], dir);
    float delta[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) delta[d] = w * ((pa[d] - disp * dir[d]) - pa[d]);
    store_row(vals, t, delta, w > 0.0f);
  } else if (kind == kStrain) {
    const float w = w_in[t];
    float p[4][3];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const size_t i = (size_t)idx[4 * t + k];
#pragma unroll
      for (int d = 0; d < 3; ++d) p[k][d] = x[i * 3 + d];
    }
    float f[9];  // F = P Qinv, row-major; qinv is [9, C]
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        f[3 * d + j] = (p[1][d] - p[0][d]) * a[(size_t)(0 + j) * c + t] +
                       (p[2][d] - p[0][d]) * a[(size_t)(3 + j) * c + t] +
                       (p[3][d] - p[0][d]) * a[(size_t)(6 + j) * c + t];
    float u[9], sigma[3], v[9];
    pies::svd3(f, u, sigma, v);
    float s[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] = fminf(fmaxf(sigma[k], b[t]), c_hi[t]);
    s[2] = s[2] * (pies::det3(f) < 0.0f ? -1.0f : 1.0f);
    float ps[4][3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      ps[0][d] = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        ps[j + 1][d] = u[3 * d + 0] * s[0] * v[3 * j + 0] + u[3 * d + 1] * s[1] * v[3 * j + 1] +
                       u[3 * d + 2] * s[2] * v[3 * j + 2];
    }
    if (recenter) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float m = (((0.0f + ps[1][d]) + ps[2][d]) + ps[3][d]) / 4.0f;
        const float ctr = (((p[0][d] + p[1][d]) + p[2][d]) + p[3][d]) / 4.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) ps[k][d] = (ps[k][d] - m) + ctr;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float delta[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) delta[d] = w * (ps[k][d] - p[k][d]);
      store_row(vals, (size_t)t * 4 + k, delta, w > 0.0f);
    }
  } else {  // kBend
    const float w = w_in[t];
    float p[4][3], wim[4], out[4][3];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const size_t i = (size_t)idx[4 * t + k];
      wim[k] = inv_mass[i];
#pragma unroll
      for (int d = 0; d < 3; ++d) p[k][d] = x[i * 3 + d];
    }
    bend_project(p, wim, a[t], out);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float delta[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) delta[d] = w * (out[k][d] - p[k][d]);
      store_row(vals, (size_t)t * 4 + k, delta, w > 0.0f);
    }
  }
}

// Stage 2: x[i] += (sum of its rows' deltas) / max(sum of their live flags, 1).
__global__ void __launch_bounds__(256)
    pbd_apply_kernel(float* __restrict__ x, const int* __restrict__ row_start,
                     const int* __restrict__ entries, const float* __restrict__ vals, int n,
                     int rows, const int* __restrict__ failed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  failed += 2 * b;
  if (i >= n || failed[0] != 0) return;
  x += b * n * 3;
  vals += b * rows * 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int e1 = row_start[i + 1];
  for (int e = row_start[i]; e < e1; ++e) {
    const float4 v = reinterpret_cast<const float4*>(vals)[entries[e]];
    acc[0] = acc[0] + v.x;
    acc[1] = acc[1] + v.y;
    acc[2] = acc[2] + v.z;
    acc[3] = acc[3] + v.w;
  }
  const float cnt = fmaxf(acc[3], 1.0f);
#pragma unroll
  for (int d = 0; d < 3; ++d) x[(size_t)i * 3 + d] = x[(size_t)i * 3 + d] + acc[d] / cnt;
}

// The head: prev = x, then x += (v dt - g dt^2 y) mask, in place.  The first
// substep of a tick folds each member's latch slot 1 into its slot 0 (see
// state.py).
__global__ void __launch_bounds__(256)
    pbd_head_kernel(float* __restrict__ pos, float* __restrict__ prev,
                    const float* __restrict__ vel, const float* __restrict__ mask, int n,
                    float dt, float gravity, int* failed, int fold) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  failed += 2 * b;
  if (i >= n) return;
  pos += b * n * 3;
  prev += b * n * 3;
  vel += b * n * 3;
  mask += b * n;
  const int was = fold ? (failed[0] | failed[1]) : failed[0];
  if (fold && i == 0 && was) failed[0] = 1;
  if (was) return;
  const float m = mask[i];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const size_t j = (size_t)i * 3 + d;
    const float g = d == 1 ? -gravity : 0.0f;
    const float p = pos[j];
    prev[j] = p;
    pos[j] = p + (vel[j] * dt + (g * dt) * dt) * m;
  }
}

// The floor clamp: y += (floor + r) - y where that is positive, live nodes.
__global__ void __launch_bounds__(256)
    pbd_floor_kernel(float* __restrict__ x, const float* __restrict__ radius,
                     const float* __restrict__ mask, int n, float floor_height,
                     const int* __restrict__ failed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  failed += 2 * b;
  if (i >= n || failed[0] != 0) return;
  x += b * n * 3;
  radius += b * n;
  mask += b * n;
  const size_t j = (size_t)i * 3 + 1;
  const float y = x[j];
  const float lift = (floor_height + radius[i]) - y;
  x[j] = y + ((lift > 0.0f && mask[i] > 0.0f) ? lift : 0.0f);
}

// The tail: the damped velocity, floor friction with the 5.0 stop speed,
// positions = prev = x, and non-finite positions into latch slot 1.  `x`
// may be `pos` itself.
__global__ void __launch_bounds__(256)
    pbd_tail_kernel(float* pos, float* __restrict__ prev, float* __restrict__ vel,
                    const float* x, const float* __restrict__ radius,
                    const float* __restrict__ mask, int n, float dt, float keep_damp,
                    float keep_fric, float floor_height, int* failed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  failed += 2 * b;
  if (i >= n || failed[0] != 0) return;
  pos += b * n * 3;
  prev += b * n * 3;
  vel += b * n * 3;
  x += b * n * 3;
  radius += b * n;
  mask += b * n;
  const float m = mask[i];
  float xi[3], v[3];
  bool finite = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const size_t j = (size_t)i * 3 + d;
    xi[d] = x[j];
    v[d] = ((keep_damp * (xi[d] - prev[j])) / dt) * m;
    finite = finite && isfinite(xi[d]);
  }
  const bool on_floor = (xi[1] - radius[i] <= floor_height) && m > 0.0f;
  const float xz = sqrtf(v[0] * v[0] + v[2] * v[2]);
  const float scale = (on_floor && xz < 5.0f) ? 0.0f : (on_floor ? keep_fric : 1.0f);
  v[0] = v[0] * scale;
  v[2] = v[2] * scale;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const size_t j = (size_t)i * 3 + d;
    pos[j] = xi[d];
    prev[j] = xi[d];
    vel[j] = v[d];
  }
  if (!finite) atomicOr(&failed[1], 1);
}

// Blocks over n items per member, members in y.
inline dim3 grid(int n, int threads, int members) {
  return dim3((n + threads - 1) / threads, members);
}

}  // namespace

extern "C" int pies_pbd_rows(int kind, const float* x, const float* inv_mass, const int* idx,
                             const float* a, const float* b, const float* c_hi, const float* w,
                             float* vals, int c, int n, float w_scale, int recenter,
                             const int* failed, int members, void* stream) {
  if (kind < kPosition || kind > kBend || a == nullptr ||
      (kind == kStrain && (b == nullptr || c_hi == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (c > 0 && members > 0)
    pbd_rows_kernel<<<grid(c, 128, members), 128, 0, (cudaStream_t)stream>>>(
        kind, x, inv_mass, idx, a, b, c_hi, w, vals, c, n, w_scale, recenter, failed);
  return (int)cudaGetLastError();
}

extern "C" int pies_pbd_apply(float* x, const int* row_start, const int* entries,
                              const float* vals, int n, int rows, const int* failed, int members,
                              void* stream) {
  if (n > 0 && members > 0)
    pbd_apply_kernel<<<grid(n, 256, members), 256, 0, (cudaStream_t)stream>>>(
        x, row_start, entries, vals, n, rows, failed);
  return (int)cudaGetLastError();
}

extern "C" int pies_pbd_head(float* pos, float* prev, const float* vel, const float* mask, int n,
                             float dt, float gravity, int* failed, int fold, int members,
                             void* stream) {
  if (n > 0 && members > 0)
    pbd_head_kernel<<<grid(n, 256, members), 256, 0, (cudaStream_t)stream>>>(
        pos, prev, vel, mask, n, dt, gravity, failed, fold);
  return (int)cudaGetLastError();
}

extern "C" int pies_pbd_floor(float* x, const float* radius, const float* mask, int n,
                              float floor_height, const int* failed, int members, void* stream) {
  if (n > 0 && members > 0)
    pbd_floor_kernel<<<grid(n, 256, members), 256, 0, (cudaStream_t)stream>>>(
        x, radius, mask, n, floor_height, failed);
  return (int)cudaGetLastError();
}

extern "C" int pies_pbd_tail(float* pos, float* prev, float* vel, const float* x,
                             const float* radius, const float* mask, int n, float dt,
                             float keep_damp, float keep_fric, float floor_height, int* failed,
                             int members, void* stream) {
  if (n > 0 && members > 0)
    pbd_tail_kernel<<<grid(n, 256, members), 256, 0, (cudaStream_t)stream>>>(
        pos, prev, vel, x, radius, mask, n, dt, keep_damp, keep_fric, floor_height, failed);
  return (int)cudaGetLastError();
}
