// Kernel T13: the local step of the shape- and goal-matching groups of one
// PD iteration, writing each member's force row w A^T B p into the row
// buffer that kernel T9's stage 2 sums per node.
//
// Replaces (JAX): pies_tpu/constraints/projections.py:409
// shape_group_moments and :446 project_shape with
// pies_tpu/ops/math3d.py:410 extract_rotation, and
// pies_tpu/constraints/projections.py:488 project_goal; both with the
// member weighting of pies_tpu/solver/assembly.py:275-278.
//
// Shape: one block of kShapeBlock = 128 threads per group.  The groups are
// consecutive runs of the member list (member_start, built group after
// group by topology.build_groups), so there is no scatter: lane t adds the
// 15 per-member values (x | m x_i mat_j | m mat) of members t, t + 128, ...
// of its group one after another, the lanes are summed by the pairwise
// tree v[t] = v[t] + v[t + s], s = 64 .. 1, and thread 0 forms the COM
// (equal weights 1/count) and the moment P, F = P Qinv (F = I for a padded
// group), runs the fixed-trip rotation extraction from the group's
// quaternion and stores the new one in place.  Then every lane projects its
// members: row = w[g] mask (R mat + com).  Members past the last group's run
// are padding (mask 0) and are written by the last group's block.  The
// plain twin (constraints/projections.py: shape_group_sums, project_shape)
// sums in the same order; the two differ by the roundoff of sinf and cosf.
// Groups may share nodes: only stage 2's per-node sum sees that.
//
// Goal: one thread per member, row = w[g] mask T[g] (mat, 1).
//
// Ensembles (the local step under jax.vmap, pies_tpu/parallel/ensemble.py:41):
// blockIdx.y is the member b of `members`.  The groups are the shared
// topology's; b's positions start at b*N*3, its masses at b*N, its
// rotations (shape_quats, per-member state) at b*G*4, its rows at b*S*3 (S
// the row buffer's member stride) and its latch at failed[2b].
//
// Bound: device memory.  A shape member reads its node id, material
// coordinates and mask (20 B) and its node's position and mass (16 B,
// gathered) and writes one row (12 B); a group reads 60 B and reads and
// writes its quaternion.  A goal member reads 24 B and writes 12 B.
#include <cuda_runtime.h>

#include "nan_math.cuh"

namespace {

using pies::max_keep_nan;

constexpr int kShapeBlock = 128;

__device__ __forceinline__ void quat_to_mat(const float q[4], float r[9]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  r[0] = 1.0f - 2.0f * (yy + zz);
  r[1] = 2.0f * (xy - wz);
  r[2] = 2.0f * (xz + wy);
  r[3] = 2.0f * (xy + wz);
  r[4] = 1.0f - 2.0f * (xx + zz);
  r[5] = 2.0f * (yz - wx);
  r[6] = 2.0f * (xz - wy);
  r[7] = 2.0f * (yz + wx);
  r[8] = 1.0f - 2.0f * (xx + yy);
}

// One trip of extract_rotation.  The torque's scale is 1/|den| + 1e-9, the
// JAX package's expression (pies_tpu/ops/math3d.py:432), not
// 1/(|den| + 1e-9): the port is held to that package.
__device__ __forceinline__ void rotation_trip(const float a[9], float q[4]) {
  float r[9];
  quat_to_mat(q, r);
  float num[3] = {0.0f, 0.0f, 0.0f}, dots[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float rc[3] = {r[k], r[3 + k], r[6 + k]};
    const float ac[3] = {a[k], a[3 + k], a[6 + k]};
    const float c[3] = {rc[1] * ac[2] - rc[2] * ac[1],
                        rc[2] * ac[0] - rc[0] * ac[2],
                        rc[0] * ac[1] - rc[1] * ac[0]};
#pragma unroll
    for (int d = 0; d < 3; ++d) num[d] = k == 0 ? c[d] : num[d] + c[d];
    dots[k] = rc[0] * ac[0] + rc[1] * ac[1] + rc[2] * ac[2];
  }
  const float den = dots[0] + dots[1] + dots[2];
  const float scale = 1.0f / fabsf(den) + 1e-9f;
  const float om[3] = {num[0] * scale, num[1] * scale, num[2] * scale};
  const float w = sqrtf(om[0] * om[0] + om[1] * om[1] + om[2] * om[2]);
  if (w < 1e-9f) return;  // converged: keep q (a NaN w goes on, as where())
  const float wn = max_keep_nan(w, 1e-20f);
  const float half = 0.5f * w;
  const float s = sinf(half);
  const float dq[4] = {cosf(half), s * (om[0] / wn), s * (om[1] / wn),
                       s * (om[2] / wn)};
  float qn[4];
  qn[0] = dq[0] * q[0] - dq[1] * q[1] - dq[2] * q[2] - dq[3] * q[3];
  qn[1] = dq[0] * q[1] + dq[1] * q[0] + dq[2] * q[3] - dq[3] * q[2];
  qn[2] = dq[0] * q[2] - dq[1] * q[3] + dq[2] * q[0] + dq[3] * q[1];
  qn[3] = dq[0] * q[3] + dq[1] * q[2] - dq[2] * q[1] + dq[3] * q[0];
  const float norm = max_keep_nan(
      sqrtf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3]),
      1e-20f);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = qn[k] / norm;
}

__global__ void __launch_bounds__(kShapeBlock)
    shape_rows_kernel(const float* __restrict__ x,
                      const float* __restrict__ mass,
                      const int* __restrict__ node_idx,
                      const float* __restrict__ mat,
                      const float* __restrict__ member_mask,
                      const int* __restrict__ member_start,
                      const float* __restrict__ gw,
                      const float* __restrict__ group_mask,
                      const float* __restrict__ inv_count,
                      const float* __restrict__ qinv, float* __restrict__ quats,
                      float* __restrict__ rows, int m, int groups, int trips,
                      const int* __restrict__ failed, int n, int stride) {
  __shared__ float sm[15][kShapeBlock];
  __shared__ float rc[12];  // R row-major, then the COM
  const int mb = blockIdx.y;
  if (failed[2 * mb] != 0) return;
  x += (size_t)mb * n * 3;
  mass += (size_t)mb * n;
  quats += (size_t)mb * groups * 4;
  rows += (size_t)mb * stride * 3;
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int m0 = member_start[g];
  const int m1 = member_start[g + 1];

  float acc[15];
#pragma unroll
  for (int k = 0; k < 15; ++k) acc[k] = 0.0f;
  for (int j = m0 + t; j < m1; j += kShapeBlock) {
    const int node = node_idx[j];
    const float mk = member_mask[j];
    const float xg[3] = {x[(size_t)node * 3] * mk, x[(size_t)node * 3 + 1] * mk,
                         x[(size_t)node * 3 + 2] * mk};
    const float mm = mass[node] * mk;
    const float mc[3] = {mat[(size_t)j * 3], mat[(size_t)j * 3 + 1],
                         mat[(size_t)j * 3 + 2]};
    float v[15];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      v[i] = xg[i];
      const float mx = mm * xg[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) v[3 + 3 * i + c] = mx * mc[c];
      v[12 + i] = mm * mc[i];
    }
    const bool first = j == m0 + t;
#pragma unroll
    for (int k = 0; k < 15; ++k) acc[k] = first ? v[k] : acc[k] + v[k];
  }
#pragma unroll
  for (int k = 0; k < 15; ++k) sm[k][t] = acc[k];
  __syncthreads();
  for (int s = kShapeBlock / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int k = 0; k < 15; ++k) sm[k][t] = sm[k][t] + sm[k][t + s];
    }
    __syncthreads();
  }

  if (t == 0) {
    float com[3], a[9];
    const float ic = inv_count[g];
#pragma unroll
    for (int i = 0; i < 3; ++i) com[i] = sm[i][0] * ic;
    if (group_mask[g] > 0.0f) {
      float p[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          p[3 * i + c] = sm[3 + 3 * i + c][0] - com[i] * sm[12 + c][0];
      const float* qi = qinv + (size_t)g * 9;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          a[3 * i + c] = p[3 * i] * qi[c] + p[3 * i + 1] * qi[3 + c] +
                         p[3 * i + 2] * qi[6 + c];
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) a[k] = (k % 4 == 0) ? 1.0f : 0.0f;
    }
    float q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = quats[(size_t)g * 4 + k];
#pragma unroll 1
    for (int it = 0; it < trips; ++it) rotation_trip(a, q);
#pragma unroll
    for (int k = 0; k < 4; ++k) quats[(size_t)g * 4 + k] = q[k];
    quat_to_mat(q, rc);
#pragma unroll
    for (int i = 0; i < 3; ++i) rc[9 + i] = com[i];
  }
  __syncthreads();

  const float wg = gw[g];
  const int end = g == groups - 1 ? m : m1;
  for (int j = m0 + t; j < end; j += kShapeBlock) {
    const float wm = wg * member_mask[j];
    const float mc[3] = {mat[(size_t)j * 3], mat[(size_t)j * 3 + 1],
                         mat[(size_t)j * 3 + 2]};
#pragma unroll
    for (int i = 0; i < 3; ++i)
      rows[(size_t)j * 3 + i] =
          wm * (rc[3 * i] * mc[0] + rc[3 * i + 1] * mc[1] +
                rc[3 * i + 2] * mc[2] + rc[9 + i]);
  }
}

__global__ void __launch_bounds__(256)
    goal_rows_kernel(const int* __restrict__ group_idx,
                     const float* __restrict__ mat,
                     const float* __restrict__ member_mask,
                     const float* __restrict__ gw,
                     const float* __restrict__ transforms,
                     float* __restrict__ rows, int m,
                     const int* __restrict__ failed, int stride) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int mb = blockIdx.y;
  if (failed[2 * mb] != 0) return;
  rows += (size_t)mb * stride * 3;
  const int g = group_idx[j];
  const float wm = gw[g] * member_mask[j];
  const float* tr = transforms + (size_t)g * 16;
  const float mc[3] = {mat[(size_t)j * 3], mat[(size_t)j * 3 + 1],
                       mat[(size_t)j * 3 + 2]};
#pragma unroll
  for (int i = 0; i < 3; ++i)
    rows[(size_t)j * 3 + i] =
        wm * (tr[4 * i] * mc[0] + tr[4 * i + 1] * mc[1] + tr[4 * i + 2] * mc[2] +
              tr[4 * i + 3]);
}

}  // namespace

extern "C" int pies_shape_rows(const float* x, const float* mass,
                               const int* node_idx, const float* mat,
                               const float* member_mask,
                               const int* member_start, const float* gw,
                               const float* group_mask, const float* inv_count,
                               const float* qinv, float* quats, float* rows,
                               int m, int groups, int trips, const int* failed,
                               int n, int stride, int members, void* stream) {
  if (m > 0 && groups > 0 && members > 0) {
    shape_rows_kernel<<<dim3(groups, members), kShapeBlock, 0, (cudaStream_t)stream>>>(
        x, mass, node_idx, mat, member_mask, member_start, gw, group_mask,
        inv_count, qinv, quats, rows, m, groups, trips, failed, n, stride);
  }
  return (int)cudaGetLastError();
}

extern "C" int pies_goal_rows(const int* group_idx, const float* mat,
                              const float* member_mask, const float* gw,
                              const float* transforms, float* rows, int m,
                              const int* failed, int stride, int members,
                              void* stream) {
  if (m > 0 && members > 0) {
    const int threads = 256;
    const dim3 grid((m + threads - 1) / threads, members);
    goal_rows_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        group_idx, mat, member_mask, gw, transforms, rows, m, failed, stride);
  }
  return (int)cudaGetLastError();
}
