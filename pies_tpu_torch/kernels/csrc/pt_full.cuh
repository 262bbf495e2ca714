// Kernel T23: full point-triangle contact coupling, as device functions
// that run inside the per-node passes of kernels T10 (the operator,
// ell_matvec.cu) and T9's stage 2 (the force, tet_force_nodes.cu), so a CG
// trip stays three launches and a PD iteration gains none.
//
// Replaces (JAX): pies_tpu/solver/assembly.py:559-574
// _apply_collision_terms (y += w A^T A x over the contacts, every CG
// apply) and :282-287 the stacked contact force (f += w A^T A p), with
// pies_tpu/collision/batches.py:286 project_point_tri in its stack form
// (build_stack=True: the point pushed out along the triangle's unit normal
// to `thickness`, the corners as they are).  A is the point-triangle
// differential matrix of batches.py:33 (ATA_DIFF4), w = 1e4 * mask.
//
// Each node adds the terms of its entries e = a*cap + k (column a of
// contact k) in T7's incidence (pt_coupling.cu), in ascending e, one after
// another onto its value: no float atomics, and the plain twins
// (solver/assembly.py: pt_full_operator_rows, pt_full_force_rows with
// collision.batches.csr_sum) add the same terms in the same order.  The JAX
// package scatters pt_idx row-major (contact k, then a) and sums each row of
// A^T A by its einsum: the results agree to float32 roundoff.  A contact is
// recomputed by each of its four nodes.
//
// Bound (per CG apply, per PD iteration): device memory over the live
// contacts, the 16-byte index row and the mask per incident entry and the
// four 12-byte rows of x it gathers (from L2), ~4x the contacts' 20 bytes.
//
// Ensembles: the kernels pass member b's view (PtFull::member): its
// contacts [b] of [members, cap, 4], mask, count, and T7's incidence rows
// [b] of [members, N + 1] and [members, 4 cap], all local to the member.
#pragma once

#include "nan_math.cuh"

namespace pies {

constexpr float kWPointTriFull = 1.0e4f;  // CollisionConstraint.h:33

// (A^T A)[a][b] of ATA_DIFF4: 3 at (0, 0), 1 on the rest of the diagonal,
// -1 in the rest of row and column 0, 0 elsewhere.
__device__ __forceinline__ float ata_diff4(int a, int b) {
  if (a == b) return a == 0 ? 3.0f : 1.0f;
  return (a == 0 || b == 0) ? -1.0f : 0.0f;
}

struct PtFull {
  const int* pt_idx;     // [members, cap, 4]
  const float* pt_mask;  // [members, cap]
  const int* pt_count;   // [members] live contacts (device scalars)
  const int* row_start;  // [members, N + 1] T7's incidence
  const int* entries;    // [members, 4 cap]
  int cap;
  float thickness;

  // Member b's view, for n nodes a member (no-op without contacts).
  __device__ __forceinline__ PtFull member(int b, int n) const {
    PtFull m = *this;
    if (m.pt_idx == nullptr) return m;
    const size_t bb = b;
    m.pt_idx += bb * cap * 4;
    m.pt_mask += bb * cap;
    m.pt_count += bb;
    m.row_start += bb * (n + 1);
    m.entries += bb * 4 * cap;
    return m;
  }
};

// Row a of A^T A q for the contact's four rows q[4][3].
__device__ __forceinline__ void ata_row(int a, const float q[4][3], float out[3]) {
  const float c0 = ata_diff4(a, 0), c1 = ata_diff4(a, 1), c2 = ata_diff4(a, 2),
              c3 = ata_diff4(a, 3);
#pragma unroll
  for (int d = 0; d < 3; ++d)
    out[d] = ((c0 * q[0][d] + c1 * q[1][d]) + c2 * q[2][d]) + c3 * q[3][d];
}

__device__ __forceinline__ void gather_contact(const float* __restrict__ x,
                                               const int* idx, float q[4][3]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int d = 0; d < 3; ++d) q[c][d] = x[(size_t)idx[c] * 3 + d];
}

// The stack form of project_point_tri: q[0] pushed out along the unit
// normal of (q[1], q[2], q[3]) when it lies within `thickness` of the
// plane (the normal divided per component by max(|n|, 1e-20), as
// jnp.cross then n / max(norm, 1e-20)); the corners stay.
__device__ __forceinline__ void project_stack(float q[4][3], float thickness) {
  float e1[3], e2[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    e1[d] = q[2][d] - q[1][d];
    e2[d] = q[3][d] - q[1][d];
  }
  const float nx = e1[1] * e2[2] - e1[2] * e2[1];
  const float ny = e1[2] * e2[0] - e1[0] * e2[2];
  const float nz = e1[0] * e2[1] - e1[1] * e2[0];
  const float nn = max_keep_nan(sqrtf(nx * nx + ny * ny + nz * nz), 1e-20f);
  const float n[3] = {nx / nn, ny / nn, nz / nn};
  const float ndp = n[0] * (q[0][0] - q[1][0]) + n[1] * (q[0][1] - q[1][1]) +
                    n[2] * (q[0][2] - q[1][2]);
  const float disp = ndp < thickness ? thickness - ndp : 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) q[0][d] = q[0][d] + disp * n[d];
}

// v_i += w * (A^T A q)[a] over node i's entries, q the contact's rows of x
// (project = false: the operator) or its stack projection (project =
// true: the force).  Nothing without live contacts.
template <bool kProject>
__device__ __forceinline__ void pt_full_add(const PtFull& p, const float* __restrict__ x,
                                            int i, float v[3]) {
  if (p.pt_count[0] <= 0) return;
  const int e1 = p.row_start[i + 1];
  for (int e = p.row_start[i]; e < e1; ++e) {
    const int ent = p.entries[e];
    const int a = ent / p.cap, k = ent - a * p.cap;
    float q[4][3];
    gather_contact(x, p.pt_idx + (size_t)k * 4, q);
    if (kProject) project_stack(q, p.thickness);
    float row[3];
    ata_row(a, q, row);
    const float w = kWPointTriFull * p.pt_mask[k];
#pragma unroll
    for (int d = 0; d < 3; ++d) v[d] = v[d] + w * row[d];
  }
}

}  // namespace pies
