// The per-node point-triangle force of the PD iterations, shared by T7's
// force kernel (pt_coupling.cu) and T2's fused contact mode
// (tet_cols_substep.cu).
//
// Replaces (JAX): pies_tpu/solver/tetcols.py:194-260 pt_force_cols.  For
// one node: over its incidence entries (ascending, entry e = a*cap + i is
// column a of contact i), each contact's point push-out delta along the
// unit normal of its triangle at the iterate x, summed as
// (w*mask*AtA[a][0]) * delta in the entries' order: the JAX package's CPU
// scatter order, so the sum is its sum (no float atomic).  With -fmad=false
// every caller rounds as the plain twin (solver/tetcols.py:pt_force_plain).
#pragma once

#include <cuda_runtime.h>

// Everything is internal to each translation unit that includes this file.
namespace pies {
namespace {

constexpr float kPtWeight = 1.0e4f;  // CollisionConstraint.h:33

// Column 0 of the point-triangle AtA: 3 for the point, -1 for a corner.
__device__ __forceinline__ float pt_ata_col0(int a) { return a == 0 ? 3.0f : -1.0f; }

// acc = node's force from its `len` entries at `entries` (x, pt_idx and
// pt_mask the member's own).
__device__ __forceinline__ void pt_node_force(const float* x, const int* pt_idx,
                                              const float* pt_mask, const int* entries,
                                              int len, int cap, float thickness,
                                              float acc[3]) {
  acc[0] = acc[1] = acc[2] = 0.0f;
  for (int j = 0; j < len; ++j) {
    const int ent = entries[j];
    const int a = ent / cap, i = ent - a * cap;
    const int* idx = pt_idx + (size_t)i * 4;
    float q[4][3];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d) q[c][d] = x[(size_t)idx[c] * 3 + d];
    float e1[3], e2[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      e1[d] = q[2][d] - q[1][d];
      e2[d] = q[3][d] - q[1][d];
    }
    float nx = e1[1] * e2[2] - e1[2] * e2[1];
    float ny = e1[2] * e2[0] - e1[0] * e2[2];
    float nz = e1[0] * e2[1] - e1[1] * e2[0];
    const float nn = sqrtf(nx * nx + ny * ny + nz * nz);
    const float inv = 1.0f / (nn < 1e-20f ? 1e-20f : nn);
    nx = nx * inv;
    ny = ny * inv;
    nz = nz * inv;
    const float ndp =
        nx * (q[0][0] - q[1][0]) + ny * (q[0][1] - q[1][1]) + nz * (q[0][2] - q[1][2]);
    const float disp = ndp < thickness ? thickness - ndp : 0.0f;
    const float w = (kPtWeight * pt_mask[i]) * pt_ata_col0(a);
    acc[0] = acc[0] + w * (disp * nx);
    acc[1] = acc[1] + w * (disp * ny);
    acc[2] = acc[2] + w * (disp * nz);
  }
}

}  // namespace
}  // namespace pies
