// The asymmetric distance projection of the PBD solver, shared by kernel
// T18 (its count-averaged Jacobi rows) and kernel T19 (the chain walk and
// the colour classes).
//
// Replaces (JAX): pies_tpu/constraints/projections.py:25 project_distance.
// Each caller combines the direction and the displacement in the order of
// its own plain twin; the build has no FMA contraction.
#pragma once

#include <cuda_runtime.h>

#include "nan_math.cuh"

namespace pies {

// The link from pa toward tg of rest length `rest`: its unit direction into
// dir (the x axis when the link is shorter than 1e-5); returns the
// displacement rest - |tg - pa|.
__device__ __forceinline__ float pbd_link(const float tg[3], const float pa[3], float rest,
                                          float dir[3]) {
  float df[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) df[d] = tg[d] - pa[d];
  const float dist = sqrtf(df[0] * df[0] + df[1] * df[1] + df[2] * df[2]);
  const bool safe = dist > 1e-5f;
  const float den = max_keep_nan(dist, 1e-20f);
#pragma unroll
  for (int d = 0; d < 3; ++d) dir[d] = safe ? df[d] / den : (d == 0 ? 1.0f : 0.0f);
  return rest - dist;
}

}  // namespace pies
