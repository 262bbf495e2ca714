// The NaN-keeping min and max shared by the kernels.  fminf and fmaxf drop a
// NaN; jnp.minimum / jnp.maximum and torch.minimum / torch.maximum keep it,
// and the plain twins use those.
#pragma once

#include <cuda_runtime.h>

namespace pies {

// max(a, b) that keeps a NaN in `a`, as jnp.maximum and torch.clamp_min do
// against a constant b.
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return (a != a) ? a : fmaxf(a, b);
}

// min / max that keep a NaN from either side.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

}  // namespace pies
