// The 4x4 block Cholesky of a disjoint-tet PD system and its block solve,
// shared by kernel T2 (tet_cols_substep.cu, the direct solve of the
// tet-column path) and kernel T22 (tet_block.cu, the factor of the generic
// path's block preconditioner, and its solve inside T11's stages, pcg.cu).
//
// Replaces (JAX): pies_tpu/solver/assembly.py:602 tet_block_factor and :633
// tet_block_apply, pies_tpu/solver/tetcols.py:125 block_factor_cols and :143
// block_solve_cols.  The plain twins are block_factor_cols and
// block_solve_cols of pies_tpu_torch/solver/tetcols.py, operation for
// operation; 1/sqrt is IEEE 1.0f / sqrtf (the JAX package's rsqrt rounds
// once, this twice: they agree to roundoff).
//
// A block's factor is the 10 columns (l10, l20, l30, l21, l31, l32, i00,
// i11, i22, i33): the strict lower part of L and the reciprocals of its
// diagonal, from the block's diagonal d[4] and upper off-diagonals
// b6 = (b01, b02, b03, b12, b13, b23).
#pragma once

namespace pies {

constexpr int kTetBlockCols = 10;

struct TetBlock {
  float l10, l20, l30, l21, l31, l32, i00, i11, i22, i33;
};

__device__ __forceinline__ TetBlock tet_block_factor(const float d[4], const float b6[6]) {
  TetBlock f;
  f.i00 = 1.0f / sqrtf(d[0]);
  f.l10 = b6[0] * f.i00;
  f.l20 = b6[1] * f.i00;
  f.l30 = b6[2] * f.i00;
  f.i11 = 1.0f / sqrtf(d[1] - f.l10 * f.l10);
  f.l21 = (b6[3] - f.l20 * f.l10) * f.i11;
  f.l31 = (b6[4] - f.l30 * f.l10) * f.i11;
  f.i22 = 1.0f / sqrtf(d[2] - f.l20 * f.l20 - f.l21 * f.l21);
  f.l32 = (b6[5] - f.l30 * f.l20 - f.l31 * f.l21) * f.i22;
  f.i33 = 1.0f / sqrtf(d[3] - f.l30 * f.l30 - f.l31 * f.l31 - f.l32 * f.l32);
  return f;
}

// z = (L L^T)^-1 r for one right-hand side of the block.
__device__ __forceinline__ void tet_block_solve(const TetBlock& f, const float r[4],
                                                float z[4]) {
  const float y0 = r[0] * f.i00;
  const float y1 = (r[1] - f.l10 * y0) * f.i11;
  const float y2 = (r[2] - f.l20 * y0 - f.l21 * y1) * f.i22;
  const float y3 = (r[3] - f.l30 * y0 - f.l31 * y1 - f.l32 * y2) * f.i33;
  z[3] = y3 * f.i33;
  z[2] = (y2 - f.l32 * z[3]) * f.i22;
  z[1] = (y1 - f.l21 * z[2] - f.l31 * z[3]) * f.i11;
  z[0] = (y0 - f.l10 * z[1] - f.l20 * z[2] - f.l30 * z[3]) * f.i00;
}

// Block t's factor from the column-major table f32[10, K].
__device__ __forceinline__ TetBlock load_tet_block(const float* __restrict__ factors, int t,
                                                   int k) {
  const float* c = factors + t;
  return TetBlock{c[0],          c[(size_t)k],     c[(size_t)2 * k], c[(size_t)3 * k],
                  c[(size_t)4 * k], c[(size_t)5 * k], c[(size_t)6 * k], c[(size_t)7 * k],
                  c[(size_t)8 * k], c[(size_t)9 * k]};
}

// The block preconditioner z = (L L^T)^-1 r at node i of a CG stage that
// runs one thread per node: the four threads of node i's block are four
// neighbouring lanes of one warp (blocks of the node grid start at
// multiples of 4), which trade their residual rows through shuffles.  All
// 32 lanes must call it, those past n included (their ri is not read);
// zi is written for i < n only.
__device__ __forceinline__ void tet_block_precond(const float* __restrict__ factors, int n,
                                                  int i, const float ri[3], float zi[3]) {
  const int lane = threadIdx.x & 31;
  const int base = lane & ~3;
  float r[4][3];
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int d = 0; d < 3; ++d) r[b][d] = __shfl_sync(0xffffffffu, ri[d], base + b);
  if (i >= n) return;
  const TetBlock f = load_tet_block(factors, i >> 2, n >> 2);
  const int a = lane & 3;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float rr[4] = {r[0][d], r[1][d], r[2][d], r[3][d]};
    float z[4];
    tet_block_solve(f, rr, z);
    zi[d] = a == 0 ? z[0] : a == 1 ? z[1] : a == 2 ? z[2] : z[3];
  }
}

}  // namespace pies
