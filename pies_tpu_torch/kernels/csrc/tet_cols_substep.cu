// Kernel T2: the whole PD iteration loop of one substep on the tet-column
// fast path, one thread per tet.
//
// Replaces (JAX): pies_tpu/solver/tetcols.py:263 substep_cols (loop body
// :327-370, residual and stale static projection :401-420), with
// block_factor_cols (:125) and block_solve_cols (:143), whose device
// functions tet_block.cuh shares with kernel T22, and _block_matvec_cols
// (:162).
//
// The tets of the soup are node-disjoint, so the PD system is exactly
// block-diagonal in 4x4 blocks and each tet's iterations depend on nothing
// but its own four nodes.  A thread therefore factors its block once, keeps
// x, the stale iterate and the last force in registers across all
// iterations, and writes x, the static projection and its residual share
// once.  The first iteration's tet force may come from kernel T1 (f0), which
// evaluates the same device function on the same input; the rest are
// computed here.
//
// Bound: compute, about 1.6k flops per tet and iteration on 48 bytes of x;
// device memory is touched only at entry and exit (~200 bytes per tet).
// Blocks of padding (no live tet) have zero off-diagonals and zero tet
// force: the same code then reduces to the plain diagonal solve, and the
// mask re-select keeps padded nodes exactly at their park positions.
//
// With point-triangle contacts (pt_count non-null and > 0 on the device)
// the caller runs one iteration per launch, after kernel T7 has written the
// contacts' diagonal `ptd` for every node with contact entries (those with
// row_start[n+1] > row_start[n]); such a node adds ptd*x and then its
// contact force to its force after the floor term
// (pies_tpu/solver/tetcols.py:341-349).  Elsewhere both are exact zeros and
// are not read.  The contact force is T7's `contact` array, or, fused (no
// `contact`; T7's incidence `entries` and the contacts instead), computed
// here per node by pt_force.cuh from the iterate this launch reads: no
// thread of the launch writes that buffer (it writes x_out), so every
// node's force is T7's force kernel's, bit for bit, and the tick saves a
// launch per iteration.
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): blockIdx.y
// is the member b.  Its nodes start at b*4k (x, msn, diag, mask, wf, ptd,
// contact and the outputs), its latch is failed[2b], its first force f0[b]
// of [members, 12, C], its contact count pt_count[b], its incidence row
// row_start + b*(4k+1) and entries + b*4cap, its contacts pt_idx [b] of
// [members, cap, 4] and pt_mask [b] of [members, cap], and its residual
// shares r2[b] of [members, K]; the tets' parameters, block6 and the pin
// force are shared.
#include <cuda_runtime.h>

#include "pt_force.cuh"
#include "tet_block.cuh"
#include "tet_force.cuh"

namespace {

struct SubstepIn {
  const float* x;       // [N, 3]
  const float* msn;     // [N, 3]  M s_n / h^2
  const float* pin;     // [N, 3]  folded pin force, or null
  const float* diag;    // [N]
  const float* mask;    // [N]
  const float* wf;      // [N]     W_STATIC * floor_count * active
  const float* block6;  // [6, K]
  const float* f0;      // [12, C] first iteration's tet force, or null
  const int* failed;    // latch slot 0 (tick start), [2 members]
  const float* ptd;     // [N] contact diagonal, or null
  const float* contact;  // [N, 3] contact force, or null (fused, or no contacts)
  const int* row_start;  // [N + 1] T7's incidence, or null
  const int* pt_count;   // live contacts (device scalar), or null
  const int* entries;    // [4 cap] T7's incidence entries (fused), or null
  const int* pt_idx;     // [cap, 4] contacts (fused), or null
  const float* pt_mask;  // [cap] (fused), or null
  int cap;
  float thickness;
};

struct SubstepOut {
  float* x;       // [N, 3]
  float* stat;    // [N, 3]  stale static projection
  float* r2;      // [K]     per-tet squared residual
};

__global__ void __launch_bounds__(128)
    tet_cols_substep_kernel(SubstepIn in, pies::TetBatchPtrs b, SubstepOut o,
                            int k, int c, int iterations, float plane) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= k) return;
  const size_t member = blockIdx.y;
  if (in.failed[2 * member] != 0) {
    o.r2[member * k + t] = 0.0f;  // a skipped tick reports residual 0, as the JAX tick
    return;
  }
  const size_t base = member * 4 * k;  // the member's first node
  const size_t n0 = base + (size_t)4 * t;
  const size_t l0 = (size_t)4 * t;  // the tet's first node in the shared topology

  float x[4][3], rhs0[4][3], dg[4], mk[4], wf[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    dg[a] = in.diag[n0 + a];
    mk[a] = in.mask[n0 + a];
    wf[a] = in.wf[n0 + a];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const size_t i = (n0 + a) * 3 + d;
      x[a][d] = in.x[i];
      rhs0[a][d] = in.pin != nullptr ? in.msn[i] + in.pin[(l0 + a) * 3 + d] : in.msn[i];
    }
  }
  bool pt_on[4] = {false, false, false, false};
  float pt_d[4] = {0.0f, 0.0f, 0.0f, 0.0f}, pt_f[4][3] = {};
  if (in.pt_count != nullptr && in.pt_count[member] > 0) {
    const int* rs = in.row_start + member * (4 * k + 1);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const size_t node = n0 + a;
      pt_on[a] = rs[l0 + a + 1] > rs[l0 + a];
      pt_d[a] = pt_on[a] ? in.ptd[node] : 0.0f;
      if (in.contact != nullptr) {
#pragma unroll
        for (int d = 0; d < 3; ++d) pt_f[a][d] = pt_on[a] ? in.contact[node * 3 + d] : 0.0f;
      } else if (pt_on[a]) {  // fused: the member's contacts at this launch's iterate
        pies::pt_node_force(in.x + base * 3, in.pt_idx + member * in.cap * 4,
                            in.pt_mask + member * in.cap,
                            in.entries + member * 4 * in.cap + rs[l0 + a],
                            rs[l0 + a + 1] - rs[l0 + a], in.cap, in.thickness, pt_f[a]);
      }
    }
  }
  float b6[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) b6[r] = in.block6[(size_t)r * k + t];
  const float b01 = b6[0], b02 = b6[1], b03 = b6[2], b12 = b6[3],
              b13 = b6[4], b23 = b6[5];
  // Batched 4x4 Cholesky (block_factor_cols, tet_block.cuh).
  const pies::TetBlock fac = pies::tet_block_factor(dg, b6);

  const bool live = t < c;
  pies::TetParams tp;
  if (live) pies::load_tet(b, t, tp);

  float stale[4][3], force[4][3];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      stale[a][d] = x[a][d];
      force[a][d] = 0.0f;
    }

#pragma unroll 1
  for (int it = 0; it < iterations; ++it) {
    float f12[12];
    if (!live) {
#pragma unroll
      for (int r = 0; r < 12; ++r) f12[r] = 0.0f;
    } else if (it == 0 && in.f0 != nullptr) {
#pragma unroll
      for (int r = 0; r < 12; ++r) f12[r] = in.f0[(member * 12 + r) * b.ld + t];
    } else {
      pies::tet_force12(x, tp, f12);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float sp_y = pies::nanmax(x[a][1], plane);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        float fad = rhs0[a][d] + f12[3 * a + d];
        fad = fad + wf[a] * (d == 1 ? sp_y : x[a][d]);
        if (pt_on[a]) fad = (fad + pt_d[a] * x[a][d]) + pt_f[a][d];
        force[a][d] = fad;
      }
    }
    // Block solve (block_solve_cols, tet_block.cuh) and the padding
    // re-select.
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float rhs[4] = {force[0][d], force[1][d], force[2][d], force[3][d]};
      float z[4];
      pies::tet_block_solve(fac, rhs, z);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        stale[a][d] = x[a][d];
        x[a][d] = mk[a] > 0.0f ? z[a] : x[a][d];
      }
    }
  }

  // Residual ||force - A x|| share of this block (_block_matvec_cols).
  float r2 = 0.0f;
  if (iterations > 0) {
    const float off[4][4] = {{0.0f, b01, b02, b03},
                             {b01, 0.0f, b12, b13},
                             {b02, b12, 0.0f, b23},
                             {b03, b13, b23, 0.0f}};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        float acc = dg[a] * x[a][d];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
          if (bb != a) acc = acc + off[a][bb] * x[bb][d];
        const float r = mk[a] > 0.0f ? force[a][d] - acc : 0.0f;
        r2 = r2 + r * r;
      }
  }
  o.r2[member * k + t] = r2;

#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const size_t i = (n0 + a) * 3 + d;
      o.x[i] = x[a][d];
      o.stat[i] = d == 1 ? pies::nanmax(stale[a][1], plane) : stale[a][d];
    }
}

}  // namespace

extern "C" int pies_tet_cols_substep(
    const float* x, const float* msn, const float* pin, const float* diag,
    const float* mask, const float* wf, const float* block6, const float* f0,
    const float* qinv, const float* g, const float* slo, const float* shi,
    const float* sw, const float* vlo, const float* vhi, const float* vw,
    float* x_out, float* static_out, float* r2, int k, int c, int iterations,
    float plane, const int* failed, const float* ptd, const float* contact,
    const int* row_start, const int* pt_count, const int* entries, const int* pt_idx,
    const float* pt_mask, int cap, float thickness, int members, void* stream) {
  if (k > 0 && members > 0) {
    SubstepIn in{x,         msn,       pin,   diag,     mask,    wf,
                 block6,    f0,        failed, ptd,     contact, row_start,
                 pt_count,  entries,   pt_idx, pt_mask, cap,     thickness};
    pies::TetBatchPtrs b{qinv, g, slo, shi, sw, vlo, vhi, vw, c};
    SubstepOut o{x_out, static_out, r2};
    const int threads = 128;
    const dim3 blocks((k + threads - 1) / threads, members);
    tet_cols_substep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        in, b, o, k, c < k ? c : k, iterations, plane);
  }
  return (int)cudaGetLastError();
}
