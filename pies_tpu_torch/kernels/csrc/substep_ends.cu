// Kernels T3 and T4: the elementwise head and tail of a PD substep, one
// thread per node.
//
// T3 replaces (JAX): the elementwise head of pies_tpu/solver/pd.py:59
// pd_substep (:71-83), collision/batches.py:202 detect_floor_active,
// solver/assembly.py system_diag / static_collision_diag (dense floor) and
// the floor weight of solver/tetcols.py:298.
// T4 replaces (JAX): pies_tpu/solver/pd.py:316 _finish_substep on the dense
// floor with no point-triangle contacts (the floor snap :333-361, the
// velocity :394-397, _static_floor_friction :589-617, the state update and
// the sim_failed latch :420-434), with the gravity of solver/step.py:119-124.
//
// Bound: device memory.  T3 reads 40 bytes and writes 36 per node, T4 reads
// 72 and writes 48, at a few flops each.  The design is one coalesced pass
// each, no scratch, and in-place state updates in T4.
//
// With the library's -fmad=false build every product, sum and quotient
// rounds as in the plain PyTorch twins, in the same order.  The one library
// call is powf for the friction decay (1-f)^count.
//
// On the entry-list floor T4 takes kernel T24's per-node counts of live
// entries as the friction's exponent (pd.py:601-604, the segment sum)
// instead of floor_count * active, and T24's snap flag as `active`.
//
// With node-node contacts T4 first adds kernel T27's friction impulse
// `nn_imp` (pd.py:398-402, every node).  With self-contact, T4 also takes
// kernel T8's contact friction impulse `fric` (added, before the floor
// friction, at every node with contact entries in T7's incidence when the
// device contact count is > 0; given without the incidence, at every node:
// the domain decomposition's halo-reduced friction, pies_tpu/parallel/
// domain.py:943-953).  It ORs the detection's capacity latch
// `overflow` (T5, T6, T14-T17, and the edge detection's T16) into the
// failure latch.
//
// sim_failed is an int[2] on the device (see pies_tpu_torch/state.py):
// slot 0 is the latch at the start of the tick, slot 1 takes the tail's OR.
// The first substep's head folds slot 1 into slot 0; every kernel after it
// returns at once when slot 0 is set, so a failed tick is a no-op, as
// step.tick's lax.cond makes it in the JAX package.
//
// Ensembles (pies_tpu/parallel/ensemble.py:41 ensemble_tick, the tick under
// jax.vmap): blockIdx.y is the member b of `members`.  Its node data sits at
// b*n + node, its latch at failed[2b], its detection words (overflow,
// pt_count) at [b] and its incidence row at b*(n+1); the topology
// (floor_count, stiffness_diag) is shared.  A latched member is left as it
// is while the others step, as vmap's select of lax.cond's branches does.
#include <cuda_runtime.h>

namespace {

constexpr float kWStatic = 1.0e4f;  // StaticCollisionConstraint weight

__global__ void __launch_bounds__(256)
    substep_head_kernel(const float* __restrict__ pos,
                        const float* __restrict__ vel,
                        const float* __restrict__ mass,
                        const float* __restrict__ mask,
                        const float* __restrict__ floor_count,
                        const float* __restrict__ stiffness_diag,
                        float* __restrict__ x_out, float* __restrict__ msn_out,
                        float* __restrict__ diag_out,
                        float* __restrict__ wf_out,
                        float* __restrict__ active_out, int n, float h,
                        float h2, float floor_threshold, int* failed,
                        int fold) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t g = (size_t)blockIdx.y * n + i;  // the member's node
  failed += 2 * blockIdx.y;
  const int was = fold ? (failed[0] | failed[1]) : failed[0];
  if (fold && i == 0 && was) failed[0] = 1;
  if (was) return;

  const float m = mask[g];
  const float moh2 = mass[g] / h2;
  float x[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const size_t j = g * 3 + d;
    x[d] = pos[j] + h * vel[j] * m;
    x_out[j] = x[d];
    msn_out[j] = x[d] * moh2;
  }
  const float fc = floor_count[i];
  const float act = (x[1] < floor_threshold && fc > 0.0f) ? 1.0f : 0.0f;
  const float wf = kWStatic * fc * act;
  active_out[g] = act;
  wf_out[g] = wf;
  diag_out[g] = moh2 + stiffness_diag[i] + wf;
}

__global__ void __launch_bounds__(256)
    substep_tail_kernel(float* __restrict__ pos, float* __restrict__ prev,
                        float* __restrict__ vel, float* __restrict__ forces,
                        const float* __restrict__ x_solved,
                        const float* __restrict__ static_proj,
                        const float* __restrict__ active,
                        const float* __restrict__ floor_count,
                        const float* __restrict__ inv_mass,
                        const float* __restrict__ mass,
                        const float* __restrict__ mask, int n, float h,
                        float damping, float gravity, float friction,
                        float static_threshold, int* failed,
                        const float* __restrict__ fric,
                        const int* __restrict__ row_start,
                        const int* __restrict__ pt_count,
                        const int* __restrict__ overflow,
                        const float* __restrict__ counts,
                        const float* __restrict__ nn_imp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int b = blockIdx.y;
  const size_t g = (size_t)b * n + i;  // the member's node
  failed += 2 * b;
  if (failed[0] != 0) return;
  if (i == 0 && overflow != nullptr && overflow[b] != 0) atomicOr(&failed[1], 1);
  const int* rs = row_start == nullptr ? nullptr : row_start + (size_t)b * (n + 1);
  // Without T7's incidence `fric` (when given) is added at every node.
  const bool pt = fric != nullptr && (rs == nullptr || (pt_count[b] > 0 && rs[i + 1] > rs[i]));

  const float act = active[g];
  const float m = mask[g];
  const float im = inv_mass[g];
  const float fy = -gravity * mass[g] * m;
  const float f[3] = {0.0f, fy, 0.0f};
  const float keep = 1.0f - damping;
  float x[3], v[3];
  bool finite = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const size_t j = g * 3 + d;
    // Floor snap to the stale static projection; point-triangle
    // stabilization is an exact no-op without contacts, and repeated snaps
    // equal one.
    x[d] = act > 0.0f ? static_proj[j] : x_solved[j];
    v[d] = (keep * (x[d] - prev[j]) / h + h * f[d] * im) * m;
    if (nn_imp != nullptr) v[d] = v[d] + nn_imp[j];  // kernel T27's friction
    if (pt) v[d] = v[d] + fric[j];
    finite = finite && isfinite(x[d]);
  }
  // Floor friction: (1-f)^count on x and z, the static threshold tested on
  // the velocity before the pass.
  const float count = counts != nullptr ? counts[g] : floor_count[i] * act;
  const float norm = sqrtf(v[0] * v[0] + v[2] * v[2]);
  float factor = norm < static_threshold
                     ? 0.0f
                     : powf(1.0f - friction, count);
  factor = count > 0.0f ? factor : 1.0f;
  v[0] = v[0] * factor;
  v[2] = v[2] * factor;

#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const size_t j = g * 3 + d;
    pos[j] = x[d];
    prev[j] = x[d];
    vel[j] = v[d];
    forces[j] = f[d];
  }
  if (!finite) atomicOr(&failed[1], 1);
}

}  // namespace

extern "C" int pies_substep_head(const float* pos, const float* vel,
                                 const float* mass, const float* mask,
                                 const float* floor_count,
                                 const float* stiffness_diag, float* x_out,
                                 float* msn_out, float* diag_out,
                                 float* wf_out, float* active_out, int n,
                                 float h, float h2, float floor_threshold,
                                 int* failed, int fold, int members, void* stream) {
  if (n > 0 && members > 0) {
    const int threads = 256;
    const dim3 blocks((n + threads - 1) / threads, members);
    substep_head_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        pos, vel, mass, mask, floor_count, stiffness_diag, x_out, msn_out,
        diag_out, wf_out, active_out, n, h, h2, floor_threshold, failed, fold);
  }
  return (int)cudaGetLastError();
}

extern "C" int pies_substep_tail(float* pos, float* prev, float* vel,
                                 float* forces, const float* x_solved,
                                 const float* static_proj, const float* active,
                                 const float* floor_count,
                                 const float* inv_mass, const float* mass,
                                 const float* mask, int n, float h,
                                 float damping, float gravity, float friction,
                                 float static_threshold, int* failed,
                                 const float* fric, const int* row_start,
                                 const int* pt_count, const int* overflow,
                                 const float* counts, const float* nn_imp, int members,
                                 void* stream) {
  if (n > 0 && members > 0) {
    const int threads = 256;
    const dim3 blocks((n + threads - 1) / threads, members);
    substep_tail_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        pos, prev, vel, forces, x_solved, static_proj, active, floor_count,
        inv_mass, mass, mask, n, h, damping, gravity, friction,
        static_threshold, failed, fric, row_start, pt_count, overflow, counts, nn_imp);
  }
  return (int)cudaGetLastError();
}
