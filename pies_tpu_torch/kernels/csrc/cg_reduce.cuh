// Fixed-order reductions and the trip gate shared by the Jacobi-PCG
// kernels T10 (ell_matvec.cu) and T11 (pcg.cu).
//
// A dot product over N nodes is summed in two fixed trees, which the plain
// twins in pies_tpu_torch/solver/assembly.py (block_partials, finalize)
// repeat operation for operation, so kernel and twin agree bit for bit:
//   * each block of kCgBlock = 256 threads, one node per thread, sums its
//     256 values (0 past N) by the pairwise tree v[t] = v[t] + v[t + s],
//     s = 128, 64, ..., 1, into one partial per block;
//   * a stage that needs the total sums the P partials in each of its
//     blocks: thread t adds part[t], part[t + 256], ... (0 past P) in that
//     order, then the same 256-wide tree.  Every block gets the same total,
//     and no launch is spent on a separate reduction.
//
// The gate is the condition of the JAX package's CG while_loop
// (pies_tpu/solver/assembly.py:714-716), evaluated on the device before
// each trip: every stage of trip i returns at once unless trips 0..i-1 ran
// and, with the early exit on, rz_i > float32(rtol^2) * rz_0.  The host
// enqueues all cg_iterations trips and never waits; the trips that the
// while_loop would not run change nothing.
//
// Ranks (the domain decomposition's CG, pies_tpu/parallel/domain.py:612,
// whose dots psum over the devices): a launch covers this rank's nodes, P_r
// blocks, and writes their partials at CgGate::offset = r P_r of a buffer
// of R P_r that torch.distributed gathers in place (all ranks' blocks in
// rank order); every total above then sums those R P_r partials in the
// same tree on every rank, so the exit and the trip count are the same on
// every rank, and reruns are bit-identical.
//
// Ensembles (the CG under jax.vmap, pies_tpu/parallel/ensemble.py:41):
// each member has its own gate.  A stage's blockIdx.y is the member b, and
// CgGate::member(b) points at b's trip count trips[b], its r.z partials
// prz[b] ([2, P]) and prz0[b] ([P]).  Trip i of member b runs iff b ran
// trips 0..i-1 and, with the early exit on, rz_b > float32(rtol^2) rz0_b:
// a member that has exited is left bit for bit, as vmap's select of the
// batched while_loop's carry leaves it, while the others go on.  The trees
// above are per member and do not depend on the member count.
#pragma once

#include "nan_math.cuh"

namespace pies {

constexpr int kCgBlock = 256;

// The block's pairwise tree over one value per thread; every thread gets
// the sum.  Needs blockDim.x == kCgBlock and all threads of the block.
__device__ __forceinline__ float block_sum(float v, float* sm) {
  const int t = threadIdx.x;
  __syncthreads();  // the previous call's readers of sm[0] are done
  sm[t] = v;
  __syncthreads();
#pragma unroll
  for (int s = kCgBlock / 2; s > 0; s >>= 1) {
    if (t < s) sm[t] = sm[t] + sm[t + s];
    __syncthreads();
  }
  return sm[0];
}

// The total of P block partials, the same in every block.
__device__ __forceinline__ float finalize(const float* part, int p, float* sm) {
  const int t = threadIdx.x;
  const int span = (p + kCgBlock - 1) / kCgBlock * kCgBlock;
  float acc = t < p ? part[t] : 0.0f;
  for (int j = t + kCgBlock; j < span; j += kCgBlock)
    acc = acc + (j < p ? part[j] : 0.0f);
  return block_sum(acc, sm);
}

struct CgGate {
  const int* trips;   // [B] trips completed in this solve, or null: no gate
  const float* prz;   // [B, 2, P] partials of r.z; trip i reads row i & 1
  const float* prz0;  // [B, P] partials of the initial r.z
  int parts;          // P = the partials a total sums (and each member's stride)
  int trip;           // this trip's index i
  int early_exit;     // cg_rtol > 0
  float rtol2;        // float32(cg_rtol^2)
  int offset = 0;     // where this launch writes its blocks' partials: 0, or
                      // across ranks this rank's slice r P_r of the gathered
                      // [R P_r] buffer (P = R P_r), every rank's blocks in
                      // rank order

  // Member b's gate: its own count and partials.
  __device__ __forceinline__ CgGate member(int b) const {
    CgGate g = *this;
    if (trips != nullptr) {
      g.trips = trips + b;
      g.prz = prz + (size_t)b * 2 * parts;
      g.prz0 = prz0 + (size_t)b * parts;
    }
    return g;
  }
};

// The while_loop's condition before trip i; sets *rz = rz_i when gated.
// Uniform across the block (trips reads i or i + 1 during the direction
// stage, which writes i + 1: both pass).
__device__ __forceinline__ bool cg_active(const CgGate& g, float* sm, float* rz) {
  if (g.trips == nullptr) return true;
  if (*g.trips < g.trip) return false;
  *rz = finalize(g.prz + (size_t)(g.trip & 1) * g.parts, g.parts, sm);
  if (!g.early_exit) return true;
  const float rz0 = finalize(g.prz0, g.parts, sm);
  return *rz > g.rtol2 * rz0;
}

}  // namespace pies
