// Kernel T2: the whole PD iteration loop of one substep on the tet-column
// fast path, one thread per tet.
//
// Replaces (JAX): pies_tpu/solver/tetcols.py:263-420 substep_cols (loop
// body :327-370, residual and stale static projection :401-420), with
// block_factor_cols (:125) and block_solve_cols (:143), whose device
// functions tet_block.cuh shares with kernel T22, _block_matvec_cols
// (:162) and, in the contact mode, pt_force_cols (:194, pt_force.cuh).
//
// The tets of the soup are node-disjoint, so the PD system is exactly
// block-diagonal in 4x4 blocks and each tet's iterations depend on nothing
// but its own four nodes.  A thread therefore factors its block once, keeps
// x, the stale iterate and the last force in registers across all
// iterations, and writes x, the static projection and its residual share
// once.  Every iteration's tet force is computed here, the first one too
// (kernel T1's device function, tet_force.cuh, on the predicted
// positions): the main path launches no T1 beside it.
//
// Bound: compute, about 1.6k flops per tet and iteration on 48 bytes of x;
// device memory is touched only at entry and exit (~200 bytes per tet).
// Blocks of padding (no live tet) have zero off-diagonals and zero tet
// force: the same code then reduces to the plain diagonal solve, and the
// mask re-select keeps padded nodes exactly at their park positions.
//
// Point-triangle contacts (pt_count non-null and > 0 on the device): a
// node with contact entries (row_start[n+1] > row_start[n], after kernel
// T7's setup has written the contacts' diagonal `ptd` there) adds ptd*x
// and then its contact force to its force after the floor term
// (pies_tpu/solver/tetcols.py:341-349); elsewhere both are exact zeros and
// are not read.  The contact force of a node is its contacts' push-out at
// the current iterate, so it couples the tets of a contact with each other
// between iterations.  Two forms:
//
// * pies_tet_cols_substep with `contact` (T7's force at the iterate x):
//   one iteration of every tet, the plain twin's one-iteration call.
// * pies_tet_cols_contact, the main path's contact substep: all its
//   iterations in one cooperative launch (coop.cuh: every block
//   resident).  A tet whose four nodes have no entry (a "free" tet; on the
//   500k soup's contact state 120,986 of 125,000) reads no other tet's
//   iterate, so its arithmetic is the contact-free kernel's exactly: every
//   iteration in registers.  A contact's four nodes all have entries, so
//   the "contact" tets (those with a node that has entries) read only each
//   other's iterate.  The launch takes them first: its threads walk T7's
//   ascending list of incident nodes, where a listed node whose
//   predecessor lies in another tet leads its tet, iteration by iteration.
//   Each iteration computes T7's force (pt_force.cuh) from the iterate of
//   the iteration before and writes its own to the other of two buffers
//   (x_out and a scratch, the last iteration writing x_out), and a tet
//   starts an iteration only when the tets it shares a contact with have
//   published the iteration before (a flag a tet, release and acquire
//   order; a warp waits and computes as one): then no tet reads a buffer
//   that another writes at the same time, the semantics of one launch an
//   iteration, which the plain twin runs, without a grid barrier.  A
//   thread re-derives its tet's factor,
//   right-hand side and parameters from device memory in every iteration
//   (deterministic, so bit-equal) and walks several tets an iteration,
//   iteration by iteration, when the listed nodes outnumber its grid's
//   threads.  Then the free tets, in chunks of 32 taken from a counter a
//   member, so that the threads that had contact tets take fewer and the
//   contact tets' latency hides behind the free tets' throughput.  The
//   grid is the card's resident blocks, sized on the host, never from a
//   device count.  What bounds it: the free tets' operations (~1.6k flops
//   a tet and iteration) at the SMs' issue rate, and under them the
//   contact tets' chain, four dependent iterations each an SVD of one
//   warp's lanes, and the gathers of their contacts' corners.  The earlier
//   designs, on an H100 (PERF.md §6): one launch an iteration, each
//   over all 125,000 tets (4 x ~63 us); then the free tets' launch (~103
//   us) and the contact tets' own cooperative launch with a grid barrier
//   an iteration (~56 us after it, nothing hidden); this launch with each
//   lane waiting on its flags alone (~434 us, against ~115 with a warp
//   waiting as one).
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): blockIdx.y
// is the member b (after the contact launch's member0).  Its nodes start at
// b*4k (x, msn, diag, mask, wf, ptd, contact, the scratch and the
// outputs), its latch is failed[2b], its contact count pt_count[b], its
// incidence row row_start + b*(4k+1), entries + b*4cap and node_list +
// b*4cap, node_count[b], its
// contacts pt_idx [b] of [members, cap, 4] and pt_mask [b] of [members,
// cap], and its residual shares r2[b] of [members, K]; the tets'
// parameters, block6 and the pin force are shared.  A latched member
// writes its residual shares as 0 and nothing else.
#include <cuda_runtime.h>

#include "coop.cuh"
#include "pt_force.cuh"
#include "tet_block.cuh"
#include "tet_force.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBlocksPerSm = 16;  // (the resident blocks bound it first)

struct SubstepIn {
  const float* x;       // [N, 3]
  const float* msn;     // [N, 3]  M s_n / h^2
  const float* pin;     // [N, 3]  folded pin force, or null
  const float* diag;    // [N]
  const float* mask;    // [N]
  const float* wf;      // [N]     W_STATIC * floor_count * active
  const float* block6;  // [6, K]
  const int* failed;    // latch slot 0 (tick start), [2 members]
  const float* ptd;     // [N] contact diagonal, or null
  const float* contact;  // [N, 3] contact force (one-iteration form), or null
  const int* row_start;  // [N + 1] T7's incidence, or null
  const int* pt_count;   // live contacts (device scalar), or null
  const int* entries;    // [4 cap] T7's incidence entries (contact substep), or null
  const int* pt_idx;     // [cap, 4] contacts (contact substep), or null
  const float* pt_mask;  // [cap] (contact substep), or null
  const int* node_list;  // [4 cap] T7's incident nodes, ascending (contact substep)
  const int* node_count;  // their count (contact substep)
  int cap;
  float thickness;
};

struct SubstepOut {
  float* x;       // [N, 3]
  float* stat;    // [N, 3]  stale static projection
  float* r2;      // [K]     per-tet squared residual
};

// Whether tet t of `member` has a node with contact entries.
__device__ __forceinline__ bool contact_tet(const SubstepIn& in, size_t member, int t, int k) {
  if (in.pt_count == nullptr || in.pt_count[member] <= 0) return false;
  const int* rs = in.row_start + member * (4 * (size_t)k + 1) + 4 * (size_t)t;
  return rs[4] > rs[0];
}

// Iterations [it0, it0 + count) of tet t of `member`, from the member's
// iterate at `src` (node-major [N, 3]); writes the new iterate at `dst`
// and, with `last`, the static projection and the residual share.  With
// `fused` each iteration takes its contact force from pt_force.cuh at the
// iterate it starts from, else from `contact` (read once).
__device__ __forceinline__ void tet_iterations(const SubstepIn& in, const pies::TetBatchPtrs& b,
                                               const SubstepOut& o, size_t member, int t, int k,
                                               int c, int it0, int count, bool fused,
                                               const float* src, float* dst, bool last,
                                               float plane) {
  const size_t base = member * 4 * k;  // the member's first node
  const size_t n0 = base + (size_t)4 * t;
  const size_t l0 = (size_t)4 * t;  // the tet's first node in the member (and the topology)

  float x[4][3], rhs0[4][3], dg[4], mk[4], wf[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    dg[a] = in.diag[n0 + a];
    mk[a] = in.mask[n0 + a];
    wf[a] = in.wf[n0 + a];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const size_t i = (n0 + a) * 3 + d;
      x[a][d] = src[(l0 + a) * 3 + d];
      rhs0[a][d] = in.pin != nullptr ? in.msn[i] + in.pin[(l0 + a) * 3 + d] : in.msn[i];
    }
  }
  bool pt_on[4] = {false, false, false, false};
  float pt_d[4] = {0.0f, 0.0f, 0.0f, 0.0f}, pt_f[4][3] = {};
  const int* rs = nullptr;
  if (in.pt_count != nullptr && in.pt_count[member] > 0) {
    rs = in.row_start + member * (4 * (size_t)k + 1);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const size_t node = n0 + a;
      pt_on[a] = rs[l0 + a + 1] > rs[l0 + a];
      pt_d[a] = pt_on[a] ? in.ptd[node] : 0.0f;
      if (!fused && in.contact != nullptr) {
#pragma unroll
        for (int d = 0; d < 3; ++d) pt_f[a][d] = pt_on[a] ? in.contact[node * 3 + d] : 0.0f;
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
  for (int it = it0; it < it0 + count; ++it) {
    if (fused && rs != nullptr) {  // the member's contacts at this iteration's iterate
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (pt_on[a])
          pies::pt_node_force(src, in.pt_idx + member * in.cap * 4, in.pt_mask + member * in.cap,
                              in.entries + member * 4 * in.cap + rs[l0 + a],
                              rs[l0 + a + 1] - rs[l0 + a], in.cap, in.thickness, pt_f[a]);
    }
    float f12[12];
    if (!live) {
#pragma unroll
      for (int r = 0; r < 12; ++r) f12[r] = 0.0f;
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

#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d) dst[(l0 + a) * 3 + d] = x[a][d];
  if (!last) return;

  // Residual ||force - A x|| share of this block (_block_matvec_cols).
  float r2 = 0.0f;
  if (it0 + count > 0) {
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
    for (int d = 0; d < 3; ++d)
      o.stat[(n0 + a) * 3 + d] = d == 1 ? pies::nanmax(stale[a][1], plane) : stale[a][d];
}

// Every iteration of every tet, one thread a tet.
__global__ void __launch_bounds__(kThreads)
    tet_cols_substep_kernel(SubstepIn in, pies::TetBatchPtrs b, SubstepOut o,
                            int k, int c, int iterations, float plane) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= k) return;
  const size_t member = blockIdx.y;
  if (in.failed[2 * member] != 0) {
    o.r2[member * k + t] = 0.0f;  // a skipped tick reports residual 0, as the JAX tick
    return;
  }
  const size_t base = member * 4 * k;
  tet_iterations(in, b, o, member, t, k, c, 0, iterations, false, in.x + base * 3,
                 o.x + base * 3, true, plane);
}

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

constexpr int kPollLimit = 1 << 22;  // polls before a wait gives up (a fault, never a hang)
constexpr int kSyncWords = 4;  // a member's words before its flags: claimed, finished, epoch
constexpr int kEpochMax = 1 << 30;

// Whether every tet that shares a contact with tet t (the tets whose nodes
// its contact force reads and which read its nodes) has published `need`
// (finished the iteration before the one `need` names).
__device__ __forceinline__ bool contacts_ready(const SubstepIn& in, const int* flags,
                                               size_t member, int t, int k, int need) {
  const int* rs = in.row_start + member * (4 * (size_t)k + 1);
  const int* ent = in.entries + member * 4 * in.cap;
  const int* idx = in.pt_idx + member * in.cap * 4;
  bool ready = true;
  for (int a = 0; a < 4; ++a) {
    const int n = 4 * t + a;
    for (int e = rs[n]; e < rs[n + 1]; ++e) {
      const int i = ent[e] % in.cap;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int u = idx[(size_t)i * 4 + c] >> 2;
        ready = ready && (u == t || load_relaxed(flags + u) >= need);
      }
    }
  }
  return ready;
}

// The contact substep in one cooperative (all blocks resident) launch of
// G blocks a member: first the contact tets, iteration by iteration, a warp
// starting an iteration of its tets when the tets they share a contact
// with have published the iteration before (a flag a tet, `epoch` +
// iterations done: release stores, relaxed polls, then an acquire fence)
// instead of a grid barrier; a warp waits and computes as one, so its
// lanes share each instruction of the SVD.  Then the free tets, every
// iteration in registers, in chunks of 32 taken from a per-member counter
// (the warps that had contact tets take fewer).  `buf` is a scratch
// [members, N, 3]; `sync` [members, kSyncWords + K] a member's counters (0
// between calls), its epoch and a flag a tet (every flag below the epoch),
// all 0 at first.
__global__ void __launch_bounds__(kThreads)
    tet_cols_contact_kernel(SubstepIn in, pies::TetBatchPtrs b, SubstepOut o, float* buf,
                            int* sync, int k, int c, int iterations, float plane, int member0) {
  const size_t member = member0 + blockIdx.y;
  int* work = sync + member * (kSyncWords + (size_t)k);  // claimed, finished, epoch
  int* flag = work + kSyncWords;
  const int epoch = work[2];
  const size_t base = member * 4 * k;
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * blockDim.x + threadIdx.x, stride = gridDim.x * blockDim.x;
  const bool latched = in.failed[2 * member] != 0;
  if (!latched) {
    const bool on = in.pt_count[member] > 0;
    const int listed = on ? in.node_count[member] : 0;
    const int* list = in.node_list + member * 4 * in.cap;
    const float* src = in.x + base * 3;
    for (int it = 0; it < iterations; ++it) {
      float* dst = (((iterations - 1 - it) & 1) ? buf : o.x) + base * 3;
      for (int q0 = first - lane; q0 < listed; q0 += stride) {  // (a warp's lanes together)
        const int q = q0 + lane;
        const int t = q < listed ? list[q] >> 2 : -1;
        const bool lead = q < listed && (q == 0 || (list[q - 1] >> 2) != t);
        if (it > 0) {
          bool ready = !lead || contacts_ready(in, flag, member, t, k, epoch + it);
          for (int poll = 0; !__all_sync(0xffffffffu, ready) && poll < kPollLimit; ++poll) {
            __nanosleep(64);
            if (!ready) ready = contacts_ready(in, flag, member, t, k, epoch + it);
          }
          asm volatile("fence.acq_rel.gpu;" ::: "memory");
        }
        if (lead)
          tet_iterations(in, b, o, member, t, k, c, it, 1, true, src, dst,
                         it + 1 == iterations, plane);
        __syncwarp();
        if (lead) store_release(flag + t, epoch + it + 1);
      }
      src = dst;
    }
  }
  __syncwarp();
  for (;;) {
    int t0 = 0;
    if (lane == 0) t0 = atomicAdd(work, 32);
    t0 = __shfl_sync(0xffffffffu, t0, 0);
    if (t0 >= k) break;
    const int t = t0 + lane;
    if (t >= k) continue;
    if (latched) {
      o.r2[member * k + t] = 0.0f;  // a skipped tick reports residual 0, as the JAX tick
    } else if (!contact_tet(in, member, t, k)) {
      tet_iterations(in, b, o, member, t, k, c, 0, iterations, false, in.x + base * 3,
                     o.x + base * 3, true, plane);
    }
  }
  // The member's last warp to finish readies the words for the next call:
  // the counters back to 0, the epoch past every flag this call published
  // (past 2^30 the flags are zeroed and it starts again).
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    __threadfence();
    last = atomicAdd(work + 1, 1) == (int)(gridDim.x * blockDim.x / 32) - 1;
  }
  if (__shfl_sync(0xffffffffu, last, 0)) {
    __threadfence();
    int next = epoch + iterations + 1;
    if (next >= kEpochMax) {
      for (int t = lane; t < k; t += 32) flag[t] = 0;
      next = 0;
    }
    if (lane == 0) {
      work[0] = 0;
      work[1] = 0;
      work[2] = next;
    }
  }
}

int resident[pies::kMaxDevices];

}  // namespace

extern "C" int pies_tet_cols_substep(
    const float* x, const float* msn, const float* pin, const float* diag,
    const float* mask, const float* wf, const float* block6,
    const float* qinv, const float* g, const float* slo, const float* shi,
    const float* sw, const float* vlo, const float* vhi, const float* vw,
    float* x_out, float* static_out, float* r2, int k, int c, int iterations,
    float plane, const int* failed, const float* ptd, const float* contact,
    const int* row_start, const int* pt_count, int members, void* stream) {
  if (k > 0 && members > 0) {
    SubstepIn in{x,       msn,       pin,      diag,    mask,    wf,      block6,
                 failed,  ptd,       contact,  row_start, pt_count, nullptr, nullptr,
                 nullptr, nullptr,   nullptr,  0,       0.0f};
    pies::TetBatchPtrs b{qinv, g, slo, shi, sw, vlo, vhi, vw, c};
    SubstepOut o{x_out, static_out, r2};
    const dim3 blocks((k + kThreads - 1) / kThreads, members);
    tet_cols_substep_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        in, b, o, k, c < k ? c : k, iterations, plane);
  }
  return (int)cudaGetLastError();
}

// Blocks of the contact launch that one SM keeps resident (its occupancy).
extern "C" int pies_tet_cols_contact_occupancy() {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)tet_cols_contact_kernel,
                                                    kThreads, 0) != cudaSuccess)
    return -1;
  return per_sm;
}

// The main path's contact substep: one cooperative launch of G blocks a
// member, G from the card's resident blocks (all of them for one member),
// members past what one launch keeps resident in further launches.
extern "C" int pies_tet_cols_contact(
    const float* x, const float* msn, const float* pin, const float* diag,
    const float* mask, const float* wf, const float* block6,
    const float* qinv, const float* g, const float* slo, const float* shi,
    const float* sw, const float* vlo, const float* vhi, const float* vw,
    float* x_out, float* static_out, float* r2, float* buf, int* sync, int k, int c,
    int iterations, float plane, const int* failed, const float* ptd,
    const int* row_start, const int* pt_count, const int* entries, const int* pt_idx,
    const float* pt_mask, const int* node_list, const int* node_count, int cap,
    float thickness, int members, void* stream) {
  if (k <= 0 || cap <= 0 || iterations <= 0 || members <= 0) return (int)cudaErrorInvalidValue;
  SubstepIn in{x,         msn,        pin,     diag,      mask,     wf,      block6,
               failed,    ptd,        nullptr, row_start, pt_count, entries, pt_idx,
               pt_mask,   node_list,  node_count, cap,    thickness};
  pies::TetBatchPtrs b{qinv, g, slo, shi, sw, vlo, vhi, vw, c};
  SubstepOut o{x_out, static_out, r2};
  c = c < k ? c : k;
  const void* kernel = (const void*)tet_cols_contact_kernel;
  const int grid = pies::coop_blocks(kernel, kThreads, resident, members,
                                     (k + kThreads - 1) / kThreads, kMaxBlocksPerSm);
  const int chunk = grid > 0 ? pies::coop_members(kernel, kThreads, resident, grid) : 0;
  if (chunk <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  int member0 = 0;
  void* args[] = {&in, &b, &o, &buf, &sync, &k, &c, &iterations, &plane, &member0};
  for (; member0 < members; member0 += chunk) {
    const int rest = members - member0;
    const cudaError_t err = cudaLaunchCooperativeKernel(
        kernel, dim3(grid, rest < chunk ? rest : chunk), dim3(kThreads), args, 0,
        (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
