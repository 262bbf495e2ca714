// Kernel T7: point-triangle coupling of the PD iterations.
//
// Replaces (JAX): pies_tpu/solver/tetcols.py:194-260 pt_force_cols and the
// contact terms of substep_cols (:306-349), with solver/assembly.py:357-368
// point_tri_collision_diag and the point-triangle part of system_diag
// (:577-599).
//
// What it computes (the plain twins', unchanged).  Once per substep
// (pies_pt_coupling_setup): the node incidence of the live contacts, entry
// t = a*cap + i being column a of contact i; row_start [N+1] the exclusive
// prefix of the node degrees, and for each node its entries in ascending t
// (the order in which the JAX package's CPU scatter of idx.T.reshape(-1)
// adds, so every per-node sum below is that sum, with no float atomic),
// nodes[] the node of each position; per incident node ptd = sum of
// w*mask*AtA[a][a] and the diagonal ((m/h^2 + stiffness) + ptd) + floor, the
// JAX order, and on the generic path the operator's dense diagonal
// floor + ptd (solver/pd.py:81-99 static_diag).  Per PD iteration
// (pies_pt_force): per incident node, each incident contact's point
// push-out from the current iterate (recomputed per incident node, a
// contact has 4) and the sum of (w*mask*AtA[a][0]) * delta; T2 then adds
// ptd*x + contact after the floor term.  Nodes without entries are not
// written: T2, T8, T9's stage 2 and T23 read neither array there.
//
// Bound: bytes.  On the 500k soup's contact state the live contacts are
// ~2.4k (9,792 entries over 8,910 nodes): the setup must write row_start
// over every node (2 MB) and read the live contacts; a force reads 4
// positions per incident entry and writes a row per incident node (~0.4 MB
// in all).  The earlier design was 10 launches a substep and a memset: the
// degrees zeroed over N by the wrapper, atomics and a fill over the static
// 4*cap entries, a three-launch scan over N + 1, the per-node stage over
// 4*cap threads, and each force over 4*cap threads, a leader test in each.
//
// This design: the setup is one cooperative launch (coop.cuh) of G blocks
// per member, all resident, with four grid barriers between its stages
// (members past what one launch keeps resident, at one block each, go to
// further launches over the next chunks of members):
// count the 4*count live entries' degrees (integer atomics into a scratch
// that is all 0 on entry and that the fill takes back to 0, so nothing
// zeroes it); each block sums its contiguous range of nodes, 8 consecutive
// nodes a thread (the degrees, and the incident nodes, packed in one
// 64-bit word); each block adds the sums of the blocks before it, scans its
// range and writes row_start and the compact, ascending list of incident
// nodes with their count; the atomic fill of the entries; per listed node
// the entries put in ascending order (insertion sort: a node has a
// handful) and the diagonal.  The force is one launch of a grid sized to
// the SMs that strides over the listed nodes only, read from the device
// count.
//
// Everything is skipped when the failure latch (slot 0) is set (no entry
// then: row_start all 0 where the contact count is not 0) or the device
// contact count is 0 (the incidence is not written; the node count is 0).
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y (after the setup's member0) is the member b, with its contacts [b] of [members,
// cap, 4] (node ids local to the member), its nodes from b*n, its latch
// failed[2b], and its own incidence: degree scratch, block sums, row_start
// [b] of [members, n + 1], entries, nodes and the node list [b] of
// [members, 4 cap], the node count [b].  So each member's per-node sums are
// a single-scene run's.  The stiffness diagonal is shared.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "compact.cuh"
#include "coop.cuh"
#include "pt_force.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNodes = 8;  // consecutive nodes a thread scans a pass
constexpr int kTile = kThreads * kNodes;
constexpr int kBlocksPerSm = 2;
constexpr float kWPointTri = 1.0e4f;  // CollisionConstraint.h:33
__constant__ float kAtaDiag[4] = {3.0f, 1.0f, 1.0f, 1.0f};

struct Pc {
  const int* pt_idx;
  const float* pt_mask;
  const int* pt_count;
  const float* mass;
  const float* stiffness;
  const float* wf;
  float* diag;
  int* deg;
  int* row_start;
  int* entries;
  int* nodes;
  int* node_list;
  int* node_count;
  long long* sums;  // [members, G]: per block, degrees | incident nodes << 32
  float* ptd;
  float* static_diag;  // may be null
  const int* failed;
  int n, cap, chunk;
  int member0;  // the member of blockIdx.y = 0 (a launch covers a chunk of them)
  float h2;
};

// The view of member member0 + blockIdx.y: every per-member array offset to
// its row.
__device__ __forceinline__ Pc member_view(Pc p) {
  const size_t b = p.member0 + blockIdx.y;
  p.pt_idx += b * p.cap * 4;
  p.pt_mask += b * p.cap;
  p.pt_count += b;
  p.mass += b * p.n;
  p.wf += b * p.n;
  p.diag += b * p.n;
  p.deg += b * p.n;
  p.row_start += b * (p.n + 1);
  p.entries += b * 4 * p.cap;
  p.nodes += b * 4 * p.cap;
  p.node_list += b * 4 * p.cap;
  p.node_count += b;
  p.sums += b * gridDim.x;
  p.ptd += b * p.n;
  if (p.static_diag != nullptr) p.static_diag += b * p.n;
  p.failed += 2 * b;
  return p;
}

// Block sum of v (every thread gets it).
__device__ __forceinline__ long long block_sum(long long v) {
  long long total;
  pies::block_exclusive_scan(v, &total);
  return total;
}

__global__ void __launch_bounds__(kThreads) pc_setup_kernel(Pc p0) {
  namespace cg = cooperative_groups;
  const Pc p = member_view(p0);
  const int count = p.pt_count[0];
  const bool on = count > 0;  // else the incidence stays unwritten
  const int live = on && p.failed[0] == 0 ? 4 * count : 0;
  const int t = threadIdx.x;
  const int first = blockIdx.x * kThreads + t, stride = gridDim.x * kThreads;
  cg::grid_group grid = cg::this_grid();

  // The degrees (the scratch is all 0 on entry: the fill below takes each
  // count back to 0).
  for (int q = first; q < live; q += stride) {
    const int a = q / count, i = q - a * count;
    atomicAdd(&p.deg[p.pt_idx[(size_t)i * 4 + a]], 1);
  }
  grid.sync();

  // This block's range of nodes, kNodes consecutive ones a thread a pass:
  // its degree sum and incident nodes, packed low / high.
  const int lo = blockIdx.x * p.chunk;
  const int hi = min(lo + p.chunk, p.n);
  long long mine = 0;
  for (int base = lo; on && base < hi; base += kTile) {
#pragma unroll
    for (int r = 0; r < kNodes; ++r) {
      const int i = base + kNodes * t + r;
      const int d = i < hi ? p.deg[i] : 0;
      mine += d + ((long long)(d > 0) << 32);
    }
  }
  mine = block_sum(mine);
  if (t == 0) p.sums[blockIdx.x] = mine;
  grid.sync();

  long long before = 0, all = 0;
  for (int j = t; on && j < (int)gridDim.x; j += kThreads) {
    const long long v = p.sums[j];
    all += v;
    if (j < (int)blockIdx.x) before += v;
  }
  before = block_sum(before);
  all = block_sum(all);
  long long carry = before;
  for (int base = lo; on && base < hi; base += kTile) {
    int d[kNodes];
    long long sum = 0;
#pragma unroll
    for (int r = 0; r < kNodes; ++r) {
      const int i = base + kNodes * t + r;
      d[r] = i < hi ? p.deg[i] : 0;
      sum += d[r] + ((long long)(d[r] > 0) << 32);
    }
    long long tile;
    long long at = carry + pies::block_exclusive_scan(sum, &tile);
#pragma unroll
    for (int r = 0; r < kNodes; ++r) {
      const int i = base + kNodes * t + r;
      if (i < hi) {
        p.row_start[i] = (int)(at & 0xffffffffLL);
        if (d[r] > 0) p.node_list[at >> 32] = i;
      }
      at += d[r] + ((long long)(d[r] > 0) << 32);
    }
    carry += tile;
  }
  if (blockIdx.x == gridDim.x - 1 && t == 0 && on)
    p.row_start[p.n] = (int)(all & 0xffffffffLL);
  const int n_nodes = (int)(all >> 32);
  if (blockIdx.x == 0 && t == 0) p.node_count[0] = n_nodes;
  grid.sync();

  for (int q = first; q < live; q += stride) {
    const int a = q / count, i = q - a * count;
    const int node = p.pt_idx[(size_t)i * 4 + a];
    const int pos = p.row_start[node] + atomicSub(&p.deg[node], 1) - 1;
    p.entries[pos] = a * p.cap + i;
    p.nodes[pos] = node;
  }
  grid.sync();

  for (int q = first; q < n_nodes; q += stride) {
    const int node = p.node_list[q];
    const int start = p.row_start[node], len = p.row_start[node + 1] - start;
    int* e = p.entries + start;
    for (int i = 1; i < len; ++i) {  // ascending entry order
      const int v = e[i];
      int j = i - 1;
      while (j >= 0 && e[j] > v) {
        e[j + 1] = e[j];
        --j;
      }
      e[j + 1] = v;
    }
    float acc = 0.0f;
    for (int j = 0; j < len; ++j) {
      const int a = e[j] / p.cap, i = e[j] - a * p.cap;
      acc = acc + (kWPointTri * p.pt_mask[i]) * kAtaDiag[a];
    }
    p.ptd[node] = acc;
    p.diag[node] = ((p.mass[node] / p.h2 + p.stiffness[node]) + acc) + p.wf[node];
    if (p.static_diag != nullptr) p.static_diag[node] = p.wf[node] + acc;
  }
}

struct Pf {
  const float* x;
  const int* pt_idx;
  const float* pt_mask;
  const int* pt_count;
  const int* row_start;
  const int* entries;
  const int* node_list;
  const int* node_count;
  float* contact;
  const int* failed;
  int n, cap;
  float thickness;
};

__device__ __forceinline__ Pf member_view(Pf p) {
  const size_t b = blockIdx.y;
  p.x += b * p.n * 3;
  p.pt_idx += b * p.cap * 4;
  p.pt_mask += b * p.cap;
  p.pt_count += b;
  p.row_start += b * (p.n + 1);
  p.entries += b * 4 * p.cap;
  p.node_list += b * 4 * p.cap;
  p.node_count += b;
  p.contact += b * p.n * 3;
  p.failed += 2 * b;
  return p;
}

__global__ void __launch_bounds__(kThreads) pc_force_kernel(Pf p0) {
  const Pf p = member_view(p0);
  if (p.failed[0] != 0 || p.pt_count[0] == 0) return;
  const int n_nodes = p.node_count[0];
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < n_nodes; q += gridDim.x * kThreads) {
    const int node = p.node_list[q];
    const int start = p.row_start[node], len = p.row_start[node + 1] - start;
    float acc[3];
    pies::pt_node_force(p.x, p.pt_idx, p.pt_mask, p.entries + start, len, p.cap, p.thickness,
                        acc);
#pragma unroll
    for (int d = 0; d < 3; ++d) p.contact[(size_t)node * 3 + d] = acc[d];
  }
}

int resident[pies::kMaxDevices];

}  // namespace

// Blocks per member of the setup's grid for `n` nodes a member: at most one
// tile of nodes each, kBlocksPerSm blocks an SM for all members (0: an
// error).
extern "C" int pies_pt_coupling_grid(int members, int n) {
  return pies::coop_blocks((const void*)pc_setup_kernel, kThreads, resident, members,
                           n > 0 ? (n + kTile - 1) / kTile : 1, kBlocksPerSm);
}

extern "C" int pies_pt_coupling_setup(
    const int* pt_idx, const float* pt_mask, const int* pt_count, const float* mass,
    const float* stiffness, const float* wf, float* diag, int* deg, int* row_start,
    int* entries, int* nodes, int* node_list, int* node_count, long long* sums, float* ptd,
    float* static_diag, const int* failed, int n, int cap, float h2, int members, int grid,
    void* stream) {
  if (n <= 0 || cap <= 0 || members <= 0) return (int)cudaErrorInvalidValue;
  // Members a launch holds with all its blocks resident; more members take
  // more launches, each over the next chunk.
  const int chunk =
      grid > 0 ? pies::coop_members((const void*)pc_setup_kernel, kThreads, resident, grid) : 0;
  if (chunk <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  Pc p{pt_idx, pt_mask, pt_count, mass, stiffness, wf, diag, deg, row_start, entries, nodes,
       node_list, node_count, sums, ptd, static_diag, failed, n, cap, (n + grid - 1) / grid, 0,
       h2};
  void* args[] = {&p};
  for (; p.member0 < members; p.member0 += chunk) {
    const int rest = members - p.member0;
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)pc_setup_kernel, dim3(grid, rest < chunk ? rest : chunk), dim3(kThreads),
        args, 0, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" int pies_pt_force(const float* x, const int* pt_idx, const float* pt_mask,
                             const int* pt_count, const int* row_start, const int* entries,
                             const int* node_list, const int* node_count, float* contact,
                             const int* failed, int n, int cap, float thickness, int members,
                             void* stream) {
  if (n <= 0 || cap <= 0 || members <= 0) return (int)cudaErrorInvalidValue;
  // A grid sized to the SMs (at most the static entries' tiles), striding
  // over the incident nodes the setup listed.
  const int sms = pies::sm_count();
  int grid = (2 * sms + members - 1) / members;
  grid = grid < pies::tiles(4 * cap) ? grid : pies::tiles(4 * cap);
  Pf p{x, pt_idx, pt_mask, pt_count, row_start, entries, node_list, node_count, contact,
       failed, n, cap, thickness};
  pc_force_kernel<<<dim3(grid > 0 ? grid : 1, members), kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
