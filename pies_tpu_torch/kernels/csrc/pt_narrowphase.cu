// Kernel T6: the point-triangle narrowphase on the packed-body layout.
//
// Replaces (JAX): pies_tpu/collision/broadphase.py:385-644
// (_detect_point_tri_bodies_packed's phase1, phase2 and decode), with
// narrowphase.py:39-207 (point_triangle_ccd_cols, point_triangle_phase1_face,
// _barycentric_inside_c), ops/cubic.py (earliest_root_in_unit_interval and
// the closed-form cubic), _compact_pairs_prox_first (:1293) and
// _compact_by_sort (:1271).
//
// What it computes (the plain twin's, unchanged): a (body, slot) lane is
// live when its cached pair is valid, not the body itself, and the body has
// a live face.  Each live lane tests the e faces of the candidate body
// against the m corners of its own: a proximity bit (a decided contact) or
// a crossing bit (the point crossed the face's plane) per (corner c, face
// f) combo, bit c*e + f.  Lanes with a bit are compacted, proximity lanes
// first and then crossing-only lanes, each by lane id, into
// min(2*cap, lanes) slots (the latch when the proximity lanes alone
// overflow them); on a compacted lane a crossing combo is a hit when the
// coplanarity cubic's earliest root puts the point inside the face.  Hit
// combos in (slot, combo) order are the contacts, the first cap of them.
//
// Bound: bytes.  Almost no lane is live (4,999 of 2,000,000 on the 500k
// soup with self-contact), so what the call must move is the valid word of
// every lane (8 MB) and the live lanes' pairs, corners and contacts.  The
// earlier design launched six kernels over the static sizes (one thread
// per lane for all 2M lanes, 16 MB of lane bit words written and read
// back, two scans of the block counts by one block each, phase 2 and the
// decode over 2*cap static slots), so its time was launch gaps and passes
// over empty lanes.
//
// This design is one cooperative launch (coop.cuh): G blocks per member,
// all resident, each owning a contiguous range of lanes, with two grid
// barriers (members past what one launch keeps resident, at one block
// each, go to further launches over the next chunks of members):
//  (a) each block sweeps its lanes 4,096 at a time, each thread 16 lanes
//      strided by the block width: coalesced valid loads, all 16 in flight
//      at once, the pair and the faces read only for a valid lane.  A warp
//      ballot per stride and a scan of the 128 (stride, warp) counts list
//      the live lanes in lane order in shared memory.  Each live lane gets
//      one thread per combo (a group of the smallest power of two >= m*e
//      threads, so two tet lanes per warp): the thread loads its own
//      corner and its face's three corners (no node arrays for any body
//      shape; ptxas's 32-byte frame is the cubic's three roots), runs
//      phase 1 and, on a crossing, phase 2 at once; the lane's proximity,
//      crossing and hit masks are warp ballots.  A block scan of the
//      lanes' classes and hit counts gives each lane its rank and hit
//      offset within the block among lanes of its class; the block's lanes
//      with a bit go to its own range of the item scratch, its four totals
//      (proximity lanes, crossing-only lanes and their hit counts) to the
//      block table;
//  (b) after the barrier, every block reads its member's block table: its
//      prefix and the member's totals give each of its lanes its slot and
//      its first contact row (a crossing-only lane's comes after all the
//      proximity lanes' hits), so its hits decode straight into the first
//      cap rows; the lane in the last slot, when the slots are all taken,
//      writes the hit count of the kept slots;
//  (c) after the second barrier, the count is known: the rows past it are
//      zeroed, the mask and the device count written.
// Phase 2 runs on every live crossing lane; a lane that finds no slot (the
// buffer full) is dropped after it, as the twin drops it before: the
// contacts are the same.  All counts are integers, so the order is exact.
// No memset, no host copy, no host sync.
//
// Every float operation follows the plain twin (collision/narrowphase.py,
// ops/cubic.py) in order, through ccd.cuh's face_frame, phase1_point and
// point_triangle_ccd (shared with T15); with -fmad=false and IEEE division
// the two agree bit for bit on the card, powf/acosf/cosf included (same
// libdevice).
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): the
// grid's member0 + blockIdx.y is the member b, which runs all of the above on its own
// rows: its nodes from b*n, its cached pairs, item scratch, block table and
// kept count, and its contact buffer [b] of [members, cap, 4] with
// pt_count[b] and overflow[b].  Its lanes' order, and so its contact
// prefix, is exactly a single-scene run's.  A latched member writes an
// empty contact buffer (as the plain twin returns one).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ccd.cuh"
#include "compact.cuh"
#include "coop.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;  // lanes per thread of one sweep
constexpr int kSweep = kThreads * kPer;
constexpr int kBlocksPerSm = 4;

struct Np {
  const float* x;
  const float* prev;
  const float* tri_mask;
  const int* pairs;
  const int* valid;
  const int* faces;  // [e, 3] local corners
  int4* items;       // per block: {lane, hit bits, rank in class (~rank: crossing), hit offset}
  long long* table;  // [members, G, 2]: packed class counts, packed hit counts
  long long* kept;   // [members]: hits of the kept slots when they are all taken
  int* pt_idx;
  float* pt_mask;
  int* pt_count;
  int* overflow;
  const int* failed;
  int k, m, e, off, nb, cap, slots, lanes, n, chunk, group;
  int member0;  // the member of blockIdx.y = 0 (a launch covers a chunk of them)
  float thr;
};

// The view of member member0 + blockIdx.y: every per-member array offset to
// its row.
__device__ __forceinline__ Np member_view(Np p) {
  const size_t b = p.member0 + blockIdx.y;
  p.x += b * p.n * 3;
  p.prev += b * p.n * 3;
  p.pairs += b * p.lanes;
  p.valid += b * p.lanes;
  p.items += b * (size_t)gridDim.x * p.chunk;
  p.table += b * gridDim.x * 2;
  p.kept += b;
  p.pt_idx += b * p.cap * 4;
  p.pt_mask += b * p.cap;
  p.pt_count += b;
  p.overflow += b;
  p.failed += 2 * b;
  return p;
}

__device__ __forceinline__ bool body_live(const Np& p, int b) {
  for (int j = 0; j < p.e; ++j)
    if (p.tri_mask[(size_t)b * p.e + j] > 0.0f) return true;
  return false;
}

// Whether lane l, whose cached pair is valid, is live.
__device__ __forceinline__ bool valid_lane_live(const Np& p, int l) {
  const int b = l / p.nb;
  return p.pairs[l] != b && body_live(p, b);
}

// Block sum of v (every thread gets it).
__device__ __forceinline__ long long block_sum(long long v) {
  long long total;
  pies::block_exclusive_scan(v, &total);
  return total;
}

__global__ void __launch_bounds__(kThreads) np_kernel(Np p0) {
  namespace cg = cooperative_groups;
  const Np p = member_view(p0);
  const bool dead = p.failed[0] != 0;
  const int t = threadIdx.x, lane32 = t & 31, warp = t >> 5;
  const int lo = blockIdx.x * p.chunk;
  const int hi = min(lo + p.chunk, p.lanes);
  int4* items = p.items + (size_t)blockIdx.x * p.chunk;

  __shared__ int s_list[kSweep];
  __shared__ unsigned s_hits[kSweep];
  __shared__ unsigned char s_cls[kSweep];  // 0 no bit, 1 proximity, 2 crossing only
  __shared__ int s_count[kPer * kWarps];
  __shared__ int s_live;

  // (a) this block's lanes: class counts and hit counts, packed low/high
  // (proximity / crossing only), over the lanes already swept.
  long long carry_c = 0, carry_h = 0;
  for (int base = lo; !dead && base < hi; base += kSweep) {
    // All 16 valid words in flight at once; pairs and faces only where valid.
    int valid[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int l = base + i * kThreads + t;
      valid[i] = l < hi ? p.valid[l] : 0;
    }
    unsigned bal[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      bal[i] = __ballot_sync(0xffffffffu,
                             valid[i] != 0 && valid_lane_live(p, base + i * kThreads + t));
    if (lane32 == 0)
#pragma unroll
      for (int i = 0; i < kPer; ++i) s_count[i * kWarps + warp] = __popc(bal[i]);
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the (stride, warp) counts, 4 a lane
      constexpr int kEach = kPer * kWarps / 32;
      int v[kEach], sum = 0;
#pragma unroll
      for (int r = 0; r < kEach; ++r) {
        v[r] = s_count[lane32 * kEach + r];
        sum += v[r];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane32 >= o) incl += y;
      }
      int at = incl - sum;
#pragma unroll
      for (int r = 0; r < kEach; ++r) {
        s_count[lane32 * kEach + r] = at;
        at += v[r];
      }
      if (lane32 == 31) s_live = incl;
    }
    __syncthreads();
    const unsigned below = (1u << lane32) - 1u;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if ((bal[i] >> lane32) & 1u)
        s_list[s_count[i * kWarps + warp] + __popc(bal[i] & below)] = base + i * kThreads + t;
    __syncthreads();
    const int n_live = s_live;

    // Phase 1 and phase 2: one thread per (corner, face) combo of a lane.
    const int combos = p.m * p.e, group = p.group, per_pass = kThreads / group;
    const int gi = t / group, gl = t - gi * group;
    const int shift = lane32 & ~(group - 1);
    const unsigned gmask = group == 32 ? 0xffffffffu : (1u << group) - 1u;
    for (int first = 0; first < n_live; first += per_pass) {
      const int i = first + gi;
      bool prox = false, crossed = false, hit = false;
      if (i < n_live && gl < combos) {
        const int l = s_list[i];
        const int b = l / p.nb, other = p.pairs[l];
        const int c = gl / p.e, f = gl - c * p.e;
        const int i0 = p.faces[3 * f], i1 = p.faces[3 * f + 1], i2 = p.faces[3 * f + 2];
        const int own = p.off + b * p.m + c, oth = p.off + other * p.m;
        const V3 own_p = load3(p.prev, own), own_n = load3(p.x, own);
        const V3 p0 = load3(p.prev, oth + i0), p1 = load3(p.prev, oth + i1),
                 p2 = load3(p.prev, oth + i2);
        const V3 n0 = load3(p.x, oth + i0), n1 = load3(p.x, oth + i1),
                 n2 = load3(p.x, oth + i2);
        const FaceFrame frame = face_frame(p0, p1, p2, n0, n1, n2);
        phase1_point(frame, own_p, own_n, p.thr, &prox, &crossed);
        hit = prox || (crossed && point_triangle_ccd(sub(own_p, p0), sub(p1, p0), sub(p2, p0),
                                                     sub(own_n, n0), sub(n1, n0), sub(n2, n0),
                                                     p.thr));
      }
      const unsigned bp = (__ballot_sync(0xffffffffu, prox) >> shift) & gmask;
      const unsigned bc = (__ballot_sync(0xffffffffu, crossed) >> shift) & gmask;
      const unsigned bh = (__ballot_sync(0xffffffffu, hit) >> shift) & gmask;
      if (gl == 0 && i < n_live) {
        s_hits[i] = bh;
        s_cls[i] = bp != 0 ? 1 : (bc != 0 ? 2 : 0);
      }
    }
    __syncthreads();

    // Ranks and hit offsets within the block, by class, in lane order.
    for (int q0 = 0; q0 < n_live; q0 += kThreads) {
      const int q = q0 + t;
      const int cls = q < n_live ? s_cls[q] : 0;
      const long long hits = cls != 0 ? __popc(s_hits[q]) : 0;
      const long long vc = cls == 1 ? 1LL : (cls == 2 ? (1LL << 32) : 0LL);
      const long long vh = cls == 1 ? hits : (cls == 2 ? hits << 32 : 0LL);
      long long tc, th;
      const long long at_c = carry_c + pies::block_exclusive_scan(vc, &tc);
      const long long at_h = carry_h + pies::block_exclusive_scan(vh, &th);
      if (cls != 0) {
        const int n_prox = (int)(at_c & 0xffffffffLL), n_cross = (int)(at_c >> 32);
        const int rank = cls == 1 ? n_prox : ~n_cross;
        const int offset = (int)(cls == 1 ? (at_h & 0xffffffffLL) : (at_h >> 32));
        items[n_prox + n_cross] = make_int4(s_list[q], (int)s_hits[q], rank, offset);
      }
      carry_c += tc;
      carry_h += th;
    }
    __syncthreads();  // s_list, s_hits and s_cls are the next sweep's
  }
  if (t == 0 && !dead) {
    p.table[2 * blockIdx.x] = carry_c;
    p.table[2 * blockIdx.x + 1] = carry_h;
  }
  cg::this_grid().sync();

  // (b) the member's totals and this block's prefix, then the decode.
  long long before_c = 0, before_h = 0, all_c = 0, all_h = 0;
  for (int j = t; !dead && j < (int)gridDim.x; j += kThreads) {
    const long long c = p.table[2 * j], h = p.table[2 * j + 1];
    all_c += c;
    all_h += h;
    if (j < (int)blockIdx.x) {
      before_c += c;
      before_h += h;
    }
  }
  before_c = block_sum(before_c);
  before_h = block_sum(before_h);
  all_c = block_sum(all_c);
  all_h = block_sum(all_h);
  const long long n_prox = all_c & 0xffffffffLL, n_cross = all_c >> 32;
  const long long h_prox = all_h & 0xffffffffLL, h_cross = all_h >> 32;
  if (blockIdx.x == 0 && t == 0 && n_prox > p.slots) atomicOr(p.overflow, 1);
  const int n_items = (int)((carry_c & 0xffffffffLL) + (carry_c >> 32));
  for (int q = t; q < n_items; q += kThreads) {
    const int4 it = items[q];
    const bool is_prox = it.z >= 0;
    const long long slot = is_prox ? (before_c & 0xffffffffLL) + it.z
                                   : n_prox + (before_c >> 32) + ~it.z;
    if (slot >= p.slots) continue;
    long long pos = is_prox ? (before_h & 0xffffffffLL) + it.w
                            : h_prox + (before_h >> 32) + it.w;
    const unsigned hit_bits = (unsigned)it.y;
    if (slot == p.slots - 1) p.kept[0] = pos + __popc(hit_bits);
    const int b = it.x / p.nb, other = p.pairs[it.x];
    for (int combo = 0; combo < p.m * p.e && pos < p.cap; ++combo) {
      if (!(hit_bits & (1u << combo))) continue;
      const int c = combo / p.e, f = combo - c * p.e;
      int* row = p.pt_idx + pos * 4;
      row[0] = p.off + b * p.m + c;
      for (int r = 0; r < 3; ++r) row[1 + r] = p.off + other * p.m + p.faces[3 * f + r];
      ++pos;
    }
  }
  cg::this_grid().sync();

  // (c) the count; the rows past it zeroed, the mask.
  const long long n_any = n_prox + n_cross;
  const long long kept = n_any >= p.slots && p.slots > 0 ? p.kept[0] : h_prox + h_cross;
  const int count = dead ? 0 : (int)(kept < p.cap ? kept : p.cap);
  for (int r = blockIdx.x * kThreads + t; r < p.cap; r += gridDim.x * kThreads) {
    p.pt_mask[r] = r < count ? 1.0f : 0.0f;
    if (r >= count) reinterpret_cast<int4*>(p.pt_idx)[r] = make_int4(0, 0, 0, 0);
  }
  if (blockIdx.x == 0 && t == 0) p.pt_count[0] = count;
}

int resident[pies::kMaxDevices];

}  // namespace

// Blocks per member of T6's grid for `lanes` lanes a member: at most one
// sweep of lanes each, kBlocksPerSm blocks an SM for all members (0: an
// error).
extern "C" int pies_pt_narrowphase_grid(int members, int lanes) {
  return pies::coop_blocks((const void*)np_kernel, kThreads, resident, members,
                           lanes > 0 ? (lanes + kSweep - 1) / kSweep : 1, kBlocksPerSm);
}

extern "C" int pies_pt_narrowphase(
    const float* x, const float* prev, const float* tri_mask, const int* pairs,
    const int* valid, const int* faces, void* items, long long* table, long long* kept,
    int* pt_idx, float* pt_mask, int* pt_count, int* overflow, const int* failed, int k,
    int m, int e, int off, int nb, int cap, float thr, int n, int members, int grid,
    void* stream) {
  if (k <= 0 || m <= 0 || e <= 0 || m * e > 32 || nb <= 0 || cap <= 0 || members <= 0)
    return (int)cudaErrorInvalidValue;
  const int lanes = k * nb;
  // Members a launch holds with all its blocks resident; more members take
  // more launches, each over the next chunk.
  const int chunk =
      grid > 0 ? pies::coop_members((const void*)np_kernel, kThreads, resident, grid) : 0;
  if (chunk <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  int group = 1;
  while (group < m * e) group <<= 1;
  const int pcap = 2 * cap;
  Np p{x, prev, tri_mask, pairs, valid, faces, (int4*)items, table, kept, pt_idx, pt_mask,
       pt_count, overflow, failed, k, m, e, off, nb, cap, pcap < lanes ? pcap : lanes, lanes,
       n, (lanes + grid - 1) / grid, group, 0, thr};
  void* args[] = {&p};
  for (; p.member0 < members; p.member0 += chunk) {
    const int rest = members - p.member0;
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)np_kernel, dim3(grid, rest < chunk ? rest : chunk), dim3(kThreads), args, 0,
        (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
