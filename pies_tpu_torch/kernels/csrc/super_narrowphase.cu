// Kernel T15: the point-triangle narrowphase on the super-body layout.
//
// Replaces (JAX): pies_tpu/collision/broadphase.py:850-1085
// (_detect_point_tri_super's combo_masks, phase1, phase2 and decode), with
// narrowphase.py:39-207 (point_triangle_ccd_cols, point_triangle_phase1_face,
// _barycentric_inside_c), ops/cubic.py (earliest_root_in_unit_interval and
// the closed-form cubic), _compact_pairs_prox_first (:1293) and
// _compact_by_sort (:1271).
//
// A row is a packed body (its corner slots all distinct nodes) or a loose
// triangle (slots past 2 repeat corner 0); both rows of a lane read their
// corners through the corner table.  A (corner c, face f) combo is bit
// c * n_face + f.  Which combos a lane tests is static but for two class
// tests per lane (:865-883): the masks `live` (statically live combos),
// `row_packed` (combos whose corner slot exists only on a packed row),
// `cand_packed` and `cand_loose` (combos whose face slot applies only to a
// packed, or only to a loose, candidate).
//
// Stages, back to back on one stream, each a no-op when the failure latch
// (slot 0) is set:
//  (a) one thread per (row, slot) lane; a lane whose cached pair is live
//      tests its allowed combos, giving a proximity bitmask (decided
//      contacts) and a crossing bitmask (points that crossed a face's
//      plane); per-block class counts;
//  (b) scan of the counts; every lane with a bit scatters its id to the
//      pair buffer: proximity lanes first, then crossing-only lanes, each by
//      lane id (a stable compaction into 2*cap slots); the latch when the
//      proximity lanes alone exceed the buffer;
//  (c) phase 2 on compacted lanes with crossing bits only: the coplanarity
//      cubic and the containment test at its earliest root; per-block
//      counts of hit combos;
//  (d) scan; each hit combo, in (buffer slot, combo) order, becomes contact
//      [a, b, c, d], decoded through the corner table, in the first cap
//      slots; the rest of the buffer is zeroed and the device count written.
// No host sync: the kernels read the device counts and exit past them.
//
// The point-triangle tests, the cubic and the prox-first compaction are
// ccd.cuh's (the tests shared with T6).  Every float operation follows the plain
// twin (collision/narrowphase.py, ops/cubic.py) in order; with -fmad=false
// and IEEE division the two agree bit for bit on the card, powf/acosf/cosf
// included (same libdevice).
//
// Bound: bytes.  Lanes are rows x 64 slots (9.3 M on a 144,602-row scene)
// and few are live: stage (a) reads the cache (74 MB) and writes the two
// bitmask arrays (74 MB), stage (b) reads them again.  A live lane gathers
// two rows of corners (<= 2 x 96 bytes, from L2) and does ~60 flops per
// combo.
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick): every
// launch's blockIdx.y is the member b: its nodes from b*n, its
// cached pairs, lane bits, pair buffer, block counts and totals, and its
// contact buffer [b] of [members, cap, 4] with pt_count[b] and overflow[b].
// The two scans of block counts take one block per member, so each
// member's compaction order, and so its contact prefix, is a single-scene
// run's.  A latched member (or scene) writes an empty contact buffer, as
// the plain twin returns one.  The corner and face tables are shared.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ccd.cuh"
#include "compact.cuh"

namespace {

constexpr int kMaxNodes = 8;

struct Np {
  const float* x;
  const float* prev;
  const int* corners;  // [k, w] node of each corner slot
  const int* pairs;
  const int* valid;
  const int* faces;  // [n_face, 3] local corners
  unsigned* bits_prox;
  unsigned* bits_cross;
  int* pair_buf;
  unsigned* pbits;
  long long* part1;  // per-block class counts of stage (a)
  long long* part2;  // per-block hit counts of stage (c)
  long long* totals;  // [0] packed class counts, [1] hits, [2] live buffer slots
  int* pt_idx;
  float* pt_mask;
  int* pt_count;
  int* overflow;
  const int* failed;
  int k, kp, live_k, w, n_face, nb, cap, pcap, lanes, b1, b2, n;
  unsigned live, row_packed, cand_packed, cand_loose;
  float thr;
};

// The view of member blockIdx.y: every per-member array offset to its row.
__device__ __forceinline__ Np member_view(Np p) {
  const size_t b = blockIdx.y;
  p.x += b * p.n * 3;
  p.prev += b * p.n * 3;
  p.pairs += b * p.lanes;
  p.valid += b * p.lanes;
  p.bits_prox += b * 2 * p.lanes;
  p.bits_cross += b * 2 * p.lanes;
  p.pair_buf += b * p.pcap;
  p.pbits += b * p.pcap;
  p.part1 += b * p.b1;
  p.part2 += b * p.b2;
  p.totals += b * 4;
  p.pt_idx += b * p.cap * 4;
  p.pt_mask += b * p.cap;
  p.pt_count += b;
  p.overflow += b;
  p.failed += 2 * b;
  return p;
}

// The combos a lane of row b against candidate `other` may test.
__device__ __forceinline__ unsigned allowed_combos(const Np& p, int b, int other) {
  unsigned m = p.live;
  if (b >= p.kp) m &= ~p.row_packed;
  m &= other >= p.kp ? ~p.cand_packed : ~p.cand_loose;
  return m;
}

__device__ __forceinline__ V3 corner(const Np& p, const float* a, int row, int c) {
  return load3(a, p.corners[(size_t)row * p.w + c]);
}

__global__ void __launch_bounds__(pies::kBlock) sn_phase1_kernel(Np p0) {
  const Np p = member_view(p0);
  if (p.failed[0] != 0) return;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned prox_bits = 0, cross_bits = 0;
  if (l < p.lanes) {
    const int b = l / p.nb;
    const int other = p.pairs[l];
    if (p.valid[l] != 0 && other != b && b < p.live_k) {
      const unsigned allowed = allowed_combos(p, b, other);
      V3 own_p[kMaxNodes], own_n[kMaxNodes], oth_p[kMaxNodes], oth_n[kMaxNodes];
      for (int c = 0; c < p.w; ++c) {
        own_p[c] = corner(p, p.prev, b, c);
        own_n[c] = corner(p, p.x, b, c);
        oth_p[c] = corner(p, p.prev, other, c);
        oth_n[c] = corner(p, p.x, other, c);
      }
      for (int f = 0; f < p.n_face; ++f) {
        unsigned face_bits = 0;
        for (int c = 0; c < p.w; ++c) face_bits |= 1u << (c * p.n_face + f);
        if (!(allowed & face_bits)) continue;
        const int i0 = p.faces[3 * f], i1 = p.faces[3 * f + 1], i2 = p.faces[3 * f + 2];
        const FaceFrame frame =
            face_frame(oth_p[i0], oth_p[i1], oth_p[i2], oth_n[i0], oth_n[i1], oth_n[i2]);
        for (int c = 0; c < p.w; ++c) {
          const unsigned bit = 1u << (c * p.n_face + f);
          if (!(allowed & bit)) continue;
          bool prox, crossed;
          phase1_point(frame, own_p[c], own_n[c], p.thr, &prox, &crossed);
          if (prox) prox_bits |= bit;
          if (crossed) cross_bits |= bit;
        }
      }
    }
    p.bits_prox[l] = prox_bits;
    p.bits_cross[l] = cross_bits;
  }
  long long tile;
  pies::block_exclusive_scan(lane_class(prox_bits, cross_bits), &tile);
  if (threadIdx.x == 0) p.part1[blockIdx.x] = tile;
}

__global__ void __launch_bounds__(pies::kBlock) sn_compact_kernel(Np p0) {
  const Np p = member_view(p0);
  if (p.failed[0] != 0) return;
  compact_lane(blockIdx.x * blockDim.x + threadIdx.x, p.lanes, p.pcap, p.bits_prox,
               p.bits_cross, p.part1[blockIdx.x], p.totals, p.pair_buf, p.overflow);
}

__global__ void __launch_bounds__(pies::kBlock) sn_phase2_kernel(Np p0) {
  const Np p = member_view(p0);
  if (p.failed[0] != 0) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned hit_bits = 0;
  if (i < (int)p.totals[2]) {
    const int l = p.pair_buf[i];
    hit_bits = p.bits_prox[l];
    const unsigned cross_bits = p.bits_cross[l];
    if (cross_bits != 0) {
      const int b = l / p.nb, other = p.pairs[l];
      V3 oth_p[kMaxNodes], oth_n[kMaxNodes];
      for (int c = 0; c < p.w; ++c) {
        oth_p[c] = corner(p, p.prev, other, c);
        oth_n[c] = corner(p, p.x, other, c);
      }
      for (int c = 0; c < p.w; ++c) {
        const V3 own_p = corner(p, p.prev, b, c);
        const V3 own_n = corner(p, p.x, b, c);
        for (int f = 0; f < p.n_face; ++f) {
          const unsigned bit = 1u << (c * p.n_face + f);
          if (!(cross_bits & bit)) continue;
          const int i0 = p.faces[3 * f], i1 = p.faces[3 * f + 1], i2 = p.faces[3 * f + 2];
          const V3 b0 = oth_p[i0], b1 = oth_n[i0];
          if (point_triangle_ccd(sub(own_p, b0), sub(oth_p[i1], b0), sub(oth_p[i2], b0),
                                 sub(own_n, b1), sub(oth_n[i1], b1), sub(oth_n[i2], b1),
                                 p.thr))
            hit_bits |= bit;
        }
      }
    }
    p.pbits[i] = hit_bits;
  }
  long long tile;
  pies::block_exclusive_scan((long long)__popc(hit_bits), &tile);
  if (threadIdx.x == 0) p.part2[blockIdx.x] = tile;
}

__global__ void __launch_bounds__(pies::kBlock) sn_decode_kernel(Np p0) {
  const Np p = member_view(p0);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (p.failed[0] != 0) {  // no contact, as the twin reports for a latched state
    if (i < p.cap) {
      p.pt_mask[i] = 0.0f;
      for (int r = 0; r < 4; ++r) p.pt_idx[(size_t)i * 4 + r] = 0;
    }
    if (i == 0) p.pt_count[0] = 0;
    return;
  }
  const unsigned hit_bits = i < (int)p.totals[2] ? p.pbits[i] : 0u;
  long long tile;
  long long pos =
      p.part2[blockIdx.x] + pies::block_exclusive_scan((long long)__popc(hit_bits), &tile);
  const long long total = p.totals[1];
  const int count = (int)(total < p.cap ? total : p.cap);
  if (hit_bits != 0) {
    const int l = p.pair_buf[i];
    const int b = l / p.nb, other = p.pairs[l];
    for (int combo = 0; combo < p.w * p.n_face && pos < p.cap; ++combo) {
      if (!(hit_bits & (1u << combo))) continue;
      const int c = combo / p.n_face, f = combo - c * p.n_face;
      int* row = p.pt_idx + pos * 4;
      row[0] = p.corners[(size_t)b * p.w + c];
      for (int r = 0; r < 3; ++r)
        row[1 + r] = p.corners[(size_t)other * p.w + p.faces[3 * f + r]];
      ++pos;
    }
  }
  if (i < p.cap) {
    p.pt_mask[i] = i < count ? 1.0f : 0.0f;
    if (i >= count)
      for (int r = 0; r < 4; ++r) p.pt_idx[(size_t)i * 4 + r] = 0;
  }
  if (i == 0) p.pt_count[0] = count;
}

}  // namespace

extern "C" int pies_super_narrowphase(
    const float* x, const float* prev, const int* corners, const int* pairs,
    const int* valid, const int* faces, int* bits, int* pair_buf, int* pbits,
    long long* partial, long long* totals, int* pt_idx, float* pt_mask,
    int* pt_count, int* overflow, const int* failed, int k, int kp, int live_k,
    int w, int n_face, int nb, int cap, int live, int row_packed,
    int cand_packed, int cand_loose, float thr, int n, int members, void* stream) {
  if (k > 0 && w > 0 && w <= kMaxNodes && w * n_face <= 32 && cap > 0 && members > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const int lanes = k * nb, pcap = 2 * cap;
    const int b1 = pies::tiles(lanes), b2 = pies::tiles(pcap);
    // bits [members, 2, lanes]; partial [members, b1] then [members, b2].
    Np p{x, prev, corners, pairs, valid, faces,
         (unsigned*)bits, (unsigned*)bits + lanes, pair_buf, (unsigned*)pbits,
         partial, partial + (size_t)members * b1, totals, pt_idx, pt_mask, pt_count,
         overflow, failed, k, kp, live_k, w, n_face, nb, cap, pcap, lanes, b1, b2, n,
         (unsigned)live, (unsigned)row_packed, (unsigned)cand_packed,
         (unsigned)cand_loose, thr};
    sn_phase1_kernel<<<dim3(b1, members), pies::kBlock, 0, s>>>(p);
    pies::scan_segments_kernel<long long><<<members, 1024, 0, s>>>(p.part1, b1, totals, 4,
                                                                   nullptr, 0);
    sn_compact_kernel<<<dim3(b1, members), pies::kBlock, 0, s>>>(p);
    sn_phase2_kernel<<<dim3(b2, members), pies::kBlock, 0, s>>>(p);
    pies::scan_segments_kernel<long long><<<members, 1024, 0, s>>>(p.part2, b2, totals + 1, 4,
                                                                   nullptr, 0);
    sn_decode_kernel<<<dim3(b2, members), pies::kBlock, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
