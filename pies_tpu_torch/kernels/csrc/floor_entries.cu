// Kernel T24: the entry-list floor detection and its per-node sums, one
// thread per node, once per substep (after kernel T3).
//
// Replaces (JAX): pies_tpu/collision/batches.py:104 detect_floor_contacts
// (one entry per triangle corner, e = 3 * triangle + corner, live when the
// corner's y < floor_height + thickness and the triangle is live), the
// entry-list branches of pies_tpu/solver/assembly.py:338-353
// static_collision_diag (a segment sum of W_STATIC * static_mask, into the
// system diagonal of :577-600 and the operator's static diagonal), and the
// per-node inputs of pies_tpu/solver/pd.py: the snap at entries
// (:353-361), the floor entries of any_contact (:369-373) and
// _static_floor_friction's segment-sum counts (:589-617).  The force's
// per-entry sum runs in kernel T9's stage 2 (floor_entries.cuh).
//
// Node i walks its entries in the topology's corner incidence (ascending
// e, the JAX scatters' order) and writes each entry's static_mask, its
// weight sum wf = sum 1e4 * mask (the diagonal's term; diag += wf, on
// kernel T3's diagonal, which the entry-list path leaves without a floor
// term), its count of live entries (the friction's exponent) and its snap
// flag (1 where any entry is live).  The snap is the masked set
// x.at[static_idx].set(where(mask, p, x)) with every live entry of a node
// carrying the same p; an entry of a padding triangle (mask 0, node 0)
// leaves the node as it is.
//
// Bound: device memory, per node its incidence range, position and diag
// (24 bytes) and four words written, per entry its id, its triangle's mask
// and its written mask (12 bytes): ~3.3 MB at 110,592 nodes and 79,536
// entries, ~1 us at 3.35 TB/s.
//
// Ensembles (pies_tpu/parallel/ensemble.py:41, vmap of the tick):
// blockIdx.y is the member b: its positions from b*n*3, its diag, wf,
// active and counts from b*n, its static_mask from b*n_entries and its
// latch failed[2b].  The corner incidence and the triangle mask are the
// shared topology's.
#include <cuda_runtime.h>

#include "floor_entries.cuh"

namespace {

__global__ void __launch_bounds__(256)
    floor_entries_kernel(const float* __restrict__ x,
                         const int* __restrict__ start,
                         const int* __restrict__ entries,
                         const float* __restrict__ tri_mask, float threshold,
                         float* __restrict__ static_mask,
                         float* __restrict__ diag, float* __restrict__ wf,
                         float* __restrict__ active,
                         float* __restrict__ counts, int n, int n_entries,
                         const int* __restrict__ failed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t mb = blockIdx.y;
  if (failed[2 * mb] != 0) return;
  x += mb * n * 3;
  static_mask += mb * n_entries;
  diag += mb * n, wf += mb * n, active += mb * n, counts += mb * n;
  const bool below = x[(size_t)i * 3 + 1] < threshold;
  float w = 0.0f, c = 0.0f;
  const int e1 = start[i + 1];
  for (int e = start[i]; e < e1; ++e) {
    const int ent = entries[e];
    const float m = (below && tri_mask[ent / 3] > 0.0f) ? 1.0f : 0.0f;
    static_mask[ent] = m;
    w = w + pies::kWStaticEntry * m;
    c = c + m;
  }
  wf[i] = w;
  counts[i] = c;
  active[i] = c > 0.0f ? 1.0f : 0.0f;
  diag[i] = diag[i] + w;
}

}  // namespace

extern "C" int pies_floor_entries(const float* x, const int* start, const int* entries,
                                  const float* tri_mask, float threshold,
                                  float* static_mask, float* diag, float* wf,
                                  float* active, float* counts, int n, int n_entries,
                                  const int* failed, int members, void* stream) {
  if (n > 0 && members > 0) {
    const int threads = 256;
    floor_entries_kernel<<<dim3((n + threads - 1) / threads, members), threads, 0,
                           (cudaStream_t)stream>>>(x, start, entries, tri_mask,
                                                   threshold, static_mask, diag,
                                                   wf, active, counts, n, n_entries, failed);
  }
  return (int)cudaGetLastError();
}
