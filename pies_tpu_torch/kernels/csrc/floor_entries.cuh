// The entry-list floor (kernel T24, floor_entries.cu): the device function
// that kernel T9's stage 2 (tet_force_nodes.cu) runs for the floor term of
// the force, so a PD iteration gains no launch.
//
// Replaces (JAX): pies_tpu/solver/assembly.py:332-334, the entry-list
// floor force f.at[static_idx].add(W_STATIC * static_mask * p_static):
// node i adds w * s over its triangle-corner entries (the topology's
// corner incidence, ascending entry e = 3 * triangle + corner, the order of
// the JAX scatter), one after another, with s its floor projection and w =
// 1e4 * static_mask[e] (kernel T24 wrote the mask this substep).  k entries
// add w * s k times: against the dense floor's single (k w) * s the sum
// rounds differently, by about 1e-7 of the force.  An ensemble's member b
// reads its own static_mask row ([b] of [members, n_entries]; member()),
// the corner incidence is shared.
#pragma once

namespace pies {

constexpr float kWStaticEntry = 1.0e4f;  // StaticCollisionConstraint weight

struct FloorEntries {
  const int* start;          // [N + 1] corner incidence
  const int* entries;        // [3 T]
  const float* static_mask;  // [members, 3 T]
  int n_entries;             // 3 T

  // Member b's view.
  __device__ __forceinline__ FloorEntries member(int b) const {
    FloorEntries m = *this;
    if (m.static_mask != nullptr) m.static_mask += (size_t)b * n_entries;
    return m;
  }
};

__device__ __forceinline__ void floor_entry_force(const FloorEntries& fl, int i,
                                                  const float s[3], float f[3]) {
  const int e1 = fl.start[i + 1];
  for (int e = fl.start[i]; e < e1; ++e) {
    const float w = kWStaticEntry * fl.static_mask[fl.entries[e]];
#pragma unroll
    for (int d = 0; d < 3; ++d) f[d] = f[d] + w * s[d];
  }
}

}  // namespace pies
