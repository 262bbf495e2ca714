// The lattice mesher of pies_tpu_torch (a copy of the JAX package's
// pies_tpu/native/tetmesh.cpp, FIDELITY #14, kept apart so that the port
// never builds or loads a library inside the JAX package).
//
// Tetrahedralization by body-centred lattice stuffing: voxelize the interior
// of a closed triangle mesh with ray-parity tests, emit six tets per interior
// cell, compact the corner lattice, and extract outward-wound boundary faces.
// This is the native route of `pies_tpu_torch.scene.tetmesh.tetrahedralize`
// (the role tetgen plays for the reference at PrimitiveUtilities.cpp:183-241),
// exposed through a C ABI, built by native/load.py with g++ and bound with
// ctypes.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 operator-(const Vec3& a, const Vec3& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double dot(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// Moller-Trumbore with a fixed, slightly-jittered ray direction to dodge
// edge-on degeneracies (same direction as the NumPy fallback so outputs
// match bit-for-bit on the inside/outside decision).
bool ray_hits_tri(const Vec3& origin, const Vec3& dir, const Vec3& a,
                  const Vec3& b, const Vec3& c) {
  const Vec3 e1 = b - a;
  const Vec3 e2 = c - a;
  const Vec3 pvec = cross(dir, e2);
  const double det = dot(e1, pvec);
  if (std::fabs(det) <= 1e-12) return false;
  const double inv_det = 1.0 / det;
  const Vec3 tvec = origin - a;
  const double u = dot(tvec, pvec) * inv_det;
  if (u < 0.0) return false;
  const Vec3 qvec = cross(tvec, e1);
  const double v = dot(qvec, dir) * inv_det;
  if (v < 0.0 || u + v > 1.0) return false;
  const double t = dot(e2, qvec) * inv_det;
  return t > 0.0;
}

struct FaceKey {
  int32_t a, b, c;  // sorted
  bool operator==(const FaceKey& o) const {
    return a == o.a && b == o.b && c == o.c;
  }
};

struct FaceKeyHash {
  size_t operator()(const FaceKey& k) const {
    // The engine's grid-hash primes do fine here too.
    return (size_t(uint32_t(k.a)) * 92837111u) ^
           (size_t(uint32_t(k.b)) * 689287499u) ^
           (size_t(uint32_t(k.c)) * 283923481u);
  }
};

}  // namespace

extern "C" {

void pies_free(void* p) { std::free(p); }

// Returns 0 on success. Output buffers are malloc'd; caller frees via
// pies_free.
int pies_tetrahedralize(const float* vertices, int num_vertices,
                        const int* tris, int num_tris, int resolution,
                        float** out_points, int* out_num_points,
                        int** out_tets, int* out_num_tets, int** out_surface,
                        int* out_num_surface) {
  if (num_vertices <= 0 || num_tris <= 0 || resolution <= 0) return 1;

  Vec3 lo{1e30, 1e30, 1e30}, hi{-1e30, -1e30, -1e30};
  for (int i = 0; i < num_vertices; ++i) {
    lo.x = std::min(lo.x, double(vertices[3 * i]));
    lo.y = std::min(lo.y, double(vertices[3 * i + 1]));
    lo.z = std::min(lo.z, double(vertices[3 * i + 2]));
    hi.x = std::max(hi.x, double(vertices[3 * i]));
    hi.y = std::max(hi.y, double(vertices[3 * i + 1]));
    hi.z = std::max(hi.z, double(vertices[3 * i + 2]));
  }
  const double extent =
      std::max(hi.x - lo.x, std::max(hi.y - lo.y, hi.z - lo.z));
  if (extent <= 0.0) return 2;
  const double h = extent / resolution;
  const int dims[3] = {
      std::max(1, int(std::ceil((hi.x - lo.x) / h)) + 1),
      std::max(1, int(std::ceil((hi.y - lo.y) / h)) + 1),
      std::max(1, int(std::ceil((hi.z - lo.z) / h)) + 1)};

  Vec3 dir{1e-4, 2e-4, 1.0};
  const double dn = std::sqrt(dot(dir, dir));
  dir = {dir.x / dn, dir.y / dn, dir.z / dn};

  // Bucket triangles by their (x, y) cell span for ray pruning — the rays
  // all travel ~+z, so only triangles overlapping a center's (x, y) cell
  // can be crossed.
  auto cell_of = [&](double v, double lo_v) {
    return int(std::floor((v - lo_v) / h));
  };
  std::unordered_map<int64_t, std::vector<int>> xy_buckets;
  for (int t = 0; t < num_tris; ++t) {
    double txlo = 1e30, txhi = -1e30, tylo = 1e30, tyhi = -1e30;
    for (int k = 0; k < 3; ++k) {
      const float* v = vertices + 3 * tris[3 * t + k];
      txlo = std::min(txlo, double(v[0]));
      txhi = std::max(txhi, double(v[0]));
      tylo = std::min(tylo, double(v[1]));
      tyhi = std::max(tyhi, double(v[1]));
    }
    const int ix0 = cell_of(txlo, lo.x), ix1 = cell_of(txhi, lo.x);
    const int iy0 = cell_of(tylo, lo.y), iy1 = cell_of(tyhi, lo.y);
    for (int ix = ix0; ix <= ix1; ++ix)
      for (int iy = iy0; iy <= iy1; ++iy)
        xy_buckets[(int64_t(ix) << 32) | uint32_t(iy)].push_back(t);
  }

  // Interior test per cell center.
  std::vector<uint8_t> inside(size_t(dims[0]) * dims[1] * dims[2], 0);
  auto cell_index = [&](int i, int j, int k) {
    return (size_t(i) * dims[1] + j) * dims[2] + k;
  };
  for (int i = 0; i < dims[0]; ++i) {
    for (int j = 0; j < dims[1]; ++j) {
      const auto it = xy_buckets.find((int64_t(i) << 32) | uint32_t(j));
      if (it == xy_buckets.end()) continue;
      for (int k = 0; k < dims[2]; ++k) {
        const Vec3 center{lo.x + (i + 0.5) * h, lo.y + (j + 0.5) * h,
                          lo.z + (k + 0.5) * h};
        int crossings = 0;
        for (int t : it->second) {
          const float* a = vertices + 3 * tris[3 * t];
          const float* b = vertices + 3 * tris[3 * t + 1];
          const float* c = vertices + 3 * tris[3 * t + 2];
          if (ray_hits_tri(center, dir, {a[0], a[1], a[2]},
                           {b[0], b[1], b[2]}, {c[0], c[1], c[2]}))
            ++crossings;
        }
        inside[cell_index(i, j, k)] = crossings & 1;
      }
    }
  }

  // Six tets per interior cell on the corner lattice.
  const int nx = dims[0] + 1, ny = dims[1] + 1, nz = dims[2] + 1;
  auto corner = [&](int i, int j, int k) -> int64_t {
    return (int64_t(i) * ny + j) * nz + k;
  };
  std::vector<std::array<int64_t, 4>> tets;
  for (int i = 0; i < dims[0]; ++i)
    for (int j = 0; j < dims[1]; ++j)
      for (int k = 0; k < dims[2]; ++k) {
        if (!inside[cell_index(i, j, k)]) continue;
        const int64_t c000 = corner(i, j, k), c001 = corner(i, j, k + 1);
        const int64_t c010 = corner(i, j + 1, k), c011 = corner(i, j + 1, k + 1);
        const int64_t c100 = corner(i + 1, j, k), c101 = corner(i + 1, j, k + 1);
        const int64_t c110 = corner(i + 1, j + 1, k),
                      c111 = corner(i + 1, j + 1, k + 1);
        tets.push_back({c000, c001, c011, c111});
        tets.push_back({c000, c010, c011, c111});
        tets.push_back({c000, c001, c101, c111});
        tets.push_back({c000, c100, c101, c111});
        tets.push_back({c000, c010, c110, c111});
        tets.push_back({c000, c100, c110, c111});
      }
  if (tets.empty()) return 3;

  // Compact corner ids.
  std::unordered_map<int64_t, int32_t> remap;
  std::vector<int64_t> used;
  for (const auto& t : tets)
    for (int64_t v : t)
      if (remap.emplace(v, 0).second) used.push_back(v);
  std::sort(used.begin(), used.end());
  for (size_t i = 0; i < used.size(); ++i) remap[used[i]] = int32_t(i);

  const int num_points = int(used.size());
  float* points = static_cast<float*>(std::malloc(sizeof(float) * 3 * num_points));
  for (int p = 0; p < num_points; ++p) {
    const int64_t id = used[p];
    const int i = int(id / (int64_t(ny) * nz));
    const int j = int((id / nz) % ny);
    const int k = int(id % nz);
    points[3 * p] = float(lo.x + i * h);
    points[3 * p + 1] = float(lo.y + j * h);
    points[3 * p + 2] = float(lo.z + k * h);
  }

  const int num_tets = int(tets.size());
  int* tet_out = static_cast<int*>(std::malloc(sizeof(int) * 4 * num_tets));
  for (int t = 0; t < num_tets; ++t)
    for (int k = 0; k < 4; ++k) tet_out[4 * t + k] = remap[tets[t][k]];

  // Boundary faces: those appearing exactly once across all tets.
  std::unordered_map<FaceKey, std::pair<std::array<int32_t, 3>, int32_t>,
                     FaceKeyHash>
      face_count;  // key -> (as-emitted face, opposite vertex); count via
                   // second pass marker (-1 once duplicated)
  static const int kFace[4][3] = {{0, 1, 2}, {0, 1, 3}, {0, 2, 3}, {1, 2, 3}};
  static const int kOpp[4] = {3, 2, 1, 0};
  for (int t = 0; t < num_tets; ++t) {
    for (int f = 0; f < 4; ++f) {
      std::array<int32_t, 3> face = {tet_out[4 * t + kFace[f][0]],
                                     tet_out[4 * t + kFace[f][1]],
                                     tet_out[4 * t + kFace[f][2]]};
      FaceKey key{face[0], face[1], face[2]};
      if (key.a > key.b) std::swap(key.a, key.b);
      if (key.b > key.c) std::swap(key.b, key.c);
      if (key.a > key.b) std::swap(key.a, key.b);
      auto [it, inserted] =
          face_count.emplace(key, std::make_pair(face, tet_out[4 * t + kOpp[f]]));
      if (!inserted) it->second.second = -1;  // interior face
    }
  }
  std::vector<std::array<int32_t, 3>> surface;
  for (const auto& [key, val] : face_count) {
    if (val.second < 0) continue;
    std::array<int32_t, 3> face = val.first;
    // Outward winding: flip when the normal points at the opposite vertex.
    const float* pa = points + 3 * face[0];
    const float* pb = points + 3 * face[1];
    const float* pc = points + 3 * face[2];
    const float* po = points + 3 * val.second;
    const Vec3 a{pa[0], pa[1], pa[2]}, b{pb[0], pb[1], pb[2]},
        c{pc[0], pc[1], pc[2]}, o{po[0], po[1], po[2]};
    if (dot(cross(b - a, c - a), o - a) > 0) std::swap(face[1], face[2]);
    surface.push_back(face);
  }
  // Deterministic output order.
  std::sort(surface.begin(), surface.end());

  const int num_surface = int(surface.size());
  int* surf_out = static_cast<int*>(std::malloc(sizeof(int) * 3 * num_surface));
  for (int s = 0; s < num_surface; ++s)
    for (int k = 0; k < 3; ++k) surf_out[3 * s + k] = surface[s][k];

  *out_points = points;
  *out_num_points = num_points;
  *out_tets = tet_out;
  *out_num_tets = num_tets;
  *out_surface = surf_out;
  *out_num_surface = num_surface;
  return 0;
}

}  // extern "C"
