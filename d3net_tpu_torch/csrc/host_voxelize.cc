// Host-side voxelization and gather-mode kernel maps (C++, plain C ABI).
//
// The gather-mode subset of the JAX package's cc/voxelize.cc: voxel
// dedup, the 3^3 submanifold table, the stride-2 down table and the
// transposed up table. The outputs are byte-identical to the numpy plain
// versions in d3net_tpu_torch/ops/voxelize.py: the same key packing, voxel
// ids ranked in sorted packed-key order, lexicographic kernel offsets.
// The column tables of the TPU layouts are not here (they are not ported).
//
// Host code, built with g++ by d3net_tpu_torch/ops/native.py and bound
// with ctypes; it runs in the input pipeline's worker threads.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr int64_t kKeyBound = 1 << 20;  // _KEY_BOUND in ops/voxelize.py
constexpr int64_t kKeyBias = 1 << 10;   // _KEY_BIAS

inline int64_t pack(int32_t x, int32_t y, int32_t z) {
  return ((int64_t)(x + kKeyBias) * kKeyBound + (int64_t)(y + kKeyBias)) *
             kKeyBound +
         (int64_t)(z + kKeyBias);
}

// floor division by 2 for possibly negative coords
inline int32_t half_floor(int32_t v) { return v >= 0 ? v / 2 : (v - 1) / 2; }

struct KeyIndex {
  // sorted unique keys; a voxel's id is its key's rank
  std::vector<int64_t> keys;

  void build(const int32_t* coords, int64_t n, std::vector<int64_t>* all) {
    all->resize(n);
    for (int64_t i = 0; i < n; ++i) {
      (*all)[i] = pack(coords[3 * i], coords[3 * i + 1], coords[3 * i + 2]);
    }
    keys = *all;
    std::sort(keys.begin(), keys.end());
    keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  }

  int32_t lookup(int64_t key, int32_t miss) const {
    auto it = std::lower_bound(keys.begin(), keys.end(), key);
    if (it == keys.end() || *it != key) return miss;
    return (int32_t)(it - keys.begin());
  }
};

}  // namespace

extern "C" {

// coords (N,3) int32 -> p2v (N), voxel_coords (M,3) (first occurrence's
// coords); returns M. voxel_coords must hold N rows.
int64_t d3_voxelize(const int32_t* coords, int64_t n, int32_t* p2v,
                    int32_t* voxel_coords) {
  KeyIndex idx;
  std::vector<int64_t> all;
  idx.build(coords, n, &all);
  const int64_t m = (int64_t)idx.keys.size();
  std::vector<char> seen(m, 0);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t v = idx.lookup(all[i], -1);
    p2v[i] = v;
    if (!seen[v]) {
      seen[v] = 1;
      voxel_coords[3 * v] = coords[3 * i];
      voxel_coords[3 * v + 1] = coords[3 * i + 1];
      voxel_coords[3 * v + 2] = coords[3 * i + 2];
    }
  }
  return m;
}

// Submanifold 3^3 table: coords (M,3) -> nbr (M,27), INVALID = M; tap
// (1+dx)*9 + (1+dy)*3 + (1+dz).
void d3_subm_table(const int32_t* coords, int64_t m, int32_t* nbr) {
  KeyIndex idx;
  std::vector<int64_t> all;
  idx.build(coords, m, &all);
  for (int64_t i = 0; i < m; ++i) {
    const int32_t x = coords[3 * i], y = coords[3 * i + 1],
                  z = coords[3 * i + 2];
    int k = 0;
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz, ++k)
          nbr[27 * i + k] =
              idx.lookup(pack(x + dx, y + dy, z + dz), (int32_t)m);
  }
}

// Stride-2 kernel-2 downsample: coarse coords (Mc,3) ranked in packed-key
// order (np.unique(coords // 2, axis=0)) and down (Mc,8), the fine voxel at
// 2p + {0,1}^3 or INVALID = M. coarse_coords and down must hold max(m, 1)
// rows. Returns Mc.
int64_t d3_downsample(const int32_t* coords, int64_t m, int32_t* coarse_coords,
                      int32_t* down) {
  std::vector<int64_t> ckeys(m);
  std::vector<int32_t> cc(3 * m);
  for (int64_t i = 0; i < m; ++i) {
    for (int a = 0; a < 3; ++a) cc[3 * i + a] = half_floor(coords[3 * i + a]);
    ckeys[i] = pack(cc[3 * i], cc[3 * i + 1], cc[3 * i + 2]);
  }
  std::vector<int64_t> sorted = ckeys;
  std::sort(sorted.begin(), sorted.end());
  sorted.erase(std::unique(sorted.begin(), sorted.end()), sorted.end());
  const int64_t mc = (int64_t)sorted.size();

  KeyIndex fidx;
  std::vector<int64_t> fall;
  fidx.build(coords, m, &fall);

  std::vector<char> seen(mc, 0);
  for (int64_t i = 0; i < m; ++i) {
    auto it = std::lower_bound(sorted.begin(), sorted.end(), ckeys[i]);
    const int32_t id = (int32_t)(it - sorted.begin());
    if (!seen[id]) {
      seen[id] = 1;
      coarse_coords[3 * id] = cc[3 * i];
      coarse_coords[3 * id + 1] = cc[3 * i + 1];
      coarse_coords[3 * id + 2] = cc[3 * i + 2];
    }
  }
  for (int64_t p = 0; p < mc; ++p) {
    const int32_t bx = coarse_coords[3 * p] * 2,
                  by = coarse_coords[3 * p + 1] * 2,
                  bz = coarse_coords[3 * p + 2] * 2;
    int k = 0;
    for (int dx = 0; dx <= 1; ++dx)
      for (int dy = 0; dy <= 1; ++dy)
        for (int dz = 0; dz <= 1; ++dz, ++k)
          down[8 * p + k] =
              fidx.lookup(pack(bx + dx, by + dy, bz + dz), (int32_t)m);
  }
  return mc;
}

// Transposed stride-2 table: up (Mf,8), the parent floor(f/2) at offset
// f mod 2 (id 4*ox + 2*oy + oz), INVALID = Mc elsewhere.
void d3_upsample(const int32_t* fine, int64_t mf, const int32_t* coarse,
                 int64_t mc, int32_t* up) {
  KeyIndex cidx;
  std::vector<int64_t> call;
  cidx.build(coarse, mc, &call);
  for (int64_t i = 0; i < mf * 8; ++i) up[i] = (int32_t)mc;
  for (int64_t f = 0; f < mf; ++f) {
    int32_t p[3], off[3];
    for (int a = 0; a < 3; ++a) {
      const int32_t v = fine[3 * f + a];
      p[a] = half_floor(v);
      off[a] = v - p[a] * 2;
    }
    const int k = off[0] * 4 + off[1] * 2 + off[2];
    up[8 * f + k] = cidx.lookup(pack(p[0], p[1], p[2]), (int32_t)mc);
  }
}

}  // extern "C"
