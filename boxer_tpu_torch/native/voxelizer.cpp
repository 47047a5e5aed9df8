// Native point-cloud voxelizer.
//
// C++ replacement for the reference's numba JIT voxelizer
// (`e2edet/utils/det3d/general.py:259-432`), exposed via a C ABI for ctypes.
// Semantics match boxer_tpu/dataset/processor/voxelizer.py (the numpy
// fallback / test oracle): first-arrival voxel ordering, per-voxel point cap,
// voxel-count cap, reverse (z, y, x) coordinates.
//
// Build: see boxer_tpu/native/Makefile (produces libboxer_native.so).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

extern "C" {

// points:        (n_points, n_features) float32, xyz in the first 3 features
// voxel_size:    (3,) float32
// pc_range:      (6,) float32  [x0, y0, z0, x1, y1, z1]
// out_voxels:    (max_voxels, max_points, n_features) float32, zero-filled
// out_coords:    (max_voxels, 3) int32 (z, y, x when reverse)
// out_num_points:(max_voxels,) int32
// returns        number of voxels produced (<= max_voxels)
int points_to_voxel(const float* points, int64_t n_points, int n_features,
                    const float* voxel_size, const float* pc_range,
                    int max_points, int max_voxels, int reverse,
                    float* out_voxels, int32_t* out_coords,
                    int32_t* out_num_points) {
  int64_t grid[3];
  for (int i = 0; i < 3; ++i) {
    grid[i] = static_cast<int64_t>(
        (pc_range[3 + i] - pc_range[i]) / voxel_size[i] + 0.5f);
  }

  std::unordered_map<int64_t, int32_t> voxel_of;
  voxel_of.reserve(static_cast<size_t>(max_voxels) * 2);
  int32_t n_voxels = 0;

  for (int64_t p = 0; p < n_points; ++p) {
    const float* pt = points + p * n_features;
    int64_t c[3];
    bool ok = true;
    for (int i = 0; i < 3; ++i) {
      float f = (pt[i] - pc_range[i]) / voxel_size[i];
      int64_t ci = static_cast<int64_t>(f);
      if (f < 0 || ci >= grid[i]) { ok = false; break; }
      c[i] = ci;
    }
    if (!ok) continue;

    int64_t lin = (c[2] * grid[1] + c[1]) * grid[0] + c[0];
    auto it = voxel_of.find(lin);
    int32_t v;
    if (it == voxel_of.end()) {
      if (n_voxels >= max_voxels) continue;
      v = n_voxels++;
      voxel_of.emplace(lin, v);
      int32_t* oc = out_coords + static_cast<int64_t>(v) * 3;
      if (reverse) {
        oc[0] = static_cast<int32_t>(c[2]);
        oc[1] = static_cast<int32_t>(c[1]);
        oc[2] = static_cast<int32_t>(c[0]);
      } else {
        oc[0] = static_cast<int32_t>(c[0]);
        oc[1] = static_cast<int32_t>(c[1]);
        oc[2] = static_cast<int32_t>(c[2]);
      }
    } else {
      v = it->second;
    }

    int32_t& np_v = out_num_points[v];
    if (np_v < max_points) {
      float* dst = out_voxels +
          (static_cast<int64_t>(v) * max_points + np_v) * n_features;
      std::memcpy(dst, pt, sizeof(float) * n_features);
      np_v += 1;
    }
  }
  return n_voxels;
}

// BEV rotated-rectangle collision test (parity: `det3d/general.py:586`).
// boxes/qboxes: (n, 7+) [x, y, z, l, w, h, ..., rad]; out: (n, m) uint8.
void box_collision_test(const float* boxes, int64_t n, int box_dim,
                        const float* qboxes, int64_t m,
                        uint8_t* out) {
  auto corners = [](const float* b, int box_dim, float* cx, float* cy) {
    float l = b[3] * 0.5f, w = b[4] * 0.5f;
    float rad = b[box_dim - 1];
    float c = std::cos(rad), s = std::sin(rad);
    const float tx[4] = {l, l, -l, -l};
    const float ty[4] = {w, -w, -w, w};
    for (int i = 0; i < 4; ++i) {
      cx[i] = b[0] + tx[i] * c - ty[i] * s;
      cy[i] = b[1] + tx[i] * s + ty[i] * c;
    }
  };

  std::vector<float> ax(n * 4), ay(n * 4), bx(m * 4), by(m * 4);
  for (int64_t i = 0; i < n; ++i)
    corners(boxes + i * box_dim, box_dim, &ax[i * 4], &ay[i * 4]);
  for (int64_t j = 0; j < m; ++j)
    corners(qboxes + j * box_dim, box_dim, &bx[j * 4], &by[j * 4]);

  auto separated = [](const float* px, const float* py,
                      const float* qx, const float* qy) {
    // SAT over p's edges
    for (int e = 0; e < 4; ++e) {
      float ex = px[(e + 1) % 4] - px[e];
      float ey = py[(e + 1) % 4] - py[e];
      float nx = -ey, ny = ex;
      float pmin = 1e30f, pmax = -1e30f, qmin = 1e30f, qmax = -1e30f;
      for (int k = 0; k < 4; ++k) {
        float pp = nx * px[k] + ny * py[k];
        float qq = nx * qx[k] + ny * qy[k];
        pmin = pp < pmin ? pp : pmin; pmax = pp > pmax ? pp : pmax;
        qmin = qq < qmin ? qq : qmin; qmax = qq > qmax ? qq : qmax;
      }
      if (pmax < qmin || qmax < pmin) return true;
    }
    return false;
  };

  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < m; ++j) {
      bool sep = separated(&ax[i * 4], &ay[i * 4], &bx[j * 4], &by[j * 4]) ||
                 separated(&bx[j * 4], &by[j * 4], &ax[i * 4], &ay[i * 4]);
      out[i * m + j] = sep ? 0 : 1;
    }
  }
}

}  // extern "C"
