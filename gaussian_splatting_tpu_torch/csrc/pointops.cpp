// Host-side point-cloud runtime ops in C++ — the native data-path component
// of the framework (the reference leans on sklearn/scipy KD-trees for these,
// single-threaded Python-driven; reference trainer.py:172-186 kNN scale init,
// multi_video_processor.py:219-252 dedupe).
//
// Spatial-hash uniform grid instead of KD-trees: build is O(n), queries scan
// the 27 neighboring cells — ideal for the near-uniform SfM clouds these
// pipelines produce, and embarrassingly parallel across query points
// (std::thread pool, no external deps).
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment):
//   knn_mean_distance(points, n, queries, m, k, out)   // mean dist to k-1 NN
//   radius_dedupe(points, n, radius, keep_out)         // greedy radius mask
//
// Build: gaussian_splatting_tpu_torch/ops/_build.py::load_host builds this
// copy with g++ -O3 -shared -fPIC -pthread for the machine's baseline ISA
// (no -march=native) into build/host/, on first use.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <functional>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Grid {
  float cell;
  float inv_cell;
  // Morton-ish packed cell key -> indices of points in the cell.
  std::unordered_map<int64_t, std::vector<int32_t>> cells;
  const float* pts;
  int64_t n;

  static int64_t key(int32_t x, int32_t y, int32_t z) {
    // Offset into positive range and pack 21 bits per axis.
    const int64_t B = 1 << 20;
    return (((int64_t)(x + B)) << 42) | (((int64_t)(y + B)) << 21) |
           ((int64_t)(z + B));
  }

  void build(const float* p, int64_t count, float cell_size) {
    pts = p;
    n = count;
    cell = cell_size;
    inv_cell = 1.0f / cell_size;
    cells.reserve((size_t)count);
    for (int64_t i = 0; i < count; ++i) {
      int32_t cx = (int32_t)std::floor(p[3 * i + 0] * inv_cell);
      int32_t cy = (int32_t)std::floor(p[3 * i + 1] * inv_cell);
      int32_t cz = (int32_t)std::floor(p[3 * i + 2] * inv_cell);
      cells[key(cx, cy, cz)].push_back((int32_t)i);
    }
  }

  template <typename Visit>
  void for_neighbors(float qx, float qy, float qz, int ring, Visit&& visit) const {
    int32_t cx = (int32_t)std::floor(qx * inv_cell);
    int32_t cy = (int32_t)std::floor(qy * inv_cell);
    int32_t cz = (int32_t)std::floor(qz * inv_cell);
    for (int32_t dz = -ring; dz <= ring; ++dz)
      for (int32_t dy = -ring; dy <= ring; ++dy)
        for (int32_t dx = -ring; dx <= ring; ++dx) {
          auto it = cells.find(key(cx + dx, cy + dy, cz + dz));
          if (it == cells.end()) continue;
          for (int32_t idx : it->second) visit(idx);
        }
  }
};

void parallel_for(int64_t count, const std::function<void(int64_t, int64_t)>& body) {
  unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  unsigned nthreads = std::min<uint64_t>(hw, 16);
  if (count < 4096 || nthreads <= 1) {
    body(0, count);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (count + nthreads - 1) / nthreads;
  for (unsigned t = 0; t < nthreads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(count, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([&, lo, hi] { body(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

float median_nn_scale(const float* pts, int64_t n) {
  // Cheap scale estimate: bbox diagonal / cbrt(n) — the expected NN spacing
  // for a uniform cloud; used to size grid cells.
  float lo[3] = {std::numeric_limits<float>::max(),
                 std::numeric_limits<float>::max(),
                 std::numeric_limits<float>::max()};
  float hi[3] = {-lo[0], -lo[1], -lo[2]};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      lo[d] = std::min(lo[d], pts[3 * i + d]);
      hi[d] = std::max(hi[d], pts[3 * i + d]);
    }
  float diag = 0;
  for (int d = 0; d < 3; ++d) diag += (hi[d] - lo[d]) * (hi[d] - lo[d]);
  diag = std::sqrt(diag);
  float s = diag / std::max(1.0f, std::cbrt((float)n));
  return s > 0 ? s : 1.0f;
}

}  // namespace

extern "C" {

// Mean distance to the (k-1) nearest neighbors (excluding an exact self
// match) for every query point. points (n,3) f32, queries (m,3) f32,
// out (m,) f32.
void knn_mean_distance(const float* points, int64_t n, const float* queries,
                       int64_t m, int32_t k, float* out) {
  if (n == 0 || m == 0) return;
  Grid grid;
  grid.build(points, n, median_nn_scale(points, n));
  int32_t want = std::max(1, k - 1);

  parallel_for(m, [&](int64_t lo, int64_t hi) {
    std::vector<float> best;
    for (int64_t q = lo; q < hi; ++q) {
      float qx = queries[3 * q], qy = queries[3 * q + 1], qz = queries[3 * q + 2];
      best.clear();
      int ring = 1;
      // Expand the search ring until enough candidates are guaranteed
      // inside the covered radius.
      while (true) {
        best.clear();
        grid.for_neighbors(qx, qy, qz, ring, [&](int32_t i) {
          float dx = points[3 * i] - qx;
          float dy = points[3 * i + 1] - qy;
          float dz = points[3 * i + 2] - qz;
          float d2 = dx * dx + dy * dy + dz * dz;
          if (d2 > 1e-24f)  // skip exact self
            best.push_back(d2);
        });
        float safe_r = ring * grid.cell;  // fully covered radius
        int32_t inside = 0;
        for (float d2 : best)
          if (d2 <= safe_r * safe_r) ++inside;
        if (inside >= want || ring >= 8) break;
        ++ring;
      }
      int32_t kk = std::min<int32_t>(want, (int32_t)best.size());
      float acc = 0.0f;
      if (kk > 0) {
        std::nth_element(best.begin(), best.begin() + (kk - 1), best.end());
        for (int32_t i = 0; i < kk; ++i) acc += std::sqrt(best[i]);
        acc /= kk;
      }
      out[q] = acc;
    }
  });
}

// Greedy radius dedupe: keep[i] = 0 if a kept point with smaller index lies
// within `radius`. points (n,3) f32, keep_out (n,) uint8.
void radius_dedupe(const float* points, int64_t n, float radius,
                   uint8_t* keep_out) {
  if (n == 0) return;
  Grid grid;
  grid.build(points, n, std::max(radius, 1e-9f));
  float r2 = radius * radius;
  // Sequential greedy pass (deterministic, matches KD-tree pair semantics of
  // the reference: later duplicates dropped, multi_video_processor.py:219).
  for (int64_t i = 0; i < n; ++i) keep_out[i] = 1;
  for (int64_t i = 0; i < n; ++i) {
    if (!keep_out[i]) continue;
    float qx = points[3 * i], qy = points[3 * i + 1], qz = points[3 * i + 2];
    grid.for_neighbors(qx, qy, qz, 1, [&](int32_t j) {
      if (j <= i || !keep_out[j]) return;
      float dx = points[3 * j] - qx;
      float dy = points[3 * j + 1] - qy;
      float dz = points[3 * j + 2] - qz;
      if (dx * dx + dy * dy + dz * dz < r2) keep_out[j] = 0;
    });
  }
}

}  // extern "C"
