// csof_native: the host-side data-plane core of csof_tpu_torch, the port's
// own copy of the JAX package's native/csof_native.cpp (the same source, so
// the same bits under the same compiler and flags).
//
// The batch-assembly inner loops of the loaders: a multithreaded patch
// gather with zero padding, per-image min-max and z-score normalization, and
// one-hot encoding. A plain C ABI bound by ctypes
// (csof_tpu_torch/native/bindings.py), built at first use with:
// g++ -O3 -march=native -std=c++17 -fPIC -pthread -Wall -shared csof_native.cpp

#include <algorithm>
#include <cmath>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) over a small thread pool.
template <typename F>
void pfor(int64_t n, int num_threads, F&& fn) {
  num_threads = std::max(1, num_threads);
  if (num_threads == 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    threads.emplace_back([&]() {
      while (true) {
        int64_t i = next.fetch_add(1);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Gather `n` patches of shape patch[0..2] centered at centers[i*3..] from a
// (c, z, y, x) float32 volume, zero-padded past borders.
// src dims: {c, z, y, x}. out: (n, c, pz, py, px) contiguous.
void extract_patches_3d_f32(const float* src, const int64_t* dims,
                            const int64_t* centers, int64_t n,
                            const int64_t* patch, float* out,
                            int num_threads) {
  const int64_t c = dims[0], Z = dims[1], Y = dims[2], X = dims[3];
  const int64_t pz = patch[0], py = patch[1], px = patch[2];
  const int64_t patch_vox = pz * py * px;
  const int64_t out_stride = c * patch_vox;

  pfor(n, num_threads, [&](int64_t i) {
    const int64_t cz = centers[i * 3 + 0] - pz / 2;
    const int64_t cy = centers[i * 3 + 1] - py / 2;
    const int64_t cx = centers[i * 3 + 2] - px / 2;
    float* dst = out + i * out_stride;
    std::memset(dst, 0, sizeof(float) * out_stride);
    const int64_t z0 = std::max<int64_t>(cz, 0), z1 = std::min(cz + pz, Z);
    const int64_t y0 = std::max<int64_t>(cy, 0), y1 = std::min(cy + py, Y);
    const int64_t x0 = std::max<int64_t>(cx, 0), x1 = std::min(cx + px, X);
    if (z0 >= z1 || y0 >= y1 || x0 >= x1) return;
    const int64_t span = x1 - x0;
    for (int64_t ch = 0; ch < c; ++ch) {
      const float* sp = src + ch * Z * Y * X;
      float* dp = dst + ch * patch_vox;
      for (int64_t z = z0; z < z1; ++z) {
        for (int64_t y = y0; y < y1; ++y) {
          std::memcpy(dp + (z - cz) * py * px + (y - cy) * px + (x0 - cx),
                      sp + z * Y * X + y * X + x0, sizeof(float) * span);
        }
      }
    }
  });
}

// 2D variant: src dims {c, y, x}; centers (n, 2); patch {py, px}.
void extract_patches_2d_f32(const float* src, const int64_t* dims,
                            const int64_t* centers, int64_t n,
                            const int64_t* patch, float* out,
                            int num_threads) {
  const int64_t c = dims[0], Y = dims[1], X = dims[2];
  const int64_t py = patch[0], px = patch[1];
  const int64_t patch_vox = py * px;
  const int64_t out_stride = c * patch_vox;

  pfor(n, num_threads, [&](int64_t i) {
    const int64_t cy = centers[i * 2 + 0] - py / 2;
    const int64_t cx = centers[i * 2 + 1] - px / 2;
    float* dst = out + i * out_stride;
    std::memset(dst, 0, sizeof(float) * out_stride);
    const int64_t y0 = std::max<int64_t>(cy, 0), y1 = std::min(cy + py, Y);
    const int64_t x0 = std::max<int64_t>(cx, 0), x1 = std::min(cx + px, X);
    if (y0 >= y1 || x0 >= x1) return;
    const int64_t span = x1 - x0;
    for (int64_t ch = 0; ch < c; ++ch) {
      const float* sp = src + ch * Y * X;
      float* dp = dst + ch * patch_vox;
      for (int64_t y = y0; y < y1; ++y) {
        std::memcpy(dp + (y - cy) * px + (x0 - cx), sp + y * X + x0,
                    sizeof(float) * span);
      }
    }
  });
}

// Per-image min-max normalization to [0, 1] in place: data is (n, m) where m
// is the per-image voxel count (ref video loaders min-max,
// nnunet/training/dataloading/dataset_loading.py:6517).
void minmax_normalize_f32(float* data, int64_t n, int64_t m, float eps,
                          int num_threads) {
  pfor(n, num_threads, [&](int64_t i) {
    float* p = data + i * m;
    float mn = p[0], mx = p[0];
    for (int64_t j = 1; j < m; ++j) {
      mn = std::min(mn, p[j]);
      mx = std::max(mx, p[j]);
    }
    const float inv = 1.0f / (mx - mn + eps);
    for (int64_t j = 0; j < m; ++j) p[j] = (p[j] - mn) * inv;
  });
}

// Per-image z-score in place.
void zscore_normalize_f32(float* data, int64_t n, int64_t m, float eps,
                          int num_threads) {
  pfor(n, num_threads, [&](int64_t i) {
    float* p = data + i * m;
    double sum = 0, sq = 0;
    for (int64_t j = 0; j < m; ++j) {
      sum += p[j];
      sq += (double)p[j] * p[j];
    }
    const float mean = (float)(sum / m);
    const float var = (float)(sq / m) - mean * mean;
    const float inv = 1.0f / (std::sqrt(std::max(var, 0.0f)) + eps);
    for (int64_t j = 0; j < m; ++j) p[j] = (p[j] - mean) * inv;
  });
}

// One-hot encode an int32 label map: (n,) labels -> (n, num_classes) floats.
void one_hot_f32(const int32_t* labels, int64_t n, int32_t num_classes,
                 float* out, int num_threads) {
  pfor(n, num_threads, [&](int64_t i) {
    float* row = out + i * num_classes;
    std::memset(row, 0, sizeof(float) * num_classes);
    const int32_t l = labels[i];
    if (l >= 0 && l < num_classes) row[l] = 1.0f;
  });
}

int csof_native_version() { return 1; }

}  // extern "C"
