// tmrnet_data: native host-side frame preprocessing for the input pipeline.
//
// The reference's input pipeline spends its CPU in per-frame Python/PIL work
// (pil_loader + torchvision transforms inside DataLoader workers, reference
// train_singlenet_phase_1fc.py:189-196) and an interpreted O(H*W) pixel loop
// in the offline cutmargin pass (video2frame_cutmargin.py:30-34). This library
// provides the equivalent operations as vectorized, multithreaded C++ working
// directly on numpy buffers via ctypes:
//
//   tmr_cutmargin_bbox      grayscale -> threshold -> exact binary median
//                           (19x19, via integral image) -> content bbox
//   tmr_resize_bilinear_u8  batched bilinear resize (uint8 RGB)
//   tmr_preprocess_batch    crop + optional hflip + u8->f32 normalize,
//                           fused in one pass per frame (batched, threaded)
//
// Built at first use by tmrnet_torch/data/native.py (g++ -O3 -shared). No
// external dependencies.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Simple parallel-for over [0, n) with static partitioning.
void parallel_for(int n, int num_threads, void (*body)(int, void*), void* ctx) {
  if (n <= 0) return;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int t = std::min(n, num_threads > 0 ? num_threads : std::max(1, hw));
  if (t <= 1) {
    for (int i = 0; i < n; ++i) body(i, ctx);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int k = 0; k < t; ++k) {
    threads.emplace_back([&]() {
      int i;
      while ((i = next.fetch_add(1)) < n) body(i, ctx);
    });
  }
  for (auto& th : threads) th.join();
}

template <typename F>
struct FnCtx {
  F* fn;
};

template <typename F>
void invoke_body(int i, void* ctx) {
  (*static_cast<FnCtx<F>*>(ctx)->fn)(i);
}

template <typename F>
void pfor(int n, int num_threads, F fn) {
  FnCtx<F> ctx{&fn};
  parallel_for(n, num_threads, &invoke_body<F>, &ctx);
}

}  // namespace

extern "C" {

// Content bounding box after binary-median cleanup.
// rgb: (h, w, 3) uint8. Writes bbox = {row0, row1, col0, col1} (end-exclusive).
// Returns 0 on success, 1 if the frame is entirely below threshold.
int tmr_cutmargin_bbox(const uint8_t* rgb, int h, int w, int threshold,
                       int median_ksize, int guard, int* bbox) {
  std::vector<uint8_t> bin(static_cast<size_t>(h) * w);
  // ITU-R 601-2 luma, matching cv2.cvtColor(RGB2GRAY) rounding closely.
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = rgb + static_cast<size_t>(y) * w * 3;
    uint8_t* brow = bin.data() + static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      const int r = row[3 * x], g = row[3 * x + 1], b = row[3 * x + 2];
      const int gray = (299 * r + 587 * g + 114 * b + 500) / 1000;
      brow[x] = gray > threshold ? 1 : 0;
    }
  }

  // Exact median filter of a binary image == majority vote in the window,
  // computed with an integral image (O(h*w), replaces cv2.medianBlur(19)).
  const int k = median_ksize | 1;  // force odd
  const int r = k / 2;
  std::vector<int32_t> integral(static_cast<size_t>(h + 1) * (w + 1), 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t* brow = bin.data() + static_cast<size_t>(y) * w;
    int32_t rowsum = 0;
    int32_t* irow = integral.data() + static_cast<size_t>(y + 1) * (w + 1);
    const int32_t* prev = integral.data() + static_cast<size_t>(y) * (w + 1);
    for (int x = 0; x < w; ++x) {
      rowsum += brow[x];
      irow[x + 1] = prev[x + 1] + rowsum;
    }
  }
  auto window_count = [&](int y, int x) -> int {
    const int y0 = std::max(0, y - r), y1 = std::min(h, y + r + 1);
    const int x0 = std::max(0, x - r), x1 = std::min(w, x + r + 1);
    const int32_t* top = integral.data() + static_cast<size_t>(y0) * (w + 1);
    const int32_t* bot = integral.data() + static_cast<size_t>(y1) * (w + 1);
    return bot[x1] - bot[x0] - top[x1] + top[x0];
  };
  // cv2.medianBlur pads by border replication; using the clipped window with
  // the full-window majority threshold matches interior pixels exactly and is
  // conservative at borders (which are black margin anyway).
  const int half = (k * k) / 2;

  int row0 = h, row1 = -1, col0 = w, col1 = -1;
  // Reference-exact scan (change_size(): `for j in range(10, y-10)`): BOTH
  // row and column extents come from pixels inside the column guard band,
  // and the crop excludes the max row/col (width = right - left).
  const int cg0 = std::min(guard, w);
  const int cg1 = w - guard;  // empty band when w <= 2*guard -> all-black
  for (int y = 0; y < h; ++y) {
    for (int x = cg0; x < cg1; ++x) {
      if (window_count(y, x) > half) {
        row0 = std::min(row0, y);
        row1 = std::max(row1, y);
        col0 = std::min(col0, x);
        col1 = std::max(col1, x);
      }
    }
  }
  if (row1 < 0) return 1;
  bbox[0] = row0;
  bbox[1] = row1 > row0 ? row1 : row0 + 1;
  bbox[2] = col0;
  bbox[3] = col1 > col0 ? col1 : col0 + 1;
  return 0;
}

// Batched bilinear resize, uint8 RGB. in: (n, ih, iw, 3) -> out: (n, oh, ow, 3).
void tmr_resize_bilinear_u8(const uint8_t* in, int n, int ih, int iw, int oh,
                            int ow, uint8_t* out, int num_threads) {
  const float sy = static_cast<float>(ih) / oh;
  const float sx = static_cast<float>(iw) / ow;
  pfor(n, num_threads, [&](int i) {
    const uint8_t* src = in + static_cast<size_t>(i) * ih * iw * 3;
    uint8_t* dst = out + static_cast<size_t>(i) * oh * ow * 3;
    for (int y = 0; y < oh; ++y) {
      const float fy = (y + 0.5f) * sy - 0.5f;
      const int y0 = std::max(0, std::min(ih - 1, static_cast<int>(fy)));
      const int y1 = std::min(ih - 1, y0 + 1);
      const float wy = std::max(0.0f, std::min(1.0f, fy - y0));
      for (int x = 0; x < ow; ++x) {
        const float fx = (x + 0.5f) * sx - 0.5f;
        const int x0 = std::max(0, std::min(iw - 1, static_cast<int>(fx)));
        const int x1 = std::min(iw - 1, x0 + 1);
        const float wx = std::max(0.0f, std::min(1.0f, fx - x0));
        for (int c = 0; c < 3; ++c) {
          const float v00 = src[(static_cast<size_t>(y0) * iw + x0) * 3 + c];
          const float v01 = src[(static_cast<size_t>(y0) * iw + x1) * 3 + c];
          const float v10 = src[(static_cast<size_t>(y1) * iw + x0) * 3 + c];
          const float v11 = src[(static_cast<size_t>(y1) * iw + x1) * 3 + c];
          const float top = v00 + wx * (v01 - v00);
          const float bot = v10 + wx * (v11 - v10);
          dst[(static_cast<size_t>(y) * ow + x) * 3 + c] =
              static_cast<uint8_t>(top + wy * (bot - top) + 0.5f);
        }
      }
    }
  });
}

// Fused crop + optional horizontal flip + u8->f32 normalize.
// in: (n, ih, iw, 3) uint8; out: (n, crop, crop, 3) float32.
// crop_y/crop_x/flip are per-frame arrays (length n) so one call handles a
// whole batch of clips with clip-deterministic augmentation parameters.
void tmr_preprocess_batch(const uint8_t* in, int n, int ih, int iw,
                          const int* crop_y, const int* crop_x, int crop,
                          const uint8_t* flip, const float* mean,
                          const float* stdev, float* out, int num_threads) {
  // Per-channel 256-entry lookup tables: the uint8->normalized-float map has
  // only 768 distinct values, so the inner loop is three table reads per
  // pixel — faster than per-pixel multiply-subtract and exact.
  float lut[3][256];
  for (int c = 0; c < 3; ++c) {
    const float inv_std = 1.0f / (255.0f * stdev[c]);
    const float mu = mean[c] / stdev[c];
    for (int v = 0; v < 256; ++v) {
      lut[c][v] = v * inv_std - mu;
    }
  }
  pfor(n, num_threads, [&](int i) {
    const uint8_t* src = in + static_cast<size_t>(i) * ih * iw * 3;
    float* dst = out + static_cast<size_t>(i) * crop * crop * 3;
    const int cy = crop_y[i], cx = crop_x[i];
    const bool fl = flip[i] != 0;
    for (int y = 0; y < crop; ++y) {
      const uint8_t* srow = src + (static_cast<size_t>(cy + y) * iw + cx) * 3;
      float* drow = dst + static_cast<size_t>(y) * crop * 3;
      if (!fl) {
        const int m = crop * 3;
        for (int k = 0; k + 2 < m; k += 3) {
          drow[k] = lut[0][srow[k]];
          drow[k + 1] = lut[1][srow[k + 1]];
          drow[k + 2] = lut[2][srow[k + 2]];
        }
      } else {
        for (int x = 0; x < crop; ++x) {
          const uint8_t* px = srow + 3 * (crop - 1 - x);
          drow[3 * x] = lut[0][px[0]];
          drow[3 * x + 1] = lut[1][px[1]];
          drow[3 * x + 2] = lut[2][px[2]];
        }
      }
    }
  });
}

}  // extern "C"
