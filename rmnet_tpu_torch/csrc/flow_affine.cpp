// Native flow re-computation after per-frame affine augmentation.
//
// Host-side op of the training augmentation (rmnet_tpu_torch/data/flow_affine.py;
// semantics of the reference
// extensions/flow_affine_transformation/flow_affine_transformation.cpp:39-85,
// including the x1-before-y1 update order). Exposed with a plain C ABI and
// loaded via ctypes — no pybind11 dependency.
//
// Build: rmnet_tpu_torch/data/flow_affine.py (g++ -O3 -march=native
// -ffp-contract=off -shared -fPIC, at first use, into build/native/).

#include <cmath>
#include <cstddef>

extern "C" {

// flow:  (h, w, 2) float32, contiguous — input
// m1,m2: (2, 3) float32 — inverse affines for frame t-1 / frame t
// out:   (h, w, 2) float32, contiguous — output
void update_optical_flow(const float *flow, const float *m1, const float *m2,
                         float *out, std::size_t height, std::size_t width) {
  for (std::size_t i = 0; i < height; ++i) {
    for (std::size_t j = 0; j < width; ++j) {
      const std::size_t idx = (i * width + j) * 2;
      float x2 = std::round(m2[0] * j + m2[1] * i + m2[2]);
      float y2 = std::round(m2[3] * j + m2[4] * i + m2[5]);

      float x1 = j + flow[idx];
      float y1 = i + flow[idx + 1];
      // Reference order: x1 is overwritten first, y1 uses the NEW x1.
      x1 = std::round(m1[0] * x1 + m1[1] * y1 + m1[2]);
      y1 = std::round(m1[3] * x1 + m1[4] * y1 + m1[5]);

      x1 = x1 < 0 ? 0 : (x1 >= width ? width - 1 : x1);
      y1 = y1 < 0 ? 0 : (y1 >= height ? height - 1 : y1);
      x2 = x2 < 0 ? 0 : (x2 >= width ? width - 1 : x2);
      y2 = y2 < 0 ? 0 : (y2 >= height ? height - 1 : y2);

      out[idx] = x1 - x2;
      out[idx + 1] = y1 - y2;
    }
  }
}

// Batched affine warp (inverse mapping, bilinear or nearest) used by the
// host-side data pipeline: out(y, x) = img(A . (x, y, 1)) with A = dst->src.
// img: (h, w, c) float32; matrix: (2, 3) dst->src; fill: (c,) border value.
void affine_warp(const float *img, const float *matrix, const float *fill,
                 float *out, std::size_t height, std::size_t width,
                 std::size_t channels, int nearest) {
  const float a = matrix[0], b = matrix[1], tx = matrix[2];
  const float c = matrix[3], d = matrix[4], ty = matrix[5];
  for (std::size_t y = 0; y < height; ++y) {
    for (std::size_t x = 0; x < width; ++x) {
      const float sx = a * x + b * y + tx;
      const float sy = c * x + d * y + ty;
      float *dst = out + (y * width + x) * channels;
      if (nearest) {
        const long ix = std::lround(sx);
        const long iy = std::lround(sy);
        if (ix < 0 || iy < 0 || ix >= (long)width || iy >= (long)height) {
          for (std::size_t ch = 0; ch < channels; ++ch) dst[ch] = fill[ch];
        } else {
          const float *src = img + (iy * width + ix) * channels;
          for (std::size_t ch = 0; ch < channels; ++ch) dst[ch] = src[ch];
        }
      } else {
        const float fx = std::floor(sx), fy = std::floor(sy);
        const long x0 = (long)fx, y0 = (long)fy;
        const float wx = sx - fx, wy = sy - fy;
        for (std::size_t ch = 0; ch < channels; ++ch) {
          float acc = 0.f;
          const long xs[2] = {x0, x0 + 1};
          const long ys[2] = {y0, y0 + 1};
          const float wxs[2] = {1.f - wx, wx};
          const float wys[2] = {1.f - wy, wy};
          for (int yy = 0; yy < 2; ++yy) {
            for (int xx = 0; xx < 2; ++xx) {
              const float wgt = wys[yy] * wxs[xx];
              float v;
              if (xs[xx] < 0 || ys[yy] < 0 || xs[xx] >= (long)width ||
                  ys[yy] >= (long)height) {
                v = fill[ch];
              } else {
                v = img[(ys[yy] * width + xs[xx]) * channels + ch];
              }
              acc += wgt * v;
            }
          }
          dst[ch] = acc;
        }
      }
    }
  }
}

}  // extern "C"
