// Native data-path kernels of the host-side loader (mgwfbp_tpu_torch/data):
// fused crop + flip + normalize, and a plain uint8 -> float32 normalize. One
// pass over the uint8 batch produces normalized float32, instead of numpy's
// pad -> crop -> flip -> cast -> normalize chain (each a full-batch memory
// round trip). The same source as the JAX package's native/augment.cpp.
//
// Randomness stays in Python (offsets and flips are drawn with the same
// seeded generator as the numpy path), and both paths compute
// px * (1 / (255 * std)) - mean / std in float32, so they are bit-identical.
//
// Built at first use by mgwfbp_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 -o <build>/libmgwfbp_native.<hash>.so augment.cpp

#include <cstdint>

extern "C" {

// x: (B, H, W, C) uint8. out: (B, H, W, C) float32.
// oy/ox: (B,) crop offsets into the zero-padded image (0..2*pad).
// flip: (B,) 0/1 horizontal flip AFTER the crop.
// mean/std: (C,) normalization in 0..1 scale: out = (x/255 - mean) / std.
void fused_crop_flip_normalize(
    const uint8_t* x, float* out,
    int64_t b, int64_t h, int64_t w, int64_t c,
    int64_t pad,
    const int64_t* oy, const int64_t* ox, const uint8_t* flip,
    const float* mean, const float* stddev) {
  // precompute per-channel affine: out = px * (1/(255*std)) - mean/std
  float scale[16];
  float shift[16];
  for (int64_t k = 0; k < c && k < 16; ++k) {
    scale[k] = 1.0f / (255.0f * stddev[k]);
    shift[k] = mean[k] / stddev[k];
  }
  for (int64_t i = 0; i < b; ++i) {
    const uint8_t* img = x + i * h * w * c;
    float* dst = out + i * h * w * c;
    const int64_t top = oy[i] - pad;   // source row of output row 0
    const int64_t left = ox[i] - pad;  // source col of output col 0
    const bool fl = flip[i] != 0;
    for (int64_t y = 0; y < h; ++y) {
      const int64_t sy = y + top;
      float* row = dst + y * w * c;
      if (sy < 0 || sy >= h) {  // fully padded row -> normalized zeros
        for (int64_t xcol = 0; xcol < w; ++xcol)
          for (int64_t k = 0; k < c; ++k) row[xcol * c + k] = -shift[k];
        continue;
      }
      const uint8_t* srow = img + sy * w * c;
      for (int64_t xcol = 0; xcol < w; ++xcol) {
        // output col xcol reads crop col (flipped or not)
        const int64_t cc = fl ? (w - 1 - xcol) : xcol;
        const int64_t sx = cc + left;
        float* px = row + xcol * c;
        if (sx < 0 || sx >= w) {
          for (int64_t k = 0; k < c; ++k) px[k] = -shift[k];
        } else {
          const uint8_t* sp = srow + sx * c;
          for (int64_t k = 0; k < c; ++k)
            px[k] = (float)sp[k] * scale[k] - shift[k];
        }
      }
    }
  }
}

// Plain fused uint8 -> normalized float32 (eval path / no augmentation).
void normalize_u8(
    const uint8_t* x, float* out, int64_t n, int64_t c,
    const float* mean, const float* stddev) {
  float scale[16];
  float shift[16];
  for (int64_t k = 0; k < c && k < 16; ++k) {
    scale[k] = 1.0f / (255.0f * stddev[k]);
    shift[k] = mean[k] / stddev[k];
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = i % c;
    out[i] = (float)x[i] * scale[k] - shift[k];
  }
}

}  // extern "C"
