// Native host-side letterbox resampler for the serving front end
// (the port's own copy of tpu_pose/native/letterbox.cpp).
//
// Mixed-resolution serving letterboxes every request on the caller's
// thread before it can batch (tpu_pose_torch/serving.py submit()). The
// numpy twin (ops/preprocess.resize_bilinear_np) builds (nh, k, w0, c)
// gather intermediates per frame; this does the same separable
// triangle-kernel resample with one (nh, w0, c) float row buffer, one
// pass per axis. Called through ctypes, which releases the GIL, so the
// client threads' preprocessing overlaps.
//
// Numerics: the resample plan (indices and weights) is computed in Python
// by ops/preprocess._resample_weights_np and passed in, so the sampling
// convention lives in one place; accumulation is float32 and the
// conversion back to uint8 rounds half to even (nearbyintf under the
// default rounding mode, as np.round). tests/test_torch_native.py holds
// it within 1 LSB of the numpy path.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Separable resample of an (h0, w0, c) uint8 image to (nh, nw, c),
// written into a (size, size, c) uint8 output at offset (off_y, off_x)
// with `fill` elsewhere.  iy/wy: (nh, ky) row plan; ix/wx: (nw, kx)
// column plan (indices pre-clipped to [0, h0) / [0, w0), weights
// pre-normalized — produced by _resample_weights_np).  Returns 0 on
// success, nonzero on bad arguments.
int letterbox_resample_u8(
    const uint8_t* img, int64_t h0, int64_t w0, int64_t c,
    const int64_t* iy, const float* wy, int64_t nh, int64_t ky,
    const int64_t* ix, const float* wx, int64_t nw, int64_t kx,
    uint8_t* out, int64_t size, int64_t off_y, int64_t off_x,
    uint8_t fill) {
  if (h0 <= 0 || w0 <= 0 || c <= 0 || nh <= 0 || nw <= 0 || size <= 0 ||
      ky <= 0 || kx <= 0 || off_y < 0 || off_x < 0 ||
      off_y + nh > size || off_x + nw > size) {
    return 1;
  }

  // Pad fill: only the border strips outside the (nh, nw) content box.
  const int64_t row_bytes = size * c;
  std::memset(out, fill, off_y * row_bytes);
  std::memset(out + (off_y + nh) * row_bytes, fill,
              (size - off_y - nh) * row_bytes);
  for (int64_t y = off_y; y < off_y + nh; ++y) {
    std::memset(out + y * row_bytes, fill, off_x * c);
    std::memset(out + y * row_bytes + (off_x + nw) * c, fill,
                (size - off_x - nw) * c);
  }

  // Pass 1 (rows): rows_f32[o, x, ch] = sum_k wy[o,k] * img[iy[o,k], x, ch].
  // Inner loop runs over the contiguous (w0 * c) row — autovectorizes.
  std::vector<float> rows((size_t)(nh * w0 * c), 0.0f);
  const int64_t src_row = w0 * c;
  for (int64_t o = 0; o < nh; ++o) {
    float* dst = rows.data() + o * src_row;
    for (int64_t k = 0; k < ky; ++k) {
      const float w = wy[o * ky + k];
      if (w == 0.0f) continue;
      const uint8_t* src = img + iy[o * ky + k] * src_row;
      for (int64_t i = 0; i < src_row; ++i) {
        dst[i] += w * (float)src[i];
      }
    }
  }

  // Pass 2 (cols) + round/clip to uint8 directly into the padded frame.
  for (int64_t y = 0; y < nh; ++y) {
    const float* row = rows.data() + y * src_row;
    uint8_t* dst = out + (off_y + y) * row_bytes + off_x * c;
    for (int64_t o = 0; o < nw; ++o) {
      for (int64_t ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int64_t k = 0; k < kx; ++k) {
          acc += wx[o * kx + k] * row[ix[o * kx + k] * c + ch];
        }
        float r = nearbyintf(acc);  // half-to-even == np.round
        dst[o * c + ch] = (uint8_t)(r < 0.0f ? 0.0f
                                             : (r > 255.0f ? 255.0f : r));
      }
    }
  }
  return 0;
}

}  // extern "C"
