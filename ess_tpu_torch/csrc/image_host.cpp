// Host C++ for the sensor-A image sets: PNG row unfiltering (alone or
// fused with the RGB to gray conversion of `cv2.imread(path, 0)`) and the
// arithmetic of `cv2.resize(..., INTER_LINEAR)`.
//
// Plain C ABI, loaded with ctypes by ess_tpu_torch/data/png.py, which
// builds it on first use:
//   g++ -O3 -shared -fPIC -o libimage_host_<digest>.so image_host.cpp
// The plain versions are the numpy / Python ones in png.py (`unfilter_ref`,
// `rgb_to_gray_ref`) and imgproc.py (`resize_linear_ref`); the tests hold
// each pair equal.

#include <cstdint>
#include <cstdlib>

namespace {

// The Paeth predictor with its choices made by bit masks: on noisy rows the
// branches of the textbook form mispredict, and with ternaries the
// compiler turns some of them back into branches.
inline int paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c),
            pc = std::abs(a + b - 2 * c);
  const int m1 = -static_cast<int>(pb <= pc);
  const int bc = (b & m1) | (c & ~m1);
  const int m2 = -static_cast<int>((pa <= pb) & (pa <= pc));
  return (a & m2) | (bc & ~m2);
}

// One row of `n` bytes (a multiple of BPP), BPP bytes a pixel: `up` is
// the decoded row above (zeros for the first row), the bytes left of the
// row are zeros. Sub, Average and Paeth carry the pixel to the left (and
// Paeth the one above it) in registers, one chain a channel: the chains of
// a pixel's channels run side by side, and no store is read back.
template <int BPP>
int unfilter_row(int kind, const uint8_t* __restrict__ f,
                 const uint8_t* __restrict__ up, uint8_t* __restrict__ out,
                 int64_t n) {
  int a[BPP] = {}, c[BPP] = {};
  switch (kind) {
    case 0:
      for (int64_t i = 0; i < n; ++i) out[i] = f[i];
      return 0;
    case 1:
      for (int64_t i = 0; i < n; i += BPP)
        for (int k = 0; k < BPP; ++k)
          out[i + k] = static_cast<uint8_t>(a[k] = (f[i + k] + a[k]) & 255);
      return 0;
    case 2:
      for (int64_t i = 0; i < n; ++i)
        out[i] = static_cast<uint8_t>(f[i] + up[i]);
      return 0;
    case 3:
      for (int64_t i = 0; i < n; i += BPP)
        for (int k = 0; k < BPP; ++k)
          out[i + k] = static_cast<uint8_t>(
              a[k] = (f[i + k] + ((a[k] + up[i + k]) >> 1)) & 255);
      return 0;
    case 4:
      for (int64_t i = 0; i < n; i += BPP)
        for (int k = 0; k < BPP; ++k) {
          const int b = up[i + k];
          out[i + k] = static_cast<uint8_t>(
              a[k] = (f[i + k] + paeth(a[k], b, c[k])) & 255);
          c[k] = b;
        }
      return 0;
    default:
      return 1;
  }
}

template <int BPP>
int64_t unfilter(const uint8_t* raw, int64_t height, int64_t row_bytes,
                 uint8_t* out, const uint8_t* zeros) {
  const uint8_t* up = zeros;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* r = raw + y * (row_bytes + 1);
    uint8_t* o = out + y * row_bytes;
    if (unfilter_row<BPP>(r[0], r + 1, up, o, row_bytes)) return y + 1;
    up = o;
  }
  return 0;
}

// libpng's png_do_rgb_to_gray for 8-bit samples as OpenCV's PNG reader sets
// it up (png_set_rgb_to_gray(png, 1, 0.299, 0.587): 15-bit coefficients
// 9797, 19234 and 32768 - 9797 - 19234 = 3737, truncated), which is what
// cv2.imread(path, 0) returns for an RGB PNG; gray pixels pass through.
inline uint8_t gray(uint32_t r, uint32_t g, uint32_t b) {
  return static_cast<uint8_t>((9797 * r + 19234 * g + 3737 * b) >> 15);
}

}  // namespace

extern "C" {

// Undo the PNG row filters of `height` rows of `row_bytes` bytes, each row
// in `raw` led by its filter byte, into `out` (height x row_bytes); `bpp`
// is 1 (8-bit gray) or 3 (8-bit RGB) and `zeros` holds `row_bytes` zero
// bytes (the row above the first). Returns 0, or 1 + the index of the first
// row whose filter byte is not 0..4, or -1 for another `bpp`.
int64_t png_unfilter(const uint8_t* raw, int64_t height, int64_t row_bytes,
                     int64_t bpp, uint8_t* out, const uint8_t* zeros) {
  if (bpp == 1) return unfilter<1>(raw, height, row_bytes, out, zeros);
  if (bpp == 3) return unfilter<3>(raw, height, row_bytes, out, zeros);
  return -1;
}

// png_unfilter at 3 bytes a pixel followed by the gray mix, a row at a time:
// `rows` holds 2 x row_bytes bytes for the current and the previous RGB
// row, `zeros` row_bytes zero bytes; `out` is height x (row_bytes / 3).
// Returns as png_unfilter.
int64_t png_unfilter_gray(const uint8_t* raw, int64_t height,
                          int64_t row_bytes, uint8_t* out, uint8_t* rows,
                          const uint8_t* zeros) {
  const int64_t width = row_bytes / 3;
  const uint8_t* up = zeros;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* r = raw + y * (row_bytes + 1);
    uint8_t* o = rows + (y & 1) * row_bytes;
    if (unfilter_row<3>(r[0], r + 1, up, o, row_bytes)) return y + 1;
    uint8_t* g = out + y * width;
    for (int64_t x = 0; x < width; ++x)
      g[x] = gray(o[3 * x], o[3 * x + 1], o[3 * x + 2]);
    up = o;
  }
  return 0;
}

// cv2.resize(src, (dw, dh), interpolation=INTER_LINEAR) on uint8 given its
// source indices and 11-bit weights along x (xs0, xs1, xw0, xw1: dw each)
// and y (ys0, ys1, yw0, yw1: dh each), as imgproc._resize_coefs computes
// them: the horizontal pass (s0 * w0 + s1 * w1) >> 4 on the two source rows
// of a destination row, then ((r0 * b0) >> 16) + ((r1 * b1) >> 16) + 2 >> 2,
// saturated. `src` rows are `stride` bytes apart.
void resize_linear_u8(const uint8_t* src, int64_t stride, uint8_t* dst,
                      int64_t dh, int64_t dw, const int32_t* xs0,
                      const int32_t* xs1, const int32_t* xw0,
                      const int32_t* xw1, const int32_t* ys0,
                      const int32_t* ys1, const int32_t* yw0,
                      const int32_t* yw1) {
  for (int64_t y = 0; y < dh; ++y) {
    const uint8_t* s0 = src + ys0[y] * stride;
    const uint8_t* s1 = src + ys1[y] * stride;
    const int32_t b0 = yw0[y], b1 = yw1[y];
    uint8_t* d = dst + y * dw;
    for (int64_t x = 0; x < dw; ++x) {
      const int32_t r0 = (s0[xs0[x]] * xw0[x] + s0[xs1[x]] * xw1[x]) >> 4;
      const int32_t r1 = (s1[xs0[x]] * xw0[x] + s1[xs1[x]] * xw1[x]) >> 4;
      int32_t v = (((r0 * b0) >> 16) + ((r1 * b1) >> 16) + 2) >> 2;
      d[x] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

}  // extern "C"

