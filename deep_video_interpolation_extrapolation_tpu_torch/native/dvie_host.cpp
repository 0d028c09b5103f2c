// The port's fused PNG path: row unfiltering, flip, crop and normalization
// of 8-bit, non-interlaced gray and RGB images in one pass, on the host.
//
// The counterpart of the JAX package's native/dvie_host.cpp
// (dvie_decode_rgb_norm, dvie_decode_seg_onehot) without libpng: Python
// (native/host.py) walks the chunks, checks every chunk's CRC and inflates
// the image data with zlib only down to the crop's last row; these
// functions take the inflated rows (each a filter byte, then w * channels
// bytes) and do the rest.  Rows above the crop are unfiltered too (each row
// is predicted from the one above it) but only the crop's rows are written.
//
// The flip mirrors the whole image before the crop is taken, as the Python
// order img[:, ::-1][y0:y0 + ch, x0:x0 + cw] does.
//
// Return codes: 0 ok; 1 the data is shorter than the rows it must hold, or
// a row has an unknown filter type; 2 the channel count is not 1 or 3;
// 4 the crop does not lie inside the image.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Reconstructs one row in place: `cur` holds the filtered bytes of the row,
// `prev` the reconstructed row above it (zeros above row 0).
bool unfilter_row(int kind, uint8_t* cur, const uint8_t* prev, size_t n,
                  int bpp) {
  switch (kind) {
    case 0:
      return true;
    case 1:  // Sub
      for (size_t i = bpp; i < n; ++i) cur[i] = uint8_t(cur[i] + cur[i - bpp]);
      return true;
    case 2:  // Up
      for (size_t i = 0; i < n; ++i) cur[i] = uint8_t(cur[i] + prev[i]);
      return true;
    case 3:  // Average
      for (size_t i = 0; i < n; ++i) {
        const int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
        cur[i] = uint8_t(cur[i] + ((a + prev[i]) >> 1));
      }
      return true;
    case 4:  // Paeth
      for (size_t i = 0; i < n; ++i) {
        const bool left = i >= size_t(bpp);
        const int a = left ? cur[i - bpp] : 0;
        const int c = left ? prev[i - bpp] : 0;
        cur[i] = uint8_t(cur[i] + paeth(a, prev[i], c));
      }
      return true;
    default:
      return false;
  }
}

// Unfilters rows [0, y0 + ch) of `raw` and hands each row of the crop,
// reconstructed, to `emit(y_out, row)`.
template <class Emit>
int unfilter_crop(const uint8_t* raw, size_t raw_len, int32_t h, int32_t w,
                  int32_t channels, int32_t y0, int32_t x0, int32_t ch,
                  int32_t cw, Emit emit) {
  if (channels != 1 && channels != 3) return 2;
  if (y0 < 0 || x0 < 0 || ch <= 0 || cw <= 0 || w <= 0 || h <= 0 ||
      int64_t(y0) + ch > h || int64_t(x0) + cw > w)
    return 4;
  const size_t stride = size_t(w) * channels;
  const size_t rows = size_t(y0) + ch;
  if (raw_len < rows * (stride + 1)) return 1;
  std::vector<uint8_t> buf(2 * stride, 0);
  uint8_t* prev = buf.data();
  uint8_t* cur = buf.data() + stride;
  for (size_t y = 0; y < rows; ++y) {
    const uint8_t* src = raw + y * (stride + 1);
    std::memcpy(cur, src + 1, stride);
    if (!unfilter_row(src[0], cur, prev, stride, channels)) return 1;
    if (y >= size_t(y0)) emit(int32_t(y - y0), cur);
    uint8_t* t = prev;
    prev = cur;
    cur = t;
  }
  return 0;
}

}  // namespace

extern "C" {

// Crop -> float32 [ch, cw, 3] through `lut` (256 entries).  A gray image
// gives each pixel's value to all three channels, as Pillow's
// convert("RGB") does.
int dvie_rows_rgb_norm(const uint8_t* raw, size_t raw_len, int32_t h,
                       int32_t w, int32_t channels, int32_t y0, int32_t x0,
                       int32_t ch, int32_t cw, int32_t flip, const float* lut,
                       float* out) {
  return unfilter_crop(
      raw, raw_len, h, w, channels, y0, x0, ch, cw,
      [&](int32_t y, const uint8_t* row) {
        float* dst = out + size_t(y) * cw * 3;
        for (int32_t x = 0; x < cw; ++x) {
          const int32_t sx = flip ? w - 1 - (x0 + x) : x0 + x;
          const uint8_t* s = row + size_t(sx) * channels;
          dst[3 * x + 0] = lut[s[0]];
          dst[3 * x + 1] = lut[channels == 3 ? s[1] : s[0]];
          dst[3 * x + 2] = lut[channels == 3 ? s[2] : s[0]];
        }
      });
}

// Crop -> uint8 [ch, cw, channels].
int dvie_rows_u8(const uint8_t* raw, size_t raw_len, int32_t h, int32_t w,
                 int32_t channels, int32_t y0, int32_t x0, int32_t ch,
                 int32_t cw, int32_t flip, uint8_t* out) {
  return unfilter_crop(
      raw, raw_len, h, w, channels, y0, x0, ch, cw,
      [&](int32_t y, const uint8_t* row) {
        uint8_t* dst = out + size_t(y) * cw * channels;
        if (!flip) {
          std::memcpy(dst, row + size_t(x0) * channels, size_t(cw) * channels);
          return;
        }
        for (int32_t x = 0; x < cw; ++x) {
          const uint8_t* s = row + size_t(w - 1 - (x0 + x)) * channels;
          for (int32_t c = 0; c < channels; ++c) dst[x * channels + c] = s[c];
        }
      });
}

int dvie_host_abi_version() { return 1; }

}  // extern "C"
