// The row filters of 8-bit PNG images (PNG specification, section 9): the
// decoder's inverse of all five filter types and the encoder's adaptive
// choice of one filter a row. Called from utils/image_ops.py via ctypes.
//
// An image of h rows of `stride` bytes (width times bytes a pixel, `bpp`)
// is stored filtered as h rows of 1 + stride bytes, the first byte of each
// naming its filter.

#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Predictor of byte i of a row from the reconstructed bytes: `cur` (this
// row), `up` (the row above; zeros above the first).
inline int predict(int kind, const uint8_t* cur, const uint8_t* up, int i,
                   int bpp) {
  const int left = i >= bpp ? cur[i - bpp] : 0;
  const int ul = i >= bpp ? up[i - bpp] : 0;
  switch (kind) {
    case 1: return left;
    case 2: return up[i];
    case 3: return (left + up[i]) >> 1;
    case 4: return paeth(left, up[i], ul);
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Undo the filters of `data` (h rows of 1 + stride bytes) into `out` (h
// rows of stride bytes). Returns 0, or the first filter type above 4.
int png_unfilter(const uint8_t* data, int h, int stride, int bpp,
                 uint8_t* out) {
  const std::vector<uint8_t> zeros(stride, 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = data + static_cast<size_t>(y) * (stride + 1);
    const int kind = row[0];
    if (kind > 4) return kind;
    uint8_t* cur = out + static_cast<size_t>(y) * stride;
    const uint8_t* up = y ? cur - stride : zeros.data();
    for (int i = 0; i < stride; ++i)
      cur[i] = static_cast<uint8_t>(row[1 + i] + predict(kind, cur, up, i, bpp));
  }
  return 0;
}

// Filter `img` (h rows of stride bytes) into `out` (h rows of 1 + stride
// bytes), each row with the filter whose output has the least sum of
// absolute values read as signed bytes (the specification's recommended
// heuristic, libpng's default).
void png_filter_adaptive(const uint8_t* img, int h, int stride, int bpp,
                         uint8_t* out) {
  const std::vector<uint8_t> zeros(stride, 0);
  std::vector<uint8_t> trial(stride);
  for (int y = 0; y < h; ++y) {
    const uint8_t* cur = img + static_cast<size_t>(y) * stride;
    const uint8_t* up = y ? cur - stride : zeros.data();
    uint8_t* dst = out + static_cast<size_t>(y) * (stride + 1);
    long best = -1;
    for (int kind = 0; kind <= 4; ++kind) {
      long cost = 0;
      for (int i = 0; i < stride; ++i) {
        const uint8_t v =
            static_cast<uint8_t>(cur[i] - predict(kind, cur, up, i, bpp));
        trial[i] = v;
        cost += v < 128 ? v : 256 - v;
      }
      if (best < 0 || cost < best) {
        best = cost;
        dst[0] = static_cast<uint8_t>(kind);
        for (int i = 0; i < stride; ++i) dst[1 + i] = trial[i];
      }
    }
  }
}

}  // extern "C"
