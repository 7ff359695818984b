// PNG unfiltering on the host (io/image.py).
//
// Python inflates the image data with zlib; this reverses the per-row
// filters of the whole image in one call.  Average (3) and Paeth (4)
// depend on the byte to their left in the same row, so a row is a serial
// walk.  Plain C ABI (ctypes), built with the host compiler; no zlib
// needed.

#include <cstdint>
#include <cstdlib>

static inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

extern "C" {

// Reverse the filters of `h` scanlines: `raw` holds h * (stride + 1)
// bytes, each row a filter byte and `stride` filtered bytes; `out` gets
// h * stride unfiltered bytes; `bpp` is the bytes per pixel.  Returns 0,
// or -1 - y for an unknown filter type in row y.
int vt_png_unfilter(const uint8_t* raw, uint8_t* out, int64_t h, int64_t stride, int bpp) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* line = raw + y * (stride + 1) + 1;
    const int filter = line[-1];
    const uint8_t* prev = y ? out + (y - 1) * stride : nullptr;
    uint8_t* row = out + y * stride;
    if (filter > 4) return static_cast<int>(-1 - y);
    for (int64_t x = 0; x < stride; ++x) {
      int a = x >= bpp ? row[x - bpp] : 0;
      int b = prev ? prev[x] : 0;
      int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
      int v = line[x];
      switch (filter) {
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) >> 1; break;
        case 4: v += paeth(a, b, c); break;
        default: break;
      }
      row[x] = static_cast<uint8_t>(v);
    }
  }
  return 0;
}

}  // extern "C"
