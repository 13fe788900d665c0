// PNG row reconstruction (PNG specification, section 9): the filtered
// scanlines of an 8-bit, non-interlaced image back to its bytes.
//
// Built by keypointnerf_torch/data/native_loader.py into
// build/native/libkpnerf_png.so and called through ctypes, which releases
// the GIL for the call: loader threads decode their PNGs side by side.
#include <cstdint>
#include <cstdlib>

extern "C" {

// raw: H rows of (1 + stride) bytes, each a filter type byte and the row's
// filtered bytes; out: H rows of `stride` reconstructed bytes; bpp: bytes a
// pixel. Returns -1, or the first row whose filter type is not 0-4 (its
// bytes and the rows after it are left unwritten).
int64_t kp_png_unfilter(const uint8_t* raw, uint8_t* out, int64_t H, int64_t stride,
                        int64_t bpp) {
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t* x = raw + y * (stride + 1) + 1;
    const uint8_t kind = x[-1];
    uint8_t* row = out + y * stride;
    const uint8_t* prev = y > 0 ? out + (y - 1) * stride : nullptr;
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? row[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
      int pred;
      switch (kind) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return y;
      }
      row[i] = static_cast<uint8_t>(x[i] + pred);
    }
  }
  return -1;
}

}  // extern "C"
