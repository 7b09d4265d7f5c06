// PNG scanline de-filtering / filtering (the hot loops of io/png16.py).
//
// The port's copy of back2future_tpu/runtime/src/pngfilter.cc. The Python
// codec handles chunk parsing and zlib; the per-byte sequential
// reconstruction loops (PNG filters Sub/Up/Average/Paeth) and the encoder's
// Up filter live here. io/png16.py:_defilter_python is the oracle that
// tests/test_torch_io.py holds this against.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// lines: h x stride bytes (modified in place), ftypes: h filter bytes.
// Returns 0 on success, -1 on a bad filter type.
int b2f_png_defilter(uint8_t* lines, const uint8_t* ftypes, int64_t h,
                     int64_t stride, int64_t bpp) {
  uint8_t* prev = (uint8_t*)calloc(stride, 1);
  if (!prev) return -1;
  int rc = 0;
  for (int64_t y = 0; y < h; ++y) {
    uint8_t* line = lines + y * stride;
    switch (ftypes[y]) {
      case 0:
        break;
      case 1:  // Sub
        for (int64_t x = bpp; x < stride; ++x) line[x] += line[x - bpp];
        break;
      case 2:  // Up
        for (int64_t x = 0; x < stride; ++x) line[x] += prev[x];
        break;
      case 3:  // Average
        for (int64_t x = 0; x < stride; ++x) {
          int left = x >= bpp ? line[x - bpp] : 0;
          line[x] += (uint8_t)((left + prev[x]) >> 1);
        }
        break;
      case 4: {  // Paeth
        for (int64_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? line[x - bpp] : 0;
          int b = prev[x];
          int c = x >= bpp ? prev[x - bpp] : 0;
          int p = a + b - c;
          int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          line[x] += (uint8_t)pred;
        }
        break;
      }
      default:
        rc = -1;
        y = h;  // bail
    }
    memcpy(prev, line, stride);
  }
  free(prev);
  return rc;
}

// Choose + apply PNG filters for encoding (Up filter: cheap and effective
// for smooth flow maps). out must hold h*(stride+1) bytes.
void b2f_png_filter_up(const uint8_t* lines, uint8_t* out, int64_t h,
                       int64_t stride) {
  const uint8_t* prev = nullptr;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* line = lines + y * stride;
    uint8_t* o = out + y * (stride + 1);
    if (y == 0) {
      o[0] = 0;
      memcpy(o + 1, line, stride);
    } else {
      o[0] = 2;
      for (int64_t x = 0; x < stride; ++x) o[1 + x] = line[x] - prev[x];
    }
    prev = line;
  }
}

}  // extern "C"
