// Three-state occlusion derivation from depth + flow (getOCC,
// flowExtensions.lua:172-239): forward/backward z-buffer splatting with
// the reference's column-major last-writer-wins traversal, then a 3x3
// lower-median filter. The port's copy of
// back2future_tpu/runtime/src/getocc.cc, behind io/occ.py:get_occ; the
// Python loop `get_occ_reference` is the semantic oracle, and
// tests/test_torch_io.py holds the two (and the JAX package's library)
// equal.
//
// The splat phase is order-dependent (each collision marks exactly one
// of {old occupant, new pixel} occluded, in traversal order), so it
// stays sequential. The median filter, an OpenMP loop over rows in the
// JAX package, splits its rows over std::thread as OpenMP's
// schedule(static) does (runtime/host_build.py compiles without
// OpenMP); each output row is one thread's, so the result does not
// depend on the thread count.

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "parallel_rows.h"

namespace {

// torch.round semantics (C round(): half away from zero), applied in the
// reference's 1-based coordinate frame: getOCC computes
// round(x_1based + flow) (flowExtensions.lua:184-185), and half-away
// rounding is not shift-invariant at negative .5 ties, so the +1/-1
// frame shift must be inside the round to match exactly. KITTI flow is
// quantized to 1/64, so exact .5 fractional displacements do occur.
inline int64_t round_torch_1based(double zero_based, double disp) {
  return (int64_t)std::round(zero_based + 1.0 + disp) - 1;
}

inline double median_lower(double* vals, int n) {
  std::sort(vals, vals + n);
  return vals[(n + 1) / 2 - 1];
}

}  // namespace

extern "C" {

// depth: (h, w) float64; flow: (h, w, 2) float64 [u, v];
// occ out: (h, w) float64 in {0, 0.5, 1}; `threads` runs the median filter.
void get_occ_f64(const double* depth, const double* flow, double* occ,
                 int64_t h, int64_t w, int64_t threads) {
  const int64_t n = h * w;
  int64_t* fwd_pixel = new int64_t[n];
  int64_t* bwd_pixel = new int64_t[n];
  double* fwd_z = new double[n]();
  double* bwd_z = new double[n]();
  double* splat = new double[n];
  std::fill(fwd_pixel, fwd_pixel + n, -1);
  std::fill(bwd_pixel, bwd_pixel + n, -1);
  std::fill(splat, splat + n, 0.5);

  // column-major traversal, linear id i = x*h + y (flowExtensions.lua:186)
  for (int64_t x = 0; x < w; ++x) {
    for (int64_t y = 0; y < h; ++y) {
      const int64_t i = x * h + y;
      const double u = flow[(y * w + x) * 2 + 0];
      const double v = flow[(y * w + x) * 2 + 1];
      const double d = depth[y * w + x];
      for (int dir = 1; dir >= -1; dir -= 2) {
        const int64_t xf = round_torch_1based(x, dir * u);
        const int64_t yf = round_torch_1based(y, dir * v);
        int64_t* pix = (dir == 1) ? fwd_pixel : bwd_pixel;
        double* zbuf = (dir == 1) ? fwd_z : bwd_z;
        const double state = (dir == 1) ? 1.0 : 0.0;
        if (xf >= 0 && xf < w && yf >= 0 && yf < h) {
          const int64_t t = yf * w + xf;
          if (pix[t] == -1) {
            pix[t] = i;
            zbuf[t] = d;
          } else if (d - zbuf[t] < -0.1) {
            // current pixel is closer: previous occupant is occluded
            const int64_t occ_x = pix[t] / h;
            const int64_t occ_y = pix[t] % h;
            splat[occ_y * w + occ_x] = state;
            pix[t] = i;
            zbuf[t] = d;
          } else {
            splat[y * w + x] = state;
          }
        } else {
          splat[y * w + x] = state;
        }
      }
    }
  }

  // 3x3 lower-median filter, window clipped at borders
  // (flowExtensions.lua:230-237)
  parallel_rows(h, threads, [=](int64_t ya, int64_t yb) {
    for (int64_t y = ya; y < yb; ++y) {
      const int64_t y0 = std::max<int64_t>(y - 1, 0);
      const int64_t y1 = std::min<int64_t>(y + 1, h - 1);
      for (int64_t x = 0; x < w; ++x) {
        const int64_t x0 = std::max<int64_t>(x - 1, 0);
        const int64_t x1 = std::min<int64_t>(x + 1, w - 1);
        double win[9];
        int m = 0;
        for (int64_t yy = y0; yy <= y1; ++yy)
          for (int64_t xx = x0; xx <= x1; ++xx) win[m++] = splat[yy * w + xx];
        occ[y * w + x] = median_lower(win, m);
      }
    }
  });

  delete[] fwd_pixel;
  delete[] bwd_pixel;
  delete[] fwd_z;
  delete[] bwd_z;
  delete[] splat;
}

}  // extern "C"
