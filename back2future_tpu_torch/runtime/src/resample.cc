// Host-side raster resampling for the data pipeline and the serving API.
//
// The port's copy of back2future_tpu/runtime/src/resample.cc, with the
// same six entry points and the same arithmetic: float32 HWC bilinear
// (align-corners, ScaleBHWD convention: src = dst*(in-1)/(out-1)) and
// nearest (src = floor(dst*in/out)) resizes, the window-evaluated
// transforms of the augmentation fast path, and the in-place photometric
// pipeline. The JAX package runs the two full-plane resizes as OpenMP
// loops over output rows; here runtime/host_build.py compiles without
// OpenMP, and those loops split their rows over std::thread as OpenMP's
// schedule(static) splits them (parallel_rows.h), with the thread
// count an explicit argument. Every row is computed by the same code
// whichever thread takes it, so the result does not depend on the count.
// data/resample.py and data/augment.py keep the NumPy twins of every
// function; tests/test_torch_native_resample.py holds these against the
// JAX package's library bit for bit and against the twins.

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "parallel_rows.h"

extern "C" {

// img: (h, w, c) float32 contiguous; out: (oh, ow, c) float32
void resize_bilinear_f32(const float* img, float* out,
                         int64_t h, int64_t w, int64_t c,
                         int64_t oh, int64_t ow, int64_t threads) {
  const double sy = (oh > 1) ? double(h - 1) / double(oh - 1) : 0.0;
  const double sx = (ow > 1) ? double(w - 1) / double(ow - 1) : 0.0;
  parallel_rows(oh, threads, [=](int64_t ya, int64_t yb) {
    for (int64_t y = ya; y < yb; ++y) {
      const double fy = y * sy;
      const int64_t y0 = std::min<int64_t>((int64_t)fy, h - 1);
      const int64_t y1 = std::min<int64_t>(y0 + 1, h - 1);
      const float wy = (float)(fy - (double)y0);
      const float* r0 = img + y0 * w * c;
      const float* r1 = img + y1 * w * c;
      float* dst = out + y * ow * c;
      for (int64_t x = 0; x < ow; ++x) {
        const double fx = x * sx;
        const int64_t x0 = std::min<int64_t>((int64_t)fx, w - 1);
        const int64_t x1 = std::min<int64_t>(x0 + 1, w - 1);
        const float wx = (float)(fx - (double)x0);
        const float* p00 = r0 + x0 * c;
        const float* p01 = r0 + x1 * c;
        const float* p10 = r1 + x0 * c;
        const float* p11 = r1 + x1 * c;
        for (int64_t k = 0; k < c; ++k) {
          const float top = p00[k] * (1.0f - wx) + p01[k] * wx;
          const float bot = p10[k] * (1.0f - wx) + p11[k] * wx;
          dst[x * c + k] = top * (1.0f - wy) + bot * wy;
        }
      }
    }
  });
}

void resize_nearest_f32(const float* img, float* out,
                        int64_t h, int64_t w, int64_t c,
                        int64_t oh, int64_t ow, int64_t threads) {
  const double sy = double(h) / double(oh);
  const double sx = double(w) / double(ow);
  parallel_rows(oh, threads, [=](int64_t ya, int64_t yb) {
    for (int64_t y = ya; y < yb; ++y) {
      const int64_t ys = std::min<int64_t>((int64_t)(y * sy), h - 1);
      const float* src_row = img + ys * w * c;
      float* dst = out + y * ow * c;
      for (int64_t x = 0; x < ow; ++x) {
        const int64_t xs = std::min<int64_t>((int64_t)(x * sx), w - 1);
        for (int64_t k = 0; k < c; ++k) dst[x * c + k] = src_row[xs * c + k];
      }
    }
  });
}

// ---------------------------------------------------------------- windowed
// Window-evaluated variants for the augmentation fast path
// (data/augment.py:augment_sample_cropped): each evaluates only the
// output rectangle [oy, oy+wh) x [ox, ox+ww) of the full virtual output
// plane — the exact preimage chain of the training crop — instead of
// materializing full-resolution intermediates. Serial, as in the JAX
// package: they are called from loader workers, so parallelism comes
// from the workers.

// Nearest rotation about the (h,w) image center evaluated on a window,
// with optional source flips folded in (flips happen BEFORE rotation in
// the augmentation order) and integer-translate folding via a window
// offset: pixels whose global output coordinate falls outside [0,h)x[0,w)
// are zero-filled (translate's fill), as are pixels whose nearest source
// falls outside (rotation's fill). Arithmetic matches
// augment.rotate_nearest: f64 maps, round-half-even.
void rotate_nearest_window_f32(const float* src, float* out,
                               int64_t h, int64_t w, int64_t c,
                               double angle, int64_t flip_h, int64_t flip_v,
                               int64_t oy, int64_t ox,
                               int64_t wh, int64_t ww) {
  const double cy = double(h - 1) / 2.0, cx = double(w - 1) / 2.0;
  const double ca = std::cos(angle), sa = std::sin(angle);
  for (int64_t i = 0; i < wh; ++i) {
    const int64_t yg = oy + i;
    const double yd = (double)yg;
    float* dst = out + i * ww * c;
    for (int64_t j = 0; j < ww; ++j) {
      const int64_t xg = ox + j;
      const double xd = (double)xg;
      const double xs = ca * (xd - cx) + sa * (yd - cy) + cx;
      const double ys = -sa * (xd - cx) + ca * (yd - cy) + cy;
      const int64_t xi = (int64_t)std::nearbyint(xs);
      const int64_t yi = (int64_t)std::nearbyint(ys);
      const bool ok = yg >= 0 && yg < h && xg >= 0 && xg < w &&
                      xi >= 0 && xi < w && yi >= 0 && yi < h;
      if (ok) {
        const int64_t xsrc = flip_h ? (w - 1 - xi) : xi;
        const int64_t ysrc = flip_v ? (h - 1 - yi) : yi;
        const float* p = src + (ysrc * w + xsrc) * c;
        for (int64_t k = 0; k < c; ++k) dst[j * c + k] = p[k];
      } else {
        for (int64_t k = 0; k < c; ++k) dst[j * c + k] = 0.0f;
      }
    }
  }
}

// Align-corners bilinear (ih,iw)->(oh,ow) evaluated on output window
// [oy,oy+wh)x[ox,ox+ww). The source is given as a buffer holding rows
// [by0, by0+bh) x [bx0, bx0+bw) of the virtual (ih,iw) source plane
// (pass the full source with by0=bx0=0, bh=ih, bw=iw). Optional source
// flips are folded (flip defined on the virtual (ih,iw) plane). Weight
// arithmetic matches resize_bilinear_f32 exactly.
void resize_bilinear_window_f32(const float* srcbuf, float* out,
                                int64_t bh, int64_t bw,
                                int64_t by0, int64_t bx0,
                                int64_t ih, int64_t iw, int64_t c,
                                int64_t oh, int64_t ow,
                                int64_t flip_h, int64_t flip_v,
                                int64_t oy, int64_t ox,
                                int64_t wh, int64_t ww) {
  const double sy = (oh > 1) ? double(ih - 1) / double(oh - 1) : 0.0;
  const double sx = (ow > 1) ? double(iw - 1) / double(ow - 1) : 0.0;
  for (int64_t i = 0; i < wh; ++i) {
    const double fy = (double)(oy + i) * sy;
    int64_t y0 = std::min<int64_t>((int64_t)fy, ih - 1);
    int64_t y1 = std::min<int64_t>(y0 + 1, ih - 1);
    const float wy = (float)(fy - (double)y0);
    if (flip_v) { y0 = ih - 1 - y0; y1 = ih - 1 - y1; }
    const int64_t b0 = std::min(std::max(y0 - by0, (int64_t)0), bh - 1);
    const int64_t b1 = std::min(std::max(y1 - by0, (int64_t)0), bh - 1);
    const float* r0 = srcbuf + b0 * bw * c;
    const float* r1 = srcbuf + b1 * bw * c;
    float* dst = out + i * ww * c;
    for (int64_t j = 0; j < ww; ++j) {
      const double fx = (double)(ox + j) * sx;
      int64_t x0 = std::min<int64_t>((int64_t)fx, iw - 1);
      int64_t x1 = std::min<int64_t>(x0 + 1, iw - 1);
      const float wx = (float)(fx - (double)x0);
      if (flip_h) { x0 = iw - 1 - x0; x1 = iw - 1 - x1; }
      const int64_t a0 = std::min(std::max(x0 - bx0, (int64_t)0), bw - 1);
      const int64_t a1 = std::min(std::max(x1 - bx0, (int64_t)0), bw - 1);
      const float* p00 = r0 + a0 * c;
      const float* p01 = r0 + a1 * c;
      const float* p10 = r1 + a0 * c;
      const float* p11 = r1 + a1 * c;
      for (int64_t k = 0; k < c; ++k) {
        const float top = p00[k] * (1.0f - wx) + p01[k] * wx;
        const float bot = p10[k] * (1.0f - wx) + p11[k] * wx;
        dst[j * c + k] = top * (1.0f - wy) + bot * wy;
      }
    }
  }
}

// Nearest resize (ih,iw)->(oh,ow) on an output window, flips folded,
// reading the full source. Mapping matches resize_nearest_f32.
void resize_nearest_window_f32(const float* src, float* out,
                               int64_t ih, int64_t iw, int64_t c,
                               int64_t oh, int64_t ow,
                               int64_t flip_h, int64_t flip_v,
                               int64_t oy, int64_t ox,
                               int64_t wh, int64_t ww) {
  const double sy = double(ih) / double(oh);
  const double sx = double(iw) / double(ow);
  for (int64_t i = 0; i < wh; ++i) {
    int64_t ys = std::min<int64_t>((int64_t)((oy + i) * sy), ih - 1);
    if (flip_v) ys = ih - 1 - ys;
    const float* src_row = src + ys * iw * c;
    float* dst = out + i * ww * c;
    for (int64_t j = 0; j < ww; ++j) {
      int64_t xs = std::min<int64_t>((int64_t)((ox + j) * sx), iw - 1);
      if (flip_h) xs = iw - 1 - xs;
      for (int64_t k = 0; k < c; ++k) dst[j * c + k] = src_row[xs * c + k];
    }
  }
}

// ---------------------------------------------------------------- photometric
// In-place photometric training pipeline (augment.preprocess): the
// brightness/contrast/saturation jitters in the rng-drawn order, PCA
// lighting, ImageNet normalization — one native call instead of ~10
// full-size NumPy temporaries, and GIL-free so loader threads scale.
// Random draws stay on the Python side (stream parity with the NumPy
// path); op codes: 0=brightness, 1=contrast, 2=saturation.
// Elementwise arithmetic matches the NumPy path op-for-op in f32; the
// contrast group-mean uses a double accumulator (NumPy: pairwise f32) —
// agreement to ~1e-6 relative, covered by tests.
void photo_pipeline_f32(float* img, int64_t h, int64_t w, int64_t c,
                        const int64_t* ops, const double* alphas,
                        int64_t n_ops, const float* pca_rgb,
                        int64_t do_lighting, const float* mean,
                        const float* stdv, int64_t do_normalize) {
  const int64_t npx = h * w;
  const int64_t groups = c / 3;
  if (groups > 64) return;  // caller gates on this; defend the fixed
  //                           acc[64]/target[64] buffers regardless
  for (int64_t oi = 0; oi < n_ops; ++oi) {
    const float a = (float)alphas[oi];
    const float b = (float)(1.0 - alphas[oi]);
    switch (ops[oi]) {
      case 0:  // brightness: blend toward zero
        for (int64_t i = 0; i < npx * c; ++i) img[i] *= a;
        break;
      case 1: {  // contrast: blend toward the group's mean gray value
        double acc[64] = {0};
        for (int64_t p = 0; p < npx; ++p) {
          const float* px = img + p * c;
          for (int64_t g = 0; g < groups; ++g) {
            const float* q = px + g * 3;
            acc[g] += q[0] * 0.299f + q[1] * 0.587f + q[2] * 0.114f;
          }
        }
        float target[64];
        for (int64_t g = 0; g < groups; ++g)
          target[g] = (float)(acc[g] / (double)npx) * b;
        for (int64_t p = 0; p < npx; ++p) {
          float* px = img + p * c;
          for (int64_t g = 0; g < groups; ++g)
            for (int64_t k = 0; k < 3; ++k)
              px[g * 3 + k] = px[g * 3 + k] * a + target[g];
        }
        break;
      }
      case 2:  // saturation: blend toward the group's per-pixel gray
        for (int64_t p = 0; p < npx; ++p) {
          float* px = img + p * c;
          for (int64_t g = 0; g < groups; ++g) {
            float* q = px + g * 3;
            const float luma =
                q[0] * 0.299f + q[1] * 0.587f + q[2] * 0.114f;
            const float add = luma * b;
            q[0] = q[0] * a + add;
            q[1] = q[1] * a + add;
            q[2] = q[2] * a + add;
          }
        }
        break;
    }
  }
  if (do_lighting) {
    for (int64_t p = 0; p < npx; ++p) {
      float* px = img + p * c;
      for (int64_t g = 0; g < groups; ++g)
        for (int64_t k = 0; k < 3; ++k) px[g * 3 + k] += pca_rgb[k];
    }
  }
  if (do_normalize) {
    for (int64_t p = 0; p < npx; ++p) {
      float* px = img + p * c;
      for (int64_t g = 0; g < groups; ++g)
        for (int64_t k = 0; k < 3; ++k)
          px[g * 3 + k] = (px[g * 3 + k] - mean[k]) / stdv[k];
    }
  }
}

}  // extern "C"
