// Bilinear warp with pixel-offset flow, forward: the first design, kept
// callable for comparison only (b2f_warp_bilinear_fwd_thread; nothing on
// any path launches it). The path's kernel is warp_fwd_tiled.cu, which
// replaces the XLA quad gather of back2future_tpu/ops/warp.py
// (`_corners` + `_gather_corners` + `_warp_forward`), itself the
// reference's native sampler (extras/stnbhwd/BilinearSamplerBHWD.cu). NHWC:
//
//   xc = clamp(x + flow[b,y,x,0], 0, W-1), yc = clamp(y + flow[b,y,x,1], 0, H-1)
//   x0 = floor(xc), wx = 1 - (xc - x0)     (y0, wy likewise)
//   out = wx*wy*I[y0,x0] + (1-wx)*wy*I[y0,x0+1] + wx*(1-wy)*I[y0+1,x0]
//         + (1-wx)*(1-wy)*I[y0+1,x0+1]
//
// An out-of-range +1 corner only occurs when the coordinate clamps at the
// last row/column, where its weight is exactly 0; its index is clamped so
// nothing outside the image is read. The coordinates and weights are f32
// for every image dtype: in bf16 the pixel grid itself would round (the
// spacing is 2.0 from 256 to 512), which the JAX package does.
//
// What bounds it on the H100: device memory. Per output pixel it reads 4
// gathered channel vectors (mostly from L1/L2, as neighbouring pixels
// gather neighbouring corners) and writes one, at ~1 FLOP per byte.
//
// Design: one thread per output pixel computes the coordinates once and
// walks the channels in 16-byte packs (8 bf16 or 4 f32) when C and the
// pointers allow it, one element at a time otherwise, accumulating in f32.
#include "common.cuh"

namespace {

using b2f::from_f32;
using b2f::Pack;
using b2f::to_f32;

constexpr int THREADS = 128;

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
warp_bilinear_fwd_kernel(const T* __restrict__ img, const T* __restrict__ flow,
                         T* __restrict__ out, int H, int W, int C, size_t npix) {
  const size_t p = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (p >= npix) return;
  const int x = static_cast<int>(p % W);
  const int y = static_cast<int>((p / W) % H);
  const size_t b = p / (static_cast<size_t>(H) * W);

  const float xc = fminf(fmaxf(to_f32(flow[2 * p]) + static_cast<float>(x), 0.f),
                         static_cast<float>(W - 1));
  const float yc = fminf(fmaxf(to_f32(flow[2 * p + 1]) + static_cast<float>(y), 0.f),
                         static_cast<float>(H - 1));
  const float x0f = floorf(xc), y0f = floorf(yc);
  const float wx = 1.f - (xc - x0f), wy = 1.f - (yc - y0f);
  const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  const float w_tl = wx * wy, w_tr = (1.f - wx) * wy;
  const float w_bl = wx * (1.f - wy), w_br = (1.f - wx) * (1.f - wy);

  const T* base = img + b * H * W * C;
  const T* tl = base + (static_cast<size_t>(y0) * W + x0) * C;
  const T* tr = base + (static_cast<size_t>(y0) * W + x1) * C;
  const T* bl = base + (static_cast<size_t>(y1) * W + x0) * C;
  const T* br = base + (static_cast<size_t>(y1) * W + x1) * C;
  T* o = out + p * C;

  using P = Pack<T, VEC>;
  for (int c = 0; c < C; c += VEC) {
    const P a = *reinterpret_cast<const P*>(tl + c);
    const P bv = *reinterpret_cast<const P*>(tr + c);
    const P cv = *reinterpret_cast<const P*>(bl + c);
    const P d = *reinterpret_cast<const P*>(br + c);
    P r;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      r.v[k] = from_f32<T>(w_tl * to_f32(a.v[k]) + w_tr * to_f32(bv.v[k]) +
                           w_bl * to_f32(cv.v[k]) + w_br * to_f32(d.v[k]));
    *reinterpret_cast<P*>(o + c) = r;
  }
}

template <typename T>
cudaError_t launch(const void* img, const void* flow, void* out, int B, int H,
                   int W, int C, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t npix = static_cast<size_t>(B) * H * W;
  const dim3 grid(static_cast<unsigned>((npix + THREADS - 1) / THREADS));
  const bool packed = C % VEC == 0 &&
      (reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (packed)
    warp_bilinear_fwd_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(img), static_cast<const T*>(flow), static_cast<T*>(out),
        H, W, C, npix);
  else
    warp_bilinear_fwd_kernel<T, 1><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(img), static_cast<const T*>(flow), static_cast<T*>(out),
        H, W, C, npix);
  return cudaGetLastError();
}

}  // namespace

// The first design, for comparison only; the arguments are those of
// b2f_warp_bilinear_fwd (warp_fwd_tiled.cu): img: (B, H, W, C), flow:
// (B, H, W, 2), out: (B, H, W, C), all contiguous and of `dtype`
// (b2f::DType). Launches on `stream`, returns cudaGetLastError().
extern "C" int b2f_warp_bilinear_fwd_thread(const void* img, const void* flow, void* out,
                                            int dtype, int B, int H, int W, int C,
                                            void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case b2f::kFloat32: return launch<float>(img, flow, out, B, H, W, C, s);
    case b2f::kBFloat16: return launch<__nv_bfloat16>(img, flow, out, B, H, W, C, s);
    default: return cudaErrorInvalidValue;
  }
}
