// Bilinear warp with pixel-offset flow, backward: the first design of the
// image and flow gradients, kept callable for comparison only as
// b2f_warp_bilinear_dimages_thread and b2f_warp_bilinear_dflow_thread
// (nothing on the serving or train path launches them). The kernels of
// the path are warp_bwd_tiled.cu's, with the same semantics and C
// interface (b2f_warp_bilinear_dimages, b2f_warp_bilinear_dflow).
//
// With the forward of warp_fwd.cu (xc = clamp(x + flow_x, 0, W-1),
// x0 = floor(xc), wx = 1 - (xc - x0); y likewise; corners tl, tr, bl, br),
// for an output gradient g (B, H, W, C), NHWC:
//
// dimages (K4) is the exact transpose of the bilinear gather,
//     d_img[b, corner(p), c] += w_corner(p) * g[b, p, c]
//   for the four corners of every output pixel p. A +1 corner outside the
//   image has weight exactly 0 and is skipped, so no index leaves the image.
//
// dflow (W-dflow) is the reference sampler's flow gradient
//   (extras/stnbhwd/BilinearSamplerBHWD.cu:232-295): with the per-corner dot
//   products tl = <I[y0,x0], g[p]> etc., out-of-range +1 corners giving 0,
//     dfx = -wy*tl + wy*tr - (1-wy)*bl + (1-wy)*br
//     dfy = -wx*tl + wx*bl - (1-wx)*tr + (1-wx)*br
//   at the clamped coordinate, NOT zeroed where it clamps. With
//   reference_grads == 0 it is the autodiff gradient of `_warp_autodiff`
//   instead: the same formula with a component zeroed where its
//   coordinate clamps (the two differ only at exact clamp ties).
//
// Coordinates and weights are f32 for every dtype, as in the forward.
//
// Design: dimages runs one thread per (output pixel, VEC-channel group)
// and issues up to 16 scalar f32 atomic adds into a zeroed f32 buffer that
// the caller allocates and casts; every one of them goes to L2. dflow
// runs one thread per output pixel, which walks the channels in 16-byte
// packs where C and the pointers allow it and sums the dot products in
// f32; across a warp one pack's loads lie 2C bytes apart.
#include "warp_corners.cuh"

namespace {

using b2f::Corners;
using b2f::from_f32;
using b2f::Pack;
using b2f::to_f32;
using b2f::warp_corners;

constexpr int THREADS = 128;

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
warp_bilinear_dimages_kernel(const T* __restrict__ flow, const T* __restrict__ g,
                             float* __restrict__ d_img, int H, int W, int C,
                             size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const int groups = C / VEC;
  const size_t p = i / groups;
  const int c = static_cast<int>(i % groups) * VEC;
  const int x = static_cast<int>(p % W);
  const int y = static_cast<int>((p / W) % H);
  const size_t b = p / (static_cast<size_t>(H) * W);
  const Corners k = warp_corners(flow, p, x, y, H, W);

  const Pack<T, VEC> gv = *reinterpret_cast<const Pack<T, VEC>*>(g + p * C + c);
  float* base = d_img + b * H * W * C + c;
  float* tl = base + (static_cast<size_t>(k.y0) * W + k.x0) * C;
  float* tr = base + (static_cast<size_t>(k.y0) * W + k.x1) * C;
  float* bl = base + (static_cast<size_t>(k.y1) * W + k.x0) * C;
  float* br = base + (static_cast<size_t>(k.y1) * W + k.x1) * C;
  const float w_tl = k.wx * k.wy, w_tr = (1.f - k.wx) * k.wy;
  const float w_bl = k.wx * (1.f - k.wy), w_br = (1.f - k.wx) * (1.f - k.wy);
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const float gc = to_f32(gv.v[v]);
    atomicAdd(tl + v, w_tl * gc);
    if (k.x1_in) atomicAdd(tr + v, w_tr * gc);
    if (k.y1_in) atomicAdd(bl + v, w_bl * gc);
    if (k.x1_in && k.y1_in) atomicAdd(br + v, w_br * gc);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
warp_bilinear_dflow_kernel(const T* __restrict__ img, const T* __restrict__ flow,
                           const T* __restrict__ g, T* __restrict__ d_flow, int H,
                           int W, int C, size_t npix, int reference_grads) {
  const size_t p = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (p >= npix) return;
  const int x = static_cast<int>(p % W);
  const int y = static_cast<int>((p / W) % H);
  const size_t b = p / (static_cast<size_t>(H) * W);
  const Corners k = warp_corners(flow, p, x, y, H, W);

  const T* base = img + b * H * W * C;
  const T* tl_p = base + (static_cast<size_t>(k.y0) * W + k.x0) * C;
  const T* tr_p = base + (static_cast<size_t>(k.y0) * W + k.x1) * C;
  const T* bl_p = base + (static_cast<size_t>(k.y1) * W + k.x0) * C;
  const T* br_p = base + (static_cast<size_t>(k.y1) * W + k.x1) * C;
  const T* gp = g + p * C;

  using P = Pack<T, VEC>;
  float tl = 0.f, tr = 0.f, bl = 0.f, br = 0.f;
  for (int c = 0; c < C; c += VEC) {
    const P gv = *reinterpret_cast<const P*>(gp + c);
    const P a = *reinterpret_cast<const P*>(tl_p + c);
    const P bv = *reinterpret_cast<const P*>(tr_p + c);
    const P cv = *reinterpret_cast<const P*>(bl_p + c);
    const P d = *reinterpret_cast<const P*>(br_p + c);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float gc = to_f32(gv.v[v]);
      tl = fmaf(to_f32(a.v[v]), gc, tl);
      tr = fmaf(to_f32(bv.v[v]), gc, tr);
      bl = fmaf(to_f32(cv.v[v]), gc, bl);
      br = fmaf(to_f32(d.v[v]), gc, br);
    }
  }
  const float2 d = b2f::warp_dflow(k, tl, tr, bl, br, reference_grads);
  d_flow[2 * p] = from_f32<T>(d.x);
  d_flow[2 * p + 1] = from_f32<T>(d.y);
}

bool aligned16(const void* a) { return reinterpret_cast<uintptr_t>(a) % 16 == 0; }

template <typename T>
cudaError_t launch_dimages(const void* flow, const void* g, float* d_img, int B, int H,
                           int W, int C, cudaStream_t stream) {
  constexpr int VEC = 4;
  const size_t npix = static_cast<size_t>(B) * H * W;
  const bool packed = C % VEC == 0 && aligned16(g);
  const size_t n = npix * (packed ? C / VEC : C);
  const dim3 grid(static_cast<unsigned>((n + THREADS - 1) / THREADS));
  if (packed)
    warp_bilinear_dimages_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(flow), static_cast<const T*>(g), d_img, H, W, C, n);
  else
    warp_bilinear_dimages_kernel<T, 1><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(flow), static_cast<const T*>(g), d_img, H, W, C, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dflow(const void* img, const void* flow, const void* g, void* d_flow,
                         int B, int H, int W, int C, int reference_grads,
                         cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t npix = static_cast<size_t>(B) * H * W;
  const dim3 grid(static_cast<unsigned>((npix + THREADS - 1) / THREADS));
  if (C % VEC == 0 && aligned16(img) && aligned16(g))
    warp_bilinear_dflow_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(img), static_cast<const T*>(flow), static_cast<const T*>(g),
        static_cast<T*>(d_flow), H, W, C, npix, reference_grads);
  else
    warp_bilinear_dflow_kernel<T, 1><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(img), static_cast<const T*>(flow), static_cast<const T*>(g),
        static_cast<T*>(d_flow), H, W, C, npix, reference_grads);
  return cudaGetLastError();
}

}  // namespace

// The first design's K4, for comparison only. flow: (B, H, W, 2) and g:
// (B, H, W, C), contiguous and of `dtype` (b2f::DType); d_img: (B, H, W,
// C) f32, zeroed by the caller, to which the image gradient is ADDED.
// Launches on `stream`, returns cudaGetLastError().
extern "C" int b2f_warp_bilinear_dimages_thread(const void* flow, const void* g, void* d_img,
                                                int dtype, int B, int H, int W, int C,
                                                void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(d_img);
  switch (dtype) {
    case b2f::kFloat32: return launch_dimages<float>(flow, g, out, B, H, W, C, s);
    case b2f::kBFloat16:
      return launch_dimages<__nv_bfloat16>(flow, g, out, B, H, W, C, s);
    default: return cudaErrorInvalidValue;
  }
}

// The first design's W-dflow, for comparison only. img: (B, H, W, C),
// flow: (B, H, W, 2), g: (B, H, W, C), d_flow: (B, H, W, 2), all
// contiguous and of `dtype`. reference_grads: 1 for the reference formula,
// 0 for the autodiff gradient (zeroed where the coordinate clamps).
// Launches on `stream`, returns cudaGetLastError().
extern "C" int b2f_warp_bilinear_dflow_thread(const void* img, const void* flow,
                                              const void* g, void* d_flow, int dtype, int B,
                                              int H, int W, int C, int reference_grads,
                                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case b2f::kFloat32:
      return launch_dflow<float>(img, flow, g, d_flow, B, H, W, C, reference_grads, s);
    case b2f::kBFloat16:
      return launch_dflow<__nv_bfloat16>(img, flow, g, d_flow, B, H, W, C,
                                         reference_grads, s);
    default:
      return cudaErrorInvalidValue;
  }
}
