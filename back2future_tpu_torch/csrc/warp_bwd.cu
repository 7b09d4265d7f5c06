// Bilinear warp with pixel-offset flow, backward: image and flow gradients.
//
// With the forward of warp_fwd.cu (xc = clamp(x + flow_x, 0, W-1),
// x0 = floor(xc), wx = 1 - (xc - x0); y likewise; corners tl, tr, bl, br),
// for an output gradient g (B, H, W, C), NHWC:
//
// b2f_warp_bilinear_dimages (K4) replaces back2future_tpu/ops/warp_pallas.py
//   `_kernel` (via `d_images_pallas`), and the XLA scatter that is its
//   default in back2future_tpu/ops/warp.py `_warp_bwd`: the exact
//   transpose of the bilinear gather,
//     d_img[b, corner(p), c] += w_corner(p) * g[b, p, c]
//   for the four corners of every output pixel p. A +1 corner outside the
//   image has weight exactly 0 and is skipped, so no index leaves the image.
//
// b2f_warp_bilinear_dflow (W-dflow) replaces the XLA flow-gradient formula
//   of back2future_tpu/ops/warp.py `_warp_bwd` (the reference sampler's,
//   extras/stnbhwd/BilinearSamplerBHWD.cu:232-295): with the per-corner dot
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
// What bounds them on the H100: device memory. dflow reads 4 gathered
// channel vectors and one of g per pixel and writes 2 values (~1 FLOP per
// byte). dimages reads g once and issues 4 f32 atomic adds per element;
// neighbouring lanes add to neighbouring channels of one corner, so each
// warp's adds coalesce into few L2 sectors, and L2 atomic throughput is the
// limit.
//
// Design: the TPU kernel's two-hot contraction (P*H*W*C multiply-adds) is
// not carried over: on Hopper the exact transpose is a scatter. dimages
// runs one thread per (output pixel, VEC-channel group) and adds into a
// zeroed f32 buffer that the caller allocates and casts; the order of the
// atomic sums varies from run to run, so the result is not bitwise
// deterministic (f32 rounding only). dflow runs one thread per output
// pixel, which walks the channels in 16-byte packs where C and the
// pointers allow it and sums the dot products in f32; it is deterministic.
#include "common.cuh"

namespace {

using b2f::from_f32;
using b2f::Pack;
using b2f::to_f32;

constexpr int THREADS = 128;

// Clamped f32 source coordinate of output pixel p and its corners.
struct Corners {
  int x0, y0, x1, y1;     // +1 corners clamped into the image
  bool x1_in, y1_in;      // whether the +1 corners were inside before clamping
  bool x_clamped, y_clamped;
  float wx, wy;           // weights of the left column / top row
};

template <typename T>
__device__ __forceinline__ Corners corners(const T* flow, size_t p, int x, int y, int H,
                                           int W) {
  Corners k;
  const float xs = to_f32(flow[2 * p]) + static_cast<float>(x);
  const float ys = to_f32(flow[2 * p + 1]) + static_cast<float>(y);
  const float xc = fminf(fmaxf(xs, 0.f), static_cast<float>(W - 1));
  const float yc = fminf(fmaxf(ys, 0.f), static_cast<float>(H - 1));
  const float x0f = floorf(xc), y0f = floorf(yc);
  k.wx = 1.f - (xc - x0f);
  k.wy = 1.f - (yc - y0f);
  k.x0 = static_cast<int>(x0f);
  k.y0 = static_cast<int>(y0f);
  k.x1_in = k.x0 + 1 <= W - 1;
  k.y1_in = k.y0 + 1 <= H - 1;
  k.x1 = k.x1_in ? k.x0 + 1 : k.x0;
  k.y1 = k.y1_in ? k.y0 + 1 : k.y0;
  k.x_clamped = xs < 0.f || xs > static_cast<float>(W - 1);
  k.y_clamped = ys < 0.f || ys > static_cast<float>(H - 1);
  return k;
}

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
  const Corners k = corners(flow, p, x, y, H, W);

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
  const Corners k = corners(flow, p, x, y, H, W);

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
  if (!k.x1_in) tr = br = 0.f;
  if (!k.y1_in) bl = br = 0.f;
  const float wx = k.wx, wy = k.wy;
  float dfx = -wy * tl + wy * tr - (1.f - wy) * bl + (1.f - wy) * br;
  float dfy = -wx * tl + wx * bl - (1.f - wx) * tr + (1.f - wx) * br;
  if (!reference_grads) {
    if (k.x_clamped) dfx = 0.f;
    if (k.y_clamped) dfy = 0.f;
  }
  d_flow[2 * p] = from_f32<T>(dfx);
  d_flow[2 * p + 1] = from_f32<T>(dfy);
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

// flow: (B, H, W, 2) and g: (B, H, W, C), contiguous and of `dtype`
// (b2f::DType); d_img: (B, H, W, C) f32, zeroed by the caller, to which the
// image gradient is ADDED. Launches on `stream`, returns cudaGetLastError().
extern "C" int b2f_warp_bilinear_dimages(const void* flow, const void* g, void* d_img,
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

// img: (B, H, W, C), flow: (B, H, W, 2), g: (B, H, W, C), d_flow:
// (B, H, W, 2), all contiguous and of `dtype`. reference_grads: 1 for the
// reference formula, 0 for the autodiff gradient (zeroed where the
// coordinate clamps). Launches on `stream`, returns cudaGetLastError().
extern "C" int b2f_warp_bilinear_dflow(const void* img, const void* flow, const void* g,
                                       void* d_flow, int dtype, int B, int H, int W,
                                       int C, int reference_grads, void* stream) {
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
