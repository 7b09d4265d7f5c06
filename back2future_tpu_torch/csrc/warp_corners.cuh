// The f32 source coordinate of a warp output pixel and its four corners,
// shared by the warp's kernels (warp_fwd_tiled.cu, warp_bwd.cu,
// warp_bwd_tiled.cu), and the read-only loads of their C = 3 routes.
// The arithmetic is warp_fwd.cu's: xc = clamp(x + flow_x, 0, W-1),
// x0 = floor(xc), wx = 1 - (xc - x0); y likewise.
#pragma once

#include "common.cuh"

namespace b2f {

struct Corners {
  int x0, y0, x1, y1;     // +1 corners clamped into the image
  bool x1_in, y1_in;      // whether the +1 corners were inside before clamping
  bool x_clamped, y_clamped;
  float wx, wy;           // weights of the left column / top row
};

// corners of output pixel (y, x) moved by the flow (fx, fy)
__device__ __forceinline__ Corners corners_at(float fx, float fy, int x, int y, int H, int W) {
  Corners k;
  const float xs = fx + static_cast<float>(x);
  const float ys = fy + static_cast<float>(y);
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

// corners of output pixel p = (b, y, x) of a (B, H, W, 2) flow
template <typename T>
__device__ __forceinline__ Corners warp_corners(const T* flow, size_t p, int x, int y, int H,
                                                int W) {
  return corners_at(to_f32(flow[2 * p]), to_f32(flow[2 * p + 1]), x, y, H, W);
}

// the 3 channels of a pixel at p, or the 6 of two neighbouring pixels,
// through the read-only path: 4-byte (bf16) or 8-byte (f32) pairs from
// where the span's start allows them, single elements at its ends
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// the flow of pixel p as f32 (u, v): one pair load where the flow is
// aligned for it (flow_pairs)
template <typename T>
__device__ __forceinline__ float2 flow_at(const T* flow, size_t p, int flow_pairs) {
  return flow_pairs ? ld2(flow + 2 * p) : make_float2(ld1(flow + 2 * p), ld1(flow + 2 * p + 1));
}

// the 6 elements at p (a corner pair): 3 pair loads where p is aligned
// for them, else an element, 2 pairs and an element
template <typename T>
__device__ __forceinline__ void load_span6(const T* p, float (&v)[6]) {
  if (reinterpret_cast<uintptr_t>(p) % (2 * sizeof(T)) == 0) {
    const float2 a = ld2(p), b = ld2(p + 2), c = ld2(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y; v[4] = c.x; v[5] = c.y;
  } else {
    const float2 a = ld2(p + 1), b = ld2(p + 3);
    v[0] = ld1(p); v[1] = a.x; v[2] = a.y; v[3] = b.x; v[4] = b.y; v[5] = ld1(p + 5);
  }
}

// the 3 elements at p, and 0 for the +1 corner
template <typename T>
__device__ __forceinline__ void load_span3(const T* p, float (&v)[6]) {
  v[0] = ld1(p); v[1] = ld1(p + 1); v[2] = ld1(p + 2);
  v[3] = v[4] = v[5] = 0.f;
}

// the 3 elements at p (a pixel at C = 3): a pair and an element, the pair
// first where p is aligned for it, else last
template <typename T>
__device__ __forceinline__ void load_pixel3(const T* p, float (&v)[3]) {
  if (reinterpret_cast<uintptr_t>(p) % (2 * sizeof(T)) == 0) {
    const float2 a = ld2(p);
    v[0] = a.x; v[1] = a.y; v[2] = ld1(p + 2);
  } else {
    const float2 a = ld2(p + 1);
    v[0] = ld1(p); v[1] = a.x; v[2] = a.y;
  }
}

// the flow gradient of one pixel from its four corner dot products (the
// +1 corners outside the image give 0): the reference formula at the
// clamped coordinate, or with reference_grads == 0 the autodiff gradient,
// zeroed where the coordinate clamps
__device__ __forceinline__ float2 warp_dflow(const Corners& k, float tl, float tr, float bl,
                                             float br, int reference_grads) {
  if (!k.x1_in) tr = br = 0.f;
  if (!k.y1_in) bl = br = 0.f;
  const float wx = k.wx, wy = k.wy;
  float dfx = -wy * tl + wy * tr - (1.f - wy) * bl + (1.f - wy) * br;
  float dfy = -wx * tl + wx * bl - (1.f - wx) * tr + (1.f - wx) * br;
  if (!reference_grads) {
    if (k.x_clamped) dfx = 0.f;
    if (k.y_clamped) dfy = 0.f;
  }
  return make_float2(dfx, dfy);
}

}  // namespace b2f
