// The f32 source coordinate of a warp output pixel and its four corners,
// shared by the warp's backward kernels (warp_bwd.cu, warp_bwd_tiled.cu).
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
