// Bilinear warp with pixel-offset flow, backward, designed for Hopper: the
// image gradient (K4) and the flow gradient (W-dflow). The semantics are
// those of warp_bwd.cu, which keeps the first design's kernels callable
// for comparison only (b2f_warp_bilinear_{dimages,dflow}_thread):
//
//   d_img[b, corner(p), c] += w_corner(p) * g[b, p, c]
//   d_flow[b, p] = the reference formula of the four corner dot products
//                  <I[corner(p)], g[b, p]> (warp_corners.cuh, warp_dflow)
//
// for the four corners of every output pixel p; a +1 corner outside the
// image has weight exactly 0 and is skipped.
//
// K4 replaces back2future_tpu/ops/warp_pallas.py `_kernel` (via
// `d_images_pallas`) and the XLA scatter that is its default in
// back2future_tpu/ops/warp.py `_warp_bwd`. The TPU kernel's two-hot
// contraction (P*H*W*C multiply-adds) is not carried over: on Hopper the
// exact transpose stays a scatter, and what bounds it is where it adds.
// The first design ran one thread per (pixel, 4 channels), each issuing up
// to 16 scalar f32 atomics, every one of them to L2 (~45 M per train
// step); L2 takes about as many 16-byte reductions a second as scalar
// ones, so their count is what bounds K4. Here a block owns a TH x TW tile
// of output pixels and a slice of at most CS channels. It computes its
// pixels' corners in f32, takes the bounding box of all their corners,
// and then
//  - window route, when the box holds at most WINDOW_PIX pixels: the
//    tile's g is staged in shared memory and its adds are sorted by the
//    window pixel they go to; each (window pixel, 4 channels) sums its adds
//    in registers and flushes them into the f32 buffer with one 16-byte
//    reduction (atomicAdd of a float4, a global vector reduction on sm_90),
//    none where no add lands. Neighbouring blocks' windows overlap, so the
//    flush is atomic too; it issues about (covered window / tile) x C/4
//    reductions per tile pixel instead of 4 x C/4. Smooth flows (a model's
//    flows are 2x upsamples of the coarser level's) keep the box close to
//    the tile. (Summing into the window with shared f32 atomics, the
//    first plan, took as long as the direct route: on Hopper each is a
//    compare-and-swap loop.)
//  - direct route, for a block whose corners spread further (large or
//    incoherent flows): each (pixel, 4 channels) adds its four corners
//    with 16-byte reductions, 4x fewer atomic instructions than before.
// Each block picks its route on the device; both give the exact
// transpose. The window route's five phases, each behind a barrier,
// make a block's latency longer, and a launch whose grid is about one
// block an SM lasts one block's latency: there the direct route is
// faster even for a window that fits. So a launch lets its blocks take
// the window route only where its grid holds 1.5 blocks an SM or more
// (on an H100, the train step's levels 3-4 but not 5-6, which is where
// each route was measured to be the faster on the same inputs). Where C is
// not a multiple of 4 the adds are scalar, and where g is not aligned for
// 4-element packs its loads are. The order of the f32 sums varies from run
// to run (atomics), so the result is not bitwise deterministic: f32
// rounding only.
//
// K4 at C = 3 has a kernel of its own. The image warps (SPyNet's pme step runs
// 12 a step, 8x320x640 down to 8x10x20) are C = 3, where the quad tiles leave 7
// of each 8 lanes without a channel, read g an element at a time and flush up
// to 12 scalar atomics a pixel: on an H100, 0.51 ms a step, behind
// aten.grid_sampler_2d_backward (0.38). Here a block owns an 8 x 32 tile, one
// thread a pixel, which reads its flow as a pair and its 3 channels of g as a
// pair and an element (load_pixel3), and the block takes the bounding box of
// its corners. Where the box holds at most WINDOW3 pixels (and the launch
// allows it) every add goes into a channel-major f32 window in shared memory
// with an f32 shared atomic (a compare-and-swap loop on Hopper:
// ATOMS.CAST.SPIN; 12 a pixel at most, none that adds 0; with C = 3 that is
// cheap: K4's counting sort in its place was 7-13% slower in turns); the window
// is then flushed into a zeroed f32 accumulator of exactly 3 channels a pixel:
// each window row is a run of pixels, and each group of 4 pixels (48 bytes,
// 16-byte aligned) that a run touches is 3 16-byte reductions, about (covered
// window / tile) x 3/4 a tile pixel instead of 4 corners x 3 channels.
// Elsewhere each pixel adds its four corners directly, an 8-byte pair and an
// element each. A 4-channel accumulator (one 16-byte reduction a window pixel,
// the pad dropped in the cast) made the kernel 0.006 ms a step faster, but its
// zero-fill and cast move a third more bytes and its cast is a strided copy:
// 0.205 against 0.183 ms a step in all (in turns on an H100 on the pme step's
// own inputs, the quad tiles 0.510; PERF.md section 6 has both measurements).
// The window route's barriers cost more than its fewer reductions save only on
// the smallest grids: a launch allows it where its grid holds half a block an
// SM or more.
//
// W-dflow replaces the XLA flow-gradient formula of back2future_tpu/ops/
// warp.py `_warp_bwd`. It is bound by device memory (about a FLOP a
// byte). The first design ran one thread per pixel that walked C in
// 16-byte packs: across a warp one pack's loads lay 2C bytes apart, and at
// C = 3 (the image warps, two thirds of its time in a train step) it made
// fifteen 2-byte loads per pixel. Here, for C = 3, one thread per pixel
// reads its corner pairs (tl, tr) and (bl, br) as 6-element spans (3-4
// loads each) through the read-only path, its g from a block tile staged
// with 16-byte loads, and its flow and flow gradient as pairs; for any
// other C a group of 4 or 8 lanes shares a pixel, each lane reading every
// G-th 16-byte pack of g and of the four corners, so that one load of the
// group covers whole 64- or 128-byte segments, and the group sums its four
// dot products with xor-shuffles. Both sum in f32 and are deterministic.
#include <climits>

#include "warp_corners.cuh"

namespace {

using b2f::Corners;
using b2f::from_f32;
using b2f::load_span3;
using b2f::load_span6;
using b2f::Pack;
using b2f::to_f32;
using b2f::warp_corners;

// K4's plan: a block's output tile (one thread per tile pixel for its
// corners), its channel slice of at most CS channels in QS 4-channel
// quads (lane t % QS of each group of QS threads takes quad t % QS of
// PIX pixels, t / QS + PIX * k), and the largest window, in pixels, that
// takes the window route: twice the tile, so that a window flushes at
// most half the reductions of the direct route
constexpr int TH = 16, TW = 16;
constexpr int TP = TH * TW;
constexpr int CS = 32;
constexpr int QS = CS / 4;
constexpr int NT = 256;
constexpr int PIX = NT / QS;
constexpr int WINDOW_PIX = 2 * TP;
static_assert(TP == NT && WINDOW_PIX == 2 * NT, "one tile pixel and 2 window pixels a thread");

// adds v's first nv channels at dst: one 16-byte reduction (atomicAdd of
// a float4) where vec_out holds (then nv is 4), else a scalar atomic per
// channel that is not 0
__device__ __forceinline__ void add_quad(float* dst, float4 v, int nv, int vec_out) {
  if (vec_out) {
    atomicAdd(reinterpret_cast<float4*>(dst), v);
    return;
  }
  const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < nv && vals[c] != 0.f) atomicAdd(dst + c, vals[c]);
}

template <typename T>
__device__ __forceinline__ float4 to_f32x4(const Pack<T, 4>& pk) {
  return make_float4(to_f32(pk.v[0]), to_f32(pk.v[1]), to_f32(pk.v[2]), to_f32(pk.v[3]));
}

__device__ __forceinline__ float4 scale4(float w, float4 g) {
  return make_float4(w * g.x, w * g.y, w * g.z, w * g.w);
}

// K4: grid (tiles across W, tiles across H, B * slices). vec_out: C % 4 ==
// 0 and d_img 16-byte aligned, so 4 channels are added as one 16-byte
// reduction. VEC: 4 when g's 4-channel packs are aligned, else 1.
// WINDOW: a block whose box fits takes the window route (else every
// block takes the direct route). COUNT (for comparing the routes only):
// every block adds one to routes[1], and one that takes the window route
// one to routes[0].
template <typename T, int VEC, bool WINDOW, bool COUNT>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 4 : 2)   // f32: 8 packs of 4 registers
warp_bilinear_dimages_tiled_kernel(const T* __restrict__ flow, const T* __restrict__ g,
                                   float* __restrict__ d_img, int H, int W, int C, int Hs,
                                   int y0, int slices, int vec_out, int* __restrict__ routes) {
  __shared__ int4 corner_s[TP];   // x0, y0 (-1: outside the image), wx, wy as bits
  __shared__ int4 box_s[NT / 32];

  const int t = threadIdx.x;
  const int q = t % QS;
  const int slice = blockIdx.z % slices;
  // the image's first pixel in flow and g (H rows), and in d_img (Hs rows)
  const size_t img0 = static_cast<size_t>(blockIdx.z / slices) * H * W;
  const size_t src0 = static_cast<size_t>(blockIdx.z / slices) * Hs * W;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int c0 = slice * CS;
  const int cs = min(CS, C - c0);
  const int nv = max(0, min(4, cs - 4 * q));   // this lane's channels of its quad

  // this lane's quad of pixels t / QS + PIX * k: all its g loads are
  // issued first, to be in flight together and with the corners' flow
  Pack<T, 4> gk[TP / PIX];
#pragma unroll
  for (int k = 0; k < TP / PIX; ++k) {
    const int pix = t / QS + PIX * k;
    const int y = ty0 + pix / TW, x = tx0 + pix % TW;
    const T* gp = g + (img0 + static_cast<size_t>(y) * W + x) * C + c0 + 4 * q;
    const bool live = nv > 0 && y < H && x < W;
    if (VEC == 4) {
      if (live) gk[k] = *reinterpret_cast<const Pack<T, 4>*>(gp);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        gk[k].v[v] = live && v < nv ? gp[v] : b2f::from_f32<T>(0.f);
    }
  }

  // the tile's corners, one pixel a thread, and their bounding box (rows
  // y0..y1, columns x0..x1)
  {
    const int y = ty0 + t / TW, x = tx0 + t % TW;
    int4 e = make_int4(0, -1, 0, 0);
    int4 box = make_int4(INT_MAX, -1, INT_MAX, -1);
    if (y < H && x < W) {
      const Corners k = warp_corners(flow, img0 + static_cast<size_t>(y) * W + x, x, y0 + y, Hs,
                                     W);
      e = make_int4(k.x0, k.y0, __float_as_int(k.wx), __float_as_int(k.wy));
      box = make_int4(k.y0, k.y1, k.x0, k.x1);
    }
    corner_s[t] = e;
    if (WINDOW) {
      box.x = __reduce_min_sync(0xffffffffu, box.x);
      box.y = __reduce_max_sync(0xffffffffu, box.y);
      box.z = __reduce_min_sync(0xffffffffu, box.z);
      box.w = __reduce_max_sync(0xffffffffu, box.w);
      if (t % 32 == 0) box_s[t / 32] = box;
    }
  }
  __syncthreads();
  int4 box = box_s[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) {
    const int4 o = box_s[w];
    box = make_int4(min(box.x, o.x), max(box.y, o.y), min(box.z, o.z), max(box.w, o.w));
  }
  const int ylo = box.x, xlo = box.z;
  const int ww = box.w - box.z + 1;
  const int wpix = (box.y - box.x + 1) * ww;   // read only where WINDOW

  if (!WINDOW || wpix > WINDOW_PIX) {
    // direct route: each (pixel, quad)'s four corners, one 16-byte
    // reduction each
    if (nv == 0) return;
#pragma unroll
    for (int k = 0; k < TP / PIX; ++k) {
      const int4 e = corner_s[t / QS + PIX * k];
      if (e.y < 0) continue;
      const float4 gv = to_f32x4(gk[k]);
      const float wx = __int_as_float(e.z), wy = __int_as_float(e.w);
      const bool x1_in = e.x + 1 < W, y1_in = e.y + 1 < Hs;
      float* tl = d_img + (src0 + static_cast<size_t>(e.y) * W + e.x) * C + c0 + 4 * q;
      add_quad(tl, scale4(wx * wy, gv), nv, vec_out);
      if (x1_in) add_quad(tl + C, scale4((1.f - wx) * wy, gv), nv, vec_out);
      if (y1_in) add_quad(tl + static_cast<size_t>(W) * C, scale4(wx * (1.f - wy), gv), nv,
                          vec_out);
      if (x1_in && y1_in)
        add_quad(tl + static_cast<size_t>(W + 1) * C, scale4((1.f - wx) * (1.f - wy), gv), nv,
                 vec_out);
    }
    if (COUNT && t == 0) atomicAdd(&routes[1], 1);   // thread 0 has a quad
    return;
  }

  // window route. Hopper has no shared-memory f32 add (a compare-and-swap
  // loop stands in for it), so the window is not summed into in place:
  // the tile's adds are sorted by window pixel (a counting sort with
  // integer shared atomics, which are native), and each (window pixel,
  // quad) sums its own adds in registers and flushes them with one
  // reduction. 1. stage g; count the adds of each window pixel.
  __shared__ Pack<T, 4> g_s[TP * QS];   // the tile's g, pixel-major
  __shared__ int start_s[WINDOW_PIX + 1];   // per window pixel: its adds, then their start
  __shared__ int2 list_s[4 * TP];   // the adds by window pixel: tile pixel, weight as bits
  __shared__ int warp_s[NT / 32];
  for (int i = t; i <= wpix; i += NT) start_s[i] = 0;
#pragma unroll
  for (int k = 0; k < TP / PIX; ++k) g_s[(t / QS + PIX * k) * QS + q] = gk[k];
  __syncthreads();
  const int4 e = corner_s[t];
  const bool x1_in = e.x + 1 < W, y1_in = e.y + 1 < Hs;
  const int tl = (e.y - ylo) * ww + e.x - xlo;
  int slot[4];   // this pixel's adds: their places among their window pixel's
  if (e.y >= 0) {
    slot[0] = atomicAdd(&start_s[tl], 1);
    if (x1_in) slot[1] = atomicAdd(&start_s[tl + 1], 1);
    if (y1_in) slot[2] = atomicAdd(&start_s[tl + ww], 1);
    if (x1_in && y1_in) slot[3] = atomicAdd(&start_s[tl + ww + 1], 1);
  }
  __syncthreads();

  // 2. exclusive scan of the counts: window pixels 2t, 2t+1 a thread, a
  // shuffle scan in each warp, then the totals of the warps before
  const int c_a = 2 * t < wpix ? start_s[2 * t] : 0;
  const int c_b = 2 * t + 1 < wpix ? start_s[2 * t + 1] : 0;
  int incl = c_a + c_b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (t % 32 >= o) incl += v;
  }
  if (t % 32 == 31) warp_s[t / 32] = incl;
  __syncthreads();
  int run = incl - c_a - c_b;
  for (int w = 0; w < t / 32; ++w) run += warp_s[w];
  if (2 * t <= wpix) start_s[2 * t] = run;   // start_s[wpix]: the total
  if (2 * t + 1 <= wpix) start_s[2 * t + 1] = run + c_a;
  if (t == NT - 1 && wpix == 2 * NT) start_s[wpix] = run + c_a + c_b;
  __syncthreads();

  // 3. place the adds, with their weights
  if (e.y >= 0) {
    const float wx = __int_as_float(e.z), wy = __int_as_float(e.w);
    list_s[start_s[tl] + slot[0]] = make_int2(t, __float_as_int(wx * wy));
    if (x1_in) list_s[start_s[tl + 1] + slot[1]] = make_int2(t, __float_as_int((1.f - wx) * wy));
    if (y1_in)
      list_s[start_s[tl + ww] + slot[2]] = make_int2(t, __float_as_int(wx * (1.f - wy)));
    if (x1_in && y1_in)
      list_s[start_s[tl + ww + 1] + slot[3]] =
          make_int2(t, __float_as_int((1.f - wx) * (1.f - wy)));
  }
  __syncthreads();

  // 4. each (window pixel, quad) sums its adds and flushes them: one
  // reduction, none where no pixel adds or the sum is all 0
  if (nv > 0) {
    int wp = t / QS, r = wp / ww, col = wp - r * ww;
    for (; wp < wpix; wp += PIX) {
      const int b0 = start_s[wp], b1 = start_s[wp + 1];
      if (b0 < b1) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int i = b0; i < b1; ++i) {
          const int2 add = list_s[i];
          const float4 gv = to_f32x4(g_s[add.x * QS + q]);
          const float w = __int_as_float(add.y);
          acc = make_float4(fmaf(w, gv.x, acc.x), fmaf(w, gv.y, acc.y), fmaf(w, gv.z, acc.z),
                            fmaf(w, gv.w, acc.w));
        }
        if (acc.x != 0.f || acc.y != 0.f || acc.z != 0.f || acc.w != 0.f)
          add_quad(d_img + (src0 + static_cast<size_t>(ylo + r) * W + xlo + col) * C + c0 +
                       4 * q,
                   acc, nv, vec_out);
      }
      for (col += PIX; col >= ww; col -= ww) ++r;
    }
  }
  if (COUNT && t == 0) {
    atomicAdd(&routes[0], 1);
    atomicAdd(&routes[1], 1);
  }
}

// K4 at C = 3: a block owns a TH3 x TW3 tile, one thread a pixel, and the
// window route sums into at most WINDOW3 window pixels. The f32
// accumulator holds exactly the 3 channels a pixel, so that the zero-fill
// and the cast move no pad; a window flushes whole 16-byte groups of 4
// pixels.
constexpr int TH3 = 8, TW3 = 32;
constexpr int NT3 = TH3 * TW3;
constexpr int WINDOW3 = 2 * NT3;

// adds v (3 channels) at pixel q of the f32 accumulator, where v is not
// all 0: an 8-byte pair and an element, the pair first at an even pixel
// (its address 8-byte aligned), last at an odd one
__device__ __forceinline__ void add_pixel3(float* acc, size_t q, float v0, float v1, float v2) {
  if (v0 == 0.f && v1 == 0.f && v2 == 0.f) return;
  float* dst = acc + q * 3;
  if (q % 2 == 0) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v0, v1));
    atomicAdd(dst + 2, v2);
  } else {
    atomicAdd(dst, v0);
    atomicAdd(reinterpret_cast<float2*>(dst + 1), make_float2(v1, v2));
  }
}

// the window route's flush of its sums (win_s, channel-major; window
// pixel r * ww + col is image pixel (ylo + r, xlo + col), accumulator
// pixel src0 + (ylo + r) * W + xlo + col) by the block's threads: each
// window row is a run of ww accumulator pixels q0 .. q0 + ww - 1, and each
// group of 4 pixels 4k .. 4k + 3 that a run touches (12 floats, 16-byte
// aligned) is flushed as 3 16-byte reductions, 0 for a pixel outside the
// run, none for 4 floats that are all 0; a group that reaches past the
// accumulator's npix pixels, pixel by pixel. Groups are items
// r * per_row + k, thread item % NT3.
__device__ __forceinline__ void flush_window3(float* acc, const float* win_s, size_t src0,
                                              int ylo, int xlo, int ww, int wpix, int W,
                                              size_t npix, int t) {
  const int per_row = (ww + 6) / 4;   // groups a run of ww pixels touches, at most
  const int items = wpix / ww * per_row;
  for (int item = t; item < items; item += NT3) {
    const int r = item / per_row;
    const size_t q0 = src0 + static_cast<size_t>(ylo + r) * W + xlo;
    const size_t gq = (q0 / 4 + (item - r * per_row)) * 4;
    if (gq >= q0 + ww) continue;
    float v[12];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = static_cast<int>(static_cast<long long>(gq + i) - static_cast<long long>(q0));
      const bool in = col >= 0 && col < ww;
#pragma unroll
      for (int c = 0; c < 3; ++c) v[3 * i + c] = in ? win_s[c * WINDOW3 + r * ww + col] : 0.f;
    }
    if (gq + 4 <= npix) {
      float4* dst = reinterpret_cast<float4*>(acc + 3 * gq);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 f = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
        if (f.x != 0.f || f.y != 0.f || f.z != 0.f || f.w != 0.f) atomicAdd(dst + j, f);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (gq + i < npix) add_pixel3(acc, gq + i, v[3 * i], v[3 * i + 1], v[3 * i + 2]);
    }
  }
}

// K4 at C = 3: grid (tiles across W, tiles across H, B). Thread t takes
// pixel (t / TW3, t % TW3) of its block's tile: its flow as a pair, its g
// as a pair and an element (load_pixel3), its four corners and weights.
// window: a block whose corners' bounding box holds at most WINDOW3 pixels
// takes the window route (else, and where window is 0, the direct route).
// d_img: (B, Hs, W, 3) f32, npix = B * Hs * W. flow_pairs: flow is
// pair-aligned. routes (for comparing the routes only, else null): every
// block adds one to routes[1], and one that takes the window route one to
// routes[0].
template <typename T>
__global__ void __launch_bounds__(NT3)
warp_bilinear_dimages_pixels_kernel(const T* __restrict__ flow, const T* __restrict__ g,
                                    float* __restrict__ d_img, int H, int W, int Hs, int y0,
                                    size_t npix, int window, int flow_pairs,
                                    int* __restrict__ routes) {
  __shared__ float win_s[3 * WINDOW3];   // window sums, channel-major
  __shared__ int4 box_s[NT3 / 32];

  const int t = threadIdx.x;
  const int y = blockIdx.y * TH3 + t / TW3, x = blockIdx.x * TW3 + t % TW3;
  const size_t src0 = static_cast<size_t>(blockIdx.z) * Hs * W;
  const bool live = y < H && x < W;
  float gv[3] = {0.f, 0.f, 0.f};
  Corners k{};
  int4 box = make_int4(INT_MAX, -1, INT_MAX, -1);
  if (live) {
    const size_t p = (static_cast<size_t>(blockIdx.z) * H + y) * W + x;
    b2f::load_pixel3(g + 3 * p, gv);
    const float2 f = b2f::flow_at(flow, p, flow_pairs);
    k = b2f::corners_at(f.x, f.y, x, y0 + y, Hs, W);
    box = make_int4(k.y0, k.y1, k.x0, k.x1);
  }
  // the four corners' weights; 0 where a corner is outside the image (and
  // for a thread past the image's edge)
  const float w[4] = {live ? k.wx * k.wy : 0.f, k.x1_in ? (1.f - k.wx) * k.wy : 0.f,
                      k.y1_in ? k.wx * (1.f - k.wy) : 0.f,
                      k.x1_in && k.y1_in ? (1.f - k.wx) * (1.f - k.wy) : 0.f};

  int wpix = INT_MAX, ww = 1;
  if (window) {
    for (int i = t; i < 3 * WINDOW3; i += NT3) win_s[i] = 0.f;
    box.x = __reduce_min_sync(0xffffffffu, box.x);
    box.y = __reduce_max_sync(0xffffffffu, box.y);
    box.z = __reduce_min_sync(0xffffffffu, box.z);
    box.w = __reduce_max_sync(0xffffffffu, box.w);
    if (t % 32 == 0) box_s[t / 32] = box;
    __syncthreads();
    box = box_s[0];
#pragma unroll
    for (int i = 1; i < NT3 / 32; ++i) {
      const int4 o = box_s[i];
      box = make_int4(min(box.x, o.x), max(box.y, o.y), min(box.z, o.z), max(box.w, o.w));
    }
    ww = box.w - box.z + 1;
    wpix = (box.y - box.x + 1) * ww;
  }

  if (wpix > WINDOW3) {
    // direct route: each pixel's four corners, 3 channels each
    if (live) {
      const size_t q = src0 + static_cast<size_t>(k.y0) * W + k.x0;
      add_pixel3(d_img, q, w[0] * gv[0], w[0] * gv[1], w[0] * gv[2]);
      if (k.x1_in) add_pixel3(d_img, q + 1, w[1] * gv[0], w[1] * gv[1], w[1] * gv[2]);
      if (k.y1_in) add_pixel3(d_img, q + W, w[2] * gv[0], w[2] * gv[1], w[2] * gv[2]);
      if (k.x1_in && k.y1_in)
        add_pixel3(d_img, q + W + 1, w[3] * gv[0], w[3] * gv[1], w[3] * gv[2]);
    }
    if (routes != nullptr && t == 0) atomicAdd(&routes[1], 1);
    return;
  }

  // window route: window pixel (r, col) is image pixel (ylo + r, xlo + col);
  // every add into the window with an f32 shared atomic, none that adds 0
  const int ylo = box.x, xlo = box.z;
  const int at[4] = {(k.y0 - ylo) * ww + k.x0 - xlo, (k.y0 - ylo) * ww + k.x0 - xlo + 1,
                     (k.y0 - ylo + 1) * ww + k.x0 - xlo, (k.y0 - ylo + 1) * ww + k.x0 - xlo + 1};
  const bool in[4] = {live, k.x1_in, k.y1_in, k.x1_in && k.y1_in};
  if (live) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v[3] = {w[j] * gv[0], w[j] * gv[1], w[j] * gv[2]};
      if (in[j] && (v[0] != 0.f || v[1] != 0.f || v[2] != 0.f)) {
#pragma unroll
        for (int c = 0; c < 3; ++c) atomicAdd(&win_s[c * WINDOW3 + at[j]], v[c]);
      }
    }
  }
  __syncthreads();
  flush_window3(d_img, win_s, src0, ylo, xlo, ww, wpix, W, npix, t);
  if (routes != nullptr && t == 0) {
    atomicAdd(&routes[0], 1);
    atomicAdd(&routes[1], 1);
  }
}

// W-dflow's plan: threads per block of both kernels
constexpr int NT_FLOW = 128;

// the corners of pixel p = (b, y, x), its flow read as one pair where the
// flow is aligned for it
template <typename T>
__device__ __forceinline__ Corners pair_corners(const T* flow, size_t p, int x, int y, int H,
                                                int W, bool flow_pairs) {
  const float2 f = b2f::flow_at(flow, p, flow_pairs);
  return b2f::corners_at(f.x, f.y, x, y, H, W);
}

// W-dflow for C = 3 (the image warps): one thread per pixel. Each corner
// pair (tl, tr), and (bl, br), is one 6-element span where the +1 column
// is inside the image; the block's g (3 * NT_FLOW contiguous elements) is
// staged through shared memory with 16-byte loads where aligned. The flow,
// the spans and g are all in flight before the block waits for its g.
// flow_pairs: flow and d_flow are pair-aligned.
template <typename T>
__global__ void __launch_bounds__(NT_FLOW)
warp_bilinear_dflow_rows_kernel(const T* __restrict__ img, const T* __restrict__ flow,
                                const T* __restrict__ g, T* __restrict__ d_flow, int H, int W,
                                int Hs, int y0, size_t npix, int flow_pairs,
                                int reference_grads) {
  constexpr int CHUNKS = NT_FLOW * 3 * sizeof(T) / 16;   // a full block's g
  __shared__ uint4 g_raw[CHUNKS];
  T* g_s = reinterpret_cast<T*>(g_raw);
  const int t = threadIdx.x;
  const size_t p0 = static_cast<size_t>(blockIdx.x) * NT_FLOW;
  const int n = static_cast<int>(min(static_cast<size_t>(NT_FLOW), npix - p0));
  const T* src = g + 3 * p0;
  const bool chunked = n == NT_FLOW && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  uint4 chunk;
  if (chunked && t < CHUNKS) chunk = __ldg(reinterpret_cast<const uint4*>(src) + t);

  const size_t p = p0 + min(t, n - 1);
  const int x = static_cast<int>(p % W);
  const int y = static_cast<int>((p / W) % H);
  const size_t b = p / (static_cast<size_t>(H) * W);
  const Corners k = pair_corners(flow, p, x, y0 + y, Hs, W, flow_pairs);
  float top[6], bot[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const T* row0 = img + ((b * Hs + k.y0) * W + k.x0) * 3;
  if (k.x1_in) load_span6(row0, top); else load_span3(row0, top);
  if (k.y1_in) {
    const T* row1 = row0 + static_cast<size_t>(W) * 3;
    if (k.x1_in) load_span6(row1, bot); else load_span3(row1, bot);
  }

  if (chunked) {
    if (t < CHUNKS) g_raw[t] = chunk;
  } else {
    for (int i = t; i < 3 * n; i += NT_FLOW) g_s[i] = src[i];
  }
  __syncthreads();
  if (t >= n) return;
  const float g0 = to_f32(g_s[3 * t]), g1 = to_f32(g_s[3 * t + 1]), g2 = to_f32(g_s[3 * t + 2]);
  const float2 d = b2f::warp_dflow(k, top[0] * g0 + top[1] * g1 + top[2] * g2,
                                   top[3] * g0 + top[4] * g1 + top[5] * g2,
                                   bot[0] * g0 + bot[1] * g1 + bot[2] * g2,
                                   bot[3] * g0 + bot[4] * g1 + bot[5] * g2, reference_grads);
  if (flow_pairs) {
    Pack<T, 2> out;
    out.v[0] = from_f32<T>(d.x);
    out.v[1] = from_f32<T>(d.y);
    *reinterpret_cast<Pack<T, 2>*>(d_flow + 2 * p) = out;
  } else {
    d_flow[2 * p] = from_f32<T>(d.x);
    d_flow[2 * p + 1] = from_f32<T>(d.y);
  }
}

// W-dflow for every other C: G lanes share a pixel. Lane l reads the VEC-
// element packs l, l + G, ... of g and of the four corners, so that one
// load of the group covers G * VEC contiguous elements, and the group sums
// its four dot products with xor-shuffles.
template <typename T, int VEC, int G>
__global__ void __launch_bounds__(NT_FLOW)
warp_bilinear_dflow_lanes_kernel(const T* __restrict__ img, const T* __restrict__ flow,
                                 const T* __restrict__ g, T* __restrict__ d_flow, int H, int W,
                                 int C, int Hs, int y0, size_t npix, int reference_grads) {
  const size_t i = static_cast<size_t>(blockIdx.x) * NT_FLOW + threadIdx.x;
  const int l = threadIdx.x % G;
  const bool live = i / G < npix;   // the whole group, so its shuffles stay converged
  const size_t p = live ? i / G : npix - 1;
  const int x = static_cast<int>(p % W);
  const int y = static_cast<int>((p / W) % H);
  const size_t b = p / (static_cast<size_t>(H) * W);
  const Corners k = warp_corners(flow, p, x, y0 + y, Hs, W);

  const T* base = img + b * Hs * W * C;
  const T* tl_p = base + (static_cast<size_t>(k.y0) * W + k.x0) * C;
  const T* tr_p = base + (static_cast<size_t>(k.y0) * W + k.x1) * C;
  const T* bl_p = base + (static_cast<size_t>(k.y1) * W + k.x0) * C;
  const T* br_p = base + (static_cast<size_t>(k.y1) * W + k.x1) * C;
  const T* gp = g + p * C;
  using P = Pack<T, VEC>;
  float tl = 0.f, tr = 0.f, bl = 0.f, br = 0.f;
  for (int c = l * VEC; c < C; c += G * VEC) {
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
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) {
    tl += __shfl_xor_sync(0xffffffffu, tl, o);
    tr += __shfl_xor_sync(0xffffffffu, tr, o);
    bl += __shfl_xor_sync(0xffffffffu, bl, o);
    br += __shfl_xor_sync(0xffffffffu, br, o);
  }
  if (l != 0 || !live) return;
  const float2 d = b2f::warp_dflow(k, tl, tr, bl, br, reference_grads);
  d_flow[2 * p] = from_f32<T>(d.x);
  d_flow[2 * p + 1] = from_f32<T>(d.y);
}

// K4's routes, as a launch allows them: by its grid (the path's), or
// for comparing the routes only, direct on every block, or the window
// wherever the box fits; each by the kernel of its C (the pixel kernel
// at C = 3, the quad tiles elsewhere). kRouteQuads: the quad tiles by
// their grid at any C, as the path took them at C = 3 before the pixel
// kernel
enum Route { kRouteByGrid = 0, kRouteDirect = 1, kRouteWindow = 2, kRouteQuads = 3 };

// SMs of the current device (0 where it cannot be read)
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// the window route pays where the grid holds 1.5 blocks an SM or more
bool window_pays(long long blocks) {
  const int sms = sm_count();
  return sms > 0 && 2 * blocks >= 3LL * sms;
}

// and at C = 3, where the grid holds half a block an SM or more: the
// direct route adds 2 reductions a corner into the exact accumulator, so
// the window pays on smaller grids than the quad tiles' (on an H100, from
// the 8x40x80 image warps of SPyNet's pme step up; measured per level on
// the step's own inputs, `chip_smoke.py --k4-c3`)
bool pixels_window_pays(long long blocks) {
  const int sms = sm_count();
  return sms > 0 && 2 * blocks >= sms;
}

template <typename T, bool COUNT>
cudaError_t launch_dimages(const void* flow, const void* g, float* d_img, int B, int H, int W,
                           int C, int Hs, int y0, int route, int* routes, cudaStream_t stream) {
  const int slices = (C + CS - 1) / CS;
  const long long z = static_cast<long long>(B) * slices;
  const int tiles_y = (H + TH - 1) / TH;
  if (z > 65535 || tiles_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, tiles_y, static_cast<unsigned>(z));
  const bool window = route == kRouteWindow ||
                      (route == kRouteByGrid &&
                       window_pays(static_cast<long long>(grid.x) * grid.y * z));
  const bool vec_in = C % 4 == 0 && reinterpret_cast<uintptr_t>(g) % (4 * sizeof(T)) == 0;
  const auto kernel = vec_in ? (window ? warp_bilinear_dimages_tiled_kernel<T, 4, true, COUNT>
                                       : warp_bilinear_dimages_tiled_kernel<T, 4, false, COUNT>)
                             : (window ? warp_bilinear_dimages_tiled_kernel<T, 1, true, COUNT>
                                       : warp_bilinear_dimages_tiled_kernel<T, 1, false, COUNT>);
  const int vec_out = C % 4 == 0 && reinterpret_cast<uintptr_t>(d_img) % 16 == 0;
  kernel<<<grid, NT, 0, stream>>>(static_cast<const T*>(flow), static_cast<const T*>(g), d_img,
                                  H, W, C, Hs, y0, slices, vec_out, routes);
  return cudaGetLastError();
}

// K4 at C = 3 into a 16-byte aligned accumulator. window: 1 the window
// route wherever the box fits, 0 direct on every block, -1 as
// pixels_window_pays allows it
template <typename T>
cudaError_t launch_pixels(const void* flow, const void* g, float* d_img, int B, int H, int W,
                          int Hs, int y0, int window, int* routes, cudaStream_t stream) {
  const int tiles_y = (H + TH3 - 1) / TH3;
  if (B > 65535 || tiles_y > 65535 || reinterpret_cast<uintptr_t>(d_img) % 16 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((W + TW3 - 1) / TW3, tiles_y, B);
  if (window < 0) window = pixels_window_pays(static_cast<long long>(grid.x) * grid.y * B);
  const int flow_pairs = reinterpret_cast<uintptr_t>(flow) % (2 * sizeof(T)) == 0;
  warp_bilinear_dimages_pixels_kernel<T><<<grid, NT3, 0, stream>>>(
      static_cast<const T*>(flow), static_cast<const T*>(g), d_img, H, W, Hs, y0,
      static_cast<size_t>(B) * Hs * W, window, flow_pairs, routes);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_route(const void* flow, const void* g, float* out, int B, int H, int W, int C,
                         int Hs, int y0, int route, int* routes, cudaStream_t s) {
  if (C == 3 && route != kRouteQuads) {
    const int window = route == kRouteByGrid ? -1 : route == kRouteWindow;
    return launch_pixels<T>(flow, g, out, B, H, W, Hs, y0, window, routes, s);
  }
  const int quads = route == kRouteQuads ? kRouteByGrid : route;
  return routes != nullptr
             ? launch_dimages<T, true>(flow, g, out, B, H, W, C, Hs, y0, quads, routes, s)
             : launch_dimages<T, false>(flow, g, out, B, H, W, C, Hs, y0, quads, routes, s);
}

int dimages(const void* flow, const void* g, void* d_img, int dtype, int B, int H, int W, int C,
            int Hs, int y0, int route, int* routes, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Hs <= 0 || y0 < 0 || y0 + H > Hs ||
      route < kRouteByGrid || route > kRouteQuads)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(d_img);
  switch (dtype) {
    case b2f::kFloat32:
      return launch_route<float>(flow, g, out, B, H, W, C, Hs, y0, route, routes, s);
    case b2f::kBFloat16:
      return launch_route<__nv_bfloat16>(flow, g, out, B, H, W, C, Hs, y0, route, routes, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// W-dflow's launch: the rows kernel for C = 3; else lane groups of 8
// where the channels hold 8 packs, of 4 below
template <typename T, int VEC, int G>
cudaError_t launch_lanes(const T* img, const T* flow, const T* g, T* d_flow, int H, int W,
                         int C, int Hs, int y0, size_t npix, int reference_grads,
                         cudaStream_t stream) {
  const size_t blocks = (npix * G + NT_FLOW - 1) / NT_FLOW;
  warp_bilinear_dflow_lanes_kernel<T, VEC, G><<<static_cast<unsigned>(blocks), NT_FLOW, 0,
                                                stream>>>(img, flow, g, d_flow, H, W, C, Hs, y0,
                                                          npix, reference_grads);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dflow(const void* img_, const void* flow_, const void* g_, void* d_flow_,
                         int B, int H, int W, int C, int Hs, int y0, int reference_grads,
                         cudaStream_t stream) {
  const T* img = static_cast<const T*>(img_);
  const T* flow = static_cast<const T*>(flow_);
  const T* g = static_cast<const T*>(g_);
  T* d_flow = static_cast<T*>(d_flow_);
  const size_t npix = static_cast<size_t>(B) * H * W;
  if (C == 3) {
    const auto pair_aligned = [](const void* a) {
      return reinterpret_cast<uintptr_t>(a) % (2 * sizeof(T)) == 0;
    };
    const size_t blocks = (npix + NT_FLOW - 1) / NT_FLOW;
    warp_bilinear_dflow_rows_kernel<T><<<static_cast<unsigned>(blocks), NT_FLOW, 0, stream>>>(
        img, flow, g, d_flow, H, W, Hs, y0, npix, pair_aligned(flow) && pair_aligned(d_flow),
        reference_grads);
    return cudaGetLastError();
  }
  constexpr int VEC = 16 / sizeof(T);
  if (C % VEC == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(g) % 16 == 0) {
    return C / VEC >= 8
               ? launch_lanes<T, VEC, 8>(img, flow, g, d_flow, H, W, C, Hs, y0, npix,
                                         reference_grads, stream)
               : launch_lanes<T, VEC, 4>(img, flow, g, d_flow, H, W, C, Hs, y0, npix,
                                         reference_grads, stream);
  }
  return launch_lanes<T, 1, 4>(img, flow, g, d_flow, H, W, C, Hs, y0, npix, reference_grads,
                               stream);
}

// the kernel that b2f_warp_bwd_tiled_info reports
template <typename T>
const void* kernel_of(int kernel) {
  switch (kernel) {
    case 0:
      return reinterpret_cast<const void*>(warp_bilinear_dimages_tiled_kernel<T, 4, true, false>);
    case 3:
      return reinterpret_cast<const void*>(
          warp_bilinear_dimages_tiled_kernel<T, 4, false, false>);
    case 1: return reinterpret_cast<const void*>(warp_bilinear_dflow_rows_kernel<T>);
    case 2:
      return reinterpret_cast<const void*>(
          warp_bilinear_dflow_lanes_kernel<T, 16 / sizeof(T), 4>);
    case 4: return reinterpret_cast<const void*>(warp_bilinear_dimages_pixels_kernel<T>);
    default: return nullptr;
  }
}

}  // namespace

// K4. flow: (B, H, W, 2) and g: (B, H, W, C), contiguous and of `dtype`
// (b2f::DType); d_img: (B, H_src, W, C) f32, zeroed by the caller, to which
// the image gradient is ADDED; at C = 3 16-byte aligned. The row window as in
// b2f_warp_bilinear_fwd: output row y is source row y0 + y (y0 = 0, H =
// H_src: the whole image). Launches on `stream`, returns
// cudaGetLastError().
extern "C" int b2f_warp_bilinear_dimages(const void* flow, const void* g, void* d_img,
                                         int dtype, int B, int H, int W, int C, int H_src,
                                         int y0, void* stream) {
  return dimages(flow, g, d_img, dtype, B, H, W, C, H_src, y0, kRouteByGrid, nullptr, stream);
}

// The same for comparing K4's routes (Route); routes: null, or 2 device
// ints zeroed by the caller, to which the blocks that took the window
// route and all blocks are added.
extern "C" int b2f_warp_bilinear_dimages_routes(const void* flow, const void* g, void* d_img,
                                                int dtype, int B, int H, int W, int C, int H_src,
                                                int y0, int route, void* routes, void* stream) {
  return dimages(flow, g, d_img, dtype, B, H, W, C, H_src, y0, route, static_cast<int*>(routes),
                 stream);
}

// W-dflow. img: (B, H_src, W, C), flow: (B, H, W, 2), g: (B, H, W, C),
// d_flow: (B, H, W, 2), all contiguous and of `dtype`; the row window as in
// b2f_warp_bilinear_fwd. reference_grads: 1 for the reference formula, 0
// for the autodiff gradient (zeroed where the coordinate clamps). Launches
// on `stream`, returns cudaGetLastError().
extern "C" int b2f_warp_bilinear_dflow(const void* img, const void* flow, const void* g,
                                       void* d_flow, int dtype, int B, int H, int W, int C,
                                       int H_src, int y0, int reference_grads, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H_src <= 0 || y0 < 0 || y0 + H > H_src)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case b2f::kFloat32:
      return launch_dflow<float>(img, flow, g, d_flow, B, H, W, C, H_src, y0, reference_grads,
                                 s);
    case b2f::kBFloat16:
      return launch_dflow<__nv_bfloat16>(img, flow, g, d_flow, B, H, W, C, H_src, y0,
                                         reference_grads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// What the compiler and the runtime made of the kernels, in f32 (dtype
// 0) or bf16 (1): kernel 0 K4 with 4-channel packs and the window route,
// 1 W-dflow's C = 3 rows, 2 W-dflow's lane groups of 4 with 16-byte
// packs, 3 K4 with 4-channel packs, direct on every block, 4 K4's C = 3
// pixel kernel. Registers and local memory (bytes, spills) per thread,
// static shared memory per block (bytes), resident blocks per SM.
// Launches nothing.
extern "C" int b2f_warp_bwd_tiled_info(int kernel, int dtype, int* regs, int* local_bytes,
                                       int* smem, int* blocks_per_sm) {
  const void* fn = dtype == b2f::kBFloat16 ? kernel_of<__nv_bfloat16>(kernel)
                                           : kernel_of<float>(kernel);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, kernel == 1 || kernel == 2 ? NT_FLOW : kernel == 4 ? NT3 : NT, 0);
}
