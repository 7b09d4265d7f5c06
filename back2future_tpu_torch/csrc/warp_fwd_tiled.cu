// Bilinear warp with pixel-offset flow, forward, designed for Hopper.
//
// Replaces the XLA quad gather of back2future_tpu/ops/warp.py
// (`_corners` + `_gather_corners` + `_warp_forward`). The semantics and the
// arithmetic are those of warp_fwd.cu, which keeps the first design
// callable for comparison only (b2f_warp_bilinear_fwd_thread): for output
// pixel (b, y, x), with warp_corners.cuh's f32 corners and weights,
//
//   out = wx*wy*I[y0,x0] + (1-wx)*wy*I[y0,x1] + wx*(1-wy)*I[y1,x0]
//         + (1-wx)*(1-wy)*I[y1,x1]
//
// summed in f32 and rounded once; a +1 corner past the image is clamped
// into it and read with weight exactly 0.
//
// What bounds it on the H100: device memory, at about a FLOP a byte. Each
// input byte is read once from device memory at best (the corners of
// neighbouring pixels overlap, so most gathers hit L1 or L2), and each
// output byte written once. The first design ran one thread per output
// pixel and walked C in 16-byte packs: at C = 32 bf16 a warp's load lay
// 64 bytes a lane apart (16 lines touched where 4 would do) and each store
// wrote half-sectors over 2 KB; C was a runtime bound, so the pack loop did
// not unroll and few loads were in flight; at C = 3 it made 12 2-byte
// loads a pixel. Here both kernels walk the pixels in a grid-stride loop
// over a persistent grid (the blocks every SM holds at once), the pixel's
// coordinates advancing by the grid's stride without a division:
//  - lanes kernel (every C but 3): a group of G lanes shares a pixel, and
//    lane l reads packs l, l + G, ... (16 bytes each where C and the
//    pointers allow it) of each of the four corners. One load of a group
//    covers G packs of a corner row in one contiguous segment, and the
//    warp's stores cover its 32 / G consecutive pixels whole. At the
//    model's widths (bf16 C = 32, 64, 96, 128; f32 16..128) the packs per
//    pixel are a template parameter, G * PPL, so all 4 * PPL loads of a
//    lane are issued together; any other C walks its packs in a loop.
//  - rows kernel (C = 3, the image warps): one thread per pixel. Each
//    corner pair (tl, tr), and (bl, br), is read as one 6-element span
//    where the +1 column is inside the image (warp_corners.cuh's
//    load_span6, as W-dflow's rows kernel: 3 pair loads, or 4 loads where
//    the span starts at an odd element), so 6-8 loads a pixel instead of
//    12, and its 3 outputs are stored where they go.
// Measured on the same inputs against variants of this design
// (`chip_smoke.py --gather-variants`, PERF.md): loading the next pixel's
// flow ahead of the current pixel's corners, staging the C = 3 output in
// shared memory for 16-byte stores, reading the C = 3 spans as the 16-byte
// chunks that hold them, and one pass of a full grid were each slower on
// the train step's and the serving forward's own inputs; reading the
// spans as aligned 32-bit words was no faster. None of them is here.
#include <algorithm>
#include <climits>
#include <cstring>

#include "warp_corners.cuh"

namespace {

using b2f::Corners;
using b2f::flow_at;
using b2f::from_f32;
using b2f::Pack;
using b2f::to_f32;

// threads per block of the lanes kernel and of the rows kernel
constexpr int NT = 256;
constexpr int NT_ROWS = 128;

// VEC elements at p through the read-only path, as one load
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> ldg_pack(const T* p) {
  using P = Pack<T, VEC>;
  P r;
  if constexpr (sizeof(P) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&r, &u, 16);
  } else if constexpr (sizeof(P) == 4) {
    const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
    memcpy(&r, &u, 4);
  } else {
    static_assert(sizeof(P) == 2, "16-byte packs or single elements");
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
    memcpy(&r, &u, 2);
  }
  return r;
}

// a grid's stride in pixels, with its parts s % W, (s / W) % H and
// s / (H * W), which the host computes
struct Stride {
  size_t s, sb;
  int sx, sy;
};

Stride stride_of(size_t s, int H, int W) {
  return {s, s / (static_cast<size_t>(H) * W), static_cast<int>(s % W),
          static_cast<int>((s / W) % H)};
}

// the output pixel a thread is at, (b, y, x) of its index p, stepped by
// the grid's stride without a division: x + sx < 2W and y + 1 + sy < 2H,
// so one carry each. The first pixel is split by 32-bit divisions where
// the pixels' indices fit in 32 bits (`narrow`).
struct Walk {
  size_t p, b;
  int x, y;

  __device__ __forceinline__ Walk(size_t p0, int H, int W, bool narrow) : p(p0) {
    size_t r;   // the row of p over all images
    if (narrow) {
      const unsigned q = static_cast<unsigned>(p0), rq = q / W;
      r = rq;
      x = static_cast<int>(q - rq * W);
      b = rq / H;
    } else {
      r = p0 / W;
      x = static_cast<int>(p0 - r * W);
      b = r / H;
    }
    y = static_cast<int>(r - b * H);
  }

  __device__ __forceinline__ void step(const Stride& s, int H, int W) {
    p += s.s;
    x += s.sx;
    if (x >= W) { x -= W; ++y; }
    y += s.sy;
    if (y >= H) { y -= H; ++b; }
    b += s.sb;
  }
};

// the four corner weights of a pixel, in the order tl, tr, bl, br
struct Weights {
  float tl, tr, bl, br;
};

__device__ __forceinline__ Weights weights_of(const Corners& k) {
  return {k.wx * k.wy, (1.f - k.wx) * k.wy, k.wx * (1.f - k.wy), (1.f - k.wx) * (1.f - k.wy)};
}

__device__ __forceinline__ float blend(const Weights& w, float tl, float tr, float bl, float br) {
  return w.tl * tl + w.tr * tr + w.bl * bl + w.br * br;
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> blend_packs(const Weights& w, const Pack<T, VEC>& a,
                                                    const Pack<T, VEC>& b,
                                                    const Pack<T, VEC>& c,
                                                    const Pack<T, VEC>& d) {
  Pack<T, VEC> r;
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    r.v[e] = from_f32<T>(blend(w, to_f32(a.v[e]), to_f32(b.v[e]), to_f32(c.v[e]),
                               to_f32(d.v[e])));
  return r;
}

// lanes kernel: G lanes a pixel, PPL packs of VEC elements a lane (C = G *
// PPL * VEC), or with PPL = 0 any C, lane l walking packs l, l + G, ...
// flow_pairs: the flow is aligned for pair loads.
template <typename T, int VEC, int G, int PPL>
__global__ void __launch_bounds__(NT)
warp_bilinear_fwd_lanes_kernel(const T* __restrict__ img, const T* __restrict__ flow,
                               T* __restrict__ out, int H, int W, int C, int Hs, int y0,
                               size_t npix, Stride stride, int flow_pairs) {
  using P = Pack<T, VEC>;
  constexpr int GROUPS = NT / G;   // pixels a block takes at once
  const int l = threadIdx.x % G;
  const size_t p0 = static_cast<size_t>(blockIdx.x) * GROUPS + threadIdx.x / G;
  if (p0 >= npix) return;
  const size_t plane = static_cast<size_t>(Hs) * W * C;
  for (Walk at(p0, H, W, npix <= UINT_MAX); at.p < npix; at.step(stride, H, W)) {
    const float2 f = flow_at(flow, at.p, flow_pairs);
    const Corners k = b2f::corners_at(f.x, f.y, at.x, y0 + at.y, Hs, W);
    const Weights w = weights_of(k);
    const T* tl = img + at.b * plane + (static_cast<size_t>(k.y0) * W + k.x0) * C;
    const size_t dx = static_cast<size_t>(k.x1 - k.x0) * C;
    const size_t dy = static_cast<size_t>(k.y1 - k.y0) * W * C;
    T* o = out + at.p * C;
    if constexpr (PPL > 0) {
      P a[PPL], b[PPL], c[PPL], d[PPL];
#pragma unroll
      for (int j = 0; j < PPL; ++j) {
        const int e = (l + G * j) * VEC;
        a[j] = ldg_pack<T, VEC>(tl + e);
        b[j] = ldg_pack<T, VEC>(tl + dx + e);
        c[j] = ldg_pack<T, VEC>(tl + dy + e);
        d[j] = ldg_pack<T, VEC>(tl + dy + dx + e);
      }
#pragma unroll
      for (int j = 0; j < PPL; ++j)
        *reinterpret_cast<P*>(o + (l + G * j) * VEC) = blend_packs(w, a[j], b[j], c[j], d[j]);
    } else {
      for (int e = l * VEC; e < C; e += G * VEC) {
        const P a = ldg_pack<T, VEC>(tl + e), b = ldg_pack<T, VEC>(tl + dx + e);
        const P c = ldg_pack<T, VEC>(tl + dy + e), d = ldg_pack<T, VEC>(tl + dy + dx + e);
        *reinterpret_cast<P*>(o + e) = blend_packs(w, a, b, c, d);
      }
    }
  }
}

// rows kernel, C = 3: one thread a pixel; a clamped +1 corner repeats the
// corner it was clamped to (read with weight 0), as the twin's clamped
// index does
template <typename T>
__global__ void __launch_bounds__(NT_ROWS)
warp_bilinear_fwd_rows_kernel(const T* __restrict__ img, const T* __restrict__ flow,
                              T* __restrict__ out, int H, int W, int Hs, int y0, size_t npix,
                              Stride stride, int flow_pairs) {
  const size_t p0 = static_cast<size_t>(blockIdx.x) * NT_ROWS + threadIdx.x;
  for (Walk at(p0, H, W, npix <= UINT_MAX); at.p < npix; at.step(stride, H, W)) {
    const float2 f = flow_at(flow, at.p, flow_pairs);
    const Corners k = b2f::corners_at(f.x, f.y, at.x, y0 + at.y, Hs, W);
    const Weights w = weights_of(k);
    float top[6], bot[6];   // tl then tr; bl then br
    const T* row0 = img + ((at.b * Hs + k.y0) * W + k.x0) * 3;
    if (k.x1_in) {
      b2f::load_span6(row0, top);
    } else {
      b2f::load_span3(row0, top);
      top[3] = top[0]; top[4] = top[1]; top[5] = top[2];
    }
    if (k.y1_in) {
      const T* row1 = row0 + static_cast<size_t>(W) * 3;
      if (k.x1_in) {
        b2f::load_span6(row1, bot);
      } else {
        b2f::load_span3(row1, bot);
        bot[3] = bot[0]; bot[4] = bot[1]; bot[5] = bot[2];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 6; ++e) bot[e] = top[e];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[3 * at.p + c] = from_f32<T>(blend(w, top[c], top[3 + c], bot[c], bot[3 + c]));
  }
}

// the blocks of a persistent grid for `needed` blocks of `threads`: as
// many as the card's SMs hold at once, fewer where the work needs fewer
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, size_t needed, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (e != cudaSuccess) return e;
  *grid = static_cast<unsigned>(
      std::min(needed, static_cast<size_t>(sms) * static_cast<size_t>(std::max(per_sm, 1))));
  return cudaSuccess;
}

template <typename T, int VEC, int G, int PPL>
cudaError_t launch_lanes(const T* img, const T* flow, T* out, int H, int W, int C, int Hs, int y0,
                         size_t npix, int flow_pairs, cudaStream_t stream) {
  const auto kernel = warp_bilinear_fwd_lanes_kernel<T, VEC, G, PPL>;
  unsigned grid = 0;
  const cudaError_t e = persistent_grid(kernel, NT, (npix + NT / G - 1) / (NT / G), &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, NT, 0, stream>>>(img, flow, out, H, W, C, Hs, y0, npix,
                                  stride_of(static_cast<size_t>(grid) * (NT / G), H, W),
                                  flow_pairs);
  return cudaGetLastError();
}

// the lane plan of C channels in packs of VEC (C % VEC == 0, pointers
// aligned for the packs): G lanes a pixel, PPL packs a lane, at the packs
// per pixel of the table; any other count loops in groups of 4
template <typename T, int VEC>
cudaError_t launch_packed(const T* img, const T* flow, T* out, int H, int W, int C, int Hs,
                          int y0, size_t npix, int flow_pairs, cudaStream_t s) {
  switch (C / VEC) {
    case 4: return launch_lanes<T, VEC, 4, 1>(img, flow, out, H, W, C, Hs, y0, npix, flow_pairs, s);
    case 8: return launch_lanes<T, VEC, 8, 1>(img, flow, out, H, W, C, Hs, y0, npix, flow_pairs, s);
    case 12: return launch_lanes<T, VEC, 4, 3>(img, flow, out, H, W, C, Hs, y0, npix, flow_pairs, s);
    case 16: return launch_lanes<T, VEC, 8, 2>(img, flow, out, H, W, C, Hs, y0, npix, flow_pairs, s);
    case 24: return launch_lanes<T, VEC, 8, 3>(img, flow, out, H, W, C, Hs, y0, npix, flow_pairs, s);
    case 32: return launch_lanes<T, VEC, 8, 4>(img, flow, out, H, W, C, Hs, y0, npix, flow_pairs, s);
    default: return launch_lanes<T, VEC, 4, 0>(img, flow, out, H, W, C, Hs, y0, npix, flow_pairs, s);
  }
}

template <typename T>
cudaError_t launch(const void* img_, const void* flow_, void* out_, int B, int H, int W, int C,
                   int Hs, int y0, cudaStream_t stream) {
  const T* img = static_cast<const T*>(img_);
  const T* flow = static_cast<const T*>(flow_);
  T* out = static_cast<T*>(out_);
  const size_t npix = static_cast<size_t>(B) * H * W;
  const int flow_pairs = reinterpret_cast<uintptr_t>(flow) % (2 * sizeof(T)) == 0;
  if (C == 3) {
    const auto kernel = warp_bilinear_fwd_rows_kernel<T>;
    unsigned grid = 0;
    const cudaError_t e = persistent_grid(kernel, NT_ROWS, (npix + NT_ROWS - 1) / NT_ROWS, &grid);
    if (e != cudaSuccess) return e;
    kernel<<<grid, NT_ROWS, 0, stream>>>(img, flow, out, H, W, Hs, y0, npix,
                                         stride_of(static_cast<size_t>(grid) * NT_ROWS, H, W),
                                         flow_pairs);
    return cudaGetLastError();
  }
  constexpr int VEC = 16 / sizeof(T);
  if (C % VEC == 0 &&
      (reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(out)) % 16 == 0)
    return launch_packed<T, VEC>(img, flow, out, H, W, C, Hs, y0, npix, flow_pairs, stream);
  return launch_lanes<T, 1, 4, 0>(img, flow, out, H, W, C, Hs, y0, npix, flow_pairs, stream);
}

// the kernel that b2f_warp_fwd_tiled_info reports: 0 the rows kernel
// (C = 3), 1-4 the lanes kernel at C = 32, 64, 96, 128 with 16-byte
// packs, 5 with single elements (any C)
template <typename T>
const void* kernel_of(int kernel) {
  constexpr int VEC = 16 / sizeof(T);
  switch (kernel) {
    case 0: return reinterpret_cast<const void*>(warp_bilinear_fwd_rows_kernel<T>);
    case 1:
      return VEC == 8 ? reinterpret_cast<const void*>(warp_bilinear_fwd_lanes_kernel<T, VEC, 4, 1>)
                      : reinterpret_cast<const void*>(warp_bilinear_fwd_lanes_kernel<T, VEC, 8, 1>);
    case 2:
      return VEC == 8 ? reinterpret_cast<const void*>(warp_bilinear_fwd_lanes_kernel<T, VEC, 8, 1>)
                      : reinterpret_cast<const void*>(warp_bilinear_fwd_lanes_kernel<T, VEC, 8, 2>);
    case 3:
      return VEC == 8 ? reinterpret_cast<const void*>(warp_bilinear_fwd_lanes_kernel<T, VEC, 4, 3>)
                      : reinterpret_cast<const void*>(warp_bilinear_fwd_lanes_kernel<T, VEC, 8, 3>);
    case 4:
      return VEC == 8 ? reinterpret_cast<const void*>(warp_bilinear_fwd_lanes_kernel<T, VEC, 8, 2>)
                      : reinterpret_cast<const void*>(warp_bilinear_fwd_lanes_kernel<T, VEC, 8, 4>);
    case 5: return reinterpret_cast<const void*>(warp_bilinear_fwd_lanes_kernel<T, 1, 4, 0>);
    default: return nullptr;
  }
}

}  // namespace

// img: (B, H_src, W, C), flow: (B, H, W, 2), out: (B, H, W, C), all
// contiguous and of `dtype` (b2f::DType). The row window: output row y is
// source row y0 + y, so its coordinate is (y0 + y) + v in f32 (an exact
// integer plus the flow, as in a launch over the whole image), and the
// clamp and the +1 corners' mask use H_src; y0 = 0 and H = H_src is the
// whole image. Launches on `stream`, returns cudaGetLastError().
extern "C" int b2f_warp_bilinear_fwd(const void* img, const void* flow, void* out, int dtype,
                                     int B, int H, int W, int C, int H_src, int y0,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H_src <= 0 || y0 < 0 || y0 + H > H_src)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case b2f::kFloat32: return launch<float>(img, flow, out, B, H, W, C, H_src, y0, s);
    case b2f::kBFloat16: return launch<__nv_bfloat16>(img, flow, out, B, H, W, C, H_src, y0, s);
    default: return cudaErrorInvalidValue;
  }
}

// What the compiler and the runtime made of a kernel (kernel_of), in f32
// (dtype 0) or bf16 (1): registers and local memory (bytes, spills) per
// thread, static shared memory per block (bytes), resident blocks per SM.
// Launches nothing.
extern "C" int b2f_warp_fwd_tiled_info(int kernel, int dtype, int* regs, int* local_bytes,
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
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                       kernel == 0 ? NT_ROWS : NT, 0);
}
