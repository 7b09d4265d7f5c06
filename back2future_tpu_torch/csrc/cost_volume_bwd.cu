// Multi-frame cost volume, backward: the two transposes of one frame term,
// on the CUDA cores. Since the bf16 kernels moved to the tensor cores
// (cost_volume_bwd_mma.cu), this file serves f32 on the main path, and
// both types only through the `_cuda_cores` entry points, which time the
// old bf16 design beside the new one.
//
// Replaces back2future_tpu/ops/cost_volume_pallas.py `_dref_kernel` (K2)
// and `_dframe_kernel` (K3), the Pallas TPU kernels of `_cv_bwd_rule`.
// With the forward out[b,y,x,q] = scale * sum_c ref[b,y,x,c] *
// frame[b, y-qy, x-qx, c] (cost_volume_fwd.cu), NHWC:
//
//   d_ref[b,y,x,c]   = scale * sum_q g[b,y,x,q]       * frame[b, y-qy, x-qx, c]
//   d_frame[b,y,x,c] = scale * sum_q g[b,y+qy,x+qx,q] * ref[b, y+qy, x+qx, c]
//
// over the win*win displacements q (qx outer, qy inner, dilated by
// `dilation`, mirrored when !FWD); pixels outside the image count as 0.
// Inputs and outputs are f32 or bf16; sums are f32, rounded once.
//
// What bounds them on the H100: like the forward, 2 FLOP per multiply-add
// against one shared-memory load of a staged value, and every staged value
// is reused by win*win outputs; so shared-memory bandwidth, not device
// memory, is the limit.
//
// Design: one block per (batch element, TH x TW pixel tile, CK-channel
// chunk); each thread owns one pixel and CK channels, with CK f32
// accumulators in registers. Splitting the channels over blocks keeps the
// coarse levels (5x10 pixels) from running a handful of blocks. The
// channel-strided tile (the haloed frame tile for d_ref, the haloed ref
// tile for d_frame) is staged once as f32 channel planes whose stride is
// padded so the staging stores are conflict-free; a warp's 32 lanes (32
// neighbouring pixels of one row) then read 32 consecutive words.
//   d_ref  : a pixel needs only its own g row, read from global memory
//            (L1) into registers one displacement column (win values)
//            at a time.
//   d_frame: a gather, not a scatter: each frame pixel sums over the
//            win*win ref pixels it was paired with, so it is
//            deterministic. The haloed g planes it reads (81 f32 planes
//            of a 16x40 halo at win 9 would be 207 KB) are staged one
//            displacement column (win planes) at a time.
// The TPU kernels' whole-image VMEM slabs and sequential grid are not
// carried over: blocks are independent and each loads only its own tile.
#include "common.cuh"

namespace {

using b2f::from_f32;
using b2f::to_f32;

constexpr int TH = 8;         // tile rows
constexpr int TW = 32;        // tile columns: one warp per row
constexpr int NT = TH * TW;   // threads per block, one per pixel
constexpr int CK = 16;        // channels per block

// plane stride of the staged tiles: staging stores cover 32/CK pixels x
// CK channels per warp, so a stride = 32/CK (mod 32) puts them in 32
// distinct banks
__host__ __device__ inline int plane_stride(int hsz) {
  return (hsz + 31) / 32 * 32 + 32 / CK;
}

// Stage CK channels [c0, c0+CK) of the (TH+2pad) x (TW+2pad) haloed tile
// of `src` (batch element already applied) as f32 planes; 0 outside.
template <typename T>
__device__ void stage_halo(const T* __restrict__ src, float* dst, int y0, int x0,
                           int pad, int hw, int hsz, int stride, int H, int W,
                           int C, int c0) {
  for (int e = threadIdx.x; e < hsz * CK; e += NT) {
    const int p = e / CK, c = e % CK;
    const int py = y0 - pad + p / hw, px = x0 - pad + p % hw;
    float v = 0.f;
    if (c0 + c < C && py >= 0 && py < H && px >= 0 && px < W)
      v = to_f32(src[(static_cast<size_t>(py) * W + px) * C + c0 + c]);
    dst[c * stride + p] = v;
  }
}

template <typename T>
__device__ void store_chunk(T* __restrict__ out, const float* acc, int b, int y,
                            int x, int H, int W, int C, int c0, float scale) {
  if (y >= H || x >= W) return;
  T* o = out + ((static_cast<size_t>(b) * H + y) * W + x) * C + c0;
#pragma unroll
  for (int k = 0; k < CK; ++k)
    if (c0 + k < C) o[k] = from_f32<T>(acc[k] * scale);
}

template <typename T, int WIN, bool FWD>
__global__ void __launch_bounds__(NT)
cost_volume_dref_kernel(const T* __restrict__ g, const T* __restrict__ frame,
                        T* __restrict__ d_ref, int H, int W, int C, int dil,
                        float scale) {
  constexpr int N = (WIN - 1) / 2;
  constexpr int Q = WIN * WIN;
  constexpr int SIGN = FWD ? 1 : -1;
  const int pad = N * dil;
  const int hw = TW + 2 * pad;
  const int hsz = (TH + 2 * pad) * hw;
  const int stride = plane_stride(hsz);

  extern __shared__ float frm_s[];        // [CK][stride]

  const int t = threadIdx.x;
  const int ty = t / TW, tx = t % TW;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int nck = (C + CK - 1) / CK;
  const int b = blockIdx.z / nck, c0 = (blockIdx.z % nck) * CK;
  const size_t plane = static_cast<size_t>(H) * W * C;
  const int y = y0 + ty, x = x0 + tx;
  const bool inside = y < H && x < W;
  const T* grow = g + ((static_cast<size_t>(b) * H + (inside ? y : 0)) * W +
                       (inside ? x : 0)) * Q;

  stage_halo(frame + b * plane, frm_s, y0, x0, pad, hw, hsz, stride, H, W, C, c0);
  __syncthreads();

  float acc[CK];
#pragma unroll
  for (int k = 0; k < CK; ++k) acc[k] = 0.f;

#pragma unroll 1
  for (int ix = 0; ix < WIN; ++ix) {
    float gv[WIN];
#pragma unroll
    for (int iy = 0; iy < WIN; ++iy) gv[iy] = inside ? to_f32(grow[ix * WIN + iy]) : 0.f;
    // frame value for displacement (qy, qx) sits at halo-local
    // (ty + pad - qy, tx + pad - qx)
    const int dx = pad - SIGN * (ix - N) * dil;
#pragma unroll
    for (int iy = 0; iy < WIN; ++iy) {
      const int dy = pad - SIGN * (iy - N) * dil;
      const float* f = frm_s + (ty + dy) * hw + tx + dx;
#pragma unroll
      for (int k = 0; k < CK; ++k) acc[k] = fmaf(gv[iy], f[k * stride], acc[k]);
    }
  }
  store_chunk(d_ref, acc, b, y, x, H, W, C, c0, scale);
}

template <typename T, int WIN, bool FWD>
__global__ void __launch_bounds__(NT)
cost_volume_dframe_kernel(const T* __restrict__ g, const T* __restrict__ ref,
                          T* __restrict__ d_frame, int H, int W, int C, int dil,
                          float scale) {
  constexpr int N = (WIN - 1) / 2;
  constexpr int Q = WIN * WIN;
  constexpr int SIGN = FWD ? 1 : -1;
  const int pad = N * dil;
  const int hw = TW + 2 * pad;
  const int hsz = (TH + 2 * pad) * hw;
  const int stride = plane_stride(hsz);

  extern __shared__ float smem[];
  float* ref_s = smem;                    // [CK][stride]
  float* g_s = smem + CK * stride;        // [WIN][stride]: one displacement column

  const int t = threadIdx.x;
  const int ty = t / TW, tx = t % TW;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int nck = (C + CK - 1) / CK;
  const int b = blockIdx.z / nck, c0 = (blockIdx.z % nck) * CK;
  const size_t plane = static_cast<size_t>(H) * W * C;
  const T* gb = g + static_cast<size_t>(b) * H * W * Q;

  stage_halo(ref + b * plane, ref_s, y0, x0, pad, hw, hsz, stride, H, W, C, c0);

  float acc[CK];
#pragma unroll
  for (int k = 0; k < CK; ++k) acc[k] = 0.f;

#pragma unroll 1
  for (int ix = 0; ix < WIN; ++ix) {
    __syncthreads();   // the previous column's planes are consumed
    for (int e = t; e < hsz * WIN; e += NT) {
      const int p = e / WIN, iy = e % WIN;
      const int py = y0 - pad + p / hw, px = x0 - pad + p % hw;
      float v = 0.f;
      if (py >= 0 && py < H && px >= 0 && px < W)
        v = to_f32(gb[(static_cast<size_t>(py) * W + px) * Q + ix * WIN + iy]);
      g_s[iy * stride + p] = v;
    }
    __syncthreads();
    // g and ref for displacement (qy, qx) both sit at halo-local
    // (ty + pad + qy, tx + pad + qx)
    const int dx = pad + SIGN * (ix - N) * dil;
#pragma unroll
    for (int iy = 0; iy < WIN; ++iy) {
      const int dy = pad + SIGN * (iy - N) * dil;
      const int off = (ty + dy) * hw + tx + dx;
      const float gq = g_s[iy * stride + off];
#pragma unroll
      for (int k = 0; k < CK; ++k) acc[k] = fmaf(gq, ref_s[k * stride + off], acc[k]);
    }
  }
  store_chunk(d_frame, acc, b, y0 + ty, x0 + tx, H, W, C, c0, scale);
}

// which transpose a launch computes
enum Which { kDRef, kDFrame };

template <typename T, int WIN, bool FWD>
cudaError_t launch(Which which, const void* g, const void* other, void* out, int B,
                   int H, int W, int C, int dil, float scale, cudaStream_t stream) {
  const int pad = (WIN - 1) / 2 * dil;
  const int stride = plane_stride((TH + 2 * pad) * (TW + 2 * pad));
  const size_t planes = which == kDRef ? CK : CK + WIN;
  const size_t smem = sizeof(float) * planes * stride;
  void (*kernel)(const T*, const T*, T*, int, int, int, int, float) =
      which == kDRef ? &cost_volume_dref_kernel<T, WIN, FWD>
                     : &cost_volume_dframe_kernel<T, WIN, FWD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int nck = (C + CK - 1) / CK;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * nck);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const T*>(g),
                                     static_cast<const T*>(other),
                                     static_cast<T*>(out), H, W, C, dil, scale);
  return cudaGetLastError();
}

template <typename T, int WIN>
cudaError_t dispatch_dir(Which which, const void* g, const void* other, void* out,
                         int B, int H, int W, int C, int dil, int fwd, float scale,
                         cudaStream_t s) {
  return fwd ? launch<T, WIN, true>(which, g, other, out, B, H, W, C, dil, scale, s)
             : launch<T, WIN, false>(which, g, other, out, B, H, W, C, dil, scale, s);
}

template <typename T>
cudaError_t dispatch_win(Which which, const void* g, const void* other, void* out,
                         int B, int H, int W, int C, int win, int dil, int fwd,
                         float scale, cudaStream_t s) {
  switch (win) {
    case 3: return dispatch_dir<T, 3>(which, g, other, out, B, H, W, C, dil, fwd, scale, s);
    case 5: return dispatch_dir<T, 5>(which, g, other, out, B, H, W, C, dil, fwd, scale, s);
    case 7: return dispatch_dir<T, 7>(which, g, other, out, B, H, W, C, dil, fwd, scale, s);
    case 9: return dispatch_dir<T, 9>(which, g, other, out, B, H, W, C, dil, fwd, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

int entry(Which which, const void* g, const void* other, void* out, int dtype, int B,
          int H, int W, int C, int win, int dilation, int fwd, float scale,
          void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || dilation < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case b2f::kFloat32:
      return dispatch_win<float>(which, g, other, out, B, H, W, C, win, dilation, fwd,
                                 scale, s);
    case b2f::kBFloat16:
      return dispatch_win<__nv_bfloat16>(which, g, other, out, B, H, W, C, win,
                                         dilation, fwd, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace b2f {
// cost_volume_bwd_mma.cu: K2 (dframe 0) and K3 (dframe 1) in bf16 on the
// tensor cores
cudaError_t cost_volume_bwd_mma(const void* g, const void* other, void* out, int B, int H, int W,
                                int C, int win, int dil, int fwd, float scale, int dframe,
                                cudaStream_t stream);
}  // namespace b2f

namespace {

bool valid_shape(int B, int H, int W, int C, int dilation) {
  return B > 0 && H > 0 && W > 0 && C > 0 && dilation >= 1;
}

// bf16 on the tensor cores, f32 on this file's CUDA-core kernels
int entry_main(Which which, const void* g, const void* other, void* out, int dtype, int B, int H,
               int W, int C, int win, int dilation, int fwd, float scale, void* stream) {
  if (dtype != b2f::kBFloat16)
    return dtype == b2f::kFloat32 ? entry(which, g, other, out, dtype, B, H, W, C, win,
                                          dilation, fwd, scale, stream)
                                  : cudaErrorInvalidValue;
  if (!valid_shape(B, H, W, C, dilation)) return cudaErrorInvalidValue;
  return b2f::cost_volume_bwd_mma(g, other, out, B, H, W, C, win, dilation, fwd, scale,
                                  which == kDFrame, static_cast<cudaStream_t>(stream));
}

}  // namespace

// g: (B, H, W, win*win); frame, d_ref: (B, H, W, C); all contiguous and of
// `dtype` (b2f::DType). win in {3, 5, 7, 9}, dilation >= 1. Launches on
// `stream` and returns cudaGetLastError(). f32 on this file's CUDA-core
// kernel, bf16 on the tensor cores (cost_volume_bwd_mma.cu).
extern "C" int b2f_cost_volume_dref(const void* g, const void* frame, void* d_ref,
                                    int dtype, int B, int H, int W, int C, int win,
                                    int dilation, int fwd, float scale, void* stream) {
  return entry_main(kDRef, g, frame, d_ref, dtype, B, H, W, C, win, dilation, fwd, scale,
                    stream);
}

// g: (B, H, W, win*win); ref, d_frame: (B, H, W, C); as b2f_cost_volume_dref.
extern "C" int b2f_cost_volume_dframe(const void* g, const void* ref, void* d_frame,
                                      int dtype, int B, int H, int W, int C, int win,
                                      int dilation, int fwd, float scale, void* stream) {
  return entry_main(kDFrame, g, ref, d_frame, dtype, B, H, W, C, win, dilation, fwd, scale,
                    stream);
}

// The two transposes on this file's CUDA-core kernels in both types: the
// old bf16 design, kept to be timed beside the
// tensor-core kernels. Nothing on the serving or training path calls them.
extern "C" int b2f_cost_volume_dref_cuda_cores(const void* g, const void* frame, void* d_ref,
                                               int dtype, int B, int H, int W, int C, int win,
                                               int dilation, int fwd, float scale, void* stream) {
  return entry(kDRef, g, frame, d_ref, dtype, B, H, W, C, win, dilation, fwd, scale, stream);
}

extern "C" int b2f_cost_volume_dframe_cuda_cores(const void* g, const void* ref, void* d_frame,
                                                 int dtype, int B, int H, int W, int C, int win,
                                                 int dilation, int fwd, float scale,
                                                 void* stream) {
  return entry(kDFrame, g, ref, d_frame, dtype, B, H, W, C, win, dilation, fwd, scale, stream);
}
