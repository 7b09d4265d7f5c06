// Multi-frame cost volume, forward: one frame term of the volume.
//
// Replaces back2future_tpu/ops/cost_volume_pallas.py `_fwd_kernel` (the
// Pallas TPU kernel behind `cost_volume_pallas`, dispatched from
// back2future_tpu/ops/cost_volume.py). It computes, NHWC,
//
//   out[b,y,x,q] = scale * sum_c ref[b,y,x,c] * frame[b, y-qy(q), x-qx(q), c]
//
// over the win*win displacements q, enumerated qx outer / qy inner,
// dilated by `dilation` and mirrored when !FWD; frame pixels outside the
// image count as 0. Inputs and output are f32 or bf16; sums are f32.
//
// What bounds it on the H100: each output costs 2*C FLOP against one
// 2-byte write, and every frame value is reused by win*win outputs, so
// device memory is not the limit. The inner loop does one shared-memory
// load per FMA, so shared-memory bandwidth (32 words per clock per SM,
// a quarter of the FP32 FMA rate) bounds it.
//
// Design: one block per (batch element, TH x TW pixel tile). The ref tile
// and the frame tile with its (win-1)/2*dilation halo are staged in
// shared memory, CK channels at a time, as f32 channel planes, so a
// warp's 32 lanes (32 neighbouring pixels of one row) read 32
// consecutive words: no bank conflicts. Each thread owns one pixel and
// all win*win displacements, with the accumulators in registers (win is a
// template parameter so the accumulator array is fully unrolled). The
// TPU kernel's whole-image VMEM slab and sequential grid are not carried
// over: blocks are independent and each loads only its own haloed tile.
//
// bf16 does not use this kernel on the main path: `b2f_cost_volume_fwd`
// sends it to the tensor cores (cost_volume_fwd_mma.cu). f32 stays here.
// `b2f_cost_volume_fwd_cuda_cores` runs this kernel in both types, to
// compare the two designs on the card.
#include "common.cuh"

namespace b2f {
// cost_volume_fwd_mma.cu: K1 in bf16
cudaError_t cost_volume_fwd_mma(const void* ref, const void* frame, void* out, int B, int H,
                                int W, int C, int win, int dil, int fwd, float scale,
                                cudaStream_t stream);
}  // namespace b2f

namespace {

using b2f::from_f32;
using b2f::to_f32;

constexpr int TH = 8;         // tile rows
constexpr int TW = 32;        // tile columns: one warp per row
constexpr int NT = TH * TW;   // threads per block, one per pixel
constexpr int CK = 8;         // channels staged per pass

template <typename T, int WIN, bool FWD>
__global__ void __launch_bounds__(NT)
cost_volume_fwd_kernel(const T* __restrict__ ref, const T* __restrict__ frame,
                       T* __restrict__ out, int H, int W, int C, int dil,
                       float scale) {
  constexpr int N = (WIN - 1) / 2;
  constexpr int Q = WIN * WIN;
  constexpr int SIGN = FWD ? 1 : -1;
  const int pad = N * dil;
  const int hw = TW + 2 * pad;            // haloed tile width
  const int hsz = (TH + 2 * pad) * hw;    // haloed tile size

  extern __shared__ float smem[];
  float* ref_s = smem;                    // [CK][NT]
  float* frm_s = smem + CK * NT;          // [CK][hsz]

  const int t = threadIdx.x;
  const int ty = t / TW, tx = t % TW;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t plane = static_cast<size_t>(H) * W * C;
  const T* refb = ref + blockIdx.z * plane;
  const T* frmb = frame + blockIdx.z * plane;

  float acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    // stage: element e = (pixel, channel), channel fastest so a pixel's
    // CK channels are one contiguous read; out-of-range entries are 0
    for (int e = t; e < NT * CK; e += NT) {
      const int p = e / CK, c = e % CK;
      const int py = y0 + p / TW, px = x0 + p % TW;
      float v = 0.f;
      if (c0 + c < C && py < H && px < W)
        v = to_f32(refb[(static_cast<size_t>(py) * W + px) * C + c0 + c]);
      ref_s[c * NT + p] = v;
    }
    for (int e = t; e < hsz * CK; e += NT) {
      const int p = e / CK, c = e % CK;
      const int py = y0 - pad + p / hw, px = x0 - pad + p % hw;
      float v = 0.f;
      if (c0 + c < C && py >= 0 && py < H && px >= 0 && px < W)
        v = to_f32(frmb[(static_cast<size_t>(py) * W + px) * C + c0 + c]);
      frm_s[c * hsz + p] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < CK; ++c) {
      const float r = ref_s[c * NT + t];
      // frame value for displacement (qy, qx) sits at halo-local
      // (ty + pad - qy, tx + pad - qx)
      const float* f = frm_s + c * hsz + ty * hw + tx;
#pragma unroll
      for (int ix = 0; ix < WIN; ++ix) {
        const int dx = pad - SIGN * (ix - N) * dil;
#pragma unroll
        for (int iy = 0; iy < WIN; ++iy) {
          const int dy = pad - SIGN * (iy - N) * dil;
          acc[ix * WIN + iy] = fmaf(r, f[dy * hw + dx], acc[ix * WIN + iy]);
        }
      }
    }
    __syncthreads();
  }

  const int y = y0 + ty, x = x0 + tx;
  if (y < H && x < W) {
    T* o = out + ((static_cast<size_t>(blockIdx.z) * H + y) * W + x) * Q;
#pragma unroll
    for (int q = 0; q < Q; ++q) o[q] = from_f32<T>(acc[q] * scale);
  }
}

template <typename T, int WIN, bool FWD>
cudaError_t launch(const void* ref, const void* frame, void* out, int B, int H,
                   int W, int C, int dil, float scale, cudaStream_t stream) {
  const int pad = (WIN - 1) / 2 * dil;
  const size_t smem =
      sizeof(float) * CK * (NT + static_cast<size_t>(TH + 2 * pad) * (TW + 2 * pad));
  auto kernel = cost_volume_fwd_kernel<T, WIN, FWD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const T*>(ref),
                                     static_cast<const T*>(frame),
                                     static_cast<T*>(out), H, W, C, dil, scale);
  return cudaGetLastError();
}

template <typename T, int WIN>
cudaError_t dispatch_dir(const void* ref, const void* frame, void* out, int B,
                         int H, int W, int C, int dil, int fwd, float scale,
                         cudaStream_t s) {
  return fwd ? launch<T, WIN, true>(ref, frame, out, B, H, W, C, dil, scale, s)
             : launch<T, WIN, false>(ref, frame, out, B, H, W, C, dil, scale, s);
}

template <typename T>
cudaError_t dispatch_win(const void* ref, const void* frame, void* out, int B,
                         int H, int W, int C, int win, int dil, int fwd,
                         float scale, cudaStream_t s) {
  switch (win) {
    case 3: return dispatch_dir<T, 3>(ref, frame, out, B, H, W, C, dil, fwd, scale, s);
    case 5: return dispatch_dir<T, 5>(ref, frame, out, B, H, W, C, dil, fwd, scale, s);
    case 7: return dispatch_dir<T, 7>(ref, frame, out, B, H, W, C, dil, fwd, scale, s);
    case 9: return dispatch_dir<T, 9>(ref, frame, out, B, H, W, C, dil, fwd, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_shape(int B, int H, int W, int C, int dilation) {
  return B > 0 && H > 0 && W > 0 && C > 0 && dilation >= 1;
}

}  // namespace

// ref, frame: (B, H, W, C) contiguous; out: (B, H, W, win*win) contiguous,
// all of `dtype` (b2f::DType). win in {3, 5, 7, 9}, dilation >= 1.
// Launches on `stream` and returns cudaGetLastError(). f32 on the CUDA
// cores (this file), bf16 on the tensor cores (cost_volume_fwd_mma.cu).
extern "C" int b2f_cost_volume_fwd(const void* ref, const void* frame, void* out,
                                   int dtype, int B, int H, int W, int C, int win,
                                   int dilation, int fwd, float scale, void* stream) {
  if (!valid_shape(B, H, W, C, dilation)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case b2f::kFloat32:
      return dispatch_win<float>(ref, frame, out, B, H, W, C, win, dilation, fwd, scale, s);
    case b2f::kBFloat16:
      return b2f::cost_volume_fwd_mma(ref, frame, out, B, H, W, C, win, dilation, fwd, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The same function on this file's CUDA-core kernel in both types: the
// old bf16 design, kept to be timed beside the tensor-core kernel. Nothing
// on the serving or training path calls it.
extern "C" int b2f_cost_volume_fwd_cuda_cores(const void* ref, const void* frame, void* out,
                                              int dtype, int B, int H, int W, int C, int win,
                                              int dilation, int fwd, float scale,
                                              void* stream) {
  if (!valid_shape(B, H, W, C, dilation)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case b2f::kFloat32:
      return dispatch_win<float>(ref, frame, out, B, H, W, C, win, dilation, fwd, scale, s);
    case b2f::kBFloat16:
      return dispatch_win<__nv_bfloat16>(ref, frame, out, B, H, W, C, win, dilation, fwd,
                                         scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
