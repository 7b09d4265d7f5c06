// Fused feature-pyramid stem: one ConvUnit (conv 3x3 stride 2 + leaky 0.2,
// conv 3x3 stride 1 + leaky 0.2, padding 1 on each side) per launch.
//
// Replaces back2future_tpu/ops/stem_pallas.py `_unit_a_kernel` (unit A,
// level 2: 3 -> 16 -> 16 channels) and `_unit_b_kernel` (unit B, level 3:
// 16 -> 32 -> 32), the Pallas TPU kernels behind `fused_stem`. NHWC:
//
//   mid[b,y,x,m] = round(leaky(b1[m] + sum_{ky,kx,c} x[b,2y+ky-1,2x+kx-1,c] w1[ky,kx,c,m]))
//   out[b,y,x,o] = round(leaky(b2[o] + sum_{ky,kx,m} mid[b,y+ky-1,x+kx-1,m] w2[ky,kx,m,o]))
//
// with input pixels outside the image and mid pixels outside the mid map
// counted as 0 (the padding of each conv). Sums are f32; `round` is to the
// storage type, so the mid map is rounded once, as in the unfused chain.
// Weights (HWIO) and biases come from the wrapper in f32, already rounded
// to the compute type.
//
// What bounds it on the H100: at the serving shape (48 x 320 x 1216 x 3 in)
// unit A moves 261.5 MB and does 25.6 GFLOP, unit B 224.1 MB and 32.3
// GFLOP, so on the tensor cores both are memory-bound (78 and 67 us at
// 3.35 TB/s); on the f32 CUDA cores (67 TFLOP/s) the FLOPs take 381 and
// 482 us, so this kernel, which uses the CUDA cores, is compute-bound.
//
// Design: one block per (image, TH x TW tile of the output). The block
// stages the input region the tile needs, (2(TH+2)+1) x (2(TW+2)+1) x Cin,
// in shared memory as planes of the storage type (one plane per channel,
// so a warp's neighbouring columns hit different banks), with the first
// conv's weights in f32. It computes the haloed (TH+2) x (TW+2) x Cmid mid
// tile into shared memory (one mid pixel per thread, Cmid f32
// accumulators), then reuses the input region for the second conv's
// weights and computes the tile (one output pixel per thread, Cout
// accumulators). The mid map never goes to device memory. Each weight is
// read by all lanes of a warp at one address (a broadcast), four output
// channels per load. The TPU kernels' block-Toeplitz lift onto 128-lane
// blocks and whole-image VMEM slabs are not carried over.
//
// Which kernel runs which type: f32 runs this kernel for both units; bf16
// runs on the tensor cores, unit A in stem_unit_a_mma.cu and unit B in
// stem_unit_b_mma.cu. `b2f_stem_unit_a_cuda_cores` runs this kernel for
// unit A in both types, to time the old bf16 design beside the new one.
#include "common.cuh"

namespace b2f {
// stem_unit_a_mma.cu: unit A (K5) in bf16
cudaError_t stem_unit_a_mma(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, int N, int H, int W, cudaStream_t stream);
// stem_unit_b_mma.cu: unit B (K6) in bf16
cudaError_t stem_unit_b_mma(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, int N, int H, int W, cudaStream_t stream);
}  // namespace b2f

namespace {

using b2f::from_f32;
using b2f::Pack;
using b2f::to_f32;

constexpr int TH = 8;                  // output tile rows
constexpr int TW = 32;                 // output tile columns
constexpr int NT = TH * TW;            // threads per block
constexpr int MH = TH + 2, MW = TW + 2;              // haloed mid tile
constexpr int IH = 2 * MH + 1, IW = 2 * MW + 1;      // input region

constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

template <typename T, int CIN, int CMID, int COUT>
struct Smem {
  static constexpr size_t in = align16(sizeof(T) * CIN * IH * IW);
  static constexpr size_t w1 = align16(sizeof(float) * 9 * CIN * CMID);
  static constexpr size_t w2 = align16(sizeof(float) * 9 * CMID * COUT);
  // the input and w1 are dead once the mid tile is written: w2 reuses them
  static constexpr size_t region = (in + w1 > w2) ? in + w1 : w2;
  static constexpr size_t mid = align16(sizeof(T) * CMID * MH * MW);
  static constexpr size_t bytes = region + mid + sizeof(float) * (CMID + COUT);
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.2f * v; }

// copy n floats (n a multiple of 4, both pointers 16-byte aligned)
__device__ __forceinline__ void copy_f32(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += NT)
    reinterpret_cast<float4*>(dst)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
}

template <typename T, int CIN, int CMID, int COUT>
__global__ void __launch_bounds__(NT)
stem_unit_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, T* __restrict__ out, int H, int W,
                 int Ho, int Wo) {
  using S = Smem<T, CIN, CMID, COUT>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* in_s = reinterpret_cast<T*>(smem);                      // [CIN][IH][IW]
  float* w1_s = reinterpret_cast<float*>(smem + S::in);      // [9][CIN][CMID]
  float* w2_s = reinterpret_cast<float*>(smem);              // [9][CMID][COUT], later
  T* mid_s = reinterpret_cast<T*>(smem + S::region);         // [CMID][MH][MW]
  float* b1_s = reinterpret_cast<float*>(smem + S::region + S::mid);
  float* b2_s = b1_s + CMID;

  const int t = threadIdx.x;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int iy0 = 2 * (oy0 - 1) - 1, ix0 = 2 * (ox0 - 1) - 1;   // input region origin
  const T* xb = x + static_cast<size_t>(blockIdx.z) * H * W * CIN;

  // stage: element e = (region pixel, channel), channel fastest, so a
  // region row is one contiguous read; outside the image -> 0
  for (int e = t; e < IH * IW * CIN; e += NT) {
    const int p = e / CIN, c = e % CIN;
    const int r = p / IW, col = p % IW;
    const int gy = iy0 + r, gx = ix0 + col;
    T v = from_f32<T>(0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = xb[(static_cast<size_t>(gy) * W + gx) * CIN + c];
    in_s[(c * IH + r) * IW + col] = v;
  }
  copy_f32(w1_s, w1, 9 * CIN * CMID);
  for (int i = t; i < CMID; i += NT) b1_s[i] = b1[i];
  for (int i = t; i < COUT; i += NT) b2_s[i] = b2[i];
  __syncthreads();

  // conv 1 (stride 2): mid pixel (my, mx) of the haloed tile is mid-map
  // pixel (oy0 - 1 + my, ox0 - 1 + mx); its taps sit at region (2my+ky, 2mx+kx)
  for (int p = t; p < MH * MW; p += NT) {
    const int my = p / MW, mx = p % MW;
    const int gy = oy0 - 1 + my, gx = ox0 - 1 + mx;
    if (gy < 0 || gy >= Ho || gx < 0 || gx >= Wo) {   // the second conv's padding
#pragma unroll
      for (int m = 0; m < CMID; ++m) mid_s[(m * MH + my) * MW + mx] = from_f32<T>(0.f);
      continue;
    }
    float acc[CMID];
#pragma unroll
    for (int m = 0; m < CMID; ++m) acc[m] = b1_s[m];
#pragma unroll 1
    for (int k = 0; k < 9; ++k) {
      const T* src = in_s + (2 * my + k / 3) * IW + 2 * mx + k % 3;
      const float* w = w1_s + k * CIN * CMID;
#pragma unroll
      for (int c = 0; c < CIN; ++c) {
        const float v = to_f32(src[c * IH * IW]);
#pragma unroll
        for (int m = 0; m < CMID; m += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(w + c * CMID + m);
          acc[m] = fmaf(v, wv.x, acc[m]);
          acc[m + 1] = fmaf(v, wv.y, acc[m + 1]);
          acc[m + 2] = fmaf(v, wv.z, acc[m + 2]);
          acc[m + 3] = fmaf(v, wv.w, acc[m + 3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < CMID; ++m) mid_s[(m * MH + my) * MW + mx] = from_f32<T>(leaky(acc[m]));
  }
  __syncthreads();
  copy_f32(w2_s, w2, 9 * CMID * COUT);
  __syncthreads();

  // conv 2 (stride 1): output pixel (ty, tx) reads mid (ty+ky, tx+kx)
  const int ty = t / TW, tx = t % TW;
  const int oy = oy0 + ty, ox = ox0 + tx;
  if (oy >= Ho || ox >= Wo) return;
  float acc[COUT];
#pragma unroll
  for (int o = 0; o < COUT; ++o) acc[o] = b2_s[o];
#pragma unroll 1
  for (int k = 0; k < 9; ++k) {
    const T* src = mid_s + (ty + k / 3) * MW + tx + k % 3;
    const float* w = w2_s + k * CMID * COUT;
#pragma unroll
    for (int m = 0; m < CMID; ++m) {
      const float v = to_f32(src[m * MH * MW]);
#pragma unroll
      for (int o = 0; o < COUT; o += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(w + m * COUT + o);
        acc[o] = fmaf(v, wv.x, acc[o]);
        acc[o + 1] = fmaf(v, wv.y, acc[o + 1]);
        acc[o + 2] = fmaf(v, wv.z, acc[o + 2]);
        acc[o + 3] = fmaf(v, wv.w, acc[o + 3]);
      }
    }
  }
  // one pixel's COUT channels are contiguous: 16-byte stores
  constexpr int VEC = 16 / sizeof(T);
  static_assert(COUT % VEC == 0, "COUT must fill whole 16-byte packs");
  Pack<T, VEC>* o = reinterpret_cast<Pack<T, VEC>*>(
      out + ((static_cast<size_t>(blockIdx.z) * Ho + oy) * Wo + ox) * COUT);
#pragma unroll
  for (int j = 0; j < COUT / VEC; ++j) {
    Pack<T, VEC> pk;
#pragma unroll
    for (int i = 0; i < VEC; ++i) pk.v[i] = from_f32<T>(leaky(acc[j * VEC + i]));
    o[j] = pk;
  }
}

template <typename T, int CIN, int CMID, int COUT>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int N, int H, int W, cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const size_t smem = Smem<T, CIN, CMID, COUT>::bytes;
  auto kernel = stem_unit_kernel<T, CIN, CMID, COUT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, N);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<T*>(out), H, W,
      Ho, Wo);
  return cudaGetLastError();
}

// bf16 on the tensor cores unless `cuda_cores`
template <int CIN, int CMID, int COUT>
cudaError_t dispatch(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, void* out, int dtype, int N, int H, int W, void* stream,
                     bool cuda_cores = false) {
  if (N <= 0 || H <= 0 || W <= 0 || N > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case b2f::kFloat32:
      return launch<float, CIN, CMID, COUT>(x, w1, b1, w2, b2, out, N, H, W, s);
    case b2f::kBFloat16:
      if (cuda_cores)
        return launch<__nv_bfloat16, CIN, CMID, COUT>(x, w1, b1, w2, b2, out, N, H, W, s);
      if constexpr (CIN == 3)   // K5
        return b2f::stem_unit_a_mma(x, w1, b1, w2, b2, out, N, H, W, s);
      else   // K6
        return b2f::stem_unit_b_mma(x, w1, b1, w2, b2, out, N, H, W, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (N, H, W, Cin) contiguous of `dtype` (b2f::DType); w1: (3, 3, Cin,
// Cmid) f32; b1: (Cmid) f32; w2: (3, 3, Cmid, Cout) f32; b2: (Cout) f32,
// all contiguous and 16-byte aligned; out: (N, ceil(H/2), ceil(W/2), Cout)
// of `dtype`. Launches on `stream` and returns cudaGetLastError().

// unit A (K5): Cin 3, Cmid 16, Cout 16
extern "C" int b2f_stem_unit_a(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int dtype, int N, int H, int W,
                               void* stream) {
  return dispatch<3, 16, 16>(x, w1, b1, w2, b2, out, dtype, N, H, W, stream);
}

// unit A on this file's CUDA-core kernel in both types: the old bf16
// design, kept to be timed beside the tensor-core kernel. Nothing on the
// serving or training path calls it.
extern "C" int b2f_stem_unit_a_cuda_cores(const void* x, const void* w1, const void* b1,
                                          const void* w2, const void* b2, void* out, int dtype,
                                          int N, int H, int W, void* stream) {
  return dispatch<3, 16, 16>(x, w1, b1, w2, b2, out, dtype, N, H, W, stream, true);
}

// unit B (K6): Cin 16, Cmid 32, Cout 32
extern "C" int b2f_stem_unit_b(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, int dtype, int N, int H, int W,
                               void* stream) {
  return dispatch<16, 32, 32>(x, w1, b1, w2, b2, out, dtype, N, H, W, stream);
}
