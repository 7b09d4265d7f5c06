// Unit B of the fused stem (K6) in bf16, on the tensor cores: one
// ConvUnit 16 -> 32 -> 32 (conv 3x3 stride 2 + leaky 0.2, conv 3x3 stride 1
// + leaky 0.2, padding 1 on each side), NHWC,
//
//   mid[b,y,x,m] = bf16(leaky(b1[m] + sum_{ky,kx,c} x[b,2y+ky-1,2x+kx-1,c] w1[ky,kx,c,m]))
//   out[b,y,x,o] = bf16(leaky(b2[o] + sum_{ky,kx,m} mid[b,y+ky-1,x+kx-1,m] w2[ky,kx,m,o]))
//
// with input pixels outside the image and mid pixels outside the mid map
// counted as 0, sums in f32. Replaces back2future_tpu/ops/stem_pallas.py
// `_unit_b_kernel` (the `pallas_call` at stem_pallas.py:307) for bf16; the
// f32 instantiation stays on the CUDA-core kernel of stem_fwd.cu, since f32
// on the tensor cores would be TF32.
//
// What bounds it on the H100: at the serving shape (48 x 160 x 608 x 16 in)
// it moves 224.1 MB (67 us at 3.35 TB/s) and does 32.3 GFLOP (33 us at the
// dense bf16 rate of 989 TFLOP/s), so it is bound by bytes once its
// products run on the tensor cores; on the f32 CUDA cores (the kernel of
// stem_fwd.cu) the FLOPs alone take 482 us.
//
// Design: blocks of 8 warps, two per SM, each walking over 8 x 32 output
// tiles (persistent: the grid is two blocks per SM).
// - Staging (`stage_input`, `stage_weights`): the haloed input region,
//   21 x 69 pixels x 16 channels, goes to shared memory in NHWC order (a
//   pixel is 32 bytes, two 16-byte chunks) by `cp.async.cg` 16-byte copies
//   straight from device memory, a region row being one contiguous
//   2208-byte run; pixels outside the image are zero-filled (source size
//   0). The next tile's copies are issued as soon as conv 1 is done with
//   the region, so they fly while conv 2 and the output run. Once per
//   block, the weights arrive in f32 HWIO and are converted (exactly:
//   they are already rounded to bf16) into bf16 B operands laid out
//   [tap][cout][cin], K contiguous, so a plain `ldmatrix` gives `mma`'s
//   `.col` fragments.
// - Conv 1 (`conv1`): an implicit GEMM with M = the 340 pixels of the
//   haloed 10 x 34 mid tile (22 m16 tiles over the 8 warps), N = 32 (four
//   n8 tiles), K = 9 taps x 16 channels, one k16 step per tap, on
//   `mma.sync.m16n8k16` bf16 -> f32. Each lane of an `ldmatrix.x4` points
//   at the input pixel (2my+ky, 2mx+kx) of its A row: the gather of the
//   implicit GEMM, with no im2col buffer. The epilogue adds the bias,
//   applies leaky, rounds to bf16 and writes the mid tile (10 x 34 x 32,
//   NHWC) to shared memory, zero outside the mid map. The mid map never
//   goes to device memory.
// - Conv 2 (`conv2`): each warp takes one output row (32 pixels, two m16
//   tiles x four n8 tiles, 32 f32 accumulators per lane), K = 9 taps x 32
//   channels (18 k16 steps), A by `ldmatrix.x4` from the mid tile.
// - Output (`stage_output`, `store_output`): bias, leaky, bf16, staged
//   through the mid tile's region once conv 2 is done with it, and written
//   back with 16-byte stores, a warp storing 512 contiguous bytes (8
//   pixels of 64 bytes); ragged edges masked.
// - Bank conflicts: the rows of one 8 x 8 `ldmatrix` matrix sit 64 bytes
//   apart (stride-2 input pixels in conv 1, 64-byte mid pixels and w2 rows
//   in conv 2), which would put them on 2 of the 8 16-byte bank groups.
//   Every array is addressed in 16-byte chunks through `swz`, which XORs
//   the chunk's slot within its 128-byte line with the line index mod 4,
//   so any 8 rows 32 or 64 bytes apart land in 8 distinct bank groups.
// - 96.1 KB of dynamic shared memory per block: two blocks per SM.
#include <climits>

#include "common.cuh"

namespace {

constexpr int CIN = 16, CMID = 32, COUT = 32;
constexpr int TH = 8;                              // output tile rows (one per warp)
constexpr int TW = 32;                             // output tile columns
constexpr int WARPS = TH;
constexpr int NT = 32 * WARPS;                     // threads per block
constexpr int MH = TH + 2, MW = TW + 2;            // haloed mid tile
constexpr int MPIX = MH * MW;                      // 340 mid pixels
constexpr int MTILES1 = (MPIX + 15) / 16;          // 22 m16 tiles of conv 1
constexpr int IH = 2 * MH + 1, IW = 2 * MW + 1;    // 21 x 69 input region

constexpr int align128(int n) { return (n + 127) / 128 * 128; }

// shared memory, bytes; every array starts on a 128-byte line for `swz`
constexpr int IN_BYTES = align128(IH * IW * CIN * 2);   // input region
constexpr int MID_BYTES = align128(MPIX * CMID * 2);     // mid tile; later the output tile
constexpr int W1_BYTES = 9 * CMID * CIN * 2;
constexpr int W2_BYTES = 9 * COUT * CMID * 2;
constexpr int OFF_MID = IN_BYTES;
constexpr int OFF_W1 = OFF_MID + MID_BYTES;
constexpr int OFF_W2 = OFF_W1 + W1_BYTES;
constexpr int OFF_BIAS = OFF_W2 + W2_BYTES;
constexpr int SMEM_BYTES = OFF_BIAS + 4 * (CMID + COUT);
static_assert(TH * TW * COUT * 2 <= MID_BYTES, "the output tile must fit the mid tile's region");
static_assert(W1_BYTES % 128 == 0 && W2_BYTES % 128 == 0, "arrays must stay 128-byte aligned");

// 16-byte chunk index -> its place: slot (0..7) within the 128-byte line
// XORed with the line index mod 4
__device__ __forceinline__ int swz(int chunk) { return chunk ^ ((chunk >> 3) & 3); }

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.2f * v; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the B fragments of the four n8 tiles (32 output channels) of one k16
// step: rows n of `w` (a [n][k] array of `chunks_per_row` 16-byte chunks
// per row), chunks `k0` and `k0 + 1`
__device__ __forceinline__ void load_b(uint32_t (&b)[4][2], uint32_t w, int row0,
                                       int chunks_per_row, int k0, int lane) {
  const int j = lane >> 3, r = lane & 7;   // this lane's matrix and row in it
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int n = (2 * g + (j >> 1)) * 8 + r;
    uint32_t v[4];
    ldmatrix_x4(v, w + 16 * swz((row0 + n) * chunks_per_row + k0 + (j & 1)));
    b[2 * g][0] = v[0];
    b[2 * g][1] = v[1];
    b[2 * g + 1][0] = v[2];
    b[2 * g + 1][1] = v[3];
  }
}

// the haloed input region of the tile, NHWC, by cp.async (not yet waited for)
__device__ __forceinline__ void stage_input(uint32_t in_s, const __nv_bfloat16* __restrict__ xb,
                                            int iy0, int ix0, int H, int W) {
  for (int e = threadIdx.x; e < IH * IW * 2; e += NT) {
    const int q = e >> 1, r = q / IW, col = q - r * IW;
    const int gy = iy0 + r, gx = ix0 + col;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const __nv_bfloat16* src =
        inside ? xb + (static_cast<size_t>(gy) * W + gx) * CIN + (e & 1) * 8 : xb;
    cp_async16(in_s + 16 * swz(e), src, inside);
  }
}

// f32 HWIO weights -> bf16 [tap][cout][cin]; one 16-byte chunk (8 input
// channels of one output channel) per task, lanes along the output
// channel so each global read of a warp is 128 contiguous bytes
template <int K, int N>
__device__ __forceinline__ void stage_weight(unsigned char* w_s, const float* __restrict__ w) {
  constexpr int KCH = K / 8;   // chunks per row
  for (int i = threadIdx.x; i < 9 * KCH * N; i += NT) {
    const int n = i % N, kc = (i / N) % KCH, tap = i / (N * KCH);
    const float* src = w + (tap * K + kc * 8) * N + n;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(__ldg(src + (2 * j) * N),
                                                     __ldg(src + (2 * j + 1) * N));
      v[j] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(w_s + 16 * swz((tap * N + n) * KCH + kc)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ void stage_weights(unsigned char* smem, const float* __restrict__ w1,
                                              const float* __restrict__ b1,
                                              const float* __restrict__ w2,
                                              const float* __restrict__ b2) {
  stage_weight<CIN, CMID>(smem + OFF_W1, w1);
  stage_weight<CMID, COUT>(smem + OFF_W2, w2);
  float* bias = reinterpret_cast<float*>(smem + OFF_BIAS);
  if (threadIdx.x < CMID) bias[threadIdx.x] = b1[threadIdx.x];
  else if (threadIdx.x < CMID + COUT) bias[threadIdx.x] = b2[threadIdx.x - CMID];
}

// accumulators of one m16 x n32 tile, started at the bias: lane holds
// rows lane/4 and lane/4 + 8, columns nt*8 + 2*(lane%4) + {0, 1}
__device__ __forceinline__ void init_acc(float (&acc)[4][4], const float* bias, int lane) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = nt * 8 + 2 * (lane & 3);
    acc[nt][0] = acc[nt][2] = bias[c];
    acc[nt][1] = acc[nt][3] = bias[c + 1];
  }
}

// leaky + bf16 of one lane's two neighbouring channels
__device__ __forceinline__ uint32_t leaky_pack(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(leaky(a), leaky(b));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// conv 1: the haloed mid tile into `mid`; warp w takes m16 tiles w, w+8, w+16
__device__ __forceinline__ void conv1(unsigned char* smem, int oy0, int ox0, int Ho, int Wo) {
  constexpr int PER_WARP = (MTILES1 + WARPS - 1) / WARPS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t in_s = smem_addr(smem), w1_s = smem_addr(smem + OFF_W1);
  const float* bias = reinterpret_cast<const float*>(smem + OFF_BIAS);

  float acc[PER_WARP][4][4];
  int q0[PER_WARP];   // this lane's A row: the input pixel of tap (0, 0)
#pragma unroll
  for (int i = 0; i < PER_WARP; ++i) {
    const int p = min((warp + i * WARPS) * 16 + (lane & 15), MPIX - 1);   // pad rows: any pixel
    const int my = p / MW, mx = p - my * MW;
    q0[i] = 2 * my * IW + 2 * mx;
    init_acc(acc[i], bias, lane);
  }
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int shift = (tap / 3) * IW + tap % 3;
    uint32_t b[4][2];
    load_b(b, w1_s, tap * CMID, CIN / 8, 0, lane);
#pragma unroll
    for (int i = 0; i < PER_WARP; ++i) {
      if (warp + i * WARPS >= MTILES1) break;   // warp-uniform
      uint32_t a[4];
      ldmatrix_x4(a, in_s + 16 * swz((q0[i] + shift) * 2 + (lane >> 4)));
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[i][nt], a, b[nt][0], b[nt][1]);
    }
  }

  unsigned char* mid = smem + OFF_MID;
#pragma unroll
  for (int i = 0; i < PER_WARP; ++i) {
    if (warp + i * WARPS >= MTILES1) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (warp + i * WARPS) * 16 + (lane >> 2) + 8 * h;
      if (p >= MPIX) continue;
      const int my = p / MW, mx = p - my * MW;
      const int gy = oy0 - 1 + my, gx = ox0 - 1 + mx;
      const bool inside = gy >= 0 && gy < Ho && gx >= 0 && gx < Wo;   // else conv 2's padding
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<uint32_t*>(mid + 16 * swz(p * 4 + nt) + 4 * (lane & 3)) =
            inside ? leaky_pack(acc[i][nt][2 * h], acc[i][nt][2 * h + 1]) : 0u;
    }
  }
}

// conv 2: warp w computes output row w of the tile (two m16 tiles) into `acc`
__device__ __forceinline__ void conv2(const unsigned char* smem, float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t mid_s = smem_addr(smem + OFF_MID), w2_s = smem_addr(smem + OFF_W2);
  const float* bias = reinterpret_cast<const float*>(smem + OFF_BIAS) + CMID;

  init_acc(acc[0], bias, lane);
  init_acc(acc[1], bias, lane);
  const int q0 = warp * MW + (lane & 15);   // mid pixel of tap (0, 0), first m16 tile
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int q = q0 + (tap / 3) * MW + tap % 3;
#pragma unroll
    for (int s = 0; s < CMID / 16; ++s) {
      uint32_t b[4][2];
      load_b(b, w2_s, tap * COUT, CMID / 8, 2 * s, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, mid_s + 16 * swz((q + 16 * i) * 4 + 2 * s + (lane >> 4)));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[i][nt], a, b[nt][0], b[nt][1]);
      }
    }
  }
}

// conv 2's epilogue: leaky, bf16, the tile staged NHWC in `out_s` (the
// region of the mid tile, once every warp is done reading it)
__device__ __forceinline__ void stage_output(unsigned char* out_s, const float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = warp * TW + 16 * i + (lane >> 2) + 8 * h;   // pixel of the tile
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<uint32_t*>(out_s + 16 * swz(p * 4 + nt) + 4 * (lane & 3)) =
            leaky_pack(acc[i][nt][2 * h], acc[i][nt][2 * h + 1]);
    }
}

// the staged output tile to device memory, 16-byte stores, ragged edges masked
__device__ __forceinline__ void store_output(const unsigned char* out_s,
                                             __nv_bfloat16* __restrict__ ob, int oy0, int ox0,
                                             int Ho, int Wo) {
#pragma unroll
  for (int k = 0; k < TH * TW * 4 / NT; ++k) {
    const int e = k * NT + threadIdx.x;
    const int p = e >> 2, oy = oy0 + p / TW, ox = ox0 + p % TW;
    if (oy < Ho && ox < Wo)
      *reinterpret_cast<uint4*>(ob + (static_cast<size_t>(oy) * Wo + ox) * COUT + (e & 3) * 8) =
          *reinterpret_cast<const uint4*>(out_s + 16 * swz(e));
  }
}

// a tile of the grid: tile columns fastest, then rows, then images
struct Tile {
  int n, oy0, ox0;
  __device__ Tile(int t, int tiles_x, int tiles_y)
      : n(t / (tiles_x * tiles_y)),
        oy0((t / tiles_x) % tiles_y * TH),
        ox0(t % tiles_x * TW) {}
};

// persistent: block b takes tiles b, b + gridDim.x, ...; the weights are
// staged once per block, and the next tile's input is copied in while
// this tile's conv 2 runs (the input region is dead after conv 1)
__global__ void __launch_bounds__(NT, 2)
stem_unit_b_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int H,
                       int W, int Ho, int Wo, int tiles_x, int tiles_y, int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t in_s = smem_addr(smem);
  const size_t in_image = static_cast<size_t>(H) * W * CIN;
  const size_t out_image = static_cast<size_t>(Ho) * Wo * COUT;
  int t = blockIdx.x;
  Tile tile(t, tiles_x, tiles_y);
  stage_input(in_s, x + tile.n * in_image, 2 * tile.oy0 - 3, 2 * tile.ox0 - 3, H, W);
  stage_weights(smem, w1, b1, w2, b2);
  for (; t < tiles; t += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();
    conv1(smem, tile.oy0, tile.ox0, Ho, Wo);
    __syncthreads();
    const Tile here = tile;
    if (t + gridDim.x < tiles) {
      tile = Tile(t + gridDim.x, tiles_x, tiles_y);
      stage_input(in_s, x + tile.n * in_image, 2 * tile.oy0 - 3, 2 * tile.ox0 - 3, H, W);
    }
    float acc[2][4][4];
    conv2(smem, acc);
    __syncthreads();
    stage_output(smem + OFF_MID, acc);
    __syncthreads();
    store_output(smem + OFF_MID, out + here.n * out_image, here.oy0, here.ox0, Ho, Wo);
  }
}

cudaError_t set_smem_limit() {
  return cudaFuncSetAttribute(stem_unit_b_mma_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

}  // namespace

namespace b2f {

// x: (N, H, W, 16) bf16; w1 (3, 3, 16, 32), b1 (32), w2 (3, 3, 32, 32),
// b2 (32) f32, already rounded to bf16; out (N, ceil(H/2), ceil(W/2), 32)
// bf16; all contiguous and 16-byte aligned. Called by stem_fwd.cu's
// `b2f_stem_unit_b` for bf16.
cudaError_t stem_unit_b_mma(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, int N, int H, int W,
                            cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int tiles_x = (Wo + TW - 1) / TW, tiles_y = (Ho + TH - 1) / TH;
  const long long tiles = static_cast<long long>(tiles_x) * tiles_y * N;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t e = set_smem_limit();
  int device = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int grid = static_cast<int>(tiles < 2LL * sms ? tiles : 2LL * sms);   // 2 blocks per SM
  stem_unit_b_mma_kernel<<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), H, W, Ho, Wo, tiles_x, tiles_y, static_cast<int>(tiles));
  return cudaGetLastError();
}

}  // namespace b2f

// What the compiler and the runtime made of the bf16 K6 kernel: registers
// per thread, local memory per thread (bytes, spills), dynamic shared
// memory per block (bytes) and resident blocks per SM. Launches nothing.
extern "C" int b2f_stem_unit_b_bf16_info(int* regs, int* local_bytes, int* smem_bytes,
                                         int* blocks_per_sm) {
  cudaError_t e = set_smem_limit();
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, stem_unit_b_mma_kernel);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = SMEM_BYTES;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, stem_unit_b_mma_kernel, NT,
                                                       SMEM_BYTES);
}
