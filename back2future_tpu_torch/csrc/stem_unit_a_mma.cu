// Unit A of the fused stem (K5) in bf16, on the tensor cores: one
// ConvUnit 3 -> 16 -> 16 (conv 3x3 stride 2 + leaky 0.2, conv 3x3 stride 1
// + leaky 0.2, padding 1 on each side), NHWC,
//
//   mid[b,y,x,m] = bf16(leaky(b1[m] + sum_{ky,kx,c<3} x[b,2y+ky-1,2x+kx-1,c] w1[ky,kx,c,m]))
//   out[b,y,x,o] = bf16(leaky(b2[o] + sum_{ky,kx,m<16} mid[b,y+ky-1,x+kx-1,m] w2[ky,kx,m,o]))
//
// with input pixels outside the image and mid pixels outside the mid map
// counted as 0, sums in f32. Replaces back2future_tpu/ops/stem_pallas.py
// `_unit_a_kernel` (the `pallas_call` at stem_pallas.py:361) for bf16; the
// f32 instantiation stays on the CUDA-core kernel of stem_fwd.cu, since f32
// on the tensor cores would be TF32.
//
// What bounds it on the H100: at the serving shape (48 x 320 x 1216 x 3 in)
// it moves 261.5 MB (78 us at 3.35 TB/s) and does 25.6 GFLOP (26 us at the
// dense bf16 rate), so it is bound by bytes once its products run on the
// tensor cores; on the f32 CUDA cores the FLOPs alone take 381 us.
//
// Design: blocks of 8 warps, two per SM, each walking over 8 x 32 output
// tiles (persistent: the grid is two blocks per SM).
// - Input (`load_octet`, `store_region`): a bf16 pixel is 6 bytes, so
//   neither cp.async nor ldmatrix can address one pixel. The haloed
//   region, 21 rows x 70 pixels from global column 2*ox0 - 3, is read as
//   octets of 8 pixels (48 bytes) from the 8-pixel-aligned column
//   2*ox0 - 8, 10 octets a row, one per thread, into a raw copy of the
//   region in shared memory: three 16-byte cp.async copies when W % 8 == 0
//   and the tensor is 16-byte aligned (zero-filled outside the image),
//   else 24 two-byte loads. The next tile's copies are issued once the
//   raw region has been moved on, and fly during this tile's convs. Moving
//   it pads each pixel to 4 channels (8 bytes, channel 3 zero) and shifts
//   it 5 pixels, so that global column 2*ox0 - 3 is region column 0, on a
//   16-byte boundary; each thread builds whole 16-byte chunks (2 pixels)
//   from 4 aligned words of the raw row, so neither side conflicts on
//   banks. Region rows are RCH = 37 chunks (74 pixels) apart: the step
//   from the last mid pixel of a tile row to the first of the next is then
//   1 mod 8 chunks, as within a row, so conv 1's ldmatrix rows never share
//   a bank group.
// - Conv 1 (`conv1`, K = 27): with region column 0 on a 16-byte boundary,
//   mid pixel mx's taps of one ky are the 4 padded pixels at region
//   columns 2mx .. 2mx+3, 16 bf16 values starting on chunk mx. So each ky
//   is one k16 step whose A rows ldmatrix reads in place (k = 4 kx + c);
//   the fourth pixel and channel 3 meet zero weights. M = the 340 pixels
//   of the haloed 10 x 34 mid tile (22 m16 tiles over the 8 warps), N = 16
//   (two n8 tiles), 3 k16 steps, `mma.sync.m16n8k16` bf16 -> f32. The
//   epilogue adds the bias, applies leaky, rounds to bf16 and writes the
//   mid tile (340 pixels x 32 bytes) to shared memory, zero outside the
//   mid map. The mid map never goes to device memory.
// - Conv 2 (`conv2`, K = 144): each warp takes one output row (32 pixels,
//   two m16 tiles x two n8 tiles), 9 k16 steps (one per tap), A by
//   ldmatrix from the mid tile.
// - Weights: every B fragment of both convs (3 + 9 k16 steps x 2 n8
//   tiles, 48 registers) is built once per block in registers from the f32
//   HWIO arguments (exactly: they are already rounded to bf16), so the
//   tile loop reads no weights at all.
// - Output (`stage_output`, `store_output`): bias, leaky, bf16, staged in
//   a region of its own and written back with 16-byte stores, a warp
//   storing 512 contiguous bytes (16 pixels of 32 bytes); ragged edges
//   masked.
// - Bank conflicts: mid and output pixels are 32 bytes (2 chunks), so the
//   8 rows of an ldmatrix matrix or of an epilogue store sit 2 chunks
//   apart. Both arrays are addressed through `swz`, which XORs a chunk's
//   slot within its 128-byte line with the line's parity: any 8 chunks 2
//   apart then land in 8 distinct bank groups.
// - 43,392 bytes of static shared memory per block.
#include <climits>

#include "mma.cuh"

namespace {

using b2f::mma::cp_async16;
using b2f::mma::cp_async_commit;
using b2f::mma::cp_async_wait_all;
using b2f::mma::ldmatrix_x4;
using b2f::mma::mma_bf16;
using b2f::mma::smem_addr;
using b2f::mma::st_shared16;

constexpr int CIN = 3, CP = 4, CMID = 16, COUT = 16;   // CP: padded input channels
constexpr int TH = 8;                                  // output tile rows (one per warp)
constexpr int TW = 32;                                 // output tile columns
constexpr int WARPS = TH;
constexpr int NT = 32 * WARPS;                         // threads per block
constexpr int MH = TH + 2, MW = TW + 2;                // haloed mid tile
constexpr int MPIX = MH * MW;                          // 340 mid pixels
constexpr int MTILES1 = (MPIX + 15) / 16;              // 22 m16 tiles of conv 1
constexpr int IH = 2 * MH + 1, IW = 2 * MW + 2;        // 21 x 70 padded input pixels
constexpr int RCH = 37;                                // chunks per region row (74 pixels)
constexpr int RAW_ROW = 560;                           // bytes per raw region row (OCTETS x 48 used)
constexpr int PITCH = IW / 2 + 1;                      // chunks built per region row, one spare
constexpr int SHIFT = 5;                               // region column 0 = octet column 5
constexpr int OCTETS = (IW + SHIFT + 7) / 8;           // 10 octets of 8 pixels a row
constexpr int TASKS = IH * OCTETS;                     // 210 octets per tile
constexpr int KSTEPS1 = 3, KSTEPS2 = 9;                // k16 steps of conv 1 and conv 2
constexpr int BLOCKS_PER_SM = 2;

constexpr int align128(int n) { return (n + 127) / 128 * 128; }

// shared memory, bytes; every array starts on a 128-byte line for `swz`
constexpr int IN_BYTES = align128(IH * RCH * 16);      // input region, 4-channel pixels
constexpr int MID_BYTES = align128(MPIX * CMID * 2);   // mid tile
constexpr int OUT_BYTES = TH * TW * COUT * 2;          // output tile
constexpr int RAW_BYTES = align128(IH * RAW_ROW);       // the region's octets as read
constexpr int OFF_MID = IN_BYTES;
constexpr int OFF_OUT = OFF_MID + MID_BYTES;
constexpr int OFF_RAW = OFF_OUT + OUT_BYTES;
constexpr int SMEM_BYTES = OFF_RAW + RAW_BYTES;
static_assert(2 * RCH >= IW, "a region row must hold IW pixels");
static_assert((2 * RCH - (MW - 1)) % 8 == 1, "conv 1's A rows must not wrap onto a bank group");
static_assert(TASKS <= NT, "one octet per thread");
static_assert(RAW_ROW % 16 == 0 && RAW_ROW >= OCTETS * 48 && PITCH <= RCH, "raw and region rows");
static_assert((RAW_ROW / 4 - 3 * (PITCH - 1)) % 32 == 3,
              "store_region's word loads must step 3 banks across a row's end too");
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory");

// 16-byte chunk index -> its place: slot (0..7) within the 128-byte line
// XORed with the line's parity (mma.cuh's `swz`, for rows 64 bytes apart,
// would leave rows 32 bytes apart 2-way conflicted)
__device__ __forceinline__ int swz(int chunk) { return chunk ^ ((chunk >> 3) & 1); }

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.2f * v; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// leaky + bf16 of one lane's two neighbouring channels
__device__ __forceinline__ uint32_t leaky_pack(float a, float b) {
  return pack_bf16(leaky(a), leaky(b));
}

// The B fragments of both convs, in registers: w1f[ky][nt], w2f[tap][nt].
// Lane holds B[k][n] at n = nt*8 + lane/4, k = 2*(lane%4) + {0, 1} (first
// register) and k + 8 (second). Conv 1's k is 4*kx + c (c < 4, kx < 4);
// kx == 3 and c == 3 are the padding and take 0. Conv 2's k is the mid
// channel.
struct Weights {
  uint32_t w1f[KSTEPS1][2][2];
  uint32_t w2f[KSTEPS2][2][2];
  float b1[2][2], b2[2][2];   // bias of this lane's two channels per n8 tile

  __device__ __forceinline__ void load(const float* __restrict__ w1, const float* __restrict__ b1g,
                                       const float* __restrict__ w2,
                                       const float* __restrict__ b2g) {
    const int lane = threadIdx.x & 31;
    const int n0 = lane >> 2, k0 = 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = nt * 8 + n0;
#pragma unroll
      for (int ky = 0; ky < KSTEPS1; ++ky)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = k0 + 8 * r + e, kx = k / CP, c = k % CP;
            v[e] = kx < 3 && c < CIN ? __ldg(w1 + ((ky * 3 + kx) * CIN + c) * CMID + n) : 0.f;
          }
          w1f[ky][nt][r] = pack_bf16(v[0], v[1]);
        }
#pragma unroll
      for (int tap = 0; tap < KSTEPS2; ++tap)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = k0 + 8 * r;
          w2f[tap][nt][r] = pack_bf16(__ldg(w2 + (tap * CMID + m) * COUT + n),
                                      __ldg(w2 + (tap * CMID + m + 1) * COUT + n));
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        b1[nt][e] = __ldg(b1g + nt * 8 + k0 + e);
        b2[nt][e] = __ldg(b2g + nt * 8 + k0 + e);
      }
    }
  }
};

// accumulators of one m16 x n16 tile, started at the bias: lane holds
// rows lane/4 and lane/4 + 8, columns nt*8 + 2*(lane%4) + {0, 1}
__device__ __forceinline__ void init_acc(float (&acc)[2][4], const float (&bias)[2][2]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    acc[nt][0] = acc[nt][2] = bias[nt][0];
    acc[nt][1] = acc[nt][3] = bias[nt][1];
  }
}

// One thread's octet of the input region: 8 pixels x 3 channels of one
// region row (row task / OCTETS, octet task % OCTETS), 48 bytes in memory
// order, into its place `slot` in the raw region (rows of OCTETS * 8
// pixels as they lie in the image, RAW_ROW bytes apart); zeros outside
// the image. The tile's
// region starts at image row iy0 and 8-aligned image column gxa. With
// `vec`, three cp.async copies, not waited for; else 24 two-byte loads and
// three 16-byte stores.
__device__ __forceinline__ void load_octet(uint32_t slot, const __nv_bfloat16* __restrict__ xb,
                                           int task, int iy0, int gxa, int H, int W, bool vec) {
  if (task >= TASKS) return;
  const int r = task / OCTETS, gy = iy0 + r, gx = gxa + 8 * (task - r * OCTETS);
  const bool row = gy >= 0 && gy < H;
  const long long pix = static_cast<long long>(gy) * W + gx;
  if (vec) {   // W % 8 == 0: the octet lies wholly inside the row or wholly outside
    const bool valid = row && gx >= 0 && gx < W;
    const __nv_bfloat16* src = valid ? xb + pix * CIN : xb;
#pragma unroll
    for (int q = 0; q < 3; ++q) cp_async16(slot + 16 * q, src + 8 * q, valid);
    return;
  }
  uint32_t v[12] = {};
  const unsigned short* src = reinterpret_cast<const unsigned short*>(xb);
#pragma unroll
  for (int e = 0; e < 24; ++e) {
    const int x = gx + e / CIN;
    if (row && x >= 0 && x < W) v[e / 2] |= uint32_t{__ldg(src + pix * CIN + e)} << (16 * (e & 1));
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const uint32_t chunk[4] = {v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]};
    st_shared16(slot + 16 * q, chunk);
  }
}

// The raw region to the padded one, a 16-byte chunk (2 pixels) per task:
// region pixels 2k, 2k+1 of row r are raw pixels 2k+SHIFT, 2k+SHIFT+1,
// 12 bytes from byte 12k + 30 of the raw row, read as the 4 aligned words
// from byte 12k + 28 and shifted by 16 bits; channel 3 zero. Neighbouring
// lanes read words 3 apart, also across the end of a row (RAW_ROW and the
// spare chunk k = 35, whose pixels conv 1 never reads): no bank conflict.
__device__ __forceinline__ void store_region(unsigned char* smem) {
  static_assert(SHIFT == 5, "the word offsets below are SHIFT's");
  const uint32_t* raw = reinterpret_cast<const uint32_t*>(smem + OFF_RAW);
  for (int c = threadIdx.x; c < IH * PITCH; c += NT) {
    const int r = c / PITCH, k = c - r * PITCH;
    const uint32_t* w = raw + r * (RAW_ROW / 4) + 3 * k + 7;
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
    *reinterpret_cast<uint4*>(smem + 16 * (r * RCH + k)) =
        make_uint4(__funnelshift_r(w0, w1, 16), w1 >> 16, w2, w3 & 0xffffu);
  }
}

// conv 1: the haloed mid tile into `mid`; warp w takes m16 tiles w, w+8,
// w+16, one at a time (8 accumulators live, not 24: the 48 weight
// registers stay within the 128 of two blocks per SM)
__device__ __forceinline__ void conv1(unsigned char* smem, const Weights& wt, int oy0, int ox0,
                                      int Ho, int Wo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t in_s = smem_addr(smem);
  unsigned char* mid = smem + OFF_MID;
#pragma unroll 1
  for (int tile = warp; tile < MTILES1; tile += WARPS) {
    // this lane's A row (pad rows: any pixel) and its chunk at ky = 0
    const int pa = min(tile * 16 + (lane & 15), MPIX - 1);
    const int ya = pa / MW;
    const int q0 = 2 * ya * RCH + pa - ya * MW + (lane >> 4);
    float acc[2][4];
    init_acc(acc, wt.b1);
#pragma unroll
    for (int ky = 0; ky < KSTEPS1; ++ky) {
      uint32_t a[4];
      ldmatrix_x4(a, in_s + 16 * (q0 + ky * RCH));
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[nt], a, wt.w1f[ky][nt][0], wt.w1f[ky][nt][1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = tile * 16 + (lane >> 2) + 8 * h;
      if (p >= MPIX) continue;
      const int my = p / MW, mx = p - my * MW;
      const int gy = oy0 - 1 + my, gx = ox0 - 1 + mx;
      const bool inside = gy >= 0 && gy < Ho && gx >= 0 && gx < Wo;   // else conv 2's padding
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        *reinterpret_cast<uint32_t*>(mid + 16 * swz(p * 2 + nt) + 4 * (lane & 3)) =
            inside ? leaky_pack(acc[nt][2 * h], acc[nt][2 * h + 1]) : 0u;
    }
  }
}

// conv 2: warp w computes output row w of the tile (two m16 tiles) into `acc`
__device__ __forceinline__ void conv2(const unsigned char* smem, const Weights& wt,
                                      float (&acc)[2][2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t mid_s = smem_addr(smem + OFF_MID);
  init_acc(acc[0], wt.b2);
  init_acc(acc[1], wt.b2);
  const int q0 = warp * MW + (lane & 15);   // mid pixel of tap (0, 0), first m16 tile
#pragma unroll
  for (int tap = 0; tap < KSTEPS2; ++tap) {
    const int q = q0 + (tap / 3) * MW + tap % 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t a[4];
      ldmatrix_x4(a, mid_s + 16 * swz((q + 16 * i) * 2 + (lane >> 4)));
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        mma_bf16(acc[i][nt], a, wt.w2f[tap][nt][0], wt.w2f[tap][nt][1]);
    }
  }
}

// conv 2's epilogue: leaky, bf16, the tile staged NHWC in `out_s`
__device__ __forceinline__ void stage_output(unsigned char* out_s, const float (&acc)[2][2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = warp * TW + 16 * i + (lane >> 2) + 8 * h;   // pixel of the tile
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        *reinterpret_cast<uint32_t*>(out_s + 16 * swz(p * 2 + nt) + 4 * (lane & 3)) =
            leaky_pack(acc[i][nt][2 * h], acc[i][nt][2 * h + 1]);
    }
}

// the staged output tile to device memory, 16-byte stores, ragged edges masked
__device__ __forceinline__ void store_output(const unsigned char* out_s,
                                             __nv_bfloat16* __restrict__ ob, int oy0, int ox0,
                                             int Ho, int Wo) {
#pragma unroll
  for (int k = 0; k < TH * TW * 2 / NT; ++k) {
    const int e = k * NT + threadIdx.x;
    const int p = e >> 1, oy = oy0 + p / TW, ox = ox0 + p % TW;
    if (oy < Ho && ox < Wo)
      *reinterpret_cast<uint4*>(ob + (static_cast<size_t>(oy) * Wo + ox) * COUT + (e & 1) * 8) =
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
// built once per block; three barriers a tile
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
stem_unit_a_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int H,
                       int W, int Ho, int Wo, int tiles_x, int tiles_y, int tiles, bool vec) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const size_t in_image = static_cast<size_t>(H) * W * CIN;
  const size_t out_image = static_cast<size_t>(Ho) * Wo * COUT;
  const int task = threadIdx.x;
  const uint32_t raw =
      smem_addr(smem + OFF_RAW + task / OCTETS * RAW_ROW + task % OCTETS * 48);   // task < TASKS
  int t = blockIdx.x;
  Tile tile(t, tiles_x, tiles_y);
  load_octet(raw, x + tile.n * in_image, task, 2 * tile.oy0 - 3, 2 * tile.ox0 - 8, H, W, vec);
  cp_async_commit();
  Weights wt;
  wt.load(w1, b1, w2, b2);
  cp_async_wait_all();
  __syncthreads();
  store_region(smem);
  __syncthreads();
  for (; t < tiles; t += gridDim.x) {
    const Tile here = tile;
    const bool more = t + gridDim.x < tiles;
    if (more) {   // the raw region is free: its copies fly during this tile's convs
      tile = Tile(t + gridDim.x, tiles_x, tiles_y);
      load_octet(raw, x + tile.n * in_image, task, 2 * tile.oy0 - 3, 2 * tile.ox0 - 8, H, W, vec);
    }
    cp_async_commit();
    conv1(smem, wt, here.oy0, here.ox0, Ho, Wo);
    __syncthreads();
    float acc[2][2][4];
    conv2(smem, wt, acc);
    stage_output(smem + OFF_OUT, acc);
    cp_async_wait_all();
    __syncthreads();
    store_output(smem + OFF_OUT, out + here.n * out_image, here.oy0, here.ox0, Ho, Wo);
    if (more) store_region(smem);   // conv 1 is done with the region
    __syncthreads();
  }
}

}  // namespace

namespace b2f {

// x: (N, H, W, 3) bf16; w1 (3, 3, 3, 16), b1 (16), w2 (3, 3, 16, 16),
// b2 (16) f32, already rounded to bf16; out (N, ceil(H/2), ceil(W/2), 16)
// bf16; all contiguous, out 16-byte aligned. Any H, W and alignment of x
// (16-byte loads where W % 8 == 0 and x is 16-byte aligned). Called by
// stem_fwd.cu's `b2f_stem_unit_a` for bf16.
cudaError_t stem_unit_a_mma(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, int N, int H, int W,
                            cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int tiles_x = (Wo + TW - 1) / TW, tiles_y = (Ho + TH - 1) / TH;
  const long long tiles = static_cast<long long>(tiles_x) * tiles_y * N;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long long slots = static_cast<long long>(BLOCKS_PER_SM) * sms;
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  const bool vec = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  stem_unit_a_mma_kernel<<<grid, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), H, W, Ho, Wo, tiles_x, tiles_y, static_cast<int>(tiles),
      vec);
  return cudaGetLastError();
}

}  // namespace b2f

// What the compiler and the runtime made of the bf16 K5 kernel: registers
// per thread, local memory per thread (bytes, spills), shared memory per
// block (bytes) and resident blocks per SM. Launches nothing.
extern "C" int b2f_stem_unit_a_bf16_info(int* regs, int* local_bytes, int* smem_bytes,
                                         int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, stem_unit_a_mma_kernel);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, stem_unit_a_mma_kernel, NT,
                                                       0);
}
