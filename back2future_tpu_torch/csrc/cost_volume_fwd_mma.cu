// Multi-frame cost volume, forward (K1), in bf16 on the tensor cores:
// one frame term of the volume, NHWC,
//
//   out[b,y,x,q] = bf16(scale * sum_c ref[b,y,x,c] * frame[b, y-qy(q), x-qx(q), c])
//
// over the win*win displacements q, enumerated qx outer / qy inner,
// dilated by `dil` and mirrored when !fwd; frame pixels outside the image
// count as 0; sums in f32, rounded once. Replaces
// back2future_tpu/ops/cost_volume_pallas.py `_fwd_kernel` for bf16; the
// f32 instantiation stays on the CUDA-core kernel of cost_volume_fwd.cu,
// since f32 on the tensor cores would be TF32.
//
// What bounds it on the H100: per serving forward (B=16, 1216x320,
// levels 3..7, one future and one past volume each) it reads 176.7 MB of
// features and writes 167.9 MB of costs, 344.6 MB in all: 0.103 ms at
// 3.35 TB/s. Its 7.16 useful GFLOP take 7 us at the dense bf16 rate, so it
// is bound by bytes once the products run on the tensor cores. The
// CUDA-core kernel spends one shared-memory load per FMA and stores each
// pixel's 81 costs as scalars 162 bytes apart (3.1 ms).
//
// Design: a banded GEMM per row pair. For an output row y, one qy and 16
// neighbouring pixels x0..x0+15, the costs against frame row y-qy are a
// 16 x (16 + 2*pad) product over C (pad = (win-1)/2*dil): column j is
// frame pixel x0-pad+j, and pixel i needs the columns j = i + u*dil,
// u = 0..win-1, which form its qx band. The columns are walked in passes
// of FC = 24 (three n8 tiles of `mma.sync.m16n8k16` bf16 -> f32): one
// pass for win 9 at dil 1, where all 24 columns are computed and each
// pixel uses 9 (2.67x the useful products, 19.1 GFLOP per serving forward).
// - Blocks: 384 threads at win 9 (TH * ceil(win/3) warps), two per SM,
//   persistent: block b takes the 4 x 16 pixel tiles b, b + gridDim.x, ...
//   Warp (ty, g) owns tile row ty and the qy rows u = 3g..3g+2, so a lane
//   holds 3 x 3 x 4 = 36 f32 sums (80 registers, no spills).
// - Staging: each tile is walked in stages of CK = 32 channels (two k16
//   steps; the tail zero-filled) per pass, double-buffered: the copies of
//   the next stage, the next tile's first one included, are issued before
//   the current stage is computed, so they fly during its products, band
//   scatter and store. `cp.async.cg` 16-byte copies bring the ref tile
//   (4 x 16 pixels) and the frame rows the tile's qy rows need (24 columns
//   each) into shared memory in NHWC order, 64 bytes a pixel, addressed in
//   16-byte chunks through the XOR swizzle of stem_unit_b_mma.cu so that
//   `ldmatrix` rows 64 bytes apart hit 8 distinct bank groups. The frame
//   rows are ty + u*dil: contiguous when dil <= TH, else win groups of TH
//   rows, so a staged "slot" row is ty + u*min(dil, TH) and any dil fits
//   in TH*win slots. When C is not a multiple of 8 or an input is not
//   16-byte aligned, the chunks are gathered by scalar loads instead.
// - Products: per k16 step a warp loads its A fragment (16 ref pixels)
//   once with `ldmatrix.x4` and, per qy row, B (24 frame pixels) with
//   `ldmatrix.x4` + `.x2`: three `mma` per qy row.
// - Epilogue: the band entries of the sums, times `scale` and rounded to
//   bf16, go into an output tile in shared memory laid out as the output
//   ([pixel][win*win]); at dil 1 (a kernel of its own, `DIL1`) a lane's
//   three sums of one (pixel, qx) are neighbours in q and go out as one
//   4-byte and one 2-byte store, and the columns no lane can use are
//   skipped at compile time; other dilations test each sum, one division
//   each. Once a tile's passes are done, each tile row, TW * 162
//   contiguous bytes at win 9, goes to device memory by 16-byte stores
//   (scalar at its unaligned ends; ragged tiles masked).
// Where the time goes (chip_smoke.py --k1-phases) and the numbers: PERF.md.
// Registers, shared memory and blocks per SM: `b2f_cost_volume_fwd_bf16_info`
// (chip_smoke.py's build line prints them with the `-Xptxas -v` report).
#include <climits>

#include "mma.cuh"

namespace {

using namespace b2f::mma;

constexpr int TH = 4;            // tile rows
constexpr int TW = 16;           // tile columns: one m16 tile
constexpr int FC = 24;           // frame columns per pass: three n8 tiles
constexpr int NT8 = FC / 8;
constexpr int CK = 32;           // channels per staged chunk: two k16 steps
constexpr int CCH = CK / 8;      // 16-byte chunks per staged pixel
constexpr int QG = 3;            // qy rows per warp

constexpr int align128(int n) { return (n + 127) / 128 * 128; }

constexpr int REF_BYTES = TH * TW * CK * 2;     // one ref chunk
constexpr int SLOT_BYTES = FC * CK * 2;         // one staged frame row of a chunk
static_assert(REF_BYTES % 128 == 0 && SLOT_BYTES % 128 == 0, "arrays must stay 128-byte aligned");

template <int WIN>
struct Plan {
  static constexpr int Q = WIN * WIN;
  static constexpr int NQG = (WIN + QG - 1) / QG;
  static constexpr int WARPS = TH * NQG;
  static constexpr int NT = 32 * WARPS;
  // a staged output row: TW pixels of Q costs, starting `shift` (< 8)
  // elements into a 16-byte-aligned row, so that its 16-byte chunks are
  // those of device memory
  static constexpr int OUT_ROW = (TW * Q + 7 + 7) / 8 * 8;
  static constexpr int OUT_BYTES = align128(TH * OUT_ROW * 2);
};

// What every tile of one launch shares: the images, the sizes, the
// geometry of the staged frame rows, the grid of tiles.
struct Geometry {
  const __nv_bfloat16* ref;
  const __nv_bfloat16* frame;
  __nv_bfloat16* out;
  int H, W, C, dil, pad;
  int step;                     // min(dil, TH): slot row of (ty, u) is ty + u * step
  int ns;                       // staged frame rows (slots)
  int tiles_x, tiles_y;
  int out_off;                  // `out`'s element offset from a 16-byte boundary
  bool vec;                     // 16-byte copies (C % 8 == 0, inputs 16-byte aligned)
};

// a tile of the grid: tile columns fastest, then rows, then images
struct Tile {
  int b, y0, x0;
  __device__ Tile(int t, const Geometry& g)
      : b(t / (g.tiles_x * g.tiles_y)),
        y0((t / g.tiles_x) % g.tiles_y * TH),
        x0(t % g.tiles_x * TW) {}
};

// stage s of tile `t` (pass s / chunks, channels from (s % chunks) * CK)
// into one buffer: the ref tile and the frame slots, FC frame columns
// from x0 - pad + pass * FC (copies not yet waited for)
template <int NT>
__device__ __forceinline__ void stage(uint32_t ref_s, uint32_t frm_s, const Geometry& g,
                                      const Tile& t, int s, int chunks) {
  const int c0 = s % chunks * CK, xf0 = t.x0 - g.pad + s / chunks * FC;
  const size_t image = static_cast<size_t>(t.b) * g.H * g.W;
  for (int e = threadIdx.x; e < TH * TW * CCH; e += NT) {
    const int p = e / CCH, c = c0 + (e % CCH) * 8;
    const int y = t.y0 + p / TW, x = t.x0 + p % TW;
    const bool inside = y < g.H && x < g.W;
    stage_chunk(ref_s + 16 * swz(e), g.ref, inside ? image + y * g.W + x : 0, c, g.C, inside,
                g.vec);
  }
  for (int e = threadIdx.x; e < g.ns * FC * CCH; e += NT) {
    const int p = e / CCH, c = c0 + (e % CCH) * 8;
    const int slot = p / FC, x = xf0 + p % FC;
    const int y = t.y0 - g.pad + (g.dil <= TH ? slot : slot % TH + (slot / TH) * g.dil);
    const bool inside = y >= 0 && y < g.H && x >= 0 && x < g.W;
    stage_chunk(frm_s + 16 * swz(e), g.frame, inside ? image + y * g.W + x : 0, c, g.C, inside,
                g.vec);
  }
}

// one staged chunk: `ksteps` k16 steps of warp (ty, g)'s products
template <int WIN>
__device__ __forceinline__ void products(float (&acc)[QG][NT8][4], uint32_t ref_s,
                                         uint32_t frm_s, int ty, int g, int step, int ksteps) {
  const int lane = threadIdx.x & 31;
  const int j = lane >> 3, r = lane & 7;   // this lane's matrix and row in it (B)
#pragma unroll
  for (int ks = 0; ks < CK / 16; ++ks) {
    if (ks >= ksteps) break;
    uint32_t a[4];
    ldmatrix_x4(a, ref_s + 16 * swz((ty * TW + (lane & 15)) * CCH + 2 * ks + (lane >> 4)));
#pragma unroll
    for (int t = 0; t < QG; ++t) {
      const int u = g * QG + t;
      if (u >= WIN) break;   // warp-uniform
      const int row = (ty + u * step) * FC;   // first staged pixel of the slot row
      uint32_t b[4], b2[2];
      ldmatrix_x4(b, frm_s + 16 * swz((row + (j >> 1) * 8 + r) * CCH + 2 * ks + (j & 1)));
      ldmatrix_x2(b2, frm_s + 16 * swz((row + 16 + r) * CCH + 2 * ks + (j & 1)));
      mma_bf16(acc[t][0], a, b[0], b[1]);
      mma_bf16(acc[t][1], a, b[2], b[3]);
      mma_bf16(acc[t][2], a, b2[0], b2[1]);
    }
  }
}

// the band entries of one pass's sums into the staged output row `o`
// (already offset by the row's shift): sum (i, j) is pixel i against
// column pass*FC + j, in the band where j - i = u*dil, u < WIN.
template <int WIN>
__device__ __forceinline__ void scatter_band(__nv_bfloat16* o, const float (&acc)[QG][NT8][4],
                                             int g, int pass, int dil, bool fwd, float scale) {
  constexpr int Q = WIN * WIN;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < QG; ++t) {
    const int uy = g * QG + t;
    if (uy >= WIN) break;
    const int iy = fwd ? WIN - 1 - uy : uy;
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = (lane >> 2) + 8 * (k >> 1);
        const int d = pass * FC + nt * 8 + 2 * (lane & 3) + (k & 1) - i;
        if (d < 0 || d % dil != 0 || d / dil >= WIN) continue;
        const int ix = fwd ? WIN - 1 - d / dil : d / dil;
        o[i * Q + ix * WIN + iy] = __float2bfloat16(acc[t][nt][k] * scale);
      }
  }
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// scatter_band for dil 1 and a warp holding QG = 3 qy rows: one pass
// (TW + WIN - 1 <= FC), u = j - i, and a lane's three sums of one (i, j)
// are neighbours in q (qy inner), written as one 4-byte and one 2-byte
// store. The sums whose column can miss the band for every lane are
// skipped at compile time.
template <int WIN>
__device__ __forceinline__ void scatter_band_dil1(__nv_bfloat16* o,
                                                  const float (&acc)[QG][NT8][4], int g,
                                                  bool fwd, float scale) {
  static_assert(QG == 3 && TW + WIN - 1 <= FC, "one pass of three qy rows");
  constexpr int Q = WIN * WIN;
  const int lane = threadIdx.x & 31;
  // the lowest q of the three: qy rows 3g..3g+2, mirrored when fwd
  const int iy0 = fwd ? WIN - QG - g * QG : g * QG;
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int dmin = nt * 8 + (k & 1) - 7 - 8 * (k >> 1), dmax = dmin + 13;
      if (dmax < 0 || dmin >= WIN) continue;   // no lane's column is in the band
      const int i = (lane >> 2) + 8 * (k >> 1);
      const int u = nt * 8 + 2 * (lane & 3) + (k & 1) - i;
      if (u < 0 || u >= WIN) continue;
      const int ix = fwd ? WIN - 1 - u : u;
      __nv_bfloat16* e = o + i * Q + ix * WIN + iy0;
      // in q order: qy rows iy0, iy0 + 1, iy0 + 2 (selected by value: an
      // index chosen at run time would put `acc` in local memory)
      const float first = acc[0][nt][k] * scale, last = acc[2][nt][k] * scale;
      const uint16_t lo = bf16_bits(fwd ? last : first);
      const uint16_t mid = bf16_bits(acc[1][nt][k] * scale);
      const uint16_t hi = bf16_bits(fwd ? first : last);
      const bool odd = (reinterpret_cast<uintptr_t>(e) & 2) != 0;
      *reinterpret_cast<uint16_t*>(odd ? e : e + 2) = odd ? lo : hi;
      *reinterpret_cast<uint32_t*>(odd ? e + 1 : e) =
          odd ? mid | (static_cast<uint32_t>(hi) << 16) : lo | (static_cast<uint32_t>(mid) << 16);
    }
}

// the output run of tile row ty: its first element in `out`, and the
// shift (< 8) of its first element past a 16-byte boundary, at which the
// staged row holds it
struct Run {
  size_t first;
  int shift;
  __device__ Run(const Geometry& g, const Tile& t, int ty, int q) {
    first = ((static_cast<size_t>(t.b) * g.H + min(t.y0 + ty, g.H - 1)) * g.W + t.x0) * q;
    shift = static_cast<int>((first + g.out_off) & 7);
  }
};

// the staged output tile to device memory: element k >= shift of staged
// row ty is element first - shift + k of `out`; whole 16-byte chunks by
// vector stores, the ends element by element
template <int WIN>
__device__ __forceinline__ void store_tile(const unsigned char* out_s, const Geometry& g,
                                           const Tile& t) {
  using P = Plan<WIN>;
  constexpr int CHUNKS = P::OUT_ROW / 8;
  const int n = min(TW, g.W - t.x0) * P::Q;   // valid elements of a row run
  for (int e = threadIdx.x; e < TH * CHUNKS; e += P::NT) {
    const int ty = e / CHUNKS, lo = (e % CHUNKS) * 8;
    if (t.y0 + ty >= g.H) continue;
    const Run run(g, t, ty, P::Q);
    if (lo + 8 <= run.shift || lo >= run.shift + n) continue;
    const __nv_bfloat16* src = reinterpret_cast<const __nv_bfloat16*>(out_s) + ty * P::OUT_ROW;
    __nv_bfloat16* dst = g.out + run.first - run.shift;
    if (lo >= run.shift && lo + 8 <= run.shift + n) {
      *reinterpret_cast<uint4*>(dst + lo) = *reinterpret_cast<const uint4*>(src + lo);
    } else {
      for (int k = max(lo, run.shift); k < min(lo + 8, run.shift + n); ++k) dst[k] = src[k];
    }
  }
}

// shared memory: the output tile, then two buffers of (ref chunk, frame slots)
template <int WIN>
__host__ __device__ constexpr int smem_bytes(int ns) {
  return Plan<WIN>::OUT_BYTES + 2 * (REF_BYTES + ns * SLOT_BYTES);
}

// persistent: block b takes tiles b, b + gridDim.x, ...; each tile is
// `passes * chunks` stages, and every stage's copies, the next tile's
// first included, are issued before the current stage is computed, so
// the next tile's loads fly while this tile's band is scattered and stored
template <int WIN, bool DIL1>
__global__ void __launch_bounds__(Plan<WIN>::NT, 2)
cost_volume_fwd_mma_kernel(Geometry g, int fwd, float scale, int tiles) {
  using P = Plan<WIN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int ty = warp / P::NQG, wg = warp % P::NQG;
  const uint32_t buf0 = smem_addr(smem + P::OUT_BYTES);
  const uint32_t buf1 = buf0 + REF_BYTES + g.ns * SLOT_BYTES;
  const int chunks = (g.C + CK - 1) / CK;
  const int stages = (TW + 2 * g.pad + FC - 1) / FC * chunks;
  const int step = DIL1 ? 1 : g.step;

  int t = blockIdx.x, s = 0;
  Tile tile(t, g);
  stage<P::NT>(buf0, buf0 + REF_BYTES, g, tile, 0, chunks);
  cp_async_commit();
  float acc[QG][NT8][4];
  for (unsigned n = 0;; ++n) {
    // the next stage: this tile's next, or the next tile's first
    const int s_next = s + 1 < stages ? s + 1 : 0;
    const int t_next = s_next ? t : t + gridDim.x;
    const Tile next = s_next ? tile : Tile(t_next, g);
    const uint32_t cur = (n & 1) ? buf1 : buf0, nxt = (n & 1) ? buf0 : buf1;
    if (t_next < tiles) stage<P::NT>(nxt, nxt + REF_BYTES, g, next, s_next, chunks);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int c0 = s % chunks * CK;
    if (c0 == 0) {
#pragma unroll
      for (auto& a : acc)
        for (auto& b : a)
          for (float& v : b) v = 0.f;
    }
    products<WIN>(acc, cur, cur + REF_BYTES, ty, wg, step, min(CK / 16, (g.C - c0 + 15) / 16));
    if (c0 + CK >= g.C) {
      const Run run(g, tile, ty, P::Q);
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(smem) + ty * P::OUT_ROW + run.shift;
      if (DIL1 && (wg + 1) * QG <= WIN)   // warp-uniform
        scatter_band_dil1<WIN>(o, acc, wg, fwd != 0, scale);
      else
        scatter_band<WIN>(o, acc, wg, s / chunks, g.dil, fwd != 0, scale);
    }
    if (s + 1 == stages) {
      __syncthreads();
      store_tile<WIN>(smem, g, tile);
    }
    __syncthreads();
    if (t_next >= tiles) break;
    s = s_next;
    t = t_next;
    tile = next;
  }
}

template <int WIN, bool DIL1>
cudaError_t set_smem_limit(int bytes) {
  return cudaFuncSetAttribute(cost_volume_fwd_mma_kernel<WIN, DIL1>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// resident blocks per SM times the SMs of the current device, for `smem`
// bytes of shared memory; the shared-memory limit is set on the way. Kept
// for the last device and size asked for, so a launch costs no queries.
template <int WIN, bool DIL1>
cudaError_t grid_cap(int smem, int* cap) {
  static int last_device = -1, last_smem = -1, last_cap = 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device == last_device && smem == last_smem) {
    *cap = last_cap;
    return cudaSuccess;
  }
  e = set_smem_limit<WIN, DIL1>(smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cost_volume_fwd_mma_kernel<WIN, DIL1>, Plan<WIN>::NT, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *cap = last_cap = per_sm * sms;
  last_smem = smem;
  last_device = device;
  return cudaSuccess;
}

template <int WIN, bool DIL1>
cudaError_t launch(const Geometry& g, int B, int fwd, float scale, cudaStream_t stream) {
  const int smem = smem_bytes<WIN>(g.ns);
  const long long tiles = static_cast<long long>(g.tiles_x) * g.tiles_y * B;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  int cap = 0;
  const cudaError_t e = grid_cap<WIN, DIL1>(smem, &cap);
  if (e != cudaSuccess) return e;
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  cost_volume_fwd_mma_kernel<WIN, DIL1><<<grid, Plan<WIN>::NT, smem, stream>>>(
      g, fwd, scale, static_cast<int>(tiles));
  return cudaGetLastError();
}

template <int WIN>
cudaError_t launch_win(const Geometry& g, int B, int fwd, float scale, cudaStream_t stream) {
  return g.dil == 1 ? launch<WIN, true>(g, B, fwd, scale, stream)
                    : launch<WIN, false>(g, B, fwd, scale, stream);
}

}  // namespace

namespace b2f {

// ref, frame: (B, H, W, C) bf16; out: (B, H, W, win*win) bf16; all
// contiguous. win in {3, 5, 7, 9}, dil >= 1. Called by cost_volume_fwd.cu's
// `b2f_cost_volume_fwd` for bf16.
cudaError_t cost_volume_fwd_mma(const void* ref, const void* frame, void* out, int B, int H,
                                int W, int C, int win, int dil, int fwd, float scale,
                                cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  Geometry g;
  g.ref = static_cast<const __nv_bfloat16*>(ref);
  g.frame = static_cast<const __nv_bfloat16*>(frame);
  g.out = static_cast<__nv_bfloat16*>(out);
  g.H = H;
  g.W = W;
  g.C = C;
  g.dil = dil;
  g.pad = (win - 1) / 2 * dil;
  g.step = dil < TH ? dil : TH;
  g.ns = TH + (win - 1) * g.step;
  g.tiles_x = (W + TW - 1) / TW;
  g.tiles_y = (H + TH - 1) / TH;
  g.out_off = static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 1) & 7);
  g.vec = C % 8 == 0 && aligned(ref) && aligned(frame);
  switch (win) {
    case 3: return launch_win<3>(g, B, fwd, scale, stream);
    case 5: return launch_win<5>(g, B, fwd, scale, stream);
    case 7: return launch_win<7>(g, B, fwd, scale, stream);
    case 9: return launch_win<9>(g, B, fwd, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace b2f

// What the compiler and the runtime made of the bf16 K1 kernel at the
// main path's win 9, dil 1: registers per thread, local memory per thread
// (bytes, spills), dynamic shared memory per block (bytes), resident
// blocks per SM. Launches nothing.
extern "C" int b2f_cost_volume_fwd_bf16_info(int* regs, int* local_bytes, int* smem,
                                             int* blocks_per_sm) {
  const int bytes = smem_bytes<9>(TH + 8);
  cudaError_t e = set_smem_limit<9, true>(bytes);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, cost_volume_fwd_mma_kernel<9, true>);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem = bytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                       cost_volume_fwd_mma_kernel<9, true>,
                                                       Plan<9>::NT, bytes);
}
