// Multi-frame cost volume, backward (K2 d_ref, K3 d_frame), in bf16 on the
// tensor cores. With the forward out[b,y,x,q] = scale * sum_c ref[b,y,x,c]
// * frame[b, y-qy, x-qx, c] (NHWC; q enumerates qx outer / qy inner,
// dilated by `dil`, mirrored when !fwd; pixels outside the image 0):
//
//   d_ref[b,y,x,c]   = bf16(scale * sum_q g[b,y,x,q] * frame[b, y-qy, x-qx, c])
//   d_frame[b,y,x,c] = bf16(scale * sum_q g[b,y+qy,x+qx,q] * ref[b, y+qy, x+qx, c])
//
// sums in f32, rounded once. Replaces back2future_tpu/ops/cost_volume_pallas.py
// `_dref_kernel` (K2) and `_dframe_kernel` (K3) for bf16; f32 stays on the
// CUDA-core kernels of cost_volume_bwd.cu (f32 on the tensor cores would
// be TF32).
//
// One kernel body serves both. The op is bilinear, so d_frame is d_ref's
// form on a shifted gradient with the direction mirrored: with
// g'[b,y,x,q] = g[b, y+qy, x+qx, q] (0 outside the image), d_frame =
// dref_form(g', ref, !fwd). In that form the g' value that meets the ref
// value at staged slot ty + u, column j is g at that very pixel; so the
// d_frame instantiation stages g as the haloed tile, exactly as it
// stages ref, and reads its A values there: no shifted copy of g is made.
//
// What bounds them on the H100: per hard train step (B=8, 320x640, levels
// 3..7, a future and a past volume each) d_ref reads g (44.2 MB over the
// levels) and the frame (23.2 MB) and writes d_ref (23.2 MB): 90.6 MB,
// 0.027 ms at 3.35 TB/s; d_frame moves the same. The 1.9 useful GFLOP of
// each take 2 us at the dense bf16 rate, so both are bound by bytes once
// the products run on the tensor cores; the CUDA-core kernels spend one
// shared-memory load per FMA, and K3 restages g's planes per 16 channels.
//
// Design of the product: for an output row y, a qy row u and 16 pixels on
// the dilation lattice x0 + i*dil (i = 0..15),
//   D[16 x CG] += A_u[16 x KC] . B_u[KC x CG]
// where B_u is frame row y - pad + u*dil at columns x0 + (j - n)*dil, j =
// 0..KC-1 (n = (win-1)/2), and A_u[i, j] = g[y, x0+i*dil, ix*win + iy] at
// j = i + v, v = 0..win-1 (ix = v, iy = u; both mirrored when fwd), 0
// elsewhere: each row of A holds one pixel's own band of win g values. On
// the lattice the band is win wide for every dil, so KC = 32 (two k16
// steps of `mma.sync.m16n8k16` bf16 -> f32) covers TW + win - 1 <= 24
// columns at every window and dilation.
// - Blocks: 256 threads, one (TH x TW lattice tile, CG-channel group) each;
//   warp ty owns tile row ty: 16 pixels x CG = 32 channels, 16 f32 sums a
//   lane. Four blocks per SM for d_ref, two for d_frame.
// - Staging, once per block: g (d_ref: the tile's TH rows of TW pixels,
//   20.9 KB at win 9; d_frame: the haloed TH + win - 1 rows of TW + win - 1
//   pixels, 62.5 KB), each row's pixels in the image one contiguous run at
//   dil 1, moved by 16-byte `cp.async` copies aligned in device memory (so
//   any alignment of g works), its two end chunks and everything outside
//   the image by scalar loads and zero stores; element by element at dil >
//   1, where the lattice pixels are not contiguous. And the TH + win - 1
//   frame rows x KC columns x CG channels the tile needs, as
//   cost_volume_fwd_mma.cu stages its frame slots: NHWC order, 16-byte
//   chunks through the XOR swizzle, by `cp.async` when C % 8 == 0 and the
//   frame is 16-byte aligned, else scalar loads. Columns past TW + win - 1
//   only meet zeros of A and are zero-filled without a load.
// - A: per (u, k16 step) a lane builds its fragment from the staged g row
//   (its 8 elements by scalar shared loads at offsets computed once, an
//   element that can never be in the band skipped at compile time), once
//   for all CG channels.
// - B: `ldmatrix.x4.trans` of the staged [column][channel] rows, the
//   k-major B of `mma`: two per (u, k16 step), four `mma`.
// - Output: each lane's sums, times `scale`, leave as bf16 pairs (4-byte
//   stores; 16 contiguous bytes per pixel across a lane quad), scalar when
//   C is odd or d_ref is not 4-byte aligned.
// The numbers (chip_smoke.py) are in PERF.md. Registers, shared memory and
// blocks per SM: `b2f_cost_volume_bwd_bf16_info`.
#include <climits>

#include "mma.cuh"

namespace {

using namespace b2f::mma;

constexpr int TH = 8;            // tile rows: one warp each
constexpr int TW = 16;           // tile columns: one m16 tile
constexpr int CG = 32;           // channels per block: four n8 tiles
constexpr int KC = 32;           // staged frame columns: two k16 steps
constexpr int NT = 32 * TH;      // threads per block
constexpr int CCH = CG / 8;      // 16-byte chunks per staged pixel
constexpr int NT8 = CG / 8;      // n8 tiles per warp
constexpr int KS = KC / 16;      // k16 steps

__host__ __device__ constexpr int align128(int n) { return (n + 127) / 128 * 128; }

// DFRAME: d_frame, whose A values sit at the frame slots' rows and columns
// (the staged g is the haloed tile); else d_ref (the tile's own pixels)
template <int WIN, bool DFRAME>
struct Plan {
  static constexpr int Q = WIN * WIN;
  static constexpr int N = (WIN - 1) / 2;
  static constexpr int ROWS = TH + WIN - 1;            // staged frame rows (slots)
  static constexpr int COLS = TW + WIN - 1;            // frame columns A can reach
  // staged g: GR rows of GC lattice pixels, row s / column c at lattice
  // offset s - GO / c - GO from the tile's first pixel, each row from a
  // `shift` (< 8) elements in
  static constexpr int GR = DFRAME ? ROWS : TH;
  static constexpr int GC = DFRAME ? COLS : TW;
  static constexpr int GO = DFRAME ? N : 0;
  static constexpr int G_ROW = (GC * Q + 7 + 7) / 8 * 8;
  static constexpr int G_BYTES = align128(GR * G_ROW * 2);
  static constexpr int SHIFT_BYTES = align128(GR * 4);
  static constexpr int F_BYTES = ROWS * KC * CG * 2;
  static constexpr int SMEM = G_BYTES + SHIFT_BYTES + F_BYTES;
  static_assert(COLS <= KC, "a pixel's band must fit the staged columns");
};

// What every block of one launch shares.
struct Geometry {
  const __nv_bfloat16* g;       // (B, H, W, Q): the output gradient
  const __nv_bfloat16* frame;   // (B, H, W, C): frame for d_ref, ref for d_frame
  __nv_bfloat16* out;           // (B, H, W, C)
  int H, W, C, dil;
  int tiles_x, tiles_y, groups;
  int g_off;                    // g's element offset from a 16-byte boundary
  bool frame_vec;               // 16-byte frame copies (C % 8 == 0, 16-byte aligned)
  bool pairs;                   // 4-byte output stores (C even, out 4-byte aligned)
};

// a block's tile: TH x TW pixels on the dilation lattice, (y0 + ty*dil,
// x0 + i*dil), and its channels from c0. Channel groups fastest, then
// tile columns, rows, images; the lattice tiles of one span of TH*dil rows
// (TW*dil columns) are its dil residues.
struct Tile {
  int b, y0, x0, c0;
  __device__ Tile(int blk, const Geometry& g) {
    c0 = blk % g.groups * CG;
    int t = blk / g.groups;
    const int tx = t % g.tiles_x;
    t /= g.tiles_x;
    const int ty = t % g.tiles_y;
    b = t / g.tiles_y;
    y0 = ty / g.dil * TH * g.dil + ty % g.dil;
    x0 = tx / g.dil * TW * g.dil + tx % g.dil;
  }
};

// g's staged rows and their shifts. At dil 1 each row's pixels in the
// image are one contiguous run, brought in by 16-byte `cp.async` chunks
// aligned in device memory: the run's first value sits `shift` (its
// element offset mod 8) plus its column's offset into the staged row.
// The chunks at the run's two ends are gathered element by element, and
// chunks outside it (rows and columns outside the image) are zeroed, so
// that every staged value outside the run is 0. At dil > 1, element by
// element, 0 outside the image.
template <int WIN, bool DFRAME>
__device__ __forceinline__ void stage_g(unsigned char* smem, const Geometry& g, const Tile& t) {
  using P = Plan<WIN, DFRAME>;
  int* shifts = reinterpret_cast<int*>(smem + P::G_BYTES);
  const unsigned short* src = reinterpret_cast<const unsigned short*>(g.g);
  if (g.dil == 1) {
    constexpr int CH = P::G_ROW / 8;   // 16-byte chunks of a staged row
    const uint32_t base = smem_addr(smem);
    // the image's columns of a row: [cs, ce)
    const int cs = max(0, P::GO - t.x0), ce = min(P::GC, g.W - t.x0 + P::GO);
    const int n = (ce - cs) * P::Q;   // values of a row's run
    for (int e = threadIdx.x; e < P::GR * CH; e += NT) {
      const int s = e / CH, m = e % CH;
      const int y = t.y0 + s - P::GO;
      const uint32_t dst = base + 2 * (s * P::G_ROW + 8 * m);
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (y < 0 || y >= g.H || n <= 0) {
        if (m == 0) shifts[s] = 0;
        st_shared16(dst, v);
        continue;
      }
      // the run's first value in g, and its place in the staged row
      const size_t first =
          ((static_cast<size_t>(t.b) * g.H + y) * g.W + t.x0 - P::GO + cs) * P::Q;
      const int shift = static_cast<int>((static_cast<unsigned>(first) + g.g_off -
                                          static_cast<unsigned>(cs * P::Q)) & 7);
      if (m == 0) shifts[s] = shift;
      const int lo = 8 * m - shift - cs * P::Q;   // the run's value at the chunk's start
      if (lo >= 0 && lo + 8 <= n) {
        cp_async16(dst, g.g + (first + lo), true);
        continue;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (lo + k >= 0 && lo + k < n)
          v[k / 2] |= static_cast<uint32_t>(src[first + lo + k]) << (16 * (k % 2));
      st_shared16(dst, v);
    }
    return;
  }
  unsigned short* dst = reinterpret_cast<unsigned short*>(smem);
  for (int e = threadIdx.x; e < P::GR; e += NT) shifts[e] = 0;
  for (int e = threadIdx.x; e < P::GR * P::GC * P::Q; e += NT) {
    const int s = e / (P::GC * P::Q), r = e % (P::GC * P::Q);
    const int y = t.y0 + (s - P::GO) * g.dil, x = t.x0 + (r / P::Q - P::GO) * g.dil;
    const bool inside = y >= 0 && y < g.H && x >= 0 && x < g.W;
    dst[s * P::G_ROW + r] =
        inside ? src[((static_cast<size_t>(t.b) * g.H + y) * g.W + x) * P::Q + r % P::Q] : 0;
  }
}

// the tile's frame rows (slot s = ty + u: row y0 + (s - n)*dil) at KC
// columns (j: x0 + (j - n)*dil), channels c0 .. c0 + CG
template <int WIN>
__device__ __forceinline__ void stage_frame(uint32_t f_s, const Geometry& g, const Tile& t) {
  using P = Plan<WIN, false>;
  const size_t image = static_cast<size_t>(t.b) * g.H * g.W;
  for (int e = threadIdx.x; e < P::ROWS * KC * CCH; e += NT) {
    const int p = e / CCH, c = t.c0 + (e % CCH) * 8;
    const int s = p / KC, j = p % KC;
    const int y = t.y0 + (s - P::N) * g.dil, x = t.x0 + (j - P::N) * g.dil;
    const bool inside = j < P::COLS && y >= 0 && y < g.H && x >= 0 && x < g.W;
    stage_chunk(f_s + 16 * swz(e), g.frame, inside ? image + static_cast<size_t>(y) * g.W + x : 0,
                c, g.C, inside, g.frame_vec);
  }
}

// Where this lane's A fragment elements sit in a staged g row, for every
// qy row: element (i, j) of k16 step ks (i = row, j = column of the step)
// is the g value q = ix*WIN + iy at v = ks*16 + j - i, ix = v (mirrored
// when fwd), 0 outside 0 <= v < WIN, of pixel i (d_ref) or of staged
// column ks*16 + j (d_frame). Fragment register r holds rows lane/4 +
// 8*(r&1), columns 2*(lane%4) + 8*(r>>1) and the next. off = column*Q +
// ix*WIN (add iy for the qy row), or -1 outside the band.
template <int WIN, bool DFRAME>
__device__ __forceinline__ void a_offsets(int (&off)[KS][4][2], bool fwd) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jmin = ks * 16 + 8 * (r >> 1) + h, imin = 8 * (r & 1);
        off[ks][r][h] = -1;
        if (jmin + 6 - imin < 0 || jmin - (imin + 7) >= WIN) continue;   // never in the band
        const int i = (lane >> 2) + imin, j = jmin + 2 * (lane & 3);
        const int v = j - i;
        if (v >= 0 && v < WIN)
          off[ks][r][h] = (DFRAME ? j : i) * WIN * WIN + (fwd ? WIN - 1 - v : v) * WIN;
      }
}

// A_u's fragment of k16 step ks for the qy row iy, from the staged g row
template <int WIN>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const unsigned short* grow,
                                           const int (&off)[4][2], int iy) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t lo = off[r][0] >= 0 ? grow[off[r][0] + iy] : 0u;
    const uint32_t hi = off[r][1] >= 0 ? grow[off[r][1] + iy] : 0u;
    a[r] = lo | (hi << 16);
  }
}

// d_ref (DFRAME false): out = dref_form(g, frame, fwd). d_frame (DFRAME
// true, `frame` = ref, `fwd` mirrored by the caller): the g value that
// meets staged frame slot ty + u, column j is g at that very pixel, so g
// is staged as the haloed tile, like the frame, and no shifted copy of it
// is needed.
template <int WIN, bool DFRAME>
__global__ void __launch_bounds__(NT, DFRAME ? 2 : 4)
cost_volume_bwd_mma_kernel(Geometry g, int fwd, float scale) {
  using P = Plan<WIN, DFRAME>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile t(blockIdx.x, g);
  const uint32_t f_s = smem_addr(smem + P::G_BYTES + P::SHIFT_BYTES);
  stage_g<WIN, DFRAME>(smem, g, t);
  stage_frame<WIN>(f_s, g, t);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int ty = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int y = t.y0 + ty * g.dil;
  if (y >= g.H) return;   // warp-uniform; no barrier follows
  const unsigned short* g_s = reinterpret_cast<const unsigned short*>(smem);
  const int* shifts = reinterpret_cast<const int*>(smem + P::G_BYTES);

  float acc[NT8][4];
#pragma unroll
  for (auto& a : acc)
    for (float& v : a) v = 0.f;
  // B rows of an ldmatrix.x4.trans: k = lane%8 + 8*((lane/8)%2), channel
  // chunk lane/16 of the pair of n8 tiles
  const int jb = (lane & 7) + ((lane >> 3) & 1) * 8, cb = lane >> 4;
  int off[KS][4][2];
  a_offsets<WIN, DFRAME>(off, fwd != 0);
#pragma unroll
  for (int u = 0; u < WIN; ++u) {
    const int iy = fwd ? WIN - 1 - u : u;
    const int row = DFRAME ? ty + u : ty;   // staged g row
    const unsigned short* grow = g_s + row * P::G_ROW + shifts[row];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      a_fragment<WIN>(a, grow, off[ks], iy);
#pragma unroll
      for (int p = 0; p < NT8 / 2; ++p) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, f_s + 16 * swz(((ty + u) * KC + ks * 16 + jb) * CCH + 2 * p + cb));
        mma_bf16(acc[2 * p], a, b[0], b[1]);
        mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
      }
    }
  }

  // sums (k = 0, 1): row lane/4, channels 2*(lane%4) + k of each n8 tile;
  // (k = 2, 3): row lane/4 + 8
  const size_t row = (static_cast<size_t>(t.b) * g.H + y) * g.W;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int x = t.x0 + ((lane >> 2) + 8 * hr) * g.dil;
    if (x >= g.W) continue;
    __nv_bfloat16* o = g.out + (row + x) * g.C;
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const int c = t.c0 + nt * 8 + 2 * (lane & 3);
      const float v0 = acc[nt][2 * hr] * scale, v1 = acc[nt][2 * hr + 1] * scale;
      if (g.pairs) {
        if (c < g.C) *reinterpret_cast<__nv_bfloat162*>(o + c) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < g.C) o[c] = __float2bfloat16(v0);
        if (c + 1 < g.C) o[c + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// sets a kernel's dynamic shared-memory limit to `bytes` once per device
// and size (kept for the last ones asked for, so a launch costs no call)
template <typename Kernel>
cudaError_t smem_limit(Kernel kernel, int bytes, int* last_device, int* last_bytes) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess || (device == *last_device && bytes <= *last_bytes)) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) {
    *last_device = device;
    *last_bytes = bytes;
  }
  return e;
}

template <int WIN, bool DFRAME>
cudaError_t launch_bwd(const Geometry& g, int B, int fwd, float scale, cudaStream_t stream) {
  using P = Plan<WIN, DFRAME>;
  static int last_device = -1, last_bytes = 0;
  const long long blocks = static_cast<long long>(g.tiles_x) * g.tiles_y * B * g.groups;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t e = smem_limit(cost_volume_bwd_mma_kernel<WIN, DFRAME>, P::SMEM,
                                   &last_device, &last_bytes);
  if (e != cudaSuccess) return e;
  cost_volume_bwd_mma_kernel<WIN, DFRAME><<<static_cast<int>(blocks), NT, P::SMEM, stream>>>(
      g, fwd, scale);
  return cudaGetLastError();
}

template <bool DFRAME>
cudaError_t launch_win(const Geometry& g, int B, int win, int fwd, float scale,
                       cudaStream_t stream) {
  switch (win) {
    case 3: return launch_bwd<3, DFRAME>(g, B, fwd, scale, stream);
    case 5: return launch_bwd<5, DFRAME>(g, B, fwd, scale, stream);
    case 7: return launch_bwd<7, DFRAME>(g, B, fwd, scale, stream);
    case 9: return launch_bwd<9, DFRAME>(g, B, fwd, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace b2f {

// g: (B, H, W, win*win), other, out: (B, H, W, C), all bf16 and
// contiguous; win in {3, 5, 7, 9}, dil >= 1. d_ref (dframe 0) from (g,
// frame); d_frame (dframe 1) from (g, ref). Called by cost_volume_bwd.cu's
// entry points for bf16.
cudaError_t cost_volume_bwd_mma(const void* g, const void* other, void* out, int B, int H, int W,
                                int C, int win, int dil, int fwd, float scale, int dframe,
                                cudaStream_t stream) {
  Geometry geo;
  geo.g = static_cast<const __nv_bfloat16*>(g);
  geo.frame = static_cast<const __nv_bfloat16*>(other);
  geo.out = static_cast<__nv_bfloat16*>(out);
  geo.H = H;
  geo.W = W;
  geo.C = C;
  geo.dil = dil;
  geo.tiles_x = (W + TW * dil - 1) / (TW * dil) * dil;
  geo.tiles_y = (H + TH * dil - 1) / (TH * dil) * dil;
  geo.groups = (C + CG - 1) / CG;
  geo.g_off = static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 1) & 7);
  geo.frame_vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(other) % 16 == 0;
  geo.pairs = C % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  // d_frame is d_ref's form with the direction mirrored
  return dframe ? launch_win<true>(geo, B, win, !fwd, scale, stream)
                : launch_win<false>(geo, B, win, fwd, scale, stream);
}

}  // namespace b2f

// What the compiler and the runtime made of the bf16 backward kernels at
// the main path's win 9 (dframe 0: d_ref, 1: d_frame): registers per
// thread, local memory per thread (bytes, spills), dynamic shared memory
// per block (bytes), resident blocks per SM. Launches nothing.
template <bool DFRAME>
static int bwd_info(int* regs, int* local_bytes, int* smem, int* blocks_per_sm) {
  static int last_device = -1, last_bytes = 0;
  const auto kernel = cost_volume_bwd_mma_kernel<9, DFRAME>;
  const int bytes = Plan<9, DFRAME>::SMEM;
  cudaError_t e = smem_limit(kernel, bytes, &last_device, &last_bytes);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem = bytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, NT, bytes);
}

extern "C" int b2f_cost_volume_bwd_bf16_info(int dframe, int* regs, int* local_bytes, int* smem,
                                             int* blocks_per_sm) {
  return dframe ? bwd_info<true>(regs, local_bytes, smem, blocks_per_sm)
                : bwd_info<false>(regs, local_bytes, smem, blocks_per_sm);
}
