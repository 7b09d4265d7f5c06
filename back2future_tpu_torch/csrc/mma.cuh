// Shared-memory, cp.async, ldmatrix and mma.sync helpers of the cost
// volume's bf16 tensor-core kernels (cost_volume_fwd_mma.cu,
// cost_volume_bwd_mma.cu).
#pragma once

#include "common.cuh"

namespace b2f {
namespace mma {

// 16-byte chunk index -> its place: slot (0..7) within the 128-byte line
// XORed with the line index mod 4, so that `ldmatrix` rows 64 bytes apart
// (pixels of 32 bf16 channels) hit 8 distinct bank groups
__device__ __forceinline__ int swz(int chunk) { return chunk ^ ((chunk >> 3) & 3); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group of copies is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// wait until every committed group of copies has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// four 8 x 8 matrices, each transposed on the way: from rows of a k-major
// ([k][n], n contiguous) array, the `mma` B fragments
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// one 16-byte chunk (8 channels from c) of pixel `pix` of `base` into
// shared memory at `dst`, or zeros where the pixel is outside the image
// or the channels past C: a `cp.async` when `vec` (C % 8 == 0, `base`
// 16-byte aligned), else scalar loads and one 16-byte store
__device__ __forceinline__ void stage_chunk(uint32_t dst, const __nv_bfloat16* __restrict__ base,
                                            size_t pix, int c, int C, bool inside, bool vec) {
  if (vec) {
    const bool valid = inside && c < C;
    cp_async16(dst, valid ? base + pix * C + c : base, valid);
    return;
  }
  const unsigned short* src = reinterpret_cast<const unsigned short*>(base) + pix * C + c;
  uint32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = inside && c + 2 * k < C ? src[2 * k] : 0u;
    const uint32_t hi = inside && c + 2 * k + 1 < C ? src[2 * k + 1] : 0u;
    v[k] = lo | (hi << 16);
  }
  st_shared16(dst, v);
}

}  // namespace mma
}  // namespace b2f
