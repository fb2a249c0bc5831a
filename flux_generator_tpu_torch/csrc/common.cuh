// Warp-level tensor-core helpers shared by the port's kernels (sm_90a).
//
// mma.sync m16n8k16 with bf16 operands and f32 accumulators. Fragment layout
// (g = lane / 4, t = lane % 4), each 32-bit register holding two bf16 with the
// lower index in the low half:
//   A (16 x 16, row major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B (16 x 8, k x n):      b0 = B[2t..2t+1][g],  b1 = B[2t+8..2t+9][g]
//   C (16 x 8, f32):        c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fgt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a · b on one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a · b on one m16n8k32 tile with s8 operands and s32 accumulators. The
// fragments hold four int8 per register, lower index in the low byte, at the
// byte positions of the bf16 layout above (g = lane / 4, t = lane % 4):
//   A (16 x 32, row major): a0 = A[g][4t..4t+3], a1 = A[g+8][4t..], a2 = A[g][4t+16..], a3 = A[g+8][4t+16..]
//   B (32 x 8, k x n):      b0 = B[4t..4t+3][g], b1 = B[4t+16..4t+19][g]
//   C (16 x 8, s32):        as the f32 C above
__device__ __forceinline__ void mma_s8_16832(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 values (taken mod 256) packed low byte first.
__device__ __forceinline__ uint32_t pack_s8x4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Four 8x8 matrices of 16-bit elements from shared memory (lanes 8i..8i+7 give
// the row addresses of matrix i, 16-byte aligned); lane l receives row l / 4,
// elements 2(l % 4) and 2(l % 4) + 1 of each. Read as int8, an m16n8k32 A
// fragment is rows (l % 16) at byte (l / 16) · 16, and the B fragments of two
// n8 tiles of K-contiguous rows are rows (l % 8) + 8 (l / 16) at byte
// ((l / 8) % 2) · 16.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

}  // namespace fgt
