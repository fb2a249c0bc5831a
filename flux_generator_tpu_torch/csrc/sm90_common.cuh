// Hopper (sm_90a) pieces shared by the wgmma/TMA kernels: kernel A's bf16 mode
// (flash_attention_sm90.cu) and int8 tiers (flash_attention.cu), kernel B's bf16
// route (int4_matmul.cu), kernels E and F (flash_attention_bwd.cu), kernel G's
// GEMM (w8a8_matmul.cu) and the bare-dot probe's bf16 mode (bare_dot.cu).
//
// - mbarriers: init, arrive, arrive with an expected byte count, and a bare
//   try_wait spin (see mbar_wait for why it has no poll limit);
// - TMA: one box of a 2-D or 4-D tensor map into shared memory, completion
//   counted on an mbarrier, and a 2-D or 4-D store from shared memory in bulk
//   groups;
//   `encode_map` builds the map of a (B, L, H, D) bf16 tensor as (D, H, L, B)
//   with boxes of 64 values × `rows` rows of one (batch, head) and a 128-byte
//   swizzle, so a (batch, head) is read in place and rows past L come in as
//   zeros; `encode_map_2d` the map of a row-major matrix of any element type;
// - wgmma: the shared-memory descriptor of a 128- or 64-byte-swizzled operand, fence,
//   commit and wait, bf16 products m64n128k16 and m64n64k16 with both operands
//   in shared memory (A K-major, B K-major or MN-major) or with A from
//   registers and B MN-major (m64n128k16, m64n64k16) or K-major (m64n256k16,
//   m64n128k16) in shared memory, the int8 products m64n128k32
//   and m64n192k32 (s32 sums, both operands K-major in shared memory: int8
//   wgmma takes no other layout), and `pack_frag`, which turns an f32 accumulator tile into
//   the bf16 A fragments of the next product;
// - named-barrier turns that order two consumer warpgroups' products.
//
// Operand layouts (BOX = 64 bf16 values, one 128-byte swizzle row). A tile of
// `rows` rows × D columns sits in shared memory as D/64 boxes of rows × 128
// bytes, each 1024-byte aligned. As a K-major operand (rows = M or N, the
// columns the contraction) k16 step kk starts at box kk/4, byte (kk%4)·32,
// with SBO 1024 (eight rows). As an MN-major B operand (rows = the
// contraction, the columns N) k16 step kk starts 16 rows further, with LBO
// the size of a box (the next 64 columns) and SBO 1024. An int8 k32 step is
// the same 32 bytes of a swizzled row, so int8 tiles step as bf16 ones do.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace fgt {
namespace sm90 {

constexpr int BOX = 64;  // bf16 values in one 128-byte swizzled row of a TMA box
constexpr int ROW_BYTES = BOX * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase of this parity has completed. (A poll count
// with a __trap() after too many polls made ptxas hold the consumers to the
// launch's 168 registers: spills, and wgmma serialized, warning C7512.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map (coordinates innermost first) into shared memory;
// completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-D tensor map (column, row) into shared memory; completion
// counts its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One box of shared memory to a 2-D tensor map (column, row), in the thread's
// current bulk group; the map clips what lies past the tensor's edges.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
// One box of shared memory to a 4-D tensor map (coordinates innermost first),
// in the thread's current bulk group; the map clips what lies past the edges.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// Generic-proxy writes to shared memory made visible to TMA (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (SW128).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// As desc_sw128 for a 64-byte-swizzled operand (rows of 64 bytes, layout type 2).
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (2ull << 62);
}

// Named barriers 1 and 2 order the two consumer warpgroups' products: a
// warpgroup syncs on its own before it issues and arrives on the other's after.
__device__ __forceinline__ void turn_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void turn_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }
// Wait until at most N of this warpgroup's commit groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma registers across an
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define FGT_D8(b) \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), "+f"(d[b + 5]), \
      "+f"(d[b + 6]), "+f"(d[b + 7])
#define FGT_I8(b) \
  "+r"(d[b + 0]), "+r"(d[b + 1]), "+r"(d[b + 2]), "+r"(d[b + 3]), "+r"(d[b + 4]), "+r"(d[b + 5]), \
      "+r"(d[b + 6]), "+r"(d[b + 7])
#define FGT_REGS32                                                                                 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, " \
  "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define FGT_REGS64                                                                                  \
  FGT_REGS32                                                                                        \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, " \
  "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define FGT_REGS96 \
  FGT_REGS64 \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79" \
  ", %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"

// d (+)= A·B, m64n128k16, A and B K-major in shared memory; d is overwritten
// when `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FGT_REGS64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FGT_D8(0), FGT_D8(8), FGT_D8(16), FGT_D8(24), FGT_D8(32), FGT_D8(40), FGT_D8(48), FGT_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A·B, m64n128k16, A K-major and B MN-major (its rows the contraction)
// in shared memory; d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_ss_n128_bmn(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FGT_REGS64 "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : FGT_D8(0), FGT_D8(8), FGT_D8(16), FGT_D8(24), FGT_D8(32), FGT_D8(40), FGT_D8(48), FGT_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A·B in int8 with exact s32 sums, m64n128k32, A and B K-major in
// shared memory; d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" FGT_REGS64 "}, %64, %65, p;\n}\n"
      : FGT_I8(0), FGT_I8(8), FGT_I8(16), FGT_I8(24), FGT_I8(32), FGT_I8(40), FGT_I8(48), FGT_I8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// As above with N = 192.
__device__ __forceinline__ void wgmma_s8(int (&d)[96], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {" FGT_REGS96 "}, %96, %97, p;\n}\n"
      : FGT_I8(0), FGT_I8(8), FGT_I8(16), FGT_I8(24), FGT_I8(32), FGT_I8(40), FGT_I8(48), FGT_I8(56),
        FGT_I8(64), FGT_I8(72), FGT_I8(80), FGT_I8(88)
      : "l"(da), "l"(db), "r"(accumulate));
}

// As above with N = 64.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" FGT_REGS32 "}, %32, %33, p;\n}\n"
      : FGT_I8(0), FGT_I8(8), FGT_I8(16), FGT_I8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A·B in int8 with exact s32 sums, m64n128k32: A from registers (the
// m16n8k32 A fragment of this thread's warp's 16 rows, four int8 a register),
// B K-major in shared memory; d is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" FGT_REGS64 "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : FGT_I8(0), FGT_I8(8), FGT_I8(16), FGT_I8(24), FGT_I8(32), FGT_I8(40), FGT_I8(48), FGT_I8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// As above with N = 64.
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" FGT_REGS32 "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : FGT_I8(0), FGT_I8(8), FGT_I8(16), FGT_I8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// As wgmma_ss_n128 with N = 64.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" FGT_REGS32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FGT_D8(0), FGT_D8(8), FGT_D8(16), FGT_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A·B, m64nNk16 with N = 64 or 128: A from registers (the m16n8k16 A
// fragment of this thread's warp's 16 rows), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FGT_REGS64 "}, {%64, %65, %66, %67}, %68, "
      "p, 1, 1, 1;\n}\n"
      : FGT_D8(0), FGT_D8(8), FGT_D8(16), FGT_D8(24), FGT_D8(32), FGT_D8(40), FGT_D8(48), FGT_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" FGT_REGS32 "}, {%32, %33, %34, %35}, %36, "
      "p, 1, 1, 1;\n}\n"
      : FGT_D8(0), FGT_D8(8), FGT_D8(16), FGT_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define FGT_REGS128 \
  FGT_REGS96 \
  ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111" \
  ", %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// d += A·B, m64n256k16: A from registers (as wgmma_rs), B K-major in shared
// memory (its rows the N side, the contraction along a swizzled row).
__device__ __forceinline__ void wgmma_rs_bk(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" FGT_REGS128 "}, {%128, %129, %130, %131}, "
      "%132, p, 1, 1, 0;\n}\n"
      : FGT_D8(0), FGT_D8(8), FGT_D8(16), FGT_D8(24), FGT_D8(32), FGT_D8(40), FGT_D8(48), FGT_D8(56),
        FGT_D8(64), FGT_D8(72), FGT_D8(80), FGT_D8(88), FGT_D8(96), FGT_D8(104), FGT_D8(112), FGT_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// As above with N = 128.
__device__ __forceinline__ void wgmma_rs_bk(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FGT_REGS64 "}, {%64, %65, %66, %67}, %68, "
      "p, 1, 1, 0;\n}\n"
      : FGT_D8(0), FGT_D8(8), FGT_D8(16), FGT_D8(24), FGT_D8(32), FGT_D8(40), FGT_D8(48), FGT_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FGT_D8
#undef FGT_I8
#undef FGT_REGS32
#undef FGT_REGS64
#undef FGT_REGS96
#undef FGT_REGS128

// This thread's f32 share of a 64 × 2N accumulator tile as bf16 A fragments:
// columns 16kk..16kk+15 (n8 groups 2kk and 2kk + 1) are the A fragment of
// k16 step kk.
template <int N>
__device__ __forceinline__ void pack_frag(const float (&sc)[N], uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    pa[kk][0] = pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A (B, L, H, D) contiguous bf16 tensor as a 4-D map (D, H, L, B) with boxes of
// 64 values × `rows` rows of one (batch, head), 128-byte swizzle, zero fill.
inline bool encode_map(CUtensorMap* map, const void* ptr, int B, int L, int H, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(L) * H * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(BOX), 1u, static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major matrix of `rows` rows × `cols` elements of `type` (`elem_bytes`
// each; rows `pitch` bytes apart, a multiple of 16) as a 2-D map (column, row)
// with boxes of box_cols × box_rows, zero fill past the edges on loads.
inline bool encode_map_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, uint64_t cols,
                          uint64_t rows, uint64_t pitch, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1u, 1u};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace fgt
