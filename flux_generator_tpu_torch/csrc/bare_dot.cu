// The bare-dot probe (#13) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dot_kernel` of scripts/prof_attn_int8.py
// (pallas_call at :76, called by `bare_dot`), the probe that asks whether
// int8 attention loses its time in the int8 matrix unit or in quantizing
// inside the kernel. With its BlockSpecs it computes, for a (steps·BM, K) and
// b (K, steps·BN), out[i·BM:(i+1)·BM] = a_blk(i) · b_blk(i) in bf16, where
// a_blk(i) is rows i·BM.. of a and b_blk(i) columns i·BN.. of b, i < steps:
//   BF16:        bf16 in, f32 sums, rounded to bf16;
//   INT8:        int8 in, int32 sums, → f32 → bf16;
//   INT8_QUANT:  bf16 in; each a row and each b column (over K) is quantized
//                inside the kernel, s = max(amax, 1e-20) / 127 and
//                x_i = clip(rint(x / s), ±127), then (f32(int32 dot) · s_a)
//                · s_b → bf16. The division by 127 is the product with
//                f32(1/127), as XLA compiles the script's `/ 127.0`; x / s is
//                an IEEE division (correctly rounded, not fast math).
// The quantization stays inside the kernel, once a step for each a row and
// each b column, as the TPU kernel quantizes once a grid step: its cost is
// what the probe measures.
//
// Bound: at the probe's shape (BM = BN = 1024, K = 128, 64 steps) a step
// moves 2.62 MB (the bf16 a and b blocks and the bf16 output, each once) for
// 0.27 GFLOP: 168 MB in all, 0.050 ms at 3.35 TB/s against 0.017 ms of bf16
// tensor-core work, so bytes bound it, the output (134 MB) above all. INT8
// reads half the input bytes: 151 MB, 0.045 ms.
//
// BF16 (the probe's control: the int8 modes' ratios are read against it) is
// designed for those bytes: persistent blocks of three warpgroups walk the
// 128 × 128 output tiles with a stride of the grid, column tiles fastest, so
// that the blocks that run together write whole neighbouring row bands of
// out. Warpgroup 0's first thread loads each tile's a rows (K-major, boxes of
// 64 values × 128 rows) and b columns (row-major, boxes of 64 columns × K
// rows: the MN-major B operand) with TMA into a ring of stages; warpgroups 1
// and 2 each take 64 rows: wgmma m64n128k16 with both operands in shared
// memory, then the sums go to bf16 in a 128-byte-swizzled staging buffer
// (OUT_BUFS a warpgroup, taken in turns) that one thread stores with TMA. A
// tile's store thus overlaps the next tiles' loads and products, and no
// thread waits for a store but the one that reuses its buffer OUT_BUFS tiles
// later. The ring has as many stages as fit beside the staging buffers (2 at
// K 128). On the H100 the stores take most of the time (the output is 134 MB
// of the 168), and where the blocks write matters: column tiles first was
// faster than row tiles first, and contiguous runs of tiles a block (each
// band's a rows loaded once, but the blocks' writes spread over the whole
// output) far slower; a third staging buffer bought nothing.
//
// The int8 modes are built for the same bytes, and for Hopper's int8 wgmma,
// which takes both operands K-major only: b arrives MN-major (its rows are
// K). So the roles are swapped: a block computes outᵀ tiles, b's columns as
// the product's M side (the A operand, in registers) and a's rows as its N
// side (the B operand, K-major in shared memory as a lies). The unit of work
// is (step, 128-column tile of b): the block gathers the tile's int8 A
// fragments once, from a TMA load of b's K × 128 box that the first consumer
// thread issues a unit ahead, keeps them in registers (4·K/32 a thread), and
// walks the step's BM / 128 row tiles of a: wgmma m64n128k32 .s32.s8.s8, one
// consumer warpgroup a 64 columns of b. (Keeping b for the step beat column
// tiles first, with b loaded and gathered every tile.) The s32
// sums convert to f32 by a magic number: |Σ| ≤ 256 · 128 · 128 = 2^22, and
// x + 1.5·2^23 is exact up to that bound on both sides (at +2^22 the mantissa
// carries into the exponent, 2^24 − 1.5·2^23 = 2^22). The epilogue takes the
// transpose with stmatrix .trans: each n8 group of sums is an 8 × 8 (n, m)
// fragment, stored as rows m of a 128-byte-swizzled staging buffer
// (conflict-free), which one thread stores with TMA, as in BF16. Persistent
// blocks take the units with a stride of the grid, so the blocks that run
// together write neighbouring column tiles of one row band.
// INT8: warpgroup 0's first thread loads each row tile of a (boxes of 128
// bytes × 128 rows) with TMA into a ring of stages.
// INT8_QUANT: a cluster of C blocks takes a unit of C column tiles of one
// step (C the largest divisor of BN / 128 up to 8: the whole step at the
// probe's BN 1024), block r the r-th. Each block's consumers quantize its
// b columns once, in registers, as they gather them from the TMA load of the
// bf16 tile (a column's K values lie in one quad of lanes: amax by two
// shuffles). Warpgroup 0 is the quantizer of a: for each row tile it
// quantizes rows [128r/C, 128(r+1)/C) (16 at C 8; K/16 lanes a row, 16
// values a lane, read by cp.async a few passes ahead) and writes each row,
// K-major and swizzled as wgmma reads it, with its scale into the stage of
// every block of the cluster by st.async, each store completing its bytes on
// that block's full barrier; each block's consumers, done with a stage,
// arrive on every block's empty barrier. So each a row and each b column is
// quantized once a step when C = BN / 128 (a rows BN / 128 / C times
// otherwise), and quantizing overlaps the products and stores of the tiles
// before. (Rows written locally, then a proxy fence and bulk copies to the
// peers, were slower: the fence waits for the thread's cp.async reads.)
// x / s is a / s for a = |x| from rb = RN(1/s) with two Markstein
// corrections, correctly rounded as the IEEE quotient, and rint by the magic
// number, whose low byte is the int8 level.

#include <cstring>

#include "sm90_common.cuh"

namespace {

using fgt::bf16;
using namespace fgt::sm90;

constexpr int TM = 128;  // output rows a tile
constexpr int TN = 128;  // output columns a tile

enum Mode : int { kBf16 = 0, kInt8 = 1, kInt8Quant = 2 };

// ---- BF16: persistent wgmma kernel ----

constexpr int H_THREADS = 384;   // the producer warpgroup and two consumer warpgroups
constexpr int H_CONSUMERS = 256;
constexpr int A_BOX = TM * ROW_BYTES;     // 64 values × 128 rows of a
constexpr int OUT_BOX = 64 * ROW_BYTES;   // 64 columns × 64 rows of out
constexpr int OUT_BUFS = 2;               // staging buffers a consumer warpgroup takes in turn
constexpr int OUT_BYTES = 2 * OUT_BUFS * 2 * OUT_BOX;  // two consumers × OUT_BUFS × two boxes
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ constexpr int a_boxes(int K) { return (K + BOX - 1) / BOX; }
__host__ __device__ constexpr int stage_bytes(int K) { return a_boxes(K) * A_BOX + 2 * K * ROW_BYTES; }
// the ring's stages: as many as fit beside the staging buffers, at most MAX_STAGES
__host__ __device__ constexpr int ring_stages(int K) {
  return (SMEM_LIMIT - 1024 - OUT_BYTES - 2 * MAX_STAGES * 8) / stage_bytes(K) < MAX_STAGES
             ? (SMEM_LIMIT - 1024 - OUT_BYTES - 2 * MAX_STAGES * 8) / stage_bytes(K)
             : MAX_STAGES;
}
__host__ __device__ constexpr int bf16_smem(int K) {
  return ring_stages(K) * stage_bytes(K) + OUT_BYTES + 2 * MAX_STAGES * 8 + 1024;
}

__global__ void __launch_bounds__(H_THREADS, 1)
bare_dot_bf16_sm90_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                          const __grid_constant__ CUtensorMap tm_out, int K, int BM, int BN, int steps) {
  extern __shared__ unsigned char smem_raw[];
  const int stages = ring_stages(K);
  const int sbytes = stage_bytes(K);
  const int boxes = a_boxes(K);
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t out0 = base + stages * sbytes;
  const uint32_t bars = out0 + OUT_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (MAX_STAGES + s); };
  const int m_tiles = BM / TM;
  const int n_tiles = BN / TN;
  const int tiles = m_tiles * n_tiles * steps;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), H_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: each tile's a rows and b columns
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
        const int mt = (tile / n_tiles) % m_tiles;
        const int nt = tile % n_tiles;
        const int step = tile / (m_tiles * n_tiles);
        const int s = it % stages;
        mbar_wait(empty(s), ((it / stages) & 1) ^ 1);
        mbar_expect_tx(full(s), sbytes);
        const uint32_t sa = base + s * sbytes;
        const uint32_t sb = sa + boxes * A_BOX;
        for (int x = 0; x < boxes; ++x) tma_load_2d(sa + x * A_BOX, &tm_a, full(s), x * BOX, step * BM + mt * TM);
        for (int x = 0; x < 2; ++x) {
          tma_load_2d(sb + x * K * ROW_BYTES, &tm_b, full(s), step * BN + nt * TN + x * BOX, 0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows [cw·64, cw·64 + 64) of each tile; the
  // sums of n8 column group j are acc[4j..4j+3] (rows g and g + 8 of the
  // thread's warp, columns 8j + 2t and + 1)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int g = (tid % 32) >> 2;
  const int t = tid & 3;
  const int wg_bar = 1 + cw;  // named barrier of this warpgroup's 128 threads
  float acc[64];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int mt = (tile / n_tiles) % m_tiles;
    const int nt = tile % n_tiles;
    const int step = tile / (m_tiles * n_tiles);
    const int s = it % stages;
    mbar_wait(full(s), (it / stages) & 1);
    const uint32_t sa = base + s * sbytes + cw * 64 * ROW_BYTES;
    const uint32_t sb = base + s * sbytes + boxes * A_BOX;
    wgmma_fence();
    for (int kk = 0; kk < K / 16; ++kk) {  // a: box kk/4, 32 bytes along its rows; b: 16 rows further
      wgmma_ss_n128_bmn(acc, desc_sw128(sa + (kk / 4) * A_BOX + (kk % 4) * 32, 16, 1024),
                        desc_sw128(sb + kk * 16 * ROW_BYTES, K * ROW_BYTES, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(empty(s));

    // bf16 into this warpgroup's staging buffer (it % OUT_BUFS), 128-byte swizzled as
    // the map stores it: 16-byte chunk c of row r sits at chunk c ^ (r % 8)
    const uint32_t buf = out0 + (cw * OUT_BUFS + it % OUT_BUFS) * 2 * OUT_BOX;
    if (tid == 0) bulk_wait_read<OUT_BUFS - 1>();  // the store from this buffer OUT_BUFS tiles ago has read it
    asm volatile("bar.sync %0, 128;\n" ::"r"(wg_bar) : "memory");
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        const uint32_t addr = buf + (j / 8) * OUT_BOX + r * ROW_BYTES + (((j % 8) ^ (r % 8)) * 16) + t * 4;
        const uint32_t v = fgt::pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
      }
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(wg_bar) : "memory");
    if (tid == 0) {
      const int row = step * BM + mt * TM + cw * 64;
      tma_store_2d(&tm_out, buf, nt * TN, row);
      tma_store_2d(&tm_out, buf + OUT_BOX, nt * TN + BOX, row);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();
}

// setmaxnreg moves registers inside the block's allocation: the consumers'
// 232 and the producer's 40 must fit in what the block got at launch, or the
// consumers' setmaxnreg.inc would wait forever.
constexpr int REG_POOL = 128 * 40 + H_CONSUMERS * 232;

cudaError_t launch_bf16(const void* a, const void* b, bf16* out, int K, int BM, int BN, int steps, cudaStream_t st) {
  static bool regs_checked = false;
  cudaError_t err;
  if (!regs_checked) {
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, bare_dot_bf16_sm90_kernel)) != cudaSuccess) return err;
    if (attr.numRegs * H_THREADS < REG_POOL) return cudaErrorInvalidConfiguration;
    regs_checked = true;
  }
  const int smem = bf16_smem(K);
  err = cudaFuncSetAttribute(bare_dot_bf16_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(steps) * BM;
  const int64_t cols = static_cast<int64_t>(steps) * BN;
  CUtensorMap ta, tb, to;
  if (!encode_map_2d(&ta, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, rows, 2ull * K, BOX, TM,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map_2d(&tb, b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cols, K, 2ull * cols, BOX, K,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map_2d(&to, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, BN, rows, 2ull * BN, BOX, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  const int64_t tiles = static_cast<int64_t>(BM / TM) * (BN / TN) * steps;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  bare_dot_bf16_sm90_kernel<<<grid, H_THREADS, smem, st>>>(ta, tb, to, K, BM, BN, steps);
  return cudaGetLastError();
}

// ---- INT8 and INT8_QUANT: persistent int8 wgmma kernel, b as the A operand ----

constexpr int I_BOX = TM * 128;   // 128 rows × 128 bytes of int8 a: one swizzled box
constexpr int I_OUT = TM * ROW_BYTES;  // a warpgroup's staging buffer: 128 rows × 64 bf16 columns
constexpr int MAX_CLUSTER = 8;
constexpr int I_MAX_STAGES = 8;
constexpr int Q_SLOTS = 4;        // the quantizer's cp.async ring: passes of a rows read ahead
constexpr int Q_SLOT = 128 * 32;  // 32 bytes (16 bf16) a thread of warpgroup 0
constexpr float MAGIC = 12582912.f;  // 1.5 · 2^23: x + MAGIC holds rint(x) in its low mantissa bits
constexpr int MAGIC_BITS = 0x4B400000;

// The shared-memory layout of a mode at K (offsets from the 1024-aligned
// base): the ring of a stages, b's box (int8 K × 128 bytes, or bf16 as two
// boxes of 64 columns × K rows), the staging buffers (2 warpgroups ×
// OUT_BUFS), and for INT8_QUANT the a rows' scales a stage and the
// quantizer's cp.async slots; then the barriers.
template <int MODE, int K>
struct I8Layout {
  static constexpr bool QUANT = MODE == kInt8Quant;
  static constexpr int BOXES = (K + 127) / 128;
  static constexpr int STAGE = BOXES * I_BOX;
  static constexpr int B_BYTES = (QUANT ? 2 : 1) * K * 128;
  static constexpr int OUT_ALL = 2 * OUT_BUFS * I_OUT;
  static constexpr int SCALE = QUANT ? TM * 4 : 0;  // a stage's row scales
  static constexpr int SLOTS = QUANT ? Q_SLOTS * Q_SLOT : 0;
  static constexpr int BARS = 2 * I_MAX_STAGES + 2;  // full, empty a stage; b full, b empty
  static constexpr int FIXED = 1024 + B_BYTES + OUT_ALL + SLOTS + BARS * 8;
  static constexpr int FIT = (SMEM_LIMIT - FIXED) / (STAGE + SCALE);
  static constexpr int STAGES = FIT < I_MAX_STAGES ? FIT : I_MAX_STAGES;
  static constexpr int B_OFF = STAGES * STAGE;
  static constexpr int OUT_OFF = B_OFF + B_BYTES;
  static constexpr int SCALE_OFF = OUT_OFF + OUT_ALL;
  static constexpr int SLOT_OFF = SCALE_OFF + STAGES * SCALE;
  static constexpr int BAR_OFF = SLOT_OFF + SLOTS;
  static constexpr int SMEM = 1024 + BAR_OFF + BARS * 8;
  static_assert(STAGES >= 2, "two stages at least");
};

// Registers a thread after setmaxnreg: warpgroup 0 (INT8's TMA thread, or
// INT8_QUANT's quantizer) and the two consumer warpgroups.
template <int MODE>
struct I8Regs {
  static constexpr int PRODUCER = MODE == kInt8Quant ? 96 : 40;
  static constexpr int CONSUMER = MODE == kInt8Quant ? 200 : 232;
  static constexpr int POOL = 128 * PRODUCER + H_CONSUMERS * CONSUMER;
};

// Thread-block clusters: this block's rank, the cluster's index and count (a
// launch with clusters of one block has them too), an address in block
// `rank`'s shared memory and an arrival on its barrier.
__device__ __forceinline__ int cluster_reg(int which) {
  uint32_t v;
  if (which == 0) asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  else if (which == 1) asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(v));
  else asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(v));
  return static_cast<int>(v);
}
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(v) : "r"(addr), "r"(rank));
  return v;
}
// An arrival with the default (CTA-scope) release: it tells a peer that this
// warpgroup is done reading a stage, which orders no data of its own (a
// cluster-scope release held each tile's epilogue back).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar_cluster) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar_cluster) : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float quant_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-20f), 1.f / 127.f);
}

// a / b correctly rounded for 0 ≤ a and normal b, from rb = RN(1 / b): two
// Markstein corrections of a·rb (IEEE division's fast path, without its range
// check: here b ≥ 1e-20/127 and a ≤ 127.5·b).
__device__ __forceinline__ float div_rb(float a, float b, float rb) {
  float q = __fmul_rn(a, rb);
  float r = __fmaf_rn(-b, q, a);
  q = __fmaf_rn(r, rb, q);
  r = __fmaf_rn(-b, q, a);
  return __fmaf_rn(r, rb, q);
}

// clip(rint(x / s), ±127) + MAGIC: its low byte is the int8 level. Clipping
// before rint gives the same level: rint maps (127, 127.5] to 127.
__device__ __forceinline__ uint32_t quant_bits(float x, float s, float rs) {
  const float q = copysignf(fminf(div_rb(fabsf(x), s, rs), 127.f), x);
  return __float_as_uint(__fadd_rn(q, MAGIC));
}

// Low bytes of four words, the first in the low byte.
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// float(x) for |x| ≤ 2^22, exact, by the magic number (no conversion unit)
__device__ __forceinline__ float i2f(int x) { return __fsub_rn(__int_as_float(x + MAGIC_BITS), MAGIC); }

__device__ __forceinline__ float bf16_bits(uint32_t lo16) { return __uint_as_float(lo16 << 16); }

__device__ __forceinline__ uint32_t lds_u8(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

template <int MODE, int KS>
__global__ void __launch_bounds__(H_THREADS, 1)
bare_dot_i8_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_out, const bf16* __restrict__ a, int BM, int BN,
                   int steps, int C) {
  constexpr int K = 32 * KS;
  using L = I8Layout<MODE, K>;
  using R = I8Regs<MODE>;
  constexpr bool QUANT = L::QUANT;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_s = base + L::B_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (I_MAX_STAGES + s); };
  const uint32_t b_full = bars + 8u * 2 * I_MAX_STAGES;
  const uint32_t b_empty = b_full + 8u;
  const int m_tiles = BM / TM;
  const int groups = BN / TN / C;  // units a step: groups of C column tiles (INT8: C = 1)
  const int units = steps * groups;
  // INT8: blocks take units blockIdx.x, + gridDim.x, ...; INT8_QUANT: clusters
  // take units by their index, block r of a cluster column tile r of the group
  const int rank = QUANT ? cluster_reg(0) : 0;
  const int first = QUANT ? cluster_reg(1) : static_cast<int>(blockIdx.x);
  const int stride = QUANT ? cluster_reg(2) : static_cast<int>(gridDim.x);
  const int wg = threadIdx.x / 128;
  // a unit's b columns, issued by the first consumer thread one unit ahead:
  // the int8 box, or the two bf16 boxes
  auto load_b = [&](int u) {
    const int col = (u / groups) * BN + ((u % groups) * C + rank) * TN;
    mbar_expect_tx(b_full, L::B_BYTES);
    tma_load_2d(b_s, &tm_b, b_full, col, 0);
    if constexpr (QUANT) tma_load_2d(b_s + K * 128, &tm_b, b_full, col + BOX, 0);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);                             // the quantizer's or the TMA thread's arrival
      mbar_init(empty(s), QUANT ? 2 * C : H_CONSUMERS);  // each block's two consumer warpgroups, or every consumer
    }
    mbar_init(b_full, 1);
    mbar_init(b_empty, H_CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (QUANT) cluster_sync();  // every block's barriers before any remote arrival

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R::PRODUCER));
    if constexpr (!QUANT) {
      if (threadIdx.x == 0) {  // each unit's row tiles of a, through the ring
        int it = 0;
        for (int u = first; u < units; u += stride) {
          const int step = u / groups;
          for (int mt = 0; mt < m_tiles; ++mt, ++it) {
            const int s = it % STAGES;
            mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(full(s), L::STAGE);
#pragma unroll
            for (int x = 0; x < L::BOXES; ++x) {
              tma_load_2d(base + s * L::STAGE + x * I_BOX, &tm_a, full(s), x * 128, step * BM + mt * TM);
            }
          }
        }
      }
    } else {
      // the quantizer: this block's rows [r0, r1) of each row tile, RPP rows a
      // pass (LR lanes a row, lane l of a row holding values 16l..16l+15),
      // read by cp.async Q_SLOTS - 1 passes ahead
      constexpr int LR = K <= 32 ? 2 : K <= 64 ? 4 : K <= 128 ? 8 : 16;  // a power of two ≥ K / 16
      constexpr int RPP = 4 * (32 / LR);
      const int tid = threadIdx.x;
      const int l = tid % LR;
      const int prow = tid / LR;  // the thread's row within a pass
      const int r0 = rank * (TM / 4) / C * 4;  // whole 16-byte runs of scales
      const int r1 = (rank + 1) * (TM / 4) / C * 4;
      const int passes = (r1 - r0 + RPP - 1) / RPP;
      const bool lane_on = l * 16 < K;
      const uint32_t slots = base + L::SLOT_OFF + tid * 32;
      // the pass that cp.async reads ahead: unit iu (its step), row tile imt, pass ip
      int iu = first, istep = first / groups, imt = 0, ip = 0, iq = 0;
      auto issue = [&]() {
        const int row = r0 + ip * RPP + prow;
        if (iu < units && lane_on && row < r1) {
          const bf16* src = a + (static_cast<int64_t>(istep) * BM + imt * TM + row) * K + l * 16;
          const uint32_t dst = slots + (iq % Q_SLOTS) * Q_SLOT;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 16), "l"(src + 8) : "memory");
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        ++iq;
        if (++ip == passes) {
          ip = 0;
          if (++imt == m_tiles) {
            imt = 0;
            iu += stride;
            istep = iu / groups;
          }
        }
      };
      for (int q = 0; q < Q_SLOTS - 1; ++q) issue();
      int it = 0, q = 0;
      for (int u = first; u < units; u += stride) {
        for (int mt = 0; mt < m_tiles; ++mt, ++it) {
          const int s = it % STAGES;
          const uint32_t stage = base + s * L::STAGE;
          const uint32_t scales = base + L::SCALE_OFF + s * L::SCALE;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);  // every block is done with stage s
          // the stage's arrival: the bytes of all 128 rows (K each) and their scales, from every block
          if (tid == 0) mbar_expect_tx(full(s), TM * (K + 4));
          for (int p = 0; p < passes; ++p, ++q) {
            issue();
            asm volatile("cp.async.wait_group %0;\n" ::"n"(Q_SLOTS - 1) : "memory");
            const int row = r0 + p * RPP + prow;
            const bool on = lane_on && row < r1;
            uint4 v[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
            if (on) {
              const uint32_t src = slots + (q % Q_SLOTS) * Q_SLOT;
              asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                           : "=r"(v[0].x), "=r"(v[0].y), "=r"(v[0].z), "=r"(v[0].w) : "r"(src));
              asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                           : "=r"(v[1].x), "=r"(v[1].y), "=r"(v[1].z), "=r"(v[1].w) : "r"(src + 16));
            }
            const uint32_t w[8] = {v[0].x, v[0].y, v[0].z, v[0].w, v[1].x, v[1].y, v[1].z, v[1].w};
            float f[16];
            float amax = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              f[2 * i] = bf16_bits(w[i] & 0xffffu);
              f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
              amax = fmaxf(amax, fmaxf(fabsf(f[2 * i]), fabsf(f[2 * i + 1])));
            }
#pragma unroll
            for (int off = 1; off < LR; off <<= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
            const float sc = quant_scale(amax);
            const float rs = __frcp_rn(sc);
            uint32_t o[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              o[i] = pack_low_bytes(quant_bits(f[4 * i], sc, rs), quant_bits(f[4 * i + 1], sc, rs),
                                    quant_bits(f[4 * i + 2], sc, rs), quant_bits(f[4 * i + 3], sc, rs));
            }
            if (on) {
              // chunk l of the row (box l / 8, swizzled position (l % 8) ^ (row % 8))
              // and the row's scale into stage s of every block, each store
              // completing its bytes on that block's full barrier
              const uint32_t dst = stage + (l / 8) * I_BOX + row * 128 + (((l % 8) ^ (row % 8)) << 4);
              for (int c = 0; c < C; ++c) {
                const uint32_t bar = mapa(full(s), c);
                asm volatile(
                    "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                        mapa(dst, c)),
                    "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(bar)
                    : "memory");
                if (l == 0) {
                  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                                   mapa(scales + row * 4, c)),
                               "r"(__float_as_uint(sc)), "r"(bar)
                               : "memory");
                }
              }
            }
          }
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  } else {
    // consumers: warpgroup cw owns b columns [64cw, 64cw + 64) of the unit's
    // tile, the product's rows: this thread's n0 and n0 + 8; the sums of n8
    // group j are acc[4j..4j+3] = (n0, m), (n0, m + 1), (n0 + 8, m), (n0 + 8,
    // m + 1) for a row m = 8j + 2t of the row tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R::CONSUMER));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int g = (tid % 32) >> 2;
    const int t = tid & 3;
    const int lane = tid % 32;
    const int wg_bar = 2 + cw;  // named barrier of this warpgroup's 128 threads
    if (threadIdx.x == 128 && first < units) load_b(first);
    int it = 0, ui = 0;
    for (int u = first; u < units; u += stride, ++ui) {
      const int step = u / groups;
      const int nt = (u % groups) * C + rank;
      // b's A fragments: register 2·hi + h of k32 step kk holds column n0 + 8h,
      // rows (K) 32kk + 16hi + 4t .. + 3, low byte first
      uint32_t bf[KS][4];
      float sb[2] = {1.f, 1.f};
      mbar_wait(b_full, ui & 1);
      if constexpr (!QUANT) {
        // int8 box: byte (k, n) at k·128 + ((n / 16) ^ (k % 8))·16 + n % 16
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            uint32_t word = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k = 32 * kk + 16 * (r >> 1) + 4 * t + i;
              word |= lds_u8(b_s + k * 128 + (((4 * cw + warp) ^ (k & 7)) << 4) + g + 8 * (r & 1)) << (8 * i);
            }
            bf[kk][r] = word;
          }
      } else {
        // bf16 boxes of 64 columns: (k, n) in box n / 64 at k·128 + (((n % 64) / 8) ^ (k % 8))·16 + 2(n % 8);
        // column n0 + 8h is in chunk 2·warp + h
        auto at = [&](int k, int h) {
          return b_s + cw * K * 128 + k * 128 + (((2 * warp + h) ^ (k & 7)) << 4) + 2 * g;
        };
        float amax[2] = {0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k = 32 * kk + 16 * (r >> 1) + 4 * t + i;
              amax[r & 1] = fmaxf(amax[r & 1], fabsf(bf16_bits(lds_u16(at(k, r & 1)))));
            }
        float rs[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // a column's K values lie in the quad's four threads
          amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
          amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 2));
          sb[h] = quant_scale(amax[h]);
          rs[h] = __frcp_rn(sb[h]);
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            uint32_t x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k = 32 * kk + 16 * (r >> 1) + 4 * t + i;
              x[i] = quant_bits(bf16_bits(lds_u16(at(k, r & 1))), sb[r & 1], rs[r & 1]);
            }
            bf[kk][r] = pack_low_bytes(x[0], x[1], x[2], x[3]);
          }
      }
      mbar_arrive(b_empty);
      if (threadIdx.x == 128 && u + stride < units) {  // every consumer holds its fragments: the next unit's b
        mbar_wait(b_empty, ui & 1);
        load_b(u + stride);
      }

      for (int mt = 0; mt < m_tiles; ++mt, ++it) {
        const int s = it % STAGES;
        const uint32_t stage = base + s * L::STAGE;
        mbar_wait(full(s), (it / STAGES) & 1);
        if constexpr (QUANT) fence_proxy_async();  // the quantizers' stores, seen by wgmma
        int acc[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {  // a: box kk / 4, 32 bytes along its rows
          wgmma_s8_rs(acc, bf[kk], desc_sw128(stage + (kk / 4) * I_BOX + (kk % 4) * 32, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
        float v[64];
        if constexpr (QUANT) {
          const uint32_t scales = base + L::SCALE_OFF + s * L::SCALE;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            float sa0, sa1;
            asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(sa0), "=f"(sa1) : "r"(scales + (8 * j + 2 * t) * 4));
            v[4 * j] = __fmul_rn(__fmul_rn(i2f(acc[4 * j]), sa0), sb[0]);
            v[4 * j + 1] = __fmul_rn(__fmul_rn(i2f(acc[4 * j + 1]), sa1), sb[0]);
            v[4 * j + 2] = __fmul_rn(__fmul_rn(i2f(acc[4 * j + 2]), sa0), sb[1]);
            v[4 * j + 3] = __fmul_rn(__fmul_rn(i2f(acc[4 * j + 3]), sa1), sb[1]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 64; ++i) v[i] = i2f(acc[i]);
          mbar_arrive(empty(s));
        }

        // out rows m, columns n into this warpgroup's staging buffer (it % OUT_BUFS),
        // 128-byte swizzled as the map stores it: the sums of n8 group j and
        // column half h are an 8 × 8 (n, m) fragment, stored transposed by
        // stmatrix, four a call; lanes 8i..8i+7 give the rows m = 8(j + i / 2)
        // + q of fragment i (group j + i / 2, half i % 2), 16 bytes at chunk
        // 2·warp + i % 2
        const uint32_t buf = base + L::OUT_OFF + (cw * OUT_BUFS + it % OUT_BUFS) * I_OUT;
        if (tid == 0) bulk_wait_read<OUT_BUFS - 1>();  // the store from this buffer OUT_BUFS tiles ago has read it
        asm volatile("bar.sync %0, 128;\n" ::"r"(wg_bar) : "memory");
        if constexpr (QUANT) {
          if (tid < C) mbar_arrive_cluster(mapa(empty(s), tid));  // the warpgroup has read the stage's scales
        }
        const int q = lane & 7;
        const int fi = lane >> 3;
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          const uint32_t addr = buf + (8 * (j + fi / 2) + q) * 128 + (((2 * warp + (fi & 1)) ^ q) << 4);
          asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                       "r"(fgt::pack_bf16x2(v[4 * j], v[4 * j + 1])), "r"(fgt::pack_bf16x2(v[4 * j + 2], v[4 * j + 3])),
                       "r"(fgt::pack_bf16x2(v[4 * j + 4], v[4 * j + 5])),
                       "r"(fgt::pack_bf16x2(v[4 * j + 6], v[4 * j + 7]))
                       : "memory");
        }
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;\n" ::"r"(wg_bar) : "memory");
        if (tid == 0) {
          tma_store_2d(&tm_out, buf, nt * TN + cw * BOX, step * BM + mt * TM);
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait_all();
  }
  if constexpr (QUANT) cluster_sync();  // no block leaves while a peer may still reach its shared memory
}

// The cluster size of INT8_QUANT: the largest divisor of the column tiles a
// step up to MAX_CLUSTER (INT8 runs without clusters).
int cluster_of(int mode, int BN) {
  if (mode != kInt8Quant) return 1;
  const int n_tiles = BN / TN;
  for (int c = MAX_CLUSTER; c > 1; --c) {
    if (n_tiles % c == 0) return c;
  }
  return 1;
}

template <int MODE, int KS>
cudaError_t i8_attributes() {
  static bool done = false;
  if (done) return cudaSuccess;
  auto kernel = bare_dot_i8_kernel<MODE, KS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         I8Layout<MODE, 32 * KS>::SMEM);
  if (err != cudaSuccess) return err;
  // setmaxnreg moves registers inside the block's allocation: the pool must
  // fit in what the block got at launch, or setmaxnreg.inc would wait forever
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
  if (attr.numRegs * H_THREADS < I8Regs<MODE>::POOL) return cudaErrorInvalidConfiguration;
  done = true;
  return cudaSuccess;
}

// Blocks (INT8) or clusters (INT8_QUANT) that can run at once.
template <int MODE, int KS>
cudaError_t i8_capacity(int C, int* count) {
  cudaError_t err = i8_attributes<MODE, KS>();
  if (err != cudaSuccess) return err;
  if (MODE == kInt8) {
    int device = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    return cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, device);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(H_THREADS);
  cfg.dynamicSmemBytes = I8Layout<MODE, 32 * KS>::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(count, bare_dot_i8_kernel<MODE, KS>, &cfg);
}

// The launch's grid (blocks) and cluster size.
template <int MODE, int KS>
cudaError_t i8_plan(int BM, int BN, int steps, int* grid, int* cluster) {
  const int C = cluster_of(MODE, BN);
  int capacity = 0;
  cudaError_t err = i8_capacity<MODE, KS>(C, &capacity);
  if (err != cudaSuccess) return err;
  if (capacity < 1) return cudaErrorInvalidConfiguration;
  const int64_t units = static_cast<int64_t>(steps) * (BN / TN / C);
  *grid = static_cast<int>(units < capacity ? units : capacity) * C;
  *cluster = C;
  return cudaSuccess;
}

template <int MODE, int KS>
cudaError_t launch_i8(const void* a, const void* b, bf16* out, int BM, int BN, int steps, cudaStream_t st) {
  constexpr int K = 32 * KS;
  int grid = 0, C = 1;
  cudaError_t err = i8_plan<MODE, KS>(BM, BN, steps, &grid, &C);
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(steps) * BM;
  const int64_t cols = static_cast<int64_t>(steps) * BN;
  CUtensorMap ta, tb, to;
  memset(&ta, 0, sizeof(ta));  // INT8_QUANT reads a by cp.async
  bool ok = encode_map_2d(&to, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, BN, rows, 2ull * BN, BOX, TM,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (MODE == kInt8) {
    ok = ok &&
         encode_map_2d(&ta, a, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, rows, K, 128, TM, CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode_map_2d(&tb, b, CU_TENSOR_MAP_DATA_TYPE_UINT8, cols, K, cols, 128, K, CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    ok = ok && encode_map_2d(&tb, b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cols, K, 2ull * cols, BOX, K,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (!ok) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(H_THREADS);
  cfg.dynamicSmemBytes = I8Layout<MODE, K>::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = MODE == kInt8Quant ? 1 : 0;
  const bf16* ap = static_cast<const bf16*>(a);
  void* args[] = {&ta, &tb, &to, &ap, &BM, &BN, &steps, &C};
  return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(bare_dot_i8_kernel<MODE, KS>), args);
}

template <int MODE, int KS>
cudaError_t i8_info(int* regs, int* spill_bytes, int* smem_bytes, int* blocks_per_sm, int* stages) {
  cudaError_t err = i8_attributes<MODE, KS>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, bare_dot_i8_kernel<MODE, KS>)) != cudaSuccess) return err;
  *regs = attr.numRegs;
  *spill_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = I8Layout<MODE, 32 * KS>::SMEM + static_cast<int>(attr.sharedSizeBytes);
  *stages = I8Layout<MODE, 32 * KS>::STAGES;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, bare_dot_i8_kernel<MODE, KS>, H_THREADS,
                                                       I8Layout<MODE, 32 * KS>::SMEM);
}

// F(KS) for KS = K / 32 in 1..8, one instantiation each.
#define FGT_BY_KS(MODE, F, ...)                                      \
  switch (K / 32) {                                                  \
    case 1: return F<MODE, 1>(__VA_ARGS__);                          \
    case 2: return F<MODE, 2>(__VA_ARGS__);                          \
    case 3: return F<MODE, 3>(__VA_ARGS__);                          \
    case 4: return F<MODE, 4>(__VA_ARGS__);                          \
    case 5: return F<MODE, 5>(__VA_ARGS__);                          \
    case 6: return F<MODE, 6>(__VA_ARGS__);                          \
    case 7: return F<MODE, 7>(__VA_ARGS__);                          \
    case 8: return F<MODE, 8>(__VA_ARGS__);                          \
    default: return cudaErrorInvalidValue;                           \
  }

template <int MODE>
cudaError_t launch_i8_k(const void* a, const void* b, bf16* out, int K, int BM, int BN, int steps, cudaStream_t st) {
  FGT_BY_KS(MODE, launch_i8, a, b, out, BM, BN, steps, st)
}
template <int MODE>
cudaError_t i8_info_k(int K, int* regs, int* spill_bytes, int* smem_bytes, int* blocks_per_sm, int* stages) {
  FGT_BY_KS(MODE, i8_info, regs, spill_bytes, smem_bytes, blocks_per_sm, stages)
}
template <int MODE>
cudaError_t i8_plan_k(int K, int BM, int BN, int steps, int* grid, int* cluster) {
  FGT_BY_KS(MODE, i8_plan, BM, BN, steps, grid, cluster)
}
#undef FGT_BY_KS

}  // namespace

// a: (steps·BM, K) contiguous, int8 for mode 1 else bf16; b: (K, steps·BN)
// contiguous, the same type; out: (steps·BM, BN) bf16. mode: 0 bf16, 1 int8,
// 2 int8 quantized inside. Requires BM, BN multiples of 128, K a multiple of 32
// in [32, 256], steps in [1, 65535], and a, b and out 16-byte aligned (TMA,
// cp.async). Returns a cudaError_t: cudaErrorInvalidValue also when a tensor
// map cannot be encoded.
extern "C" int fgt_bare_dot(const void* a, const void* b, void* out, int K, int BM, int BN, int steps,
                            int mode, void* stream) {
  if (K < 32 || K > 256 || K % 32 != 0 || BM <= 0 || BN <= 0 || BM % TM != 0 || BN % TN != 0 ||
      steps <= 0 || steps > 65535 || BM / TM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kBf16: return static_cast<int>(launch_bf16(a, b, o, K, BM, BN, steps, st));
    case kInt8: return static_cast<int>(launch_i8_k<kInt8>(a, b, o, K, BM, BN, steps, st));
    case kInt8Quant: return static_cast<int>(launch_i8_k<kInt8Quant>(a, b, o, K, BM, BN, steps, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A mode's kernel at K: registers a thread at launch (before setmaxnreg),
// local memory (spills) a thread, shared memory a block, blocks an SM and
// ring stages.
extern "C" int fgt_bare_dot_info(int mode, int K, int* regs, int* spill_bytes, int* smem_bytes,
                                 int* blocks_per_sm, int* stages) {
  if (K < 32 || K > 256 || K % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kInt8) return static_cast<int>(i8_info_k<kInt8>(K, regs, spill_bytes, smem_bytes, blocks_per_sm, stages));
  if (mode == kInt8Quant) {
    return static_cast<int>(i8_info_k<kInt8Quant>(K, regs, spill_bytes, smem_bytes, blocks_per_sm, stages));
  }
  if (mode != kBf16) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = bf16_smem(K);
  cudaError_t err =
      cudaFuncSetAttribute(bare_dot_bf16_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, bare_dot_bf16_sm90_kernel)) != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *spill_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = smem + static_cast<int>(attr.sharedSizeBytes);
  *stages = ring_stages(K);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, bare_dot_bf16_sm90_kernel, H_THREADS, smem));
}

// An int8 mode's launch at (K, BM, BN, steps): blocks in the grid and blocks
// a cluster (1 for "int8"; for "int8_quant_inside" the largest divisor of
// BN / 128 up to 8, so each a row is quantized BN / 128 / cluster times a step).
extern "C" int fgt_bare_dot_plan(int mode, int K, int BM, int BN, int steps, int* grid, int* cluster) {
  if (K < 32 || K > 256 || K % 32 != 0 || BM <= 0 || BN <= 0 || BM % TM != 0 || BN % TN != 0 || steps <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == kInt8) return static_cast<int>(i8_plan_k<kInt8>(K, BM, BN, steps, grid, cluster));
  if (mode == kInt8Quant) return static_cast<int>(i8_plan_k<kInt8Quant>(K, BM, BN, steps, grid, cluster));
  return static_cast<int>(cudaErrorInvalidValue);
}
