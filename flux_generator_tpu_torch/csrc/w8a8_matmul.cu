// W8A8 matmul with the activation quantization fused in (kernel G), and the
// per-row int8 quantizer (kernel H), for Hopper (sm_90a).
//
// G replaces the TPU kernel `_kernel` of flux_generator_tpu/ops/pallas/
// w8a8_matmul.py (pallas_call at :119); H replaces `_quant_kernel` (:166).
//
// G computes out = x · (w_q · diag(ws)) for x (M, K) bf16, w_q (K, N) int8 and
// per-output-channel f32 scales ws (N,). w_q is stored K-contiguous (strides
// (1, K)), the layout in which ops.quant stores int8 per-channel weights: int8
// wgmma takes both operands K-major only, and x_q (M, K) and the weight's N
// rows of K bytes are K-major as they lie, so nothing is transposed. K is cut
// into blocks of BK = 512, 256 or 128 (the largest that divides K). For each
// row and K block, sx = max(amax|x|, 1e-12) · (1/127) and x_q = rint(x ·
// rcp(sx)) with no clip (|x · rcp(sx)| ≤ 127); the block's int32 dot x_q · w_q
// is added into an f32 accumulator as acc += f32(dot) · sx, in block order;
// out = bf16(acc · ws). Numerics follow the TPU kernel: products and sums of
// the f32 fold are rounded one at a time (no fused multiply-add), the
// reciprocal is correctly rounded. A block's dot is exact in f32 (|Σ| ≤
// 512·127² < 2²⁴), and the products and sums are the plain version's, in its
// order, so the output equals the plain version's bit for bit.
//
// Bound: int8 tensor-core throughput at M 1024 and more (1979 TOP/s): the
// image qkv (M 1024, K 3072, N 9216) is 58 G operations against 35 MB of x,
// w_q and out, ~1,600 operations a byte. The text denses (M 256) do 512
// operations a weight byte, under the int8 ridge (~590): their weight bytes
// bound them, so every SM has to stream weights.
//
// Design: two kernels in one call.
// - The quantizer pass. The TPU kernel quantizes each x block in VMEM as it
//   arrives; here each of the N / 128 tile columns would repeat that, so a
//   first kernel quantizes each (row, K block) once (one warp each: 16-byte
//   loads, a warp-shuffle amax) into an int8 copy of x (M·K bytes) and its f32
//   scales. On an H100 it runs within 1.0–1.7× its bytes bound at M ≥ 1024
//   and 2–4× at M 256, where the bound is under a microsecond: a few
//   percent of a call either way.
// - The GEMM: persistent blocks (one an SM) of three warpgroups walk the
//   output tiles of 128 rows × BN columns, row tiles fastest (the blocks that
//   run together share weight columns). Warpgroup 0 is the producer
//   (setmaxnreg 40): one thread issues every copy with TMA (2-D maps of x_q
//   and of the weight's K-contiguous rows, 128-byte swizzle, boxes of 128
//   bytes of K × 128 or BN rows, zero fill past M and N) into a ring of
//   STAGES stages with a full mbarrier (the copy's bytes) and an empty one
//   (the 256 consumer threads), running ahead into the next tile.
//   Warpgroups 1 and 2 (setmaxnreg 232) each own 64 rows of a tile: int8
//   wgmma m64nBNk32 with both operands in shared memory into BN/2 int32 sums
//   a thread; at the end of each K block a warpgroup waits for its products
//   and folds the sums into BN/2 f32 values with its rows' scales, while the
//   other warpgroup's products keep the tensor cores busy. BN is 128 or 192:
//   int32 and f32 values for 256 columns would take all 255 registers. A
//   column costs the same at either width on the H100; the wrapper
//   (`tile_n`) picks the width whose tiles spread most evenly over the
//   blocks (192 cuts the image qkv's busiest block from 5 tiles of 128 to 3
//   of 192). Every tile folds its K blocks in order in one block, so the
//   output is the plain version's bit for bit at every shape (a split of K
//   across blocks would add f32 partial sums in another order; measured on
//   the H100, it was also slower at every under-filled shape than whole
//   tiles).
// - The epilogue: out = bf16(acc · ws). Where N % 8 == 0 (rows 16-byte
//   aligned) a warpgroup writes its 64 × BN bf16 tile into a 128-byte-
//   swizzled staging tile and one thread stores it with TMA (the map clips M
//   and N), so the store runs under the next tile's products; for any other N
//   the same values go out from registers with masks at the M and N edges.
//
// H: per row, sx = max(amax|x|, 1e-12) · (1/127) and x_q = rint(x · rcp(sx))
// with no clip, over the whole row. Bound: bytes (2 read + 1 written a
// value, 3.35 TB/s). Design: each row is read from HBM once, with whole rows
// in flight on every SM: whole warps take a row (`tpr` threads, each holding
// 1-8 16-byte chunks in registers; short rows share a block); the amax is a
// warp-shuffle max and one shared-memory step across the row's warps; the
// chunks still in registers are quantized and stored 8 bytes a thread. The
// geometry comes from the wrapper (`quantize_geometry`): with 4 rows an SM or
// more, the most chunks a thread (the most rows in flight); with fewer, the
// fewest (a row's loads over the most threads). A row longer than the
// registers hold (K > 32,768; no Flux or MusicGen activation comes near) is
// swept twice, the second time from L2.

#include <string.h>

#include "sm90_common.cuh"

namespace {

using fgt::bf16;
using namespace fgt::sm90;

constexpr int BM = 128;          // rows of an output tile: two consumer warpgroups of 64
constexpr int KC = 128;          // bytes of K a ring stage holds: one 128-byte swizzle row
constexpr int THREADS = 384;     // the producer warpgroup and two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int A_BYTES = BM * KC;
constexpr int OUT_BOX = 64 * 128;  // 64 bf16 columns × 64 rows of out, 128-byte swizzled

// Shared memory of the GEMM for output tiles BN columns wide (128 or 192).
template <int BN>
struct Tile {
  static constexpr int STAGES = BN == 128 ? 5 : 4;
  static constexpr int STAGE_BYTES = A_BYTES + BN * KC;
  static constexpr int OUT_BOXES = BN / 64;             // a warpgroup's 64 × BN staging tile
  static constexpr int OUT_OFF = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = OUT_OFF + 2 * OUT_BOXES * OUT_BOX;
  // + slack to align the base to the 1024 bytes of a 128-byte swizzle atom
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;
  static constexpr int ACC = BN / 2;  // int32 sums (and f32 folds) a consumer thread holds
};
constexpr int Q_WARPS = 8;       // (row, K block) items a quantizer block takes
constexpr int H_THREADS = 512;   // H's largest block

__device__ __forceinline__ float row_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), 1.f / 127.f);
}

__device__ __forceinline__ void unpack8(const uint4& val, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&val);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __low2float(h[j]);
    f[2 * j + 1] = __high2float(h[j]);
  }
}

__device__ __forceinline__ uint2 quant8(const float (&f)[8], float rcp) {
  int q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) q[j] = __float2int_rn(__fmul_rn(f[j], rcp));
  return make_uint2(fgt::pack_s8x4(q[0], q[1], q[2], q[3]), fgt::pack_s8x4(q[4], q[5], q[6], q[7]));
}

// One warp per (row, K block): x_q and the block's scale sx[row · nkb + kb].
template <int BK>
__global__ void __launch_bounds__(Q_WARPS * 32)
quantize_blocks_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                       int M, int K) {
  constexpr int CH = BK / 8;  // 16-byte chunks a block row
  constexpr int PER = (CH + 31) / 32;
  const int nkb = K / BK;
  const int item = blockIdx.x * Q_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (item >= M * nkb) return;
  const int row = item / nkb;
  const int kb = item % nkb;
  const bf16* src = x + static_cast<int64_t>(row) * K + kb * BK;
  int8_t* dst = xq + static_cast<int64_t>(row) * K + kb * BK;
  float v[PER][8];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = lane + 32 * j;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c < CH) val = *reinterpret_cast<const uint4*>(src + c * 8);
    unpack8(val, v[j]);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[j][e]));
  }
  amax = fgt::warp_max(amax);
  const float s = row_scale(amax);
  const float rcp = __frcp_rn(s);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = lane + 32 * j;
    if (c < CH) *reinterpret_cast<uint2*>(dst + c * 8) = quant8(v[j], rcp);
  }
  if (lane == 0) sx[item] = s;
}

// Output tile `tile` of the walk: row tiles fastest, so the blocks that run
// together share weight columns.
template <int BN>
__device__ __forceinline__ int2 tile_origin(int tile, int m_tiles) {
  return make_int2((tile % m_tiles) * BM, (tile / m_tiles) * BN);
}

template <int BK, int BN>
__global__ void __launch_bounds__(THREADS, 1)
w8a8_gemm_sm90_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_out, const float* __restrict__ sx,
                      const float* __restrict__ ws, bf16* __restrict__ out, int M, int N, int K) {
  using T = Tile<BN>;
  constexpr int CPB = BK / KC;  // ring stages a K block
  constexpr int STAGES = T::STAGES;
  constexpr int ACC = T::ACC;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + T::BAR_OFF;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  const int nkb = K / BK;
  const int m_tiles = (M + BM - 1) / BM;
  const int tiles = m_tiles * ((N + BN - 1) / BN);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: every tile's K chunks, in the order the consumers take them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int2 o = tile_origin<BN>(tile, m_tiles);
        for (int c = 0; c < K / KC; ++c, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), T::STAGE_BYTES);
          const uint32_t stage = base + s * T::STAGE_BYTES;
          tma_load_2d(stage, &tm_x, full(s), c * KC, o.x);
          tma_load_2d(stage + A_BYTES, &tm_w, full(s), c * KC, o.y);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows [cw·64, cw·64 + 64) of each tile. The
  // sums of n8 column group j are acc[4j..4j+3]: rows g and g + 8 of the
  // thread's warp, columns 8j + 2t and + 1.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int g = (tid % 32) >> 2;
  const int t = tid & 3;
  const int wg_bar = 1 + cw;  // named barrier of this warpgroup's 128 threads
  const uint32_t staging = base + T::OUT_OFF + cw * T::OUT_BOXES * OUT_BOX;
  const bool tma_store = N % 8 == 0;  // out's rows 16-byte aligned: the map can store them
  int acc[ACC];
  float facc[ACC];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int2 o = tile_origin<BN>(tile, m_tiles);
    const int r0 = o.x + cw * 64 + warp * 16 + g;
    const int r1 = r0 + 8;
#pragma unroll
    for (int i = 0; i < ACC; ++i) facc[i] = 0.f;
    for (int kb = 0; kb < nkb; ++kb) {
      // the block's row scales, read while its products run
      const float s0 = r0 < M ? sx[static_cast<int64_t>(r0) * nkb + kb] : 0.f;
      const float s1 = r1 < M ? sx[static_cast<int64_t>(r1) * nkb + kb] : 0.f;
      int prev = 0;
#pragma unroll
      for (int cc = 0; cc < CPB; ++cc, ++it) {
        const int s = it % STAGES;
        mbar_wait(full(s), (it / STAGES) & 1);
        const uint32_t a_tile = base + s * T::STAGE_BYTES + cw * 64 * KC;
        const uint32_t b_tile = base + s * T::STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 32; ++kk) {  // k32 steps: 32 bytes along a swizzled row each
          wgmma_s8(acc, desc_sw128(a_tile + kk * 32, 16, 1024), desc_sw128(b_tile + kk * 32, 16, 1024),
                   cc > 0 || kk > 0);
        }
        wgmma_commit();
        if (cc > 0) {  // the previous stage's products are done: hand it back
          wgmma_wait1();
          mbar_arrive(empty(prev));
        }
        prev = s;
      }
      wgmma_wait0();
      fence_regs(acc);
      mbar_arrive(empty(prev));
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        facc[i] = __fadd_rn(facc[i], __fmul_rn(static_cast<float>(acc[i]), (i & 2) ? s1 : s0));
      }
    }

    if (tma_store) {  // bf16 into the staging tile (chunk c of row r at c ^ (r % 8)), one thread stores it
      if (tid == 0) bulk_wait_read<0>();  // the previous tile's store has read the staging tile
      asm volatile("bar.sync %0, 128;\n" ::"r"(wg_bar) : "memory");
#pragma unroll
      for (int j = 0; j < ACC / 4; ++j) {
        const int col = o.y + 8 * j + 2 * t;
        const float w0 = col < N ? __ldg(ws + col) : 0.f;  // N is even: col + 1 < N with col
        const float w1 = col < N ? __ldg(ws + col + 1) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + g + 8 * h;
          const uint32_t addr = staging + (j / 8) * OUT_BOX + r * 128 + (((j % 8) ^ (r % 8)) * 16) + t * 4;
          const uint32_t v = fgt::pack_bf16x2(__fmul_rn(facc[4 * j + 2 * h], w0),
                                              __fmul_rn(facc[4 * j + 2 * h + 1], w1));
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
        }
      }
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(wg_bar) : "memory");
      if (tid == 0) {  // the map clips rows past M and columns past N
        for (int b = 0; b < T::OUT_BOXES; ++b) tma_store_2d(&tm_out, staging + b * OUT_BOX, o.y + 64 * b, o.x + cw * 64);
        bulk_commit();
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j) {  // any N: masked stores from registers
      const int col = o.y + 8 * j + 2 * t;
      if (col >= N) continue;
      const bool two = col + 1 < N;
      const float w0 = __ldg(ws + col);
      const float w1 = two ? __ldg(ws + col + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h ? r1 : r0;
        if (row >= M) continue;
        bf16* dst = out + static_cast<int64_t>(row) * N + col;
        const float y0 = __fmul_rn(facc[4 * j + 2 * h], w0);
        const float y1 = __fmul_rn(facc[4 * j + 2 * h + 1], w1);
        if (two && N % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
        } else {
          dst[0] = __float2bfloat16_rn(y0);
          if (two) dst[1] = __float2bfloat16_rn(y1);
        }
      }
    }
  }
  if (tid == 0) bulk_wait_all();
}

// setmaxnreg moves registers inside the block's allocation: the consumers'
// 232 and the producer's 40 must fit in what the block got at launch, or the
// consumers' setmaxnreg.inc would wait forever.
constexpr int REG_POOL = 128 * 40 + CONSUMERS * 232;

template <int BK, int BN>
cudaError_t gemm_attributes() {
  static bool checked = false;
  if (!checked) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, w8a8_gemm_sm90_kernel<BK, BN>);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * THREADS < REG_POOL) return cudaErrorInvalidConfiguration;
    checked = true;
  }
  return cudaFuncSetAttribute(w8a8_gemm_sm90_kernel<BK, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Tile<BN>::SMEM);
}

template <int BK, int BN>
cudaError_t launch_gemm(const int8_t* xq, const float* sx, const int8_t* w, const float* ws, bf16* out, int M,
                        int N, int K, int grid, cudaStream_t stream) {
  cudaError_t err = gemm_attributes<BK, BN>();
  if (err != cudaSuccess) return err;
  CUtensorMap tx, tw, to;
  memset(&to, 0, sizeof(to));  // unused unless N % 8 == 0
  if (!encode_map_2d(&tx, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, M, K, KC, BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map_2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, N, K, KC, BN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (N % 8 == 0 &&
       !encode_map_2d(&to, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N, M, 2ull * N, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B))) {
    return cudaErrorInvalidValue;
  }
  w8a8_gemm_sm90_kernel<BK, BN><<<grid, THREADS, Tile<BN>::SMEM, stream>>>(tx, tw, to, sx, ws, out, M, N, K);
  return cudaGetLastError();
}

template <int BK>
cudaError_t launch_g(const bf16* x, int8_t* xq, float* sx, const int8_t* w, const float* ws, bf16* out, int M,
                     int N, int K, int bn, int grid, cudaStream_t stream) {
  const int items = M * (K / BK);
  quantize_blocks_kernel<BK><<<(items + Q_WARPS - 1) / Q_WARPS, Q_WARPS * 32, 0, stream>>>(x, xq, sx, M, K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return bn == 192 ? launch_gemm<BK, 192>(xq, sx, w, ws, out, M, N, K, grid, stream)
                   : launch_gemm<BK, 128>(xq, sx, w, ws, out, M, N, K, grid, stream);
}

template <int BK, int BN>
cudaError_t gemm_info(int* regs, int* spill_bytes, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(w8a8_gemm_sm90_kernel<BK, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<BN>::SMEM);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, w8a8_gemm_sm90_kernel<BK, BN>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *spill_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = Tile<BN>::SMEM + static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, w8a8_gemm_sm90_kernel<BK, BN>, THREADS,
                                                       Tile<BN>::SMEM);
}

template <int BN>
cudaError_t gemm_info_bk(int bk, int* regs, int* spill_bytes, int* smem_bytes, int* blocks_per_sm) {
  if (bk == 512) return gemm_info<512, BN>(regs, spill_bytes, smem_bytes, blocks_per_sm);
  if (bk == 256) return gemm_info<256, BN>(regs, spill_bytes, smem_bytes, blocks_per_sm);
  if (bk == 128) return gemm_info<128, BN>(regs, spill_bytes, smem_bytes, blocks_per_sm);
  return cudaErrorInvalidValue;
}

// H, any K: one warp a row, Q_WARPS rows a block, scalar loads (K % 8 != 0 or
// rows not 16-byte aligned): the row's amax from a first sweep, then a second
// sweep writes int8.
__global__ void __launch_bounds__(Q_WARPS * 32)
quantize_rows_scalar_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int M,
                            int K) {
  const int row = blockIdx.x * Q_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const bf16* xr = x + static_cast<int64_t>(row) * K;
  int8_t* qr = xq + static_cast<int64_t>(row) * K;
  float amax = 0.f;
  for (int i = lane; i < K; i += 32) amax = fmaxf(amax, fabsf(__bfloat162float(xr[i])));
  amax = fgt::warp_max(amax);
  const float s = row_scale(amax);
  const float rcp = __frcp_rn(s);
  for (int i = lane; i < K; i += 32) {
    qr[i] = static_cast<int8_t>(__float2int_rn(__fmul_rn(__bfloat162float(xr[i]), rcp)));
  }
  if (lane == 0) sx[row] = s;
}

// The running max of |x| over a chunk's eight bf16 values, kept as two 16-bit
// magnitudes a word: for values that are not NaN the order of the bits is
// the order of the numbers, and NaNs (above inf's 0x7f80) count as 0, as
// fmaxf skips them; no value is unpacked, so a thread holding 8 chunks fits
// 64 registers with no spill.
__device__ __forceinline__ uint32_t amax8(const uint4& val, uint32_t m) {
  const uint32_t w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a = w[j] & 0x7fff7fffu;
    m = __vmaxu2(m, a & ~__vcmpgtu2(a, 0x7f807f80u));
  }
  return m;
}

__device__ __forceinline__ float amax_of(uint32_t m) { return __uint_as_float(max(m & 0xffffu, m >> 16) << 16); }

// H, K % 8 == 0 and 16-byte aligned rows: `tpr` threads (whole warps) take a
// row, blockDim.x / tpr rows a block, C 16-byte chunks (8 values) a thread: a
// warp's loads are contiguous (chunks lt, lt + tpr, ...). Where tpr · C · 8
// ≥ K a thread's chunks are loaded at once and stay in registers for the
// quantize pass: the row is read from HBM once. A longer row (K > 32,768)
// is swept twice: the amax tile by tile, then each tile read again (from
// L2). The amax is a warp-shuffle max, then one shared-memory step across
// the row's warps; int8 is stored 8 bytes a thread. Bounded to 2 blocks of
// H_THREADS an SM (64 registers a thread): on an H100 the compiler's
// schedule under this bound ran the K 12288 and 15360 rows faster than under
// 1 block an SM, though it takes more registers.
template <int C>
__global__ void __launch_bounds__(H_THREADS, 2)
quantize_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int M, int K,
                     int tpr) {
  __shared__ float red[32];  // each warp's amax
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rows = blockDim.x / tpr;
  const int r = tid / tpr, lt = tid % tpr;
  const int row = blockIdx.x * rows + r;
  const bool live = row < M;
  const int chunks = K / 8;
  const int tile = tpr * C;
  const int tiles = (chunks + tile - 1) / tile;
  const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * K);
  int8_t* qr = xq + static_cast<int64_t>(row) * K;
  uint4 v[C];
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int c = lt + j * tpr;
    v[j] = live && c < chunks ? src[c] : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int j = 0; j < C; ++j) m = amax8(v[j], m);
  for (int t = 1; t < tiles; ++t) {  // a longer row: the rest of its amax
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = t * tile + lt + j * tpr;
      if (live && c < chunks) m = amax8(src[c], m);
    }
  }
  float amax = fgt::warp_max(amax_of(m));
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  const int wpr = tpr / 32;  // the row's warps: r · wpr, ...
  amax = fgt::warp_max(lane < wpr ? red[r * wpr + lane] : 0.f);
  const float s = row_scale(amax);
  const float rcp = __frcp_rn(s);
  if (!live) return;
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = t * tile + lt + j * tpr;
      if (c < chunks) {
        float f[8];
        unpack8(tiles == 1 ? v[j] : src[c], f);
        *reinterpret_cast<uint2*>(qr + c * 8) = quant8(f, rcp);
      }
    }
  }
  if (lt == 0) sx[row] = s;
}

template <int C>
cudaError_t launch_h(const bf16* x, int8_t* xq, float* sx, int M, int K, int tpr, int rows, int blocks,
                     cudaStream_t stream) {
  quantize_rows_kernel<C><<<blocks, tpr * rows, 0, stream>>>(x, xq, sx, M, K, tpr);
  return cudaGetLastError();
}

cudaError_t launch_h_c(int c, const bf16* x, int8_t* xq, float* sx, int M, int K, int tpr, int rows, int blocks,
                       cudaStream_t stream) {
  switch (c) {
    case 1: return launch_h<1>(x, xq, sx, M, K, tpr, rows, blocks, stream);
    case 2: return launch_h<2>(x, xq, sx, M, K, tpr, rows, blocks, stream);
    case 4: return launch_h<4>(x, xq, sx, M, K, tpr, rows, blocks, stream);
    case 8: return launch_h<8>(x, xq, sx, M, K, tpr, rows, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (M, K) contiguous bf16, 16-byte aligned; xq: (M, K) int8 and sx: (M, K/BK)
// f32 scratch (BK the largest of 512, 256, 128 dividing K), xq 16-byte aligned;
// w: (K, N) int8, K-contiguous (strides (1, K)), 16-byte aligned; ws: (N,) f32;
// out: (M, N) bf16, 16-byte aligned. The GEMM runs `grid` persistent blocks
// over the ⌈M/128⌉·⌈N/bn⌉ output tiles of 128 × bn (bn 128 or 192). Requires
// K % 128 == 0. Returns a cudaError_t: cudaErrorInvalidValue also when a
// tensor map cannot be encoded.
extern "C" int fgt_w8a8_matmul(const void* x, void* xq, void* sx, const void* w, const void* ws, void* out, int M,
                               int N, int K, int bn, int grid, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 128 != 0 || grid < 1 || (bn != 128 && bn != 192) ||
      static_cast<int64_t>((M + BM - 1) / BM) * ((N + bn - 1) / bn) > (1ll << 31) - 1 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf16* xb = static_cast<const bf16*>(x);
  int8_t* qb = static_cast<int8_t*>(xq);
  float* sb = static_cast<float*>(sx);
  const int8_t* wb = static_cast<const int8_t*>(w);
  const float* wsb = static_cast<const float*>(ws);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 512 == 0) return static_cast<int>(launch_g<512>(xb, qb, sb, wb, wsb, ob, M, N, K, bn, grid, st));
  if (K % 256 == 0) return static_cast<int>(launch_g<256>(xb, qb, sb, wb, wsb, ob, M, N, K, bn, grid, st));
  return static_cast<int>(launch_g<128>(xb, qb, sb, wb, wsb, ob, M, N, K, bn, grid, st));
}

// The GEMM kernel's registers a thread at launch (before setmaxnreg), local
// memory (spills) a thread, shared memory a block and blocks an SM, for K
// block `bk` (512, 256 or 128) and tile width `bn` (128 or 192).
extern "C" int fgt_w8a8_matmul_info(int bk, int bn, int* regs, int* spill_bytes, int* smem_bytes,
                                    int* blocks_per_sm) {
  if (bn == 128) return static_cast<int>(gemm_info_bk<128>(bk, regs, spill_bytes, smem_bytes, blocks_per_sm));
  if (bn == 192) return static_cast<int>(gemm_info_bk<192>(bk, regs, spill_bytes, smem_bytes, blocks_per_sm));
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: (M, K) contiguous bf16; xq: (M, K) int8; sx: (M,) f32. The geometry
// (`quantize_geometry` in the wrapper): `chunks` (1, 2, 4 or 8) 16-byte
// chunks a thread a tile, `tpr` threads a row (whole warps), `rows` rows a
// block (tpr · rows ≤ 512), `blocks` blocks; chunks 0 takes the scalar
// kernel for any K (one warp a row), as it must where K % 8 != 0 or x or xq
// is not 16-byte aligned. Returns a cudaError_t.
extern "C" int fgt_quantize_rows(const void* x, void* xq, void* sx, int M, int K, int chunks, int tpr, int rows,
                                 int blocks, void* stream) {
  if (M <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  int8_t* qb = static_cast<int8_t*>(xq);
  float* sb = static_cast<float*>(sx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunks == 0) {
    quantize_rows_scalar_kernel<<<(M + Q_WARPS - 1) / Q_WARPS, Q_WARPS * 32, 0, st>>>(xb, qb, sb, M, K);
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(xq) % 16 == 0;
  if (!aligned || tpr <= 0 || tpr % 32 != 0 || rows <= 0 || tpr * rows > H_THREADS ||
      static_cast<int64_t>(blocks) * rows < M) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_h_c(chunks, xb, qb, sb, M, K, tpr, rows, blocks, st));
}
