// The bare-dot probe (#13) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dot_kernel` of scripts/prof_attn_int8.py
// (pallas_call at :76, called by `bare_dot`), the probe that asks whether
// int8 attention loses its time in the int8 matrix unit or in quantizing
// inside the kernel. With its BlockSpecs it computes, for a (steps·BM, K) and
// b (K, steps·BN), out[i·BM:(i+1)·BM] = a_blk(i) · b_blk(i) in bf16, where
// a_blk(i) is rows i·BM.. of a and b_blk(i) columns i·BN.. of b, i < steps:
//   BF16:        bf16 in, f32 sums, rounded to bf16;
//   INT8:        int8 in, int32 sums (mma.sync m16n8k32), → f32 → bf16;
//   INT8_QUANT:  bf16 in; each a row and each b column (over K) is quantized
//                inside the kernel, s = max(amax, 1e-20) / 127 and
//                x_i = clip(rint(x / s), ±127), then (f32(int32 dot) · s_a)
//                · s_b → bf16. The division by 127 is the product with
//                f32(1/127), as XLA compiles the script's `/ 127.0`; x / s is
//                an IEEE division (__fdiv_rn, not fast math).
// The quantization stays inside the kernel and is repeated per output tile,
// as the TPU kernel repeats it per grid step: its cost is what the probe
// measures.
//
// Bound: at the probe's shape (BM = BN = 1024, K = 128, 64 steps) a step
// moves 2.62 MB (the bf16 a and b blocks and the bf16 output, each once) for
// 0.27 GFLOP: 168 MB in all, 0.050 ms at 3.35 TB/s against 0.017 ms of bf16
// tensor-core work, so bytes bound it, the output (134 MB) above all.
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
// The int8 modes: one block of 8 warps per 128 x 128 output tile, the whole K
// (≤ 256) of its a rows and b columns staged in shared memory; each warp owns
// a 32 x 64 sub-tile of mma.sync m16n8k32. int8 b is stored transposed
// (K-contiguous) for the B fragment. In INT8_QUANT warps 0-3 quantize the 128
// b columns (one a thread) while warps 4-7 quantize the 128 a rows (32 a
// warp).

#include "sm90_common.cuh"

namespace {

using fgt::bf16;
using namespace fgt::sm90;

constexpr int TM = 128;  // output rows per block
constexpr int TN = 128;  // output columns per block
constexpr int THREADS = 256;  // the int8 kernel
constexpr int SB = TN + 8;  // row stride of the bf16 b tile (elements)

enum Mode : int { kBf16 = 0, kInt8 = 1, kInt8Quant = 2 };

__host__ __device__ constexpr int sa_stride(int K) { return K + 8; }   // bf16 a rows (elements)
__host__ __device__ constexpr int si_stride(int K) { return K + 16; }  // int8 rows (bytes)

__host__ __device__ inline size_t smem_bytes(int mode, int K) {
  const size_t bf = static_cast<size_t>(TM) * sa_stride(K) * 2 + static_cast<size_t>(K) * SB * 2;
  const size_t i8 = static_cast<size_t>(TM + TN) * si_stride(K);
  if (mode == kInt8) return i8;
  return bf + i8 + (TM + TN) * sizeof(float);
}

__device__ __forceinline__ float quant_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-20f), 1.f / 127.f);
}

__device__ __forceinline__ int8_t quant(float x, float s) {
  return static_cast<int8_t>(max(-127, min(127, __float2int_rn(__fdiv_rn(x, s)))));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
bare_dot_kernel(const void* __restrict__ a_ptr, const void* __restrict__ b_ptr, bf16* __restrict__ out,
                int K, int BM, int BN, int steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SA = sa_stride(K);
  const int SI = si_stride(K);
  bf16* sA = reinterpret_cast<bf16*>(smem);                 // [TM][SA] bf16 (INT8_QUANT)
  bf16* sB = sA + TM * SA;                                  // [K][SB] bf16
  int8_t* sAi = MODE == kInt8 ? reinterpret_cast<int8_t*>(smem)
                              : reinterpret_cast<int8_t*>(sB + K * SB);  // [TM][SI] int8
  int8_t* sBt = sAi + TM * SI;                              // [TN][SI] int8, K-contiguous
  float* sSa = reinterpret_cast<float*>(sBt + TN * SI);     // [TM] (INT8_QUANT)
  float* sSb = sSa + TM;                                    // [TN]

  const int step = blockIdx.z;
  const int64_t row0 = static_cast<int64_t>(step) * BM + blockIdx.y * TM;  // rows of a and out
  const int64_t col0 = static_cast<int64_t>(step) * BN + blockIdx.x * TN;  // columns of b
  const int64_t ldb = static_cast<int64_t>(steps) * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 64;

  if constexpr (MODE == kInt8) {
    const int8_t* a = static_cast<const int8_t*>(a_ptr);
    const int8_t* b = static_cast<const int8_t*>(b_ptr);
    const int chunks = K / 16;
    for (int idx = threadIdx.x; idx < TM * chunks; idx += THREADS) {
      const int r = idx / chunks, c = idx % chunks;
      *reinterpret_cast<uint4*>(sAi + r * SI + c * 16) =
          *reinterpret_cast<const uint4*>(a + (row0 + r) * K + c * 16);
    }
    for (int idx = threadIdx.x; idx < K * (TN / 16); idx += THREADS) {
      const int k = idx / (TN / 16), c = idx % (TN / 16);
      const uint4 v = *reinterpret_cast<const uint4*>(b + k * ldb + col0 + c * 16);
      const int8_t* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) sBt[(c * 16 + j) * SI + k] = bytes[j];
    }
  } else {
    const bf16* a = static_cast<const bf16*>(a_ptr);
    const bf16* b = static_cast<const bf16*>(b_ptr);
    const int chunks = K / 8;
    for (int idx = threadIdx.x; idx < TM * chunks; idx += THREADS) {
      const int r = idx / chunks, c = idx % chunks;
      *reinterpret_cast<uint4*>(sA + r * SA + c * 8) = *reinterpret_cast<const uint4*>(a + (row0 + r) * K + c * 8);
    }
    for (int idx = threadIdx.x; idx < K * (TN / 8); idx += THREADS) {
      const int k = idx / (TN / 8), c = idx % (TN / 8);
      *reinterpret_cast<uint4*>(sB + k * SB + c * 8) = *reinterpret_cast<const uint4*>(b + k * ldb + col0 + c * 8);
    }
  }
  __syncthreads();

  if constexpr (MODE == kInt8Quant) {
    if (warp < 4) {  // one b column a thread
      const int n = threadIdx.x;
      float amax = 0.f;
      for (int k = 0; k < K; ++k) amax = fmaxf(amax, fabsf(__bfloat162float(sB[k * SB + n])));
      const float s = quant_scale(amax);
      for (int k = 0; k < K; ++k) sBt[n * SI + k] = quant(__bfloat162float(sB[k * SB + n]), s);
      sSb[n] = s;
    } else {  // 32 a rows a warp
      for (int r = (warp - 4) * 32; r < (warp - 3) * 32; ++r) {
        float amax = 0.f;
        for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(__bfloat162float(sA[r * SA + k])));
        const float s = quant_scale(fgt::warp_max(amax));
        for (int k = lane; k < K; k += 32) sAi[r * SI + k] = quant(__bfloat162float(sA[r * SA + k]), s);
        if (lane == 0) sSa[r] = s;
      }
    }
    __syncthreads();
  }

  bf16* ob = out + row0 * BN + blockIdx.x * TN;
  {
    int acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
    for (int kk = 0; kk < K / 32; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* ar = sAi + (wm + mt * 16 + g) * SI + kk * 32 + t * 4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(ar);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * SI);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(ar + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * SI + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* br = sBt + (wn + nt * 8 + g) * SI + kk * 32 + t * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(br);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(br + 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) fgt::mma_s8_16832(acc[mt][nt], af[mt], b0, b1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = wm + mt * 16 + g;
      float sa0 = 1.f, sa1 = 1.f;
      if constexpr (MODE == kInt8Quant) {
        sa0 = sSa[r];
        sa1 = sSa[r + 8];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = wn + nt * 8 + t * 2;
        float v[4] = {static_cast<float>(acc[mt][nt][0]), static_cast<float>(acc[mt][nt][1]),
                      static_cast<float>(acc[mt][nt][2]), static_cast<float>(acc[mt][nt][3])};
        if constexpr (MODE == kInt8Quant) {
          const float sb0 = sSb[c], sb1 = sSb[c + 1];
          v[0] = __fmul_rn(__fmul_rn(v[0], sa0), sb0);
          v[1] = __fmul_rn(__fmul_rn(v[1], sa0), sb1);
          v[2] = __fmul_rn(__fmul_rn(v[2], sa1), sb0);
          v[3] = __fmul_rn(__fmul_rn(v[3], sa1), sb1);
        }
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(r) * BN + c) = __floats2bfloat162_rn(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(r + 8) * BN + c) =
            __floats2bfloat162_rn(v[2], v[3]);
      }
    }
  }
}

template <int MODE>
cudaError_t launch(const void* a, const void* b, bf16* out, int K, int BM, int BN, int steps, cudaStream_t st) {
  const size_t smem = smem_bytes(MODE, K);
  cudaError_t err = cudaFuncSetAttribute(bare_dot_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bare_dot_kernel<MODE><<<dim3(BN / TN, BM / TM, steps), THREADS, smem, st>>>(a, b, out, K, BM, BN, steps);
  return cudaGetLastError();
}

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

}  // namespace

// a: (steps·BM, K) contiguous, int8 for mode 1 else bf16; b: (K, steps·BN)
// contiguous, the same type; out: (steps·BM, BN) bf16. mode: 0 bf16, 1 int8,
// 2 int8 quantized inside. Requires BM, BN multiples of 128, K a multiple of 32
// in [32, 256], steps in [1, 65535], and for mode 0 a, b and out 16-byte
// aligned (TMA). Returns a cudaError_t: cudaErrorInvalidValue also when a
// tensor map cannot be encoded.
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
    case kInt8: return static_cast<int>(launch<kInt8>(a, b, o, K, BM, BN, steps, st));
    case kInt8Quant: return static_cast<int>(launch<kInt8Quant>(a, b, o, K, BM, BN, steps, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 kernel's registers a thread at launch (before setmaxnreg), local
// memory (spills) a thread, shared memory a block and blocks an SM at K.
extern "C" int fgt_bare_dot_bf16_info(int K, int* regs, int* spill_bytes, int* smem_bytes, int* blocks_per_sm) {
  if (K < 32 || K > 256 || K % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = bf16_smem(K);
  cudaError_t err =
      cudaFuncSetAttribute(bare_dot_bf16_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, bare_dot_bf16_sm90_kernel)) != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *spill_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = smem + static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, bare_dot_bf16_sm90_kernel, H_THREADS, smem));
}
