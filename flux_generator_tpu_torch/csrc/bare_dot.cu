// The bare-dot probe (#13) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dot_kernel` of scripts/prof_attn_int8.py
// (pallas_call at :76, called by `bare_dot`), the probe that asks whether
// int8 attention loses its time in the int8 matrix unit or in quantizing
// inside the kernel. With its BlockSpecs it computes, for a (steps·BM, K) and
// b (K, steps·BN), out[i·BM:(i+1)·BM] = a_blk(i) · b_blk(i) in bf16, where
// a_blk(i) is rows i·BM.. of a and b_blk(i) columns i·BN.. of b, i < steps:
//   BF16:        bf16 in, f32 sums (mma.sync m16n8k16), rounded to bf16;
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
// tensor-core work, so bytes bound it, the output above all.
// Design: one block of 8 warps per 128 x 128 output tile (64 tiles a step at
// BM = BN = 1024), the whole K (≤ 256) of its a rows and b columns staged in
// shared memory; each warp owns a 32 x 64 sub-tile. bf16 B fragments come from
// ldmatrix.trans of the row-major b tile; int8 b is stored transposed
// (K-contiguous) for the m16n8k32 B fragment. In INT8_QUANT warps 0-3 quantize
// the 128 b columns (one a thread) while warps 4-7 quantize the 128 a rows (32
// a warp). Not yet used: wgmma, TMA, cp.async pipelining.

#include "common.cuh"

namespace {

using fgt::bf16;

constexpr int TM = 128;  // output rows per block
constexpr int TN = 128;  // output columns per block
constexpr int THREADS = 256;
constexpr int SB = TN + 8;  // row stride of the bf16 b tile (elements)

enum Mode : int { kBf16 = 0, kInt8 = 1, kInt8Quant = 2 };

__host__ __device__ constexpr int sa_stride(int K) { return K + 8; }   // bf16 a rows (elements)
__host__ __device__ constexpr int si_stride(int K) { return K + 16; }  // int8 rows (bytes)

__host__ __device__ inline size_t smem_bytes(int mode, int K) {
  const size_t bf = static_cast<size_t>(TM) * sa_stride(K) * 2 + static_cast<size_t>(K) * SB * 2;
  const size_t i8 = static_cast<size_t>(TM + TN) * si_stride(K);
  if (mode == kBf16) return bf;
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
  bf16* sA = reinterpret_cast<bf16*>(smem);                 // [TM][SA] bf16 (BF16, INT8_QUANT)
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
  if constexpr (MODE == kBf16) {
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    for (int ks = 0; ks < K / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* xr = sA + (wm + mt * 16 + g) * SA + ks * 16 + t * 2;
        af[mt][0] = fgt::ld_u32(xr);
        af[mt][1] = fgt::ld_u32(xr + 8 * SA);
        af[mt][2] = fgt::ld_u32(xr + 8);
        af[mt][3] = fgt::ld_u32(xr + 8 * SA + 8);
      }
      const bf16* brow = sB + (ks * 16 + (lane & 15)) * SB + wn + (lane >> 4) * 8;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        fgt::ldmatrix_x4_trans(bfr, brow + np * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          fgt::mma_bf16_16816(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          fgt::mma_bf16_16816(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = wm + mt * 16 + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = wn + nt * 8 + t * 2;
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(r) * BN + c) =
            __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(r + 8) * BN + c) =
            __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  } else {
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

}  // namespace

// a: (steps·BM, K) contiguous, int8 for mode 1 else bf16; b: (K, steps·BN)
// contiguous, the same type; out: (steps·BM, BN) bf16. mode: 0 bf16, 1 int8,
// 2 int8 quantized inside. Requires BM, BN multiples of 128, K a multiple of 32
// in [32, 256], steps in [1, 65535]. Returns a cudaError_t.
extern "C" int fgt_bare_dot(const void* a, const void* b, void* out, int K, int BM, int BN, int steps,
                            int mode, void* stream) {
  if (K < 32 || K > 256 || K % 32 != 0 || BM <= 0 || BN <= 0 || BM % TM != 0 || BN % TN != 0 ||
      steps <= 0 || steps > 65535 || BM / TM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kBf16: return static_cast<int>(launch<kBf16>(a, b, o, K, BM, BN, steps, st));
    case kInt8: return static_cast<int>(launch<kInt8>(a, b, o, K, BM, BN, steps, st));
    case kInt8Quant: return static_cast<int>(launch<kInt8Quant>(a, b, o, K, BM, BN, steps, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
