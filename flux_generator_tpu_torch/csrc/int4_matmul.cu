// int4 unpack-in-matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of flux_generator_tpu/ops/pallas/int4_matmul.py
// (pallas_call at :148), which runs every T5-XXL matmul on the Flux path.
//
// Computes y = x · W for x (M, K) bf16 or f32 and W stored as packed int4 (K/2, N)
// uint8 in the repo's SPLIT layout (ops/quant.pack_int4): packed row r holds
// original row r in the low nibble and row r + K/2 in the high nibble, both
// biased by +8. Scales are f32, per output channel (N,) or per input group
// (K/gs, N); the first g/2 groups belong to the low half. Numerics follow the
// TPU kernel: grouped weights are dequantized in f32 and rounded to bf16 before
// the product; per-channel weights enter the product as exact small integers
// and the scale is folded into the f32 accumulator after the K loop. The
// accumulator is f32 throughout. Bias stays outside, in ops/linear.dense.
//
// Bound: at the T5-XXL shapes (M = 256 tokens; 4096→4096, 4096→10240,
// 10240→4096) a call does 2·M·K·N ≈ 8.6–21 GFLOP against 8–21 MB of packed
// weights, ~400 FLOP per weight byte, so it is bound by tensor-core (and, for
// the in-loop dequantization, CUDA-core) throughput, not by bytes: the weights
// of the whole T5-XXL encoder are about 2.4 GB.
// Design: one block of 4 warps per 64 x 128 output tile; each step takes 32
// packed rows, i.e. 32 rows of each K half. The block unpacks both nibbles,
// dequantizes them into two bf16 (32, 128) tiles in shared memory, stages the
// matching x columns of both halves, and each warp runs mma.sync m16n8k16 over
// its 32 x 64 sub-tile for both halves into one f32 accumulator. B fragments
// come from ldmatrix.trans. Not yet used: wgmma, TMA, software pipelining.
//
// Shapes, as the TPU wrapper takes them: any M (rows past M are masked where
// the TPU wrapper pads them with zeros) and any N (columns past N read the
// byte 0x88, whose nibbles dequantize to 0, where the TPU wrapper pads with
// 0x88; a row stride that is no multiple of 16 bytes is read byte by byte).
// f32 activations take their own route: no tensor cores, since TF32 would
// round x and the weights to 10 mantissa bits. The weights are dequantized in
// f32 (grouped: q · s in f32, per channel: q, the scale folded after the K
// loop, as for bf16) and every product is an f32 FMA on the CUDA cores, 64 x 64
// outputs a block of 256 threads, 4 x 4 a thread, 16 packed rows a step.

#include "common.cuh"

namespace {

using fgt::bf16;

constexpr int BM = 64;    // rows of x per block
constexpr int BN = 128;   // output columns per block
constexpr int BKP = 32;   // packed rows per step (32 rows of each K half)
constexpr int THREADS = 128;  // 4 warps: 2 along m x 2 along n, 32 x 64 each
constexpr int XS = BKP + 8;   // shared row stride of x tiles (bf16), +16 B vs bank conflicts
constexpr int WS = BN + 8;    // shared row stride of dequantized W tiles (bf16)

// 16 packed bytes of one row from column col: one 16-byte load where the
// row stride allows it, else byte by byte; columns past N read 0x88.
__device__ __forceinline__ void load_packed16(uint8_t (&bytes)[16], const uint8_t* __restrict__ row,
                                              int col, int N) {
  if (N % 16 == 0 && col + 16 <= N) {
    *reinterpret_cast<uint4*>(bytes) = *reinterpret_cast<const uint4*>(row + col);
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) bytes[j] = col + j < N ? row[col + j] : uint8_t{0x88};
}

// out[col], out[col + 1] of one output row as bf16; col + 1 only below N.
__device__ __forceinline__ void store_pair(bf16* row, int col, int N, float v0, float v1) {
  if (N % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  row[col] = __float2bfloat16_rn(v0);
  if (col + 1 < N) row[col + 1] = __float2bfloat16_rn(v1);
}

template <bool GROUPED>
__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale, bf16* __restrict__ out,
                   int M, int N, int K, int group_size) {
  __shared__ __align__(16) bf16 sX[2][BM * XS];   // [K half][m][k]
  __shared__ __align__(16) bf16 sW[2][BKP * WS];  // [K half][k][n]

  const int Kp = K / 2;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 64;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int kb = 0; kb < Kp; kb += BKP) {
    __syncthreads();  // every warp is done with the previous tiles

    // x columns [kb, kb + BKP) of both halves: 4 16-byte chunks per row
    constexpr int XCH = BKP / 8;
    for (int idx = threadIdx.x; idx < 2 * BM * XCH; idx += THREADS) {
      const int half = idx / (BM * XCH);
      const int rem = idx % (BM * XCH);
      const int r = rem / XCH;
      const int c = rem % XCH;
      const int row = m0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < M) {
        val = *reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * K + half * Kp + kb + c * 8);
      }
      *reinterpret_cast<uint4*>(&sX[half][r * XS + c * 8]) = val;
    }

    // packed rows [kb, kb + BKP) x columns [n0, n0 + BN): 16 bytes per chunk
    constexpr int WCH = BN / 16;
    for (int idx = threadIdx.x; idx < BKP * WCH; idx += THREADS) {
      const int r = idx / WCH;
      const int c = idx % WCH;
      const int col = n0 + c * 16;
      __align__(16) uint8_t bytes[16];
      load_packed16(bytes, w + static_cast<int64_t>(kb + r) * N, col, N);
      __align__(16) bf16 lo[16];
      __align__(16) bf16 hi[16];
      if constexpr (GROUPED) {
        const float* s_lo = scale + static_cast<int64_t>((kb + r) / group_size) * N;
        const float* s_hi = scale + static_cast<int64_t>((kb + r + Kp) / group_size) * N;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float sl = col + j < N ? s_lo[col + j] : 0.f;
          const float sh = col + j < N ? s_hi[col + j] : 0.f;
          lo[j] = __float2bfloat16_rn(static_cast<float>((bytes[j] & 15) - 8) * sl);
          hi[j] = __float2bfloat16_rn(static_cast<float>((bytes[j] >> 4) - 8) * sh);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          lo[j] = __float2bfloat16_rn(static_cast<float>((bytes[j] & 15) - 8));
          hi[j] = __float2bfloat16_rn(static_cast<float>((bytes[j] >> 4) - 8));
        }
      }
      uint4* dlo = reinterpret_cast<uint4*>(&sW[0][r * WS + c * 16]);
      uint4* dhi = reinterpret_cast<uint4*>(&sW[1][r * WS + c * 16]);
      dlo[0] = reinterpret_cast<const uint4*>(lo)[0];
      dlo[1] = reinterpret_cast<const uint4*>(lo)[1];
      dhi[0] = reinterpret_cast<const uint4*>(hi)[0];
      dhi[1] = reinterpret_cast<const uint4*>(hi)[1];
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int ks = 0; ks < BKP / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const bf16* xr = &sX[half][(wm + mt * 16 + g) * XS + ks * 16 + t * 2];
          a[mt][0] = fgt::ld_u32(xr);
          a[mt][1] = fgt::ld_u32(xr + 8 * XS);
          a[mt][2] = fgt::ld_u32(xr + 8);
          a[mt][3] = fgt::ld_u32(xr + 8 * XS + 8);
        }
        const bf16* wrow = &sW[half][(ks * 16 + (lane & 15)) * WS + wn + (lane >> 4) * 8];
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bfr[4];
          fgt::ldmatrix_x4_trans(bfr, wrow + np * 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            fgt::mma_bf16_16816(acc[mt][2 * np], a[mt], bfr[0], bfr[1]);
            fgt::mma_bf16_16816(acc[mt][2 * np + 1], a[mt], bfr[2], bfr[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + wn + nt * 8 + t * 2;
    if (col >= N) continue;
    float s0 = 1.f, s1 = 1.f;
    if constexpr (!GROUPED) {
      s0 = scale[col];
      s1 = col + 1 < N ? scale[col + 1] : 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = m0 + wm + mt * 16 + g;
      if (row < M) store_pair(out + static_cast<int64_t>(row) * N, col, N, acc[mt][nt][0] * s0, acc[mt][nt][1] * s1);
      if (row + 8 < M) {
        store_pair(out + static_cast<int64_t>(row + 8) * N, col, N, acc[mt][nt][2] * s0, acc[mt][nt][3] * s1);
      }
    }
  }
}

constexpr int FBM = 64;        // f32 route: rows of x per block
constexpr int FBN = 64;        // output columns per block
constexpr int FBKP = 16;       // packed rows per step
constexpr int FTHREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <bool GROUPED>
__global__ void __launch_bounds__(FTHREADS)
int4_matmul_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                       const float* __restrict__ scale, float* __restrict__ out,
                       int M, int N, int K, int group_size) {
  __shared__ float sX[2][FBKP][FBM + 4];  // [K half][k][m]: x transposed
  __shared__ float sW[2][FBKP][FBN + 4];  // [K half][k][n]: dequantized W

  const int Kp = K / 2;
  const int m0 = blockIdx.y * FBM;
  const int n0 = blockIdx.x * FBN;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kb = 0; kb < Kp; kb += FBKP) {
    __syncthreads();  // every thread is done with the previous tiles
    for (int idx = threadIdx.x; idx < 2 * FBM * FBKP; idx += FTHREADS) {
      const int half = idx / (FBM * FBKP);
      const int rem = idx % (FBM * FBKP);
      const int m = rem / FBKP;
      const int k = rem % FBKP;
      const int row = m0 + m;
      sX[half][k][m] = row < M ? x[static_cast<int64_t>(row) * K + half * Kp + kb + k] : 0.f;
    }
    for (int idx = threadIdx.x; idx < FBKP * FBN; idx += FTHREADS) {
      const int k = idx / FBN;
      const int n = idx % FBN;
      const int col = n0 + n;
      const uint8_t byte = col < N ? w[static_cast<int64_t>(kb + k) * N + col] : uint8_t{0x88};
      float lo = static_cast<float>((byte & 15) - 8);
      float hi = static_cast<float>((byte >> 4) - 8);
      if constexpr (GROUPED) {
        lo = col < N ? lo * scale[static_cast<int64_t>((kb + k) / group_size) * N + col] : 0.f;
        hi = col < N ? hi * scale[static_cast<int64_t>((kb + k + Kp) / group_size) * N + col] : 0.f;
      }
      sW[0][k][n] = lo;
      sW[1][k][n] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll 4
      for (int k = 0; k < FBKP; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = sX[half][k][ty * 4 + i];
          b[i] = sW[half][k][tx * 4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx * 4 + j;
    if (col >= N) continue;
    const float s = GROUPED ? 1.f : scale[col];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row < M) out[static_cast<int64_t>(row) * N + col] = GROUPED ? acc[i][j] : acc[i][j] * s;
    }
  }
}

}  // namespace

// x: (M, K) contiguous, bf16 (x_f32 == 0) or f32 (x_f32 == 1); w: (K/2, N)
// contiguous uint8; scale: (N,) f32 when group_size == 0, else (K/group_size, N)
// f32; out: (M, N) in x's dtype. Requires K % 64 == 0 and, when grouped,
// (K/2) % group_size == 0. Returns a cudaError_t.
extern "C" int fgt_int4_matmul(const void* x, const void* w, const void* scale, void* out,
                               int M, int N, int K, int group_size, int x_f32, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % (2 * BKP) != 0 ||
      (group_size > 0 && (K / 2) % group_size != 0) || (M + FBM - 1) / FBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* sb = static_cast<const float*>(scale);
  if (x_f32) {
    const dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    const float* xf = static_cast<const float*>(x);
    float* of = static_cast<float*>(out);
    if (group_size > 0) {
      int4_matmul_f32_kernel<true><<<grid, FTHREADS, 0, st>>>(xf, wb, sb, of, M, N, K, group_size);
    } else {
      int4_matmul_f32_kernel<false><<<grid, FTHREADS, 0, st>>>(xf, wb, sb, of, M, N, K, 0);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  if (group_size > 0) {
    int4_matmul_kernel<true><<<grid, THREADS, 0, st>>>(xb, wb, sb, ob, M, N, K, group_size);
  } else {
    int4_matmul_kernel<false><<<grid, THREADS, 0, st>>>(xb, wb, sb, ob, M, N, K, 0);
  }
  return static_cast<int>(cudaGetLastError());
}
