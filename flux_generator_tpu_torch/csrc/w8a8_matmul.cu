// W8A8 matmul with the activation quantization fused in (kernel G), and the
// per-row int8 quantizer (kernel H), for Hopper (sm_90a).
//
// G replaces the TPU kernel `_kernel` of flux_generator_tpu/ops/pallas/
// w8a8_matmul.py (pallas_call at :119); H replaces `_quant_kernel` (:166).
//
// G computes out = x · (w_q · diag(ws)) for x (M, K) bf16, w_q (K, N) int8 and
// per-output-channel f32 scales ws (N,). w_q is stored K-contiguous (strides
// (1, K)), the layout in which ops.quant stores int8 per-channel weights: int8
// mma.sync takes B only as .col, and cuBLAS's int8 GEMM is fast in it too. K is
// cut into blocks of BK = 512, 256 or 128 (the largest that divides K). For each
// row and K block, sx = max(amax|x|, 1e-12) · (1/127) and x_q = rint(x · rcp(sx))
// with no clip (|x · rcp(sx)| ≤ 127); the block's int32 dot x_q · w_q is added
// into an f32 accumulator as acc += f32(dot) · sx, in block order;
// out = bf16(acc · ws). Numerics follow the TPU kernel: products and sums of the
// f32 fold are rounded one at a time (no fused multiply-add), the reciprocal is
// correctly rounded.
//
// Bound: int8 tensor-core throughput. At a Flux 512² double block's image qkv
// (M 1024, K 3072, N 9216) a call is 58 G int8 operations against 35 MB of x,
// w_q and out, ~1,600 operations a byte.
// Design: two kernels in one call. The TPU kernel quantizes each x block in VMEM
// as the block arrives; on the card every one of the N / 128 output-tile columns
// would quantize the same x tile again, so a first kernel quantizes each
// (row, K block) once (one warp each: 16-byte loads, a warp-shuffle amax) into an
// int8 copy of x (M·K bytes, 1/2 of x) and its f32 scales. The GEMM kernel then
// runs one block of 4 warps per 64 x 128 output tile (2 x 2 warps of 32 x 64)
// over K in 128-byte chunks through a 4-stage cp.async ring in shared memory:
// int8 x rows and 128 K-contiguous weight rows, both copied as they are. The
// warps load fragments with ldmatrix, run mma.sync m16n8k32 into int32
// accumulators and fold them into f32 with the row scales after each K block.
// M and N edges are masked in the kernels; nothing is padded. Not yet used:
// wgmma, TMA.
//
// H: one warp per row: a warp-shuffle amax, then a second pass over the row (from
// cache) writes int8 and the f32 row scale, with the formula above over the whole
// row. Bound: bytes (2 read + 1 written a value).

#include "common.cuh"

namespace {

using fgt::bf16;

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int THREADS = 128;        // 4 warps: 2 along m x 2 along n
constexpr int KC = 128;             // bytes of K a pipeline stage holds
constexpr int STAGES = 4;
constexpr int S = KC + 16;          // shared row stride (bytes), +16 against bank conflicts
constexpr int STAGE_BYTES = (BM + BN) * S;
constexpr int G_SMEM = STAGES * STAGE_BYTES;  // 110,592 bytes: two blocks an SM
constexpr int Q_WARPS = 8;          // (row, K block) items a quantizer block takes

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

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
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

// Stage chunk [k0, k0 + KC) of the x_q rows [m0, m0 + BM) and of the weight
// columns [n0, n0 + BN) (K-contiguous rows of w) into one ring slot. Rows past M
// and columns past N are zero.
__device__ __forceinline__ void stage_rows(const int8_t* __restrict__ src, int rows, int r0, int K,
                                           int k0, int n_rows, int8_t* dst_tile) {
  constexpr int CH = KC / 16;
  for (int idx = threadIdx.x; idx < n_rows * CH; idx += THREADS) {
    const int r = idx / CH;
    const int c = idx % CH;
    int8_t* dst = dst_tile + r * S + c * 16;
    if (r0 + r < rows) {
      cp_async16(dst, src + static_cast<int64_t>(r0 + r) * K + k0 + c * 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void stage_chunk(const int8_t* __restrict__ xq,
                                            const int8_t* __restrict__ w, int M, int N, int K,
                                            int m0, int n0, int k0, int8_t* sA, int8_t* sB) {
  stage_rows(xq, M, m0, K, k0, BM, sA);
  stage_rows(w, N, n0, K, k0, BN, sB);
}

template <int BK>
__global__ void __launch_bounds__(THREADS)
w8a8_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                   const int8_t* __restrict__ w, const float* __restrict__ ws,
                   bf16* __restrict__ out, int M, int N, int K) {
  constexpr int CPB = BK / KC;  // chunks a K block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem_raw);

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 64;
  const int nkb = K / BK;
  const int n_chunks = K / KC;

  float facc[2][8][4];
  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        facc[mt][nt][e] = 0.f;
        acc[mt][nt][e] = 0;
      }

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_chunks) {
      int8_t* slot = ring + st * STAGE_BYTES;
      stage_chunk(xq, w, M, N, K, m0, n0, st * KC, slot, slot + BM * S);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int c = 0; c < n_chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();  // chunk c has landed, and every warp is done with chunk c - 1
    const int next = c + STAGES - 1;
    if (next < n_chunks) {
      int8_t* slot = ring + (next % STAGES) * STAGE_BYTES;
      stage_chunk(xq, w, M, N, K, m0, n0, next * KC, slot, slot + BM * S);
    }
    asm volatile("cp.async.commit_group;\n" ::);

    const int8_t* sA = ring + (c % STAGES) * STAGE_BYTES;
    const int8_t* sB = sA + BM * S;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        fgt::ldmatrix_x4(a[mt], sA + (wm + mt * 16 + (lane & 15)) * S + ks + (lane >> 4) * 16);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {  // two n8 tiles a load
        uint32_t b[4];
        fgt::ldmatrix_x4(b, sB + (wn + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + ks +
                                ((lane >> 3) & 1) * 16);
        fgt::mma_s8_16832(acc[0][2 * np], a[0], b[0], b[1]);
        fgt::mma_s8_16832(acc[1][2 * np], a[1], b[0], b[1]);
        fgt::mma_s8_16832(acc[0][2 * np + 1], a[0], b[2], b[3]);
        fgt::mma_s8_16832(acc[1][2 * np + 1], a[1], b[2], b[3]);
      }
    }

    if ((c + 1) % CPB == 0) {  // the end of K block kb: fold with its row scales, in block order
      const int kb = c / CPB;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r0 = m0 + wm + mt * 16 + g;
        const float s0 = r0 < M ? sx[static_cast<int64_t>(r0) * nkb + kb] : 0.f;
        const float s1 = r0 + 8 < M ? sx[static_cast<int64_t>(r0 + 8) * nkb + kb] : 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          facc[mt][nt][0] = __fadd_rn(facc[mt][nt][0], __fmul_rn(static_cast<float>(acc[mt][nt][0]), s0));
          facc[mt][nt][1] = __fadd_rn(facc[mt][nt][1], __fmul_rn(static_cast<float>(acc[mt][nt][1]), s0));
          facc[mt][nt][2] = __fadd_rn(facc[mt][nt][2], __fmul_rn(static_cast<float>(acc[mt][nt][2]), s1));
          facc[mt][nt][3] = __fadd_rn(facc[mt][nt][3], __fmul_rn(static_cast<float>(acc[mt][nt][3]), s1));
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);

#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + wn + nt * 8 + t * 2;
    if (col >= N) continue;
    const bool pair = col + 1 < N;
    const float w0 = ws[col];
    const float w1 = pair ? ws[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mt * 16 + g + half * 8;
        if (row >= M) continue;
        bf16* dst = out + static_cast<int64_t>(row) * N + col;
        const float y0 = __fmul_rn(facc[mt][nt][2 * half], w0);
        const float y1 = __fmul_rn(facc[mt][nt][2 * half + 1], w1);
        if (pair && (N % 2 == 0)) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
        } else {
          dst[0] = __float2bfloat16_rn(y0);
          if (pair) dst[1] = __float2bfloat16_rn(y1);
        }
      }
    }
  }
}

template <int BK>
cudaError_t launch_g(const bf16* x, int8_t* xq, float* sx, const int8_t* w, const float* ws, bf16* out,
                     int M, int N, int K, cudaStream_t stream) {
  const int items = M * (K / BK);
  quantize_blocks_kernel<BK><<<(items + Q_WARPS - 1) / Q_WARPS, Q_WARPS * 32, 0, stream>>>(x, xq, sx, M, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(w8a8_matmul_kernel<BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w8a8_matmul_kernel<BK><<<grid, THREADS, G_SMEM, stream>>>(xq, sx, w, ws, out, M, N, K);
  return cudaGetLastError();
}

// H: one warp a row, Q_WARPS rows a block: the row's amax from a first sweep,
// then a second sweep (from cache) writes int8. VEC: K % 8 == 0 and aligned rows.
template <bool VEC>
__global__ void __launch_bounds__(Q_WARPS * 32)
quantize_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                     int M, int K) {
  const int row = blockIdx.x * Q_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const bf16* xr = x + static_cast<int64_t>(row) * K;
  int8_t* qr = xq + static_cast<int64_t>(row) * K;
  float amax = 0.f;
  if (VEC) {
#pragma unroll 4
    for (int c = lane; c < K / 8; c += 32) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
    }
  } else {
    for (int i = lane; i < K; i += 32) amax = fmaxf(amax, fabsf(__bfloat162float(xr[i])));
  }
  amax = fgt::warp_max(amax);
  const float s = row_scale(amax);
  const float rcp = __frcp_rn(s);
  if (VEC) {
#pragma unroll 4
    for (int c = lane; c < K / 8; c += 32) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), f);
      *reinterpret_cast<uint2*>(qr + c * 8) = quant8(f, rcp);
    }
  } else {
    for (int i = lane; i < K; i += 32) {
      qr[i] = static_cast<int8_t>(__float2int_rn(__fmul_rn(__bfloat162float(xr[i]), rcp)));
    }
  }
  if (lane == 0) sx[row] = s;
}

}  // namespace

// x: (M, K) contiguous bf16, 16-byte aligned; xq: (M, K) int8 and sx: (M, K/BK)
// f32 scratch (BK the largest of 512, 256, 128 dividing K), xq 16-byte aligned;
// w: (K, N) int8, K-contiguous (strides (1, K)), 16-byte aligned; ws: (N,) f32;
// out: (M, N) bf16. Requires K % 128 == 0. Returns a cudaError_t.
extern "C" int fgt_w8a8_matmul(const void* x, void* xq, void* sx, const void* w, const void* ws,
                               void* out, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 128 != 0 || (M + BM - 1) / BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf16* xb = static_cast<const bf16*>(x);
  int8_t* qb = static_cast<int8_t*>(xq);
  float* sb = static_cast<float*>(sx);
  const int8_t* wb = static_cast<const int8_t*>(w);
  const float* wsb = static_cast<const float*>(ws);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 512 == 0) return static_cast<int>(launch_g<512>(xb, qb, sb, wb, wsb, ob, M, N, K, st));
  if (K % 256 == 0) return static_cast<int>(launch_g<256>(xb, qb, sb, wb, wsb, ob, M, N, K, st));
  return static_cast<int>(launch_g<128>(xb, qb, sb, wb, wsb, ob, M, N, K, st));
}

// x: (M, K) contiguous bf16; xq: (M, K) int8; sx: (M,) f32. Returns a cudaError_t.
extern "C" int fgt_quantize_rows(const void* x, void* xq, void* sx, int M, int K, void* stream) {
  if (M <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  int8_t* qb = static_cast<int8_t*>(xq);
  float* sb = static_cast<float*>(sx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xq) % 8 == 0;
  const int blocks = (M + Q_WARPS - 1) / Q_WARPS;
  if (vec) {
    quantize_rows_kernel<true><<<blocks, Q_WARPS * 32, 0, st>>>(xb, qb, sb, M, K);
  } else {
    quantize_rows_kernel<false><<<blocks, Q_WARPS * 32, 0, st>>>(xb, qb, sb, M, K);
  }
  return static_cast<int>(cudaGetLastError());
}
