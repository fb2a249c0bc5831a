// Flash-attention backward for Hopper (sm_90a): kernel E (dQ) and kernel F (dK, dV).
//
// Replace the TPU kernels `_bwd_dq_kernel` (pallas_call at
// flux_generator_tpu/ops/pallas/flash_attention.py:438) and `_bwd_dkv_kernel`
// (:452), reached from `_flash_core_bwd` → `_bwd_core`. As there, RoPE is
// applied outside: both kernels take the ROTATED q and k, v, the output
// gradient dO, the forward's row logsumexp lse and dvec = rowsum(dO ∘ O),
// and compute, per (batch, head) with P = exp(q·kᵀ·scale − lse):
//   dP = dO · vᵀ,  dS = P ∘ (dP − dvec),
//   E: dQ = dS · k · scale              (one block per 64 query rows, loop over keys)
//   F: dK = dSᵀ · q · scale, dV = Pᵀ · dO (one block per 64 keys, loop over queries)
// Each output is accumulated in registers by the one block that owns it and
// written once, as the two TPU passes accumulate along their innermost grid
// axis: no atomics, so a run is deterministic.
//
// Layout: q, k, v, dO, dQ, dK, dV (B, L, H, D) contiguous bf16, D in {64, 128},
// any L; lse, dvec (B·H, L) f32. Rows past L are masked as `l_actual` masks
// them on the TPU: a key past L gives P = 0 in E, a query past L adds 0 in F
// (their tiles are zero-filled in shared memory and never stored).
//
// Numerics: q·kᵀ and dO·vᵀ are bf16 products with f32 accumulation, which is
// exact for bf16 inputs, as the TPU kernels' f32 products are. P and dS are
// f32 and are rounded to bf16 to feed dS·k, Pᵀ·dO and dSᵀ·q (2⁻⁹ relative per
// term, the rounding kernel A applies to P before P·V); outputs are bf16.
//
// Bound: tensor-core throughput. At Flux-dev training's shape (L = 1536,
// H = 24, D = 128) E does 6·L²·D·H ≈ 43.5 GFLOP (three products: S, dP, dQ)
// and F 8·L²·D·H ≈ 58 GFLOP (S, dP, dV, dK) against ~57 MB of traffic.
// Design: warp-level mma.sync m16n8k16, 4 warps of 16 rows per block, tiles
// staged in shared memory with rows padded by 16 bytes (fragment loads free
// of bank conflicts). F computes Sᵀ = k·qᵀ and dPᵀ = v·dOᵀ directly, with the
// block's keys as the MMA rows, so Pᵀ and dSᵀ come out in accumulator layout
// and feed the next products as A fragments with no transpose through shared
// memory; the q/dO tiles are then read as B operands with ldmatrix.trans. E
// and F keep their A operands in shared memory and load fragments per k-step,
// which holds registers near 128 (two f32 accumulators of D columns in F).
// Not yet used: wgmma, TMA, cp.async double buffering.

#include <math.h>

#include "common.cuh"

namespace {

using fgt::bf16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 16;  // rows each block owns: queries in E, keys in F
constexpr int KT = 64;            // keys per tile in E
constexpr int QT = 32;            // queries per tile in F
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int stride() { return D + 8; }

template <int D>
__host__ __device__ constexpr int dq_smem_bytes() { return (2 * ROWS + 2 * KT) * stride<D>() * 2; }

template <int D>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return (2 * ROWS + 2 * QT) * stride<D>() * 2 + 2 * QT * 4;
}

// Rows [row0, row0 + N) of one head into shared memory, zero past L.
template <int D, int N>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src,
                                          int64_t row_stride, int row0, int L) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < N * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < L) val = *reinterpret_cast<const uint4*>(src + row * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * stride<D>() + c * 8) = val;
  }
}

// A fragment (16 rows from `rows`, k16 step kk) of a row-major tile in shared memory.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* rows, int kk, int g, int t) {
  constexpr int S = stride<D>();
  a[0] = fgt::ld_u32(rows + g * S + kk * 16 + t * 2);
  a[1] = fgt::ld_u32(rows + (g + 8) * S + kk * 16 + t * 2);
  a[2] = fgt::ld_u32(rows + g * S + kk * 16 + 8 + t * 2);
  a[3] = fgt::ld_u32(rows + (g + 8) * S + kk * 16 + 8 + t * 2);
}

// acc (16 x D) += A (16 x 16·KS, from accumulator tiles `x`, rounded to bf16)
// · T (16·KS rows x D, row-major in shared memory), for the warp.
template <int D, int KS>
__device__ __forceinline__ void mma_acc_rows(float (&acc)[D / 8][4], const float (&x)[2 * KS][4],
                                             const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t pa[4] = {
        fgt::pack_bf16x2(x[2 * kk][0], x[2 * kk][1]),
        fgt::pack_bf16x2(x[2 * kk][2], x[2 * kk][3]),
        fgt::pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]),
        fgt::pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]),
    };
    const bf16* row = tile + (kk * 16 + (lane & 15)) * stride<D>() + (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      fgt::ldmatrix_x4_trans(b, row + dp * 16);
      fgt::mma_bf16_16816(acc[2 * dp], pa, b[0], b[1]);
      fgt::mma_bf16_16816(acc[2 * dp + 1], pa, b[2], b[3]);
    }
  }
}

// Store a warp's 16 x D accumulator (times `mul`) as bf16 rows r0 and r0 + 8.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, int64_t row_stride, const float (&acc)[D / 8][4],
                                           int r0, int L, int t, float mul) {
  if (r0 < L) {
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(out + r0 * row_stride + dt * 8 + t * 2) =
          __floats2bfloat162_rn(acc[dt][0] * mul, acc[dt][1] * mul);
    }
  }
  if (r0 + 8 < L) {
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 8) * row_stride + dt * 8 + t * 2) =
          __floats2bfloat162_rn(acc[dt][2] * mul, acc[dt][3] * mul);
    }
  }
}

// ------------------------------------------------------------------ E: dQ

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dvec,
                    bf16* __restrict__ dq, int L, int H, float scale) {
  constexpr int S = stride<D>();
  constexpr int KD = D / 16;  // k16 steps over the head dim
  constexpr int NT = KT / 8;  // n8 logit tiles per key tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + ROWS * S;  // dO rows
  bf16* sK = sO + ROWS * S;
  bf16* sV = sK + KT * S;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * ROWS;
  const int64_t row_stride = static_cast<int64_t>(H) * D;
  const int64_t head_off = (static_cast<int64_t>(b) * L * H + h) * D;

  load_rows<D, ROWS>(sQ, q + head_off, row_stride, q0, L);
  load_rows<D, ROWS>(sO, dout + head_off, row_stride, q0, L);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* qw = sQ + warp * 16 * S;
  const bf16* ow = sO + warp * 16 * S;

  // this thread's rows: g (fragment elements 0, 1) and g + 8 (elements 2, 3)
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const float* lse_h = lse + static_cast<int64_t>(bh) * L;
  const float* dv_h = dvec + static_cast<int64_t>(bh) * L;
  const float lb0 = r0 < L ? lse_h[r0] * LOG2E : 0.f;
  const float lb1 = r1 < L ? lse_h[r1] * LOG2E : 0.f;
  const float dv0 = r0 < L ? dv_h[r0] : 0.f;
  const float dv1 = r1 < L ? dv_h[r1] : 0.f;
  const float sl2 = scale * LOG2E;

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int n_tiles = (L + KT - 1) / KT;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * KT;
    __syncthreads();  // every warp is done with the previous tile (and sQ/sO are in)
    load_rows<D, KT>(sK, k + head_off, row_stride, k0, L);
    load_rows<D, KT>(sV, v + head_off, row_stride, k0, L);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], oa[4];
      load_a<D>(qa, qw, kk, g, t);
      load_a<D>(oa, ow, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* kr = sK + (nt * 8 + g) * S + kk * 16 + t * 2;
        const bf16* vr = sV + (nt * 8 + g) * S + kk * 16 + t * 2;
        fgt::mma_bf16_16816(s[nt], qa, fgt::ld_u32(kr), fgt::ld_u32(kr + 8));
        fgt::mma_bf16_16816(dp[nt], oa, fgt::ld_u32(vr), fgt::ld_u32(vr + 8));
      }
    }

    // dS = P ∘ (dP − dvec), with P = 0 for keys past L
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + t * 2 + (e & 1);
        const float p = key < L ? exp2f(fmaf(s[nt][e], sl2, -(e < 2 ? lb0 : lb1))) : 0.f;
        s[nt][e] = p * (dp[nt][e] - (e < 2 ? dv0 : dv1));
      }
    }
    mma_acc_rows<D, KT / 16>(acc, s, sK, lane);  // dQ += dS · k
  }

  store_rows<D>(dq + head_off, row_stride, acc, r0, L, t, scale);
}

// ------------------------------------------------------------------ F: dK, dV

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dvec,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H, float scale) {
  constexpr int S = stride<D>();
  constexpr int KD = D / 16;
  constexpr int NT = QT / 8;  // n8 tiles of queries per query tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + ROWS * S;
  bf16* sQ = sV + ROWS * S;
  bf16* sO = sQ + QT * S;  // dO rows
  float* sL = reinterpret_cast<float*>(sO + QT * S);  // lse · log2(e) of the query tile
  float* sD = sL + QT;                                // dvec of the query tile

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * ROWS;
  const int64_t row_stride = static_cast<int64_t>(H) * D;
  const int64_t head_off = (static_cast<int64_t>(b) * L * H + h) * D;
  const float* lse_h = lse + static_cast<int64_t>(bh) * L;
  const float* dv_h = dvec + static_cast<int64_t>(bh) * L;

  load_rows<D, ROWS>(sK, k + head_off, row_stride, k0, L);
  load_rows<D, ROWS>(sV, v + head_off, row_stride, k0, L);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* kw = sK + warp * 16 * S;
  const bf16* vw = sV + warp * 16 * S;
  const float sl2 = scale * LOG2E;

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc_k[dt][0] = acc_k[dt][1] = acc_k[dt][2] = acc_k[dt][3] = 0.f;
    acc_v[dt][0] = acc_v[dt][1] = acc_v[dt][2] = acc_v[dt][3] = 0.f;
  }

  const int n_tiles = (L + QT - 1) / QT;
  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = j * QT;
    __syncthreads();
    load_rows<D, QT>(sQ, q + head_off, row_stride, q0, L);
    load_rows<D, QT>(sO, dout + head_off, row_stride, q0, L);
    if (threadIdx.x < QT) {
      const int row = q0 + threadIdx.x;
      sL[threadIdx.x] = row < L ? lse_h[row] * LOG2E : 0.f;
      sD[threadIdx.x] = row < L ? dv_h[row] : 0.f;
    }
    __syncthreads();

    // Sᵀ = k · qᵀ and dPᵀ = v · dOᵀ: this warp's 16 keys as rows, the tile's queries as columns
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      load_a<D>(ka, kw, kk, g, t);
      load_a<D>(va, vw, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* qr = sQ + (nt * 8 + g) * S + kk * 16 + t * 2;
        const bf16* orow = sO + (nt * 8 + g) * S + kk * 16 + t * 2;
        fgt::mma_bf16_16816(st[nt], ka, fgt::ld_u32(qr), fgt::ld_u32(qr + 8));
        fgt::mma_bf16_16816(dpt[nt], va, fgt::ld_u32(orow), fgt::ld_u32(orow + 8));
      }
    }

    // Pᵀ and dSᵀ, with the lse and dvec of each element's query column; P = 0
    // for queries past L
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + t * 2 + (e & 1);
        const float p = q0 + c < L ? exp2f(fmaf(st[nt][e], sl2, -sL[c])) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - sD[c]);
      }
    }
    mma_acc_rows<D, QT / 16>(acc_v, st, sO, lane);   // dV += Pᵀ · dO
    mma_acc_rows<D, QT / 16>(acc_k, dpt, sQ, lane);  // dK += dSᵀ · q
  }

  const int r0 = k0 + warp * 16 + g;
  store_rows<D>(dk + head_off, row_stride, acc_k, r0, L, t, scale);
  store_rows<D>(dv + head_off, row_stride, acc_v, r0, L, t, 1.f);
}

template <int D>
cudaError_t launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                      const float* lse, const float* dvec, bf16* dq, int B, int L, int H,
                      float scale, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + ROWS - 1) / ROWS, B * H);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(q, k, v, dout, lse, dvec, dq, L, H, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* lse, const float* dvec, bf16* dk, bf16* dv, int B, int L,
                       int H, float scale, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + ROWS - 1) / ROWS, B * H);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(q, k, v, dout, lse, dvec, dk, dv, L,
                                                            H, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int L, int H) { return B <= 0 || L <= 0 || H <= 0 || B * H > 65535; }

}  // namespace

// q, k (rotated), v, dout, dq: (B, L, H, D) contiguous bf16; lse, dvec: (B·H, L)
// f32. Returns a cudaError_t.
extern "C" int fgt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* dvec,
                                          void* dq, int B, int L, int H, int D, float scale,
                                          void* stream) {
  if (bad_shape(B, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(dout);
  const float* lb = static_cast<const float*>(lse);
  const float* db = static_cast<const float*>(dvec);
  bf16* out = static_cast<bf16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return static_cast<int>(launch_dq<128>(qb, kb, vb, ob, lb, db, out, B, L, H, scale, st));
  if (D == 64) return static_cast<int>(launch_dq<64>(qb, kb, vb, ob, lb, db, out, B, L, H, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above, writing dk and dv: (B, L, H, D) contiguous bf16.
extern "C" int fgt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* dvec,
                                           void* dk, void* dv, int B, int L, int H, int D,
                                           float scale, void* stream) {
  if (bad_shape(B, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(dout);
  const float* lb = static_cast<const float*>(lse);
  const float* db = static_cast<const float*>(dvec);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return static_cast<int>(launch_dkv<128>(qb, kb, vb, ob, lb, db, dkb, dvb, B, L, H, scale, st));
  }
  if (D == 64) {
    return static_cast<int>(launch_dkv<64>(qb, kb, vb, ob, lb, db, dkb, dvb, B, L, H, scale, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
