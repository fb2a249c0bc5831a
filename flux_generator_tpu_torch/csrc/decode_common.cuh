// The weight-streaming machinery of the first design of the MusicGen decode
// step (kernel D, which now has its own in decode_step.cu), kept for its
// probes (decode_chain.cu, chain_bisect.cu), for Hopper (sm_90a): one
// persistent cooperative launch walks the layers' 14 weight chunks of (H, H)
// in phases separated by grid syncs.
//
//   projection   tiles of 128 output columns × a k-slice, whose weight rows
//                are copied into shared memory with cp.async (a block's first
//                tile of the next projection is started before the phase in
//                between and the grid sync, so it streams in while they run);
//                8 warps split the slice's rows, each lane owns 4 columns, the
//                block reduces the warps in a fixed order and writes one
//                partial sum per slice;
//   residual     one block per (row, 256-column segment): x += Σ slices in a
//                fixed order, plus the segment's mean and M2, which the next
//                LN merges (Chan) — so every sum has one order and a step is
//                bitwise reproducible.
//
// Numerics of the JAX kernels: weights dequantized as bf16(w) · bf16(s)
// rounded to bf16; dot inputs rounded to bf16 with f32 accumulation; LN in f32
// (eps 1e-5); residual in f32; y in bf16.
//
// Every choice that splits a sum (k-slices per projection) is made from the
// device and the width alone, never from the number of rows B, so a row's
// result does not depend on how many rows share the launch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TN = 128;       // output columns of a projection tile, 4 per lane
constexpr int MAXB = 8;       // rows (CFG batch) the kernels take
constexpr int DH = 64;        // head dim
constexpr int CPL = 14;       // weight chunks per layer
constexpr int SEG = THREADS;  // residual columns per stats segment
constexpr int KT_MAX = 512;   // rows of a projection k-slice
constexpr int W_STAGE = 48 * 1024;  // bytes of the staged weight tile
constexpr int MAX_SPLIT = 8;        // blocks sharing one (row, head) of self-attention
constexpr int BLOCKS_PER_SM = 2;    // the launch bounds' residency

// shared memory, in floats
constexpr int SM_A = 0;                          // [MAXB][KT_MAX] projection inputs
constexpr int SM_RED = SM_A + MAXB * KT_MAX;     // [WARPS][MAXB][TN] warp partials
constexpr int SM_MISC = SM_RED + WARPS * MAXB * TN;
constexpr int SM_STATS = SM_MISC;                // [MAXB][2] LN mean, rstd
constexpr int SM_BUF = SM_STATS + 2 * MAXB;      // [WARPS] block reductions
constexpr int H_MAX = 8192;
constexpr int SM_SEGS = SM_BUF + WARPS;          // [MAXB][H_MAX / SEG][2] segment stats
constexpr int SM_FLOATS = SM_SEGS + MAXB * (H_MAX / SEG) * 2;
// then the staged weight tile: W_STAGE bytes
constexpr size_t SMEM_BYTES = sizeof(float) * SM_FLOATS + W_STAGE;

// where a projection's input rows come from: LN of the residual, the merged
// attention splits, GELU (exact, or its tanh form) of the partial sums of the
// previous projection, or those partial sums as they are
enum ASrc { A_LN = 0, A_ATT = 1, A_GELU = 2, A_SUM = 3, A_GELU_TANH = 4 };

struct Args {
  const void* w;        // (L·14, H, H) int8 or bf16
  const bf16* s;        // (L·14, H)
  const bf16* ln;       // (L, 8, H), or null: LN without scale and bias
  const bf16* x;        // (B, H)
  const bf16* ck;       // (L, B, S, H)
  const bf16* cv;
  void* kc;             // (L, B, W, H) bf16 or e4m3 bytes
  void* vc;
  const int* cond_len;  // (B,) or null
  bf16* y;              // (B, H)
  float* xs;            // (B, H) residual stream
  float* seg;           // (B, H / SEG, 2) segment mean, M2
  float* pa;            // partials of q/k/v, cross q, up
  float* pb;            // partials of o, cross o, down
  float* att;           // (splits, B, H) unnormalised attention outputs
  float* att_ml;        // (splits, B, heads, 2) their running max and sum
  int L, B, H, S, W, offset, n_heads;
  int n_split;          // blocks per (row, head) of self-attention
  int ks_qkv, ks_o, ks_up, ks_dn;  // k-slices per input row chunk
};

struct Proj {
  int chunk0;    // first weight chunk of the phase within the layer
  int n_out;     // output column chunks: N = n_out · H
  int k_chunks;  // input row chunks: K = k_chunks · H
  int ks;        // k-slices per row chunk
};

__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum (or max) over the block, the same value in every thread.
template <bool IS_MAX>
__device__ float block_reduce(float v, float* buf) {
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // buf free from its last use
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = buf[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) t = IS_MAX ? fmaxf(t, buf[i]) : t + buf[i];
  return t;
}

// 4 int8 weights (one 32-bit word) → bf16(w · s) as f32. int8 → f32 by the
// 2^23 trick: 0x4B0000XX with XX = w + 128 is 2^23 + 128 + w.
__device__ __forceinline__ void dequant(uint32_t raw, const float (&sc)[4], float (&wf)[4]) {
  const uint32_t u = raw ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) - 8388736.f;
    wf[j] = bfr(v * sc[j]);
  }
}

// 4 bf16 weights (64 bits) → bf16(w · s) as f32.
__device__ __forceinline__ void dequant(uint2 raw, const float (&sc)[4], float (&wf)[4]) {
  const uint32_t r[2] = {raw.x, raw.y};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t bits = (j & 1) ? (r[j >> 1] & 0xFFFF0000u) : (r[j >> 1] << 16);
    wf[j] = bfr(__uint_as_float(bits) * sc[j]);
  }
}

template <bool I8>
struct WeightWord;
template <>
struct WeightWord<true> {
  using T = uint32_t;
  using E = int8_t;
};
template <>
struct WeightWord<false> {
  using T = uint2;
  using E = bf16;
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ unsigned char* stage_buf(float* smem) {
  return reinterpret_cast<unsigned char*>(smem + SM_FLOATS);
}

// Start copying the weight rows of one projection tile into shared memory
// (cp.async, 16 bytes a thread at a time); the projection waits for them.
template <bool I8>
__device__ void stage_tile(const Args& a, int layer, Proj pr, int tile, float* smem) {
  using Elem = typename WeightWord<I8>::E;
  constexpr int RB = TN * int(sizeof(Elem));  // bytes of a tile row
  constexpr int CPR = RB / 16;
  const int H = a.H, NT = pr.n_out * H / TN, KT = H / pr.ks;
  const int n0 = (tile % NT) * TN, k0 = (tile / NT) * KT;
  const int chunk = layer * CPL + pr.chunk0 + k0 / H + n0 / H;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(
      static_cast<const Elem*>(a.w) + (size_t(chunk) * H + k0 % H) * H + n0 % H);
  const size_t stride = size_t(H) * sizeof(Elem);
  unsigned char* dst = stage_buf(smem);
  for (int i = threadIdx.x; i < KT * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    cp_async16(dst + r * RB + c * 16, src + r * stride + c * 16);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Stage this block's first tile of the next projection phase, so its
// weights stream in while the grid finishes the current phase and syncs.
template <bool I8>
__device__ void stage_next(const Args& a, int layer, Proj pr, float* smem) {
  if (layer < a.L && int(blockIdx.x) < pr.n_out * a.H / TN * pr.k_chunks * pr.ks)
    stage_tile<I8>(a, layer, pr, blockIdx.x, smem);
}

// Merge the previous residual phase's segment statistics into each row's
// LN mean and rstd (equal-size groups: mean of means, M2 = Σ M2_i + n Σ δ_i²).
__device__ void ln_stats(const Args& a, float* smem) {
  float* st = smem + SM_STATS;
  float* segs = smem + SM_SEGS;
  const int nseg = a.H / SEG;
  for (int i = threadIdx.x; i < a.B * nseg * 2; i += THREADS) segs[i] = __ldcg(a.seg + i);
  __syncthreads();
  if (threadIdx.x < a.B) {
    const float* sg = segs + threadIdx.x * nseg * 2;
    float mean = 0.f;
    for (int i = 0; i < nseg; ++i) mean += sg[2 * i];
    mean /= nseg;
    float m2 = 0.f;
    for (int i = 0; i < nseg; ++i) {
      const float dl = sg[2 * i] - mean;
      m2 += sg[2 * i + 1] + float(SEG) * dl * dl;
    }
    st[2 * threadIdx.x] = mean;
    st[2 * threadIdx.x + 1] = rsqrtf(m2 / a.H + 1e-5f);
  }
  __syncthreads();
}

// A projection's output as it is: the default epilogue.
struct KeepPartial {
  __device__ float operator()(int, int, int, float v) const { return v; }
};

// One projection phase: out[slice][b][n] = epi(slice, b, n, Σ_{k in slice} A[b][k] · W[k][n]).
// ln_slot: the row pair (scale, bias) of a.ln that an A_LN input takes, or
// -1 for none. a_slices: the attention splits (A_ATT) or the partial-sum
// slices of the input (A_GELU, A_GELU_TANH, A_SUM), whose rows are src_n
// floats apart.
template <bool I8, int MB, class Epi = KeepPartial>
__device__ void projection(const Args& a, int layer, Proj pr, ASrc src, int ln_slot, int a_slices,
                           int src_n, float* out, float* smem, Epi epi = Epi()) {
  using Word = typename WeightWord<I8>::T;
  const int H = a.H, B = a.B;
  const int N = pr.n_out * H;
  const int NT = N / TN;
  const int KT = H / pr.ks;
  const int tiles = NT * pr.k_chunks * pr.ks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* a_s = smem + SM_A;
  float* red = smem + SM_RED;
  const float* st = smem + SM_STATS;
  if (src == A_LN) ln_stats(a, smem);
  const bf16* lnp = a.ln && ln_slot >= 0 ? a.ln + (size_t(layer) * 8 + ln_slot) * H : nullptr;
  const Word* wsm = reinterpret_cast<const Word*>(stage_buf(smem)) + lane;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int nt = tile % NT, slice = tile / NT;
    const int n0 = nt * TN, k0 = slice * KT;
    const int chunk = layer * CPL + pr.chunk0 + k0 / H + n0 / H;
    const int col0 = n0 % H;
    if (tile != int(blockIdx.x)) stage_tile<I8>(a, layer, pr, tile, smem);  // not staged ahead

    for (int i = tid; i < B * KT; i += THREADS) {
      const int b = i / KT, k = k0 + i % KT;
      float v;
      if (src == A_LN) {
        v = (__ldcg(a.xs + size_t(b) * H + k) - st[2 * b]) * st[2 * b + 1];
        if (lnp) v = v * __bfloat162float(lnp[k]) + __bfloat162float(lnp[H + k]);
        v = bfr(v);
      } else if (src == A_ATT) {
        // merge the attention splits of head k / DH: Σ e_s·acc_s / Σ e_s·l_s
        const float* ml = a.att_ml + (size_t(b) * a.n_heads + k / DH) * 2;
        const size_t ml_stride = size_t(B) * a.n_heads * 2;
        float mx = -INFINITY;
        for (int s = 0; s < a_slices; ++s) mx = fmaxf(mx, __ldcg(ml + s * ml_stride));
        float num = 0.f, den = 0.f;
        for (int s = 0; s < a_slices; ++s) {
          const float e = expf(__ldcg(ml + s * ml_stride) - mx);
          num += e * __ldcg(a.att + (size_t(s) * B + b) * H + k);
          den += e * __ldcg(ml + s * ml_stride + 1);
        }
        v = bfr(num / den);
      } else {
        float h = 0.f;
        for (int s = 0; s < a_slices; ++s) h += __ldcg(a.pa + (size_t(s) * B + b) * src_n + k);
        if (src == A_GELU)
          h = 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
        else if (src == A_GELU_TANH)
          h = 0.5f * h * (1.f + tanhf(0.7978845608f * (h + 0.044715f * (h * h * h))));
        v = bfr(h);
      }
      a_s[b * KT + (k - k0)] = v;
    }
    float sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = __bfloat162float(a.s[size_t(chunk) * H + col0 + lane * 4 + j]);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();

    float acc[MB][4];
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;
#pragma unroll 4
    for (int r = warp; r < KT; r += WARPS) {
      float wf[4];
      dequant(wsm[r * (TN / 4)], sc, wf);
#pragma unroll
      for (int b = 0; b < MB; ++b) {
        if (b < B) {
          const float av = a_s[b * KT + r];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[b][j] = fmaf(av, wf[j], acc[b][j]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < MB; ++b)
      if (b < B)
        *reinterpret_cast<float4*>(red + (warp * MAXB + b) * TN + lane * 4) =
            make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
    __syncthreads();
    for (int i = tid; i < B * TN; i += THREADS) {
      const int b = i / TN, c = i % TN;
      float v = red[b * TN + c];
#pragma unroll
      for (int wp = 1; wp < WARPS; ++wp) v += red[(wp * MAXB + b) * TN + c];
      out[(size_t(slice) * B + b) * N + n0 + c] = epi(slice, b, n0 + c, v);
    }
    __syncthreads();
  }
}

// A residual update as it is: the default hook.
struct KeepResidual {
  __device__ float operator()(int, int, float v) const { return v; }
};

// x += Σ partial slices (or x = input), passed through hook(row, column, x),
// then each 256-column segment's mean and M2 for the next LN; the last layer
// also writes y.
template <class Hook = KeepResidual>
__device__ void residual(const Args& a, int slices, bool init, bool last, float* smem, Hook hook = Hook()) {
  const int H = a.H, B = a.B, nseg = H / SEG;
  float* buf = smem + SM_BUF;
  for (int item = blockIdx.x; item < B * nseg; item += gridDim.x) {
    const int b = item / nseg, sg = item % nseg;
    const size_t k = size_t(b) * H + size_t(sg) * SEG + threadIdx.x;
    float v;
    if (init) {
      v = __bfloat162float(a.x[k]);
    } else {
      v = __ldcg(a.xs + k);
      for (int s = 0; s < slices; ++s) v += __ldcg(a.pb + size_t(s) * B * H + k);
      v = hook(b, sg * SEG + threadIdx.x, v);
    }
    a.xs[k] = v;
    if (last) a.y[k] = __float2bfloat16_rn(v);
    const float mean = block_reduce<false>(v, buf) / SEG;
    const float dl = v - mean;
    const float m2 = block_reduce<false>(dl * dl, buf);
    if (threadIdx.x == 0) {
      a.seg[2 * item] = mean;
      a.seg[2 * item + 1] = m2;
    }
  }
}

// ------------------------------------------------------------ host side

struct Plan {
  int grid = 0;
  int per_sm = 0;   // resident blocks an SM the launch uses
  int nominal = 0;  // BLOCKS_PER_SM · SMs: the grid every split is sized for
  int ks_qkv = 0, ks_o = 0, ks_up = 0, ks_dn = 0;
  size_t xs = 0, seg = 0, pa = 0, pb = 0, att = 0, att_ml = 0, total = 0;  // in floats
};

// k-slices per row chunk: the most whose tiles still fit one wave of the grid
// (the fewest when none does), with slices of at most kt_max rows.
inline int pick_ks(int H, int nt, int k_chunks, int grid, int kt_max) {
  int best = 0, least = 0;
  for (int s = 1; s <= H; ++s) {
    if (H % s || H / s > kt_max) continue;
    if (!least) least = s;
    if (nt * k_chunks * s <= grid) best = s;
  }
  return best ? best : least;
}

inline size_t round4(size_t n) { return (n + 3) & ~size_t(3); }

inline bool shape_ok(int B, int H) {
  return B >= 1 && B <= MAXB && H >= SEG && H <= H_MAX && H % SEG == 0 && H % TN == 0;
}

// The grid (co-resident blocks from the occupancy query at `smem` bytes of
// dynamic shared memory a block), the k-slices and the scratch layout of
// `kern` for B rows of width H. The k-slices follow the nominal grid, not the
// occupancy of this instantiation, so every instantiation splits its sums alike.
inline cudaError_t make_plan(const void* kern, bool i8, int B, int H, Plan& p, size_t smem = SMEM_BYTES) {
  int dev = 0, n_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop || n_sm <= 0) return cudaErrorNotSupported;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  p.per_sm = std::min(per_sm, BLOCKS_PER_SM);
  p.grid = p.per_sm * n_sm;
  p.nominal = BLOCKS_PER_SM * n_sm;
  const int nt = H / TN;
  const int kt_max = std::min(KT_MAX, W_STAGE / (TN * (i8 ? 1 : 2)));
  p.ks_qkv = pick_ks(H, 3 * nt, 1, p.nominal, kt_max);
  p.ks_o = pick_ks(H, nt, 1, p.nominal, kt_max);
  p.ks_up = pick_ks(H, 4 * nt, 1, p.nominal, kt_max);
  p.ks_dn = pick_ks(H, nt, 4, p.nominal, kt_max);
  const size_t bh = size_t(B) * H;
  const size_t pa = std::max(std::max(size_t(p.ks_qkv) * 3 * bh, size_t(p.ks_o) * bh), size_t(p.ks_up) * 4 * bh);
  const size_t pb = std::max(size_t(p.ks_o) * bh, size_t(4 * p.ks_dn) * bh);
  p.xs = 0;
  p.seg = round4(bh);
  p.pa = p.seg + round4(size_t(B) * (H / SEG) * 2);
  p.pb = p.pa + round4(pa);
  p.att = p.pb + round4(pb);
  p.att_ml = p.att + round4(size_t(MAX_SPLIT) * bh);
  p.total = p.att_ml + round4(size_t(MAX_SPLIT) * B * (H / DH) * 2);
  return cudaSuccess;
}

// Fill the scratch pointers and the plan's splits into `a`.
inline void bind_plan(const Plan& p, float* scratch, Args& a) {
  a.xs = scratch + p.xs;
  a.seg = scratch + p.seg;
  a.pa = scratch + p.pa;
  a.pb = scratch + p.pb;
  a.att = scratch + p.att;
  a.att_ml = scratch + p.att_ml;
  a.ks_qkv = p.ks_qkv;
  a.ks_o = p.ks_o;
  a.ks_up = p.ks_up;
  a.ks_dn = p.ks_dn;
}

}  // namespace
