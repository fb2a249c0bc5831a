// The fused MusicGen decode step: all decoder layers of one AR step in one
// persistent cooperative launch, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_kernel` (v1, pallas_call at
// flux_generator_tpu/ops/pallas/decode_layer.py:1180), `_kernel2` (v2, :1083)
// and `_kernel3` (v3, :984). The three share one contract and differ only in
// how the KV-cache window reaches the TPU's 16 MB VMEM (manual double-buffered
// DMA, at most two blocked chunks, or streamed grid phases). This kernel reads
// the live rows of a window of any length straight from device memory.
//
// Per layer, in the order of `_kernel2`: LN1 → q, k_new, v_new projections →
// self-attention over cache rows < offset, seeded with the current token →
// o-projection + residual; LN_cross → q (the q third of the cross qkv) →
// cross-attention over the text K/V masked at cond_len[b] (NEG = -1e30, dead V
// rows zeroed) → o-projection + residual; LN2 → up 4h → exact GELU → down →
// residual. The new K/V rows are written into the caches at `offset` here,
// where the JAX wrapper inserts them after its call.
//
// Numerics of the JAX kernel: weights dequantized as bf16(w) · bf16(s) rounded
// to bf16; dot inputs rounded to bf16 with f32 accumulation; LN in f32 (eps
// 1e-5); q scaled by 1/8 and rounded to bf16; f32 logits and running-max
// softmax divided at the end, P rounded to bf16 for P·V; residual in f32; y in
// bf16.
//
// Bound: at MusicGen-medium one step streams 48 × 14 chunks of 1536² weights
// (1.59 GB in int8) at M = B ≤ 8 rows, so the step is a chain of weight-bound
// GEMVs whose every phase needs the whole output of the one before it. The
// design is the TPU kernel's, one launch per step instead of ~480: a grid of
// co-resident blocks (sized from the occupancy query; the launch fails rather
// than run blocks that cannot all be resident) walks 11 phases per layer with
// a grid.sync() between them:
//   projection   tiles of 128 output columns × a k-slice, whose weight rows
//                are copied into shared memory with cp.async (a block's first
//                tile of the next projection is started before the phase in
//                between and the grid sync, so it streams in while they run);
//                8 warps split the slice's rows, each lane owns 4 columns, the
//                block reduces the warps in a fixed order and writes one
//                partial sum per slice;
//   attention    self-attention splits the cache rows of each (row, head)
//                over up to 8 blocks (at least 64 rows each), cross-attention
//                takes one block per (row, head); a block scores one row per
//                thread with an online softmax over 256-row chunks and leaves
//                its unnormalised output with its running max and sum, which
//                the o-projection merges while it loads its input;
//   residual     one block per (row, 256-column segment): x += Σ slices in a
//                fixed order, plus the segment's mean and M2, which the next
//                LN merges (Chan) — so every sum has one order and a step is
//                bitwise reproducible.
// Batches of at most 2 rows take an instantiation with 2 accumulator rows.
// Not yet used: tensor cores, TMA, fewer phases; the f8 KV cache.

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
constexpr int MAXB = 8;       // rows (CFG batch) the kernel takes
constexpr int DH = 64;        // head dim
constexpr int CPL = 14;       // weight chunks per layer
constexpr int SEG = THREADS;  // residual columns per stats segment
constexpr int KT_MAX = 512;   // rows of a projection k-slice
constexpr int W_STAGE = 48 * 1024;  // bytes of the staged weight tile
constexpr int MAX_SPLIT = 8;        // blocks sharing one (row, head) of self-attention
constexpr int ROWS_PER_SPLIT = 64;  // fewest cache rows worth a block of their own
constexpr int CH = THREADS;   // attention rows per chunk
constexpr float NEG = -1e30f;

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

enum ASrc { A_LN = 0, A_ATT = 1, A_GELU = 2 };

struct Args {
  const void* w;        // (L·14, H, H) int8 or bf16
  const bf16* s;        // (L·14, H)
  const bf16* ln;       // (L, 8, H)
  const bf16* x;        // (B, H)
  const bf16* ck;       // (L, B, S, H)
  const bf16* cv;
  bf16* kc;             // (L, B, W, H)
  bf16* vc;
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

// One projection phase: out[slice][b][n] = Σ_{k in slice} A[b][k] · W[k][n].
template <bool I8, int MB>
__device__ void projection(const Args& a, int layer, Proj pr, ASrc src, int ln_slot, int a_slices,
                           float* out, float* smem) {
  // a_slices: partial-sum slices of the GELU input, or attention splits
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
  const bf16* lnp = a.ln + (size_t(layer) * 8 + ln_slot) * H;
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
        v = bfr(v * __bfloat162float(lnp[k]) + __bfloat162float(lnp[H + k]));
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
        for (int s = 0; s < a_slices; ++s) h += __ldcg(a.pa + (size_t(s) * B + b) * (4 * H) + k);
        v = bfr(0.5f * h * (1.f + erff(h * 0.70710678118654752f)));
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
      out[(size_t(slice) * B + b) * N + n0 + c] = v;
    }
    __syncthreads();
  }
}

// x += Σ partial slices (or x = input), then each 256-column segment's mean
// and M2 for the next LN; the last layer also writes y.
__device__ void residual(const Args& a, int slices, bool init, bool last, float* smem) {
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

// Self-attention over the cache (seeded with the current token, whose k/v
// rows split 0 also writes at `offset`), its rows split over n_split blocks
// per (row, head), or cross-attention over the text K/V masked at cond_len,
// one block per (row, head). Each block leaves its unnormalised output and
// running max/sum; the next projection merges the splits.
__device__ void attention(const Args& a, int layer, bool self_attn, float* smem) {
  const int H = a.H, B = a.B, tid = threadIdx.x;
  constexpr int GROUPS = THREADS / 32;  // P·V: 8 row groups of 32 lanes, 2 dims a lane
  float* q_s = smem + SM_A;  // [DH]
  float* kn_s = q_s + DH;    // [DH]
  float* vn_s = kn_s + DH;   // [DH]
  float* p_s = vn_s + DH;    // [CH]
  float* pv_s = p_s + CH;    // [GROUPS][DH]
  float* acc_s = pv_s + GROUPS * DH;
  float* buf = smem + SM_BUF;
  const int n_split = self_attn ? a.n_split : 1;
  for (int item = blockIdx.x; item < B * a.n_heads * n_split; item += gridDim.x) {
    const int split = item % n_split, bh = item / n_split;
    const int b = bh / a.n_heads, head = bh % a.n_heads, c0 = head * DH;
    const int slices = self_attn ? a.ks_qkv : a.ks_o;
    const int N = self_attn ? 3 * H : H;
    const bool seeded = self_attn && split == 0;
    if (tid < DH) {
      float q = 0.f, k = 0.f, v = 0.f;
      for (int s = 0; s < slices; ++s) {
        const float* p = a.pa + (size_t(s) * B + b) * N + c0 + tid;
        q += __ldcg(p);
        if (seeded) {
          k += __ldcg(p + H);
          v += __ldcg(p + 2 * H);
        }
      }
      q_s[tid] = bfr(q * 0.125f);
      if (seeded) {
        const bf16 kb = __float2bfloat16_rn(k), vb = __float2bfloat16_rn(v);
        kn_s[tid] = __bfloat162float(kb);
        vn_s[tid] = __bfloat162float(vb);
        const size_t row = ((size_t(layer) * B + b) * a.W + a.offset) * H + c0 + tid;
        a.kc[row] = kb;
        a.vc[row] = vb;
      }
    }
    __syncthreads();
    float m, l;
    if (seeded) {
      m = block_reduce<false>(tid < DH ? q_s[tid] * kn_s[tid] : 0.f, buf);
      l = 1.f;
      if (tid < DH) acc_s[tid] = vn_s[tid];
    } else {
      m = -INFINITY;
      l = 0.f;
      if (tid < DH) acc_s[tid] = 0.f;
    }
    int r_begin, r_end, nlive;
    const bf16 *K, *V;
    if (self_attn) {
      const int per = (a.offset + n_split - 1) / n_split;
      r_begin = min(split * per, a.offset);
      r_end = min(r_begin + per, a.offset);
      nlive = a.offset;
      K = a.kc + (size_t(layer) * B + b) * a.W * H + c0;
      V = a.vc + (size_t(layer) * B + b) * a.W * H + c0;
    } else {
      r_begin = 0;
      r_end = a.S;
      nlive = a.cond_len ? min(max(a.cond_len[b], 0), a.S) : a.S;
      K = a.ck + (size_t(layer) * B + b) * a.S * H + c0;
      V = a.cv + (size_t(layer) * B + b) * a.S * H + c0;
    }
    for (int r0 = r_begin; r0 < r_end; r0 += CH) {
      const int r = r0 + tid;
      float sc = -INFINITY;
      if (r < r_end) {
        if (r < nlive) {
          const uint4* kr = reinterpret_cast<const uint4*>(K + size_t(r) * H);
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < DH / 8; ++i) {
            const uint4 u = kr[i];
            const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              dot = fmaf(q_s[8 * i + 2 * j], __uint_as_float(wd[j] << 16), dot);
              dot = fmaf(q_s[8 * i + 2 * j + 1], __uint_as_float(wd[j] & 0xFFFF0000u), dot);
            }
          }
          sc = dot;
        } else {
          sc = NEG;
        }
      }
      const float m_new = fmaxf(m, block_reduce<true>(sc, buf));
      const float rs = expf(m - m_new);
      const float p = r < r_end ? expf(sc - m_new) : 0.f;
      p_s[tid] = bfr(p);
      l = l * rs + block_reduce<false>(p, buf);  // its barriers publish p_s
      // P·V: lane owns dims (2·lane, 2·lane+1), group g rows g, g+8, …
      const int lane = tid & 31, grp = tid >> 5;
      const int nr = min(CH, r_end - r0);
      float part0 = 0.f, part1 = 0.f;
#pragma unroll 8
      for (int rr = grp; rr < nr; rr += GROUPS) {
        if (r0 + rr < nlive) {
          const uint32_t v2 = *reinterpret_cast<const uint32_t*>(V + size_t(r0 + rr) * H + 2 * lane);
          part0 = fmaf(p_s[rr], __uint_as_float(v2 << 16), part0);
          part1 = fmaf(p_s[rr], __uint_as_float(v2 & 0xFFFF0000u), part1);
        }
      }
      pv_s[grp * DH + 2 * lane] = part0;
      pv_s[grp * DH + 2 * lane + 1] = part1;
      __syncthreads();
      if (tid < DH) {
        float sum = pv_s[tid];
#pragma unroll
        for (int g = 1; g < GROUPS; ++g) sum += pv_s[g * DH + tid];
        acc_s[tid] = acc_s[tid] * rs + sum;
      }
      m = m_new;
      __syncthreads();
    }
    if (tid < DH) a.att[(size_t(split) * B + b) * H + c0 + tid] = acc_s[tid];
    if (tid == 0) {
      float* ml = a.att_ml + ((size_t(split) * B + b) * a.n_heads + head) * 2;
      ml[0] = m;
      ml[1] = l;
    }
    __syncthreads();
  }
}

template <bool I8, int MB>
__global__ void __launch_bounds__(THREADS, 2) decode_step_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const Proj qkv{0, 3, 1, a.ks_qkv}, o{3, 1, 1, a.ks_o}, cq{4, 1, 1, a.ks_o}, co{5, 1, 1, a.ks_o};
  const Proj up{6, 4, 1, a.ks_up}, down{10, 1, 4, a.ks_dn};
  stage_next<I8>(a, 0, qkv, smem);
  residual(a, 0, true, false, smem);
  grid.sync();
  for (int l = 0; l < a.L; ++l) {
    projection<I8, MB>(a, l, qkv, A_LN, 0, 0, a.pa, smem);
    stage_next<I8>(a, l, o, smem);
    grid.sync();
    attention(a, l, true, smem);
    grid.sync();
    projection<I8, MB>(a, l, o, A_ATT, 0, a.n_split, a.pb, smem);
    stage_next<I8>(a, l, cq, smem);
    grid.sync();
    residual(a, a.ks_o, false, false, smem);
    grid.sync();
    projection<I8, MB>(a, l, cq, A_LN, 2, 0, a.pa, smem);
    stage_next<I8>(a, l, co, smem);
    grid.sync();
    attention(a, l, false, smem);
    grid.sync();
    projection<I8, MB>(a, l, co, A_ATT, 0, 1, a.pb, smem);
    stage_next<I8>(a, l, up, smem);
    grid.sync();
    residual(a, a.ks_o, false, false, smem);
    grid.sync();
    projection<I8, MB>(a, l, up, A_LN, 4, 0, a.pa, smem);
    stage_next<I8>(a, l, down, smem);
    grid.sync();
    projection<I8, MB>(a, l, down, A_GELU, 0, a.ks_up, a.pb, smem);
    stage_next<I8>(a, l + 1, qkv, smem);
    grid.sync();
    residual(a, 4 * a.ks_dn, false, l + 1 == a.L, smem);
    if (l + 1 < a.L) grid.sync();
  }
}

// ------------------------------------------------------------ host side

struct Plan {
  int grid = 0;
  int ks_qkv = 0, ks_o = 0, ks_up = 0, ks_dn = 0;
  size_t xs = 0, seg = 0, pa = 0, pb = 0, att = 0, att_ml = 0, total = 0;  // in floats
};

// k-slices per row chunk: the most whose tiles still fit one wave of the grid
// (the fewest when none does), with slices of at most kt_max rows.
int pick_ks(int H, int nt, int k_chunks, int grid, int kt_max) {
  int best = 0, least = 0;
  for (int s = 1; s <= H; ++s) {
    if (H % s || H / s > kt_max) continue;
    if (!least) least = s;
    if (nt * k_chunks * s <= grid) best = s;
  }
  return best ? best : least;
}

size_t round4(size_t n) { return (n + 3) & ~size_t(3); }

template <bool I8, int MB>
cudaError_t make_plan(int B, int H, Plan& p) {
  int dev = 0, n_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop || n_sm <= 0) return cudaErrorNotSupported;
  auto kern = decode_step_kernel<I8, MB>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  p.grid = std::min(per_sm, 2) * n_sm;
  const int nt = H / TN;
  const int kt_max = std::min(KT_MAX, W_STAGE / (TN * (I8 ? 1 : 2)));
  p.ks_qkv = pick_ks(H, 3 * nt, 1, p.grid, kt_max);
  p.ks_o = pick_ks(H, nt, 1, p.grid, kt_max);
  p.ks_up = pick_ks(H, 4 * nt, 1, p.grid, kt_max);
  p.ks_dn = pick_ks(H, nt, 4, p.grid, kt_max);
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

bool shape_ok(int B, int H) {
  return B >= 1 && B <= MAXB && H >= SEG && H <= H_MAX && H % SEG == 0 && H % TN == 0;
}

// the instantiation for B rows and the weight type: acc for 2 rows when B ≤ 2
cudaError_t plan_for(int B, int H, bool i8, Plan& p, const void** kern) {
  if (B <= 2) {
    *kern = i8 ? reinterpret_cast<const void*>(decode_step_kernel<true, 2>)
               : reinterpret_cast<const void*>(decode_step_kernel<false, 2>);
    return i8 ? make_plan<true, 2>(B, H, p) : make_plan<false, 2>(B, H, p);
  }
  *kern = i8 ? reinterpret_cast<const void*>(decode_step_kernel<true, MAXB>)
             : reinterpret_cast<const void*>(decode_step_kernel<false, MAXB>);
  return i8 ? make_plan<true, MAXB>(B, H, p) : make_plan<false, MAXB>(B, H, p);
}

}  // namespace

// f32 scratch the kernel needs for B rows of width H (0 when the shape is not taken).
extern "C" int fgt_decode_step_scratch_floats(int B, int H, int w_is_int8) {
  Plan p;
  const void* kern = nullptr;
  if (!shape_ok(B, H)) return 0;
  return plan_for(B, H, w_is_int8 != 0, p, &kern) == cudaSuccess ? static_cast<int>(p.total) : 0;
}

// One AR step through all L layers; see the header comment. cond_len may be
// null (every text row live). Returns a cudaError_t.
extern "C" int fgt_decode_step(const void* w, const void* s, const void* ln, const void* x, const void* ck,
                               const void* cv, void* kc, void* vc, const void* cond_len, void* y, void* scratch,
                               int L, int B, int H, int S, int W, int offset, int n_heads, int w_is_int8,
                               void* stream) {
  if (!shape_ok(B, H) || L <= 0 || S <= 0 || n_heads * DH != H || offset < 0 || offset >= W)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const void* kern = nullptr;
  cudaError_t err = plan_for(B, H, w_is_int8 != 0, p, &kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* sc = static_cast<float*>(scratch);
  Args a;
  a.w = w;
  a.s = static_cast<const bf16*>(s);
  a.ln = static_cast<const bf16*>(ln);
  a.x = static_cast<const bf16*>(x);
  a.ck = static_cast<const bf16*>(ck);
  a.cv = static_cast<const bf16*>(cv);
  a.kc = static_cast<bf16*>(kc);
  a.vc = static_cast<bf16*>(vc);
  a.cond_len = static_cast<const int*>(cond_len);
  a.y = static_cast<bf16*>(y);
  a.xs = sc + p.xs;
  a.seg = sc + p.seg;
  a.pa = sc + p.pa;
  a.pb = sc + p.pb;
  a.att = sc + p.att;
  a.att_ml = sc + p.att_ml;
  // split the cache rows over the blocks that one wave of (row, head) items
  // leaves idle, at least ROWS_PER_SPLIT rows a block
  a.n_split = std::max(1, std::min({MAX_SPLIT, p.grid / (B * n_heads),
                                    (offset + ROWS_PER_SPLIT - 1) / ROWS_PER_SPLIT}));
  a.L = L;
  a.B = B;
  a.H = H;
  a.S = S;
  a.W = W;
  a.offset = offset;
  a.n_heads = n_heads;
  a.ks_qkv = p.ks_qkv;
  a.ks_o = p.ks_o;
  a.ks_up = p.ks_up;
  a.ks_dn = p.ks_dn;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kern, dim3(p.grid), dim3(THREADS), args, SMEM_BYTES,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
