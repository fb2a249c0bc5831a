// The fused MusicGen decode step (kernel D): all decoder layers of one AR
// step in one persistent cooperative launch, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_kernel` (v1, pallas_call at
// flux_generator_tpu/ops/pallas/decode_layer.py:1180), `_kernel2` (v2, :1083)
// and `_kernel3` (v3, :984), and their e4m3 cache tier. The three share one
// contract and differ only in how the KV-cache window reaches the TPU's 16 MB
// VMEM (manual double-buffered DMA, at most two blocked chunks, or streamed
// grid phases). This kernel reads the live rows of a window of any length
// straight from device memory.
//
// Per layer, in the order of `_kernel2`: LN1 → q, k_new, v_new projections →
// self-attention over cache rows < offset, seeded with the current token →
// o-projection + residual; LN_cross → q (the q third of the cross qkv) →
// cross-attention over the text K/V masked at cond_len[b] (NEG = -1e30, dead V
// rows zeroed) → o-projection + residual; LN2 → up 4h → exact GELU → down →
// residual. The new K/V rows are written into the caches at `offset` here,
// where the JAX wrapper inserts them after its call.
//
// The cache holds bf16, or e4m3 bytes (the JAX package's FGT_MG_KV=f8:
// float8_e4m3fn in int8 buffers, decode_layer.py:80-117). e4m3 rows widen
// exactly in registers (cuda_fp8.h's cvt, e4m3 → f16 → f32) and are summed in
// the bf16 tier's order, so the bf16 tier on widened caches gives the same
// bits. The current token is seeded with its bf16 k/v rows, as in JAX, and
// the rows are then stored as e4m3 with saturation to ±448 and rounding to
// nearest even — the bytes of JAX's `store_kv_rows` (decode_layer.py:103-117).
//
// Numerics of the JAX kernels: weights dequantized as bf16(w) · bf16(s)
// rounded to bf16 (one rounding of the exact product); dot inputs rounded to
// bf16 with f32 accumulation; LN in f32 (eps 1e-5); q scaled by 1/8 and
// rounded to bf16; f32 logits and a running-max softmax divided at the end, P
// rounded to bf16 for P·V; the residual in f32; y in bf16.
//
// Bound: bytes. At MusicGen-medium a step streams 48 × 14 weight chunks of
// 1536² (1.59 GB in int8) and the live cache rows (2 · L · B · offset · H
// elements: 4.5 GB in bf16 at B 8, offset 1900), through a chain of phases
// each of which needs the whole output of the one before it.
//
// Design. A grid of one 256-thread block an SM (the launch fails rather than
// run blocks that cannot all be resident) walks the layers in 7 phases a layer
// with a grid sync after each (7 · L a step; 11 · L in D's first design):
//   qkv | self-attention | o + residual | cross q + cross-attention |
//   cross o + residual | up + GELU | down + residual.
// - Projections on tensor cores (mma.sync m16n8k16 bf16, f32 sums): the ≤ 8
//   rows are the narrow n side, zero-padded to 8; the weight columns the wide
//   m side. A weight tile is 256 rows × one 128-byte row (128 int8 or 64 bf16
//   columns, 32 KB). A thread reads 16 bytes of each of its four k rows and
//   dequantizes pairs of rows (2t, 2t+1) and (2t+8, 2t+9) of one column into
//   the bf16x2 registers of its A fragment: int8 widens exactly (the 2^23
//   trick) and is scaled by the column's bf16 scale with one bf16x2 multiply.
//   An item of a phase is one column tile × kt consecutive tiles of K, kt the
//   fewest that fit the phase in one wave of the grid; its eight warps split
//   each tile's rows, sum the tiles in registers, add their sums in warp order
//   and write one partial. Rows have no guards in the inner loop: padding rows
//   are zeros that nothing stores. An item's inputs (its rows of the
//   activations, LN parameters and statistics, column scales) come by 16-byte
//   cp.async copies all in flight at once.
// - A weight ring: 5 stages of 32 KB, filled by TMA (128-byte swizzle, which
//   makes the fragment reads conflict-free). The weight addresses do not
//   depend on data, so each block walks its own tiles of all phases of all
//   layers in order and, as it frees a stage, refills it with the tile 5
//   ahead, which may belong to a later phase: the stream stays in flight
//   across the grid syncs, and a block waits for its activations.
// - Folds in place of phases: o, cross o, down and up split K across blocks;
//   each block writes its partial and takes a ticket on its column tile; the
//   last to arrive sums the partials in k order and adds them to the residual,
//   with the tile's LN statistics (mean, M2 of each 128- or 64-column segment;
//   the next LN merges them by Chan's formula), or takes GELU (up). The cross
//   q's last block runs the cross-attention of its heads (S text rows, one
//   warp a (row, head)).
// - Self-attention: an item is one warp's (row, head, split of the cache
//   rows), the splits of 64 rows and at most 16 from the offset; the warp
//   reads K eight lanes a row and V a row a step, 32 rows a pass with all its
//   loads issued first, and keeps an online softmax. It takes a ticket on its
//   (row, head); the last split merges the splits in split order.
// - Code size: a layer's phases run once each, so their code is fetched anew
//   every layer; the phases are calls (one copy of the projection for all six)
//   and their loops stay rolled where the latency allows.
// The schedule, the weight ring, the tile products, the tickets and the
// grid sync are decode_ring.cuh's, which the probes #11 and #12 share.
// Every sum has one fixed order, so a step is bitwise reproducible, and every
// split (the items' k-tiles, the cache-row splits) is chosen from the width,
// the offset and the device, never from B, so a row's result does not depend
// on how many rows share the launch.

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "decode_ring.cuh"

namespace {

constexpr int SYNCS_PER_LAYER = 7;
constexpr float NEG = -1e30f;

// where a projection's input rows come from: LN of the residual, or a buffer
// of f32 rows (the merged self-attention, the cross-attention, GELU of up)
enum ASrc { A_LN = 0, A_BUF = 1 };
// what the last block of a column tile does with the summed partials: add
// them to the residual, run the cross-attention of its heads, or take GELU
enum Fold { F_NONE = 0, F_RESIDUAL = 1, F_CROSS = 2, F_GELU = 3 };

struct Args {
  const bf16* s;        // (L·14, H) column scales
  const bf16* ln;       // (L, 8, H)
  const bf16* x;        // (B, H)
  const bf16* ck;       // (L, B, S, H)
  const bf16* cv;
  void* kc;             // (L, B, W, H) bf16 or e4m3 bytes
  void* vc;
  const int* cond_len;  // (B,) or null
  bf16* y;              // (B, H)
  float* xs;            // (B, H) residual stream
  float* seg;           // (B, H / TN, 2) segment mean, M2
  float* pa;            // k-group partials of qkv (groups, B, 3H) and up (groups, B, 4H)
  float* pb;            // k-group partials of o, cross q, cross o and down (groups, B, H)
  float* att;           // (splits, B, H) unnormalised self-attention outputs of the splits
  float* att_ml;        // (splits, B, heads, 2) their running max and sum
  float* satt;          // (B, H) the merged self-attention
  float* xatt;          // (B, H) the cross-attention
  float* gelu;          // (B, 4H) GELU of up
  int* tickets;         // (5, 4H / 64): o, cross q, cross o, up, down by column tile; then (B, heads): self-attention
  unsigned long long* timers;  // null, or (1 + 7·L) device-clock stamps of block 0 after each grid sync
  int L, B, H, S, W, offset, n_heads, n_split;
};

static_assert(sizeof(Args) <= 256, "Args fits its shared-memory slot");


// Two e4m3 bytes (the lower address in the low byte) → two f32, exactly.
__device__ __forceinline__ float2 e4m3x2(uint32_t two_bytes) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(two_bytes), __NV_E4M3);
  return __half22float2(__half2(h));
}

// Eight elements of q in f32 · eight elements of a cache row, in element order.
__device__ __forceinline__ float dot8(const float (&q)[8], const float (&k)[8]) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc = fmaf(q[e], k[e], acc);
  return acc;
}

// The cache element: bf16, or e4m3 bytes (F8). A row's 64 elements are read
// eight a lane (a Part), eight lanes a row, and widen exactly, so both tiers
// sum the same f32 values in the same order.
template <bool F8>
struct Cache;
template <>
struct Cache<false> {
  using T = bf16;
  using Part = uint4;
  static __device__ __forceinline__ T encode(bf16 v) { return v; }
  static __device__ __forceinline__ Part load_part(const T* row, int sub) {
    return __ldg(reinterpret_cast<const uint4*>(row) + sub);
  }
  static __device__ __forceinline__ void widen8(Part u, float (&k)[8]) {
    const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      k[2 * j] = __uint_as_float(wd[j] << 16);
      k[2 * j + 1] = __uint_as_float(wd[j] & 0xFFFF0000u);
    }
  }
  // the word holding elements 2·lane and 2·lane + 1 of a row, and its values
  using Pair = uint32_t;
  static __device__ __forceinline__ Pair load_pair(const T* v, int lane) {
    return __ldg(reinterpret_cast<const uint32_t*>(v + 2 * lane));
  }
  static __device__ __forceinline__ float2 widen(Pair u) {
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xFFFF0000u));
  }
};
template <>
struct Cache<true> {
  using T = __nv_fp8_storage_t;
  using Part = uint2;
  static __device__ __forceinline__ T encode(bf16 v) {
    return __nv_cvt_float_to_fp8(__bfloat162float(v), __NV_SATFINITE, __NV_E4M3);
  }
  static __device__ __forceinline__ Part load_part(const T* row, int sub) {
    return __ldg(reinterpret_cast<const uint2*>(row) + sub);
  }
  static __device__ __forceinline__ void widen8(Part u, float (&k)[8]) {
    const uint32_t wd[2] = {u.x, u.y};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 lo = e4m3x2(wd[j] & 0xFFFFu), hi = e4m3x2(wd[j] >> 16);
      k[4 * j] = lo.x;
      k[4 * j + 1] = lo.y;
      k[4 * j + 2] = hi.x;
      k[4 * j + 3] = hi.y;
    }
  }
  using Pair = uint32_t;
  static __device__ __forceinline__ Pair load_pair(const T* v, int lane) {
    return __ldg(reinterpret_cast<const uint16_t*>(v + 2 * lane));
  }
  static __device__ __forceinline__ float2 widen(Pair u) { return e4m3x2(u); }
};

// ------------------------------------------------------------ statistics

// The last block of a column tile (first column n0): Σ of its slices of
// partials (slice order), for each row. F_RESIDUAL: x += Σ (or x = the input
// when slices < 0), then the tile's mean and M2 of each row for the next LN,
// and on the last layer y. F_GELU: gelu = GELU(Σ) (exact, erf). Thread e takes
// elements e, e + THREADS, ... (at most 4), eight slices' loads in flight at
// once; the statistics go through rowv (shared, [MAXB][TN_MAX]), warp b doing
// row b.
template <int TN>
__device__ __noinline__ void fold_sum(const Args& a, Fold fold, int n0, int N, const float* part, int slices,
                                      bool last, float* rowv) {
  constexpr int CH = 8, PER = MAXB * TN / THREADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, H = a.H, B = a.B;
  size_t k[PER];
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * THREADS, b = e / TN;
    k[i] = size_t(b) * N + n0 + e % TN;
    v[i] = b >= B || fold == F_GELU ? 0.f : slices < 0 ? __bfloat162float(a.x[k[i]]) : __ldcg(a.xs + k[i]);
  }
  for (int s0 = 0; s0 < slices; s0 += CH) {  // slices in order
    float t[CH][PER];
#pragma unroll
    for (int s = 0; s < CH; ++s)
#pragma unroll
      for (int i = 0; i < PER; ++i)
        t[s][i] = s0 + s < slices && (tid + i * THREADS) / TN < B ? __ldcg(part + size_t(s0 + s) * B * N + k[i]) : 0.f;
#pragma unroll
    for (int s = 0; s < CH; ++s)
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (s0 + s < slices) v[i] += t[s][i];
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * THREADS;
    rowv[e / TN * TN_MAX + e % TN] = v[i];
  }
#pragma unroll 1
  for (int e = tid; e < B * TN; e += THREADS) {  // each thread its own elements
    const size_t kk = size_t(e / TN) * N + n0 + e % TN;
    const float x = rowv[e / TN * TN_MAX + e % TN];
    if (fold == F_GELU) {
      a.gelu[kk] = 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    } else {
      a.xs[kk] = x;
      if (last) a.y[kk] = __float2bfloat16_rn(x);
    }
  }
  if (fold == F_GELU) return;
  __syncthreads();  // rowv written
  if (warp < B) {
    const float* rv = rowv + warp * TN_MAX;
    float sum = 0.f;
#pragma unroll
    for (int c = lane; c < TN; c += 32) sum += rv[c];
    const float mean = warp_sum(sum) / TN;
    float m2 = 0.f;
#pragma unroll
    for (int c = lane; c < TN; c += 32) {
      const float dl = rv[c] - mean;
      m2 += dl * dl;
    }
    m2 = warp_sum(m2);
    if (lane == 0) {
      float* sg = a.seg + (size_t(warp) * (H / TN) + n0 / TN) * 2;
      sg[0] = mean;
      sg[1] = m2;
    }
  }
}

// A running softmax: its max, its sum, and this lane's two output dims.
struct Soft {
  float m, l, a0, a1;
};

// One pass of a warp over nr ≤ 32 rows of K and V (bf16, or e4m3 when F8)
// with q (64 f32 in shared memory): rows ≥ nlive (text rows past cond_len)
// get logit NEG and add no V. K is read eight lanes a row, V one row a step,
// every load before the arithmetic; logits in f32, P rounded to bf16 for
// P·V, the sum of P kept in f32. Both tiers sum the same values in one order.
template <bool F8>
__device__ __noinline__ Soft attend_pass(const typename Cache<F8>::T* K, const typename Cache<F8>::T* V, int H,
                                         int nr, int nlive, const float* q, Soft st) {
  using KV = Cache<F8>;
  const int lane = threadIdx.x & 31, sub = lane & 7, nv = min(nr, nlive);
  typename KV::Part kp[8];
  typename KV::Pair vw[32];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = (lane >> 3) + 4 * i;  // this lane's rows: rr, rr + 4, ...
    kp[i] = rr < nv ? KV::load_part(K + size_t(rr) * H, sub) : typename KV::Part{};
  }
#pragma unroll
  for (int rr = 0; rr < 32; ++rr) vw[rr] = rr < nv ? KV::load_pair(V + size_t(rr) * H, lane) : 0u;
  float qv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) qv[e] = q[8 * sub + e];
  float sc[8], cmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < 8; ++i) {  // row rr's logit: eight partial dots, summed over its eight lanes
    float k[8];
    KV::widen8(kp[i], k);
    float d = dot8(qv, k);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    const int rr = (lane >> 3) + 4 * i;
    sc[i] = rr >= nr ? -INFINITY : rr >= nlive ? NEG : d;
    cmax = fmaxf(cmax, sc[i]);
  }
  const float m_new = fmaxf(st.m, warp_max(cmax));
  const float rs = expf(st.m - m_new);
  float pr[8], psum = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    pr[i] = (lane >> 3) + 4 * i < nr ? expf(sc[i] - m_new) : 0.f;
    psum += pr[i];
  }
  st.l = st.l * rs + warp_sum(sub == 0 ? psum : 0.f);  // each row once: from lane 8·(rr % 4)
  st.a0 *= rs;
  st.a1 *= rs;
#pragma unroll
  for (int rr = 0; rr < 32; ++rr) {
    const float pb = bfr(__shfl_sync(0xffffffffu, pr[rr >> 2], (rr & 3) << 3));
    const float2 v2 = KV::widen(vw[rr]);
    st.a0 = fmaf(pb, v2.x, st.a0);
    st.a1 = fmaf(pb, v2.y, st.a1);
  }
  st.m = m_new;
  return st;
}

// The cross q's last block: q of the tile's heads (Σ slices, ·1/8, bf16), then
// cross-attention over the text K/V masked at cond_len, one warp a (row, head),
// 32 text rows a pass; the output, divided by its sum, goes to xatt.
__device__ __noinline__ void fold_cross(const Args& a, int layer, int tn, int n0, const float* part, int slices,
                                        float* q_s) {
  const int H = a.H, B = a.B, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  {  // thread (b, c) for c < tn: at most 4 rows a thread, every load first
    constexpr int RPT = MAXB * TN_MAX / THREADS;
    const int c = tid % tn, b0 = tid / tn, bstep = THREADS / tn;
    float q[RPT] = {};
#pragma unroll 2
    for (int s = 0; s < slices; ++s) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int b = b0 + r * bstep;
        if (b < B) q[r] += __ldcg(part + (size_t(s) * B + b) * H + n0 + c);
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int b = b0 + r * bstep;
      if (b < B) q_s[b * TN_MAX + c] = bfr(q[r] * 0.125f);
    }
  }
  __syncthreads();
  const int heads = tn / DH;
  for (int item = warp; item < B * heads; item += WARPS) {
    const int b = item / heads, hl = item % heads, c0 = n0 + hl * DH;
    const int nlive = a.cond_len ? min(max(a.cond_len[b], 0), a.S) : a.S;
    const bf16* CK = a.ck + (size_t(layer) * B + b) * a.S * H + c0;
    const bf16* CV = a.cv + (size_t(layer) * B + b) * a.S * H + c0;
    Soft st{-INFINITY, 0.f, 0.f, 0.f};
    for (int r0 = 0; r0 < a.S; r0 += 32)
      st = attend_pass<false>(CK + size_t(r0) * H, CV + size_t(r0) * H, H, min(32, a.S - r0), nlive - r0,
                              q_s + b * TN_MAX + hl * DH, st);
    *reinterpret_cast<float2*>(a.xatt + size_t(b) * H + c0 + 2 * lane) = make_float2(st.a0 / st.l, st.a1 / st.l);
  }
}

// ------------------------------------------------------------ projections

// Stage the inputs of an item of kt tiles (at g): its column scales into sc_s
// and its input rows (B × kt·256 from g.k0) into a_s as bf16; rows ≥ B stay
// zero. Every operand comes by 16-byte asynchronous copies, all in flight at
// once (the rows' raw values wait in red's space): one round trip. Then
// thread k takes columns k, k + 256, ... (KT = THREADS).
template <int TN>
__device__ void stage_inputs(const Args& a, int layer, int p, ASrc src, int ln_slot, const float* buf,
                             const GTile& g, int kt, unsigned char* smem) {
  static_assert(KT == THREADS, "a thread a column of each tile");
  static_assert(MAXB * KI_MAX <= WARPS * MAXB * TN_MAX, "the raw inputs fit in red");
  const int H = a.H, B = a.B, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = P_KCH[p] * H, nseg = H / TN, ki = kt * KT;  // K: the rows' length; ki: the item's
  bf16* a_s = reinterpret_cast<bf16*>(smem + SM_A);
  bf16* sc_s = reinterpret_cast<bf16*>(smem + SM_SC);
  float* raw = reinterpret_cast<float*>(smem + SM_RED);  // [MAXB][KI_MAX]
  bf16* lns = reinterpret_cast<bf16*>(smem + SM_LNP);    // [2][KI_MAX]
  float* segs = reinterpret_cast<float*>(smem + SM_SEG); // [B][nseg][2]
  float* st = reinterpret_cast<float*>(smem + SM_STATS);
  const float* base = (src == A_LN ? a.xs : buf) + g.k0;
  for (int b = 0; b < B; ++b)  // the rows
    for (int q = tid; q < ki / 4; q += THREADS) cp_async16(raw + b * KI_MAX + 4 * q, base + size_t(b) * K + 4 * q);
  if (tid < TN / 8) cp_async16(sc_s + 8 * tid, a.s + size_t(g.chunk) * H + g.n0 % H + 8 * tid);  // the column scales
  if (src == A_LN) {
    const bf16* lnp = a.ln + (size_t(layer) * 8 + ln_slot) * H + g.k0;
    for (int half = 0; half < 2; ++half)  // LN scale and bias of the rows' columns
      for (int q = tid; q < ki / 8; q += THREADS) cp_async16(lns + half * KI_MAX + 8 * q, lnp + half * H + 8 * q);
    for (int c = tid; c < B * nseg / 2; c += THREADS) cp_async16(segs + 4 * c, a.seg + 4 * c);  // segment stats
  }
  cp_async_wait();
  __syncthreads();
  if (src == A_LN) {
    // row b's mean and rstd from its segments (equal-size groups: mean of
    // means, M2 = Σ M2_i + n Σ δ_i²); warp b does row b
    if (warp < B) {
      const float* sg = segs + warp * nseg * 2;
      float sum = 0.f;
      for (int i = lane; i < nseg; i += 32) sum += sg[2 * i];
      const float mean = warp_sum(sum) / nseg;
      float m2 = 0.f;
      for (int i = lane; i < nseg; i += 32) {
        const float dl = sg[2 * i] - mean;
        m2 += sg[2 * i + 1] + float(TN) * dl * dl;
      }
      m2 = warp_sum(m2);
      if (lane == 0) {
        st[2 * warp] = mean;
        st[2 * warp + 1] = rsqrtf(m2 / H + 1e-5f);
      }
    }
    __syncthreads();
  }
  for (int k = tid; k < ki; k += THREADS) {
    const float sc = __bfloat162float(lns[k]), bi = __bfloat162float(lns[KI_MAX + k]);
    for (int b = 0; b < B; ++b) {
      float x = raw[b * KI_MAX + k];
      if (src == A_LN) x = ((x - st[2 * b]) * st[2 * b + 1]) * sc + bi;
      a_s[b * APITCH + k] = __float2bfloat16_rn(x);
    }
  }
}

// One projection phase: this block's items of phase p, in ring order. An
// item sums its kt weight tiles in registers and writes out[k-group][b][n] =
// Σ_{k in group} A[b][k] · W[k][n]; in a fold phase the block then takes a
// ticket on the item's column, and the last block of a column folds its
// k-groups.
template <bool I8>
__device__ __noinline__ void projection(const CUtensorMap* wmap, const Args& a, const Sched& sd, Ring& ring, int layer, int p,
                           ASrc src, int ln_slot, const float* buf, Fold fold, float* out, unsigned char* smem) {
  constexpr int COLS = WTile<I8>::COLS, TN = WTile<I8>::TN, NMMA = WTile<I8>::NMMA;
  const int H = a.H, B = a.B, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int G = gridDim.x, N = P_NOUT[p] * H, items = sd.items[p], kt = sd.kt[p];
  unsigned char* stages = smem + SM_RING;
  const bf16* a_s = reinterpret_cast<const bf16*>(smem + SM_A);
  const bf16* sc_s = reinterpret_cast<const bf16*>(smem + SM_SC);
  float* red = reinterpret_cast<float*>(smem + SM_RED);
  int* flag = reinterpret_cast<int*>(smem + SM_FLAG);
  GTile* gt = reinterpret_cast<GTile*>(smem + SM_GRP);
  const uint32_t bars = smem_u32(smem + SM_BARS);
  for (int item = sd.first(p); item < items; item += G) {
    if (tid == 0) *gt = item_at(sd, layer, p, item, H);
    __syncthreads();  // gt written
    stage_inputs<TN>(a, layer, p, src, ln_slot, buf, *gt, kt, smem);
    __syncthreads();  // a_s and sc_s written
    // this thread's column scales, as bf16x2 (s, s)
    uint32_t sc[COLS];
#pragma unroll
    for (int i = 0; i < COLS / 8; ++i) {
      const uint4 u = *reinterpret_cast<const uint4*>(sc_s + COLS * g + 8 * i);
      const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        sc[8 * i + 2 * q] = __byte_perm(wd[q], wd[q], 0x1010u);
        sc[8 * i + 2 * q + 1] = __byte_perm(wd[q], wd[q], 0x3232u);
      }
    }
    float acc[NMMA][4] = {};
    const int c0 = ring.consumed;
    for (int tl = 0; tl < kt; ++tl) {  // the item's tiles in k order, every warp on each
      const int stage = (c0 + tl) % STAGES;
      stage_wait(bars + 8 * stage, ((c0 + tl) / STAGES) & 1);
      tile_products<I8>(stages + stage * TILE_BYTES, a_s + tl * KT, sc, acc, warp, WARPS);
      __syncthreads();  // the stage is read
      if (tid == 0) {   // refill it with the tile STAGES ahead
        ring.consumed = c0 + tl + 1;
        refill<I8>(wmap, a, sd, ring, smem);
      }
    }
    // C rows g / g + 8 are columns COLS·g + 2μ / + 1; C columns 2t, 2t + 1 the rows b
#pragma unroll
    for (int mu = 0; mu < NMMA; ++mu) {
      const int c = COLS * g + 2 * mu;
      if (2 * t < B)
        *reinterpret_cast<float2*>(red + (warp * MAXB + 2 * t) * TN_MAX + c) = make_float2(acc[mu][0], acc[mu][2]);
      if (2 * t + 1 < B)
        *reinterpret_cast<float2*>(red + (warp * MAXB + 2 * t + 1) * TN_MAX + c) = make_float2(acc[mu][1], acc[mu][3]);
    }
    __syncthreads();  // red written
    float* o = out + size_t(gt->k0 / (kt * KT)) * B * N + gt->n0;
#pragma unroll 1
    for (int e = tid; e < B * TN; e += THREADS) {  // the warps in order
      const int b = e / TN, c = e % TN;
      float v = red[b * TN_MAX + c];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v += red[(w * MAXB + b) * TN_MAX + c];
      __stcg(o + size_t(b) * N + c, v);
    }
    __syncthreads();  // red free; the partials stored
    if (fold == F_NONE) continue;
    const int slices = sd.ks[p];
    if (tid == 0) {  // the barrier above ordered the block's partials before the ticket
      int* ticket = a.tickets + (p - 1) * (4 * H / 64) + gt->col;
      *flag = take_ticket(ticket) == slices - 1;
      if (*flag) *ticket = 0;
    }
    __syncthreads();
    if (*flag) {
      if (fold == F_CROSS)
        fold_cross(a, layer, TN, gt->n0, out, slices, red);
      else
        fold_sum<TN>(a, fold, gt->n0, N, out, slices, p == PHASES - 1 && layer + 1 == a.L, red);
    }
    __syncthreads();  // red, flag and gt free
  }
}

// ------------------------------------------------------------ self-attention

// Self-attention over the cache, seeded with the current token, whose k/v
// rows split 0 also writes at `offset`. An item is one (row, head, split of
// the cache rows) and one warp's, in passes of 32 rows (attend_pass). The warp
// leaves its unnormalised output with its max and sum and takes a ticket on
// its (row, head); the last split to arrive merges the splits in split order
// into satt (Σ e_s·acc_s / Σ e_s·l_s, e_s = exp(m_s − max)).
template <bool F8>
__device__ __noinline__ void self_attention(const Args& a, int layer, int slices, unsigned char* smem) {
  using KV = Cache<F8>;
  using T = typename KV::T;
  const int H = a.H, B = a.B, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* q_s = reinterpret_cast<float*>(smem + SM_Q) + warp * DH;  // this warp's q
  T* kc = static_cast<T*>(a.kc);
  T* vc = static_cast<T*>(a.vc);
  int* tickets = a.tickets + 5 * (4 * H / 64);
  const int n_split = a.n_split, heads = a.n_heads;
  const int per = (a.offset + n_split - 1) / n_split;
  // items round the grid's blocks first, so every SM shares the cache rows
  for (int item = warp * gridDim.x + blockIdx.x; item < B * heads * n_split; item += gridDim.x * WARPS) {
    const int split = item % n_split, bh = item / n_split;
    const int b = bh / heads, head = bh % heads, c0 = head * DH;
    const bool seeded = split == 0;
    // q (and for split 0 the new k and v) of dims 2·lane, 2·lane + 1: Σ the qkv slices
    float2 q = make_float2(0.f, 0.f), k = q, v = q;
#pragma unroll 8
    for (int s = 0; s < slices; ++s) {
      const float* pp = a.pa + (size_t(s) * B + b) * 3 * H + c0 + 2 * lane;
      const float2 qs = __ldcg(reinterpret_cast<const float2*>(pp));
      q.x += qs.x;
      q.y += qs.y;
      if (seeded) {
        const float2 ks = __ldcg(reinterpret_cast<const float2*>(pp + H));
        const float2 vs = __ldcg(reinterpret_cast<const float2*>(pp + 2 * H));
        k.x += ks.x;
        k.y += ks.y;
        v.x += vs.x;
        v.y += vs.y;
      }
    }
    const float q0 = bfr(q.x * 0.125f), q1 = bfr(q.y * 0.125f);
    q_s[2 * lane] = q0;
    q_s[2 * lane + 1] = q1;
    Soft st{-INFINITY, 0.f, 0.f, 0.f};
    if (seeded) {
      const bf16 k0b = __float2bfloat16_rn(k.x), k1b = __float2bfloat16_rn(k.y);
      const bf16 v0b = __float2bfloat16_rn(v.x), v1b = __float2bfloat16_rn(v.y);
      const size_t row = ((size_t(layer) * B + b) * a.W + a.offset) * H + c0 + 2 * lane;
      kc[row] = KV::encode(k0b);
      kc[row + 1] = KV::encode(k1b);
      vc[row] = KV::encode(v0b);
      vc[row + 1] = KV::encode(v1b);
      st = Soft{warp_sum(q0 * __bfloat162float(k0b) + q1 * __bfloat162float(k1b)), 1.f, __bfloat162float(v0b),
                __bfloat162float(v1b)};
    }
    __syncwarp();  // q_s written
    const int r_begin = min(split * per, a.offset), r_end = min(r_begin + per, a.offset);
    const size_t base = (size_t(layer) * B + b) * a.W * H + c0;
    for (int r0 = r_begin; r0 < r_end; r0 += 32)
      st = attend_pass<F8>(kc + base + size_t(r0) * H, vc + base + size_t(r0) * H, H, min(32, r_end - r0), 32, q_s, st);
    *reinterpret_cast<float2*>(a.att + (size_t(split) * B + b) * H + c0 + 2 * lane) = make_float2(st.a0, st.a1);
    const size_t ml_stride = size_t(B) * heads * 2;
    float* ml0 = a.att_ml + (size_t(b) * heads + head) * 2;
    if (lane == 0) {
      ml0[split * ml_stride] = st.m;
      ml0[split * ml_stride + 1] = st.l;
    }
    __syncwarp();  // q_s read; the warp's stores before lane 0's ticket
    int last = 0;
    if (lane == 0) {
      last = take_ticket(tickets + bh) == n_split - 1;
      if (last) tickets[bh] = 0;
    }
    if (!__shfl_sync(0xffffffffu, last, 0)) continue;
    // the merge: split s's max and sum in lane s (n_split ≤ 32), the outputs in split order
    const float ms = lane < n_split ? __ldcg(ml0 + lane * ml_stride) : -INFINITY;
    const float ls = lane < n_split ? __ldcg(ml0 + lane * ml_stride + 1) : 0.f;
    const float mx = warp_max(ms);
    const float e = lane < n_split ? expf(ms - mx) : 0.f;
    const float den = warp_sum(e * ls);
    float num0 = 0.f, num1 = 0.f;
    for (int s0 = 0; s0 < n_split; s0 += 8) {
      float2 part[8];
#pragma unroll
      for (int q8 = 0; q8 < 8; ++q8)
        part[q8] = s0 + q8 < n_split
                       ? __ldcg(reinterpret_cast<const float2*>(a.att + (size_t(s0 + q8) * B + b) * H + c0 + 2 * lane))
                       : make_float2(0.f, 0.f);
#pragma unroll
      for (int q8 = 0; q8 < 8; ++q8) {
        const float es = __shfl_sync(0xffffffffu, e, (s0 + q8) & 31);
        if (s0 + q8 < n_split) {
          num0 += es * part[q8].x;
          num1 += es * part[q8].y;
        }
      }
    }
    *reinterpret_cast<float2*>(a.satt + size_t(b) * H + c0 + 2 * lane) = make_float2(num0 / den, num1 / den);
  }
}

// ------------------------------------------------------------ the kernel

template <bool I8, bool F8>
__global__ void __launch_bounds__(THREADS, 1) decode_step_kernel(const __grid_constant__ CUtensorMap wmap, Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the ring's stages 1024-aligned for the 128-byte swizzle; pointer arithmetic keeps the shared space
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  constexpr int TN = WTile<I8>::TN;
  const int tid = threadIdx.x, H = a.H;
  Sched* sched = reinterpret_cast<Sched*>(smem + SM_SCHED);
  Ring* ring = reinterpret_cast<Ring*>(smem + SM_RINGST);
  Args* args = reinterpret_cast<Args*>(smem + SM_ARGS);
  const uint32_t bars = smem_u32(smem + SM_BARS);
  bf16* a_s = reinterpret_cast<bf16*>(smem + SM_A);
  for (int i = tid; i < MAXB * APITCH; i += THREADS) a_s[i] = __float2bfloat16_rn(0.f);
  if (tid == 0) {
    *sched = make_sched(H, TN);
    *args = a;
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap)) : "memory");
    // fill the ring with this block's first tiles
    *ring = Ring{0, 0, Cursor{0, 0, sched->first(0), 0}};
    ring->next.settle(*sched, a.L);
    refill<I8>(&wmap, a, *sched, *ring, smem);
  }
  __syncthreads();
  const Sched& sd = *sched;
  const Args& as = *args;
  int n_sync = 0;
  const auto sync = [&]() { grid_sync(a.timers, n_sync++); };
  if (blockIdx.x == 0)
    for (int i = tid; i < 5 * (4 * H / 64) + a.B * a.n_heads; i += THREADS) a.tickets[i] = 0;
  for (int c = blockIdx.x; c < H / TN; c += gridDim.x) {
    fold_sum<TN>(as, F_RESIDUAL, c * TN, H, nullptr, -1, false, reinterpret_cast<float*>(smem + SM_RED));
    __syncthreads();  // red free
  }
  sync();
  for (int l = 0; l < a.L; ++l) {
    projection<I8>(&wmap, as, sd, *ring, l, 0, A_LN, 0, nullptr, F_NONE, as.pa, smem);
    sync();
    self_attention<F8>(as, l, sd.ks[0], smem);
    sync();
    projection<I8>(&wmap, as, sd, *ring, l, 1, A_BUF, 0, as.satt, F_RESIDUAL, as.pb, smem);
    sync();
    projection<I8>(&wmap, as, sd, *ring, l, 2, A_LN, 2, nullptr, F_CROSS, as.pb, smem);
    sync();
    projection<I8>(&wmap, as, sd, *ring, l, 3, A_BUF, 0, as.xatt, F_RESIDUAL, as.pb, smem);
    sync();
    projection<I8>(&wmap, as, sd, *ring, l, 4, A_LN, 4, nullptr, F_GELU, as.pa, smem);
    sync();
    projection<I8>(&wmap, as, sd, *ring, l, 5, A_BUF, 0, as.gelu, F_RESIDUAL, as.pb, smem);
    if (l + 1 < a.L) sync();
  }
  if (a.timers && blockIdx.x == 0 && tid == 0) {  // block 0's end: the last stamp
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.timers[n_sync] = t;
  }
}

// ------------------------------------------------------------ host side

const void* pick_kernel(bool i8, bool f8) {
  if (i8) return f8 ? reinterpret_cast<const void*>(decode_step_kernel<true, true>)
                    : reinterpret_cast<const void*>(decode_step_kernel<true, false>);
  return f8 ? reinterpret_cast<const void*>(decode_step_kernel<false, true>)
            : reinterpret_cast<const void*>(decode_step_kernel<false, false>);
}

inline bool shape_ok(int B, int H) { return B >= 1 && B <= MAXB && H >= KT && H <= H_MAX && H % KT == 0; }

struct Plan {
  int grid = 0;
  size_t xs = 0, seg = 0, pa = 0, pb = 0, att = 0, att_ml = 0, satt = 0, xatt = 0, gelu = 0, tickets = 0, total = 0;
};

// The grid (one block an SM, which the occupancy query must allow) and the
// scratch layout for B rows of width H.
inline cudaError_t make_plan(const void* kern, int B, int H, Plan& p) {
  const cudaError_t err = coop_grid(kern, p.grid);
  if (err != cudaSuccess) return err;
  const size_t bh = size_t(B) * H, slices = H / KT, nseg = H / 64;
  p.xs = 0;
  p.seg = round4(bh);
  p.pa = p.seg + round4(size_t(B) * nseg * 2);
  p.pb = p.pa + round4(slices * 4 * bh);
  p.att = p.pb + round4(4 * slices * bh);
  p.att_ml = p.att + round4(size_t(MAX_SPLIT) * bh);
  p.satt = p.att_ml + round4(size_t(MAX_SPLIT) * B * (H / DH) * 2);
  p.xatt = p.satt + round4(bh);
  p.gelu = p.xatt + round4(bh);
  p.tickets = p.gelu + round4(4 * bh);
  p.total = p.tickets + round4(5 * 4 * nseg + size_t(B) * (H / DH));
  return cudaSuccess;
}

}  // namespace

// f32 scratch the kernel needs for B rows of width H (0 when the shape is not taken).
extern "C" int fgt_decode_step_scratch_floats(int B, int H, int w_is_int8) {
  Plan p;
  if (!shape_ok(B, H)) return 0;
  return make_plan(pick_kernel(w_is_int8 != 0, false), B, H, p) == cudaSuccess ? static_cast<int>(p.total) : 0;
}

// The instantiation's registers a thread, local memory bytes a thread (its
// calls' stack; ptxas reports spills apart), shared memory bytes a block,
// resident blocks an SM, ring stages and grid syncs a layer.
extern "C" int fgt_decode_step_info(int w_is_int8, int kv_is_e4m3, int* regs, int* local_bytes, int* smem_bytes,
                                    int* blocks_per_sm, int* ring_stages, int* syncs_per_layer) {
  const void* kern = pick_kernel(w_is_int8 != 0, kv_is_e4m3 != 0);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, THREADS, SMEM_BYTES);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = static_cast<int>(SMEM_BYTES);
  *ring_stages = STAGES;
  *syncs_per_layer = SYNCS_PER_LAYER;
  return static_cast<int>(err);
}

// One AR step through all L layers; see the header comment. cond_len may be
// null (every text row live); kv_is_e4m3 selects the e4m3-byte cache tier.
// timers may be null, or take 7·L + 1 u64 stamps of the device clock (ns):
// block 0 after each grid sync, then at its end. Returns a cudaError_t.
extern "C" int fgt_decode_step(const void* w, const void* s, const void* ln, const void* x, const void* ck,
                               const void* cv, void* kc, void* vc, const void* cond_len, void* y, void* scratch,
                               int L, int B, int H, int S, int W, int offset, int n_heads, int w_is_int8,
                               int kv_is_e4m3, void* timers, void* stream) {
  if (!shape_ok(B, H) || L <= 0 || S <= 0 || n_heads * DH != H || offset < 0 || offset >= W ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(s) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool i8 = w_is_int8 != 0;
  const void* kern = pick_kernel(i8, kv_is_e4m3 != 0);
  Plan p;
  cudaError_t err = make_plan(kern, B, H, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap wmap;
  if (!weight_map(&wmap, w, i8, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  float* sc = static_cast<float*>(scratch);
  Args a;
  a.s = static_cast<const bf16*>(s);
  a.ln = static_cast<const bf16*>(ln);
  a.x = static_cast<const bf16*>(x);
  a.ck = static_cast<const bf16*>(ck);
  a.cv = static_cast<const bf16*>(cv);
  a.kc = kc;
  a.vc = vc;
  a.cond_len = static_cast<const int*>(cond_len);
  a.y = static_cast<bf16*>(y);
  a.xs = sc + p.xs;
  a.seg = sc + p.seg;
  a.pa = sc + p.pa;
  a.pb = sc + p.pb;
  a.att = sc + p.att;
  a.att_ml = sc + p.att_ml;
  a.satt = sc + p.satt;
  a.xatt = sc + p.xatt;
  a.gelu = sc + p.gelu;
  a.tickets = reinterpret_cast<int*>(sc + p.tickets);
  a.timers = static_cast<unsigned long long*>(timers);
  a.L = L;
  a.B = B;
  a.H = H;
  a.S = S;
  a.W = W;
  a.offset = offset;
  a.n_heads = n_heads;
  a.n_split = row_splits(offset);  // cache-row splits from the offset alone
  void* args[] = {&wmap, &a};
  err = cudaLaunchCooperativeKernel(kern, dim3(p.grid), dim3(THREADS), args, SMEM_BYTES,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
