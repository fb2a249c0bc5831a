// The probes of the MusicGen decode step (kernel D) on D's own machinery, for
// Hopper (sm_90a): the decode-chain probe (#11, decode_chain.cu) and the
// chain-bisect probe (#12, chain_bisect.cu).
//
// Both run x (M, H) bf16 through L layers of 14 int8 (H, H) weight chunks
// with bf16 scales, D's packed weights, with attention as identity. One layer:
//   LN → q = c0, k = c1, v = c2 (with #12's ln: × ln[l, 0] + ln[l, 1]);
//   x += c3·q + 0·(k + v)[:, 0]; LN → x += c5·(c4·LN); LN → up c6..c9 →
//   GELU per chunk (#11 exact, #12 the tanh form) → x += Σ c10..c13.
// #12 adds the script's extras (prof_chain_bisect.py), each a bit of the
// template mask MASK (X_RUNTIME: read at run time), built where and as D
// builds its counterpart, so a rung's increment is D's cost of that piece:
//   smem   Args.offset, never read
//   ln     LN scale and bias of the qkv pre-norm, staged with an item's
//          inputs as D stages its LN parameters
//   cross  + 0·Σ_b ck[l, b, 0, n] + 0·Σ_b cv[l, b, 0, n] on c4's output,
//          read in the cross-q fold, where D reads its cross K/V
//   hbm    the (L, 2, W, H) caches: pointers, never read without dma
//   bufs   no operand and no code: D stages no cache row in shared memory,
//          its warps load rows into registers (the script's VMEM buffers
//          have no counterpart), so the rung's increment reads the noise
//   outs   kn, vn (L, 2, H) bf16, rows 0..1 of the c1 and c2 products,
//          written by the qkv fold (D writes its new k/v rows there too)
//   dma    layer l's (2, W, H) K and V windows read at the start of the o
//          phase, which waits for them, with D's warp loads (an item a (row,
//          head, split of the rows), 32 rows a pass, K eight lanes a row in
//          16-byte pieces and V a 4-byte pair a lane, every load of a pass
//          issued first), and 0·(the script's touched row of b 0, K + V)
//          added to the o input. Not TMA bulk copies into a shared-memory
//          ring: D reads its windows with these warp loads, and the weight
//          ring leaves 4 KB of the 227 KB a block may hold.
// Extras that change no code (smem, hbm, bufs) run their rung-before's kernel.
//
// Design: D's (decode_ring.cuh). One 256-thread block an SM; the weights
// through D's 5-stage TMA ring, run ahead across the grid syncs; the
// projections on mma.sync with the rows padded to 8; every phase a fold
// phase, whose last block per column tile sums the k-group partials in order
// into a buffer, GELU or the residual (with the segment statistics that the
// next LN merges). Six grid syncs a layer (D has seven, its self-attention
// a phase of its own):
//   qkv | o + residual | cross q | cross o + residual | up + GELU |
//   down + residual.
// Every sum has one fixed order, so a step is bitwise reproducible, and the
// k-groups follow the width and the device, never M, so a row's result does
// not depend on how many rows share the launch.
//
// Numerics of the scripts' kernels: weights dequantized as bf16(w) · bf16(s)
// rounded to bf16 (one rounding of the exact product); dot inputs rounded to
// bf16 with f32 accumulation; LN in f32 (eps 1e-5); residual in f32; y in
// bf16. No --use_fast_math, so the 0·x terms stay and carry a NaN as the
// scripts' do.
//
// Bound: bytes. 48 × 14 × 1536² int8 weights a step, 1.585 GB, 0.4733 ms at
// 3.35 TB/s; with dma also the 302 MB of caches at B 2, W 512.
#pragma once

#include "decode_ring.cuh"

namespace {

// the extras, in the script's order: bit i for extra i
constexpr unsigned X_SMEM = 1, X_LN = 2, X_CROSS = 4, X_HBM = 8, X_BUFS = 16, X_OUTS = 32, X_DMA = 64;
constexpr unsigned X_ALL = 127;
constexpr unsigned X_CODE = X_LN | X_CROSS | X_OUTS | X_DMA;  // the extras that change the kernel's code
constexpr unsigned X_RUNTIME = 128;  // the instantiation that reads the extras at run time
constexpr int CB = 2;                // rows of the cross K/V, the caches and kn/vn (the script's B)
using WT = WTile<true>;              // the probes stream int8 weights
constexpr int TN = WT::TN;           // 128 columns a tile
constexpr int SYNCS_PER_LAYER = 6;

enum GeluForm { GELU_ERF = 0, GELU_TANH = 1 };

struct Args {
  const bf16* s;        // (L·14, H) column scales
  const bf16* ln;       // (L, 8, H) with ln, else null
  const bf16* x;        // (B, H)
  const bf16* ck;       // (L, CB, S, H) with cross
  const bf16* cv;
  const bf16* kc;       // (L, CB, W, H) with hbm
  const bf16* vc;
  bf16* y;              // (B, H)
  bf16* kn;             // (L, CB, H) with outs
  bf16* vn;
  float* xs;            // (B, H) residual stream
  float* seg;           // (B, H / TN, 2) segment mean, M2
  float* pa;            // k-group partials of qkv (groups, B, 3H) and up (groups, B, 4H)
  float* pb;            // k-group partials of o, cross q, cross o and down (groups, B, H)
  float* qkv;           // (B, 3H) q, k, v
  float* cq;            // (B, H) c4's output
  float* gelu;          // (B, 4H) GELU of up
  unsigned* sink;       // (grid · WARPS) with dma: each warp's fold of the cache words it read
  int* tickets;         // (6, 4H / 64) by phase and column tile
  unsigned long long* timers;  // null, or (1 + 6·L) device-clock stamps of block 0 after each grid sync
  int L, B, H, S, W, offset, touched, n_split;
  unsigned extras;
};

static_assert(sizeof(Args) <= 256, "Args fits its shared-memory slot");

template <unsigned MASK>
__device__ __forceinline__ bool on(const Args& a, unsigned x) {
  return (MASK & X_RUNTIME) ? (a.extras & x) != 0 : (MASK & x) != 0;
}

// ------------------------------------------------------------ D's loops, as functions

// The pieces of D's projection phase (decode_step.cu: projection,
// stage_inputs, fold_sum and the kernel's set-up), the same code made into
// functions for the probes' phases, at int8 weights; read_windows below
// copies D's cache loads (attend_pass, self_attention). This copy follows
// D by hand: tests/test_torch_decode_chain.py pins decode_step.cu's hash,
// and a change to D fails there until it is carried here (or found not to
// apply) and the pin is moved.

// Thread 0 at the kernel's start: the ring's barriers, and the ring filled
// with this block's first tiles.
__device__ __forceinline__ void ring_start(const CUtensorMap* wmap, const Args& a, const Sched& sd, Ring& ring,
                                           unsigned char* smem) {
  const uint32_t bars = smem_u32(smem + SM_BARS);
  for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(wmap)) : "memory");
  ring = Ring{0, 0, Cursor{0, 0, sd.first(0), 0}};
  ring.next.settle(sd, a.L);
  refill<true>(wmap, a, sd, ring, smem);
}

// The mean and M2 of each of rows 0..B-1 of one column tile (rowv, shared,
// [MAXB][TN_MAX]) into its segment of seg (B, H / TN, 2); warp b does row b.
template <int TN>
__device__ __forceinline__ void seg_stats(float* seg, int H, int B, int n0, const float* rowv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
      float* sg = seg + (size_t(warp) * (H / TN) + n0 / TN) * 2;
      sg[0] = mean;
      sg[1] = m2;
    }
  }
}

// Row b's mean and rstd (into st[2b], st[2b + 1]) from its nseg segments of
// TN columns in segs (shared, [B][nseg][2]): equal-size groups, so the mean
// of means and M2 = Σ M2_i + n Σ δ_i²; warp b does row b.
template <int TN>
__device__ __forceinline__ void ln_merge(const float* segs, float* st, int B, int H, int nseg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
}

// This thread's column scales of the item (staged in sc_s), as bf16x2 (s, s).
__device__ __forceinline__ void column_scales(const bf16* sc_s, uint32_t (&sc)[WT::COLS]) {
  constexpr int COLS = WT::COLS;
  const int g = (threadIdx.x & 31) >> 2;
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
}

// An item's kt weight tiles from the ring, in k order, every warp on each:
// acc += the tiles' products with the staged rows a_s; thread 0 refills each
// stage as it is freed.
__device__ __forceinline__ void item_products(const CUtensorMap* wmap, const Args& a, const Sched& sd, Ring& ring,
                                              int kt, const bf16* a_s, const uint32_t (&sc)[WT::COLS],
                                              float (&acc)[WT::NMMA][4], unsigned char* smem) {
  const int tid = threadIdx.x, warp = tid >> 5;
  unsigned char* stages = smem + SM_RING;
  const uint32_t bars = smem_u32(smem + SM_BARS);
  const int c0 = ring.consumed;
  for (int tl = 0; tl < kt; ++tl) {  // the item's tiles in k order, every warp on each
    const int stage = (c0 + tl) % STAGES;
    stage_wait(bars + 8 * stage, ((c0 + tl) / STAGES) & 1);
    tile_products<true>(stages + stage * TILE_BYTES, a_s + tl * KT, sc, acc, warp, WARPS);
    __syncthreads();  // the stage is read
    if (tid == 0) {   // refill it with the tile STAGES ahead
      ring.consumed = c0 + tl + 1;
      refill<true>(wmap, a, sd, ring, smem);
    }
  }
}

// The item's partial: out[b][c] (row stride N) = Σ over the warps, in warp
// order, of their sums, for rows b < B and the tile's TN columns.
__device__ __forceinline__ void store_partial(const float (&acc)[WT::NMMA][4], float* red, float* o, int B, int N) {
  constexpr int COLS = WT::COLS, NMMA = WT::NMMA;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
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
#pragma unroll 1
  for (int e = tid; e < B * TN; e += THREADS) {  // the warps in order
    const int b = e / TN, c = e % TN;
    float v = red[b * TN_MAX + c];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += red[(w * MAXB + b) * TN_MAX + c];
    __stcg(o + size_t(b) * N + c, v);
  }
  __syncthreads();  // red free; the partials stored
}

// Thread 0, after the barrier that ordered the block's partials: take a
// ticket on the column tile; the last of `slices` arrivals resets it for the
// next layer and sets *flag.
__device__ __forceinline__ void last_arrival(int* ticket, int slices, int* flag) {
  *flag = take_ticket(ticket) == slices - 1;
  if (*flag) *ticket = 0;
}

// Block 0's last stamp, at its end.
__device__ __forceinline__ void stamp_end(unsigned long long* timers, int n) {
  if (timers && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    timers[n] = t;
  }
}

// ------------------------------------------------------------ the folds

// The last block of column tile n0 of phase p: Σ of its slices of partials
// (slice order), for each row, then
//   p 0 (qkv): qkv = Σ; with outs, kn/vn of rows < CB from the k and v columns;
//   p 2 (cross q): cq = Σ, with cross + 0·Σ_b ck[l, b, 0, n] + 0·Σ_b cv[l, b, 0, n];
//   p 4 (up): gelu = GELU(Σ);
//   p 1, 3, 5: x += Σ (x = the input when slices < 0), after o + 0·(k + v)[b, 0];
//   the tile's mean and M2 of each row for the next LN, and with `last` y.
// Thread e takes elements e, e + THREADS, ... (4), eight slices' loads in
// flight at once; rowv is shared, [MAXB][TN_MAX].
template <int GELU, unsigned MASK>
__device__ __noinline__ void fold(const Args& a, int layer, int p, int n0, int N, const float* part, int slices,
                                  bool last, float* rowv) {
  constexpr int CH = 8, PER = MAXB * TN / THREADS;
  const int tid = threadIdx.x, H = a.H, B = a.B;
  const bool residual = slices < 0 || (p & 1);
  size_t k[PER];
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * THREADS, b = e / TN;
    k[i] = size_t(b) * N + n0 + e % TN;
    v[i] = b >= B || !residual ? 0.f : slices < 0 ? __bfloat162float(a.x[k[i]]) : __ldcg(a.xs + k[i]);
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
    const int b = e / TN, n = n0 + e % TN;
    const size_t kk = size_t(b) * N + n;
    float x = rowv[b * TN_MAX + e % TN];
    if (residual) {
      if (p == 1 && slices >= 0)  // the script's 0·ts[:, :1]: column 0 of k and of v
        x = x + 0.f * (__ldcg(a.qkv + size_t(b) * 3 * H + H) + __ldcg(a.qkv + size_t(b) * 3 * H + 2 * H));
      a.xs[kk] = x;
      if (last) a.y[kk] = __float2bfloat16_rn(x);
      rowv[b * TN_MAX + e % TN] = x;
    } else if (p == 0) {
      a.qkv[kk] = x;
      if (on<MASK>(a, X_OUTS) && b < CB && n >= H) {
        bf16* o = n < 2 * H ? a.kn : a.vn;
        o[(size_t(layer) * CB + b) * H + n % H] = __float2bfloat16_rn(x);
      }
    } else if (p == 2) {
      if (on<MASK>(a, X_CROSS)) {
        float sk = 0.f, sv = 0.f;
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          const size_t row = ((size_t(layer) * CB + c) * a.S) * H + n;
          sk += __bfloat162float(a.ck[row]);
          sv += __bfloat162float(a.cv[row]);
        }
        x = x + 0.f * sk + 0.f * sv;
      }
      a.cq[kk] = x;
    } else if (GELU == GELU_TANH) {
      a.gelu[kk] = 0.5f * x * (1.f + tanhf(0.7978845608f * (x + 0.044715f * (x * x * x))));
    } else {
      a.gelu[kk] = 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    }
  }
  if (!residual) return;
  __syncthreads();  // rowv written
  seg_stats<TN>(a.seg, H, B, n0, rowv);
}

// ------------------------------------------------------------ projections

// Stage the inputs of an item of kt tiles (at g) of phase p: its column
// scales into sc_s and its input rows (B × kt·256 from g.k0) into a_s as
// bf16; rows ≥ B stay zero. The qkv, cross q and up phases take LN of the
// residual (qkv with ln's scale and bias under ln); o takes q from the qkv
// buffer (under dma + 0·the touched cache rows), cross o the cross-q
// buffer, down the GELU buffer. Every operand comes by 16-byte asynchronous
// copies, all in flight at once (the rows' raw values wait in red's space).
template <unsigned MASK>
__device__ void stage_inputs(const Args& a, int layer, int p, const GTile& g, int kt, unsigned char* smem) {
  static_assert(KT == THREADS, "a thread a column of each tile");
  static_assert(MAXB * KI_MAX <= WARPS * MAXB * TN_MAX, "the raw inputs fit in red");
  const int H = a.H, B = a.B, tid = threadIdx.x;
  const bool from_ln = !(p & 1), affine = p == 0 && on<MASK>(a, X_LN), touch = p == 1 && on<MASK>(a, X_DMA);
  const int nseg = H / TN, ki = kt * KT;
  const int ld = from_ln ? H : p == 1 ? 3 * H : P_KCH[p] * H;  // the input rows' length
  const float* buf = from_ln ? a.xs : p == 1 ? a.qkv : p == 3 ? a.cq : a.gelu;
  bf16* a_s = reinterpret_cast<bf16*>(smem + SM_A);
  bf16* sc_s = reinterpret_cast<bf16*>(smem + SM_SC);
  float* raw = reinterpret_cast<float*>(smem + SM_RED);  // [MAXB][KI_MAX]
  bf16* lns = reinterpret_cast<bf16*>(smem + SM_LNP);    // [2][KI_MAX]
  float* segs = reinterpret_cast<float*>(smem + SM_SEG); // [B][nseg][2]
  float* st = reinterpret_cast<float*>(smem + SM_STATS);
  const float* base = buf + g.k0;
  for (int b = 0; b < B; ++b)  // the rows
    for (int q = tid; q < ki / 4; q += THREADS) cp_async16(raw + b * KI_MAX + 4 * q, base + size_t(b) * ld + 4 * q);
  if (tid < TN / 8) cp_async16(sc_s + 8 * tid, a.s + size_t(g.chunk) * H + g.n0 % H + 8 * tid);  // the column scales
  if (affine) {
    const bf16* lnp = a.ln + size_t(layer) * 8 * H + g.k0;
    for (int half = 0; half < 2; ++half)  // LN scale and bias of the rows' columns
      for (int q = tid; q < ki / 8; q += THREADS) cp_async16(lns + half * KI_MAX + 8 * q, lnp + half * H + 8 * q);
  }
  if (from_ln)
    for (int c = tid; c < B * nseg / 2; c += THREADS) cp_async16(segs + 4 * c, a.seg + 4 * c);  // segment stats
  cp_async_wait();
  __syncthreads();
  if (from_ln) {
    ln_merge<TN>(segs, st, B, H, nseg);
    __syncthreads();
  }
  // with dma, the touched row of b 0 of layer l's K and V windows
  const size_t trow = (size_t(layer) * CB * a.W + a.touched) * H + g.k0;
  for (int k = tid; k < ki; k += THREADS) {
    float sc = 1.f, bi = 0.f, tk = 0.f, tv = 0.f;
    if (affine) sc = __bfloat162float(lns[k]), bi = __bfloat162float(lns[KI_MAX + k]);
    if (touch) tk = __bfloat162float(__ldg(a.kc + trow + k)), tv = __bfloat162float(__ldg(a.vc + trow + k));
    for (int b = 0; b < B; ++b) {
      float x = raw[b * KI_MAX + k];
      if (from_ln) x = (x - st[2 * b]) * st[2 * b + 1];
      if (affine) x = x * sc + bi;
      if (touch) x = x + 0.f * tk + 0.f * tv;
      a_s[b * APITCH + k] = __float2bfloat16_rn(x);
    }
  }
}

// One projection phase: this block's items of phase p, in ring order. An
// item sums its kt weight tiles in registers and writes out[k-group][b][n] =
// Σ_{k in group} A[b][k] · W[k][n]; the block then takes a ticket on the
// item's column tile, and the last block of a column folds its k-groups.
template <int GELU, unsigned MASK>
__device__ __noinline__ void projection(const CUtensorMap* wmap, const Args& a, const Sched& sd, Ring& ring,
                                        int layer, int p, unsigned char* smem) {
  constexpr int COLS = WT::COLS, NMMA = WT::NMMA;
  const int H = a.H, B = a.B, tid = threadIdx.x;
  const int G = gridDim.x, N = P_NOUT[p] * H, items = sd.items[p], kt = sd.kt[p], slices = sd.ks[p];
  float* out = p == 0 || p == 4 ? a.pa : a.pb;
  const bf16* a_s = reinterpret_cast<const bf16*>(smem + SM_A);
  const bf16* sc_s = reinterpret_cast<const bf16*>(smem + SM_SC);
  float* red = reinterpret_cast<float*>(smem + SM_RED);
  int* flag = reinterpret_cast<int*>(smem + SM_FLAG);
  GTile* gt = reinterpret_cast<GTile*>(smem + SM_GRP);
  for (int item = sd.first(p); item < items; item += G) {
    if (tid == 0) *gt = item_at(sd, layer, p, item, H);
    __syncthreads();  // gt written
    stage_inputs<MASK>(a, layer, p, *gt, kt, smem);
    __syncthreads();  // a_s and sc_s written
    uint32_t sc[COLS];  // this thread's column scales, as bf16x2 (s, s)
    column_scales(sc_s, sc);
    float acc[NMMA][4] = {};
    item_products(wmap, a, sd, ring, kt, a_s, sc, acc, smem);
    store_partial(acc, red, out + size_t(gt->k0 / (kt * KT)) * B * N + gt->n0, B, N);
    if (tid == 0)  // the barrier in store_partial ordered the block's partials before the ticket
      last_arrival(a.tickets + p * (4 * H / 64) + gt->col, slices, flag);
    __syncthreads();
    if (*flag) fold<GELU, MASK>(a, layer, p, gt->n0, N, out, slices, p == PHASES - 1 && layer + 1 == a.L, red);
    __syncthreads();  // red, flag and gt free
  }
}

// ------------------------------------------------------------ the windows (dma)

// This block's warps read their share of layer l's (CB, W, H) K and V
// windows as D's self-attention reads its cache rows (attend_pass): an item
// is one (row, head, split of the W rows), one warp's, items round the
// grid's blocks first; 32 rows a pass, K eight lanes a row in 16-byte pieces
// and V a 4-byte pair a lane, every load of a pass issued before any is
// used. The warp folds the words it read by XOR into its sink slot, so no
// load can be dropped, and the o phase that follows waits for them.
__device__ __noinline__ void read_windows(const Args& a, int layer) {
  const int H = a.H, lane = threadIdx.x & 31, warp = threadIdx.x >> 5, sub = lane & 7, heads = H / DH;
  const int n_split = a.n_split, per = (a.W + n_split - 1) / n_split;
  uint32_t acc = 0;
  for (int item = warp * gridDim.x + blockIdx.x; item < CB * heads * n_split; item += gridDim.x * WARPS) {
    const int split = item % n_split, bh = item / n_split, b = bh / heads, c0 = bh % heads * DH;
    const int r_begin = min(split * per, a.W), r_end = min(r_begin + per, a.W);
    const size_t base = (size_t(layer) * CB + b) * a.W * H + c0;
    for (int r0 = r_begin; r0 < r_end; r0 += 32) {
      const int nv = min(32, r_end - r0);
      const bf16* K = a.kc + base + size_t(r0) * H;
      const bf16* V = a.vc + base + size_t(r0) * H;
      uint4 kp[8];
      uint32_t vw[32];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rr = (lane >> 3) + 4 * i;  // this lane's rows: rr, rr + 4, ...
        kp[i] = rr < nv ? __ldg(reinterpret_cast<const uint4*>(K + size_t(rr) * H) + sub) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int rr = 0; rr < 32; ++rr)
        vw[rr] = rr < nv ? __ldg(reinterpret_cast<const uint32_t*>(V + size_t(rr) * H + 2 * lane)) : 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc ^= kp[i].x ^ kp[i].y ^ kp[i].z ^ kp[i].w;
#pragma unroll
      for (int rr = 0; rr < 32; ++rr) acc ^= vw[rr];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) a.sink[blockIdx.x * WARPS + warp] = acc;
}

// ------------------------------------------------------------ the kernel

template <int GELU, unsigned MASK>
__global__ void __launch_bounds__(THREADS, 1) probe_kernel(const __grid_constant__ CUtensorMap wmap, Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the ring's stages 1024-aligned for the 128-byte swizzle; pointer arithmetic keeps the shared space
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, H = a.H;
  Sched* sched = reinterpret_cast<Sched*>(smem + SM_SCHED);
  Ring* ring = reinterpret_cast<Ring*>(smem + SM_RINGST);
  Args* args = reinterpret_cast<Args*>(smem + SM_ARGS);
  bf16* a_s = reinterpret_cast<bf16*>(smem + SM_A);
  for (int i = tid; i < MAXB * APITCH; i += THREADS) a_s[i] = __float2bfloat16_rn(0.f);
  if (tid == 0) {
    *sched = make_sched(H, TN);
    *args = a;
    ring_start(&wmap, a, *sched, *ring, smem);
  }
  __syncthreads();
  const Sched& sd = *sched;
  const Args& as = *args;
  int n_sync = 0;
  const auto sync = [&]() { grid_sync(a.timers, n_sync++); };
  if (blockIdx.x == 0)
    for (int i = tid; i < PHASES * (4 * H / 64); i += THREADS) a.tickets[i] = 0;
  for (int c = blockIdx.x; c < H / TN; c += gridDim.x) {  // x into the residual, with its statistics
    fold<GELU, MASK>(as, 0, PHASES - 1, c * TN, H, nullptr, -1, false, reinterpret_cast<float*>(smem + SM_RED));
    __syncthreads();  // red free
  }
  sync();
  const bool dma = on<MASK>(as, X_DMA);
  for (int l = 0; l < a.L; ++l) {
    projection<GELU, MASK>(&wmap, as, sd, *ring, l, 0, smem);
    sync();
    if (dma) read_windows(as, l);
    projection<GELU, MASK>(&wmap, as, sd, *ring, l, 1, smem);
    sync();
    projection<GELU, MASK>(&wmap, as, sd, *ring, l, 2, smem);
    sync();
    projection<GELU, MASK>(&wmap, as, sd, *ring, l, 3, smem);
    sync();
    projection<GELU, MASK>(&wmap, as, sd, *ring, l, 4, smem);
    sync();
    projection<GELU, MASK>(&wmap, as, sd, *ring, l, 5, smem);
    if (l + 1 < a.L) sync();
  }
  stamp_end(a.timers, n_sync);  // block 0's end: the last stamp
}

// ------------------------------------------------------------ host side

inline bool shape_ok(int B, int H) { return B >= 1 && B <= MAXB && H >= KT && H <= H_MAX && H % KT == 0; }

struct Plan {
  int grid = 0;
  size_t xs = 0, seg = 0, pa = 0, pb = 0, qkv = 0, cq = 0, gelu = 0, sink = 0, tickets = 0, total = 0;  // in floats
};

// The grid (one block an SM) and the scratch layout for B rows of width H.
inline cudaError_t make_plan(const void* kern, int B, int H, Plan& p) {
  const cudaError_t err = coop_grid(kern, p.grid);
  if (err != cudaSuccess) return err;
  const size_t bh = size_t(B) * H, slices = H / KT;
  p.xs = 0;
  p.seg = round4(bh);
  p.pa = p.seg + round4(size_t(B) * (H / TN) * 2);
  p.pb = p.pa + round4(slices * 4 * bh);
  p.qkv = p.pb + round4(4 * slices * bh);
  p.cq = p.qkv + round4(3 * bh);
  p.gelu = p.cq + round4(bh);
  p.sink = p.gelu + round4(4 * bh);
  p.tickets = p.sink + round4(size_t(p.grid) * WARPS);
  p.total = p.tickets + round4(size_t(PHASES) * (4 * H / 64));
  return cudaSuccess;
}

// Launch `kern` on a (its operands, a.L, a.B and a.H set): the weight map,
// the scratch pointers of the plan, the windows' splits.
inline cudaError_t probe_launch(const void* kern, const void* w, Args& a, float* scratch, void* stream) {
  if (reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(a.s) % 16) return cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(kern, a.B, a.H, p);
  if (err != cudaSuccess) return err;
  CUtensorMap wmap;
  if (!weight_map(&wmap, w, true, a.L, a.H)) return cudaErrorInvalidValue;
  a.xs = scratch + p.xs;
  a.seg = scratch + p.seg;
  a.pa = scratch + p.pa;
  a.pb = scratch + p.pb;
  a.qkv = scratch + p.qkv;
  a.cq = scratch + p.cq;
  a.gelu = scratch + p.gelu;
  a.sink = reinterpret_cast<unsigned*>(scratch + p.sink);
  a.tickets = reinterpret_cast<int*>(scratch + p.tickets);
  a.n_split = row_splits(a.W);  // the window's rows split as D splits its live rows
  void* args[] = {&wmap, &a};
  err = cudaLaunchCooperativeKernel(kern, dim3(p.grid), dim3(THREADS), args, SMEM_BYTES,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instantiation's registers a thread, local memory bytes a thread,
// shared memory bytes a block, resident blocks an SM, ring stages and grid
// syncs a layer.
inline int probe_info(const void* kern, int* regs, int* local_bytes, int* smem_bytes, int* blocks_per_sm,
                      int* ring_stages, int* syncs_per_layer) {
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

}  // namespace
