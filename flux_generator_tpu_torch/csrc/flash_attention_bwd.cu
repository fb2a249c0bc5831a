// Flash-attention backward for Hopper (sm_90a): kernel E (dQ) and kernel F (dK,
// dV), wgmma fed by TMA rings.
//
// Replace the TPU kernels `_bwd_dq_kernel` (pallas_call at
// flux_generator_tpu/ops/pallas/flash_attention.py:438) and `_bwd_dkv_kernel`
// (:452), reached from `_flash_core_bwd` → `_bwd_core`. As there, RoPE is
// applied outside: both kernels take the ROTATED q and k, v, the output
// gradient dO, the forward's row logsumexp lse and dvec = rowsum(dO ∘ O),
// and compute, per (batch, head) with P = exp(q·kᵀ·scale − lse):
//   dP = dO · vᵀ,  dS = P ∘ (dP − dvec),
//   E: dQ = dS · k · scale              (a block per 128 query rows, loop over keys)
//   F: dK = dSᵀ · q · scale, dV = Pᵀ · dO (a block per 128 keys, loop over queries)
// Each output is accumulated in registers by the block that owns it and
// written once, as the two TPU passes accumulate along their innermost grid
// axis; the rows of a short last wave are summed from parts in a fixed order
// (see "The tail"). No output is accumulated with atomics, so a run is
// deterministic.
//
// Layout: q, k, v, dO, dQ, dK, dV (B, L, H, D) contiguous bf16 (q, k, v, dO
// 16-byte aligned: TMA), D in {64, 128}, any L; lse, dvec (B·H, L) f32. TMA
// fills rows past L with zeros; a key past L gets P = 0 in E, a query past L
// P = 0 in F (masked explicitly: a zero row has logit 0, and exp(0 − 0) is 1),
// and rows past L are not stored.
//
// Numerics, as the plain version: q·kᵀ and dO·vᵀ are bf16 products with f32
// accumulation; P = exp2(s·scale·log2 e − lse·log2 e) and dS are f32 and are
// rounded to bf16 to feed dS·k, Pᵀ·dO and dSᵀ·q (2⁻⁹ relative per term, the
// rounding kernel A applies to P before P·V); outputs are bf16 with the scale
// applied at the store.
//
// Bound: tensor-core throughput. At Flux-dev training's shape (L = 1536,
// H = 24, D = 128) E does 6·L²·D·H ≈ 43.5 GFLOP (three products: S, dP, dQ)
// and F 8·L²·D·H ≈ 58 GFLOP (S, dP, dV, dK), 0.044 and 0.059 ms at the bf16
// peak, against ~57 MB of traffic.
//
// Design, both kernels: a block of 384 threads. Warpgroup 0 is the producer
// (setmaxnreg 40); warpgroups 1 and 2 (setmaxnreg 232) each own 64 of the
// block's 128 rows and run every product with wgmma m64nNk16. Operands arrive
// by TMA over 4-D tensor maps (D, H, L, B) with a 128-byte swizzle
// (sm90_common.cuh): the rows a block owns once, the streamed tiles through
// rings with a full mbarrier (the copy's bytes) and an empty one (the 256
// consumer threads). The two consumer warpgroups take turns to issue their
// products (named barriers 1 and 2), so that one's exponentials run under the
// other's products.
//
// E: Q and dO (128 rows) once; K and V in tiles of 64 keys, each in its own
// ring. S = Q·Kᵀ and dP = dO·Vᵀ (both operands in shared memory, K and V the
// K-major B operand; m64n64) go out in one commit group, then dQ += dS_{j−1}·
// K_{j−1} in a second: dS from registers (the accumulator layout of two n8
// column groups is the A fragment of one k16 step, after rounding to bf16)
// and K as the MN-major B operand (m64nD). dS_j is formed while dQ's product
// of the tile before is in flight. Registers a consumer thread: dQ D/2, S and
// dP 32 each, dS's fragments 16. K_j is read by S_j and again by dQ_j an
// iteration later, so K's ring has three stages and V's two; a consumer
// thread reads its two rows' lse and dvec once. 144 KB of shared memory at D
// 128.
//
// F: K and V (128 keys) once; Q and dO in tiles of 64 queries through one
// ring of three stages, with their lse (·log2 e) and dvec rows, which the
// producer's first warp copies into shared memory (32 arrivals and the TMA
// bytes complete a stage). The keys are the MMA rows: Sᵀ = K·Qᵀ and dPᵀ =
// V·dOᵀ (m64n64, both operands in shared memory), Pᵀ and dSᵀ in registers,
// each thread reading the lse and dvec of its 16 query columns, then dV +=
// Pᵀ·dO and dK += dSᵀ·Q (A from registers, dO and Q the MN-major B operand,
// m64nD). Registers decide the query tile: at D 128 the dK and dV
// accumulators take 128 a thread and Sᵀ and dPᵀ 32 each, so 64 queries fit
// under 232 and 128 do not. 160 KB of shared memory at D 128.
//
// The tail: a block owns a unit (128 rows of one (batch, head)) and one block
// fits an SM, so at L 1536, B 1 and 24 heads each kernel has 288 units, 2.18
// waves of 132 SMs. Two fixes, both deterministic:
// - The units of a last wave that fills at most a fifth of the SMs run in
//   parts of their tile loop (the wrapper's split_plan: 24 units in 5 parts
//   of 4-5 tiles). Each part writes its f32 accumulators to `partial` (value
//   i of the 256 consumer threads together); the part that takes the last
//   ticket of its unit (atomicAdd) sums the unit's parts in part order and
//   stores, so the bits do not depend on which part finishes last.
// - F, which reads nothing E writes, may be launched as E's programmatic
//   dependent (`after_dq`): E's blocks allow it at their start, so F's first
//   blocks take the SMs that E's last round leaves idle, and every F block
//   waits for E's completion (griddepcontrol.wait) before it ends, so the
//   kernels after F still see dQ.
//
// No generic-proxy thread writes shared memory that TMA or wgmma reads (Q, K,
// V and dO arrive by TMA; P and dS stay in registers; outputs are stored from
// registers), so no fence.proxy.async is needed; the empty barriers order each
// stage's wgmma reads before TMA overwrites it.

#include <math.h>

#include "sm90_common.cuh"

namespace {

using fgt::bf16;
using namespace fgt::sm90;

constexpr int THREADS = 384;   // the producer warpgroup and two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int ROWS = 128;      // rows a block owns: queries in E, keys in F
constexpr float LOG2E = 1.4426950408889634f;
// setmaxnreg moves registers inside the block's allocation: the consumers'
// 232 and the producer's 40 must fit in what the block got at launch.
constexpr int REG_POOL = 128 * 40 + CONSUMERS * 232;

constexpr int E_BN = 64;       // keys a K/V tile of E
constexpr int E_KSTAGES = 3;   // K_j is read by S_j and by dQ_j one iteration later
constexpr int E_VSTAGES = 2;
constexpr int F_BQ = 64;       // queries a Q/dO tile of F
constexpr int F_STAGES = 3;

template <int D>
struct DqLayout {
  static constexpr int Q_BYTES = ROWS * D * 2;  // Q or dO
  static constexpr int KV_BYTES = E_BN * D * 2;  // one K or V tile
  static constexpr int O_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + E_KSTAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + E_VSTAGES * KV_BYTES;
  static constexpr int BARS = 1 + 2 * E_KSTAGES + 2 * E_VSTAGES;  // Q+dO; K full, empty; V full, empty
  // + slack to align the base to the 1024 bytes of a 128-byte swizzle atom
  static constexpr int ALLOC = BAR_OFF + BARS * 8 + 1024;
};

template <int D>
struct DkvLayout {
  static constexpr int KV_BYTES = ROWS * D * 2;  // K or V
  static constexpr int Q_BYTES = F_BQ * D * 2;   // one Q or dO tile
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int O_OFF = Q_OFF + F_STAGES * Q_BYTES;
  static constexpr int L_OFF = O_OFF + F_STAGES * Q_BYTES;      // lse·log2 e, [F_STAGES][F_BQ] f32
  static constexpr int DV_OFF = L_OFF + F_STAGES * F_BQ * 4;    // dvec, likewise
  static constexpr int BAR_OFF = DV_OFF + F_STAGES * F_BQ * 4;
  static constexpr int BARS = 1 + 2 * F_STAGES;  // K+V; full, empty
  static constexpr int ALLOC = BAR_OFF + BARS * 8 + 1024;
};

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// A block's work: the 128 rows of row block rb of (batch, head) bh, over the
// key (E) or query (F) tiles [t0, t1). Blocks below `full_blocks` take a whole
// unit (rb, bh) each; the rest split the remaining units into `chunks` parts of
// the tile loop each (split, the unit's index among them, −1 for a whole unit;
// chunk, the part).
struct Work {
  int bh, rb, t0, t1, split, chunk;
};

__device__ __forceinline__ Work work_of(int block, int row_blocks, int full_blocks, int chunks, int n_tiles) {
  int unit = block, chunk = 0, parts = 1;
  if (block >= full_blocks) {
    unit = full_blocks + (block - full_blocks) / chunks;
    chunk = (block - full_blocks) % chunks;
    parts = chunks;
  }
  return Work{unit / row_blocks, unit % row_blocks, chunk * n_tiles / parts, (chunk + 1) * n_tiles / parts,
              parts > 1 ? unit - full_blocks : -1, chunk};
}

// The 256 consumer threads (named barrier 3).
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 3, 256;\n" ::: "memory"); }

// A split unit's partial sums: every part writes its consumer threads' f32
// accumulators to partial[split][chunk], value i of the 256 threads together
// (coalesced).
template <int N>
__device__ __forceinline__ void write_partial(const float (&acc)[N], float* partial, int slot, int ctid) {
  float* out = partial + static_cast<int64_t>(slot) * N * CONSUMERS + ctid;
#pragma unroll
  for (int i = 0; i < N; ++i) __stcg(out + i * CONSUMERS, acc[i]);
}

// After write_partial: true in the part that finishes last (its ticket), which
// then sums the unit's parts with read_sum.
__device__ __forceinline__ bool last_part(int* ticket, int chunks, int ctid) {
  __shared__ int last;
  __threadfence();  // this part's partial sums before its ticket
  consumers_sync();
  if (ctid == 0) last = atomicAdd(ticket, 1) == chunks - 1;
  consumers_sync();
  if (!last) return false;
  __threadfence();
  return true;
}

// The sum of a split unit's parts in chunk order, so the result is the same
// whichever part finishes last.
template <int N>
__device__ __forceinline__ void read_sum(float (&acc)[N], const float* partial, int first_slot, int chunks, int ctid) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const float* in = partial + static_cast<int64_t>(first_slot + c) * N * CONSUMERS + ctid;
    float part[N];
#pragma unroll
    for (int i = 0; i < N; ++i) part[i] = __ldcg(in + i * CONSUMERS);
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += part[i];
  }
}

// dS = P ∘ (dP − dvec) in place of s (raw Q·Kᵀ of keys from k0), with this
// thread's rows' lse·log2 e and dvec; P = 0 for keys past L.
template <int N>
__device__ __forceinline__ void ds_rows(float (&s)[N], const float (&dp)[N], int k0, int L, int t, float sl2,
                                        float lb0, float lb1, float dv0, float dv1) {
  const bool edge = k0 + 2 * N > L;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float p = exp2f(fmaf(s[i], sl2, -((i & 2) ? lb1 : lb0)));
    if (edge && k0 + (i / 4) * 8 + t * 2 + (i & 1) >= L) p = 0.f;
    s[i] = p * (dp[i] - ((i & 2) ? dv1 : dv0));
  }
}

// Store a warpgroup's 64 × D accumulator (times `mul`) as bf16: this thread's
// rows r0 and r0 + 8, columns 8n + 2t and + 1.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, int64_t row_stride, const float (&acc)[D / 2], int r0,
                                           int L, int t, float mul) {
  if (r0 < L) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + r0 * row_stride + n * 8 + t * 2) =
          __floats2bfloat162_rn(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    }
  }
  if (r0 + 8 < L) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 8) * row_stride + n * 8 + t * 2) =
          __floats2bfloat162_rn(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
    }
  }
}

// ------------------------------------------------------------------ E: dQ

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                    const float* __restrict__ lse, const float* __restrict__ dvec, bf16* __restrict__ dq,
                    float* __restrict__ partial, int* __restrict__ tickets, int L, int H, float scale,
                    int full_blocks, int chunks) {
  using Lay = DqLayout<D>;
  constexpr int BOXES = D / BOX;  // TMA boxes (and 64-column swizzle atoms) in a row
  constexpr int KS = E_KSTAGES;
  constexpr int VS = E_VSTAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sO = base + Lay::O_OFF;
  const uint32_t sK = base + Lay::K_OFF;
  const uint32_t sV = base + Lay::V_OFF;
  const uint32_t bar_q = base + Lay::BAR_OFF;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto empty_k = [&](int s) { return bar_q + 8u * (1 + KS + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + 2 * KS + s); };
  auto empty_v = [&](int s) { return bar_q + 8u * (1 + 2 * KS + VS + s); };

  const Work w = work_of(blockIdx.x, (L + ROWS - 1) / ROWS, full_blocks, chunks, (L + E_BN - 1) / E_BN);
  const int bh = w.bh;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = w.rb * ROWS;
  const int n_tiles = w.t1 - w.t0;  // this block's key tiles, from tile w.t0
  const int wg = threadIdx.x / 128;

  griddep_launch_dependents();  // F reads nothing of E's: it may start once every block of E has

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < KS; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(empty_k(s), CONSUMERS);
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: Q and dO, then K_j and V_j in the order the consumers take them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full, uint32_t empty, int stages, int j) {
        mbar_wait(empty, ((j / stages) & 1) ^ 1);
        mbar_expect_tx(full, Lay::KV_BYTES);
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(ring + (j % stages) * Lay::KV_BYTES + x * E_BN * ROW_BYTES, map, full, x * BOX, h,
                      (w.t0 + j) * E_BN, b);
        }
      };
      mbar_expect_tx(bar_q, 2 * Lay::Q_BYTES);
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(sQ + x * ROWS * ROW_BYTES, &tm_q, bar_q, x * BOX, h, q0, b);
        tma_load_4d(sO + x * ROWS * ROW_BYTES, &tm_o, bar_q, x * BOX, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        load(&tm_k, sK, full_k(j % KS), empty_k(j % KS), KS, j);
        load(&tm_v, sV, full_v(j % VS), empty_v(j % VS), VS, j);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows [cw·64, cw·64 + 64) of the block.
  // Iteration j issues S_j, dP_j and dQ += dS_{j−1}·K_{j−1} together, forms
  // dS_j while the last is in flight, then rounds it into A fragments.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int my_turn = 1 + cw;
  const int other_turn = 2 - cw;

  const int r0 = q0 + cw * 64 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int r1 = r0 + 8;
  const float* lse_h = lse + static_cast<int64_t>(bh) * L;
  const float* dv_h = dvec + static_cast<int64_t>(bh) * L;
  const float lb0 = r0 < L ? lse_h[r0] * LOG2E : 0.f;
  const float lb1 = r1 < L ? lse_h[r1] * LOG2E : 0.f;
  const float dv0 = r0 < L ? dv_h[r0] : 0.f;
  const float dv1 = r1 < L ? dv_h[r1] : 0.f;
  const float sl2 = scale * LOG2E;  // logits → exp2 domain

  float acc[D / 2];  // dQ: column group n holds acc[4n..4n+3] (rows g, g + 8; columns 8n + 2t, + 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t q_rows = sQ + cw * 64 * ROW_BYTES;
  const uint32_t o_rows = sO + cw * 64 * ROW_BYTES;

  // S = Q·K_j^T and dP = dO·V_j^T: D/16 k16 steps, 32 bytes along a swizzled 128-byte row each
  auto issue_s_dp = [&](float (&s)[E_BN / 2], float (&dp)[E_BN / 2], int j) {
    const uint32_t k_tile = sK + (j % KS) * Lay::KV_BYTES;
    const uint32_t v_tile = sV + (j % VS) * Lay::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * ROWS * ROW_BYTES + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * E_BN * ROW_BYTES + (kk % 4) * 32;
      wgmma_ss_n64(s, desc_sw128(q_rows + a_off, 16, 1024), desc_sw128(k_tile + b_off, 16, 1024), kk > 0);
      wgmma_ss_n64(dp, desc_sw128(o_rows + a_off, 16, 1024), desc_sw128(v_tile + b_off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // dQ += dS·K_j: 16 keys a k16 step = two 8-row groups (SBO); the next 64
  // columns of D are the next box (LBO)
  auto issue_dq = [&](const uint32_t (&pa)[E_BN / 16][4], int j) {
    const uint32_t k_tile = sK + (j % KS) * Lay::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < E_BN / 16; ++kk) {
      wgmma_rs(acc, pa[kk], desc_sw128(k_tile + kk * 16 * ROW_BYTES, E_BN * ROW_BYTES, 1024));
    }
    wgmma_commit();
  };

  if (cw == 1) turn_arrive(1);  // warpgroup 1 lets warpgroup 0 issue first
  mbar_wait(bar_q, 0);
  float s[E_BN / 2], dp[E_BN / 2];
  uint32_t pa[E_BN / 16][4];

  mbar_wait(full_k(0), 0);
  mbar_wait(full_v(0), 0);
  turn_sync(my_turn);
  wgmma_fence();
  issue_s_dp(s, dp, 0);
  turn_arrive(other_turn);
  wgmma_wait0();
  fence_regs(s);
  fence_regs(dp);
  mbar_arrive(empty_v(0));
  ds_rows(s, dp, w.t0 * E_BN, L, t, sl2, lb0, lb1, dv0, dv1);
  pack_frag(s, pa);

  for (int j = 1; j < n_tiles; ++j) {
    mbar_wait(full_k(j % KS), (j / KS) & 1);
    mbar_wait(full_v(j % VS), (j / VS) & 1);
    turn_sync(my_turn);
    fence_regs(acc);
    wgmma_fence();
    issue_s_dp(s, dp, j);
    issue_dq(pa, j - 1);
    turn_arrive(other_turn);
    wgmma_wait1();  // S_j and dP_j
    fence_regs(s);
    fence_regs(dp);
    mbar_arrive(empty_v(j % VS));
    ds_rows(s, dp, (w.t0 + j) * E_BN, L, t, sl2, lb0, lb1, dv0, dv1);
    wgmma_wait0();  // dQ += dS_{j−1}·K_{j−1}
    fence_regs(acc);
    fence_regs(s);  // dS_j's fragments only once dS_{j−1}'s are read
    mbar_arrive(empty_k((j - 1) % KS));
    pack_frag(s, pa);
  }

  turn_sync(my_turn);
  fence_regs(acc);
  wgmma_fence();
  issue_dq(pa, n_tiles - 1);
  if (cw == 0) turn_arrive(other_turn);  // warpgroup 0's last turn; warpgroup 1 has none left to give
  wgmma_wait0();
  fence_regs(acc);

  if (w.split >= 0) {  // a part of a split unit: the last part sums them and stores
    const int ctid = threadIdx.x - 128;
    write_partial(acc, partial, w.split * chunks + w.chunk, ctid);
    if (!last_part(tickets + w.split, chunks, ctid)) return;
    read_sum(acc, partial, w.split * chunks, chunks, ctid);
  }
  const int64_t row_stride = static_cast<int64_t>(H) * D;
  store_rows<D>(dq + (static_cast<int64_t>(b) * L * H + h) * D, row_stride, acc, r0, L, t, scale);
}

// ------------------------------------------------------------------ F: dK, dV

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                     const float* __restrict__ lse, const float* __restrict__ dvec, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, float* __restrict__ partial, int* __restrict__ tickets, int L, int H,
                     float scale, int full_blocks, int chunks) {
  using Lay = DkvLayout<D>;
  constexpr int BOXES = D / BOX;
  constexpr int S = F_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* sL = reinterpret_cast<float*>(smem_raw + (base - raw) + Lay::L_OFF);
  float* sD = reinterpret_cast<float*>(smem_raw + (base - raw) + Lay::DV_OFF);
  const uint32_t sK = base;
  const uint32_t sV = base + Lay::V_OFF;
  const uint32_t sQ = base + Lay::Q_OFF;
  const uint32_t sO = base + Lay::O_OFF;
  const uint32_t bar_kv = base + Lay::BAR_OFF;
  auto full = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8u * (1 + S + s); };

  const Work w = work_of(blockIdx.x, (L + ROWS - 1) / ROWS, full_blocks, chunks, (L + F_BQ - 1) / F_BQ);
  const int bh = w.bh;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = w.rb * ROWS;
  const int n_tiles = w.t1 - w.t0;  // this block's query tiles, from tile w.t0
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 32);  // the producer's first warp: its lse/dvec rows, then lane 0's TMA bytes
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: K and V, then the Q/dO tiles with their lse and dvec rows
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lse_h = lse + static_cast<int64_t>(bh) * L;
      const float* dv_h = dvec + static_cast<int64_t>(bh) * L;
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * Lay::KV_BYTES);
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(sK + x * ROWS * ROW_BYTES, &tm_k, bar_kv, x * BOX, h, k0, b);
          tma_load_4d(sV + x * ROWS * ROW_BYTES, &tm_v, bar_kv, x * BOX, h, k0, b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        mbar_wait(empty(s), ((j / S) & 1) ^ 1);
        for (int r = lane; r < F_BQ; r += 32) {
          const int row = (w.t0 + j) * F_BQ + r;
          sL[s * F_BQ + r] = row < L ? lse_h[row] * LOG2E : 0.f;
          sD[s * F_BQ + r] = row < L ? dv_h[row] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * Lay::Q_BYTES);
          for (int x = 0; x < BOXES; ++x) {
            const int row = (w.t0 + j) * F_BQ;
            tma_load_4d(sQ + s * Lay::Q_BYTES + x * F_BQ * ROW_BYTES, &tm_q, full(s), x * BOX, h, row, b);
            tma_load_4d(sO + s * Lay::Q_BYTES + x * F_BQ * ROW_BYTES, &tm_o, full(s), x * BOX, h, row, b);
          }
        } else {
          mbar_arrive(full(s));
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns keys [cw·64, cw·64 + 64) of the block. Per
  // query tile: Sᵀ and dPᵀ, then Pᵀ and dSᵀ in registers, then dV and dK.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int my_turn = 1 + cw;
  const int other_turn = 2 - cw;
  const float sl2 = scale * LOG2E;

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const uint32_t k_rows = sK + cw * 64 * ROW_BYTES;
  const uint32_t v_rows = sV + cw * 64 * ROW_BYTES;

  if (cw == 1) turn_arrive(1);
  mbar_wait(bar_kv, 0);
  float st[F_BQ / 2], dpt[F_BQ / 2];
  uint32_t pa[F_BQ / 16][4], da[F_BQ / 16][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % S;
    const uint32_t q_tile = sQ + s * Lay::Q_BYTES;
    const uint32_t o_tile = sO + s * Lay::Q_BYTES;
    mbar_wait(full(s), (j / S) & 1);
    const float* lrow = sL + s * F_BQ;
    const float* drow = sD + s * F_BQ;
    const int c0 = (w.t0 + j) * F_BQ;
    const bool edge = c0 + F_BQ > L;

    // Sᵀ = K·Q_jᵀ and dPᵀ = V·dO_jᵀ: this warpgroup's 64 keys as rows
    turn_sync(my_turn);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * ROWS * ROW_BYTES + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * F_BQ * ROW_BYTES + (kk % 4) * 32;
      wgmma_ss_n64(st, desc_sw128(k_rows + a_off, 16, 1024), desc_sw128(q_tile + b_off, 16, 1024), kk > 0);
      wgmma_ss_n64(dpt, desc_sw128(v_rows + a_off, 16, 1024), desc_sw128(o_tile + b_off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    turn_arrive(other_turn);
    wgmma_wait0();
    fence_regs(st);
    fence_regs(dpt);

    // Pᵀ and dSᵀ with the lse and dvec of each element's query column; P = 0
    // for queries past L
#pragma unroll
    for (int n = 0; n < F_BQ / 8; ++n) {
      const float2 lb = *reinterpret_cast<const float2*>(lrow + 8 * n + 2 * t);
      const float2 dd = *reinterpret_cast<const float2*>(drow + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        float p = exp2f(fmaf(st[i], sl2, -((e & 1) ? lb.y : lb.x)));
        if (edge && c0 + 8 * n + 2 * t + (e & 1) >= L) p = 0.f;
        dpt[i] = p * (dpt[i] - ((e & 1) ? dd.y : dd.x));
        st[i] = p;
      }
    }
    pack_frag(st, pa);
    pack_frag(dpt, da);

    // dV += Pᵀ·dO_j and dK += dSᵀ·Q_j: dO and Q the MN-major B operand
    turn_sync(my_turn);
    fence_regs(acc_v);
    fence_regs(acc_k);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F_BQ / 16; ++kk) {
      wgmma_rs(acc_v, pa[kk], desc_sw128(o_tile + kk * 16 * ROW_BYTES, F_BQ * ROW_BYTES, 1024));
    }
#pragma unroll
    for (int kk = 0; kk < F_BQ / 16; ++kk) {
      wgmma_rs(acc_k, da[kk], desc_sw128(q_tile + kk * 16 * ROW_BYTES, F_BQ * ROW_BYTES, 1024));
    }
    wgmma_commit();
    if (j + 1 < n_tiles || cw == 0) turn_arrive(other_turn);  // warpgroup 1's last turn has no taker
    wgmma_wait0();
    fence_regs(acc_v);
    fence_regs(acc_k);
    mbar_arrive(empty(s));
  }

  if (w.split >= 0) {  // a part of a split unit: the last part sums them and stores
    const int ctid = threadIdx.x - 128;
    const int64_t half = static_cast<int64_t>(gridDim.x - full_blocks) * CONSUMERS * (D / 2);  // dK's parts, then dV's
    write_partial(acc_k, partial, w.split * chunks + w.chunk, ctid);
    write_partial(acc_v, partial + half, w.split * chunks + w.chunk, ctid);
    if (!last_part(tickets + w.split, chunks, ctid)) {
      griddep_wait();
      return;
    }
    read_sum(acc_k, partial, w.split * chunks, chunks, ctid);
    read_sum(acc_v, partial + half, w.split * chunks, chunks, ctid);
  }
  const int64_t row_stride = static_cast<int64_t>(H) * D;
  const int64_t head_off = (static_cast<int64_t>(b) * L * H + h) * D;
  const int r0 = k0 + cw * 64 + warp * 16 + g;
  store_rows<D>(dk + head_off, row_stride, acc_k, r0, L, t, scale);
  store_rows<D>(dv + head_off, row_stride, acc_v, r0, L, t, 1.f);
  griddep_wait();  // launched after E: end only once E has, so the kernels after F see dQ
}

// The kernel's dynamic shared memory, once its registers are known to take
// setmaxnreg's 40/232 split (else the consumers' setmaxnreg.inc would wait
// forever).
template <typename Kernel>
cudaError_t set_up(Kernel kernel, int smem) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * THREADS < REG_POOL) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// q, k, v, dO as tensor maps with boxes of `q_rows` rows (q, dO) and `k_rows`
// rows (k, v).
bool encode_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v, const void* dout, int B,
                 int L, int H, int D, int q_rows, int k_rows) {
  return encode_map(&maps[0], q, B, L, H, D, q_rows) && encode_map(&maps[1], k, B, L, H, D, k_rows) &&
         encode_map(&maps[2], v, B, L, H, D, k_rows) && encode_map(&maps[3], dout, B, L, H, D, q_rows);
}

// Blocks of a launch: `full_blocks` whole units, then the other units of
// (L / 128 row blocks) × B·H in `chunks` parts each.
int grid_blocks(int B, int L, int H, int full_blocks, int chunks) {
  const int units = (L + ROWS - 1) / ROWS * B * H;
  return full_blocks + (units - full_blocks) * chunks;
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* dvec, bf16* dq, float* partial, int* tickets, int B, int L, int H, float scale,
                      int full_blocks, int chunks, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = set_up(flash_bwd_dq_kernel<D>, DqLayout<D>::ALLOC);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  CUtensorMap m[4];
  if (!encode_maps(m, q, k, v, dout, B, L, H, D, ROWS, E_BN)) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<D><<<grid_blocks(B, L, H, full_blocks, chunks), THREADS, DqLayout<D>::ALLOC, stream>>>(
      m[0], m[1], m[2], m[3], lse, dvec, dq, partial, tickets, L, H, scale, full_blocks, chunks);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* dvec, bf16* dk, bf16* dv, float* partial, int* tickets, int B, int L, int H,
                       float scale, int full_blocks, int chunks, bool after_dq, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = set_up(flash_bwd_dkv_kernel<D>, DkvLayout<D>::ALLOC);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  CUtensorMap m[4];
  if (!encode_maps(m, q, k, v, dout, B, L, H, D, F_BQ, ROWS)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_blocks(B, L, H, full_blocks, chunks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = DkvLayout<D>::ALLOC;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = after_dq ? 1 : 0;
  void* args[] = {&m[0], &m[1], &m[2], &m[3], &lse, &dvec, &dk, &dv, &partial, &tickets, &L, &H, &scale,
                  &full_blocks, &chunks};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(flash_bwd_dkv_kernel<D>), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t info(Kernel kernel, int smem, int* regs, int* spill_bytes, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *spill_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = smem + static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS, smem);
}

// The split plan must cover every unit once: whole units first, the rest in
// parts of at least one tile each.
bool bad_args(int B, int L, int H, int full_blocks, int chunks, int n_tiles, const void* partial,
              const void* tickets) {
  if (B <= 0 || L <= 0 || H <= 0) return true;
  const int64_t units = static_cast<int64_t>((L + ROWS - 1) / ROWS) * B * H;
  if (units > (1 << 30) || full_blocks < 0 || full_blocks > units || chunks < 1 || chunks > n_tiles) return true;
  return full_blocks < units && chunks > 1 && (partial == nullptr || tickets == nullptr);
}

}  // namespace

// q, k (rotated), v, dout, dq: (B, L, H, D) contiguous bf16, q, k, v and dout
// 16-byte aligned (TMA); lse, dvec: (B·H, L) f32. The units (128-row blocks of
// one (batch, head)) past the first `full_blocks` run in `chunks` parts of the
// key loop each, when chunks > 1: their f32 partial sums go to `partial`
// ((units − full_blocks)·chunks·256·D/2 f32, 16-byte aligned) and `tickets`
// (units − full_blocks int32, zero) counts the parts done. Returns a
// cudaError_t: cudaErrorInvalidValue also when a tensor map cannot be encoded.
extern "C" int fgt_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                          const void* lse, const void* dvec, void* dq, void* partial, void* tickets,
                                          int B, int L, int H, int D, float scale, int full_blocks, int chunks,
                                          void* stream) {
  if (bad_args(B, L, H, full_blocks, chunks, (L + E_BN - 1) / E_BN, partial, tickets)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* lb = static_cast<const float*>(lse);
  const float* db = static_cast<const float*>(dvec);
  bf16* out = static_cast<bf16*>(dq);
  float* pb = static_cast<float*>(partial);
  int* tb = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return static_cast<int>(
        launch_dq<128>(q, k, v, dout, lb, db, out, pb, tb, B, L, H, scale, full_blocks, chunks, st));
  }
  if (D == 64) {
    return static_cast<int>(
        launch_dq<64>(q, k, v, dout, lb, db, out, pb, tb, B, L, H, scale, full_blocks, chunks, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above, writing dk and dv: (B, L, H, D) contiguous bf16, the split units
// in parts of the query loop (`partial` holds dK's parts, then dV's: twice
// E's size). With after_dq set, the launch is the programmatic dependent of
// the kernel before it on the stream, which must be E on the same inputs (see
// "The tail" above).
extern "C" int fgt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                           const void* lse, const void* dvec, void* dk, void* dv, void* partial,
                                           void* tickets, int B, int L, int H, int D, float scale, int full_blocks,
                                           int chunks, int after_dq, void* stream) {
  if (bad_args(B, L, H, full_blocks, chunks, (L + F_BQ - 1) / F_BQ, partial, tickets)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* lb = static_cast<const float*>(lse);
  const float* db = static_cast<const float*>(dvec);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  float* pb = static_cast<float*>(partial);
  int* tb = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return static_cast<int>(launch_dkv<128>(q, k, v, dout, lb, db, dkb, dvb, pb, tb, B, L, H, scale, full_blocks,
                                            chunks, after_dq, st));
  }
  if (D == 64) {
    return static_cast<int>(launch_dkv<64>(q, k, v, dout, lb, db, dkb, dvb, pb, tb, B, L, H, scale, full_blocks,
                                           chunks, after_dq, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel E (which 0) or F (which 1) at head dim D: registers a thread at launch
// (before setmaxnreg), local memory (spills) a thread, shared memory a block
// and blocks an SM.
extern "C" int fgt_flash_bwd_info(int D, int which, int* regs, int* spill_bytes, int* smem_bytes,
                                  int* blocks_per_sm) {
  if (which == 0 && D == 128) {
    return static_cast<int>(info(flash_bwd_dq_kernel<128>, DqLayout<128>::ALLOC, regs, spill_bytes, smem_bytes,
                                 blocks_per_sm));
  }
  if (which == 0 && D == 64) {
    return static_cast<int>(info(flash_bwd_dq_kernel<64>, DqLayout<64>::ALLOC, regs, spill_bytes, smem_bytes,
                                 blocks_per_sm));
  }
  if (which == 1 && D == 128) {
    return static_cast<int>(info(flash_bwd_dkv_kernel<128>, DkvLayout<128>::ALLOC, regs, spill_bytes,
                                 smem_bytes, blocks_per_sm));
  }
  if (which == 1 && D == 64) {
    return static_cast<int>(info(flash_bwd_dkv_kernel<64>, DkvLayout<64>::ALLOC, regs, spill_bytes, smem_bytes,
                                 blocks_per_sm));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
