// Flash-attention forward in bf16 for Hopper (sm_90a): wgmma, a TMA ring, RoPE
// applied once. Kernel A's bf16 mode; A's int8 tiers stay in flash_attention.cu.
//
// Replaces the bf16 tier of the TPU kernels `_attn_kernel` (one-shot, pallas_call
// at flux_generator_tpu/ops/pallas/flash_attention.py:258) and `_flash_kernel`
// (K/V streamed, :292). One kernel with a loop over K/V tiles takes any length.
//
// Computes, per (batch, head): O = softmax(q · k^T · scale) · v over (B, L, H, D)
// bf16 tensors, D in {64, 128}, and the row logsumexp (B·H, L) in f32 that the
// backward (kernels E and F) reads. Numerics as the plain version: Q·K^T
// accumulates in f32, the softmax is f32 with the scale folded into exp2, P is
// rounded to bf16 before P·V, and O is divided by the f32 row sum at the end;
// lse = m·scale + log l.
//
// RoPE: `rope_rotate_kernel` rotates q and k once, before the attention kernel,
// into scratch the wrapper allocates: interleaved pairs (2i, 2i+1) in f32 with
// bf16 tables (B, L, D/2) shared by all heads, each product and sum rounded on
// its own (no contraction into an FMA, as the plain version), then rounded to
// bf16. It is the JAX wrapper's pre-rotation (flash_attention.py:581-604), which
// the earlier kernel did inside every query block: at L 16640 each head's K was
// rotated 130 times. The pre-pass moves 4·B·L·H·D·2 bytes (and the tables): about
// 0.4 GB at L 16640, 31 MB at L 1280.
//
// Bound: tensor-core throughput. One call is 4·L²·D·H operations (Q·K^T and
// P·V): 3.40 TFLOP at the Flux 2048² shape (L 16640, H 24, D 128), 3.44 ms at the
// bf16 peak of 989 TFLOP/s, against 409 MB of q/k/v/o traffic (0.12 ms).
//
// Design: a persistent kernel. A tile is 128 query rows of one (batch, head);
// the grid is min(tiles, SMs) CTAs of three warpgroups, one CTA an SM, and CTA
// c takes tiles c, c + G, c + 2G, … (a static schedule: every tile has the same
// ⌈L/128⌉ key tiles), tile i being row block i % ⌈L/128⌉ of (batch, head)
// i / ⌈L/128⌉, so that the row blocks running at once share their heads' K and
// V in L2. Warpgroup 0 is the producer: it gives up registers (setmaxnreg 40)
// and one of its threads issues every copy with TMA (cp.async.bulk.tensor, 4-D
// tensor maps over (D, H, L, B), 128-byte swizzle, boxes of 64 values × 128
// rows, so a D 128 row is two boxes): per tile Q, into one of two buffers, then
// 128-key K and V tiles, each into its own ring of STAGES stages with a full
// mbarrier (the copy's bytes) and an empty one (the 256 consumer threads),
// K_{j+1} before V_j, the order they are consumed. The rings' stages and
// phases and the Q buffers' run on from tile to tile, so the next tile's Q and
// K_0 arrive while the current tile runs. TMA fills rows past L with zeros;
// keys past L are masked to −inf and query rows past L are not stored.
// Warpgroups 1 and 2 (setmaxnreg 232) each own 64 query rows of a tile: S =
// Q·K^T is wgmma m64n128k16 with both operands in shared memory (K's rows are
// D-contiguous, the K-major B operand); the online softmax runs on S in
// registers (row max and sum across the four lanes of a quad); O += P·V is
// wgmma m64nDk16 with P from registers (the f32 accumulator layout of two n8
// column groups is the A fragment of one k16 step, after rounding to bf16) and
// V from shared memory as the MN-major (transposed) B operand. Two overlaps
// keep the tensor cores fed while the softmax runs: a warpgroup issues S_j =
// Q·K_j^T and P_{j−1}·V_{j−1} together and runs S_j's softmax while
// P_{j−1}·V_{j−1} is in flight (O is rescaled once it lands), and the two
// warpgroups take turns to issue (named barriers 1 and 2), so that one's
// softmax overlaps the other's products. The turns run on across tiles (only
// warpgroup 1's last turn of the CTA's last tile is not handed on), so one
// warpgroup's epilogue overlaps the other's last product and its own next
// tile's first. The epilogue divides O by the row sum as the reciprocal's
// product with one FMA correction (`div_by`), writes it to the warpgroup's
// 64 rows of the tile's own Q buffer, which its last S has finished reading,
// in the 128-byte swizzled layout, and one thread stores it with TMA
// (fence.proxy.async before, a named barrier of the warpgroup between); the
// store runs while the next tile starts, and the buffer goes back to the
// producer (its empty barrier, one arrival a warpgroup) once the store has
// read it. lse is stored from registers. Shared memory: 193 KB at D 128 (Q
// twice, K and V two stages each), 97 KB at D 64; one CTA an SM (registers).
// Against the earlier grid of one block a tile (PERF.md), a tile pays a tile
// boundary (~1.6 key tiles) instead of a block's prologue and epilogue (2.8-4.0
// key tiles at D 128). Where the last round of tiles is part-empty, the tiles
// are not split over the idle SMs: the refitted cost model gives a split (and a
// merge of ~2.2 key tiles) at most 10% at L 1536 and 1000, 25% at 6 heads of
// L 1280, none at the 512² and 2048² request shapes (PERF.md). Head dim 64 has
// a three-warpgroup kernel of its own for heads of many key tiles
// (flash_fwd_d64_kernel, below: persistent too, its last part-empty round
// split over keys). The mbarrier, TMA, wgmma and tensor-map
// helpers are in sm90_common.cuh, shared with kernels E and F
// (flash_attention_bwd.cu).

#include <math.h>

#include "sm90_common.cuh"

namespace {

using fgt::bf16;
using namespace fgt::sm90;

constexpr int BM = 128;      // query rows a tile: two consumer warpgroups of 64
constexpr int BN = 128;      // keys a K/V tile
constexpr int STAGES = 2;    // K/V tiles in flight
constexpr int THREADS = 384; // the producer warpgroup and two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int Q_BYTES = BM * D * 2;   // one Q buffer (two: the next tile's Q comes in early)
  static constexpr int KV_BYTES = BN * D * 2;  // one K or one V tile
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // Q full, Q empty [2]; K full, V full, K empty, V empty [STAGES]
  static constexpr int BARS = 4 + 4 * STAGES;
  // + slack to align the base to the 1024 bytes of a 128-byte swizzle atom
  static constexpr int ALLOC = BAR_OFF + BARS * 8 + 1024;
};

// Rotates one 16-byte chunk (four interleaved pairs) with its tables' four
// (cos, sin) values; products and sums rounded one at a time.
__device__ __forceinline__ uint4 rotate_chunk(uint4 x, uint2 cv, uint2 sv) {
  const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&cv);
  const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&sv);
  __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float e = __low2float(x2[j]);
    const float o = __high2float(x2[j]);
    const float c = (j & 1) ? __high2float(c2[j >> 1]) : __low2float(c2[j >> 1]);
    const float s = (j & 1) ? __high2float(s2[j >> 1]) : __low2float(s2[j >> 1]);
    x2[j] = __floats2bfloat162_rn(__fsub_rn(__fmul_rn(e, c), __fmul_rn(o, s)),
                                  __fadd_rn(__fmul_rn(e, s), __fmul_rn(o, c)));
  }
  return x;
}

// The RoPE pre-pass: one 16-byte chunk of q and of k a thread, over (B, L, H, D)
// with (B, L, D/2) tables.
template <int D>
__global__ void __launch_bounds__(256)
rope_rotate_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ cos,
                   const bf16* __restrict__ sin, bf16* __restrict__ qr, bf16* __restrict__ kr, int H,
                   int64_t chunks) {
  constexpr int CHUNKS = D / 8;  // a row's 16-byte chunks
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= chunks) return;
  const int c = static_cast<int>(idx % CHUNKS);
  const int64_t bl = idx / CHUNKS / H;  // b·L + l
  const int64_t tab = bl * (D / 2) + c * 4;
  const uint2 cv = *reinterpret_cast<const uint2*>(cos + tab);
  const uint2 sv = *reinterpret_cast<const uint2*>(sin + tab);
  reinterpret_cast<uint4*>(qr)[idx] = rotate_chunk(reinterpret_cast<const uint4*>(q)[idx], cv, sv);
  reinterpret_cast<uint4*>(kr)[idx] = rotate_chunk(reinterpret_cast<const uint4*>(k)[idx], cv, sv);
}

// a / b from r = 1/b (correctly rounded) and one FMA correction (Markstein's:
// the quotient to the last bit but in rare cases)
__device__ __forceinline__ float div_by(float a, float b, float r) {
  const float q = a * r;
  return fmaf(fmaf(-q, b, a), r, q);
}

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one logit tile (raw Q·K^T, keys from k0) in place: masks keys
// past L, updates this thread's rows' running max and sum, leaves p = exp2((s −
// m)·scale·log2 e) in sc and returns each row's rescale factor α. exp2 is
// `ex2.approx.ftz` (0.2-0.9% faster a call at head dim 128 than the library's
// exp2f, whose range test and two multiplies serve subnormal results, and 5% at
// head dim 64; PERF.md).
template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], int k0, int L, int t, float sl2, float& m0,
                                             float& m1, float& l0, float& l1, float& alpha0, float& alpha1) {
  if (k0 + 2 * N > L) {  // keys past the real length
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (k0 + (i / 4) * 8 + t * 2 + (i & 1) >= L) sc[i] = -INFINITY;
    }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  alpha0 = ex2_ftz((m0 - mx0) * sl2);  // 0 at the first tile (m = −inf)
  alpha1 = ex2_ftz((m1 - mx1) * sl2);
  m0 = mx0;
  m1 = mx1;
  const float mb0 = mx0 * sl2;
  const float mb1 = mx1 * sl2;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    sc[i] = ex2_ftz(fmaf(sc[i], sl2, -mb0));
    sc[i + 1] = ex2_ftz(fmaf(sc[i + 1], sl2, -mb0));
    sc[i + 2] = ex2_ftz(fmaf(sc[i + 2], sl2, -mb1));
    sc[i + 3] = ex2_ftz(fmaf(sc[i + 3], sl2, -mb1));
    rs0 += sc[i] + sc[i + 1];
    rs1 += sc[i + 2] + sc[i + 3];
  }
  l0 = l0 * alpha0 + rs0;
  l1 = l1 * alpha1 + rs1;
}

// A tile is 128 query rows of one (batch, head); tile i is row block i % rb of
// (batch, head) i / rb, rb = ⌈L/128⌉, so a head's row blocks are adjacent and
// share its K and V in L2. CTA c of a grid of G takes tiles c, c + G, c + 2G, …
// (a static schedule: every tile costs the same ⌈L/128⌉ key tiles).
__device__ __forceinline__ void tile_coords(int tile, int row_blocks, int H, int& bh, int& b, int& h, int& q0) {
  bh = tile / row_blocks;
  q0 = (tile - bh * row_blocks) * BM;
  b = bh / H;
  h = bh - b * H;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                      float* __restrict__ lse, int L, int H, int row_blocks, int tiles, float scale) {
  using Lay = Layout<D>;
  constexpr int BOXES = D / BOX;  // TMA boxes (and 64-column swizzle atoms) in a row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;  // two buffers of Q_BYTES
  const uint32_t sK = base + Lay::K_OFF;
  const uint32_t sV = base + Lay::V_OFF;
  const uint32_t bars = base + Lay::BAR_OFF;
  auto full_q = [&](int qb) { return bars + 8u * qb; };
  auto empty_q = [&](int qb) { return bars + 8u * (2 + qb); };
  auto full_k = [&](int s) { return bars + 8u * (4 + s); };
  auto full_v = [&](int s) { return bars + 8u * (4 + STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8u * (4 + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8u * (4 + 3 * STAGES + s); };

  const int n_tiles = (L + BN - 1) / BN;  // key tiles a tile
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(full_q(qb), 1);
      mbar_init(empty_q(qb), 2);  // one thread of each consumer warpgroup
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), CONSUMERS);
      mbar_init(empty_v(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K/V tile g of this CTA's run (all its tiles' key tiles in order) sits in
  // ring stage g % STAGES; the rings' phases carry from tile to tile, and so
  // do the two Q buffers' (tile number i of the CTA in buffer i & 1).
  if (wg == 0) {  // producer: per tile Q, then K_0, then K_{j+1} before V_j, the order the consumers take them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int bh, b, h, q0;
      int g = 0;  // K/V tiles requested so far
      auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full, uint32_t empty, int gi, int j) {
        mbar_wait(empty, ((gi / STAGES) & 1) ^ 1);
        mbar_expect_tx(full, Lay::KV_BYTES);
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(ring + (gi % STAGES) * Lay::KV_BYTES + x * BN * ROW_BYTES, map, full, x * BOX, h, j * BN, b);
        }
      };
      int i = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
        tile_coords(tile, row_blocks, H, bh, b, h, q0);
        const int qb = i & 1;
        mbar_wait(empty_q(qb), ((i >> 1) & 1) ^ 1);  // tile i − 2's O has left the buffer
        mbar_expect_tx(full_q(qb), Lay::Q_BYTES);
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(sQ + qb * Lay::Q_BYTES + x * BM * ROW_BYTES, &tm_q, full_q(qb), x * BOX, h, q0, b);
        }
        load(&tm_k, sK, full_k(g % STAGES), empty_k(g % STAGES), g, 0);
        for (int j = 0; j < n_tiles; ++j) {
          if (j + 1 < n_tiles) load(&tm_k, sK, full_k((g + 1) % STAGES), empty_k((g + 1) % STAGES), g + 1, j + 1);
          load(&tm_v, sV, full_v(g % STAGES), empty_v(g % STAGES), g, j);
          ++g;
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows [cw·64, cw·64 + 64) of each tile.
  // Iteration j issues S_j = Q·K_j^T and O += P_{j−1}·V_{j−1} together, then
  // runs the softmax of S_j while P_{j−1}·V_{j−1} is in flight; the two
  // warpgroups take turns to issue, so one's softmax overlaps the other's
  // products, and the turns run on from tile to tile, so one's epilogue
  // overlaps the other's last product and its next tile's first.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g8 = lane >> 2;
  const int t = lane & 3;
  const int my_turn = 1 + cw;
  const int other_turn = 2 - cw;
  const float sl2 = scale * LOG2E;  // logits → exp2 domain
  const int wg_bar = 3 + cw;        // this warpgroup's own named barrier

  float acc[D / 2];  // O: column group n holds acc[4n..4n+3] (rows g8, g8 + 8; columns 8n + 2t, + 1)
  float sc[BN / 2];
  uint32_t pa[BN / 16][4];
  uint32_t q_rows;

  // S = Q·K_g^T: D/16 k16 steps, 32 bytes along a swizzled 128-byte row each
  auto issue_s = [&](int gi) {
    const uint32_t k_tile = sK + (gi % STAGES) * Lay::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da = desc_sw128(q_rows + (kk / 4) * BM * ROW_BYTES + (kk % 4) * 32, 16, 1024);
      const uint64_t db = desc_sw128(k_tile + (kk / 4) * BN * ROW_BYTES + (kk % 4) * 32, 16, 1024);
      wgmma_ss_n128(sc, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // O += P·V_g: 16 keys a k16 step = two 8-row groups (SBO); the next 64
  // columns of D are the next box (LBO)
  auto issue_pv = [&](int gi) {
    const uint32_t v_tile = sV + (gi % STAGES) * Lay::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      wgmma_rs(acc, pa[kk], desc_sw128(v_tile + kk * 16 * ROW_BYTES, BN * ROW_BYTES, 1024));
    }
    wgmma_commit();
  };

  if (cw == 1) turn_arrive(1);  // warpgroup 1 lets warpgroup 0 issue first
  int g = 0;                    // K/V tiles consumed so far
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
    int bh, b, h, q0;
    tile_coords(tile, row_blocks, H, bh, b, h, q0);
    const bool last_tile = tile + static_cast<int>(gridDim.x) >= tiles;
    const int qb = i & 1;
    q_rows = sQ + qb * Lay::Q_BYTES + cw * 64 * ROW_BYTES;
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g8 and g8 + 8 (unscaled logits)
    float l0 = 0.f, l1 = 0.f;              // this thread's share of their running sums
    float alpha0, alpha1;

    mbar_wait(full_q(qb), (i >> 1) & 1);
    mbar_wait(full_k(g % STAGES), (g / STAGES) & 1);
    turn_sync(my_turn);
    wgmma_fence();
    issue_s(g);
    turn_arrive(other_turn);
    wgmma_wait0();
    fence_regs(sc);
    mbar_arrive(empty_k(g % STAGES));
    softmax_tile(sc, 0, L, t, sl2, m0, m1, l0, l1, alpha0, alpha1);
    pack_frag(sc, pa);
    // the previous tile's O, staged in the other Q buffer, has been read out
    if (i > 0 && tid == 0) {
      bulk_wait_read<0>();
      mbar_arrive(empty_q(qb ^ 1));
    }

    for (int j = 1; j < n_tiles; ++j) {
      const int gk = g + j, gv = g + j - 1;
      mbar_wait(full_k(gk % STAGES), (gk / STAGES) & 1);
      mbar_wait(full_v(gv % STAGES), (gv / STAGES) & 1);
      turn_sync(my_turn);
      fence_regs(acc);
      wgmma_fence();
      issue_s(gk);
      issue_pv(gv);
      turn_arrive(other_turn);
      wgmma_wait1();  // S_j
      fence_regs(sc);
      mbar_arrive(empty_k(gk % STAGES));
      softmax_tile(sc, j * BN, L, t, sl2, m0, m1, l0, l1, alpha0, alpha1);
      wgmma_wait0();  // P_{j−1}·V_{j−1}
      fence_regs(acc);
      fence_regs(sc);  // P_j's fragments only once P_{j−1}'s are read
      mbar_arrive(empty_v(gv % STAGES));
#pragma unroll
      for (int x = 0; x < D / 2; ++x) acc[x] *= (x & 2) ? alpha1 : alpha0;
      pack_frag(sc, pa);
    }

    const int gl = g + n_tiles - 1;
    mbar_wait(full_v(gl % STAGES), (gl / STAGES) & 1);
    turn_sync(my_turn);
    fence_regs(acc);
    wgmma_fence();
    issue_pv(gl);
    // warpgroup 1's last turn of the CTA's last tile has no one left to give it to
    if (cw == 0 || !last_tile) turn_arrive(other_turn);
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(empty_v(gl % STAGES));
    g += n_tiles;

    // Epilogue: O / l into this warpgroup's 64 rows of the Q buffer (its
    // products are done with them), 128-byte swizzled as TMA reads it, then
    // one thread stores them with TMA; the store runs on while the next tile
    // starts. lse from registers.
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    const int rr = warp * 16 + g8;  // this thread's first row in the warpgroup's 64; rr & 7 == g8
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      // column group n: box n / 8, 16-byte chunk n % 8 of the row, swizzled by the row's place in its 8
      const uint32_t at = q_rows + (n / 8) * BM * ROW_BYTES + rr * ROW_BYTES + (((n % 8) ^ g8) << 4) + t * 4;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                   "r"(fgt::pack_bf16x2(div_by(acc[4 * n], l0, i0), div_by(acc[4 * n + 1], l0, i0)))
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * ROW_BYTES),
                   "r"(fgt::pack_bf16x2(div_by(acc[4 * n + 2], l1, i1), div_by(acc[4 * n + 3], l1, i1)))
                   : "memory");
    }
    fence_proxy_async();  // the generic-proxy writes, before TMA reads them
    asm volatile("bar.sync %0, 128;\n" ::"r"(wg_bar) : "memory");
    const int row0 = q0 + cw * 64;
    if (tid == 0 && row0 < L) {
      for (int x = 0; x < BOXES; ++x) tma_store_4d(&tm_o, q_rows + x * BM * ROW_BYTES, x * BOX, h, row0, b);
      bulk_commit();
    }
    const int r0 = row0 + rr;
    if (t == 0) {
      if (r0 < L) lse[static_cast<int64_t>(bh) * L + r0] = m0 * scale + logf(l0);
      if (r0 + 8 < L) lse[static_cast<int64_t>(bh) * L + r0 + 8] = m1 * scale + logf(l1);
    }
  }
  if (tid == 0) bulk_wait_all();  // the last store is done before the CTA's shared memory goes
}

// setmaxnreg moves registers inside the block's allocation: the consumers'
// 232 and the producer's 40 must fit in what the block got at launch, or the
// consumers' setmaxnreg.inc would wait forever.
constexpr int REG_POOL = 128 * 40 + CONSUMERS * 232;

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, bf16* o, float* lse, int B, int L, int H,
                   float scale, int ctas, cudaStream_t stream) {
  static bool regs_checked = false;
  if (!regs_checked) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, flash_fwd_sm90_kernel<D>);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * THREADS < REG_POOL) return cudaErrorInvalidConfiguration;
    regs_checked = true;
  }
  const int row_blocks = (L + BM - 1) / BM;
  const int64_t tiles = static_cast<int64_t>(B) * H * row_blocks;
  if (ctas <= 0 || tiles + ctas > 0x7fffffff) return cudaErrorInvalidValue;  // a CTA's tile index stays an int
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::ALLOC);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, to;
  if (!encode_map(&tq, q, B, L, H, D, BM) || !encode_map(&tk, k, B, L, H, D, BN) ||
      !encode_map(&tv, v, B, L, H, D, BN) || !encode_map(&to, o, B, L, H, D, 64)) {
    return cudaErrorInvalidValue;
  }
  const int grid = static_cast<int>(ctas < tiles ? ctas : tiles);
  flash_fwd_sm90_kernel<D><<<grid, THREADS, Layout<D>::ALLOC, stream>>>(tq, tk, tv, to, lse, L, H, row_blocks,
                                                                         static_cast<int>(tiles), scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t info(int* regs, int* spill_bytes, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<D>::ALLOC);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_fwd_sm90_kernel<D>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *spill_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = Layout<D>::ALLOC + static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, flash_fwd_sm90_kernel<D>, THREADS,
                                                       Layout<D>::ALLOC);
}

// ------------------------------------------------------------- head dim 64
//
// The SD 2.1 and SDXL UNet self-attention (B, L, H, 64) without RoPE has a
// kernel of its own where a head has many key tiles. At D 64 a warpgroup's
// 128-key tile is 512 cycles of tensor-core work (S = Q·K^T and P·V, 2 MFLOP),
// but its softmax is a long dependent chain on one warp a quarter of the SM:
// in two consumer warpgroups taking turns a tile took ~2,300 cycles, ~1,100 of
// them the softmax, and the tensor cores were busy 45% of the time (clock64
// stamps on an H100). The design:
// - Three consumer warpgroups (192 query rows a tile, FlashAttention-3's tile
//   at head dim 64) and no turns: each warpgroup issues S_j and
//   P_{j−1}·V_{j−1} together, runs S_j's softmax while P_{j−1}·V_{j−1} is in
//   flight, and the three run apart, so one's softmax also overlaps the
//   others' products. 128·32 + 384·160 = 65,536 registers, the SM's
//   (setmaxnreg 32 and 160): S (64), P (32) and O (32) a thread are live
//   through the softmax, which keeps two running maxima and sums a row, not
//   trees, to stay inside 160, and takes exp2 as `ex2.approx.ftz`; P is
//   packed a pair a cvt.rn.bf16x2.f32 (pack_frag).
// - Persistent, as flash_fwd_sm90_kernel<D> above: one CTA an SM over a
//   static schedule (D64Schedule), two Q buffers, so the producer requests
//   the next tile's Q and first K while the current tile runs, the K/V rings'
//   stages and phases carried from tile to tile, O divided by the row sum as
//   the reciprocal's product with one FMA correction (`div_by`), staged in
//   the warpgroup's rows of the tile's own Q buffer and stored by TMA, lse
//   stored from registers. The producer and the consumers each walk the
//   schedule from the launch's parameters: values the compiler can see are
//   the same across a warp, so the key loop's indices stay in uniform
//   registers (read from shared memory instead, they took vector registers,
//   a reconvergence point around each barrier wait and a warp sync before
//   each wgmma: 9% more cycles a key tile on an H100, PERF.md).
// - The last round split over keys. Where the tiles do not fill whole
//   rounds of the SMs, the last, part-empty round's tiles are cut into equal
//   ranges of key tiles over `tail_ctas` CTAs (stream-K over the tail: a
//   range covers at most two tiles), so every CTA runs about as many key
//   tiles. A part of a tile writes its unnormalised f32 O, its running max m
//   and its share of the row sum l (each consumer thread's registers, 36
//   values, the 384 threads' value i together) to `part`, takes a ticket of
//   its (tile, warpgroup) (atomicAdd), and the part that takes the last
//   ticket folds the tile's parts in part order (max of m, then O and l each
//   scaled by exp2((m_p − m)·scale·log2 e)), so the bits do not depend on
//   which part finishes last, then stores O and lse as a whole tile does.
//   Nothing waits for another CTA, so nothing depends on the CTAs being
//   resident together. The last part resets its ticket to 0, so the tickets
//   (the wrapper keeps one zeroed array a stream) are 0 at every launch, and
//   counts the tile in tickets[0] (the wrapper reads it back for tests). The
//   wrapper's `d64_split` picks tail_ctas from a cost model; tail_ctas =
//   the round's tile count runs its tiles whole.
// - Bound: at D 64 the products (4·L²·D·H operations at 989 TFLOP/s) and
//   the L²·H exponentials (at 3.9 T/s on the special-function units) take
//   about the same time: 0.3474 and 0.3441 ms at SD 2.1's 1024² level
//   without CFG (B 1, L 16384, 5 heads).
// Shared memory: Q twice (48 KB), a K/V ring of 2 stages of 128 keys (64
// KB); one CTA an SM (registers).
struct D64 {
  static constexpr int D = 64;
  static constexpr int BM = 192;  // query rows a tile: three consumer warpgroups of 64
  static constexpr int THREADS = 512;
  static constexpr int CONSUMERS = 384;
  static constexpr int STAGES = 2;  // 3 measured no faster (PERF.md)
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int TILE_BYTES = BN * D * 2;  // one K or V tile: 16 KB
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;
  // Q full, Q empty [2]; K full, V full, K empty, V empty [STAGES]
  static constexpr int BARS = 4 + 4 * STAGES;
  static constexpr int FLAG_OFF = BAR_OFF + BARS * 8;  // each consumer warpgroup's "last part" flag
  // + slack to align the base to the 1024 bytes of a 128-byte swizzle atom
  static constexpr int ALLOC = FLAG_OFF + 16 + 1024;
  static constexpr int PRODUCER_REGS = 32;
  static constexpr int CONSUMER_REGS = 160;
  // setmaxnreg moves registers inside the block's allocation (see REG_POOL)
  static constexpr int REG_POOL = 128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS;
  static_assert(REG_POOL <= 65536, "the register split must fit the SM");
  // a part's f32 values, float4 a thread: 8 of O and {m0, m1, l0, l1}, each for the 384 consumer threads
  static constexpr int PART_VEC4 = 9;
};

// The static schedule of a launch of G = gridDim.x CTAs over `tiles` tiles of
// n key tiles each (tile i: row block i % ⌈L/192⌉ of (batch, head)
// i / ⌈L/192⌉, so a head's row blocks are adjacent and share its K and V in
// L2). CTA c takes whole tiles c, c + G, …, c + (full − 1)·G (full = tiles /
// G), then its share of the last round's rem = tiles − full·G tiles: their
// rem·n key tiles in order cut into tail_ctas ranges [c·T/tail_ctas, (c +
// 1)·T/tail_ctas), T = rem·n, range c for CTA c < tail_ctas. rem ≤ tail_ctas
// ≤ min(G, T), so a range holds 1 to n key tiles and covers at most two
// tiles: a CTA has at most full + 2 items. tail_ctas = rem gives each of the
// round's tiles whole to one CTA. The launch keeps tail_ctas·T under 2^31,
// so the arithmetic is 32-bit (a 64-bit division is a call, and a stack
// frame in the consumers).
struct D64Schedule {
  unsigned n, full, base, tail_ctas, T;
  __device__ D64Schedule(int tiles, int L, int tail) {
    n = (L + BN - 1) / BN;
    full = static_cast<unsigned>(tiles) / gridDim.x;
    base = full * gridDim.x;
    tail_ctas = tail;
    T = (tiles - base) * n;
  }
  // the first key tile (in the tail's order) of CTA c's range
  __device__ unsigned start(unsigned c) const { return c * T / tail_ctas; }
  // the CTA whose range holds key tile x of the tail
  __device__ unsigned cta_of(unsigned x) const { return ((x + 1) * tail_ctas + T - 1) / T - 1; }
  // this CTA's item idx: its tile and key tiles [k0, k1); false past its last
  __device__ bool item(unsigned idx, int& tile, int& k0, int& k1) const {
    const unsigned c = blockIdx.x;
    if (idx < full) {
      tile = c + idx * gridDim.x;
      k0 = 0;
      k1 = n;
      return true;
    }
    if (c >= tail_ctas || idx > full + 1) return false;
    const unsigned s = start(c), e = start(c + 1);
    const unsigned t = s / n + (idx - full);  // the item's tile among the tail's
    const unsigned x = idx == full ? s : t * n;
    if (x >= e) return false;
    tile = base + t;
    k0 = x - t * n;
    k1 = e - t * n < n ? e - t * n : n;
    return true;
  }
};

// softmax_tile for three warpgroups' registers (a 64 × 128 tile: 64 logits a
// thread, rows g and g + 8, n8 column group i/4): two running maxima and
// sums a row, ex2.approx.ftz, masked keys' p zeroed after the exponentials.
__device__ __forceinline__ void softmax_d64(float (&sc)[64], int k0, int L, int t, float sl2, float& m0, float& m1,
                                            float& l0, float& l1, float& alpha0, float& alpha1) {
  const bool ragged = k0 + 128 > L;
  if (ragged) {  // keys past the real length
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (k0 + (i / 4) * 8 + t * 2 + (i & 1) >= L) sc[i] = -INFINITY;
    }
  }
  float a0 = fmaxf(m0, sc[0]), b0 = sc[1], a1 = fmaxf(m1, sc[2]), b1 = sc[3];
#pragma unroll
  for (int i = 4; i < 64; i += 4) {
    a0 = fmaxf(a0, sc[i]);
    b0 = fmaxf(b0, sc[i + 1]);
    a1 = fmaxf(a1, sc[i + 2]);
    b1 = fmaxf(b1, sc[i + 3]);
  }
  float mx0 = fmaxf(a0, b0), mx1 = fmaxf(a1, b1);
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  alpha0 = ex2_ftz((m0 - mx0) * sl2);  // 0 at the first tile (m = −inf)
  alpha1 = ex2_ftz((m1 - mx1) * sl2);
  m0 = mx0;
  m1 = mx1;
  const float mb0 = mx0 * sl2;
  const float mb1 = mx1 * sl2;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = ex2_ftz(fmaf(sc[i], sl2, (i & 2) ? -mb1 : -mb0));
  if (ragged) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (k0 + (i / 4) * 8 + t * 2 + (i & 1) >= L) sc[i] = 0.f;
    }
  }
  a0 = sc[0];
  b0 = sc[1];
  a1 = sc[2];
  b1 = sc[3];
#pragma unroll
  for (int i = 4; i < 64; i += 4) {
    a0 += sc[i];
    b0 += sc[i + 1];
    a1 += sc[i + 2];
    b1 += sc[i + 3];
  }
  l0 = fmaf(l0, alpha0, a0 + b0);
  l1 = fmaf(l1, alpha1, a1 + b1);
}

__global__ void __launch_bounds__(D64::THREADS, 1)
flash_fwd_d64_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                     float* __restrict__ lse, float* __restrict__ part, int* __restrict__ tickets, int L, int H,
                     int row_blocks, int tiles, int tail_ctas, float scale) {
  using C = D64;
  constexpr int STAGES = C::STAGES;
  constexpr int TILE_BYTES = C::TILE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;  // two buffers of Q_BYTES
  const uint32_t sK = base + C::K_OFF;
  const uint32_t sV = base + C::V_OFF;
  const uint32_t bars = base + C::BAR_OFF;
  auto full_q = [&](int qb) { return bars + 8u * qb; };
  auto empty_q = [&](int qb) { return bars + 8u * (2 + qb); };
  auto full_k = [&](int s) { return bars + 8u * (4 + s); };
  auto full_v = [&](int s) { return bars + 8u * (4 + STAGES + s); };
  auto empty_k = [&](int s) { return bars + 8u * (4 + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return bars + 8u * (4 + 3 * STAGES + s); };
  const int wg = threadIdx.x / 128;

  // The producer's copies of one item: Q into buffer qb, then K_{k0} into
  // ring stage g % STAGES (free).
  auto load_q_k0 = [&](int qb, int tile, int k0, int g) {
    const int bh = tile / row_blocks;
    const int q0 = (tile - bh * row_blocks) * C::BM;
    const int b = bh / H;
    const int h = bh - b * H;
    mbar_expect_tx(full_q(qb), C::Q_BYTES);
    tma_load_4d(sQ + qb * C::Q_BYTES, &tm_q, full_q(qb), 0, h, q0, b);
    mbar_expect_tx(full_k(g % STAGES), TILE_BYTES);
    tma_load_4d(sK + (g % STAGES) * TILE_BYTES, &tm_k, full_k(g % STAGES), 0, h, k0 * BN, b);
  };

  if (threadIdx.x == 0) {  // the barriers, then the first item's Q and K at once
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(full_q(qb), 1);
      mbar_init(empty_q(qb), 3);  // one thread of each consumer warpgroup
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), C::CONSUMERS);
      mbar_init(empty_v(s), C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const D64Schedule sch(tiles, L, tail_ctas);
    int tile, k0, k1;
    if (sch.item(0, tile, k0, k1)) load_q_k0(0, tile, k0, 0);
  }
  __syncthreads();

  // K/V tile g of this CTA's run (all its items' key tiles in order) sits in
  // ring stage g % STAGES; item i of the CTA uses Q buffer i & 1.
  if (wg == 0) {  // producer: per item Q and K_{k0}, then K_{j+1} before V_j, the order the consumers take them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      const D64Schedule sch(tiles, L, tail_ctas);
      int g = 0;  // K/V tiles requested so far
      int tile, k0, k1;
      for (int i = 0; sch.item(i, tile, k0, k1); ++i) {
        const int bh = tile / row_blocks;
        const int b = bh / H;
        const int h = bh - b * H;
        auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full, uint32_t empty, int gi, int j) {
          mbar_wait(empty, ((gi / STAGES) & 1) ^ 1);
          mbar_expect_tx(full, TILE_BYTES);
          tma_load_4d(ring + (gi % STAGES) * TILE_BYTES, map, full, 0, h, j * BN, b);
        };
        if (i > 0) {  // item 0's Q and K_{k0} went out before the block's first __syncthreads
          const int qb = i & 1;
          mbar_wait(empty_q(qb), ((i >> 1) & 1) ^ 1);  // item i − 2's O has left the buffer
          mbar_wait(empty_k(g % STAGES), ((g / STAGES) & 1) ^ 1);
          load_q_k0(qb, tile, k0, g);
        }
        for (int j = k0; j < k1; ++j) {
          if (j + 1 < k1) load(&tm_k, sK, full_k((g + 1) % STAGES), empty_k((g + 1) % STAGES), g + 1, j + 1);
          load(&tm_v, sV, full_v(g % STAGES), empty_v(g % STAGES), g, j);
          ++g;
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows [cw·64, cw·64 + 64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
  const int cw = wg - 1;
  const int ctid = threadIdx.x - 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g8 = lane >> 2;
  const int t = lane & 3;
  const int wg_bar = 1 + cw;  // this warpgroup's own named barrier
  const float sl2 = scale * LOG2E;

  float acc[C::D / 2];  // O: column group c holds acc[4c..4c+3] (rows g8, g8 + 8; columns 8c + 2t, + 1)
  float sc[BN / 2];
  uint32_t pa[BN / 16][4];
  uint32_t q_rows;

  // S = Q·K_g^T: 4 k16 steps, 32 bytes along a swizzled 128-byte row each
  auto issue_s = [&](int gi) {
    const uint32_t k_tile = sK + (gi % STAGES) * TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < C::D / 16; ++kk) {
      wgmma_ss_n128(sc, desc_sw128(q_rows + kk * 32, 16, 1024), desc_sw128(k_tile + kk * 32, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P·V_g: 16 keys a k16 step = two 8-row groups (SBO)
  auto issue_pv = [&](int gi) {
    const uint32_t v_tile = sV + (gi % STAGES) * TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      wgmma_rs(acc, pa[kk], desc_sw128(v_tile + kk * 16 * ROW_BYTES, BN * ROW_BYTES, 1024));
    }
    wgmma_commit();
  };

  // Iteration j issues S_j and P_{j−1}·V_{j−1}, waits for S_j and runs its
  // softmax while P_{j−1}·V_{j−1} is in flight, then rescales O; the three
  // warpgroups run apart, so one's softmax also overlaps the others'
  // products.
  const D64Schedule sch(tiles, L, tail_ctas);
  int g = 0;  // K/V tiles consumed so far
  int tile, k0, k1;
  for (int i = 0; sch.item(i, tile, k0, k1); ++i) {
    const int qb = i & 1;
    const int cnt = k1 - k0;
    mbar_wait(full_q(qb), (i >> 1) & 1);
    q_rows = sQ + qb * C::Q_BYTES + cw * 64 * ROW_BYTES;
#pragma unroll
    for (int x = 0; x < C::D / 2; ++x) acc[x] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g8 and g8 + 8 (unscaled logits)
    float l0 = 0.f, l1 = 0.f;              // this thread's share of their running sums
    float alpha0, alpha1;

    mbar_wait(full_k(g % STAGES), (g / STAGES) & 1);
    wgmma_fence();
    issue_s(g);
    wgmma_wait0();
    fence_regs(sc);
    mbar_arrive(empty_k(g % STAGES));
    softmax_d64(sc, k0 * BN, L, t, sl2, m0, m1, l0, l1, alpha0, alpha1);
    pack_frag(sc, pa);
    // the previous item's O, staged in the other Q buffer, has been read out
    if (i > 0 && tid == 0) {
      bulk_wait_read<0>();
      mbar_arrive(empty_q(qb ^ 1));
    }
    for (int it = 1; it < cnt; ++it) {
      const int gk = g + it, gv = g + it - 1;
      mbar_wait(full_k(gk % STAGES), (gk / STAGES) & 1);
      mbar_wait(full_v(gv % STAGES), (gv / STAGES) & 1);
      fence_regs(acc);
      wgmma_fence();
      issue_s(gk);
      issue_pv(gv);
      wgmma_wait1();  // S_j
      fence_regs(sc);
      mbar_arrive(empty_k(gk % STAGES));
      softmax_d64(sc, (k0 + it) * BN, L, t, sl2, m0, m1, l0, l1, alpha0, alpha1);
      wgmma_wait0();  // P_{j−1}·V_{j−1}
      fence_regs(acc);
      fence_regs(sc);  // P_j's fragments only once P_{j−1}'s are read
      mbar_arrive(empty_v(gv % STAGES));
#pragma unroll
      for (int x = 0; x < C::D / 2; ++x) acc[x] *= (x & 2) ? alpha1 : alpha0;
      pack_frag(sc, pa);
    }
    const int gl = g + cnt - 1;
    mbar_wait(full_v(gl % STAGES), (gl / STAGES) & 1);
    fence_regs(acc);
    wgmma_fence();
    issue_pv(gl);
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(empty_v(gl % STAGES));
    g += cnt;

    if (k0 != 0 || k1 != sch.n) {
      // A part of a tile: its partial values out, then its ticket; the last
      // part folds the tile's parts in part order.
      const unsigned tt = tile - sch.base;  // the tile among the tail's
      const int cf = sch.cta_of(tt * sch.n), cl = sch.cta_of(tt * sch.n + sch.n - 1);
      auto slot = [&](int c) {  // CTA c's part of this tile: its first or its second item of the tail
        const int s = 2 * c + static_cast<int>(tt - sch.start(c) / sch.n);
        return reinterpret_cast<float4*>(part) + (static_cast<int64_t>(s) * C::PART_VEC4 * C::CONSUMERS + ctid);
      };
      float4* mine = slot(blockIdx.x);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        __stcg(mine + v * C::CONSUMERS, make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]));
      }
      __stcg(mine + 8 * C::CONSUMERS, make_float4(m0, m1, l0, l1));
      asm volatile("bar.sync %0, 128;\n" ::"r"(wg_bar) : "memory");
      const uint32_t flag = base + C::FLAG_OFF + 4u * cw;
      if (tid == 0) {
        int* ticket = tickets + 1 + 3 * tt + cw;
        __threadfence();  // the warpgroup's values (ordered by the barrier) before its ticket
        const int last = atomicAdd(ticket, 1) == cl - cf;
        if (last) {
          *ticket = 0;  // 0 again for the next launch
          atomicAdd(tickets, 1);
          __threadfence();
        }
        asm volatile("st.shared.s32 [%0], %1;\n" ::"r"(flag), "r"(last) : "memory");
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(wg_bar) : "memory");
      int last;
      asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(last) : "r"(flag) : "memory");
      // a value the compiler sees is the same across the warp: a branch on the
      // shared-memory read itself made the whole item loop divergent to it,
      // and the key loop lost its uniform registers (8-9% slower, PERF.md)
      if (!__shfl_sync(0xffffffffu, last, 0)) continue;
      float n0 = -INFINITY, n1 = -INFINITY;
      for (int c = cf; c <= cl; ++c) {
        const float4 ml = __ldcg(slot(c) + 8 * C::CONSUMERS);
        n0 = fmaxf(n0, ml.x);
        n1 = fmaxf(n1, ml.y);
      }
#pragma unroll
      for (int x = 0; x < C::D / 2; ++x) acc[x] = 0.f;
      l0 = l1 = 0.f;
      for (int c = cf; c <= cl; ++c) {
        const float4* p = slot(c);
        const float4 ml = __ldcg(p + 8 * C::CONSUMERS);
        const float a0 = ex2_ftz((ml.x - n0) * sl2), a1 = ex2_ftz((ml.y - n1) * sl2);
        l0 = fmaf(ml.z, a0, l0);
        l1 = fmaf(ml.w, a1, l1);
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const float4 o = __ldcg(p + v * C::CONSUMERS);
          acc[4 * v] = fmaf(o.x, a0, acc[4 * v]);
          acc[4 * v + 1] = fmaf(o.y, a0, acc[4 * v + 1]);
          acc[4 * v + 2] = fmaf(o.z, a1, acc[4 * v + 2]);
          acc[4 * v + 3] = fmaf(o.w, a1, acc[4 * v + 3]);
        }
      }
      m0 = n0;
      m1 = n1;
    }

    // Epilogue: O / l into this warpgroup's 64 rows of the Q buffer (its
    // products are done with them), 128-byte swizzled as TMA reads it, then
    // one thread stores them with TMA; the store runs on while the next item
    // starts. lse from registers.
    const int bh = tile / row_blocks;
    const int q0 = (tile - bh * row_blocks) * C::BM;
    const int b = bh / H;
    const int h = bh - b * H;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    const int rr = warp * 16 + g8;  // this thread's first row in the warpgroup's 64; rr & 7 == g8
#pragma unroll
    for (int c = 0; c < C::D / 8; ++c) {
      // column group c: 16-byte chunk c of the row, swizzled by the row's place in its 8
      const uint32_t at = q_rows + rr * ROW_BYTES + ((c ^ g8) << 4) + t * 4;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                   "r"(fgt::pack_bf16x2(div_by(acc[4 * c], l0, i0), div_by(acc[4 * c + 1], l0, i0)))
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * ROW_BYTES),
                   "r"(fgt::pack_bf16x2(div_by(acc[4 * c + 2], l1, i1), div_by(acc[4 * c + 3], l1, i1)))
                   : "memory");
    }
    fence_proxy_async();  // the generic-proxy writes, before TMA reads them
    asm volatile("bar.sync %0, 128;\n" ::"r"(wg_bar) : "memory");
    const int row0 = q0 + cw * 64;
    if (tid == 0 && row0 < L) {
      tma_store_4d(&tm_o, q_rows, 0, h, row0, b);
      bulk_commit();
    }
    const int r0 = row0 + rr;
    if (t == 0) {
      if (r0 < L) lse[static_cast<int64_t>(bh) * L + r0] = m0 * scale + logf(l0);
      if (r0 + 8 < L) lse[static_cast<int64_t>(bh) * L + r0 + 8] = m1 * scale + logf(l1);
    }
  }
  if (tid == 0) bulk_wait_all();  // the last store is done before the CTA's shared memory goes
}

cudaError_t launch_d64(const void* q, const void* k, const void* v, bf16* o, float* lse, float* part, int* tickets,
                       int B, int L, int H, float scale, int ctas, int tail_ctas, cudaStream_t stream) {
  using C = D64;
  static bool regs_checked = false;
  if (!regs_checked) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, flash_fwd_d64_kernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * C::THREADS < C::REG_POOL) return cudaErrorInvalidConfiguration;
    regs_checked = true;
  }
  const int row_blocks = (L + C::BM - 1) / C::BM;
  const int64_t tiles = static_cast<int64_t>(B) * H * row_blocks;
  if (ctas <= 0 || tiles + ctas > 0x7fffffff) return cudaErrorInvalidValue;  // a CTA's tile index stays an int
  const int64_t rem = tiles % ctas;
  const int64_t key_tiles = rem * ((L + BN - 1) / BN);
  if (rem == 0 ? tail_ctas != 0 : (tail_ctas < rem || tail_ctas > ctas || tail_ctas > key_tiles)) {
    return cudaErrorInvalidValue;
  }
  // a split's schedule in 32 bits (D64Schedule), its parts and tickets given
  if (tail_ctas > rem && (key_tiles * (tail_ctas + 1) >= 0x7fffffff || part == nullptr || tickets == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_d64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::ALLOC);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, to;
  if (!encode_map(&tq, q, B, L, H, C::D, C::BM) || !encode_map(&tk, k, B, L, H, C::D, BN) ||
      !encode_map(&tv, v, B, L, H, C::D, BN) || !encode_map(&to, o, B, L, H, C::D, 64)) {
    return cudaErrorInvalidValue;
  }
  flash_fwd_d64_kernel<<<ctas, C::THREADS, C::ALLOC, stream>>>(tq, tk, tv, to, lse, part, tickets, L, H, row_blocks,
                                                               static_cast<int>(tiles), tail_ctas, scale);
  return cudaGetLastError();
}

cudaError_t info_d64(int* regs, int* spill_bytes, int* smem_bytes, int* blocks_per_sm) {
  using C = D64;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_d64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::ALLOC);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_fwd_d64_kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *spill_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = C::ALLOC + static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, flash_fwd_d64_kernel, C::THREADS, C::ALLOC);
}

}  // namespace

// q, k, v, o: (B, L, H, D) contiguous bf16, 16-byte aligned (TMA loads and
// stores); lse: (B·H, L) f32. Attention without RoPE (rotate q and k first with
// fgt_rope_rotate), on min(ctas, tiles) CTAs of the persistent kernel (one an
// SM: the caller passes the SM count). Returns a cudaError_t:
// cudaErrorInvalidValue also when a tensor map cannot be encoded.
extern "C" int fgt_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse, int B, int L,
                                  int H, int D, float scale, int ctas, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  bf16* ob = static_cast<bf16*>(o);
  float* lb = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return static_cast<int>(launch<128>(q, k, v, ob, lb, B, L, H, scale, ctas, st));
  if (D == 64) return static_cast<int>(launch<64>(q, k, v, ob, lb, B, L, H, scale, ctas, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// As fgt_flash_fwd_sm90 at head dim 64, in the persistent three-warpgroup
// kernel (192-row tiles), for any B·H, on `ctas` CTAs (one an SM at most);
// `tail_ctas` takes the last round's rem = tiles % ctas tiles (0 when rem is
// 0; rem runs them whole; rem < tail_ctas ≤ min(ctas, rem·⌈L/128⌉) splits
// them over keys, and then `part` holds 2·tail_ctas·9·4·384 f32 values and
// `tickets` 1 + 3·rem ints, zero, left zero; tickets[0] counts the split
// tiles' merges, one a warpgroup).
extern "C" int fgt_flash_fwd_d64(const void* q, const void* k, const void* v, void* o, void* lse, void* part,
                                 void* tickets, int B, int L, int H, float scale, int ctas, int tail_ctas,
                                 void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_d64(q, k, v, static_cast<bf16*>(o), static_cast<float*>(lse),
                                     static_cast<float*>(part), static_cast<int*>(tickets), B, L, H, scale, ctas,
                                     tail_ctas, static_cast<cudaStream_t>(stream)));
}

// The RoPE pre-pass: qr, kr = rope(q), rope(k) over (B, L, H, D) contiguous bf16
// (16-byte aligned) with (B, L, D/2) contiguous bf16 tables (8-byte aligned).
extern "C" int fgt_rope_rotate(const void* q, const void* k, const void* cos, const void* sin, void* qr, void* kr,
                               int B, int L, int H, int D, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || (D != 64 && D != 128)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = static_cast<int64_t>(B) * L * H * (D / 8);
  const dim3 grid(static_cast<unsigned>((chunks + 255) / 256));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* cb = static_cast<const bf16*>(cos);
  const bf16* sb = static_cast<const bf16*>(sin);
  bf16* qo = static_cast<bf16*>(qr);
  bf16* ko = static_cast<bf16*>(kr);
  if (D == 128) {
    rope_rotate_kernel<128><<<grid, 256, 0, st>>>(qb, kb, cb, sb, qo, ko, H, chunks);
  } else {
    rope_rotate_kernel<64><<<grid, 256, 0, st>>>(qb, kb, cb, sb, qo, ko, H, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// The attention kernel's registers a thread at launch (before setmaxnreg), local
// memory (spills) a thread, shared memory a block and blocks an SM: at head dim
// D with `warpgroups` consumer warpgroups (2, or at D 64 also 3: the
// head-dim-64 kernel).
extern "C" int fgt_flash_fwd_sm90_info(int D, int warpgroups, int* regs, int* spill_bytes, int* smem_bytes,
                                       int* blocks_per_sm) {
  if (D == 128 && warpgroups == 2) return static_cast<int>(info<128>(regs, spill_bytes, smem_bytes, blocks_per_sm));
  if (D == 64 && warpgroups == 2) return static_cast<int>(info<64>(regs, spill_bytes, smem_bytes, blocks_per_sm));
  if (D == 64 && warpgroups == 3) return static_cast<int>(info_d64(regs, spill_bytes, smem_bytes, blocks_per_sm));
  return static_cast<int>(cudaErrorInvalidValue);
}
