// int4 unpack-in-matmul for Hopper (sm_90a): kernel B.
//
// Replaces the TPU kernel `_kernel` of flux_generator_tpu/ops/pallas/int4_matmul.py
// (pallas_call at :148), which runs every T5-XXL matmul on the Flux path.
//
// Computes y = x · W for x (M, K) bf16 or f32 and W stored as packed int4 (K/2, N)
// uint8 in the repo's SPLIT layout (ops/quant.pack_int4): packed row r holds
// original row r in the low nibble and row r + K/2 in the high nibble, both
// biased by +8. Scales are f32, per output channel (N,) or per input group
// (K/gs, N); the first g/2 groups belong to the low half. Numerics follow the
// TPU kernel: grouped weights are dequantized as bf16(f32(q) · s), the product
// taken in f32 and rounded once; per-channel weights enter the product as exact
// small integers and the scale multiplies the f32 sum after the K loop. Sums
// are f32; the output is in x's dtype. Bias stays outside, in ops/linear.dense.
//
// Bound: at the T5-XXL shapes (M 256; 4096→4096, 4096→10240, 10240→4096) a call
// does 2·M·K·N = 8.6–21 GFLOP against 8–21 MB of packed weights, about 1000
// operations a weight byte: bf16 tensor-core throughput bounds it (8.7–21.7 µs
// at 989 TFLOP/s), not bytes.
//
// Design of the bf16 route: persistent blocks (one an SM, 384 threads) in
// clusters of `splits`; wgmma with the weight as the A operand, unpacked in
// registers. The numbers below are for tiles of 256 rows (128 rows: 8 stages of
// 25 KB), measured on an H100 by chip_smoke.py's build and B phases.
// - The product is taken transposed, outᵀ = Wᵀ·xᵀ: the weight's columns are the
//   wgmma's M side and x's rows its N side, m64nNWk16 with NW = 256 rows of x
//   (128 where M ≤ 128). A tile is NW rows × BN = 128 weight columns, so at
//   M ≤ 256 one tile holds every row of x and each packed byte is fetched and
//   unpacked once a call.
// - Warpgroup 0 is the producer (setmaxnreg 40): one thread issues the TMA
//   copies of a ring of STAGES = 5 stages of 41 KB, each with a full and an
//   empty mbarrier. A stage is one K half of a block of BKP = 64 packed rows:
//   the x box of the half's 64 columns (K-major, 128-byte swizzle, zero fill
//   past M and K); the low half's stage also holds the (64, 128) uint8 weight
//   tile (128-byte swizzle), which feeds both halves, and for group sizes that
//   are a multiple of BKP the block's two group-scale rows (one copy a stage,
//   not a load a byte).
// - Warpgroups 1 and 2 (setmaxnreg 232) own 64 weight columns each and all NW
//   rows: 128 f32 sums a thread. Of its warp's 16-column chunk a thread reads
//   with ldmatrix.trans columns 2g and 2g + 1 of rows 2t, 2t + 1 (and 2t + 8,
//   2t + 9), so with A-row g ↔ column 2g and A-row g + 8 ↔ column 2g + 1 the
//   bytes of one register are the two A-fragment registers of a k16 step:
//   bytes 0 and 2 for A-row g, 1 and 3 for g + 8; low nibbles for the low half,
//   high nibbles for the high half. Two ldmatrix.x4 a block give both halves'
//   fragments. A nibble pair becomes bf16 by the magic-number trick
//   ((u | 0x4300) is 128 + u, minus 136 is q, exact); a grouped pair then goes
//   to f32, is multiplied by its scale and rounded once (cvt.rn.bf16x2.f32).
// - Each k16 product is a commit group of its own. After issuing one, a
//   warpgroup waits until at most four run (wgmma.wait_group 4), which frees
//   the fragments of the step four back, and unpacks one k16 step of the next
//   stage into them: the unpacking runs between the products, four stay
//   queued. (Unpacking a whole stage between stages, with two fragment sets,
//   left it on the critical path: each stage took its products' time plus
//   its unpacking's.) 8 k16 steps of fragments, 32 registers.
// - A K split: at M 256 the tiles are few (32 at N 4096), so each tile's packed
//   blocks are cut into `splits` parts, one a block of a cluster (the wrapper's
//   plan picks the split, at most 4 at 256 rows, whose busiest block has the
//   least to do, the exchange counted). After its K loop each split stages its
//   f32 sums in its ring, sorted by the owner of each slice of n8 row groups
//   (slice q: groups [q·J/splits, (q + 1)·J/splits), J = NW/8); once every
//   block of the cluster is done with its ring (an mbarrier each, arrived from
//   every block; the producers wait), one thread sends each slice to its owner
//   with a bulk copy into the cluster's shared memory (cp.async.bulk
//   shared::cluster, completing bytes on the owner's mbarrier), and the owner
//   sums its slice in split order and stores it. The output does not depend
//   on which split finishes first, and is the same from run to run. The
//   exchange takes up to 224 KB of the ring; with it a block has 230,504
//   bytes of shared memory.
// - Epilogue from registers: a thread holds columns 2g and 2g + 1 of rows
//   8j + 2t and 8j + 2t + 1, stored as bf16 pairs. The wrapper allocates whole
//   tiles (rows to a multiple of NW, columns to the weight's pitch) and keeps
//   the (M, N) part, so no store is masked but the tile's last columns.
// Registers: 168 a thread at launch, none spilled, no wgmma serialized (ptxas).
// Shapes, as the TPU wrapper takes them: any M (rows past M come in as zeros);
// K % 64 == 0 (a K half whose length is no multiple of 64 ends in a partial
// block whose k16 steps past the half are skipped); any N: TMA needs the
// weight's row pitch to be a multiple of 16 bytes, so the wrapper pads a ragged
// N with 0x88 bytes (and grouped scales with zeros), as the TPU wrapper pads to
// its blocks. Columns past N are never kept, so the zero fill TMA gives past
// the weight's columns (nibble 0, q = −8) reaches no output. Group sizes that
// are no multiple of BKP read their scales row by row from global memory, in
// tiles of 128 rows (a slow path no model uses; at M > 128 it unpacks each
// weight once a row tile).
//
// f32 activations take their own route: no tensor cores, since TF32 would
// round x and the weights to 10 mantissa bits. The weights are dequantized in
// f32 (grouped: q · s in f32, per channel: q, the scale folded after the K
// loop, as for bf16) and every product is an f32 FMA on the CUDA cores, 64 x 64
// outputs a block of 256 threads, 4 x 4 a thread, 16 packed rows a step.

#include <string.h>

#include "sm90_common.cuh"

namespace {

using fgt::bf16;
using namespace fgt::sm90;

constexpr int BKP = 64;          // packed rows a stage: 64 rows of one K half
constexpr int BN = 128;          // weight columns a tile: 64 a consumer warpgroup
constexpr int THREADS = 384;     // the producer warpgroup and two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int W_BYTES = BKP * BN;
constexpr int RING_BYTES = 224 * 1024;    // the copy pipeline's stages, and the splits' exchange
constexpr int SCALE_BYTES = BN * 4;       // one group's scales of a tile's columns
constexpr int GROUP_BYTES = CONSUMERS * 16;  // one n8 group of a tile's f32 sums (a float4 a consumer thread)
constexpr int MAX_SPLITS = 8;

enum ScaleMode { PER_CHANNEL = 0, GROUP_STAGE = 1, GROUP_ROW = 2 };

// Shared memory of the bf16 route for tiles of NW rows of x (128 or 256).
template <int NW>
struct Ring {
  static constexpr int X_BYTES = NW * ROW_BYTES;  // one 64-column box of x
  static constexpr int S_OFF = X_BYTES + W_BYTES;  // GROUP_STAGE: the low and high half's scale rows
  static constexpr int STAGE_BYTES = S_OFF + 1024;  // (a multiple of the swizzle atom)
  static constexpr int STAGES = RING_BYTES / STAGE_BYTES;
  static constexpr int ACC = NW / 2;  // f32 sums a consumer thread holds
  static constexpr int J = NW / 8;    // n8 groups of x rows
  // The exchange reuses the ring: a split's sums staged by owner (splits
  // slices of ⌈J/splits⌉ groups) and the other splits' copies of its own
  // slice (splits − 1 more). 224 KB at 256 rows, split at most 4.
  static constexpr int MAX_SPLIT = NW == 256 ? 4 : MAX_SPLITS;
  static constexpr int exchange_bytes(int splits) { return (2 * splits - 1) * ((J + splits - 1) / splits) * GROUP_BYTES; }
  static constexpr int max_exchange() {
    int most = 0;
    for (int s = 2; s <= MAX_SPLIT; ++s) most = exchange_bytes(s) > most ? exchange_bytes(s) : most;
    return most;
  }
  static_assert(STAGES * STAGE_BYTES <= RING_BYTES && max_exchange() <= RING_BYTES, "the ring");
  static constexpr int BAR_OFF = RING_BYTES;
  // full and empty a stage, then the exchange's three
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 3) * 8 + 1024;  // + slack to align the base to 1024
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// The nibbles at bit SHIFT of bytes 0 and 2 of r as the bf16 pair of their
// values q = u − 8 (exact): 128 + u from the bits of bf16 0x4300, minus 136.
template <int SHIFT>
__device__ __forceinline__ uint32_t q_pair(uint32_t r) {
  const uint32_t v = ((r >> SHIFT) & 0x000F000Fu) | 0x43004300u;
  uint32_t q;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(q) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));  // v · 1 − 136
  return q;
}

// The same pair dequantized: bf16(f32(q) · s), the low value with s0, the high with s1.
template <int SHIFT>
__device__ __forceinline__ uint32_t dq_pair(uint32_t r, float s0, float s1) {
  const uint32_t q = q_pair<SHIFT>(r);
  return fgt::pack_bf16x2(__fmul_rn(__uint_as_float(q << 16), s0), __fmul_rn(__uint_as_float(q & 0xFFFF0000u), s1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A scale of column col (0 past N), group rows `stride` values apart.
__device__ __forceinline__ float scale_at(const float* __restrict__ scale, int64_t group, int stride, int col, int N) {
  return col < N ? __ldg(scale + group * stride + col) : 0.f;
}

// GROUP_STAGE: the scales of columns col, col + 1 of a block's low half, then
// its high half, from the scale rows of its low half's stage (`rows`).
__device__ __forceinline__ void stage_scales(float (&s)[4], uint32_t rows, int col_in_tile) {
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(s[0]), "=f"(s[1]) : "r"(rows + col_in_tile * 4));
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(s[2]), "=f"(s[3])
               : "r"(rows + SCALE_BYTES + col_in_tile * 4));
}

// GROUP_ROW: where a thread's scales are (group rows `stride` values apart);
// a row's group is __umulhi(row, magic), magic = ⌈2³²/gs⌉, exact while
// row · gs < 2³² (the entry point checks K · gs).
struct RowScales {
  const float* scale;
  uint32_t magic;
  int stride;
  int col;
  int N;
};

// The A fragment of k16 step kk (0..3, a constant where the loops unroll) of
// one K half (H) of a packed block, from `raw` (two ldmatrix.x4.trans:
// raw[2kk] rows 16kk + 2t, + 1, raw[2kk + 1] rows 16kk + 2t + 8, + 9).
// PER_CHANNEL: exact q; GROUP_STAGE: s0 for column 2g, s1 for 2g + 1;
// GROUP_ROW: each row's group (rows of half H from `row0`, this thread's first
// row of the block in that half, below `row_end`).
template <int H, int MODE>
__device__ __forceinline__ void unpack_step(int kk, const uint32_t (&raw)[8], uint32_t (&f)[4], float s0, float s1,
                                            const RowScales& rs, int row0, int row_end) {
  constexpr int SH = 4 * H;
  const uint32_t ra = raw[2 * kk];
  const uint32_t rb = raw[2 * kk + 1];
  if constexpr (MODE == PER_CHANNEL) {
    f[0] = q_pair<SH>(ra);
    f[1] = q_pair<SH + 8>(ra);
    f[2] = q_pair<SH>(rb);
    f[3] = q_pair<SH + 8>(rb);
  } else if constexpr (MODE == GROUP_STAGE) {
    f[0] = dq_pair<SH>(ra, s0, s0);
    f[1] = dq_pair<SH + 8>(ra, s1, s1);
    f[2] = dq_pair<SH>(rb, s0, s0);
    f[3] = dq_pair<SH + 8>(rb, s1, s1);
  } else {
    float s[4][2];  // rows 16kk + {0, 1, 8, 9} from row0 × columns col, col + 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 16 * kk + (i & 1) + 8 * (i >> 1);
      const int group = static_cast<int>(__umulhi(static_cast<uint32_t>(row), rs.magic));
      s[i][0] = row < row_end ? scale_at(rs.scale, group, rs.stride, rs.col, rs.N) : 0.f;
      s[i][1] = row < row_end ? scale_at(rs.scale, group, rs.stride, rs.col + 1, rs.N) : 0.f;
    }
    f[0] = dq_pair<SH>(ra, s[0][0], s[1][0]);
    f[1] = dq_pair<SH + 8>(ra, s[0][1], s[1][1]);
    f[2] = dq_pair<SH>(rb, s[2][0], s[3][0]);
    f[3] = dq_pair<SH + 8>(rb, s[2][1], s[3][1]);
  }
}

// One k16 product of a stage (skipped past the K half, at a partial block's
// step `kk` ≥ `steps`), in a commit group of its own.
template <int ACC>
__device__ __forceinline__ void issue_step(float (&acc)[ACC], const uint32_t (&f)[4], uint32_t x_tile, int kk,
                                           int steps) {
  wgmma_fence();
  if (kk < steps) wgmma_rs_bk(acc, f, desc_sw128(x_tile + kk * 32, 16, 1024));
  wgmma_commit();
}

// Named barrier 1: the 256 consumer threads.
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// Thread-block clusters: this block's rank, the cluster's index and count
// (a launch without clusters has clusters of one block), a shared-memory
// address in block `rank`'s window, and mbarrier arrivals and waits that order
// memory across the cluster.
__device__ __forceinline__ uint32_t cluster_reg(int which) {
  uint32_t v;
  if (which == 0) asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  else if (which == 1) asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(v));
  else asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(v));
  return v;
}
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(v) : "r"(addr), "r"(rank));
  return v;
}
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar_cluster) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar_cluster) : "memory");
}
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// Columns col and col + 1 of rows r and r + 1 (`dst` at row r, column col):
// v00 = (col, r), v01 = (col, r + 1), v10 = (col + 1, r), v11 = (col + 1, r + 1),
// each times its column's scale, as two bf16 pairs.
__device__ __forceinline__ void store_rows(bf16* dst, int pitch, float v00, float v01, float v10, float v11, float c0,
                                           float c1) {
  *reinterpret_cast<uint32_t*>(dst) = fgt::pack_bf16x2(v00 * c0, v10 * c1);
  *reinterpret_cast<uint32_t*>(dst + pitch) = fgt::pack_bf16x2(v01 * c0, v11 * c1);
}

template <int NW, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
int4_matmul_sm90_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                        const __grid_constant__ CUtensorMap tm_s,
                        const float* __restrict__ scale, bf16* __restrict__ out, int M, int N, int pitch, int K,
                        int gs, int splits) {
  using R = Ring<NW>;
  constexpr int STAGES = R::STAGES;
  constexpr int J = R::J;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + R::BAR_OFF;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  // the exchange of a tile's sums between its splits, through the ring:
  const uint32_t xempty = bars + 8u * 2 * STAGES;  // every block of the cluster is done with its ring
  const uint32_t xready = xempty + 8u;             // every split's sums of this block's slice are here
  const uint32_t xdone = xready + 8u;              // this block's slice is stored: the ring is the producer's
  const int Kp = K / 2;
  const int nb = (Kp + BKP - 1) / BKP;  // packed blocks a K half
  const int m_tiles = (M + NW - 1) / NW;
  const int tiles = m_tiles * ((N + BN - 1) / BN);
  // a cluster of `splits` blocks takes tiles c, c + clusters, ...; block r of it split r
  const int split = static_cast<int>(cluster_reg(0));
  const int cluster = static_cast<int>(cluster_reg(1));
  const int clusters = static_cast<int>(cluster_reg(2));
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_x)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_w)) : "memory");
    if (MODE == GROUP_STAGE) asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_s)) : "memory");
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init(xempty, splits);
    mbar_init(xready, 1);  // this block's own arrival; the peers' copies complete its bytes
    mbar_init(xdone, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every block's barriers initialized before any remote arrival: arrive now,
  // wait before the first exchange (only the consumers reach the cluster)
  if (splits > 1) cluster_arrive();

  if (wg == 0) {  // producer: every item's stages, in the order the consumers take them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int it = 0;
      int phase = 0;
      for (int tile = cluster; tile < tiles; tile += clusters) {
        const int m0 = (tile % m_tiles) * NW;
        const int n0 = (tile / m_tiles) * BN;
        const int b1 = (split + 1) * nb / splits;
        for (int b = split * nb / splits; b < b1; ++b) {
#pragma unroll
          for (int h = 0; h < 2; ++h, ++it) {
            const int s = it % STAGES;
            mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
            constexpr int S_BYTES = MODE == GROUP_STAGE ? 2 * SCALE_BYTES : 0;
            mbar_expect_tx(full(s), h == 0 ? R::X_BYTES + W_BYTES + S_BYTES : R::X_BYTES);
            const uint32_t stage = base + s * R::STAGE_BYTES;
            tma_load_2d(stage, &tm_x, full(s), h * Kp + b * BKP, m0);
            if (h == 0) {
              tma_load_2d(stage + R::X_BYTES, &tm_w, full(s), n0, b * BKP);
              if constexpr (MODE == GROUP_STAGE) {  // the block's group rows: low half, high half
                tma_load_2d(stage + R::S_OFF, &tm_s, full(s), n0, (b * BKP) / gs);
                tma_load_2d(stage + R::S_OFF + SCALE_BYTES, &tm_s, full(s), n0, (Kp + b * BKP) / gs);
              }
            }
          }
        }
        // the consumers exchange sums through the ring: wait until they are done
        if (splits > 1) mbar_wait(xdone, phase++ & 1);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1;
  const int ctid = threadIdx.x - 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  // this lane's ldmatrix row in a 32-row slab of the weight tile: row `lane`,
  // chunk 4cw + warp (the warp's 16 columns) at its 128-byte-swizzled place
  const uint32_t w_off = lane * 128 + (((4 * cw + warp) ^ (lane & 7)) << 4);
  const int col_in_tile = 64 * cw + 16 * warp + 2 * g;  // A-row g; A-row g + 8 is the next column
  float acc[R::ACC];
  uint32_t raw[8];
  // A fragments of eight k16 steps: f[0..3] a block's low half, f[4..7] its
  // high half. Each k16 product runs in a commit group of its own; after each
  // is issued, the wait for all but four frees the fragments of the step four
  // back, and one k16 step of the next stage is unpacked into them, so the
  // unpacking runs between the products (a warpgroup does not unpack while
  // it waits to issue) and four products stay queued.
  uint32_t f[8][4];
  int it = 0;
  int phase = 0;
  bool waited = false;  // for the cluster's barrier initialization
  for (int tile = cluster; tile < tiles; tile += clusters) {
    const int m0 = (tile % m_tiles) * NW;
    const int col = (tile / m_tiles) * BN + col_in_tile;
    const RowScales rs{scale, MODE == GROUP_ROW ? 0xFFFFFFFFu / static_cast<uint32_t>(gs) + 1u : 0u, pitch, col, N};
    const int b0 = split * nb / splits;
    const int b1 = (split + 1) * nb / splits;
#pragma unroll
    for (int i = 0; i < R::ACC; ++i) acc[i] = 0.f;
    // GROUP_STAGE: block b's scales of columns col and col + 1 (low half, high
    // half) from its low half's stage, and block b + 1's
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    float next[4] = {0.f, 0.f, 0.f, 0.f};
    // the first block's low half, unpacked before its products
    int s_lo = it % STAGES;
    mbar_wait(full(s_lo), (it / STAGES) & 1);
    if constexpr (MODE == GROUP_STAGE) stage_scales(sc, base + s_lo * R::STAGE_BYTES + R::S_OFF, col_in_tile);
    ldsm_x4_trans(raw, base + s_lo * R::STAGE_BYTES + R::X_BYTES + w_off);
    ldsm_x4_trans(raw + 4, base + s_lo * R::STAGE_BYTES + R::X_BYTES + w_off + 32 * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unpack_step<0, MODE>(kk, raw, f[kk], sc[0], sc[1], rs, b0 * BKP + 2 * t, Kp);
    }
    int prev = -1;  // the slot of the previous block's high half
    for (int b = b0; b < b1; ++b) {
      const int steps = min(4, (Kp - b * BKP) / 16);
      const bool more = b + 1 < b1;
      // low half (its slot waited for already); the high half unpacked between its products
      const uint32_t x_lo = base + s_lo * R::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        issue_step(acc, f[kk], x_lo, kk, steps);
        wgmma_wait<4>();
        unpack_step<1, MODE>(kk, raw, f[4 + kk], sc[2], sc[3], rs, Kp + b * BKP + 2 * t, K);
      }
      if (prev >= 0) mbar_arrive(empty(prev));  // the previous block's high half is done
      // high half; the next block's low half unpacked between its products
      const int s_hi = (it + 1) % STAGES;
      const int s_next = (it + 2) % STAGES;
      if (more) {
        mbar_wait(full(s_next), ((it + 2) / STAGES) & 1);
        ldsm_x4_trans(raw, base + s_next * R::STAGE_BYTES + R::X_BYTES + w_off);
        ldsm_x4_trans(raw + 4, base + s_next * R::STAGE_BYTES + R::X_BYTES + w_off + 32 * 128);
        if constexpr (MODE == GROUP_STAGE) stage_scales(next, base + s_next * R::STAGE_BYTES + R::S_OFF, col_in_tile);
      }
      mbar_wait(full(s_hi), ((it + 1) / STAGES) & 1);
      const uint32_t x_hi = base + s_hi * R::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        issue_step(acc, f[4 + kk], x_hi, kk, steps);
        wgmma_wait<4>();
        if (more) {
          unpack_step<0, MODE>(kk, raw, f[kk], next[0], next[1], rs, (b + 1) * BKP + 2 * t, Kp);
        }
      }
      mbar_arrive(empty(s_lo));  // this block's low half is done
      prev = s_hi;
      s_lo = s_next;
      it += 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i] = next[i];
    }
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive(empty(prev));

    // per-channel scales multiply the sums; grouped weights carry theirs
    const float c0 = MODE == PER_CHANNEL ? scale_at(scale, 0, 0, col, N) : 1.f;
    const float c1 = MODE == PER_CHANNEL ? scale_at(scale, 0, 0, col + 1, N) : 1.f;
    bf16* out_rows = out + static_cast<int64_t>(m0 + 2 * t) * pitch + col;
    const bool in_out = col < pitch;
    if (splits == 1) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (in_out) store_rows(out_rows + 8 * j * pitch, pitch, acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                               acc[4 * j + 3], c0, c1);
      }
      continue;
    }
    // splits > 1: each split stages its sums in its ring by owner, slice q at
    // q·slice groups; once every block of the cluster is done with its ring
    // (their producers wait), one thread copies each slice (a bulk copy into
    // the cluster's shared memory) to its owner's receive slot for this split,
    // after the staged slices; the owner sums its slice in split order.
    const int slice = (J + splits - 1) / splits;      // n8 groups a slice holds at most
    const uint32_t mine = base + ctid * 16;           // this thread's float4 of group u of region r: mine + (r·slice + u)·GROUP_BYTES
    consumers_sync();  // both warpgroups' products are done with the ring
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int owner = ((j + 1) * splits - 1) / J;  // slices are [q·J/splits, (q + 1)·J/splits)
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       mine + (owner * slice + j - owner * J / splits) * GROUP_BYTES),
                   "f"(acc[4 * j]), "f"(acc[4 * j + 1]), "f"(acc[4 * j + 2]), "f"(acc[4 * j + 3])
                   : "memory");
    }
    fence_proxy_async();  // the staged sums before the bulk copies read them
    consumers_sync();
    if (!waited) {
      cluster_wait();
      waited = true;
    }
    const int j0 = split * J / splits;
    const int j1 = (split + 1) * J / splits;
    if (ctid == 0) {
      // the other splits' copies of this slice: (splits − 1) · (j1 − j0) groups
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(xready),
                   "r"((splits - 1) * (j1 - j0) * GROUP_BYTES)
                   : "memory");
      for (int p = 0; p < splits; ++p) mbar_arrive_cluster(mapa(xempty, p));
    }
    mbar_wait_cluster(xempty, phase & 1);
    if (ctid == 0) {
      for (int q = 0; q < splits; ++q) {
        if (q == split) continue;
        const int q0 = q * J / splits;
        const int slot = splits + (split < q ? split : split - 1);  // this split's receive slot at q
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                mapa(base + slot * slice * GROUP_BYTES, q)),
            "r"(base + q * slice * GROUP_BYTES), "r"(((q + 1) * J / splits - q0) * GROUP_BYTES), "r"(mapa(xready, q))
            : "memory");
      }
      bulk_commit();
    }
    mbar_wait(xready, phase & 1);
#pragma unroll 1
    for (int j = j0; j < j1; ++j) {
      float4 part[R::MAX_SPLIT];  // every split's sums of group j, loaded at once
#pragma unroll
      for (int p = 0; p < R::MAX_SPLIT; ++p) {
        if (p < splits) {
          const int region = p == split ? split : splits + (p < split ? p : p - 1);
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(part[p].x), "=f"(part[p].y), "=f"(part[p].z), "=f"(part[p].w)
                       : "r"(mine + (region * slice + j - j0) * GROUP_BYTES));
        }
      }
      float4 v = part[0];
#pragma unroll
      for (int p = 1; p < R::MAX_SPLIT; ++p) {
        if (p < splits) {
          v.x += part[p].x;
          v.y += part[p].y;
          v.z += part[p].z;
          v.w += part[p].w;
        }
      }
      if (in_out) store_rows(out_rows + 8 * j * pitch, pitch, v.x, v.y, v.z, v.w, c0, c1);
    }
    if (ctid == 0) bulk_wait_read<0>();  // the copies out have read the staged sums
    fence_proxy_async();  // the ring's reads and writes before the producer's next copies
    mbar_arrive(xdone);
    ++phase;
  }
}

// setmaxnreg moves registers inside the block's allocation: the consumers'
// 232 and the producer's 40 must fit in what the block got at launch, or the
// consumers' setmaxnreg.inc would wait forever.
constexpr int REG_POOL = 128 * 40 + CONSUMERS * 232;

template <int NW, int MODE>
cudaError_t sm90_attributes() {
  static bool checked = false;
  if (!checked) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, int4_matmul_sm90_kernel<NW, MODE>);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * THREADS < REG_POOL) return cudaErrorInvalidConfiguration;
    checked = true;
  }
  return cudaFuncSetAttribute(int4_matmul_sm90_kernel<NW, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Ring<NW>::SMEM);
}

template <int NW, int MODE>
cudaError_t launch_sm90(const bf16* x, const uint8_t* w, int pitch, const float* scale, bf16* out, int M, int N, int K,
                        int gs, int splits, int grid, cudaStream_t stream) {
  cudaError_t err = sm90_attributes<NW, MODE>();
  if (err != cudaSuccess) return err;
  CUtensorMap tx, tw, ts;
  memset(&ts, 0, sizeof(ts));  // unused unless GROUP_STAGE
  if (!encode_map_2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M, 2ull * K, BOX, NW, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map_2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, pitch, K / 2, pitch, BN, BKP,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      (MODE == GROUP_STAGE && !encode_map_2d(&ts, scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, pitch, K / gs, 4ull * pitch,
                                             BN, 1, CU_TENSOR_MAP_SWIZZLE_NONE))) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Ring<NW>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // a tile's splits in one cluster
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  void* args[] = {&tx, &tw, &ts, &scale, &out, &M, &N, &pitch, &K, &gs, &splits};
  return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(int4_matmul_sm90_kernel<NW, MODE>), args);
}

// GROUP_ROW takes tiles of 128 rows only: at 256 its per-row scale loads
// beside 128 sums a thread spill.
template <int NW>
cudaError_t launch_sm90_mode(int mode, const bf16* x, const uint8_t* w, int pitch, const float* scale, bf16* out,
                             int M, int N, int K, int gs, int splits, int grid, cudaStream_t st) {
  if (mode == PER_CHANNEL) return launch_sm90<NW, PER_CHANNEL>(x, w, pitch, scale, out, M, N, K, gs, splits, grid, st);
  if (mode == GROUP_STAGE) return launch_sm90<NW, GROUP_STAGE>(x, w, pitch, scale, out, M, N, K, gs, splits, grid, st);
  if constexpr (NW == 128) return launch_sm90<NW, GROUP_ROW>(x, w, pitch, scale, out, M, N, K, gs, splits, grid, st);
  return cudaErrorInvalidValue;
}

template <int NW, int MODE>
cudaError_t sm90_info(int* regs, int* spill_bytes, int* smem_bytes, int* blocks_per_sm, int* stages) {
  cudaError_t err = cudaFuncSetAttribute(int4_matmul_sm90_kernel<NW, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<NW>::SMEM);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, int4_matmul_sm90_kernel<NW, MODE>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *spill_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = Ring<NW>::SMEM + static_cast<int>(attr.sharedSizeBytes);
  *stages = Ring<NW>::STAGES;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, int4_matmul_sm90_kernel<NW, MODE>, THREADS,
                                                       Ring<NW>::SMEM);
}

template <int NW>
cudaError_t sm90_info_mode(int mode, int* regs, int* spill_bytes, int* smem_bytes, int* blocks_per_sm, int* stages) {
  if (mode == PER_CHANNEL) return sm90_info<NW, PER_CHANNEL>(regs, spill_bytes, smem_bytes, blocks_per_sm, stages);
  if (mode == GROUP_STAGE) return sm90_info<NW, GROUP_STAGE>(regs, spill_bytes, smem_bytes, blocks_per_sm, stages);
  if constexpr (NW == 128) {
    if (mode == GROUP_ROW) return sm90_info<NW, GROUP_ROW>(regs, spill_bytes, smem_bytes, blocks_per_sm, stages);
  }
  return cudaErrorInvalidValue;
}

// Clusters of `splits` blocks that can run at once (every instantiation of a
// tile height takes the same resources).
template <int NW>
cudaError_t sm90_clusters(int splits, int* clusters) {
  cudaError_t err = sm90_attributes<NW, PER_CHANNEL>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Ring<NW>::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, int4_matmul_sm90_kernel<NW, PER_CHANNEL>, &cfg);
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

// x: (M, K) contiguous, bf16 (x_f32 == 0) or f32 (x_f32 == 1), 16-byte aligned;
// w: (K/2, N) uint8 with rows `pitch` bytes apart, 16-byte aligned; scale: (N,)
// f32 when group_size == 0, else (K/group_size, N) f32 with rows `pitch`
// values apart. Requires K % 64 == 0 and, when grouped, (K/2) % group_size == 0.
// f32: pitch == N, out (M, N) f32.
// bf16: pitch a multiple of 16 (w's and grouped scales' columns N..pitch hold
// anything; grouped scales 16-byte aligned), out
// (⌈M/nw⌉·nw, pitch) bf16 with rows pitch values apart, 4-byte aligned: its
// rows past M and columns past N receive values that mean nothing. `grid`
// persistent blocks, in clusters of `splits`, take the ⌈M/nw⌉·⌈N/128⌉ tiles of
// nw (128 or 256) rows × 128 columns, each tile's packed rows cut into
// `splits` parts (1 ≤ splits ≤ min(8, ⌈K/128⌉)); `grid` is a multiple of
// `splits`, at most fgt_int4_matmul_clusters' count of clusters. Returns a
// cudaError_t: cudaErrorInvalidValue also when a tensor map cannot be encoded.
extern "C" int fgt_int4_matmul(const void* x, const void* w, const void* scale, void* out, int M, int N, int pitch,
                               int K, int group_size, int x_f32, int nw, int splits, int grid, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 64 != 0 || pitch < N ||
      (group_size > 0 && (K / 2) % group_size != 0) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* sb = static_cast<const float*>(scale);
  if (x_f32) {
    if (pitch != N || (M + FBM - 1) / FBM > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid2((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    const float* xf = static_cast<const float*>(x);
    float* of = static_cast<float*>(out);
    if (group_size > 0) {
      int4_matmul_f32_kernel<true><<<grid2, FTHREADS, 0, st>>>(xf, wb, sb, of, M, N, K, group_size);
    } else {
      int4_matmul_f32_kernel<false><<<grid2, FTHREADS, 0, st>>>(xf, wb, sb, of, M, N, K, 0);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int nb = (K / 2 + BKP - 1) / BKP;
  if ((nw != 128 && nw != 256) || pitch % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 4 != 0 || splits < 1 ||
      splits > (nw == 256 ? Ring<256>::MAX_SPLIT : Ring<128>::MAX_SPLIT) || splits > nb || grid < 1 ||
      grid % splits != 0 ||
      static_cast<int64_t>((M + nw - 1) / nw) * ((N + BN - 1) / BN) > (1ll << 31) - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mode = group_size == 0 ? PER_CHANNEL : group_size % BKP == 0 ? GROUP_STAGE : GROUP_ROW;
  if ((mode == GROUP_STAGE && reinterpret_cast<uintptr_t>(scale) % 16 != 0) ||
      (mode == GROUP_ROW && static_cast<int64_t>(K) * group_size >= (1ll << 32))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  const cudaError_t err =
      nw == 256 ? launch_sm90_mode<256>(mode, xb, wb, pitch, sb, ob, M, N, K, group_size, splits, grid, st)
                : launch_sm90_mode<128>(mode, xb, wb, pitch, sb, ob, M, N, K, group_size, splits, grid, st);
  return static_cast<int>(err);
}

// Clusters of `splits` blocks of the bf16 route (tiles of `nw` rows) that the
// card runs at once: the persistent grid's limit.
extern "C" int fgt_int4_matmul_clusters(int nw, int splits, int* clusters) {
  if (splits < 1 || splits > (nw == 256 ? Ring<256>::MAX_SPLIT : Ring<128>::MAX_SPLIT)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nw == 256) return static_cast<int>(sm90_clusters<256>(splits, clusters));
  if (nw == 128) return static_cast<int>(sm90_clusters<128>(splits, clusters));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 route's kernel for tiles of `nw` rows (128 or 256) and scale mode
// `mode` (0 per channel, 1 a group a stage, 2 row by row: 128 rows only): registers a thread
// at launch (before setmaxnreg), local memory (spills) a thread, shared memory
// a block, blocks an SM and ring stages.
extern "C" int fgt_int4_matmul_info(int nw, int mode, int* regs, int* spill_bytes, int* smem_bytes,
                                    int* blocks_per_sm, int* stages) {
  if (nw == 256) return static_cast<int>(sm90_info_mode<256>(mode, regs, spill_bytes, smem_bytes, blocks_per_sm, stages));
  if (nw == 128) return static_cast<int>(sm90_info_mode<128>(mode, regs, spill_bytes, smem_bytes, blocks_per_sm, stages));
  return static_cast<int>(cudaErrorInvalidValue);
}
