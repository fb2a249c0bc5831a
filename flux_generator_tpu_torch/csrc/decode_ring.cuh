// The machinery of the MusicGen decode step (kernel D, decode_step.cu) that
// its probes share, for Hopper (sm_90a): the decode-chain probe (#11,
// decode_chain.cu) and the chain-bisect probe (#12, chain_bisect.cu) stream
// the same (L·14, H, H) weight chunks through the same schedule as D, so a
// probe's time is D's cost of that schedule and nothing else.
//
// - One 256-thread block an SM in a cooperative launch walks the layers'
//   six projections a layer: qkv (chunks 0-2), o (3), cross q (4), cross o
//   (5), up (6-9), down (10-13).
// - The schedule (Sched): an item of a projection is one column tile × kt
//   consecutive weight tiles of 256 rows; kt is the fewest that fit the
//   phase in one wave of the grid, from the width and the device, never from
//   the rows.
// - The weight ring (Ring, refill): 5 stages of 32 KB, filled by TMA with
//   the 128-byte swizzle. Each block walks its own tiles of every phase of
//   every layer in order and refills a freed stage with the tile 5 ahead, so
//   the stream stays in flight across the grid syncs.
// - The products (tile_products): mma.sync m16n8k16 bf16 with f32 sums, the
//   ≤ 8 rows on the n side padded to 8, int8 pairs widened exactly and
//   scaled by one bf16x2 multiply.
// - Tickets (take_ticket) for the folds, and the grid sync with its
//   optional device-clock stamp (grid_sync).
// D's own phase code (its item loop, folds and statistics) stays in
// decode_step.cu as it was: the probes' copies of those loops, as
// functions, are in decode_probe.cuh (inlined into D they changed its
// register allocation; as calls they would put the accumulators, which
// they take by reference, in local memory). A test pins decode_step.cu's
// hash (tests/test_torch_decode_chain.py), so a change to D stops there
// until the copy follows it.
// Every sum has one fixed order, so a step is bitwise reproducible.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

#include "sm90_common.cuh"

namespace cg = cooperative_groups;

namespace {

using fgt::bf16;
using namespace fgt::sm90;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXB = 8;               // rows the kernel takes; the mma's n side
constexpr int DH = 64;                // head dim
constexpr int CPL = 14;               // weight chunks per layer
constexpr int H_MAX = 8192;
constexpr int KT = 256;               // rows of a weight tile: one k-slice
constexpr int TILE_BYTES = KT * ROW_BYTES;  // 32 KB: 256 rows × 128 bytes
constexpr int STAGES = 5;             // the weight ring
constexpr int TMAX = 4;               // weight tiles (k-slices of 256 rows) an item takes at most
constexpr int KI_MAX = TMAX * KT;     // k rows of an item at most
constexpr int APITCH = KI_MAX + 8;    // bf16 a row of the staged activations
constexpr int TN_MAX = 128;           // columns of an int8 tile (64 for bf16)
constexpr int PHASES = 6;             // projections a layer
constexpr int MAX_SPLIT = 16;         // warps sharing one (row, head) of self-attention
constexpr int ROWS_PER_SPLIT = 64;    // cache rows a split takes before another is added

// shared memory, in bytes from a 1024-aligned base
constexpr int SM_RING = 0;
constexpr int SM_A = SM_RING + STAGES * TILE_BYTES;          // bf16 [MAXB][APITCH]
constexpr int SM_SC = SM_A + MAXB * APITCH * 2;              // bf16 [TN_MAX] column scales
constexpr int SM_RED = SM_SC + TN_MAX * 2;                   // f32 [WARPS][MAXB][TN_MAX]
constexpr int SM_Q = SM_RED + WARPS * MAXB * TN_MAX * 4;     // f32 [WARPS][DH] self-attention q
constexpr int SM_STATS = SM_Q + WARPS * DH * 4;              // f32 [MAXB][2] LN mean, rstd
constexpr int SM_LNP = SM_STATS + MAXB * 2 * 4;              // bf16 [2][KI_MAX] LN scale, bias
constexpr int SM_SEG = SM_LNP + 2 * KI_MAX * 2;              // f32 [MAXB][H_MAX / 64][2] segment stats
constexpr int SM_FLAG = SM_SEG + MAXB * (H_MAX / 64) * 2 * 4;  // int: the last-arrival flag
constexpr int SM_GRP = SM_FLAG + 16;                         // GTile: the item's place
constexpr int SM_SCHED = SM_GRP + 16;                        // the Sched below
constexpr int SM_RINGST = SM_SCHED + 128;                    // the Ring below
constexpr int SM_ARGS = SM_RINGST + 32;                      // the kernel's Args
constexpr int SM_BARS = (SM_ARGS + 256 + 7) & ~7;
constexpr int SM_USED = SM_BARS + STAGES * 8;
constexpr size_t SMEM_BYTES = SM_USED + 1024;  // slack to align the base to 1024

// The six projections of a layer, in order: qkv, o, cross q, cross o, up, down.
__constant__ int P_CHUNK0[PHASES] = {0, 3, 4, 5, 6, 10};
__constant__ int P_NOUT[PHASES] = {3, 1, 1, 1, 4, 1};
__constant__ int P_KCH[PHASES] = {1, 1, 1, 1, 1, 4};

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

// A ticket: add one with release (the caller's and, through the barrier
// before it, its block's or warp's stores come first) and acquire (what the
// other holders stored before theirs is seen after), at the device's scope.
__device__ __forceinline__ int take_ticket(int* t) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(t) : "memory");
  return old;
}

// 16 bytes from global to shared memory, through L2 only (other blocks wrote
// them), asynchronously; cp_async_wait waits for all of this thread's.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem_dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// ------------------------------------------------------------ the schedule

// The items of one projection phase: nt column tiles × ks k-groups; item i
// is column tile i % nt of k-group i / nt, whose kt weight tiles of 256 rows a
// block takes in turn, summing them in registers, and writes as one partial.
// kt is the fewest tiles (a divisor of a chunk's H / 256, at most TMAX) that
// fit the phase's items in one wave of the grid, so it depends on the width
// and the device, never on B. Phase p's items go round the grid from block
// rot[p], so the blocks with one item more in a phase take one less in the next.
struct Sched {
  int tn;  // columns of a tile: 128 int8, 64 bf16
  int nt[PHASES], kt[PHASES], ks[PHASES], items[PHASES], rot[PHASES];
  __device__ int first(int p) const {
    const int g = gridDim.x;
    return (int(blockIdx.x) - rot[p] % g + g) % g;
  }
};

__device__ Sched make_sched(int H, int tn) {
  Sched s;
  s.tn = tn;
  int acc = 0;
  const int per_chunk = H / KT, g = gridDim.x;
  for (int p = 0; p < PHASES; ++p) {
    s.nt[p] = P_NOUT[p] * H / tn;
    const int tiles = P_KCH[p] * per_chunk;
    int fit = 0, most = 1;
    for (int t = 1; t <= TMAX; ++t) {
      if (per_chunk % t) continue;
      most = t;
      if (!fit && s.nt[p] * (tiles / t) <= g) fit = t;
    }
    s.kt[p] = fit ? fit : most;
    s.ks[p] = tiles / s.kt[p];
    s.items[p] = s.nt[p] * s.ks[p];
    s.rot[p] = acc;
    acc = (acc + s.items[p]) % g;
  }
  return s;
}

// The next weight tile this block's ring fills: its layer, phase, item and
// tile within the item.
struct Cursor {
  int layer, phase, item, tile;
  __device__ bool valid(int L) const { return layer < L; }
  // move past items that do not exist (phases in which this block has none)
  __device__ void settle(const Sched& s, int L) {
    while (layer < L && item >= s.items[phase]) {
      if (++phase == PHASES) {
        phase = 0;
        ++layer;
      }
      item = s.first(phase);
    }
  }
  __device__ void advance(const Sched& s, int L) {
    if (++tile < s.kt[phase]) return;
    tile = 0;
    item += gridDim.x;
    settle(s, L);
  }
};

// An item's place: its first output column, first k row (in the phase's K),
// weight chunk (its tiles never cross one: kt divides H / 256), and column
// tile (the ticket it takes).
struct GTile {
  int n0, k0, chunk, col;
};
__device__ __forceinline__ GTile item_at(const Sched& s, int layer, int p, int item, int H) {
  const int col = item % s.nt[p], n0 = col * s.tn, k0 = item / s.nt[p] * s.kt[p] * KT;
  return {n0, k0, layer * CPL + P_CHUNK0[p] + n0 / H + k0 / H, col};
}

// Start the TMA copy of the cursor's tile into ring stage `stage`.
template <bool I8, class Args>
__device__ void issue_tile(const CUtensorMap* wmap, const Args& a, const Sched& s, const Cursor& c, int stage,
                           unsigned char* ring, uint32_t bar) {
  const int H = a.H;
  const GTile t = item_at(s, c.layer, c.phase, c.item, H);
  mbar_expect_tx(bar, TILE_BYTES);
  tma_load_2d(smem_u32(ring + stage * TILE_BYTES), wmap, bar, t.n0 % H, t.chunk * H + t.k0 % H + c.tile * KT);
}

// The ring's state, in shared memory: tiles consumed and issued, and the
// next to issue. Thread 0 alone changes it, between barriers; every thread
// reads it.
struct Ring {
  int consumed, issued;
  Cursor next;
};
static_assert(sizeof(Ring) <= 32, "Ring fits its shared-memory slot");

// Thread 0: issue tiles into every free stage (a stage is free once the tile
// STAGES before has been consumed).
template <bool I8, class Args>
__device__ void refill(const CUtensorMap* wmap, const Args& a, const Sched& sd, Ring& ring, unsigned char* smem) {
  const uint32_t bars = smem_u32(smem + SM_BARS);
  while (ring.issued < ring.consumed + STAGES && ring.next.valid(a.L)) {
    const int stage = ring.issued % STAGES;
    issue_tile<I8>(wmap, a, sd, ring.next, stage, smem + SM_RING, bars + 8 * stage);
    ring.next.advance(sd, a.L);
    ++ring.issued;
  }
}

// ------------------------------------------------------------ projections

// Wait for a ring stage's tile; a tile that never lands (a fault in the copy)
// stops the kernel with a trap after about a second instead of hanging it.
__device__ __forceinline__ void stage_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
#pragma unroll 1
  for (long polls = 0; polls < (1l << 26); ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// One 16-byte read of the weight tile at (row, 16-byte chunk), through the
// TMA's 128-byte swizzle.
__device__ __forceinline__ uint4 tile_load(const unsigned char* tile, int row, int chunk) {
  return *reinterpret_cast<const uint4*>(tile + row * ROW_BYTES + ((chunk ^ (row & 7)) << 4));
}

// bytes q of u0 (row r) and u1 (row r + 1), both XORed with 0x80, → bf16x2
// (row r low): 0x4B0000XX is 2^23 + 128 + w, exact in f32 and in its top half.
template <int Q>
__device__ __forceinline__ uint32_t i8_pair(uint32_t u0, uint32_t u1) {
  const float f0 = __uint_as_float(__byte_perm(u0, 0x4B000000u, 0x7540u | Q)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u1, 0x4B000000u, 0x7540u | Q)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632u);
}

// bf16(w · s): one bf16x2 multiply of the exact product, rounded once.
__device__ __forceinline__ uint32_t scale2(uint32_t w2, uint32_t s2) {
  __nv_bfloat162 w, s;
  memcpy(&w, &w2, 4);
  memcpy(&s, &s2, 4);
  const __nv_bfloat162 r = __hmul2(w, s);
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

// Weight columns of a thread: 16 int8 or 8 bf16 (one 16-byte read of a row).
template <bool I8>
struct WTile {
  static constexpr int COLS = I8 ? 16 : 8;
  static constexpr int TN = 8 * COLS;   // 8 thread groups
  static constexpr int NMMA = COLS / 2;  // m16 tiles: column 2μ (+1) of each group
};

// One tile's products: acc[μ] += W_tile[this warp's rows]ᵀ · A. Thread (g, t)
// owns columns COLS·g + 2μ (M row g) and COLS·g + 2μ + 1 (M row g + 8); the
// warp, the sub-th of the wpi warps on this tile, takes k16 steps sub,
// sub + wpi, ...
template <bool I8>
__device__ __forceinline__ void tile_products(const unsigned char* tile, const bf16* a_s, const uint32_t (&sc)[WTile<I8>::COLS],
                                              float (&acc)[WTile<I8>::NMMA][4], int sub, int wpi) {
  constexpr int NMMA = WTile<I8>::NMMA;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int step = sub; step < KT / 16; step += wpi) {
    const int r = 16 * step + 2 * t;
    const uint4 R[4] = {tile_load(tile, r, g), tile_load(tile, r + 1, g), tile_load(tile, r + 8, g),
                        tile_load(tile, r + 9, g)};
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(a_s + g * APITCH + r);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(a_s + g * APITCH + r + 8);
    uint32_t w[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i][0] = R[i].x;
      w[i][1] = R[i].y;
      w[i][2] = R[i].z;
      w[i][3] = R[i].w;
      if (I8) {
#pragma unroll
        for (int j = 0; j < 4; ++j) w[i][j] ^= 0x80808080u;
      }
    }
#pragma unroll
    for (int mu = 0; mu < NMMA; ++mu) {
      uint32_t af[4];
      if (I8) {  // columns 16g + 2μ, + 1: word μ/2, bytes 2(μ%2), + 1
        const int j = mu >> 1;
        if (mu & 1) {
          af[0] = i8_pair<2>(w[0][j], w[1][j]);
          af[1] = i8_pair<3>(w[0][j], w[1][j]);
          af[2] = i8_pair<2>(w[2][j], w[3][j]);
          af[3] = i8_pair<3>(w[2][j], w[3][j]);
        } else {
          af[0] = i8_pair<0>(w[0][j], w[1][j]);
          af[1] = i8_pair<1>(w[0][j], w[1][j]);
          af[2] = i8_pair<0>(w[2][j], w[3][j]);
          af[3] = i8_pair<1>(w[2][j], w[3][j]);
        }
      } else {  // columns 8g + 2μ, + 1: word μ, halves low, high
        af[0] = __byte_perm(w[0][mu], w[1][mu], 0x5410u);
        af[1] = __byte_perm(w[0][mu], w[1][mu], 0x7632u);
        af[2] = __byte_perm(w[2][mu], w[3][mu], 0x5410u);
        af[3] = __byte_perm(w[2][mu], w[3][mu], 0x7632u);
      }
      af[0] = scale2(af[0], sc[2 * mu]);
      af[1] = scale2(af[1], sc[2 * mu + 1]);
      af[2] = scale2(af[2], sc[2 * mu]);
      af[3] = scale2(af[3], sc[2 * mu + 1]);
      fgt::mma_bf16_16816(acc[mu], af, b0, b1);
    }
  }
}

// ------------------------------------------------------------ the kernel

// A grid sync; with timers, block 0 then stamps the device clock into timers[n].
__device__ __noinline__ void grid_sync(unsigned long long* timers, int n) {
  cg::this_grid().sync();
  if (timers && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    timers[n] = t;
  }
}

// ------------------------------------------------------------ host side

inline size_t round4(size_t n) { return (n + 3) & ~size_t(3); }

// The splits of `rows` cache rows over warps: a split a ROWS_PER_SPLIT rows,
// at most MAX_SPLIT; the rows' count alone decides (the batch never enters).
inline int row_splits(int rows) {
  return std::max(1, std::min(MAX_SPLIT, (rows + ROWS_PER_SPLIT - 1) / ROWS_PER_SPLIT));
}

// The grid of a cooperative launch of `kern`: one block an SM, which the
// occupancy query at SMEM_BYTES of dynamic shared memory must allow.
inline cudaError_t coop_grid(const void* kern, int& grid) {
  int dev = 0, n_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop || n_sm <= 0) return cudaErrorNotSupported;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  grid = n_sm;
  return cudaSuccess;
}

// The weights (L·14·H rows × H columns, int8 or bf16) as a TMA map with
// boxes of one 128-byte row × KT rows and the 128-byte swizzle.
inline bool weight_map(CUtensorMap* wmap, const void* w, bool i8, int L, int H) {
  const int esize = i8 ? 1 : 2;
  return encode_map_2d(wmap, w, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, H,
                       uint64_t(L) * CPL * H, uint64_t(H) * esize, ROW_BYTES / esize, KT, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
