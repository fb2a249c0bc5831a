// The chain-bisect probe: the decode-chain probe's weight stream (#11) with
// the structural pieces of the first design of the fused decode step (kernel
// D) added one at a time, for Hopper (sm_90a).
//
// Replaces the TPU kernel built by `make_kernel` in scripts/prof_chain_bisect.py
// (l.57; pallas_call at :269). One step runs x (M, H) bf16 through L layers of
// 14 int8 (H, H) weight chunks with bf16 scales, as #11 does, except that
//   - GELU is the tanh form, 0.5·g·(1 + tanh(0.7978845608·(g + 0.044715·g³)));
//   - c3 adds 0·(k + v)[:, 0] of the c1 and c2 products to the residual, so
//     they are results, not traffic only.
// The script's extras, cumulative in its ladder, each a bit of the template
// mask MASK (the generic instantiation reads them at run time):
//   smem   the offset scalar: Args.offset, never read
//   ln     (L, 8, H) LN params: scale ln[l, 0] and bias ln[l, 1] on the c0
//          pre-norm only (c1 and c2 use the same normed rows); the c4 and c6
//          pre-norms stay affine-free
//   cross  two (L, B, S, H) cross K/V: c4's output += 0·Σ_b ck[l, b, 0, :]
//          + 0·Σ_b cv[l, b, 0, :], read by the tiles of the first k-slice
//   hbm    two (L, B, W, H) caches: Args.kc/vc, never read without dma
//   bufs   the staging ring: 2 slots × (one K row + one V row) of shared
//          memory a block, 12 KB at H 1536, beside D's 98 KB (2 blocks an SM)
//   outs   kn, vn (L, B, H) bf16: rows 0..B-1 of the c1 and c2 products,
//          written by the residual pass after c3, where their partial
//          k-slices are summed anyway (no grid sync of their own)
//   dma    layer l's (B, W, H) K and V windows copied into the ring with
//          cp.async, in the script's chunk order spread over the grid (block
//          i takes rows i, i + grid, ...): the first row started after the
//          qkv phase, the rest two deep at the start of the o phase, which
//          waits for all of them, as the script's c3 does. The residual then
//          adds 0·(slot 0's K row + V row): every block that holds a row
//          touches its own slot 0, where the script touches row 0 of b 0 of
//          the last even chunk; for finite caches both add exactly zero.
// B (the cross, cache and output rows) is the script's 2; M 1..8 (2 or 8
// accumulator rows), M ≥ 2 with outs.
//
// Numerics of the script's kernel: weights dequantized as bf16(w) · bf16(s)
// rounded to bf16; dot inputs rounded to bf16 with f32 accumulation; LN in
// f32 (eps 1e-5); residual in f32; y in bf16. No --use_fast_math, so the 0·x
// terms stay in the code and carry a NaN as the script's do.
//
// Bound: the 1.585 GB of int8 weights a step at 48 layers (0.4733 ms at
// 3.35 TB/s), plus the 302 MB of caches the dma rung copies at B 2, W 512.
// The design is #11's (decode_common.cuh): one cooperative launch a step,
// projections over cp.async-staged weight tiles with the next phase's first
// tile staged ahead, 9 grid syncs a layer, fixed-order partial sums.

#include "decode_common.cuh"

namespace {

constexpr unsigned X_SMEM = 1, X_LN = 2, X_CROSS = 4, X_HBM = 8, X_BUFS = 16, X_OUTS = 32, X_DMA = 64;
constexpr unsigned X_ALL = 127;
constexpr unsigned X_RUNTIME = 128;  // the instantiation that reads the extras at run time
constexpr int CB = 2;                // rows of the cross K/V, the caches and kn/vn

struct Bisect {
  Args a;          // w, s, ln, x, ck, cv, kc, vc, y, the plan; L, B = M, H, S, W, offset
  bf16* kn;        // (L, CB, H) with outs
  bf16* vn;
  int chunk;       // cache rows a copy chunk (the script's VMEM slot)
  unsigned extras;
};

template <unsigned MASK>
__device__ __forceinline__ bool on(const Bisect& p, unsigned x) {
  return (MASK & X_RUNTIME) ? (p.extras & x) != 0 : (MASK & x) != 0;
}

// the ring: [slot][K, V][H] bf16 after the staged weight tile
__device__ __forceinline__ bf16* ring(float* smem) {
  return reinterpret_cast<bf16*>(stage_buf(smem) + W_STAGE);
}

// Cache rows this block copies a layer.
__device__ __forceinline__ int ring_rows(const Bisect& p) {
  const int n = CB * p.a.W, i = blockIdx.x;
  return n > i ? (n - i + int(gridDim.x) - 1) / int(gridDim.x) : 0;
}

// Start copying this block's n-th cache row of layer l, K and V, into ring
// slot n & 1. Rows go in the script's order: chunk j's rows of every b, then
// chunk j + 1's; the last chunk may be short. A granule is always copied by
// the same thread, so a thread's own wait orders its reuse of a slot.
__device__ void ring_copy(const Bisect& p, int l, int n, float* smem) {
  const int H = p.a.H, W = p.a.W, ch = p.chunk;
  const int r = blockIdx.x + n * gridDim.x;
  const int lo = r / (CB * ch) * ch;
  const int sz = min(W, lo + ch) - lo;
  const int b = (r - CB * lo) / sz, t = lo + (r - CB * lo) % sz;
  const size_t row = ((size_t(l) * CB + b) * W + t) * H;
  const bf16* src[2] = {static_cast<const bf16*>(p.a.kc) + row, static_cast<const bf16*>(p.a.vc) + row};
  bf16* dst = ring(smem) + (n & 1) * 2 * H;
  const int granules = H / 8;  // 16 bytes each
  for (int i = threadIdx.x; i < 2 * granules; i += THREADS) {
    const int kv = i / granules, c = (i % granules) * 8;
    cp_async16(dst + kv * H + c, src[kv] + c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The o phase's wait: row n - 1 lands while row n is in flight, two deep.
__device__ void ring_drain(const Bisect& p, int l, float* smem) {
  const int n = ring_rows(p);
  for (int j = 1; j < n; ++j) {
    ring_copy(p, l, j, smem);
    asm volatile("cp.async.wait_group 1;\n" ::);
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// cross: c4's output (the first k-slice's partial) += 0·Σ_b ck[l, b, 0, n] + 0·Σ_b cv[l, b, 0, n]
struct CrossTouch {
  const bf16* ck;  // layer l's (CB, S, H)
  const bf16* cv;
  int S, H;
  __device__ float operator()(int slice, int, int n, float v) const {
    if (slice) return v;
    float sk = 0.f, sv = 0.f;
    for (int c = 0; c < CB; ++c) {
      sk += __bfloat162float(ck[size_t(c) * S * H + n]);
      sv += __bfloat162float(cv[size_t(c) * S * H + n]);
    }
    return v + 0.f * sk + 0.f * sv;
  }
};

// The residual after c3: + 0·(k + v)[b, 0] (the script's 0·ts[:, :1]); with
// dma + 0·(ring slot 0's K and V rows); with outs kn/vn[l, b] for b < CB.
struct AfterO {
  const float* pa;  // the qkv phase's partial slices, rows 3·H floats apart
  bf16* kn;         // layer l's (CB, H), or null
  bf16* vn;
  const bf16* rk;   // ring slot 0's K row, or null
  int B, H, ks;
  __device__ float operator()(int b, int col, float v) const {
    const size_t N = size_t(3) * H;
    float k0 = 0.f, v0 = 0.f;
    for (int s = 0; s < ks; ++s) {
      k0 += __ldcg(pa + (size_t(s) * B + b) * N + H);
      v0 += __ldcg(pa + (size_t(s) * B + b) * N + 2 * H);
    }
    v += 0.f * (k0 + v0);
    if (rk) v = v + 0.f * __bfloat162float(rk[col]) + 0.f * __bfloat162float(rk[H + col]);
    if (kn && b < CB) {
      float kk = 0.f, vv = 0.f;
      for (int s = 0; s < ks; ++s) {
        kk += __ldcg(pa + (size_t(s) * B + b) * N + H + col);
        vv += __ldcg(pa + (size_t(s) * B + b) * N + 2 * H + col);
      }
      kn[size_t(b) * H + col] = __float2bfloat16_rn(kk);
      vn[size_t(b) * H + col] = __float2bfloat16_rn(vv);
    }
    return v;
  }
};

template <int MB, unsigned MASK>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) chain_bisect_kernel(Bisect p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const Args& a = p.a;
  const Proj qkv{0, 3, 1, a.ks_qkv}, o{3, 1, 1, a.ks_o}, cq{4, 1, 1, a.ks_o}, co{5, 1, 1, a.ks_o};
  const Proj up{6, 4, 1, a.ks_up}, down{10, 1, 4, a.ks_dn};
  const int H = a.H;
  const bool dma = on<MASK>(p, X_DMA), cross = on<MASK>(p, X_CROSS), outs = on<MASK>(p, X_OUTS);
  const bool touch = dma && ring_rows(p) > 0;
  stage_next<true>(a, 0, qkv, smem);
  residual(a, 0, true, false, smem);
  grid.sync();
  for (int l = 0; l < a.L; ++l) {
    // c0-c2: q, k, v of LN(x), with ln's scale and bias when a.ln is set
    projection<true, MB>(a, l, qkv, A_LN, 0, 0, 0, a.pa, smem);
    stage_next<true>(a, l, o, smem);
    if (touch) ring_copy(p, l, 0, smem);
    grid.sync();
    if (dma) ring_drain(p, l, smem);
    projection<true, MB>(a, l, o, A_SUM, 0, a.ks_qkv, 3 * H, a.pb, smem);
    stage_next<true>(a, l, cq, smem);
    grid.sync();
    const size_t kv_row = size_t(l) * CB * H;
    residual(a, a.ks_o, false, false, smem,
             AfterO{a.pa, outs ? p.kn + kv_row : nullptr, outs ? p.vn + kv_row : nullptr,
                    touch ? ring(smem) : nullptr, a.B, H, a.ks_qkv});
    grid.sync();
    if (cross) {
      const size_t c_row = size_t(l) * CB * a.S * H;
      projection<true, MB>(a, l, cq, A_LN, -1, 0, 0, a.pa, smem, CrossTouch{a.ck + c_row, a.cv + c_row, a.S, H});
    } else {
      projection<true, MB>(a, l, cq, A_LN, -1, 0, 0, a.pa, smem);
    }
    stage_next<true>(a, l, co, smem);
    grid.sync();
    projection<true, MB>(a, l, co, A_SUM, 0, a.ks_o, H, a.pb, smem);
    stage_next<true>(a, l, up, smem);
    grid.sync();
    residual(a, a.ks_o, false, false, smem);
    grid.sync();
    projection<true, MB>(a, l, up, A_LN, -1, 0, 0, a.pa, smem);
    stage_next<true>(a, l, down, smem);
    grid.sync();
    projection<true, MB>(a, l, down, A_GELU_TANH, 0, a.ks_up, 4 * H, a.pb, smem);
    stage_next<true>(a, l + 1, qkv, smem);
    grid.sync();
    residual(a, 4 * a.ks_dn, false, l + 1 == a.L, smem);
    if (l + 1 < a.L) grid.sync();
  }
}

// The ladder's eight cumulative rungs have instantiations of their own, so
// a rung's kernel carries only its structure; any other set of extras runs
// the generic one.
template <int MB>
const void* rung_kernel(unsigned extras) {
  switch (extras) {
    case 0: return reinterpret_cast<const void*>(chain_bisect_kernel<MB, 0>);
    case 1: return reinterpret_cast<const void*>(chain_bisect_kernel<MB, 1>);
    case 3: return reinterpret_cast<const void*>(chain_bisect_kernel<MB, 3>);
    case 7: return reinterpret_cast<const void*>(chain_bisect_kernel<MB, 7>);
    case 15: return reinterpret_cast<const void*>(chain_bisect_kernel<MB, 15>);
    case 31: return reinterpret_cast<const void*>(chain_bisect_kernel<MB, 31>);
    case 63: return reinterpret_cast<const void*>(chain_bisect_kernel<MB, 63>);
    case 127: return reinterpret_cast<const void*>(chain_bisect_kernel<MB, 127>);
    default: return reinterpret_cast<const void*>(chain_bisect_kernel<MB, X_RUNTIME>);
  }
}

const void* bisect_kernel(int B, unsigned extras) {
  return B <= 2 ? rung_kernel<2>(extras) : rung_kernel<MAXB>(extras);
}

size_t bisect_smem(unsigned extras, int H) {
  return SMEM_BYTES + ((extras & X_BUFS) ? size_t(2) * 2 * H * sizeof(bf16) : 0);
}

bool bisect_ok(int B, int H, unsigned extras) {
  if (!shape_ok(B, H) || extras > X_ALL) return false;
  if ((extras & X_DMA) && (extras & (X_HBM | X_BUFS)) != (X_HBM | X_BUFS)) return false;
  return !(extras & X_OUTS) || B >= CB;
}

}  // namespace

// The launch plan for B rows of width H with `extras` (the script's order,
// bit i for extra i): out[0] the grid, out[1] resident blocks an SM, out[2]
// dynamic shared memory a block in bytes, out[3] the f32 scratch in floats.
extern "C" int fgt_chain_bisect_plan(int B, int H, int extras, int* out) {
  if (!bisect_ok(B, H, unsigned(extras))) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const size_t smem = bisect_smem(unsigned(extras), H);
  cudaError_t err = make_plan(bisect_kernel(B, unsigned(extras)), true, B, H, p, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.grid;
  out[1] = p.per_sm;
  out[2] = static_cast<int>(smem);
  out[3] = static_cast<int>(p.total);
  return 0;
}

// One step through all L layers: y (B, H) bf16 from x (B, H) bf16, w (L·14,
// H, H) int8, s (L·14, H) bf16, and the operands of the extras (null where
// the extra is off): ln (L, 8, H), ck/cv (L, 2, S, H), kc/vc (L, 2, W, H),
// kn/vn (L, 2, H) outputs. Returns a cudaError_t.
extern "C" int fgt_chain_bisect(const void* w, const void* s, const void* ln, const void* x, const void* ck,
                                const void* cv, void* kc, void* vc, void* y, void* kn, void* vn, void* scratch,
                                int L, int B, int H, int S, int W, int chunk, int offset, int extras,
                                void* stream) {
  const unsigned ex = unsigned(extras);
  if (!bisect_ok(B, H, ex) || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((ex & X_LN) && !ln) return static_cast<int>(cudaErrorInvalidValue);
  if ((ex & X_CROSS) && (!ck || !cv || S < 1)) return static_cast<int>(cudaErrorInvalidValue);
  if ((ex & X_HBM) && (!kc || !vc || W < 1)) return static_cast<int>(cudaErrorInvalidValue);
  if ((ex & X_OUTS) && (!kn || !vn)) return static_cast<int>(cudaErrorInvalidValue);
  if ((ex & X_DMA) && chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* kern = bisect_kernel(B, ex);
  const size_t smem = bisect_smem(ex, H);
  Plan p;
  cudaError_t err = make_plan(kern, true, B, H, p, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Bisect bp = {};
  Args& a = bp.a;
  a.w = w;
  a.s = static_cast<const bf16*>(s);
  a.ln = (ex & X_LN) ? static_cast<const bf16*>(ln) : nullptr;
  a.x = static_cast<const bf16*>(x);
  a.ck = static_cast<const bf16*>(ck);
  a.cv = static_cast<const bf16*>(cv);
  a.kc = kc;
  a.vc = vc;
  a.y = static_cast<bf16*>(y);
  bind_plan(p, static_cast<float*>(scratch), a);
  a.L = L;
  a.B = B;
  a.H = H;
  a.S = S;
  a.W = W;
  a.offset = offset;
  a.n_heads = H / DH;
  a.n_split = 1;
  bp.kn = static_cast<bf16*>(kn);
  bp.vn = static_cast<bf16*>(vn);
  bp.chunk = chunk;
  bp.extras = ex;
  void* args[] = {&bp};
  err = cudaLaunchCooperativeKernel(kern, dim3(p.grid), dim3(THREADS), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
