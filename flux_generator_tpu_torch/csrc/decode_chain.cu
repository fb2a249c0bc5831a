// The decode-chain probe: the weight stream of kernel D's first design with
// attention as identity, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of scripts/prof_pallas_chain.py (l.81,
// pallas_call at :150), the prototype that measured the weight-streaming
// floor of the fused decode step. It streams the same packed weights — w
// (L·14, H, H) int8, s (L·14, 1, H) bf16 — through the same 14-chunk schedule
// as kernel D (decode_step.cu), and does nothing else, so its time was the
// first design's floor for moving the weights; it stays as a fixed yardstick
// for D, whose own design is now another. One layer, on x (M, H):
//   LN (no scale, no bias, eps 1e-5) → q = c0; c1 and c2 computed and parked
//   (read and multiplied like q, their traffic is the point); x += c3·q;
//   LN → x += c5·(c4·LN); LN → up c6..c9 → per chunk GELU → Σ c10..c13 → x += Σ.
// Dots as D's: inputs rounded to bf16, w.bf16 · s.bf16 rounded to bf16, f32
// accumulation. GELU uses erff; the TPU kernel's Abramowitz–Stegun
// polynomial (max error 1.5e-7) stood in only because Mosaic lacks erf.
//
// Bound: 48 × 14 × 1536² int8 bytes = 1.585 GB a step, 0.4733 ms at
// 3.35 TB/s. The design is D's (decode_common.cuh): one cooperative launch
// per step, projections over cp.async-staged weight tiles with the next
// phase's first tile staged ahead, a grid sync between dependent phases
// (9 a layer), fixed-order partial sums.

#include "decode_common.cuh"

namespace {

template <int MB>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) decode_chain_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const Proj qkv{0, 3, 1, a.ks_qkv}, o{3, 1, 1, a.ks_o}, cq{4, 1, 1, a.ks_o}, co{5, 1, 1, a.ks_o};
  const Proj up{6, 4, 1, a.ks_up}, down{10, 1, 4, a.ks_dn};
  const int H = a.H;
  stage_next<true>(a, 0, qkv, smem);
  residual(a, 0, true, false, smem);
  grid.sync();
  for (int l = 0; l < a.L; ++l) {
    projection<true, MB>(a, l, qkv, A_LN, 0, 0, 0, a.pa, smem);  // q, and k/v parked
    stage_next<true>(a, l, o, smem);
    grid.sync();
    projection<true, MB>(a, l, o, A_SUM, 0, a.ks_qkv, 3 * H, a.pb, smem);  // identity attention
    stage_next<true>(a, l, cq, smem);
    grid.sync();
    residual(a, a.ks_o, false, false, smem);
    grid.sync();
    projection<true, MB>(a, l, cq, A_LN, 0, 0, 0, a.pa, smem);
    stage_next<true>(a, l, co, smem);
    grid.sync();
    projection<true, MB>(a, l, co, A_SUM, 0, a.ks_o, H, a.pb, smem);
    stage_next<true>(a, l, up, smem);
    grid.sync();
    residual(a, a.ks_o, false, false, smem);
    grid.sync();
    projection<true, MB>(a, l, up, A_LN, 0, 0, 0, a.pa, smem);
    stage_next<true>(a, l, down, smem);
    grid.sync();
    projection<true, MB>(a, l, down, A_GELU, 0, a.ks_up, 4 * H, a.pb, smem);
    stage_next<true>(a, l + 1, qkv, smem);
    grid.sync();
    residual(a, 4 * a.ks_dn, false, l + 1 == a.L, smem);
    if (l + 1 < a.L) grid.sync();
  }
}

const void* chain_kernel(int B) {
  return B <= 2 ? reinterpret_cast<const void*>(decode_chain_kernel<2>)
                : reinterpret_cast<const void*>(decode_chain_kernel<MAXB>);
}

}  // namespace

// f32 scratch the kernel needs for B rows of width H (0 when the shape is not taken).
extern "C" int fgt_decode_chain_scratch_floats(int B, int H) {
  Plan p;
  if (!shape_ok(B, H)) return 0;
  return make_plan(chain_kernel(B), true, B, H, p) == cudaSuccess ? static_cast<int>(p.total) : 0;
}

// One step of the chain through all L layers: y (B, H) bf16 from x (B, H)
// bf16, w (L·14, H, H) int8, s (L·14, H) bf16. Returns a cudaError_t.
extern "C" int fgt_decode_chain(const void* w, const void* s, const void* x, void* y, void* scratch, int L,
                                int B, int H, void* stream) {
  if (!shape_ok(B, H) || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* kern = chain_kernel(B);
  Plan p;
  cudaError_t err = make_plan(kern, true, B, H, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a = {};
  a.w = w;
  a.s = static_cast<const bf16*>(s);
  a.ln = nullptr;
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<bf16*>(y);
  bind_plan(p, static_cast<float*>(scratch), a);
  a.L = L;
  a.B = B;
  a.H = H;
  a.n_heads = H / DH;
  a.n_split = 1;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kern, dim3(p.grid), dim3(THREADS), args, SMEM_BYTES,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
