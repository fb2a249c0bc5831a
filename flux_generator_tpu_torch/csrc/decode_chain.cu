// The decode-chain probe (#11): kernel D's weight stream on D's own
// machinery, with attention as identity, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of scripts/prof_pallas_chain.py (l.81,
// pallas_call at :150), the prototype that measured the weight-streaming
// floor of the fused decode step. It streams the same packed weights — w
// (L·14, H, H) int8, s (L·14, 1, H) bf16 — through kernel D's schedule,
// weight ring and tensor-core products (decode_ring.cuh), with D's folds in
// place of its attention, so its time is what D's design pays to move the
// weights through the six projections of every layer. One layer, on x (M, H):
//   LN (no scale, no bias, eps 1e-5) → q = c0; c1 and c2 computed and parked
//   (read and multiplied like q, their traffic is the point; 0·(k + v)[:, 0]
//   joins the residual); x += c3·q; LN → x += c5·(c4·LN); LN → up c6..c9 →
//   per chunk GELU → Σ c10..c13 → x += Σ.
// GELU uses erff; the TPU kernel's Abramowitz–Stegun polynomial (max error
// 1.5e-7) stood in only because Mosaic lacks erf.
//
// Bound: 48 × 14 × 1536² int8 bytes = 1.585 GB a step, 0.4733 ms at
// 3.35 TB/s. The design, the numerics and the six grid syncs a layer are
// decode_probe.cuh's (the chain-bisect probe without extras, but for the
// GELU).

#include "decode_probe.cuh"

namespace {

const void* chain_kernel() { return reinterpret_cast<const void*>(probe_kernel<GELU_ERF, 0>); }

}  // namespace

// f32 scratch the kernel needs for B rows of width H (0 when the shape is not taken).
extern "C" int fgt_decode_chain_scratch_floats(int B, int H) {
  Plan p;
  if (!shape_ok(B, H)) return 0;
  return make_plan(chain_kernel(), B, H, p) == cudaSuccess ? static_cast<int>(p.total) : 0;
}

// The kernel's registers a thread, local memory bytes a thread, shared
// memory bytes a block, resident blocks an SM, ring stages, grid syncs a layer.
extern "C" int fgt_decode_chain_info(int* regs, int* local_bytes, int* smem_bytes, int* blocks_per_sm,
                                     int* ring_stages, int* syncs_per_layer) {
  return probe_info(chain_kernel(), regs, local_bytes, smem_bytes, blocks_per_sm, ring_stages, syncs_per_layer);
}

// One step of the chain through all L layers: y (B, H) bf16 from x (B, H)
// bf16, w (L·14, H, H) int8, s (L·14, H) bf16, both 16-byte aligned. timers
// may be null, or take 6·L + 1 u64 stamps of the device clock (ns): block 0
// after each grid sync, then at its end. Returns a cudaError_t.
extern "C" int fgt_decode_chain(const void* w, const void* s, const void* x, void* y, void* scratch, int L,
                                int B, int H, void* timers, void* stream) {
  if (!shape_ok(B, H) || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.s = static_cast<const bf16*>(s);
  a.x = static_cast<const bf16*>(x);
  a.y = static_cast<bf16*>(y);
  a.timers = static_cast<unsigned long long*>(timers);
  a.L = L;
  a.B = B;
  a.H = H;
  return static_cast<int>(probe_launch(chain_kernel(), w, a, static_cast<float*>(scratch), stream));
}
