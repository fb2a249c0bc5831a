// The chain-bisect probe (#12): the decode-chain probe (#11) with the
// structural pieces of the fused decode step (kernel D) added one at a time,
// each built where and as D builds it, for Hopper (sm_90a).
//
// Replaces the TPU kernel built by `make_kernel` in scripts/prof_chain_bisect.py
// (l.57; pallas_call at :269). One step runs x (M, H) bf16 through L layers of
// 14 int8 (H, H) weight chunks with bf16 scales, as #11 does, with GELU in
// the tanh form, 0.5·g·(1 + tanh(0.7978845608·(g + 0.044715·g³))), and the
// script's extras, cumulative in its ladder: smem, ln, cross, hbm, bufs,
// outs, dma. What each extra builds, the design, the numerics and the bound
// are decode_probe.cuh's. B (the cross, cache and output rows) is the
// script's 2; M 1..8, M ≥ 2 with outs.

#include "decode_probe.cuh"

namespace {

// The ladder's rungs have instantiations of their own, masked to the extras
// that change code, so a rung's kernel carries only its structure (smem,
// hbm and bufs share the rung before's); any other set of extras runs the
// one that reads them at run time.
const void* bisect_kernel(unsigned extras) {
  switch (extras & X_CODE) {
    case 0: return reinterpret_cast<const void*>(probe_kernel<GELU_TANH, 0>);
    case X_LN: return reinterpret_cast<const void*>(probe_kernel<GELU_TANH, X_LN>);
    case X_LN | X_CROSS: return reinterpret_cast<const void*>(probe_kernel<GELU_TANH, X_LN | X_CROSS>);
    case X_LN | X_CROSS | X_OUTS:
      return reinterpret_cast<const void*>(probe_kernel<GELU_TANH, X_LN | X_CROSS | X_OUTS>);
    case X_CODE: return reinterpret_cast<const void*>(probe_kernel<GELU_TANH, X_CODE>);
    default: return reinterpret_cast<const void*>(probe_kernel<GELU_TANH, X_RUNTIME>);
  }
}

bool bisect_ok(int B, int H, unsigned extras) {
  if (!shape_ok(B, H) || extras > X_ALL) return false;
  if ((extras & X_DMA) && (extras & (X_HBM | X_BUFS)) != (X_HBM | X_BUFS)) return false;
  return !(extras & X_OUTS) || B >= CB;
}

}  // namespace

// The launch plan for B rows of width H with `extras` (the script's order,
// bit i for extra i): out[0] the grid, out[1] resident blocks an SM, out[2]
// dynamic shared memory a block in bytes, out[3] the f32 scratch in floats,
// out[4] grid syncs a layer.
extern "C" int fgt_chain_bisect_plan(int B, int H, int extras, int* out) {
  if (!bisect_ok(B, H, unsigned(extras))) return static_cast<int>(cudaErrorInvalidValue);
  const void* kern = bisect_kernel(unsigned(extras));
  Plan p;
  cudaError_t err = make_plan(kern, B, H, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kern, THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.grid;
  out[2] = static_cast<int>(SMEM_BYTES);
  out[3] = static_cast<int>(p.total);
  out[4] = SYNCS_PER_LAYER;
  return 0;
}

// One step through all L layers: y (B, H) bf16 from x (B, H) bf16, w (L·14,
// H, H) int8, s (L·14, H) bf16, and the operands of the extras (null where
// the extra is off): ln (L, 8, H), ck/cv (L, 2, S, H), kc/vc (L, 2, W, H),
// kn/vn (L, 2, H) outputs; w, s, ln, kc and vc 16-byte aligned. With dma,
// `touched` is the cache row of b 0 whose K and V join the o input as 0·.
// Returns a cudaError_t.
extern "C" int fgt_chain_bisect(const void* w, const void* s, const void* ln, const void* x, const void* ck,
                                const void* cv, const void* kc, const void* vc, void* y, void* kn, void* vn,
                                void* scratch, int L, int B, int H, int S, int W, int touched, int offset,
                                int extras, void* stream) {
  const unsigned ex = unsigned(extras);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (!bisect_ok(B, H, ex) || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((ex & X_LN) && (!ln || misaligned(ln))) return static_cast<int>(cudaErrorInvalidValue);
  if ((ex & X_CROSS) && (!ck || !cv || S < 1)) return static_cast<int>(cudaErrorInvalidValue);
  if ((ex & X_HBM) && (!kc || !vc || W < 1 || misaligned(kc) || misaligned(vc)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((ex & X_OUTS) && (!kn || !vn)) return static_cast<int>(cudaErrorInvalidValue);
  if ((ex & X_DMA) && (touched < 0 || touched >= W)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.s = static_cast<const bf16*>(s);
  a.ln = (ex & X_LN) ? static_cast<const bf16*>(ln) : nullptr;
  a.x = static_cast<const bf16*>(x);
  a.ck = static_cast<const bf16*>(ck);
  a.cv = static_cast<const bf16*>(cv);
  a.kc = static_cast<const bf16*>(kc);
  a.vc = static_cast<const bf16*>(vc);
  a.y = static_cast<bf16*>(y);
  a.kn = static_cast<bf16*>(kn);
  a.vn = static_cast<bf16*>(vn);
  a.L = L;
  a.B = B;
  a.H = H;
  a.S = S;
  a.W = W;
  a.offset = offset;
  a.touched = (ex & X_DMA) ? touched : 0;
  a.extras = ex;
  return static_cast<int>(probe_launch(bisect_kernel(ex), w, a, static_cast<float*>(scratch), stream));
}
