// The fused MusicGen decode step: all decoder layers of one AR step in one
// persistent cooperative launch, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_kernel` (v1, pallas_call at
// flux_generator_tpu/ops/pallas/decode_layer.py:1180), `_kernel2` (v2, :1083)
// and `_kernel3` (v3, :984). The three share one contract and differ only in
// how the KV-cache window reaches the TPU's 16 MB VMEM (manual double-buffered
// DMA, at most two blocked chunks, or streamed grid phases). This kernel reads
// the live rows of a window of any length straight from device memory.
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
// float8_e4m3fn in int8 buffers, decode_layer.py:80-117). In the e4m3 tier the
// window's rows come in as bytes (16 elements a 16-byte load) and widen
// exactly in registers through cuda_fp8.h's cvt (e4m3 → f16 → f32); the TPU
// kernels decode them arithmetically only because Mosaic's convert was slow,
// and the value is the same. The current token's attention is seeded with its
// bf16 k/v rows, as in JAX, and the rows are then stored as e4m3 with
// saturation to ±448 and rounding to nearest even — the bytes of JAX's
// `store_kv_rows` (decode_layer.py:103-117), which encodes them outside its
// kernel.
//
// Numerics of the JAX kernel: see decode_common.cuh; q scaled by 1/8 and
// rounded to bf16; f32 logits and running-max softmax divided at the end, P
// rounded to bf16 for P·V.
//
// Bound: at MusicGen-medium one step streams 48 × 14 chunks of 1536² weights
// (1.59 GB in int8) at M = B ≤ 8 rows, plus the live cache window (2 bytes an
// element in bf16, 1 in e4m3), so the step is a chain of weight-bound GEMVs
// whose every phase needs the whole output of the one before it. The design
// is the TPU kernel's, one launch per step instead of ~480: a grid of
// co-resident blocks (sized from the occupancy query; the launch fails rather
// than run blocks that cannot all be resident) walks 11 phases per layer with
// a grid.sync() between them (decode_common.cuh: projection, residual), and
//   attention    self-attention splits the cache rows of each (row, head)
//                over up to 8 blocks (at least 64 rows each; the count
//                depends on the offset and the device, not on B), and
//                cross-attention takes one block per (row, head); a block
//                scores one row per thread with an online softmax over
//                256-row chunks and leaves its unnormalised output with its
//                running max and sum, which the o-projection merges while it
//                loads its input.
// Batches of at most 2 rows take an instantiation with 2 accumulator rows.
// Not yet used: tensor cores, TMA, fewer phases.

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "decode_common.cuh"

namespace {

constexpr int ROWS_PER_SPLIT = 64;  // fewest cache rows worth a block of their own
constexpr int CH = THREADS;         // attention rows per chunk
constexpr float NEG = -1e30f;

// Two e4m3 bytes (the lower address in the low byte) → two f32, exactly.
__device__ __forceinline__ float2 e4m3x2(uint32_t two_bytes) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(two_bytes), __NV_E4M3);
  return __half22float2(__half2(h));
}

// The cache element: bf16, or e4m3 bytes (F8).
template <bool F8>
struct Cache;
template <>
struct Cache<false> {
  using T = bf16;
  static __device__ __forceinline__ T encode(bf16 v) { return v; }
  // q · k over one 64-dim row, in dim order
  static __device__ __forceinline__ float dot(const float* q, const T* k) {
    const uint4* kr = reinterpret_cast<const uint4*>(k);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const uint4 u = kr[i];
      const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc = fmaf(q[8 * i + 2 * j], __uint_as_float(wd[j] << 16), acc);
        acc = fmaf(q[8 * i + 2 * j + 1], __uint_as_float(wd[j] & 0xFFFF0000u), acc);
      }
    }
    return acc;
  }
  // elements 2·lane and 2·lane + 1 of a row
  static __device__ __forceinline__ float2 pair(const T* v, int lane) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(v + 2 * lane);
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xFFFF0000u));
  }
};
template <>
struct Cache<true> {
  using T = __nv_fp8_storage_t;
  static __device__ __forceinline__ T encode(bf16 v) {
    return __nv_cvt_float_to_fp8(__bfloat162float(v), __NV_SATFINITE, __NV_E4M3);
  }
  static __device__ __forceinline__ float dot(const float* q, const T* k) {
    const uint4* kr = reinterpret_cast<const uint4*>(k);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < DH / 16; ++i) {
      const uint4 u = kr[i];
      const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 lo = e4m3x2(wd[j] & 0xFFFFu), hi = e4m3x2(wd[j] >> 16);
        acc = fmaf(q[16 * i + 4 * j], lo.x, acc);
        acc = fmaf(q[16 * i + 4 * j + 1], lo.y, acc);
        acc = fmaf(q[16 * i + 4 * j + 2], hi.x, acc);
        acc = fmaf(q[16 * i + 4 * j + 3], hi.y, acc);
      }
    }
    return acc;
  }
  static __device__ __forceinline__ float2 pair(const T* v, int lane) {
    return e4m3x2(*reinterpret_cast<const uint16_t*>(v + 2 * lane));
  }
};

// Self-attention over the cache (seeded with the current token, whose k/v
// rows split 0 also writes at `offset`), its rows split over n_split blocks
// per (row, head), or cross-attention over the text K/V masked at cond_len,
// one block per (row, head). Each block leaves its unnormalised output and
// running max/sum; the next projection merges the splits.
template <bool F8>
__device__ void attention(const Args& a, int layer, bool self_attn, float* smem) {
  using KV = Cache<F8>;
  using T = typename KV::T;
  const int H = a.H, B = a.B, tid = threadIdx.x;
  constexpr int GROUPS = THREADS / 32;  // P·V: 8 row groups of 32 lanes, 2 dims a lane
  float* q_s = smem + SM_A;  // [DH]
  float* kn_s = q_s + DH;    // [DH]
  float* vn_s = kn_s + DH;   // [DH]
  float* p_s = vn_s + DH;    // [CH]
  float* pv_s = p_s + CH;    // [GROUPS][DH]
  float* acc_s = pv_s + GROUPS * DH;
  float* buf = smem + SM_BUF;
  T* kc = static_cast<T*>(a.kc);
  T* vc = static_cast<T*>(a.vc);
  const int n_split = self_attn ? a.n_split : 1;
  for (int item = blockIdx.x; item < B * a.n_heads * n_split; item += gridDim.x) {
    const int split = item % n_split, bh = item / n_split;
    const int b = bh / a.n_heads, head = bh % a.n_heads, c0 = head * DH;
    const int slices = self_attn ? a.ks_qkv : a.ks_o;
    const int N = self_attn ? 3 * H : H;
    const bool seeded = self_attn && split == 0;
    if (tid < DH) {
      float q = 0.f, k = 0.f, v = 0.f;
      for (int s = 0; s < slices; ++s) {
        const float* p = a.pa + (size_t(s) * B + b) * N + c0 + tid;
        q += __ldcg(p);
        if (seeded) {
          k += __ldcg(p + H);
          v += __ldcg(p + 2 * H);
        }
      }
      q_s[tid] = bfr(q * 0.125f);
      if (seeded) {
        const bf16 kb = __float2bfloat16_rn(k), vb = __float2bfloat16_rn(v);
        kn_s[tid] = __bfloat162float(kb);
        vn_s[tid] = __bfloat162float(vb);
        const size_t row = ((size_t(layer) * B + b) * a.W + a.offset) * H + c0 + tid;
        kc[row] = KV::encode(kb);
        vc[row] = KV::encode(vb);
      }
    }
    __syncthreads();
    float m, l;
    if (seeded) {
      m = block_reduce<false>(tid < DH ? q_s[tid] * kn_s[tid] : 0.f, buf);
      l = 1.f;
      if (tid < DH) acc_s[tid] = vn_s[tid];
    } else {
      m = -INFINITY;
      l = 0.f;
      if (tid < DH) acc_s[tid] = 0.f;
    }
    int r_begin, r_end, nlive;
    const T *K = nullptr, *V = nullptr;
    const bf16 *CK = nullptr, *CV = nullptr;
    if (self_attn) {
      const int per = (a.offset + n_split - 1) / n_split;
      r_begin = min(split * per, a.offset);
      r_end = min(r_begin + per, a.offset);
      nlive = a.offset;
      K = kc + (size_t(layer) * B + b) * a.W * H + c0;
      V = vc + (size_t(layer) * B + b) * a.W * H + c0;
    } else {
      r_begin = 0;
      r_end = a.S;
      nlive = a.cond_len ? min(max(a.cond_len[b], 0), a.S) : a.S;
      CK = a.ck + (size_t(layer) * B + b) * a.S * H + c0;
      CV = a.cv + (size_t(layer) * B + b) * a.S * H + c0;
    }
    for (int r0 = r_begin; r0 < r_end; r0 += CH) {
      const int r = r0 + tid;
      float sc = -INFINITY;
      if (r < r_end) {
        if (r < nlive)
          sc = self_attn ? KV::dot(q_s, K + size_t(r) * H) : Cache<false>::dot(q_s, CK + size_t(r) * H);
        else
          sc = NEG;
      }
      const float m_new = fmaxf(m, block_reduce<true>(sc, buf));
      const float rs = expf(m - m_new);
      const float p = r < r_end ? expf(sc - m_new) : 0.f;
      p_s[tid] = bfr(p);
      l = l * rs + block_reduce<false>(p, buf);  // its barriers publish p_s
      // P·V: lane owns dims (2·lane, 2·lane+1), group g rows g, g+8, …
      const int lane = tid & 31, grp = tid >> 5;
      const int nr = min(CH, r_end - r0);
      float part0 = 0.f, part1 = 0.f;
#pragma unroll 8
      for (int rr = grp; rr < nr; rr += GROUPS) {
        if (r0 + rr < nlive) {
          const size_t off = size_t(r0 + rr) * H;
          const float2 v2 = self_attn ? KV::pair(V + off, lane) : Cache<false>::pair(CV + off, lane);
          part0 = fmaf(p_s[rr], v2.x, part0);
          part1 = fmaf(p_s[rr], v2.y, part1);
        }
      }
      pv_s[grp * DH + 2 * lane] = part0;
      pv_s[grp * DH + 2 * lane + 1] = part1;
      __syncthreads();
      if (tid < DH) {
        float sum = pv_s[tid];
#pragma unroll
        for (int g = 1; g < GROUPS; ++g) sum += pv_s[g * DH + tid];
        acc_s[tid] = acc_s[tid] * rs + sum;
      }
      m = m_new;
      __syncthreads();
    }
    if (tid < DH) a.att[(size_t(split) * B + b) * H + c0 + tid] = acc_s[tid];
    if (tid == 0) {
      float* ml = a.att_ml + ((size_t(split) * B + b) * a.n_heads + head) * 2;
      ml[0] = m;
      ml[1] = l;
    }
    __syncthreads();
  }
}

template <bool I8, int MB, bool F8>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) decode_step_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const Proj qkv{0, 3, 1, a.ks_qkv}, o{3, 1, 1, a.ks_o}, cq{4, 1, 1, a.ks_o}, co{5, 1, 1, a.ks_o};
  const Proj up{6, 4, 1, a.ks_up}, down{10, 1, 4, a.ks_dn};
  stage_next<I8>(a, 0, qkv, smem);
  residual(a, 0, true, false, smem);
  grid.sync();
  for (int l = 0; l < a.L; ++l) {
    projection<I8, MB>(a, l, qkv, A_LN, 0, 0, 0, a.pa, smem);
    stage_next<I8>(a, l, o, smem);
    grid.sync();
    attention<F8>(a, l, true, smem);
    grid.sync();
    projection<I8, MB>(a, l, o, A_ATT, 0, a.n_split, 0, a.pb, smem);
    stage_next<I8>(a, l, cq, smem);
    grid.sync();
    residual(a, a.ks_o, false, false, smem);
    grid.sync();
    projection<I8, MB>(a, l, cq, A_LN, 2, 0, 0, a.pa, smem);
    stage_next<I8>(a, l, co, smem);
    grid.sync();
    attention<F8>(a, l, false, smem);
    grid.sync();
    projection<I8, MB>(a, l, co, A_ATT, 0, 1, 0, a.pb, smem);
    stage_next<I8>(a, l, up, smem);
    grid.sync();
    residual(a, a.ks_o, false, false, smem);
    grid.sync();
    projection<I8, MB>(a, l, up, A_LN, 4, 0, 0, a.pa, smem);
    stage_next<I8>(a, l, down, smem);
    grid.sync();
    projection<I8, MB>(a, l, down, A_GELU, 0, a.ks_up, 4 * a.H, a.pb, smem);
    stage_next<I8>(a, l + 1, qkv, smem);
    grid.sync();
    residual(a, 4 * a.ks_dn, false, l + 1 == a.L, smem);
    if (l + 1 < a.L) grid.sync();
  }
}

// ------------------------------------------------------------ host side

template <bool I8, bool F8>
const void* kernel_for(int B) {
  // accumulators for 2 rows when B ≤ 2
  return B <= 2 ? reinterpret_cast<const void*>(decode_step_kernel<I8, 2, F8>)
                : reinterpret_cast<const void*>(decode_step_kernel<I8, MAXB, F8>);
}

const void* pick_kernel(int B, bool i8, bool f8) {
  if (i8) return f8 ? kernel_for<true, true>(B) : kernel_for<true, false>(B);
  return f8 ? kernel_for<false, true>(B) : kernel_for<false, false>(B);
}

}  // namespace

// f32 scratch the kernel needs for B rows of width H (0 when the shape is not taken).
extern "C" int fgt_decode_step_scratch_floats(int B, int H, int w_is_int8) {
  Plan p;
  if (!shape_ok(B, H)) return 0;
  const bool i8 = w_is_int8 != 0;
  return make_plan(pick_kernel(B, i8, false), i8, B, H, p) == cudaSuccess ? static_cast<int>(p.total) : 0;
}

// One AR step through all L layers; see the header comment. cond_len may be
// null (every text row live); kv_is_e4m3 selects the e4m3-byte cache tier.
// Returns a cudaError_t.
extern "C" int fgt_decode_step(const void* w, const void* s, const void* ln, const void* x, const void* ck,
                               const void* cv, void* kc, void* vc, const void* cond_len, void* y, void* scratch,
                               int L, int B, int H, int S, int W, int offset, int n_heads, int w_is_int8,
                               int kv_is_e4m3, void* stream) {
  if (!shape_ok(B, H) || L <= 0 || S <= 0 || n_heads * DH != H || offset < 0 || offset >= W)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool i8 = w_is_int8 != 0;
  const void* kern = pick_kernel(B, i8, kv_is_e4m3 != 0);
  Plan p;
  cudaError_t err = make_plan(kern, i8, B, H, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.w = w;
  a.s = static_cast<const bf16*>(s);
  a.ln = static_cast<const bf16*>(ln);
  a.x = static_cast<const bf16*>(x);
  a.ck = static_cast<const bf16*>(ck);
  a.cv = static_cast<const bf16*>(cv);
  a.kc = kc;
  a.vc = vc;
  a.cond_len = static_cast<const int*>(cond_len);
  a.y = static_cast<bf16*>(y);
  bind_plan(p, static_cast<float*>(scratch), a);
  // split the cache rows over the blocks that one wave of (row, head) items
  // of a CFG pair leaves idle, at least ROWS_PER_SPLIT rows a block; the
  // count does not depend on B, so a row's sums do not either
  a.n_split = std::max(1, std::min({MAX_SPLIT, p.nominal / (2 * n_heads),
                                    (offset + ROWS_PER_SPLIT - 1) / ROWS_PER_SPLIT}));
  a.L = L;
  a.B = B;
  a.H = H;
  a.S = S;
  a.W = W;
  a.offset = offset;
  a.n_heads = n_heads;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kern, dim3(p.grid), dim3(THREADS), args, SMEM_BYTES,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
