// LSTM recurrence with the recurrent weight resident on chip, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_lstm_kernel` (pallas_call at
// flux_generator_tpu/ops/pallas/lstm.py:105), with the contract of `lstm_pallas`:
// the input projection xw = x·Wx + b is computed outside, and per step
//   gates = xw_t + (h cast to Wh's dtype)·Wh     (f32 accumulation)
//   (i, f, g, o) = split(gates);  c = σ(f)·c + σ(i)·tanh(g);  h = σ(o)·tanh(c)
// with c and h in f32, h written out in the output dtype. xw and Wh are both
// bf16 (EnCodec's d = 1024) or both f32 (small d).
//
// Bound: latency. Every step needs all of h from the step before, and Wh
// (d × 4d, 8 MB in bf16 at d = 1024) fits no single SM, so the steps run one
// after another across the grid; the bytes (xw, Wh, out once) take a few µs
// at 3.35 TB/s, the T exchanges of h across the grid far more. So the design
// keeps everything but the matvec and one exchange off a step's critical path:
// - Wh resident on chip: block j owns hidden units [j·U, (j+1)·U), U =
//   ⌈d / SMs⌉ (8 at d = 1024 on 132 SMs: 128 blocks), one warp a unit; lane
//   l takes its unit's four gate columns at rows k = 4l + 128i + e. Where
//   d ≤ 1024 and U ≤ 8 the lane holds them in registers as f32 (4·KPL
//   values: 128 registers at d = 1024), staged once through shared memory;
//   otherwise (a card with fewer SMs, d > 1024) the block's columns stay in
//   shared memory in Wh's dtype and a block has up to 16 warps (d up to
//   about 1600 in bf16 on 132 SMs: what shared memory holds). A step's
//   matvec is 16-byte loads of h a lane from shared memory (rows of h laid
//   out as the words, so that a lane's reads stay in their batch row) and
//   f32 FMAs in a fixed order (the same in both layouts), then the four gates' sums over the warp in six shuffles (lanes
//   8G..8G+7 end with gate G's): two calls agree bit for bit.
//   Each gate's activation runs on its own lanes (σ from the hardware
//   exponential, tanh as 2σ(2v) − 1) and lane 0 updates c and h.
// - xw ahead of time: lanes 0-3 of each warp keep a shared-memory ring of
//   their unit's four gate inputs RING (step, batch) pairs ahead with 4-byte
//   cp.async copies (a bf16 value from its aligned word), so no step waits
//   on a global load; the ring is read before the step waits for h.
// - h exchanged as flagged words instead of a grid barrier: each warp
//   publishes h_t of its unit as one 8-byte word {f32 value, step tag t + 1}
//   (one 64-bit store: value and tag land together, so no fence is needed,
//   as in NCCL's low-latency protocol; a batch row of words is padded to a
//   multiple of 4, or with Wh in registers and B > 1 to the 32·KPL rows a
//   lane's reads of h span, the padding published as zeros by unit d - 1's
//   warp);
//   every thread polls only its share of the words (two per 16-byte relaxed
//   load at GPU scope) until their tags read t + 1, rounds them to Wh's
//   dtype into shared memory, and one __syncthreads publishes them to the
//   block. The words are double-buffered
//   by the parity of t: a block writes h_{t+1} only after it has read all of
//   h_t, which every block published only after it had read all of h_{t-1},
//   so the slot it overwrites is no longer read. The wrapper zeroes the words
//   each call and tags start at 1, so no stale tag matches.
// The launch is cooperative (cudaLaunchCooperativeKernel): it guarantees that
// every block is resident, which the polling needs, and it fails rather than
// run with blocks that cannot all be resident.
//
// Modes: RUN; PHASES, where block 0's thread 0 sums the device clock over the
// steps by phase (xw ring, h exchange, matvec, gates) into timers[4], in ns;
// FLOOR, the serial floor: T exchanges of flagged words across the same grid
// with no gate math (each unit publishes 0 tagged t + 1), reading no xw or Wh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_REG_UNITS = 8;  // warps (units) a block with Wh in registers: 256 threads
constexpr int MAX_UNITS = 16;     // with Wh in shared memory: 512 threads (128 registers a thread)
constexpr int RING = 8;           // xw (step, batch) pairs a warp keeps ahead
enum Mode { RUN = 0, PHASES = 1, FLOOR = 2 };

// σ(v) and tanh(v) = 2σ(2v) − 1 from the hardware exponential and a correctly
// rounded reciprocal: within a few 1e-7 of the library functions
__device__ __forceinline__ float sigmoid(float v) { return __frcp_rn(1.f + __expf(-v)); }
__device__ __forceinline__ float tanh_fast(float v) { return 2.f * sigmoid(2.f * v) - 1.f; }

template <typename WT>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(WT) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <typename WT>
__device__ __forceinline__ float load_f32(const WT* p) {
  if constexpr (sizeof(WT) == 2) return __bfloat162float(*p);
  return *p;
}

// a value of WT from the 4-byte word that holds it, copied from `addr`
template <typename WT>
__device__ __forceinline__ float from_word(uint32_t w, const WT* addr) {
  if constexpr (sizeof(WT) == 2) {
    return __uint_as_float((reinterpret_cast<uintptr_t>(addr) & 2) ? (w & 0xffff0000u) : (w << 16));
  }
  return __uint_as_float(w);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_ring() { asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 1) : "memory"); }

__device__ __forceinline__ ulonglong2 ld_words(const unsigned long long* p) {
  ulonglong2 v;
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];\n" : "=l"(v.x), "=l"(v.y) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_word(unsigned long long* p, float h, uint32_t tag) {
  const unsigned long long v = (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(h);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ uint32_t tag_of(unsigned long long w) { return static_cast<uint32_t>(w >> 32); }

__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__host__ __device__ inline int wpitch(int kpl) { return 32 * kpl + 4; }  // a column staged for registers, f32
__host__ __device__ inline int dpad(int d) { return (d + 3) & ~3; }  // d rounded up to 16-byte rows
// A batch row of h words, and of h in shared memory: d rounded up to a
// multiple of 4, but with Wh in registers and B > 1 the 32·KPL rows a lane's
// reads span, so that they stay in their batch row (the padding published as
// zeros by unit d - 1's warp). The wrapper's `_words` follows this rule.
template <int KPL>
__host__ __device__ inline int wpitch_h(int B, int d) { return KPL && B > 1 ? 32 * KPL : dpad(d); }

struct Args {
  const void* xw;               // (B, T, 4d) WT
  const void* wh;               // (d, 4d) WT
  void* out;                    // (B, T, d) f32 or bf16
  unsigned long long* words;    // (2, B, dpad(d)) flagged h words, zeroed
  unsigned long long* timers;   // PHASES: 4 sums in ns
  int B, T, d, U, out_bf16;
};

// Shared memory. KPL > 0 (Wh in registers): the staged Wh columns at
// start-up, then h's two parities in the same bytes, each B rows of
// wpitch_h and 32·KPL zeros that the last row's reads may reach. KPL 0: the
// block's Wh columns in WT (none in FLOOR), then h's two parities. Then each
// warp's xw ring (RING × 4 words) and its unit's c (B f32).
template <typename WT, int KPL, int MODE>
__host__ __device__ inline size_t w_bytes(int d, int U) {
  if (MODE == FLOOR) return 0;
  if (KPL) return size_t(4) * U * wpitch(KPL) * 4;
  return (size_t(4) * U * dpad(d) * sizeof(WT) + 15) & ~size_t(15);
}

template <typename WT, int KPL, int MODE>
__host__ __device__ inline size_t h_offset(int d, int U) {
  return KPL ? 0 : w_bytes<WT, KPL, MODE>(d, U);
}

template <int KPL>
__host__ __device__ inline size_t h_floats(int B, int d) {
  return size_t(B) * wpitch_h<KPL>(B, d) + 32 * KPL;
}

template <typename WT, int KPL, int MODE>
__host__ __device__ inline size_t smem_bytes(int B, int d, int U) {
  const size_t w = w_bytes<WT, KPL, MODE>(d, U);
  const size_t h = size_t(2) * h_floats<KPL>(B, d) * 4;
  return (KPL ? (w > h ? w : h) : w + h) + size_t(U) * RING * 4 * 4 + size_t(U) * B * 4;
}

// four consecutive values of a Wh column in shared memory, as f32
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u), __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

template <typename WT, int KPL, int MODE>
__global__ void __launch_bounds__(KPL ? MAX_REG_UNITS * 32 : MAX_UNITS * 32, 1) lstm_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NI = KPL / 4;  // 16-byte loads of h a lane a column, Wh in registers
  const int B = a.B, T = a.T, d = a.d, U = a.U;
  const int NT = 32 * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, d - u0);  // units of this block (the last may have fewer)
  const bool active = warp < nu;
  const int unit = u0 + warp;
  const size_t d4 = size_t(4) * d;
  const WT* xw = static_cast<const WT*>(a.xw);

  const int dp = wpitch_h<KPL>(B, d);
  const size_t hstride = h_floats<KPL>(B, d);
  float* hs = reinterpret_cast<float*>(smem_raw + h_offset<WT, KPL, MODE>(d, U));  // [2][hstride]
  const size_t region = smem_bytes<WT, KPL, MODE>(B, d, U) - size_t(U) * RING * 16 - size_t(U) * B * 4;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem_raw + region) + warp * RING * 4;  // [RING][4]
  float* cs = reinterpret_cast<float*>(smem_raw + region + size_t(U) * RING * 16) + warp * B;
  const WT* wh = static_cast<const WT*>(a.wh);
  // Wh (k, gate g, unit u0 + uu), 0 past d and past the block's units
  auto wh_at = [&](int k, int g, int uu) {
    return k < d && uu < nu ? load_f32(wh + size_t(k) * d4 + size_t(g) * d + u0 + uu) : 0.f;
  };

  // KPL > 0: Wh's four gate columns of this warp's unit, rows 4·lane + 128·i + e, as f32
  float w[4][NI > 0 ? NI : 1][4];
  // KPL 0: the block's columns (unit, gate) in shared memory, dp rows each
  WT* wsm = reinterpret_cast<WT*>(smem_raw);
  if constexpr (MODE != FLOOR && KPL > 0) {
    float* ws = reinterpret_cast<float*>(smem_raw);  // [U · 4][wpitch]: column (unit, gate)
    for (int i = tid; i < 4 * U * 32 * KPL; i += NT) {
      const int j = i % (4 * U), k = i / (4 * U);
      ws[(j % U * 4 + j / U) * wpitch(KPL) + k] = wh_at(k, j / U, j % U);
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float4 v = load4(ws + (warp * 4 + g) * wpitch(KPL) + 4 * lane + 128 * i);
        w[g][i][0] = v.x;
        w[g][i][1] = v.y;
        w[g][i][2] = v.z;
        w[g][i][3] = v.w;
      }
    }
    __syncthreads();  // the staging area becomes h's buffers
  } else if constexpr (MODE != FLOOR) {
    for (int i = tid; i < 4 * U * dp; i += NT) {
      const int j = i % (4 * U), k = i / (4 * U);
      wsm[(j % U * 4 + j / U) * dp + k] = static_cast<WT>(wh_at(k, j / U, j % U));
    }
  }
  for (int i = tid; i < int(2 * hstride); i += NT) hs[i] = 0.f;
  for (int i = lane; i < B; i += 32) cs[i] = 0.f;

  // the xw ring: lane g < 4 copies gate g of pair (t, b) into ring[(t·B + b) % RING][g]
  auto xw_addr = [&](int t, int b) { return xw + (size_t(b) * T + t) * d4 + size_t(lane) * d + unit; };
  auto refill = [&](int t, int b) {
    if (lane < 4 && active && t < T) {
      const WT* p = xw_addr(t, b);
      cp_async4(static_cast<uint32_t>(__cvta_generic_to_shared(ring + ((t * B + b) % RING) * 4 + lane)),
                reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(3)));
    }
    cp_commit();
  };
  const int ahead_t = RING / B, ahead_b = RING % B;  // RING pairs ahead of (t, b)
  // pair (t, b)'s input of gate lane / 8 on every lane; refills its slot RING pairs ahead
  auto fetch = [&](int t, int b) {
    cp_wait_ring();
    float v = 0.f;
    if (lane < 4 && active) v = from_word(ring[((t * B + b) % RING) * 4 + lane], xw_addr(t, b));
    const float xv = __shfl_sync(0xffffffffu, v, lane >> 3);
    const int nb = b + ahead_b;
    refill(t + ahead_t + (nb >= B), nb >= B ? nb - B : nb);
    return xv;
  };
  if constexpr (MODE != FLOOR) {
    for (int t = 0, b = 0, q = 0; q < RING; ++q) {
      refill(t, b);
      if (++b == B) b = 0, ++t;
    }
  }
  __syncthreads();

  const bool stamp = MODE == PHASES && blockIdx.x == 0 && tid == 0;
  unsigned long long ph[4] = {0, 0, 0, 0}, t0 = 0;
  auto lap = [&](int i) {
    if (stamp) {
      const unsigned long long t1 = clock_ns();
      ph[i] += t1 - t0;
      t0 = t1;
    }
  };
  const int n = B * dp;  // words a parity, as many as h's floats in shared memory
  for (int t = 0; t < T; ++t) {
    if (stamp) t0 = clock_ns();
    float xv = 0.f;
    if constexpr (MODE != FLOOR) xv = fetch(t, 0);
    lap(0);
    float* hcur = hs + (t & 1) * hstride;
    if (t > 0) {  // h_{t-1}: the words of parity (t - 1) & 1, tagged t
      const unsigned long long* src = a.words + size_t((t - 1) & 1) * n;
      const uint32_t tag = static_cast<uint32_t>(t);
      for (int p0 = 2 * tid; p0 < n; p0 += 8 * NT) {
        unsigned long long v[8];
        bool ready;
        do {
          ready = true;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = p0 + 2 * j * NT;  // n is a multiple of 4: p < n takes words p and p + 1
            if (p < n) {
              const ulonglong2 two = ld_words(src + p);
              v[2 * j] = two.x;
              v[2 * j + 1] = two.y;
              ready &= tag_of(two.x) == tag && tag_of(two.y) == tag;
            }
          }
        } while (!ready);
        if constexpr (MODE == FLOOR) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int p = p0 + 2 * (e / 2) * NT + (e & 1);
          if (p < n) hcur[p] = round_to<WT>(__uint_as_float(static_cast<uint32_t>(v[e])));
        }
      }
      __syncthreads();
    }
    lap(1);
    unsigned long long* dst = a.words + size_t(t & 1) * n;
    // the warp of unit d - 1 also publishes the padding words of each row (zeros)
    const bool pads = active && unit == d - 1;
    for (int b = 0; b < B; ++b) {
      if (pads)
        for (int k = d + lane; k < dp; k += 32) st_word(dst + size_t(b) * dp + k, 0.f, t + 1);
      if constexpr (MODE == FLOOR) {
        if (active && lane == 0) st_word(dst + size_t(b) * dp + unit, 0.f, t + 1);
        continue;
      } else {
        if (b > 0) xv = fetch(t, b);
        // a gate's sum over even and odd 128-row slices i (a fixed order); a
        // lane's reads stay in its batch row, so rows stay independent
        const float* hb = hcur + b * dp;
        float acc[4][2] = {};
        if constexpr (KPL > 0) {
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const float4 hv = load4(hb + 4 * lane + 128 * i);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              float& s = acc[g][i & 1];
              s = fmaf(hv.x, w[g][i][0], s);
              s = fmaf(hv.y, w[g][i][1], s);
              s = fmaf(hv.z, w[g][i][2], s);
              s = fmaf(hv.w, w[g][i][3], s);
            }
          }
        } else {
          const WT* wc = wsm + size_t(warp) * 4 * dp;
          for (int k = 4 * lane; k < dp; k += 256) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int kk = k + 128 * half;
              if (kk < dp) {
                const float4 hv = load4(hb + kk);
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                  const float4 wv = load4(wc + g * dp + kk);
                  float& s = acc[g][half];
                  s = fmaf(hv.x, wv.x, s);
                  s = fmaf(hv.y, wv.y, s);
                  s = fmaf(hv.z, wv.z, s);
                  s = fmaf(hv.w, wv.w, s);
                }
              }
            }
          }
        }
        // the four sums over the warp in six shuffles: lanes 8G..8G+7 end with gate G's
        const bool hi16 = lane & 16, hi8 = lane & 8;
        const float s0 = acc[0][0] + acc[0][1], s1 = acc[1][0] + acc[1][1];
        const float s2 = acc[2][0] + acc[2][1], s3 = acc[3][0] + acc[3][1];
        const float a0 = (hi16 ? s2 : s0) + __shfl_xor_sync(0xffffffffu, hi16 ? s0 : s2, 16);
        const float a1 = (hi16 ? s3 : s1) + __shfl_xor_sync(0xffffffffu, hi16 ? s1 : s3, 16);
        float sum = (hi8 ? a1 : a0) + __shfl_xor_sync(0xffffffffu, hi8 ? a0 : a1, 8);
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (b == 0) lap(2);
        // gate G's activation on its lanes (the cell gate's tanh as 2σ(2v) − 1), gathered on lane 0
        const bool cell = (lane >> 3) == 2;
        const float sg = sigmoid(cell ? 2.f * (xv + sum) : xv + sum);
        const float act = cell ? 2.f * sg - 1.f : sg;
        const float fg = __shfl_sync(0xffffffffu, act, 8);
        const float gg = __shfl_sync(0xffffffffu, act, 16);
        const float og = __shfl_sync(0xffffffffu, act, 24);
        if (active && lane == 0) {
          const float c = fg * cs[b] + act * gg;
          cs[b] = c;
          const float h = og * tanh_fast(c);
          st_word(dst + size_t(b) * dp + unit, h, t + 1);
          const size_t o = (size_t(b) * T + t) * d + unit;
          if (a.out_bf16) {
            static_cast<bf16*>(a.out)[o] = __float2bfloat16_rn(h);
          } else {
            static_cast<float*>(a.out)[o] = h;
          }
        }
      }
    }
    lap(3);
  }
  if (stamp) {
    for (int i = 0; i < 4; ++i) a.timers[i] = ph[i];
  }
}

template <typename WT, int KPL, int MODE>
cudaError_t launch(Args a, int n_sm, int dev, cudaStream_t stream) {
  const size_t smem = smem_bytes<WT, KPL, MODE>(a.B, a.d, a.U);
  int max_smem = 0;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  auto kern = lstm_kernel<WT, KPL, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int threads = 32 * a.U, blocks = (a.d + a.U - 1) / a.U;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * n_sm < blocks) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(blocks), dim3(threads), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename WT, int MODE>
cudaError_t launch_kpl(Args a, int kpl, int n_sm, int dev, cudaStream_t stream) {
  switch (kpl) {
    case 0: return launch<WT, 0, MODE>(a, n_sm, dev, stream);
    case 8: return launch<WT, 8, MODE>(a, n_sm, dev, stream);
    case 16: return launch<WT, 16, MODE>(a, n_sm, dev, stream);
    default: return launch<WT, 32, MODE>(a, n_sm, dev, stream);
  }
}

}  // namespace

// xw (B, T, 4d) and wh (d, 4d): bf16 when wh_is_bf16 else f32, xw 4-byte
// aligned; out (B, T, d): bf16 when out_is_bf16 else f32; words: 2 parities
// of B rows of d 8-byte words each rounded up to a multiple of 4, zeroed.
// The geometry (`lstm_geometry` in the wrapper): `units` hidden units a
// block (a warp each, 1-16), `kpl` 8, 16 or 32 for Wh in registers (32·kpl
// ≥ d, units ≤ 8) or 0 for Wh in shared memory. Mode 0 runs, 1 also sums
// the phases into timers[4] (ns), 2 runs the serial floor (xw, wh and out
// unused). Returns a cudaError_t: cudaErrorInvalidValue also when a block's
// shared memory does not fit the card, cudaErrorCooperativeLaunchTooLarge
// when the grid cannot be resident at once.
extern "C" int fgt_lstm_recurrence(const void* xw, const void* wh, void* out, void* words, int B, int T, int d,
                                   int units, int kpl, int wh_is_bf16, int out_is_bf16, int mode, void* timers,
                                   void* stream) {
  const bool regs = kpl == 8 || kpl == 16 || kpl == 32;
  if (B <= 0 || T <= 0 || d <= 0 || units < 1 || units > MAX_UNITS || (kpl != 0 && !regs) ||
      (regs && (units > MAX_REG_UNITS || 32 * kpl < d)) || mode < 0 || mode > 2 || (mode == 1 && !timers) ||
      (mode != 2 && reinterpret_cast<uintptr_t>(xw) % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, n_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop || n_sm <= 0) return static_cast<int>(cudaErrorNotSupported);
  Args a{xw, wh, out, static_cast<unsigned long long*>(words), static_cast<unsigned long long*>(timers),
         B, T, d, units, out_is_bf16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 2) err = launch<float, 0, FLOOR>(a, n_sm, dev, st);
  else if (wh_is_bf16) err = mode ? launch_kpl<bf16, PHASES>(a, kpl, n_sm, dev, st) : launch_kpl<bf16, RUN>(a, kpl, n_sm, dev, st);
  else err = mode ? launch_kpl<float, PHASES>(a, kpl, n_sm, dev, st) : launch_kpl<float, RUN>(a, kpl, n_sm, dev, st);
  return static_cast<int>(err);
}
