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
// (d × 4d, 8 MB in bf16 at d = 1024) fits no single SM. The TPU kernel keeps Wh
// in VMEM; here Wh is split over the grid and stays resident in shared memory
// for the whole sequence: block j owns hidden units [j·U, (j+1)·U) and holds
// their 4·U gate columns (64 KB at d = 1024, U = 8, 128 blocks). One
// cooperative launch runs all T steps. Per step each block reads h (d floats)
// from a double-buffered global array, computes its gate columns (one warp per
// column, lanes splitting d), updates its units' c and h, writes its slice of
// the next h, and the grid synchronises. The grid is sized to at most one block
// per SM, and the launch fails rather than running with blocks that cannot all
// be resident.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <typename WT>
size_t smem_bytes(int B, int d, int U) {
  const int G = 4 * U;
  return align16(size_t(G) * d * sizeof(WT)) + sizeof(float) * (size_t(B) * d + size_t(B) * U + size_t(B) * G);
}

// xw (B, T, 4d), wh (d, 4d) in WT; out (B, T, d) in OT; hbuf (2, B, d) f32 scratch.
template <typename WT, typename OT>
__global__ void __launch_bounds__(THREADS) lstm_kernel(const WT* __restrict__ xw, const WT* __restrict__ wh,
                                                       OT* __restrict__ out, float* hbuf, int B, int T, int d,
                                                       int U) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 4 * U;
  const int d4 = 4 * d;
  WT* whs = reinterpret_cast<WT*>(smem_raw);  // [G][d]: this block's gate columns, transposed
  float* hs = reinterpret_cast<float*>(smem_raw + align16(size_t(G) * d * sizeof(WT)));  // [B][d]
  float* cs = hs + size_t(B) * d;  // [B][U] cell state of the block's units
  float* gs = cs + size_t(B) * U;  // [B][G] gate pre-activations

  const int u0 = blockIdx.x * U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // local column j = gate · U + unit; its global column in Wh / xw
  auto gcol = [&](int j) { return (j / U) * d + u0 + (j % U); };

  for (int i = tid; i < G * d; i += THREADS) {
    const int j = i % G, k = i / G;
    whs[size_t(j) * d + k] = wh[size_t(k) * d4 + gcol(j)];
  }
  for (int i = tid; i < B * U; i += THREADS) cs[i] = 0.f;

  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T; ++t) {
    // h from the step before, rounded to Wh's dtype (h.astype(wh.dtype)); other
    // blocks wrote it, so read through L2 (__ldcg), never a stale L1 line
    const float* hprev = hbuf + size_t(t & 1) * B * d;
    for (int i = tid; i < B * d; i += THREADS)
      hs[i] = t == 0 ? 0.f : to_float(from_float<WT>(__ldcg(hprev + i)));
    __syncthreads();

    for (int item = warp; item < B * G; item += WARPS) {
      const int b = item / G, j = item % G;
      const WT* wcol = whs + size_t(j) * d;
      const float* hb = hs + size_t(b) * d;
      float acc = 0.f;
      for (int k = lane; k < d; k += 32) acc = fmaf(hb[k], to_float(wcol[k]), acc);
      acc = warp_sum(acc);
      if (lane == 0) gs[item] = to_float(xw[(size_t(b) * T + t) * d4 + gcol(j)]) + acc;
    }
    __syncthreads();

    float* hnext = hbuf + size_t((t + 1) & 1) * B * d;
    for (int i = tid; i < B * U; i += THREADS) {
      const int b = i / U, u = i % U;
      const float* g = gs + size_t(b) * G;
      const float ig = sigmoid(g[u]);
      const float fg = sigmoid(g[U + u]);
      const float gg = tanhf(g[2 * U + u]);
      const float og = sigmoid(g[3 * U + u]);
      const float c = fg * cs[i] + ig * gg;
      cs[i] = c;
      const float h = og * tanhf(c);
      hnext[size_t(b) * d + u0 + u] = h;
      out[(size_t(b) * T + t) * d + u0 + u] = from_float<OT>(h);
    }
    grid.sync();
  }
}

template <typename WT, typename OT>
cudaError_t launch(const void* xw, const void* wh, void* out, float* hbuf, int B, int T, int d,
                   cudaStream_t stream) {
  int dev = 0, n_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop || n_sm <= 0) return cudaErrorNotSupported;
  // fewest units per block that keep the grid within one block per SM
  int U = 0;
  for (int u = 1; u <= d; ++u) {
    if (d % u == 0 && d / u <= n_sm) {
      U = u;
      break;
    }
  }
  if (U == 0) return cudaErrorInvalidValue;
  const int blocks = d / U;
  const size_t smem = smem_bytes<WT>(B, d, U);
  int max_smem = 0;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > size_t(max_smem)) return cudaErrorInvalidValue;
  auto kern = lstm_kernel<WT, OT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * n_sm < blocks) return cudaErrorCooperativeLaunchTooLarge;
  const WT* xw_t = static_cast<const WT*>(xw);
  const WT* wh_t = static_cast<const WT*>(wh);
  OT* out_t = static_cast<OT*>(out);
  void* args[] = {&xw_t, &wh_t, &out_t, &hbuf, &B, &T, &d, &U};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(blocks), dim3(THREADS), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// xw (B, T, 4d) and wh (d, 4d): bf16 when wh_is_bf16 else f32; out (B, T, d): bf16
// when out_is_bf16 else f32; hbuf: (2, B, d) f32 scratch. Returns a cudaError_t.
extern "C" int fgt_lstm_recurrence(const void* xw, const void* wh, void* out, void* hbuf, int B, int T, int d,
                                   int wh_is_bf16, int out_is_bf16, void* stream) {
  if (B <= 0 || T <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* hb = static_cast<float*>(hbuf);
  cudaError_t err;
  if (wh_is_bf16) {
    err = out_is_bf16 ? launch<bf16, bf16>(xw, wh, out, hb, B, T, d, st)
                      : launch<bf16, float>(xw, wh, out, hb, B, T, d, st);
  } else {
    err = out_is_bf16 ? launch<float, bf16>(xw, wh, out, hb, B, T, d, st)
                      : launch<float, float>(xw, wh, out, hb, B, T, d, st);
  }
  return static_cast<int>(err);
}
