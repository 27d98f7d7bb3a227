// Fused masked multi-head attention, forward (K1), for Hopper (sm_90a).
//
// Replaces the TPU kernel vaesne_tpu/ops/attention.py::_fwd_kernel: per
// (row, head) it computes softmax(q k^T / sqrt(Dh) + bias) v, with
// attention-weight dropout at rate > 0, without ever writing the [Lq, Lk]
// logits to device memory.
//
// Layout: q [R, Lq, E], k/v [R, Lk, E], out [R, Lq, E], E = H * Dh, head h
// in columns h*Dh .. (h+1)*Dh (the layer's own layout; the TPU kernel's
// packed [B, E, L] layout existed only to dodge TPU lane padding). mask is
// [R, Lk] of 0/1 bytes (1 = ignore the key) or null. A masked key adds
// -1e9 to its fp32 logit, so a fully masked row averages v uniformly.
//
// Dropout (attention_common.cuh): the row sum l runs over EVERY key and
// the accumulator over KEPT keys only, and 1/(1 - rate) is folded onto the
// output with 1/l: o = (keep * e) v / ((1 - rate) * sum e), as in the JAX
// kernel. When row_max/row_sum are given, the kernel also writes the row
// max m and row sum l of the exp2-domain logits per (row, head, query),
// fp32 [R, H, Lq], for the backward (K2). They are kept apart and not
// folded into one log-sum-exp: at a fully masked row every logit is about
// -1.44e9, where fp32 values lie 128 apart, so m + log2(l) would round
// back to m and the backward would see p = 1 per key instead of 1/Lk.
//
// What bounds it: at the flagship grid (982 x 982, 4 heads, Dh = 8) one
// row is 123 Mflop (32 per query-key pair and head) against 0.5 MB of q, k,
// v, out and mask, ~245 flop per byte, so fp32 FMA issue (and, close
// behind, one exp2 per pair on the SFU) is the limit, not device memory;
// dropout adds ~9 integer operations per pair. Dh = 8 is below the 16-deep
// mma minimum, so this first design uses plain FMA:
//   * one block per (row, head, tile of up to 128 queries), one thread per
//     query, holding q[Dh] (pre-scaled by log2(e)/sqrt(Dh)) and acc[Dh] in
//     registers;
//   * K, V and the mask bias stream through shared memory in chunks of
//     KC keys, which every thread of the block reads as a broadcast;
//   * an online softmax in the exp2 domain, updated once per SUB keys
//     (scores for SUB keys live in registers), one divide at the end.
// All arithmetic is fp32; bf16 inputs are widened on load and the output
// is rounded once on store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace vaesne;

constexpr int KC = 128;   // keys staged in shared memory per chunk
constexpr int SUB = 32;   // keys scored per online-softmax update
constexpr int MAX_THREADS = 128;

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(MAX_THREADS)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const uint8_t* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ row_max,
                     float* __restrict__ row_sum, int lq, int lk, int num_heads,
                     int n_tiles, float q_scale, uint32_t seed, uint32_t threshold,
                     int drop_tile, float out_scale) {
  __shared__ float ks[KC][DH];
  __shared__ float vs[KC][DH];
  __shared__ float bias[KC];

  const long long blk = blockIdx.x;
  const int tile = static_cast<int>(blk % n_tiles);
  const int h = static_cast<int>((blk / n_tiles) % num_heads);
  const long long r = blk / (static_cast<long long>(n_tiles) * num_heads);
  const int e = num_heads * DH;
  const int qi = tile * blockDim.x + threadIdx.x;
  const bool active = qi < lq;

  float qr[DH], acc[DH];
  const T* qp = q + (r * lq + (active ? qi : 0)) * e + h * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = active ? to_f32(qp[d]) * q_scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;  // running max of the exp2-domain logits
  float l = 0.f;        // running sum of exp2(s - m), over every key
  const uint32_t hrow = DROP ? hash_row(seed, r, h, num_heads, qi, drop_tile) : 0u;

  const T* kb = k + r * lk * e + h * DH;
  const T* vb = v + r * lk * e + h * DH;
  const uint8_t* mb = mask ? mask + r * lk : nullptr;

  for (int j0 = 0; j0 < lk; j0 += KC) {
    const int nk = min(KC, lk - j0);
    __syncthreads();  // the previous chunk is consumed
    for (int idx = threadIdx.x; idx < nk * DH; idx += blockDim.x) {
      const int j = idx / DH, d = idx % DH;
      const long long off = static_cast<long long>(j0 + j) * e + d;
      ks[j][d] = to_f32(kb[off]);
      vs[j][d] = to_f32(vb[off]);
    }
    for (int j = threadIdx.x; j < nk; j += blockDim.x)
      bias[j] = (mb && mb[j0 + j]) ? MASK_BIAS * LOG2E : 0.f;
    __syncthreads();
    if (!active) continue;

    for (int c0 = 0; c0 < nk; c0 += SUB) {
      float s[SUB];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = c0 + jj;
        float x = -INFINITY;
        if (j < nk) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], ks[j][d], dot);
          x = dot + bias[j];
        }
        s[jj] = x;
        cmax = fmaxf(cmax, x);
      }
      // every sub-chunk holds at least one key, so m_new is finite and the
      // first correction exp2(-inf) is 0
      const float m_new = fmaxf(m, cmax);
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = c0 + jj;
        if (j < nk) {
          float p = exp2f(s[jj] - m_new);
          l += p;
          if (DROP && !keep_weight(hrow, hash_col(j0 + j), threshold)) p = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
        }
      }
      m = m_new;
    }
  }

  if (active) {
    const float inv = out_scale / l;
    T* op = out + (r * lq + qi) * e + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) store(op + d, acc[d] * inv);
    if (row_max) {
      const long long si = (r * num_heads + h) * lq + qi;
      row_max[si] = m;
      row_sum[si] = l;
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           float* row_max, float* row_sum, long long rows, int lq, int lk, int num_heads,
           uint32_t seed, int threshold, float out_scale, cudaStream_t stream) {
  const int threads = min(MAX_THREADS, (lq + 31) / 32 * 32);
  const int n_tiles = (lq + threads - 1) / threads;
  const long long blocks = rows * num_heads * n_tiles;
  if (blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const float q_scale = LOG2E / sqrtf(static_cast<float>(DH));
  auto kernel = threshold > 0 ? attention_fwd_kernel<T, DH, true>
                              : attention_fwd_kernel<T, DH, false>;
  kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), row_max, row_sum, lq, lk,
      num_heads, n_tiles, q_scale, seed, static_cast<uint32_t>(threshold),
      dropout_tile(lq), out_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int head_dim, const void* q, const void* k, const void* v, const void* mask,
                void* out, float* row_max, float* row_sum, long long rows, int lq, int lk,
                int num_heads, uint32_t seed, int threshold, float out_scale,
                cudaStream_t stream) {
#define VAESNE_LAUNCH(DH)                                                                   \
  launch<T, DH>(q, k, v, mask, out, row_max, row_sum, rows, lq, lk, num_heads, seed,      \
                threshold, out_scale, stream)
  switch (head_dim) {
    case 4: return VAESNE_LAUNCH(4);
    case 8: return VAESNE_LAUNCH(8);
    case 16: return VAESNE_LAUNCH(16);
    case 32: return VAESNE_LAUNCH(32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VAESNE_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. row_max/row_sum: fp32 [R, H, Lq] or
// both null. threshold 0 turns dropout off (the rate-0 kernel); out_scale
// is 1/(1 - rate). Returns the cudaError_t of the launch (0 on success);
// the launch is asynchronous on `stream`.
extern "C" int vaesne_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, void* row_max,
                                    void* row_sum, long long rows, int lq, int lk,
                                    int num_heads, int head_dim, int dtype, uint32_t seed,
                                    int threshold, float out_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(row_max);
  float* l = static_cast<float*>(row_sum);
  if ((m == nullptr) != (l == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_dh<float>(head_dim, q, k, v, mask, out, m, l, rows, lq, lk, num_heads,
                              seed, threshold, out_scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(head_dim, q, k, v, mask, out, m, l, rows, lq, lk,
                                      num_heads, seed, threshold, out_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
