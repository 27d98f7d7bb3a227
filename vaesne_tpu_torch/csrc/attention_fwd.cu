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
// -1e9 to its fp32 logit, so a fully masked row averages v uniformly; a
// key past Lk (the padding of the last chunk) gets -inf.
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
// Design: tensor cores for both products (mma.sync m16n8k8, see
// attention_common.cuh). One block per (row, head, up to 128 queries), one
// warp per 16 queries:
//   * s = q k^T: the warp's q tile sits in registers as the A operand, k
//     comes from shared memory; s2 = (q.k) * log2(e)/sqrt(Dh) + bias in
//     fp32;
//   * an online softmax in the exp2 domain per chunk of keys: the row max
//     across the 4 lanes of a row by two shuffles, one exp2 per pair; the
//     statistics and row sums stay fp32;
//   * o += p v: the probabilities p, still in the accumulator's registers,
//     are the A operand (bf16 rounds them to bf16), v from shared memory;
//   * K, V (and the mask bias) of the (row, head) stream through shared
//     memory in chunks of 64 keys (Dh <= 8), three in flight by 16-byte
//     cp.async, one barrier per chunk; a chunk of real keys only runs
//     without per-tile bounds checks.
// bf16 inputs run the bf16 tensor-core instruction. fp32 inputs run 3xTF32
// (three TF32 products per block, ~2^-21 relative per product): on the
// H100, against the plain fp32 version, max-abs <= 3.4e-06 at the grids
// the model routes here (PERF.md), inside the 1e-5 gate.
//
// What bounds it: at the flagship grid (982 x 982, 4 heads, Dh = 8) the
// products are 64 (bf16) or 192 (3xTF32) tensor-core flop per (query, key,
// head) and device memory moves 0.5 MB per row: neither is near its peak.
// Per pair there is one exp2 on the SFU (16 per SM per clock: 0.71 ms at
// R = 768) and a dozen fp32 instructions around it (scale and bias, max,
// subtract, sum, pack), plus, at rate > 0, the dropout hash's 6 integer
// operations and a select. In bf16 the instruction rate is the limit, at
// about 2.6 times the exp2 floor; fp32 takes twice as long, with three
// TF32 mma.sync per block and the TF32 split of p on top (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace vaesne;

// K, V and the mask bias of one (row, head), chunk by chunk: K and V by
// cp.async (fetch); the mask bytes into registers at fetch, which become
// the bias in shared memory only after the current chunk is computed
// (land), so that no thread waits on device memory inside the loop. Keys
// past Lk get the bias -inf and zero K and V.
template <typename T, int DH>
struct KeyStager {
  static constexpr int CH = Head<DH>::CHUNK, LO = CH * Head<DH>::STRIDE;
  struct Smem {
    T k[STAGES][Mma<T>::PARTS * LO];
    T v[STAGES][Mma<T>::PARTS * LO];
    float bias[STAGES][CH];
  };
  Smem& sm;
  const T *kb, *vb;    // this (row, head)'s keys and values, rows e apart
  const uint8_t* mb;   // its mask row, or null
  int lk, e, tid, nthreads;
  uint8_t side;  // the mask byte of key tid of the chunk being fetched

  // Dh = 4: the 8-wide blocks read columns 4..7, which cp.async never writes
  __device__ __forceinline__ void clear() {
    zero_shared(&sm.k[0][0], STAGES * Mma<T>::PARTS * LO);
    zero_shared(&sm.v[0][0], STAGES * Mma<T>::PARTS * LO);
    __syncthreads();
  }
  __device__ __forceinline__ void fetch(int ci, int st) {
    const int j0 = ci * CH, nk = min(CH, lk - j0);
    stage_rows<T, DH>(sm.k[st], kb + static_cast<long long>(j0) * e, e, nk, tid, nthreads);
    stage_rows<T, DH>(sm.v[st], vb + static_cast<long long>(j0) * e, e, nk, tid, nthreads);
    side = (mb && tid < nk) ? mb[j0 + tid] : 0;
  }
  __device__ __forceinline__ void land(int ci, int st) {
    const int nk = min(CH, lk - ci * CH);
    if (tid < CH) sm.bias[st][tid] = tid >= nk ? -INFINITY : (side ? MASK_BIAS * LOG2E : 0.f);
  }
  // split the landed chunk into TF32 planes (fp32); true if it did
  __device__ __forceinline__ bool split(int st) {
    if (Mma<T>::PARTS == 1) return false;
    Mma<T>::presplit(sm.k[st], LO, tid, nthreads);
    Mma<T>::presplit(sm.v[st], LO, tid, nthreads);
    return true;
  }
};

template <typename T, int DH, int DROP>
__global__ void __launch_bounds__(MAX_WARPS * 32, MIN_BLOCKS<DH>)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const uint8_t* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ row_max,
                     float* __restrict__ row_sum, int lq, int lk, int num_heads,
                     int n_tiles, float q_scale, uint32_t seed, uint32_t threshold,
                     int drop_tile, float out_scale) {
  using MM = Mma<T>;
  using Stager = KeyStager<T, DH>;
  constexpr int NC = Head<DH>::NC, S = Head<DH>::STRIDE, CH = Stager::CH;
  constexpr int KT = CH / 8, LO = Stager::LO;  // key tiles per chunk; tail plane offset
  __shared__ __align__(16) typename Stager::Smem sm;

  const long long blk = blockIdx.x;
  const int tile = static_cast<int>(blk % n_tiles);
  const int h = static_cast<int>((blk / n_tiles) % num_heads);
  const long long r = blk / (static_cast<long long>(n_tiles) * num_heads);
  const int e = num_heads * DH;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = (tile * (nthreads >> 5) + (tid >> 5)) * 16;
  const bool active = q0 < lq;  // warp-uniform

  Stager sg{sm, k + r * lk * e + h * DH, v + r * lk * e + h * DH,
            mask ? mask + r * lk : nullptr, lk, e, tid, nthreads, 0};
  if (DH < 8) sg.clear();
  const int n_chunks = (lk + CH - 1) / CH;
  stage_ahead(sg, n_chunks);

  typename MM::A qa[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float x[4];
    load_tile<T, DH>(x, q + r * lq * e + h * DH, e, q0, lq, c, lane);
    qa[c] = MM::make_a(x);
  }
  float o[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  // running max of the exp2-domain logits (shared by the row's 4 lanes)
  // and this lane's part of the running sum of exp2(s - m), rows g, g + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  uint32_t hrow0 = 0, hrow1 = 0;
  if (DROP) {
    hrow0 = hash_row(seed, r, h, num_heads, q0 + g, drop_tile);
    hrow1 = hash_row(seed, r, h, num_heads, q0 + g + 8, drop_tile);
  }

  // One chunk of keys: FULL (all CH keys real) runs every tile without a
  // branch; the last, partial chunk skips the tiles past Lk.
  auto compute = [&](auto full, int ci, int st) {
    constexpr bool FULL = decltype(full)::value;
    const int j0 = ci * CH, nk = FULL ? CH : min(CH, lk - j0);
    const T* kst = sm.k[st];
    const T* vst = sm.v[st];
    float s[KT][4];
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (FULL || kt * 8 < nk) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < NC; ++c)
          MM::mma(acc, qa[c], MM::load_b(kst + (kt * 8 + g) * S + c * 8 + 2 * t, LO));
        const float2 b = *reinterpret_cast<const float2*>(&sm.bias[st][kt * 8 + 2 * t]);
        s[kt][0] = fmaf(acc[0], q_scale, b.x);
        s[kt][1] = fmaf(acc[1], q_scale, b.y);
        s[kt][2] = fmaf(acc[2], q_scale, b.x);
        s[kt][3] = fmaf(acc[3], q_scale, b.y);
        mx0 = fmaxf(mx0, fmaxf(s[kt][0], s[kt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[kt][2], s[kt][3]));
      }
    }
    // the chunk's first key is a real one, so the new max is finite and
    // the first correction exp2(-inf) is 0
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = fast_exp2(m0 - mn0), corr1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float pv[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c) pv[c][0] = pv[c][1] = pv[c][2] = pv[c][3] = 0.f;
    float ls0 = 0.f, ls1 = 0.f;  // the chunk's part of the row sums
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (FULL || kt * 8 < nk) {
        float p[4] = {fast_exp2(s[kt][0] - mn0), fast_exp2(s[kt][1] - mn0),
                      fast_exp2(s[kt][2] - mn1), fast_exp2(s[kt][3] - mn1)};
        ls0 += p[0] + p[1];
        ls1 += p[2] + p[3];
        if (DROP) {
          const int j = j0 + kt * 8 + 2 * t;
          const uint32_t ca = hash_col(j), cb = hash_col(j + 1);
          if (!keep_weight<DROP>(hrow0, ca, threshold)) p[0] = 0.f;
          if (!keep_weight<DROP>(hrow0, cb, threshold)) p[1] = 0.f;
          if (!keep_weight<DROP>(hrow1, ca, threshold)) p[2] = 0.f;
          if (!keep_weight<DROP>(hrow1, cb, threshold)) p[3] = 0.f;
        }
        const typename MM::A pa = MM::make_a(p);
        const T* v0 = vst + (kt * 8 + 2 * t) * S + g;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          MM::mma(pv[c], pa, MM::load_b(v0 + c * 8, v0 + S + c * 8, LO));
      }
    }
    l0 = fmaf(l0, corr0, ls0);
    l1 = fmaf(l1, corr1, ls1);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      o[c][0] = fmaf(o[c][0], corr0, pv[c][0]);
      o[c][1] = fmaf(o[c][1], corr0, pv[c][1]);
      o[c][2] = fmaf(o[c][2], corr1, pv[c][2]);
      o[c][3] = fmaf(o[c][3], corr1, pv[c][3]);
    }
  };

  run_chunks(sg, n_chunks, [&](int ci, int st) {
    if (!active) return;
    if ((ci + 1) * CH <= lk)
      compute(std::true_type{}, ci, st);
    else
      compute(std::false_type{}, ci, st);
  });

  if (active) {
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    T* ob = out + r * lq * e + h * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store_tile<T, DH>(ob, e, q0, lq, c, lane, o[c], out_scale / l0, out_scale / l1);
    if (row_max && t == 0) {
      const long long si = (r * num_heads + h) * lq + q0 + g;
      if (q0 + g < lq) {
        row_max[si] = m0;
        row_sum[si] = l0;
      }
      if (q0 + g + 8 < lq) {
        row_max[si + 8] = m1;
        row_sum[si + 8] = l1;
      }
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           float* row_max, float* row_sum, long long rows, int lq, int lk, int num_heads,
           uint32_t seed, uint32_t threshold, int full_hash, float out_scale,
           cudaStream_t stream) {
  const int warps = max(Head<DH>::MIN_THREADS / 32, min(MAX_WARPS, (lq + 15) / 16));
  const int n_tiles = (lq + 16 * warps - 1) / (16 * warps);
  const long long blocks = rows * num_heads * n_tiles;
  if (blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const float q_scale = LOG2E / sqrtf(static_cast<float>(DH));
  const int mode = drop_mode(threshold, full_hash);
  auto kernel = mode == DROP_FULL    ? attention_fwd_kernel<T, DH, DROP_FULL>
                : mode == DROP_SHORT ? attention_fwd_kernel<T, DH, DROP_SHORT>
                                     : attention_fwd_kernel<T, DH, DROP_OFF>;
  kernel<<<static_cast<unsigned>(blocks), 32 * warps, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), row_max, row_sum, lq, lk,
      num_heads, n_tiles, q_scale, seed, threshold, dropout_tile(lq), out_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int head_dim, const void* q, const void* k, const void* v, const void* mask,
                void* out, float* row_max, float* row_sum, long long rows, int lq, int lk,
                int num_heads, uint32_t seed, uint32_t threshold, int full_hash,
                float out_scale, cudaStream_t stream) {
#define VAESNE_LAUNCH(DH)                                                                   \
  launch<T, DH>(q, k, v, mask, out, row_max, row_sum, rows, lq, lk, num_heads, seed,      \
                threshold, full_hash, out_scale, stream)
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
// both null. threshold is the keep threshold thr32 of attention_common.cuh
// (0 turns dropout off: the rate-0 kernel), full_hash 1 at width 32; out_scale
// is 1/(1 - rate). Every pointer is 16-byte aligned. Returns the
// cudaError_t of the launch (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int vaesne_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, void* row_max,
                                    void* row_sum, long long rows, int lq, int lk,
                                    int num_heads, int head_dim, int dtype, uint32_t seed,
                                    uint32_t threshold, int full_hash, float out_scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(row_max);
  float* l = static_cast<float*>(row_sum);
  if ((m == nullptr) != (l == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_dh<float>(head_dim, q, k, v, mask, out, m, l, rows, lq, lk, num_heads,
                              seed, threshold, full_hash, out_scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(head_dim, q, k, v, mask, out, m, l, rows, lq, lk,
                                      num_heads, seed, threshold, full_hash, out_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
