// Fused masked multi-head attention, backward (K2), for Hopper (sm_90a).
//
// Replaces the TPU kernel vaesne_tpu/ops/attention.py::_bwd_kernel. Given
// the forward's q, k, v, mask, output o, its row statistics m and l
// (attention_fwd.cu) and the output gradient do, it computes dq, dk, dv:
//   p  = exp2(s2 - m) / l          s2 = s * log2(e), s = q.k/sqrt(Dh) + bias
//   dp = keep * (do . v) / (1 - rate)
//   D  = sum_d do * o              (the delta row term, fp32 arithmetic)
//   ds = p * (dp - D)
//   dq = sum_j ds k / sqrt(Dh),  dk = sum_i ds q / sqrt(Dh),
//   dv = sum_i keep * p * do / (1 - rate)
// recomputing s and the dropout mask (attention_common.cuh) from the same
// formulas, in the same order, as the forward, so the logits match it bit
// for bit and a fully masked row gets p = 1/Lk. The mask gets no gradient.
//
// The TPU kernel accumulates dk/dv over its q-tiles in order, in one
// block. Blocks on Hopper run in no order, so the work is split in two
// kernels, both deterministic and free of atomics, launched in turn on
// one stream:
//   * attention_bwd_dq_kernel: one thread per query (blocks as in the
//     forward), streaming K/V chunks through shared memory; each thread
//     also writes its D, which the next kernel reads;
//   * attention_bwd_dkdv_kernel: one thread per key, streaming q, do, m, l,
//     D and the query's hash through shared memory in chunks of QC queries.
// Query rows past Lq are never loaded (the TPU kernel zeroes them at load).
//
// What bounds it: per (query, key, head) ~4*Dh FMAs and one exp2 in each
// kernel (~80 flop at Dh 8) against a few bytes of I/O per query and key,
// so the fp32 FMA rate, not memory. Dh = 8 is below the 16-deep mma minimum:
// plain fp32 FMA here, a tensor-core design is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace vaesne;

constexpr int KC = 128;  // keys per shared-memory chunk (dq kernel)
constexpr int QC = 64;   // queries per shared-memory chunk (dk/dv kernel)
constexpr int MAX_THREADS = 128;

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(MAX_THREADS)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ mask,
                        const T* __restrict__ o, const T* __restrict__ dout,
                        const float* __restrict__ row_max, const float* __restrict__ row_sum,
                        float* __restrict__ delta, T* __restrict__ dq, int lq, int lk,
                        int num_heads, int n_tiles, float q_scale, uint32_t seed,
                        uint32_t threshold, int drop_tile, float drop_scale) {
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

  float qr[DH], dor[DH], acc[DH];
  float dsum = 0.f, m = 0.f, inv_l = 0.f;
  if (active) {
    const long long off = (r * lq + qi) * e + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      qr[d] = to_f32(q[off + d]) * q_scale;
      dor[d] = to_f32(dout[off + d]);
      dsum = fmaf(dor[d], to_f32(o[off + d]), dsum);
    }
    const long long si = (r * num_heads + h) * lq + qi;
    delta[si] = dsum;
    m = row_max[si];
    inv_l = 1.f / row_sum[si];
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  const uint32_t hrow = DROP ? hash_row(seed, r, h, num_heads, qi, drop_tile) : 0u;

  const T* kb = k + r * lk * e + h * DH;
  const T* vb = v + r * lk * e + h * DH;
  const uint8_t* mb = mask ? mask + r * lk : nullptr;

  for (int j0 = 0; j0 < lk; j0 += KC) {
    const int nk = min(KC, lk - j0);
    __syncthreads();
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

    for (int j = 0; j < nk; ++j) {
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dot = fmaf(qr[d], ks[j][d], dot);
        dp = fmaf(dor[d], vs[j][d], dp);
      }
      const float p = exp2f(dot + bias[j] - m) * inv_l;
      dp *= drop_scale;
      if (DROP && !keep_weight(hrow, hash_col(j0 + j), threshold)) dp = 0.f;
      const float ds = p * (dp - dsum);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
    }
  }

  if (active) {
    const float scale = rsqrtf(static_cast<float>(DH));
    T* gp = dq + (r * lq + qi) * e + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) store(gp + d, acc[d] * scale);
  }
}

template <typename T, int DH, bool DROP>
__global__ void __launch_bounds__(MAX_THREADS)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const uint8_t* __restrict__ mask,
                          const T* __restrict__ dout, const float* __restrict__ row_max,
                          const float* __restrict__ row_sum, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int lq, int lk,
                          int num_heads, int n_tiles, float q_scale, uint32_t seed,
                          uint32_t threshold, int drop_tile, float drop_scale) {
  __shared__ float qs[QC][DH];   // q * log2(e)/sqrt(Dh), as the forward scores it
  __shared__ float dos[QC][DH];
  __shared__ float ms[QC], inv_ls[QC], deltas[QC];
  __shared__ uint32_t hrows[QC];

  const long long blk = blockIdx.x;
  const int tile = static_cast<int>(blk % n_tiles);
  const int h = static_cast<int>((blk / n_tiles) % num_heads);
  const long long r = blk / (static_cast<long long>(n_tiles) * num_heads);
  const int e = num_heads * DH;
  const int kj = tile * blockDim.x + threadIdx.x;
  const bool active = kj < lk;

  float kr[DH], vr[DH], gk[DH], gv[DH];
  float bias = 0.f;
  if (active) {
    const long long off = (r * lk + kj) * e + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      kr[d] = to_f32(k[off + d]);
      vr[d] = to_f32(v[off + d]);
    }
    bias = (mask && mask[r * lk + kj]) ? MASK_BIAS * LOG2E : 0.f;
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) gk[d] = gv[d] = 0.f;
  const uint32_t hcol = hash_col(kj);

  const T* qb = q + r * lq * e + h * DH;
  const T* db = dout + r * lq * e + h * DH;
  const long long sb = (r * num_heads + h) * lq;

  for (int i0 = 0; i0 < lq; i0 += QC) {
    const int nq = min(QC, lq - i0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nq * DH; idx += blockDim.x) {
      const int i = idx / DH, d = idx % DH;
      const long long off = static_cast<long long>(i0 + i) * e + d;
      qs[i][d] = to_f32(qb[off]) * q_scale;
      dos[i][d] = to_f32(db[off]);
    }
    for (int i = threadIdx.x; i < nq; i += blockDim.x) {
      ms[i] = row_max[sb + i0 + i];
      inv_ls[i] = 1.f / row_sum[sb + i0 + i];
      deltas[i] = delta[sb + i0 + i];
      if (DROP) hrows[i] = hash_row(seed, r, h, num_heads, i0 + i, drop_tile);
    }
    __syncthreads();
    if (!active) continue;

    for (int i = 0; i < nq; ++i) {
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dot = fmaf(qs[i][d], kr[d], dot);
        dp = fmaf(dos[i][d], vr[d], dp);
      }
      const float p = exp2f(dot + bias - ms[i]) * inv_ls[i];
      float pk = p * drop_scale;
      dp *= drop_scale;
      if (DROP && !keep_weight(hrows[i], hcol, threshold)) pk = dp = 0.f;
      const float ds = p * (dp - deltas[i]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        gk[d] = fmaf(ds, qs[i][d], gk[d]);
        gv[d] = fmaf(pk, dos[i][d], gv[d]);
      }
    }
  }

  if (active) {
    // qs carries log2(e)/sqrt(Dh); dk needs 1/sqrt(Dh)
    const float scale = 1.f / LOG2E;
    const long long off = (r * lk + kj) * e + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      store(dk + off + d, gk[d] * scale);
      store(dv + off + d, gv[d]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *mask, *o, *dout;
  const float *row_max, *row_sum;
  float* delta;
  void *dq, *dk, *dv;
  long long rows;
  int lq, lk, num_heads;
  uint32_t seed;
  int threshold;
  float drop_scale;
  cudaStream_t stream;
};

template <typename T, int DH>
int launch(const Args& a, bool dkdv) {
  const int len = dkdv ? a.lk : a.lq;  // one thread per key, or per query
  const int threads = min(MAX_THREADS, (len + 31) / 32 * 32);
  const int n_tiles = (len + threads - 1) / threads;
  const long long blocks = a.rows * a.num_heads * n_tiles;
  if (blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const float q_scale = LOG2E / sqrtf(static_cast<float>(DH));
  const bool drop = a.threshold > 0;
  const uint32_t thr = static_cast<uint32_t>(a.threshold);
  const int tile = dropout_tile(a.lq);
  const unsigned grid = static_cast<unsigned>(blocks);
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  const uint8_t* mask = static_cast<const uint8_t*>(a.mask);
  if (dkdv) {
    auto kernel = drop ? attention_bwd_dkdv_kernel<T, DH, true>
                       : attention_bwd_dkdv_kernel<T, DH, false>;
    kernel<<<grid, threads, 0, a.stream>>>(q, k, v, mask, dout, a.row_max, a.row_sum,
                                           a.delta, static_cast<T*>(a.dk),
                                           static_cast<T*>(a.dv), a.lq, a.lk, a.num_heads,
                                           n_tiles, q_scale, a.seed, thr, tile, a.drop_scale);
  } else {
    auto kernel = drop ? attention_bwd_dq_kernel<T, DH, true>
                       : attention_bwd_dq_kernel<T, DH, false>;
    kernel<<<grid, threads, 0, a.stream>>>(q, k, v, mask, static_cast<const T*>(a.o), dout,
                                           a.row_max, a.row_sum, a.delta,
                                           static_cast<T*>(a.dq), a.lq, a.lk, a.num_heads,
                                           n_tiles, q_scale, a.seed, thr, tile, a.drop_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(const Args& a, int head_dim, bool dkdv) {
  switch (head_dim) {
    case 4: return launch<T, 4>(a, dkdv);
    case 8: return launch<T, 8>(a, dkdv);
    case 16: return launch<T, 16>(a, dkdv);
    case 32: return launch<T, 32>(a, dkdv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const Args& a, int head_dim, int dtype, bool dkdv) {
  if (dtype == 0) return dispatch_dh<float>(a, head_dim, dkdv);
  if (dtype == 1) return dispatch_dh<__nv_bfloat16>(a, head_dim, dkdv);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout and the gradients);
// row_max, row_sum and delta are fp32 [R, H, Lq]. threshold 0 turns the
// dropout mask off; drop_scale is 1/(1 - rate). Each returns the
// cudaError_t of its launch (0 on success), asynchronous on `stream`.
// Call vaesne_attention_bwd_dq first: it writes delta, which
// vaesne_attention_bwd_dkdv reads.
extern "C" int vaesne_attention_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* mask, const void* o, const void* dout,
                                       const void* row_max, const void* row_sum, void* delta,
                                       void* dq, long long rows, int lq, int lk,
                                       int num_heads, int head_dim, int dtype, uint32_t seed,
                                       int threshold, float drop_scale, void* stream) {
  const Args a{q, k, v, mask, o, dout, static_cast<const float*>(row_max),
               static_cast<const float*>(row_sum), static_cast<float*>(delta), dq, nullptr,
               nullptr, rows, lq, lk, num_heads, seed, threshold, drop_scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, head_dim, dtype, false);
}

extern "C" int vaesne_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                         const void* mask, const void* dout,
                                         const void* row_max, const void* row_sum,
                                         const void* delta, void* dk, void* dv,
                                         long long rows, int lq, int lk, int num_heads,
                                         int head_dim, int dtype, uint32_t seed,
                                         int threshold, float drop_scale, void* stream) {
  const Args a{q, k, v, mask, nullptr, dout, static_cast<const float*>(row_max),
               static_cast<const float*>(row_sum),
               const_cast<float*>(static_cast<const float*>(delta)), nullptr, dk, dv, rows,
               lq, lk, num_heads, seed, threshold, drop_scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, head_dim, dtype, true);
}
