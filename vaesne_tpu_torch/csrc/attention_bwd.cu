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
// formulas as the forward, so a fully masked row gets p = 1/Lk. The mask
// gets no gradient.
//
// One kernel, one block per (row, head), which computes every exp2 and
// every dropout hash once per (query, key, head). The TPU kernel
// accumulates dk/dv over its q-tiles in order; so does this block, and dq
// too, without atomics, so two runs give equal bits:
//   * first it writes D for its queries and zeroes its fp32 dq accumulator
//     (a scratch [R, H, Lq, Dh] in device memory that only this block
//     touches);
//   * then, for each super-tile of up to 128 keys (a warp per 16 keys, k
//     and v of its keys as A operands in registers), it streams q, do, m,
//     1/l, D and the query's hash through shared memory in chunks of
//     queries (attention_common.cuh: run_chunks). Per chunk every warp
//     computes s^T = k q^T and dp^T = v do^T, p and ds for its 16 keys,
//     adds dv += (keep p)^T do and dk += ds^T q to its sums, and writes its
//     ds to shared memory; after a barrier, the warps compute the chunk's
//     dq = ds k over the super-tile's keys (k staged in shared memory), in
//     two halves of the keys, and after another barrier add the halves, in
//     order, to the accumulator (super-tile by super-tile);
//   * last it writes dq = accumulator / sqrt(Dh) in the input type.
// Keys past Lk get -inf and zero k; query rows past Lq are never loaded
// (the TPU kernel zeroes them at load).
//
// Tensor cores for all five products (mma.sync m16n8k8, see
// attention_common.cuh). bf16 inputs run the bf16 instruction: p is rounded
// to bf16 as an operand, ds is kept as two bf16 terms (head and rest, two
// products), because its sums over keys and queries cancel. fp32 inputs run
// 3xTF32; on the H100 the gradients agree with autograd through the plain
// fp32 version to 1.9e-06 of max |plain| (PERF.md), inside the 1e-4 gate.
//
// What bounds it: per (query, key, head) one exp2 (0.71 ms at R = 768,
// 982 x 982, 4 heads), the fp32 instructions around it and, at rate > 0,
// the hash, as in the forward, plus the four products and the ds store;
// the tensor cores and device memory are far from their peaks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace vaesne;

constexpr int KS = MAX_WARPS * 16;  // keys per super-tile, at most
constexpr int DSS = KS + 8;         // row stride of the ds tile (floats): 8 banks apart

// q, do, the row statistics and the query's hash of one (row, head), chunk
// by chunk: q and do by cp.async (fetch); m, l and D into registers at
// fetch, which reach shared memory, with 1/l and the query's hash, only after
// the current chunk is computed (land). ds = p (keep dp / (1 - rate) - D) =
// p' (keep dp - D') with p' = p / (1 - rate) and D' = D (1 - rate):
// drop_scale is folded into 1/l and D once per query. A query past Lq gets
// m = 0, 1/l = 0, D = 0, zero q and do: p = 0 and ds = 0.
template <typename T, int DH, int DROP>
struct QueryStager {
  static constexpr int CH = Head<DH>::CHUNK, LO = CH * Head<DH>::STRIDE;
  struct Smem {
    T q[STAGES][Mma<T>::PARTS * LO];
    T dout[STAGES][Mma<T>::PARTS * LO];
    float m[STAGES][CH], il[STAGES][CH], d[STAGES][CH];
    uint32_t hrow[STAGES][CH];
  };
  Smem& sm;
  const T *qb, *db;  // this (row, head)'s queries and output gradients, rows e apart
  const float *row_max, *row_sum, *delta;  // this (row, head)'s statistics
  int lq, e, tid, nthreads;
  // the launch's seed word (a graph rewrites it), read where each chunk's
  // hash rows are made: an L1 hit that holds no register across the loop
  const uint32_t* seed_word;
  long long r;
  int h, num_heads, drop_tile;
  float drop_scale;
  float side_m, side_l, side_d;  // m, l and D of query tid of the chunk being fetched

  __device__ __forceinline__ void clear() {
    zero_shared(&sm.q[0][0], STAGES * Mma<T>::PARTS * LO);
    zero_shared(&sm.dout[0][0], STAGES * Mma<T>::PARTS * LO);
    __syncthreads();
  }
  __device__ __forceinline__ void fetch(int ci, int st) {
    const int i0 = ci * CH, nq = min(CH, lq - i0);
    stage_rows<T, DH>(sm.q[st], qb + static_cast<long long>(i0) * e, e, nq, tid, nthreads);
    stage_rows<T, DH>(sm.dout[st], db + static_cast<long long>(i0) * e, e, nq, tid, nthreads);
    const bool ok = tid < nq;
    side_m = ok ? row_max[i0 + tid] : 0.f;
    side_l = ok ? row_sum[i0 + tid] : 0.f;
    side_d = ok ? delta[i0 + tid] : 0.f;
  }
  __device__ __forceinline__ void land(int ci, int st) {
    const int i0 = ci * CH;
    if (tid >= CH) return;
    sm.m[st][tid] = side_m;
    sm.il[st][tid] = side_l > 0.f ? drop_scale / side_l : 0.f;
    sm.d[st][tid] = side_d / drop_scale;
    if (DROP) sm.hrow[st][tid] = hash_row(__ldg(seed_word), r, h, num_heads, i0 + tid, drop_tile);
  }
  __device__ __forceinline__ bool split(int st) {
    if (Mma<T>::PARTS == 1) return false;
    Mma<T>::presplit(sm.q[st], LO, tid, nthreads);
    Mma<T>::presplit(sm.dout[st], LO, tid, nthreads);
    return true;
  }
};

// Shared memory of the kernel (dynamic: above 48 KB for fp32): the query
// stages, the chunk's ds [CH][DSS] fp32, the super-tile's k [KS][S] for
// dq = ds k (two planes for fp32), each lane's dk and dv sums
// [warp][8 NC][32 lanes] fp32 (kept here rather than in registers so that
// the fp32 kernel fits 128 registers a thread without spilling), and the
// chunk's dq parts.
template <typename T, int DH, int DROP>
struct BwdSmem {
  using Stager = QueryStager<T, DH, DROP>;
  static constexpr int STAGE = (sizeof(typename Stager::Smem) + 15) / 16 * 16;
  static constexpr int DS = (Stager::CH * DSS * 4 + 15) / 16 * 16;
  static constexpr int LOK = KS * Head<DH>::STRIDE;  // tail plane offset of k
  static constexpr int K = Mma<T>::PARTS * LOK * static_cast<int>(sizeof(T));
  static constexpr int GKV = MAX_WARPS * 8 * Head<DH>::NC * 32 * 4;
  // the dq parts of a chunk: [2 halves][MT * NC tiles][4][32 lanes] fp32
  static constexpr int DQP = 2 * (Stager::CH / 16) * Head<DH>::NC * 4 * 32 * 4;
  static constexpr int BYTES = STAGE + DS + K + GKV + DQP;
};

template <typename T, int DH, int DROP>
__global__ void __launch_bounds__(MAX_WARPS * 32, MIN_BLOCKS<DH>)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const uint8_t* __restrict__ mask,
                     const T* __restrict__ o, const T* __restrict__ dout,
                     const float* __restrict__ row_max, const float* __restrict__ row_sum,
                     float* __restrict__ delta, float* __restrict__ dq_acc,
                     T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int lq,
                     int lk, int num_heads, float q_scale,
                     const uint32_t* __restrict__ seed_word, uint32_t threshold,
                     int drop_tile, float drop_scale) {
  using MM = Mma<T>;
  using Stager = QueryStager<T, DH, DROP>;
  using Smem = BwdSmem<T, DH, DROP>;
  constexpr int NC = Head<DH>::NC, S = Head<DH>::STRIDE, CH = Stager::CH;
  constexpr int TILES = CH / 8, LO = Stager::LO, LOK = Smem::LOK;
  constexpr int MT = CH / 16;  // 16-query tiles of a chunk in the dq product
  // the query tiles of a chunk unrolled by 2 only in fp32: fully unrolled,
  // that kernel needs more than the 128 registers two blocks per SM leave
  constexpr int UNROLL = MM::PARTS == 1 ? TILES : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sm = *reinterpret_cast<typename Stager::Smem*>(smem);
  float* dsm = reinterpret_cast<float*>(smem + Smem::STAGE);
  T* ksm = reinterpret_cast<T*>(smem + Smem::STAGE + Smem::DS);
  // this lane's dk sums at gkv[(c * 4 + i) * 32], its dv sums NC * 4 * 32 on
  float* gkv = reinterpret_cast<float*>(smem + Smem::STAGE + Smem::DS + Smem::K) +
               (threadIdx.x >> 5) * 8 * NC * 32 + (threadIdx.x & 31);
  float* dqp = reinterpret_cast<float*>(smem + Smem::STAGE + Smem::DS + Smem::K + Smem::GKV);

  const long long blk = blockIdx.x;
  const int h = static_cast<int>(blk % num_heads);
  const long long r = blk / num_heads;
  const int e = num_heads * DH;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, nwarps = nthreads >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long qbase = r * lq * e + h * DH, kbase = r * lk * e + h * DH;
  const long long sb = (r * num_heads + h) * lq;
  float* acc_q = dq_acc + sb * DH;  // this (row, head)'s dq accumulator, [Lq][DH]

  // D = sum_d do * o per query; the dq accumulator starts at 0
  for (int i = tid; i < lq; i += nthreads) {
    const T* po = o + qbase + static_cast<long long>(i) * e;
    const T* pd = dout + qbase + static_cast<long long>(i) * e;
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < DH; ++c) d = fmaf(to_f32(pd[c]), to_f32(po[c]), d);
    delta[sb + i] = d;
  }
  for (int i = tid; i < lq * DH; i += nthreads) acc_q[i] = 0.f;
  if (DH < 8) zero_shared(ksm, MM::PARTS * LOK);
  Stager sg{sm, q + qbase, dout + qbase, row_max + sb, row_sum + sb, delta + sb, lq, e, tid,
            nthreads, seed_word, r, h, num_heads, drop_tile, drop_scale, 0.f, 0.f, 0.f};
  if (DH < 8) sg.clear();
  __syncthreads();  // D and the zeroed accumulator are visible to the block

  const int n_chunks = (lq + CH - 1) / CH;
  const int ks_len = 16 * nwarps;  // keys per super-tile
  const float scale = rsqrtf(static_cast<float>(DH));
  for (int ks0 = 0; ks0 < lk; ks0 += ks_len) {
    stage_ahead(sg, n_chunks);
    const int nks = min(ks_len, lk - ks0);  // real keys of the super-tile
    // its k, for dq = ds k; zero past Lk
    for (int i = tid; i < KS * DH; i += nthreads) {
      const int j = i / DH, c = i % DH;
      MM::put(ksm + j * S + c, LOK,
              j < nks ? to_f32(k[kbase + static_cast<long long>(ks0 + j) * e + c]) : 0.f);
    }

    // this warp's 16 keys: k and v as A operands, their bias (-inf past Lk)
    const int k0 = ks0 + warp * 16;
    const bool active = k0 < lk;  // warp-uniform
    typename MM::A ka[NC], va[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float x[4];
      load_tile<T, DH>(x, k + kbase, e, k0, lk, c, lane);
      ka[c] = MM::make_a(x);
      load_tile<T, DH>(x, v + kbase, e, k0, lk, c, lane);
      va[c] = MM::make_a(x);
    }
    float kbias[2];
    uint32_t hcol[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = k0 + g + 8 * half;
      kbias[half] = j >= lk ? -INFINITY
                            : ((mask && mask[r * lk + j]) ? MASK_BIAS * LOG2E : 0.f);
      hcol[half] = hash_col(j);
    }
#pragma unroll
    for (int i = 0; i < 8 * NC; ++i) gkv[i * 32] = 0.f;

    // dk, dv of this warp's keys over one chunk of queries; ds to dsm
    auto key_part = [&](auto full, int ci, int st) {
      constexpr bool FULL = decltype(full)::value;
      const int nq = FULL ? CH : min(CH, lq - ci * CH);
      const T* qst = sm.q[st];
      const T* dost = sm.dout[st];
      float part_k[NC][4], part_v[NC][4];  // this chunk's dk and dv parts
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) part_k[c][i] = part_v[c][i] = 0.f;
#pragma unroll UNROLL
      for (int qt = 0; qt < TILES; ++qt) {
        if (!FULL && qt * 8 >= nq) continue;
        float sa[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int off = (qt * 8 + g) * S + c * 8 + 2 * t;
          MM::mma(sa, ka[c], MM::load_b(qst + off, LO));
          MM::mma(dp, va[c], MM::load_b(dost + off, LO));
        }
        // columns of the tile: queries qt*8 + 2t and + 1
        const int i0 = qt * 8 + 2 * t;
        const float2 m = *reinterpret_cast<const float2*>(&sm.m[st][i0]);
        const float2 il = *reinterpret_cast<const float2*>(&sm.il[st][i0]);
        const float2 dl = *reinterpret_cast<const float2*>(&sm.d[st][i0]);
        uint32_t hr[2] = {0u, 0u};
        if (DROP) {
          hr[0] = sm.hrow[st][i0];
          hr[1] = sm.hrow[st][i0 + 1];
        }
        float ds[4], pk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = i >> 1, col1 = i & 1;
          const float p = fast_exp2(fmaf(sa[i], q_scale, kbias[key]) - (col1 ? m.y : m.x)) *
                          (col1 ? il.y : il.x);
          float pd = p, d = dp[i];
          if (DROP && !keep_weight<DROP>(hr[col1], hcol[key], threshold)) pd = d = 0.f;
          ds[i] = p * (d - (col1 ? dl.y : dl.x));
          pk[i] = pd;
          dsm[(i0 + col1) * DSS + warp * 16 + g + 8 * key] = ds[i];
        }
        const typename MM::A pa = MM::make_a(pk);
        const auto dsa = MM::make_a2(ds);
        const int off = (qt * 8 + 2 * t) * S + g;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          MM::mma(part_v[c], pa, MM::load_b(dost + off + c * 8, dost + off + S + c * 8, LO));
          MM::mma(part_k[c], dsa, MM::load_b(qst + off + c * 8, qst + off + S + c * 8, LO));
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gkv[(c * 4 + i) * 32] += part_k[c][i];
          gkv[(NC * 4 + c * 4 + i) * 32] += part_v[c][i];
        }
    };

    // dq of one chunk of queries over the super-tile's keys: ds (16 queries
    // x 8 keys, from dsm) times k (8 keys x 8 columns, from ksm). The MT * NC
    // output tiles times two halves of the keys make 8 tasks over the warps;
    // each writes its part to dqp, and after a barrier each tile's two parts
    // are added, first half first, to the accumulator.
    auto query_part = [&](int ci) {
      const int kt_end = (nks + 7) / 8, kt_mid = (kt_end + 1) / 2;
      for (int task = warp; task < 2 * MT * NC; task += nwarps) {
        const int tile = task % (MT * NC), half = task / (MT * NC);
        const int m0 = (tile % MT) * 16, c = tile / MT;
        if (ci * CH + m0 >= lq) continue;
        const float* d0 = dsm + (m0 + g) * DSS + 2 * t;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int kt = half ? kt_mid : 0; kt < (half ? kt_end : kt_mid); ++kt) {
          const float2 a = *reinterpret_cast<const float2*>(d0 + kt * 8);
          const float2 b = *reinterpret_cast<const float2*>(d0 + 8 * DSS + kt * 8);
          const float x[4] = {a.x, a.y, b.x, b.y};
          const T* k0p = ksm + (kt * 8 + 2 * t) * S + c * 8 + g;
          MM::mma(acc, MM::make_a2(x), MM::load_b(k0p, k0p + S, LOK));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) dqp[(task * 4 + i) * 32 + lane] = acc[i];
      }
      __syncthreads();  // both halves of every tile are in dqp
      for (int tile = warp; tile < MT * NC; tile += nwarps) {
        const int m0 = (tile % MT) * 16, c = tile / MT;
        const int col = c * 8 + 2 * t, row = ci * CH + m0 + g;
        if (row >= lq || col >= DH) continue;
        float part[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          part[i] = dqp[(tile * 4 + i) * 32 + lane] + dqp[((MT * NC + tile) * 4 + i) * 32 + lane];
        float2* p = reinterpret_cast<float2*>(acc_q + row * DH + col);
        const float2 old = *p;
        *p = make_float2(old.x + part[0], old.y + part[1]);
        if (row + 8 < lq) {
          p = reinterpret_cast<float2*>(acc_q + (row + 8) * DH + col);
          const float2 old8 = *p;
          *p = make_float2(old8.x + part[2], old8.y + part[3]);
        }
      }
    };

    run_chunks(sg, n_chunks, [&](int ci, int st) {
      if (active) {
        if ((ci + 1) * CH <= lq)
          key_part(std::true_type{}, ci, st);
        else
          key_part(std::false_type{}, ci, st);
      }
      __syncthreads();  // the chunk's ds is complete (ksm too, at ci = 0)
      query_part(ci);
    });
    __syncthreads();  // every warp is done with ksm, dsm and the stages

    if (active) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float gk[4] = {gkv[(c * 4) * 32], gkv[(c * 4 + 1) * 32], gkv[(c * 4 + 2) * 32],
                             gkv[(c * 4 + 3) * 32]};
        const float gv[4] = {gkv[(NC * 4 + c * 4) * 32], gkv[(NC * 4 + c * 4 + 1) * 32],
                             gkv[(NC * 4 + c * 4 + 2) * 32], gkv[(NC * 4 + c * 4 + 3) * 32]};
        store_tile<T, DH>(dk + kbase, e, k0, lk, c, lane, gk, scale, scale);
        store_tile<T, DH>(dv + kbase, e, k0, lk, c, lane, gv, 1.f, 1.f);
      }
    }
  }

  __syncthreads();  // the accumulator is complete
  for (int i = tid; i < lq * DH; i += nthreads) {
    const int row = i / DH, c = i % DH;
    store_one(dq + qbase + static_cast<long long>(row) * e + c, acc_q[i] * scale);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* o,
           const void* dout, const float* row_max, const float* row_sum, float* delta,
           float* dq_acc, void* dq, void* dk, void* dv, long long rows, int lq, int lk,
           int num_heads, const uint32_t* seed, uint32_t threshold, int full_hash,
           float drop_scale, cudaStream_t stream) {
  const int warps = max(Head<DH>::MIN_THREADS / 32, min(MAX_WARPS, (lk + 15) / 16));
  const long long blocks = rows * num_heads;
  if (blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const float q_scale = LOG2E / sqrtf(static_cast<float>(DH));
  const int mode = drop_mode(threshold, full_hash);
  auto kernel = mode == DROP_FULL    ? attention_bwd_kernel<T, DH, DROP_FULL>
                : mode == DROP_SHORT ? attention_bwd_kernel<T, DH, DROP_SHORT>
                                     : attention_bwd_kernel<T, DH, DROP_OFF>;
  const int bytes = mode != DROP_OFF ? BwdSmem<T, DH, DROP_SHORT>::BYTES
                                     : BwdSmem<T, DH, DROP_OFF>::BYTES;
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<static_cast<unsigned>(blocks), 32 * warps, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(o), static_cast<const T*>(dout),
      row_max, row_sum, delta, dq_acc, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), lq, lk, num_heads, q_scale, seed, threshold,
      dropout_tile(lq), drop_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int head_dim, const void* q, const void* k, const void* v, const void* mask,
                const void* o, const void* dout, const float* row_max, const float* row_sum,
                float* delta, float* dq_acc, void* dq, void* dk, void* dv, long long rows,
                int lq, int lk, int num_heads, const uint32_t* seed, uint32_t threshold,
                int full_hash, float drop_scale, cudaStream_t stream) {
#define VAESNE_LAUNCH(DH)                                                                   \
  launch<T, DH>(q, k, v, mask, o, dout, row_max, row_sum, delta, dq_acc, dq, dk, dv, rows, \
                lq, lk, num_heads, seed, threshold, full_hash, drop_scale, stream)
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

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout and the gradients);
// row_max, row_sum, delta and the dq accumulator dq_acc are fp32, [R, H, Lq]
// and [R, H, Lq, Dh] (delta and dq_acc are scratch the kernel overwrites).
// seed points to the dropout seed, one uint32 in device memory, read only when
// dropout is on (it may be null at rate 0). threshold is the keep threshold
// thr32 of attention_common.cuh (0 turns the
// dropout mask off), full_hash 1 at width 32; drop_scale is 1/(1 - rate). Every
// pointer is 16-byte aligned. Returns the cudaError_t of the launch (0 on
// success), asynchronous on `stream`.
extern "C" int vaesne_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* mask, const void* o, const void* dout,
                                    const void* row_max, const void* row_sum, void* delta,
                                    void* dq_acc, void* dq, void* dk, void* dv, long long rows,
                                    int lq, int lk, int num_heads, int head_dim, int dtype,
                                    const void* seed_word, uint32_t threshold, int full_hash,
                                    float drop_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* seed = static_cast<const uint32_t*>(seed_word);
  if (threshold != 0 && seed == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const float* m = static_cast<const float*>(row_max);
  const float* l = static_cast<const float*>(row_sum);
  float* d = static_cast<float*>(delta);
  float* acc = static_cast<float*>(dq_acc);
  if (dtype == 0)
    return dispatch_dh<float>(head_dim, q, k, v, mask, o, dout, m, l, d, acc, dq, dk, dv, rows,
                              lq, lk, num_heads, seed, threshold, full_hash, drop_scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(head_dim, q, k, v, mask, o, dout, m, l, d, acc, dq, dk,
                                      dv, rows, lq, lk, num_heads, seed, threshold,
                                      full_hash, drop_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
