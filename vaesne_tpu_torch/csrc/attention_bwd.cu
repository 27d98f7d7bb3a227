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
// One kernel a call, one block per (row, head), which computes every exp2
// and every dropout hash once per (query, key, head) and sums dk, dv and dq
// in a fixed order, without atomics, so two runs give equal bits. Two
// designs, chosen in vaesne_attention_bwd from the dtype, the head size, Lq
// and Lk alone (routes_pipelined, exported as vaesne_attention_bwd_pipelined):
//
// The pipelined fp32 kernel (attention_bwd_kernel_pipelined), for fp32 at
// Dh = 8 with at most 1024 queries and at least 64 keys: the model's
// 982 x 982, 983 x 983 and 900 x 900 grids. Its block of four warpgroups
// stages ALL of the (row, head)'s queries once, before the key loop: q and
// do split into TF32 head and tail planes in wgmma's K-major layout, D, m,
// 1/l and the hash's query part (176 bytes a query, 180 KB at 1024); that
// is the block's one barrier until the end. Each warpgroup walks slabs of
// 64 keys, k and v split once a slab into wgmma's A registers. Per chunk of
// 16 queries, s^T and dp^T are six asynchronous wgmma m64n16k8 (3xTF32),
// issued one chunk ahead; p, the mask and ds of the chunk before run beside
// them; dv and dk are mma.sync (3xTF32) summed in registers; the warp's dq
// part over its 16 keys is an mma.sync on ds transposed through its own
// shared buffer. The warpgroup's four parts meet behind a barrier of its 128
// threads; one warp in turn adds them in warp order and adds the sum to the
// chunk's dq in shared memory once the slab before has (a counter a chunk),
// so dq sums slab by slab in order. At the end the block writes dq.
//
// PR 3's chunked kernel (attention_bwd_kernel) for everything else: bf16,
// Dh 4, 16 and 32, and grids past the pipelined kernel's limits (the
// per-pixel decoder's 3,600 x 3,600):
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
// attention_common.cuh; s and dp on wgmma in the pipelined kernel). bf16
// inputs run the bf16 instruction: p is rounded to bf16 as an operand, ds is
// kept as two bf16 terms (head and rest, two products), because its sums
// over keys and queries cancel. fp32 inputs run 3xTF32; on the H100 the
// gradients agree with autograd through the plain fp32 version to ~1e-06 of
// max |plain| in both designs (PERF.md), inside the 1e-4 gate.
//
// What bounds it: per (query, key, head) one exp2 (0.71 ms at R = 768,
// 982 x 982, 4 heads), the fp32 instructions around it and, at rate > 0,
// the hash, as in the forward, plus the five products; device memory is far
// from its peak. Measured on the H100 (PERF.md §7): in PR 3's design the
// per-chunk barriers and dq's global read-modify-write, the re-staging and
// re-splitting of q and do per super-tile, and the twelve TF32 mma.sync a
// tile each cost 9-18%. The pipelined kernel stages once, takes s and dp
// off mma.sync and has no block-wide barrier in the loop; what is left is
// the tensor pipe (nine TF32 mma.sync and 1.5 wgmma a 16 x 8 tile for dk,
// dv and dq and s, dp: by operation count some two thirds of the pipe's
// time), ~170 instructions a tile around the exp2s, and the warpgroup's
// barrier and summing warp a chunk (~14% of the kernel's time). dk and dv on
// wgmma would need q and do a second time in the queries-contiguous layout
// that tf32 wgmma takes for B, which shared memory does not hold beside the
// resident planes.

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

// -- the pipelined fp32 design: Dh = 8, Lq <= PIPE_MAX_QUERIES, Lk >= PIPE_MIN_KEYS ----

constexpr int PIPE_WARPGROUPS = 4;  // 16 warps, one block per SM
constexpr int PIPE_THREADS = PIPE_WARPGROUPS * 128;
constexpr int PIPE_QC = 16;    // queries per chunk: the N of one wgmma
constexpr int PIPE_SLAB = 64;  // keys of a warpgroup: the M of one wgmma
constexpr int PIPE_MIN_KEYS = PIPE_SLAB, PIPE_MAX_QUERIES = 1024;
constexpr int PIPE_TB = 128;  // float2 slots of a warp's transposed ds (16 queries x 8 key pairs)
// float4s of the dq parts: [warpgroup][chunk parity][warp][lane]
constexpr int PIPE_PARTS = PIPE_WARPGROUPS * 2 * 4 * 32;

// Shared memory for Lq queries: four planes (two halves of 16 bytes a query
// and a 16-byte gap each), dq's sums, m, (1 - rate)/l, D (1 - rate) and the
// hash row a query, the warps' transposed ds, the dq parts and the chunks'
// counters.
int pipe_bytes(int lq) {
  const int nc = (lq + PIPE_QC - 1) / PIPE_QC, nqp = nc * PIPE_QC;
  return 4 * 2 * (nqp * 16 + 16) + nqp * (8 + 4) * 4 + 16 * PIPE_TB * 8 + PIPE_PARTS * 16 +
         (nc * 4 + 15) / 16 * 16;
}

// A TF32 plane of nqp queries: dims 0-3 of every query (16 bytes a query,
// eight queries a wgmma core matrix, 128 bytes), 16 bytes of gap, then dims
// 4-7. As wgmma's no-swizzle K-major B: the two core matrices along K (the
// dims) lbo = nqp * 16 + 16 bytes apart, groups of 8 queries 128 bytes apart.
// The gap puts dims g and g + 4 of a query 4 banks apart, so the lanes'
// mma.sync reads of queries 2t, 2t + 1 at dim g hit 32 distinct banks.
__device__ __forceinline__ uint64_t pipe_desc(uint32_t smem_addr, uint32_t lbo) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(128 >> 4) << 32);
}

// A barrier of the 128 threads of warpgroup wg (ids 1-4; 0 is __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// d (+)= a b: the 64 x 16 products of a warpgroup's 64 keys (A, TF32, from
// registers) and 16 queries (B, TF32, K-major in shared memory). Each warp's
// part of d has mma.sync's accumulator layout, query tile i in d[i].
__device__ __forceinline__ void wgmma_keys(float (&d)[2][4], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

// The slot of the pair (ds(query q, key kk), ds(q, kk + 8)) in a warp's
// transposed ds (q, kk < 16, 8): key-pair major, q xor'd with a pattern per
// pair (0, 9, 5, 12 for kk mod 4), so that the writes (lanes over 4 queries
// of one parity and 4 pairs) and the reads (lanes over 4 queries and 4
// pairs) each hit 16 distinct bank pairs per half-warp.
__device__ __forceinline__ int tslot(int q, int kk) {
  return kk * 16 + (q ^ ((0xC590u >> (4 * (kk & 3))) & 15u));
}

// One block per (row, head) stages that (row, head)'s queries once, before
// the key loop: q and dout split into TF32 planes in wgmma's K-major layout,
// m, (1 - rate)/l, D (1 - rate) with D = sum do o, and the dropout hash's
// query part; then the block's one barrier. Each warpgroup then walks its
// slabs of 64 keys (slab w, w + 4, ...), a warp per 16 keys, with k and v as
// the A operands of wgmma in registers, split once a slab. Per chunk of 16
// queries: s^T = k q^T and dp^T = v dout^T (3xTF32, six wgmma m64n16k8,
// asynchronous) are issued one chunk ahead into a second register buffer;
// this chunk's p, the dropout mask and ds run beside them; dv += (keep p)^T
// dout and dk += ds^T q by mma.sync (3xTF32, the operands in the accumulator
// registers and the resident planes), summed in registers; ds, transposed
// through the warp's own shared buffer, gives the warp's dq part over its
// 16 keys (mma.sync). The warpgroup's four parts meet in a double buffer
// behind a barrier of its 128 threads; one warp (by turn) adds them in warp
// order and, once the slab before has (a counter per chunk in shared
// memory), adds the sum to the chunk's dq in shared memory: dq sums over
// slabs in order, without atomics, and no block-wide barrier runs inside the
// loop. Query rows past Lq are zero with 1/l = 0 (p = 0, ds = 0);
// keys past Lk are zero with bias -inf.
template <int DROP>
__global__ void __launch_bounds__(PIPE_THREADS, 1)
attention_bwd_kernel_pipelined(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const uint8_t* __restrict__ mask,
                               const float* __restrict__ o, const float* __restrict__ dout,
                               const float* __restrict__ row_max,
                               const float* __restrict__ row_sum, float* __restrict__ dq,
                               float* __restrict__ dk, float* __restrict__ dv, int lq, int lk,
                               int num_heads, float q_scale,
                               const uint32_t* __restrict__ seed_word, uint32_t threshold,
                               int drop_tile, float drop_scale) {
  using MM = Mma<float>;
  extern __shared__ __align__(128) unsigned char pipe_smem[];
  const int nc = (lq + PIPE_QC - 1) / PIPE_QC, nqp = nc * PIPE_QC;
  const int half = nqp * 4 + 4;  // floats from dims 0-3 to dims 4-7 in a plane
  float* qhi = reinterpret_cast<float*>(pipe_smem);
  float* qlo = qhi + 2 * half;
  float* dhi = qlo + 2 * half;
  float* dlo = dhi + 2 * half;
  float* acc = dlo + 2 * half;  // dq's sums, [nqp][8]
  float* sm_m = acc + nqp * 8;
  float* sm_il = sm_m + nqp;
  float* sm_d = sm_il + nqp;
  uint32_t* sm_h = reinterpret_cast<uint32_t*>(sm_d + nqp);
  float2* tbuf = reinterpret_cast<float2*>(sm_h + nqp);  // [16 warps][PIPE_TB]
  float4* pbuf = reinterpret_cast<float4*>(tbuf + 16 * PIPE_TB);  // PIPE_PARTS
  int* turn = reinterpret_cast<int*>(pbuf + PIPE_PARTS);          // [nc]: slabs summed

  const long long blk = blockIdx.x;
  const int h = static_cast<int>(blk % num_heads);
  const long long r = blk / num_heads;
  const int e = num_heads * 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t = lane & 3, g = lane >> 2;
  const long long qbase = r * lq * e + h * 8, kbase = r * lk * e + h * 8;
  const long long sb = (r * num_heads + h) * lq;

  {
    // Item i: query i / 2, dims 4 (i % 2) .. + 3, of q, dout and o; m and l
    // on the even items. All of a thread's loads are in flight before the
    // first is used.
    constexpr int ITERS = PIPE_MAX_QUERIES * 2 / PIPE_THREADS;
    float4 qx[ITERS], dx[ITERS], ox[ITERS];
    float mx[ITERS], lx[ITERS];
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = tid + it * PIPE_THREADS, row = i >> 1;
      qx[it] = dx[it] = ox[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      mx[it] = lx[it] = 0.f;
      if (row < lq) {
        const long long off = qbase + static_cast<long long>(row) * e + 4 * (i & 1);
        qx[it] = __ldg(reinterpret_cast<const float4*>(q + off));
        dx[it] = __ldg(reinterpret_cast<const float4*>(dout + off));
        ox[it] = __ldg(reinterpret_cast<const float4*>(o + off));
        if ((i & 1) == 0) {
          mx[it] = __ldg(row_max + sb + row);
          lx[it] = __ldg(row_sum + sb + row);
        }
      }
    }
    const uint32_t seed = DROP ? __ldg(seed_word) : 0u;  // one word for the launch
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = tid + it * PIPE_THREADS, row = i >> 1;
      // D = sum_d do o: this item's 4 dims, then its neighbour's (lanes 2j, 2j + 1)
      float d = fmaf(dx[it].x, ox[it].x,
                     fmaf(dx[it].y, ox[it].y, fmaf(dx[it].z, ox[it].z, dx[it].w * ox[it].w)));
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      if (row < nqp) {
        const int at = (i & 1) * half + row * 4;
        float4 hi, lo;
        split4(qx[it], hi, lo);
        *reinterpret_cast<float4*>(qhi + at) = hi;
        *reinterpret_cast<float4*>(qlo + at) = lo;
        split4(dx[it], hi, lo);
        *reinterpret_cast<float4*>(dhi + at) = hi;
        *reinterpret_cast<float4*>(dlo + at) = lo;
        if ((i & 1) == 0) {
          // ds = p (keep dp / (1 - rate) - D) = p' (keep dp - D') with
          // p' = p / (1 - rate), D' = D (1 - rate): drop_scale folded once
          sm_m[row] = mx[it];
          sm_il[row] = lx[it] > 0.f ? drop_scale / lx[it] : 0.f;
          sm_d[row] = d / drop_scale;
          sm_h[row] = DROP ? hash_row(seed, r, h, num_heads, row, drop_tile) : 0u;
        }
      }
    }
    for (int i = tid; i < nqp * 8; i += PIPE_THREADS) acc[i] = 0.f;
    for (int i = tid; i < nc; i += PIPE_THREADS) turn[i] = 0;
  }
  // the planes, written by generic stores, are read by the tensor cores'
  // asynchronous proxy; read-only from here on
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = warp >> 2, wq = warp & 3;
  const uint32_t lbo = static_cast<uint32_t>(half) * 4;
  const uint32_t qhi_a = static_cast<uint32_t>(__cvta_generic_to_shared(qhi));
  const uint32_t qlo_a = static_cast<uint32_t>(__cvta_generic_to_shared(qlo));
  const uint32_t dhi_a = static_cast<uint32_t>(__cvta_generic_to_shared(dhi));
  const uint32_t dlo_a = static_cast<uint32_t>(__cvta_generic_to_shared(dlo));
  float2* tb = tbuf + warp * PIPE_TB;
  const float scale = rsqrtf(8.f);
  const int n_slabs = (lk + PIPE_SLAB - 1) / PIPE_SLAB;

  for (int sl = wg; sl < n_slabs; sl += PIPE_WARPGROUPS) {
    const int k0 = sl * PIPE_SLAB + wq * 16;  // this warp's first key
    // A of s and dp in wgmma's register layout: (key g, dim t), (g + 8, t),
    // (g, t + 4), (g + 8, t + 4)
    uint32_t khi[4], klo[4], vhi[4], vlo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + g + 8 * (i & 1);
      const long long off = kbase + static_cast<long long>(row) * e + t + 4 * (i >> 1);
      MM::split(row < lk ? k[off] : 0.f, khi[i], klo[i]);
      MM::split(row < lk ? v[off] : 0.f, vhi[i], vlo[i]);
    }
    // B of dq's product, its k-step j: k of keys 4j + t (slot t) and 4j + t + 8
    // (slot t + 4) at dim g
    MM::B kb[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int row = k0 + 4 * j + t + 8 * x;
        MM::split(row < lk ? k[kbase + static_cast<long long>(row) * e + g] : 0.f, kb[j].hi[x],
                  kb[j].lo[x]);
      }
    float kbias[2];
    uint32_t hcol[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int j = k0 + g + 8 * x;
      kbias[x] = j >= lk ? -INFINITY : ((mask && mask[r * lk + j]) ? MASK_BIAS * LOG2E : 0.f);
      hcol[x] = hash_col(j);
    }
    float gk[4] = {0.f, 0.f, 0.f, 0.f}, gv[4] = {0.f, 0.f, 0.f, 0.f};

    // s^T and dp^T of chunk c into s and dp, asynchronously: the small terms
    // first, then the head product, in fresh accumulators.
    auto issue = [&](int c, float(&s)[2][4], float(&dp)[2][4]) {
      const uint32_t at = c * PIPE_QC * 16;
      wgmma_fence();
      wgmma_keys(s, klo, pipe_desc(qhi_a + at, lbo), 0);
      wgmma_keys(s, khi, pipe_desc(qlo_a + at, lbo), 1);
      wgmma_keys(s, khi, pipe_desc(qhi_a + at, lbo), 1);
      wgmma_keys(dp, vlo, pipe_desc(dhi_a + at, lbo), 0);
      wgmma_keys(dp, vhi, pipe_desc(dlo_a + at, lbo), 1);
      wgmma_keys(dp, vhi, pipe_desc(dhi_a + at, lbo), 1);
      wgmma_commit();
    };
    // Chunk c, its s and dp landed: p, ds, dv and dk, the warp's dq part, and
    // the warpgroup's sum of the chunk added to dq by the warp whose turn it is.
    auto process = [&](int c, float(&s)[2][4], float(&dp)[2][4]) {
      fence_regs(s);
      fence_regs(dp);
      float pk[4] = {0.f, 0.f, 0.f, 0.f}, pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = c * PIPE_QC + 8 * i + 2 * t;  // columns 2t, 2t + 1: queries qi, qi + 1
        const float2 m = *reinterpret_cast<const float2*>(sm_m + qi);
        const float2 il = *reinterpret_cast<const float2*>(sm_il + qi);
        const float2 dl = *reinterpret_cast<const float2*>(sm_d + qi);
        uint2 hr = make_uint2(0u, 0u);
        if (DROP) hr = *reinterpret_cast<const uint2*>(sm_h + qi);
        float ds[4], pd[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int key = x >> 1, col1 = x & 1;
          const float p = fast_exp2(fmaf(s[i][x], q_scale, kbias[key]) - (col1 ? m.y : m.x)) *
                          (col1 ? il.y : il.x);
          float pdv = p, d = dp[i][x];
          if (DROP && !keep_weight<DROP>(col1 ? hr.y : hr.x, hcol[key], threshold)) pdv = d = 0.f;
          ds[x] = p * (d - (col1 ? dl.y : dl.x));
          pd[x] = pdv;
        }
        // B of dv and dk: dout and q of queries qi (slot t) and qi + 1 (slot t + 4) at dim g
        const int at = (g >> 2) * half + qi * 4 + (g & 3);
        const MM::B bd = {{__float_as_uint(dhi[at]), __float_as_uint(dhi[at + 4])},
                          {__float_as_uint(dlo[at]), __float_as_uint(dlo[at + 4])}};
        const MM::B bq = {{__float_as_uint(qhi[at]), __float_as_uint(qhi[at + 4])},
                          {__float_as_uint(qlo[at]), __float_as_uint(qlo[at + 4])}};
        MM::mma(pv, MM::make_a(pd), bd);
        MM::mma(pk, MM::make_a(ds), bq);
        // ds transposed: the pairs (ds(q, g), ds(q, g + 8)) of queries 8i + 2t, + 1
        tb[tslot(8 * i + 2 * t, g)] = make_float2(ds[0], ds[2]);
        tb[tslot(8 * i + 2 * t + 1, g)] = make_float2(ds[1], ds[3]);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        gk[x] += pk[x];
        gv[x] += pv[x];
      }
      __syncwarp();
      // the warp's dq part: ds (queries g, g + 8 of the chunk; keys of slots
      // t, t + 4 of k-step j) times k, over its 16 keys
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 a0 = tb[tslot(g, 4 * j + t)], a1 = tb[tslot(g + 8, 4 * j + t)];
        const float xa[4] = {a0.x, a0.y, a1.x, a1.y};
        MM::mma(part, MM::make_a(xa), kb[j]);
      }
      __syncwarp();  // every lane has read tb before the next chunk writes it
      float4* parts = pbuf + (wg * 2 + (c & 1)) * 4 * 32 + lane;
      parts[wq * 32] = make_float4(part[0], part[1], part[2], part[3]);
      warpgroup_sync(wg);  // the four parts are in; the buffer of c - 1 is free
      if ((c & 3) != wq) return;
      float4 sum = parts[0];
#pragma unroll
      for (int w = 1; w < 4; ++w) {
        const float4 x = parts[w * 32];
        sum = make_float4(sum.x + x.x, sum.y + x.y, sum.z + x.z, sum.w + x.w);
      }
      while (*reinterpret_cast<volatile int*>(turn + c) != sl) {  // slab sl - 1 has added
      }
      __threadfence_block();
      float2* a0 = reinterpret_cast<float2*>(acc + (c * PIPE_QC + g) * 8 + 2 * t);
      float2* a1 = a0 + 32;  // query + 8
      const float2 x0 = *a0, x1 = *a1;
      *a0 = make_float2(x0.x + sum.x, x0.y + sum.y);
      *a1 = make_float2(x1.x + sum.z, x1.y + sum.w);
      __threadfence_block();
      __syncwarp();
      if (lane == 0) *reinterpret_cast<volatile int*>(turn + c) = sl + 1;
    };

    float sa[2][4], da[2][4], sb2[2][4], db2[2][4];
    issue(0, sa, da);
    int c = 0;
    for (; c + 2 < nc; c += 2) {  // chunks c and c + 1
      issue(c + 1, sb2, db2);
      wgmma_wait<1>();
      process(c, sa, da);
      issue(c + 2, sa, da);
      wgmma_wait<1>();
      process(c + 1, sb2, db2);
    }
    if (c + 1 < nc) {
      issue(c + 1, sb2, db2);
      wgmma_wait<1>();
      process(c, sa, da);
      wgmma_wait<0>();
      process(c + 1, sb2, db2);
    } else {
      wgmma_wait<0>();
      process(c, sa, da);
    }
    store_tile<float, 8>(dk + kbase, e, k0, lk, 0, lane, gk, scale, scale);
    store_tile<float, 8>(dv + kbase, e, k0, lk, 0, lane, gv, 1.f, 1.f);
  }

  __syncthreads();  // every slab's dq is summed
  for (int i = tid; i < lq * 2; i += PIPE_THREADS) {
    const int row = i >> 1;
    float4 x = *reinterpret_cast<const float4*>(acc + row * 8 + 4 * (i & 1));
    x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    *reinterpret_cast<float4*>(dq + qbase + static_cast<long long>(row) * e + 4 * (i & 1)) = x;
  }
}

bool routes_pipelined(int dtype, int head_dim, int lq, int lk) {
  return dtype == 0 && head_dim == 8 && lq >= 1 && lq <= PIPE_MAX_QUERIES && lk >= PIPE_MIN_KEYS;
}

int launch_pipelined(const float* q, const float* k, const float* v, const uint8_t* mask,
                     const float* o, const float* dout, const float* row_max,
                     const float* row_sum, float* dq, float* dk, float* dv, long long rows,
                     int lq, int lk, int num_heads, const uint32_t* seed, uint32_t threshold,
                     int full_hash, float drop_scale, cudaStream_t stream) {
  const long long blocks = rows * num_heads;
  if (blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int mode = drop_mode(threshold, full_hash);
  auto kernel = mode == DROP_FULL    ? attention_bwd_kernel_pipelined<DROP_FULL>
                : mode == DROP_SHORT ? attention_bwd_kernel_pipelined<DROP_SHORT>
                                     : attention_bwd_kernel_pipelined<DROP_OFF>;
  const int bytes = pipe_bytes(lq);
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<static_cast<unsigned>(blocks), PIPE_THREADS, bytes, stream>>>(
      q, k, v, mask, o, dout, row_max, row_sum, dq, dk, dv, lq, lk, num_heads,
      LOG2E / sqrtf(8.f), seed, threshold, dropout_tile(lq), drop_scale);
  return static_cast<int>(cudaGetLastError());
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
  if (routes_pipelined(dtype, head_dim, lq, lk))
    return launch_pipelined(static_cast<const float*>(q), static_cast<const float*>(k),
                            static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
                            static_cast<const float*>(o), static_cast<const float*>(dout), m, l,
                            static_cast<float*>(dq), static_cast<float*>(dk),
                            static_cast<float*>(dv), rows, lq, lk, num_heads, seed, threshold,
                            full_hash, drop_scale, s);
  if (dtype == 0)
    return dispatch_dh<float>(head_dim, q, k, v, mask, o, dout, m, l, d, acc, dq, dk, dv, rows,
                              lq, lk, num_heads, seed, threshold, full_hash, drop_scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(head_dim, q, k, v, mask, o, dout, m, l, d, acc, dq, dk,
                                      dv, rows, lq, lk, num_heads, seed, threshold,
                                      full_hash, drop_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// 1 where vaesne_attention_bwd launches the pipelined fp32 kernel for these
// inputs (dtype as there), else 0: the wrapper counts its launches by it and
// gives that kernel no scratch.
extern "C" int vaesne_attention_bwd_pipelined(int dtype, int head_dim, int lq, int lk) {
  return routes_pipelined(dtype, head_dim, lq, lk) ? 1 : 0;
}
