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
// Two designs, chosen in vaesne_attention_fwd from the dtype, the head size
// and Lk alone (routes_pipelined):
//
// The pipelined fp32 kernel (attention_fwd_kernel_pipelined), for fp32 at
// Dh = 8 with 64 <= Lk <= 1664 keys: the model's 982 x 982, 983 x 983 and
// 900 x 900 grids. One block of four warpgroups per (row, head) stages ALL
// of its keys once, before the key loop: K split into TF32 head and tail
// planes in wgmma's K-major layout, V split in the lanes' mma.sync fragment
// order, the bias and the dropout hash's key part (226 KB of shared memory
// at most). That is the block's one barrier; the 64-query tiles of a
// warpgroup then run their key loops with none. Per chunk of 64 keys the
// scores are three asynchronous wgmma m64n64k8 (3xTF32, q from registers,
// k from shared memory), issued one chunk ahead into a second register
// buffer, so that they run on the tensor cores while the warp does the
// chunk before: s2 = (q.k) log2(e)/sqrt(Dh) + bias, the row max by two
// shuffles, one exp2 per pair, the row sums, the dropout hash, the TF32
// split of p, and o += p v by mma.sync (3xTF32, p still in the
// accumulator's registers, two accumulator chains of at most 32 keys each,
// added to o in fp32 with round-to-nearest).
//
// The chunked kernel (attention_fwd_kernel) for everything else: bf16, Dh
// 4, 16 and 32, and the short grids (982 x 5, 60 x 60, 60 x 4). Tensor
// cores for both products (mma.sync m16n8k8, see attention_common.cuh).
// One block per (row, head, up to 128 queries), one warp per 16 queries:
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
// (three TF32 products per block, ~2^-21 relative per product) in both
// designs, within the 1e-5 max-abs gate against the plain fp32 version.
//
// What bounds it: at the flagship grid (982 x 982, 4 heads, Dh = 8) the
// products are 64 (bf16) or 192 (3xTF32) tensor-core flop per (query, key,
// head) and device memory moves 0.5 MB per row: neither is near its peak.
// Per pair there is one exp2 on the SFU (16 per SM per clock: 0.71 ms at
// R = 768) and a dozen fp32 instructions around it (scale and bias, max,
// subtract, sum, the p split), plus, at rate > 0, the dropout hash's 6
// integer operations and a select. Measured on the H100 (PERF.md §7), per
// 16 x 8 tile and SM sub-partition, the chunked fp32 kernel took ~141
// clocks: ~47 of them its six TF32 mma.sync (~8 each, and their time adds
// to, not overlaps, the other instructions'), ~38 the per-chunk barriers,
// staging and re-split, the exp2s nothing (the SFU has room). The pipelined
// kernel stages and splits once, runs the scores on wgmma beside the
// softmax, and is bound by the ~40 instructions a tile around each exp2
// plus the three PV mma.sync (~100 clocks a tile). PV on wgmma as well
// (m64n8k8, p from registers) is not used: reading its accumulator back
// into o each chunk (the round-to-nearest running sum) makes ptxas
// serialize the wgmmas unless a thread has ~250 registers, and at 8 warps
// an SM the softmax then lacks the warps to hide its latencies. In bf16
// the instruction rate is the limit, at about 2.6 times the exp2 floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
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
                     int n_tiles, float q_scale, const uint32_t* __restrict__ seed_word,
                     uint32_t threshold, int drop_tile, float out_scale) {
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
    const uint32_t seed = __ldg(seed_word);  // one word for the launch (a graph rewrites it)
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

// -- the pipelined fp32 design: Dh = 8, PIPE_MIN_KEYS <= Lk <= PIPE_MAX_KEYS ---------

constexpr int PIPE_WARPGROUPS = 4;  // 16 warps, one block per SM
constexpr int PIPE_THREADS = PIPE_WARPGROUPS * 128;
constexpr int PIPE_KT = 8;  // key tiles per chunk: the 64 keys of one wgmma share a max update
// Shared memory per tile of 8 keys: K's TF32 head and tail planes in
// wgmma's no-swizzle K-major layout (256 bytes each), V's fragments for
// mma.sync (a float4 a lane: the two values it reads, head then tail), the
// bias and the dropout hash's key part of each key.
constexpr int PIPE_TILE_BYTES = 2 * 256 + 32 * 16 + 8 * 4 + 8 * 4;
constexpr int PIPE_MAX_TILES = 208;  // 226,304 bytes of the 232,448 a block may use
constexpr int PIPE_MIN_KEYS = PIPE_KT * 8, PIPE_MAX_KEYS = PIPE_MAX_TILES * 8;

int pipe_sms = 132;  // the card's SM count, read by vaesne_attention_fwd_init

__device__ __forceinline__ Mma<float>::B fragment(const float4& x) {
  return {{__float_as_uint(x.x), __float_as_uint(x.y)}, {__float_as_uint(x.z), __float_as_uint(x.w)}};
}

// A wgmma shared-memory matrix descriptor, no swizzle: core matrices of 8
// rows of 16 bytes, 128 bytes apart along K (leading), 256 bytes apart
// along N (stride).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// d (+)= a b: the 64 x 64 scores of a warpgroup's 64 queries (A, TF32, from
// registers) and 64 keys (B, TF32, K-major in shared memory). Each warp's
// part of d has mma.sync's accumulator layout, key tile i in d[i].
__device__ __forceinline__ void wgmma_scores(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

// One block per (row, head) walks its query tiles of 64, a warpgroup
// (four warps) each (or, where rows x heads is below the SM count, per
// (row, head, group) a share of them). Before the key loop it stages ALL of
// the (row, head)'s keys, split once into TF32 planes (K in wgmma's layout,
// V in the lanes' mma.sync fragment order), with the bias and the hash's
// key part: the block's one barrier. Each warpgroup then runs its tiles'
// key loops alone: the scores of chunk c + 1 (3xTF32, three wgmma
// m64n64k8, asynchronous) are issued before the exp2s, sums, p split and
// PV products (mma.sync, per warp) of chunk c, into a second register
// buffer (the loop unrolled by two), so the tensor cores, the SFU and the
// ALUs of a sub-partition work at once. Keys past Lk up to the chunk are
// zero with bias -inf; the last chunk skips its tiles past Lk.
template <int DROP>
__global__ void __launch_bounds__(PIPE_THREADS, 1)
attention_fwd_kernel_pipelined(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const uint8_t* __restrict__ mask,
                               float* __restrict__ out, float* __restrict__ row_max,
                               float* __restrict__ row_sum, int lq, int lk, int num_heads,
                               int groups, float q_scale, const uint32_t* __restrict__ seed_word,
                               uint32_t threshold, int drop_tile, float out_scale) {
  using MM = Mma<float>;
  constexpr int KT = PIPE_KT;
  extern __shared__ __align__(128) unsigned char pipe_smem[];
  const int nt = (lk + 7) / 8;                 // key tiles holding keys
  const int ntp = (nt + KT - 1) / KT * KT;     // staged: whole chunks
  float4* khi = reinterpret_cast<float4*>(pipe_smem);  // [ntp][2][8 keys] of 4 dims
  float4* klo = khi + ntp * 16;
  float4* vf = klo + ntp * 16;                          // [ntp][32 lanes]
  float* bias = reinterpret_cast<float*>(vf + ntp * 32);
  uint32_t* colh = reinterpret_cast<uint32_t*>(bias + ntp * 8);

  const long long blk = blockIdx.x;
  const int grp = static_cast<int>(blk % groups);
  const int h = static_cast<int>((blk / groups) % num_heads);
  const long long r = blk / (static_cast<long long>(groups) * num_heads);
  const int e = num_heads * 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t = lane & 3, g = lane >> 2;

  {
    const float* kb = k + r * lk * e + h * 8;
    const float* vb = v + r * lk * e + h * 8;
    const uint8_t* mb = mask ? mask + r * lk : nullptr;
    // Item i: key 8 kt + rr, dims 4 j .. 4 j + 3, of K and of V. All of a
    // thread's loads are in flight before the first is used.
    constexpr int ITERS = (PIPE_MAX_TILES * 16 + PIPE_THREADS - 1) / PIPE_THREADS;
    float4 kx[ITERS], vx[ITERS];
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = tid + it * PIPE_THREADS, key = (i >> 4) * 8 + (i & 7), j = (i >> 3) & 1;
      kx[it] = vx[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < ntp * 16 && key < lk) {
        const long long off = static_cast<long long>(key) * e + 4 * j;
        kx[it] = __ldg(reinterpret_cast<const float4*>(kb + off));
        vx[it] = __ldg(reinterpret_cast<const float4*>(vb + off));
      }
    }
    for (int j = tid; j < ntp * 8; j += PIPE_THREADS) {
      bias[j] = j >= lk ? -INFINITY : (mb && mb[j] ? MASK_BIAS * LOG2E : 0.f);
      if (DROP) colh[j] = hash_col(j);
    }
    float* vfs = reinterpret_cast<float*>(vf);
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int i = tid + it * PIPE_THREADS;
      if (i < ntp * 16) {
        // K: row rr of core matrix j of tile kt
        split4(kx[it], khi[i], klo[i]);
        // V: lane (g, t) of tile kt holds V[8 kt + 2t, 8 kt + 2t + 1][g], heads then tails
        float4 hi, lo;
        split4(vx[it], hi, lo);
        const int rr = i & 7, j = (i >> 3) & 1;
        float* dst = vfs + ((i >> 4) * 32 + 16 * j + (rr >> 1)) * 4 + (rr & 1);
        dst[0] = hi.x;
        dst[2] = lo.x;
        dst[16] = hi.y;
        dst[18] = lo.y;
        dst[32] = hi.z;
        dst[34] = lo.z;
        dst[48] = hi.w;
        dst[50] = lo.w;
      }
    }
  }
  // the staged keys, written by this thread's generic stores, are read by
  // the tensor cores' asynchronous proxy; read-only from here on
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint32_t seed = DROP ? __ldg(seed_word) : 0u;  // one word for the launch
  const int nch = ntp / KT, nlast = nt - (nch - 1) * KT;  // chunks; tiles of the last
  const uint32_t khi_addr = static_cast<uint32_t>(__cvta_generic_to_shared(khi));
  const uint32_t klo_addr = static_cast<uint32_t>(__cvta_generic_to_shared(klo));
  const float* qb = q + r * lq * e + h * 8;
  const int n_qt = (lq + 63) / 64, wg = warp >> 2;

  for (int qt = grp + groups * wg; qt < n_qt; qt += groups * PIPE_WARPGROUPS) {
    const int q0 = qt * 64 + (warp & 3) * 16;  // this warp's 16 queries
    // A of the scores in wgmma's register layout: (g, t), (g + 8, t),
    // (g, t + 4), (g + 8, t + 4), dims in their own order
    uint32_t qhi[4], qlo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + g + 8 * (i & 1), col = t + 4 * (i >> 1);
      MM::split(row < lq ? qb[static_cast<long long>(row) * e + col] : 0.f, qhi[i], qlo[i]);
    }
    uint32_t hrow0 = 0, hrow1 = 0;
    if (DROP) {
      hrow0 = hash_row(seed, r, h, num_heads, q0 + g, drop_tile);
      hrow1 = hash_row(seed, r, h, num_heads, q0 + g + 8, drop_tile);
    }
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    // The raw scores q.k of chunk c into s, asynchronously: the small
    // terms first, then the head product, in a fresh accumulator.
    auto issue = [&](int c, float(&s)[KT][4]) {
      const uint64_t dhi = kmajor_desc(khi_addr + c * KT * 256);
      const uint64_t dlo = kmajor_desc(klo_addr + c * KT * 256);
      wgmma_fence();
      wgmma_scores(s, qlo, dhi, 0);
      wgmma_scores(s, qhi, dlo, 1);
      wgmma_scores(s, qhi, dhi, 1);
      wgmma_commit();
    };
    // Chunk c's first ntl tiles, their scores landed in s: s2 = (q.k)
    // log2(e)/sqrt(Dh) + bias, the online softmax and o += p v, the PV
    // products in two accumulator chains (even and odd tiles), each a fresh
    // sum of at most 32 keys, added to o in fp32 with round-to-nearest.
    auto process = [&](auto full, int c, int ntl, float(&s)[KT][4]) {
      constexpr bool FULL = decltype(full)::value;
      fence_regs(s);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        if (FULL || kt < ntl) {
          const float2 b = *reinterpret_cast<const float2*>(bias + (c * KT + kt) * 8 + 2 * t);
          s[kt][0] = fmaf(s[kt][0], q_scale, b.x);
          s[kt][1] = fmaf(s[kt][1], q_scale, b.y);
          s[kt][2] = fmaf(s[kt][2], q_scale, b.x);
          s[kt][3] = fmaf(s[kt][3], q_scale, b.y);
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
      float pv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        if (FULL || kt < ntl) {
          const int ti = c * KT + kt;
          float p[4] = {fast_exp2(s[kt][0] - mn0), fast_exp2(s[kt][1] - mn0),
                        fast_exp2(s[kt][2] - mn1), fast_exp2(s[kt][3] - mn1)};
          ls0 += p[0] + p[1];
          ls1 += p[2] + p[3];
          if (DROP) {
            const uint2 ch = *reinterpret_cast<const uint2*>(colh + ti * 8 + 2 * t);
            if (!keep_weight<DROP>(hrow0, ch.x, threshold)) p[0] = 0.f;
            if (!keep_weight<DROP>(hrow0, ch.y, threshold)) p[1] = 0.f;
            if (!keep_weight<DROP>(hrow1, ch.x, threshold)) p[2] = 0.f;
            if (!keep_weight<DROP>(hrow1, ch.y, threshold)) p[3] = 0.f;
          }
          MM::mma(pv[kt & 1], MM::make_a(p), fragment(vf[ti * 32 + lane]));
        }
      }
      l0 = fmaf(l0, corr0, ls0);
      l1 = fmaf(l1, corr1, ls1);
      o[0] = fmaf(o[0], corr0, pv[0][0] + pv[1][0]);
      o[1] = fmaf(o[1], corr0, pv[0][1] + pv[1][1]);
      o[2] = fmaf(o[2], corr1, pv[0][2] + pv[1][2]);
      o[3] = fmaf(o[3], corr1, pv[0][3] + pv[1][3]);
    };

    constexpr std::true_type WHOLE{};
    constexpr std::false_type LAST{};
    float sa[KT][4], sb[KT][4];
    issue(0, sa);
    int c = 0;
    for (; c + 2 < nch; c += 2) {  // chunks c and c + 1 are whole
      issue(c + 1, sb);
      wgmma_wait<1>();
      process(WHOLE, c, KT, sa);
      issue(c + 2, sa);
      wgmma_wait<1>();
      process(WHOLE, c + 1, KT, sb);
    }
    if (c + 1 < nch) {
      issue(c + 1, sb);
      wgmma_wait<1>();
      process(WHOLE, c, KT, sa);
      wgmma_wait<0>();
      process(LAST, c + 1, nlast, sb);
    } else {
      wgmma_wait<0>();
      process(LAST, c, nlast, sa);
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    store_tile<float, 8>(out + r * lq * e + h * 8, e, q0, lq, 0, lane, o, out_scale / l0,
                         out_scale / l1);
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

bool routes_pipelined(int dtype, int head_dim, int lk) {
  return dtype == 0 && head_dim == 8 && lk >= PIPE_MIN_KEYS && lk <= PIPE_MAX_KEYS;
}

int launch_pipelined(const float* q, const float* k, const float* v, const uint8_t* mask,
                     float* out, float* row_max, float* row_sum, long long rows, int lq, int lk,
                     int num_heads, const uint32_t* seed, uint32_t threshold, int full_hash,
                     float out_scale, cudaStream_t stream) {
  // a block per (row, head); where those are fewer than the SMs, each
  // (row, head)'s query tiles are shared among `groups` blocks
  const long long row_heads = rows * num_heads;
  const int n_qt = (lq + 63) / 64;
  int groups = 1;
  if (row_heads < pipe_sms) {
    const long long share = pipe_sms / row_heads;
    groups = share < n_qt ? static_cast<int>(share) : n_qt;
  }
  const long long blocks = row_heads * groups;
  if (blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const float q_scale = LOG2E / sqrtf(8.f);
  const int mode = drop_mode(threshold, full_hash);
  auto kernel = mode == DROP_FULL    ? attention_fwd_kernel_pipelined<DROP_FULL>
                : mode == DROP_SHORT ? attention_fwd_kernel_pipelined<DROP_SHORT>
                                     : attention_fwd_kernel_pipelined<DROP_OFF>;
  const int smem = ((lk + 7) / 8 + PIPE_KT - 1) / PIPE_KT * PIPE_KT * PIPE_TILE_BYTES;
  kernel<<<static_cast<unsigned>(blocks), PIPE_THREADS, smem, stream>>>(
      q, k, v, mask, out, row_max, row_sum, lq, lk, num_heads, groups, q_scale, seed, threshold,
      dropout_tile(lq), out_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           float* row_max, float* row_sum, long long rows, int lq, int lk, int num_heads,
           const uint32_t* seed, uint32_t threshold, int full_hash, float out_scale,
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
                int num_heads, const uint32_t* seed, uint32_t threshold, int full_hash,
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
// both null. seed points to the dropout seed, one uint32 in device memory,
// read only when dropout is on (it may be null at rate 0). threshold is the
// keep threshold thr32 of attention_common.cuh
// (0 turns dropout off: the rate-0 kernel), full_hash 1 at width 32; out_scale
// is 1/(1 - rate). Every pointer is 16-byte aligned. Returns the
// cudaError_t of the launch (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int vaesne_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, void* row_max,
                                    void* row_sum, long long rows, int lq, int lk,
                                    int num_heads, int head_dim, int dtype,
                                    const void* seed_word, uint32_t threshold, int full_hash,
                                    float out_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* seed = static_cast<const uint32_t*>(seed_word);
  if (threshold != 0 && seed == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* m = static_cast<float*>(row_max);
  float* l = static_cast<float*>(row_sum);
  if ((m == nullptr) != (l == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (routes_pipelined(dtype, head_dim, lk))
    return launch_pipelined(static_cast<const float*>(q), static_cast<const float*>(k),
                            static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
                            static_cast<float*>(out), m, l, rows, lq, lk, num_heads, seed,
                            threshold, full_hash, out_scale, s);
  if (dtype == 0)
    return dispatch_dh<float>(head_dim, q, k, v, mask, out, m, l, rows, lq, lk, num_heads,
                              seed, threshold, full_hash, out_scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(head_dim, q, k, v, mask, out, m, l, rows, lq, lk,
                                      num_heads, seed, threshold, full_hash, out_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// 1 where vaesne_attention_fwd launches the pipelined fp32 kernel for these
// inputs (dtype as there), else 0: the wrapper counts its launches by it.
extern "C" int vaesne_attention_fwd_pipelined(int dtype, int head_dim, int lk) {
  return routes_pipelined(dtype, head_dim, lk) ? 1 : 0;
}

// Once per device, when the library is loaded and before any launch (never
// inside a stream capture): lets the pipelined kernel take its shared
// memory, above the 48 KB a launch gets by default, and reads the SM count
// that its grid is sized by. Returns a cudaError_t.
extern "C" int vaesne_attention_fwd_init() {
  const int bytes = PIPE_MAX_TILES * PIPE_TILE_BYTES;
  for (auto kernel : {attention_fwd_kernel_pipelined<DROP_OFF>,
                      attention_fwd_kernel_pipelined<DROP_SHORT>,
                      attention_fwd_kernel_pipelined<DROP_FULL>}) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sms > 0) pipe_sms = sms;
  return 0;
}
