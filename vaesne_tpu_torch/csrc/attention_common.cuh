// What the attention forward (K1) and backward (K2) kernels share: the
// mask bias, the attention-weight dropout mask, the tensor-core tile
// operations on one head (mma.sync m16n8k8), the cp.async staging of a
// chunk of rows into shared memory, and the loop over chunks.
//
// Dropout mask: a pure function of (seed, row, head, query, key), so the
// backward regenerates the forward's mask without storing it. It is the
// JAX package's own counter hash (vaesne_tpu/ops/attention.py::_hash_bits,
// the stream its kernels use in interpret mode) with the single-draw
// seeding of _dropout_mask and its width w of VAESNE_DROPOUT_BITS (8, the
// default, 16 or 32):
//   qt         = min(1024, max(128, Lq rounded up to 128))
//   block_seed = seed + (r*H + h)*1024 + (q / qt)*(qt / 128)     (uint32)
//   x          = block_seed*C_SEED ^ (q % qt + 1)*C_ROW ^ (j + 1)*C_COL
//   x          = murmur3-style finaliser of x
//   keep      <=> (x >> (32 - w)) >= round(2^w * rate)
//             <=> x >= round(2^w * rate) << (32 - w)      (the kernels' thr32)
// So the keep probability is a multiple of 1/2^w (230/256 at rate 0.1 and
// w = 8), while the kept weights are rescaled by 1/(1 - rate) exactly, as in
// the JAX package. The finaliser's first step distributes over the xor,
// (a ^ b) ^ ((a ^ b) >> 16) = (a ^ a >> 16) ^ (b ^ b >> 16), so it is applied
// to the row part once per query and to the column part once per key; what
// is left per (query, key, head) is 6 integer operations (xor, multiply,
// shift, xor, multiply, compare), 8 at w = 32 (keep_weight).
//
// Tiles. A warp owns 16 rows (queries, or keys in the backward) of one
// head. Lane (g = lane / 4, t = lane % 4) holds, of any 16 x 8 block, the
// accumulator layout of mma.sync: rows g and g + 8, columns 2t and 2t + 1.
// A head of Dh values is NC = ceil(Dh / 8) blocks of 8 columns; Dh = 4 is
// zero-padded to 8. Every product is a sum of m16n8k8 products:
//   * bf16: mma.sync.m16n8k8.f32.bf16.bf16.f32, fp32 accumulation;
//   * fp32: three mma.sync.m16n8k8.f32.tf32.tf32.f32 per block ("3xTF32"):
//     each operand x is split into a TF32 head hi (x rounded to nearest to
//     10 mantissa bits) and a TF32 tail lo (the rest, which the tensor core
//     truncates to 10 bits), and a.b = a.lo*b.hi + a.hi*b.lo + a.hi*b.hi,
//     which drops lo*lo and the tail's truncation, ~2^-21 relative at most.
// The depth (k) of an m16n8k8 product is free to permute, as long as A and
// B permute alike. With bf16, k pairs (2t, 2t+1) of A and B already sit as
// an accumulator holds them; with TF32 slot t carries column 2t and slot
// t + 4 column 2t + 1. So an accumulator tile (the scores of 16 rows and 8
// keys) is the A operand of the next product as it stands, with no trip
// through shared memory (the FlashAttention-2 register trick), and B is
// read from shared memory as two values per lane: columns 2t, 2t + 1 of row
// g (load_b(p)), or column g of rows 2t and 2t + 1 (load_b(p0, p1)).
// The tensor cores round their fp32 sums toward zero, so a long sum (over
// ~1000 keys) is accumulated per staged chunk in a fresh accumulator and
// added to the running total in fp32 with round-to-nearest.
//
// bf16 operands that a sum cancels (dS) are kept as two bf16 terms.
//
// Staging: rows of one head stream through shared memory in chunks of
// Head::CHUNK rows, STAGES chunks in flight (16-byte cp.async), one barrier
// per chunk. For fp32 each staged value is split once into its TF32 head
// and tail (two planes of the stage buffer; a second barrier), so the
// products read both halves with no conversion per use. The TF32 split is
// done with integer operations (round the head to nearest; the tail is the
// fp32 rest, which the tensor core truncates), not with cvt.rna.tf32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vaesne {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_BIAS = -1e9f;  // added to a masked key's logit, in fp32

constexpr int STAGES = 3;     // chunks in flight in shared memory
constexpr int MAX_WARPS = 8;  // 16 rows each: up to 128 rows per block

// Blocks per SM that the register allocation must allow (__launch_bounds__):
// two at Dh <= 8 (16 warps per SM, no spills), one for wider heads.
template <int DH>
constexpr int MIN_BLOCKS = DH > 8 ? 1 : 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr uint32_t C_SEED = 0x9E3779B9u;
constexpr uint32_t C_ROW = 0x85EBCA6Bu;
constexpr uint32_t C_COL = 0xC2B2AE35u;
constexpr uint32_t C_MIX1 = 0x7FEB352Du;
constexpr uint32_t C_MIX2 = 0x846CA68Bu;

// The query tile that seeds the stream (the JAX kernel's q-tile).
inline int dropout_tile(int lq) {
  const int rounded = (lq + 127) / 128 * 128;
  return rounded < 128 ? 128 : (rounded > 1024 ? 1024 : rounded);
}

// The per-(row, head, query) part of the hash, after the finaliser's
// first step.
__device__ __forceinline__ uint32_t hash_row(uint32_t seed, long long r, int h,
                                             int num_heads, int q, int qt) {
  const uint32_t block_seed = seed + static_cast<uint32_t>((r * num_heads + h) * 1024) +
                              static_cast<uint32_t>(q / qt) * static_cast<uint32_t>(qt / 128);
  const uint32_t x = (block_seed * C_SEED) ^ (static_cast<uint32_t>(q % qt + 1) * C_ROW);
  return x ^ (x >> 16);
}

// The per-key part of the hash, after the finaliser's first step.
__device__ __forceinline__ uint32_t hash_col(int j) {
  const uint32_t x = static_cast<uint32_t>(j + 1) * C_COL;
  return x ^ (x >> 16);
}

// Kernels take the dropout width as a template argument: DROP_OFF (rate 0),
// DROP_SHORT (w = 8 or 16) or DROP_FULL (w = 32).
constexpr int DROP_OFF = 0, DROP_SHORT = 1, DROP_FULL = 2;

// keep <=> x >= thr32, thr32 = round(2^w rate) << (32 - w). The finaliser's
// last step, x ^= x >> 16, changes no bit of x >> 16, so at w <= 16
// (DROP_SHORT) it is left out; w = 32 (DROP_FULL) compares every bit.
template <int DROP>
__device__ __forceinline__ bool keep_weight(uint32_t row, uint32_t col, uint32_t thr32) {
  uint32_t x = row ^ col;
  x *= C_MIX1;
  x ^= x >> 15;
  x *= C_MIX2;
  if (DROP == DROP_FULL) x ^= x >> 16;
  return x >= thr32;
}

// The kernel's dropout mode for a launch: threshold 0 is the rate-0 kernel.
inline int drop_mode(uint32_t thr32, int full_hash) {
  return thr32 == 0u ? DROP_OFF : (full_hash ? DROP_FULL : DROP_SHORT);
}

// 2^x on the SFU (ex2.approx, ~2 ulp; subnormal results flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- cp.async ------------------------------------------------------------------

// BYTES (4, 8 or 16) from global to shared memory, asynchronously; zeros
// when !pred.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
               "n"(BYTES), "r"(pred ? BYTES : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- one head in tiles ---------------------------------------------------------

template <int DH>
struct Head {
  static constexpr int NC = (DH + 7) / 8;  // blocks of 8 columns
  // rows per staged chunk: 64 up to Dh 8, fewer for wider heads so that
  // STAGES chunks of two fp32 arrays (head and tail planes) fit in 48 KB
  static constexpr int CHUNK = DH <= 8 ? 64 : 512 / DH;
  // a block has at least CHUNK threads: thread i stages row i's side data
  static constexpr int MIN_THREADS = CHUNK > 32 ? CHUNK : 32;
  // shared-memory row stride, in elements: a multiple of 16 bytes for
  // cp.async, chosen so that load_b(p) of the 32 lanes (rows g, columns
  // 2t, 2t + 1) hits distinct banks in both types
  static constexpr int STRIDE = DH <= 8 ? 8 : DH + 8;
};

// Copy Head::CHUNK rows of one head (DH contiguous values, rows `ld`
// elements apart) into dst (rows Head::STRIDE apart) with cp.async,
// zero-filling rows >= valid. Thread tid of the block's nthreads calls it;
// the caller commits.
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int ld, int valid, int tid,
                                           int nthreads) {
  constexpr int BYTES = DH * static_cast<int>(sizeof(T));
  constexpr int CP = BYTES < 16 ? BYTES : 16;
  constexpr int PER = BYTES / CP, EPC = CP / static_cast<int>(sizeof(T));
  for (int i = tid; i < Head<DH>::CHUNK * PER; i += nthreads) {
    const int j = i / PER, c = i % PER;
    const bool ok = j < valid;
    cp_async<CP>(dst + j * Head<DH>::STRIDE + c * EPC, src + (ok ? j * ld : 0) + c * EPC, ok);
  }
}

// Zero a shared array of n elements: with Dh = 4 the 8-wide blocks read
// columns 4..7 of every staged row, which cp.async never writes.
template <typename T>
__device__ __forceinline__ void zero_shared(T* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = T(0.f);
}

// The lane's share of column block c of rows row0 .. row0 + 15 of one head
// (rows `ld` elements apart), in the accumulator layout {(g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1)}; rows >= valid and columns >= DH read as 0.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float (&x)[4], const T* base, long long ld, int row0,
                                          int valid, int c, int lane) {
  const int col = c * 8 + 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + 8 * half;
    float a = 0.f, b = 0.f;
    if (row < valid && col < DH) {
      const T* p = base + row * ld + col;
      a = to_f32(p[0]);
      b = to_f32(p[1]);
    }
    x[2 * half] = a;
    x[2 * half + 1] = b;
  }
}

__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The inverse of load_tile: rows >= valid and columns >= DH are not
// written; row g is scaled by s0 and row g + 8 by s1.
template <typename T, int DH>
__device__ __forceinline__ void store_tile(T* base, long long ld, int row0, int valid, int c,
                                           int lane, const float (&x)[4], float s0, float s1) {
  const int col = c * 8 + 2 * (lane & 3);
  const int row = row0 + (lane >> 2);
  if (col >= DH) return;
  if (row < valid) store_pair(base + row * ld + col, x[0] * s0, x[1] * s0);
  if (row + 8 < valid) store_pair(base + (row + 8) * ld + col, x[2] * s1, x[3] * s1);
}

// -- the m16n8k8 product, per input type ---------------------------------------

template <typename T>
struct Mma;

// bf16 operands (the scores P and dS are rounded to bf16 as operands of
// their products), fp32 accumulation.
template <>
struct Mma<__nv_bfloat16> {
  static constexpr int PARTS = 1;  // planes per staged array
  struct A {
    uint32_t r[2];
  };
  struct B {
    uint32_t r;
  };
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ A make_a(const float (&x)[4]) {
    return {{pack(x[0], x[1]), pack(x[2], x[3])}};
  }
  // An A operand kept to ~16 bits: its bf16 head and the bf16 of the rest,
  // two products. For dS, whose sum over keys (or queries) cancels.
  struct A2 {
    A hi, lo;
  };
  static __device__ __forceinline__ float low_half(uint32_t r) { return __uint_as_float(r << 16); }
  static __device__ __forceinline__ float high_half(uint32_t r) {
    return __uint_as_float(r & 0xffff0000u);
  }
  static __device__ __forceinline__ A2 make_a2(const float (&x)[4]) {
    const A hi = make_a(x);
    const float rest[4] = {x[0] - low_half(hi.r[0]), x[1] - high_half(hi.r[0]),
                           x[2] - low_half(hi.r[1]), x[3] - high_half(hi.r[1])};
    return {hi, make_a(rest)};
  }
  // the staged value is used as it is: no tail plane
  static __device__ __forceinline__ void presplit(__nv_bfloat16*, int, int, int) {}
  // store x where load_b reads a staged value
  static __device__ __forceinline__ void put(__nv_bfloat16* p, int, float x) {
    *p = __float2bfloat16(x);
  }
  static __device__ __forceinline__ B load_b(const __nv_bfloat16* p, int) {
    return {*reinterpret_cast<const uint32_t*>(p)};
  }
  static __device__ __forceinline__ B load_b(const __nv_bfloat16* p0, const __nv_bfloat16* p1,
                                             int) {
    return {static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p0)) |
            (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p1)) << 16)};
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(b.r));
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const A2& a, const B& b) {
    mma(c, a.lo, b);
    mma(c, a.hi, b);
  }
};

// fp32 operands by 3xTF32.
template <>
struct Mma<float> {
  static constexpr int PARTS = 2;  // planes per staged array: TF32 head, tail
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  // hi: x rounded to nearest to 10 mantissa bits; lo = x - hi, exact in
  // fp32, of which the tensor core reads the upper 19 bits (sign, exponent,
  // 10 mantissa bits), truncating it (error <= 2^-21 |x|)
  static __device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
  // Split the n staged values at p into head (in place) and tail (at p +
  // n), by thread tid of the block's nthreads; the caller synchronises.
  static __device__ __forceinline__ void presplit(float* p, int n, int tid, int nthreads) {
    for (int i = tid; i < n; i += nthreads) {
      uint32_t hi, lo;
      split(p[i], hi, lo);
      p[i] = __uint_as_float(hi);
      p[i + n] = __uint_as_float(lo);
    }
  }
  // 3xTF32 is already as precise as A2 asks
  using A2 = A;
  // A's registers: (g, slot t), (g+8, slot t), (g, slot t+4), (g+8, slot t+4)
  static __device__ __forceinline__ A make_a(const float (&x)[4]) {
    A a;
    split(x[0], a.hi[0], a.lo[0]);
    split(x[2], a.hi[1], a.lo[1]);
    split(x[1], a.hi[2], a.lo[2]);
    split(x[3], a.hi[3], a.lo[3]);
    return a;
  }
  static __device__ __forceinline__ A make_a2(const float (&x)[4]) { return make_a(x); }
  // store x where load_b reads a presplit value
  static __device__ __forceinline__ void put(float* p, int lo, float x) {
    uint32_t h, l;
    split(x, h, l);
    p[0] = __uint_as_float(h);
    p[lo] = __uint_as_float(l);
  }
  // B from a presplit buffer, its tail plane `lo` elements on
  static __device__ __forceinline__ B load_b(const float* p, int lo) {
    const float2 h = *reinterpret_cast<const float2*>(p);
    const float2 l = *reinterpret_cast<const float2*>(p + lo);
    return {{__float_as_uint(h.x), __float_as_uint(h.y)}, {__float_as_uint(l.x), __float_as_uint(l.y)}};
  }
  static __device__ __forceinline__ B load_b(const float* p0, const float* p1, int lo) {
    return {{__float_as_uint(p0[0]), __float_as_uint(p1[0])},
            {__float_as_uint(p0[lo]), __float_as_uint(p1[lo])}};
  }
  static __device__ __forceinline__ void mma1(float (&c)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // the small terms first, then the head product
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    mma1(c, a.lo, b.hi);
    mma1(c, a.hi, b.lo);
    mma1(c, a.hi, b.hi);
  }
};

// -- staging and the chunk loop --------------------------------------------------

// Stage the first STAGES - 1 chunks. Called early, so that the copies
// overlap the kernel's own loads.
template <typename Stager>
__device__ __forceinline__ void stage_ahead(Stager& sg, int n_chunks) {
#pragma unroll
  for (int ci = 0; ci < STAGES - 1; ++ci) {
    if (ci < n_chunks) {
      sg.fetch(ci, ci);
      sg.land(ci, ci);
    }
    cp_async_commit();
  }
}

// The loop over chunks of every kernel, after stage_ahead: per chunk one
// barrier (two in fp32, around the TF32 split), the chunk STAGES - 1 ahead
// fetched into the stage just consumed, compute(ci, stage) by every thread,
// then the side data of the fetched chunk landed.
template <typename Stager, typename Compute>
__device__ __forceinline__ void run_chunks(Stager& sg, int n_chunks, Compute&& compute) {
  for (int ci = 0, st = 0; ci < n_chunks; ++ci, st = st + 1 == STAGES ? 0 : st + 1) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk ci has landed; chunk ci - 1 is consumed
    if (sg.split(st)) __syncthreads();
    const int next = ci + STAGES - 1, nst = st == 0 ? STAGES - 1 : st - 1;
    if (next < n_chunks) sg.fetch(next, nst);
    cp_async_commit();
    compute(ci, st);
    if (next < n_chunks) sg.land(next, nst);
  }
}

}  // namespace vaesne
