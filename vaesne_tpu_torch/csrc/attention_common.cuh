// What the attention forward (K1) and backward (K2) kernels share: the
// fp32 load/store helpers, the mask bias, and the attention-weight dropout
// mask, a pure function of (seed, row, head, query, key), so the backward
// regenerates the forward's mask without storing it.
//
// The mask is the JAX package's own counter hash (vaesne_tpu/ops/attention.py::
// _hash_bits, the stream its kernels use in interpret mode) with the
// single-draw seeding of _dropout_mask and its default 8-bit width:
//   qt         = min(1024, max(128, Lq rounded up to 128))
//   block_seed = seed + (r*H + h)*1024 + (q / qt)*(qt / 128)     (uint32)
//   x          = block_seed*C_SEED ^ (q % qt + 1)*C_ROW ^ (j + 1)*C_COL
//   x          = murmur3-style finaliser of x
//   keep      <=> (x >> 24) >= round(256 * rate)
// So the keep probability is a multiple of 1/256 (230/256 at rate 0.1),
// while the kept weights are rescaled by 1/(1 - rate) exactly, as in the
// JAX package. About 9 integer operations per (query, key, head).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vaesne {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_BIAS = -1e9f;  // added to a masked key's logit, in fp32

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

// The per-(row, head, query) part of the hash.
__device__ __forceinline__ uint32_t hash_row(uint32_t seed, long long r, int h,
                                             int num_heads, int q, int qt) {
  const uint32_t block_seed = seed + static_cast<uint32_t>((r * num_heads + h) * 1024) +
                              static_cast<uint32_t>(q / qt) * static_cast<uint32_t>(qt / 128);
  return (block_seed * C_SEED) ^ (static_cast<uint32_t>(q % qt + 1) * C_ROW);
}

// The per-key part of the hash.
__device__ __forceinline__ uint32_t hash_col(int j) {
  return static_cast<uint32_t>(j + 1) * C_COL;
}

__device__ __forceinline__ bool keep_weight(uint32_t row, uint32_t col, uint32_t threshold) {
  uint32_t x = row ^ col;
  x ^= x >> 16;
  x *= C_MIX1;
  x ^= x >> 15;
  x *= C_MIX2;
  x ^= x >> 16;
  return (x >> 24) >= threshold;
}

}  // namespace vaesne
