// Masked Laplace log-likelihood, forward (K3) and backward (K4), for Hopper
// (sm_90a).
//
// Replaces the TPU kernels vaesne_tpu/ops/laplace.py::_fwd_kernel (K3) and
// ::_bwd_kernel (K4). Per row (k, b) of a [K, B, N] grid, with
// s = 1 + big * mask:
//   K3: out[k, b]     = sum_n -|x - loc| / s - log(2 s)
//   K4: dloc[k, b, n] = g[k, b] * sign(x - loc) / s,   sign(0) = 0
//
// Layout: every operand is addressed as base + k * stride_k + b * stride_b
// + n, so the kernels read the decoder's output where it lies: an expert's
// [K, B, N] slice of the stacked [M*K, B, N] decode (strides N and M*K*N),
// a mask or data broadcast over K (stride 0), and the flat [R, N] form read
// as K = R / Rx rows per row of x (row r = b * K + k). loc and dloc are
// fp32 or bf16, x and g fp32, the mask bytes (nonzero = masked). Every sum
// and every point of K4 is computed in fp32; K4 stores in loc's dtype,
// rounding to nearest.
//
// What bounds it: at the path's shapes ([2 * 16, 982] to [8 * 32, 982] and
// [2 * 192, 982]) a launch moves 0.2 to 5 MB, 0.07 to 1.5 us at 3.35 TB/s,
// so its time is the launch and the round trips to memory of a row, not the
// bandwidth. The design exposes one round trip per row:
//   * one row per block of 256 threads (eight warps), each thread holding
//     two pairs (or four single points) of a 1024-point chunk: [32, 982]
//     spreads over 32 SMs and [384, 982] is resident at once, one wave on
//     132 SMs. Few groups per thread is what keeps it to one round trip:
//     ptxas interleaves the loads of a thread's later groups with the
//     arithmetic on its first ones, and a warp issues in order, so with
//     eight pairs per thread (a block of 64) the later loads waited behind
//     the first ones' data;
//   * a chunk's loads are unconditional (see Chunk) and K4 loads g, and
//     divides it, only after them;
//   * 8-byte loads of fp32 pairs, 4-byte of bf16 pairs and 2-byte of mask
//     pairs where every row of every operand starts on a pair boundary (N
//     even); else single points. A row of 982 floats is 3,928 bytes, so
//     odd rows and the expert slices start 8 bytes off a 16-byte boundary,
//     which rules out 16-byte loads and TMA bulk copies;
//   * no division and no log per point. s takes two values, so sum log(2 s)
//     = n_obs * log(2) + n_masked * log(2 (1 + big)), the two logs in fp32
//     as the plain version computes them, passed in; K3 sums |x - loc| over
//     observed and over masked points apart and divides the masked sum by
//     1 + big once per row (a masked term is ~1e-10, far below the fp32
//     resolution of a row sum); K4 takes q = g / (1 + big) once per row, and
//     sign * q equals the plain version's (g * sign) / s bit for bit. (A
//     true division per masked point is a branch around a subroutine that
//     some lanes of every warp take, one dependent chain per point.);
//   * a block's (b, k) is (blockIdx.x, blockIdx.y): no integer division;
//   * the row sum goes in a fixed order (each thread over its points, a
//     butterfly of warp shuffles, then the eight warps in order), with no
//     atomics: two runs give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;  // one row per block: eight warps
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 1024;  // points of a row a block loads before arithmetic

// One operand: element (k, b, n) at p + k * sk + b * sb + n.
struct Operand {
  const void* p;
  long long sk, sb;
};

template <typename T>
__device__ __forceinline__ const T* row_of(const Operand& o, long long k, long long b) {
  return static_cast<const T*>(o.p) + k * o.sk + b * o.sb;
}

// G points of each operand travel as one load: G = 2 (pairs) or 1.
template <typename T, int G>
using LocG = std::conditional_t<G == 2,
                                std::conditional_t<std::is_same<T, float>::value, float2,
                                                   __nv_bfloat162>,
                                T>;
template <int G>
using XG = std::conditional_t<G == 2, float2, float>;
template <int G>
using MaskG = std::conditional_t<G == 2, uchar2, uint8_t>;

__device__ __forceinline__ void unpack(float v, float* o) { o[0] = v; }
__device__ __forceinline__ void unpack(float2 v, float* o) {
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void unpack(__nv_bfloat16 v, float* o) { o[0] = __bfloat162float(v); }
__device__ __forceinline__ void unpack(__nv_bfloat162 v, float* o) {
  const float2 f = __bfloat1622float2(v);
  o[0] = f.x;
  o[1] = f.y;
}
__device__ __forceinline__ void unpack(uint8_t v, bool* o) { o[0] = v != 0; }
__device__ __forceinline__ void unpack(uchar2 v, bool* o) {
  o[0] = v.x != 0;
  o[1] = v.y != 0;
}

__device__ __forceinline__ void store(float* p, const float* v, std::integral_constant<int, 1>) {
  *p = v[0];
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v,
                                      std::integral_constant<int, 1>) {
  *p = __float2bfloat16_rn(v[0]);
}
__device__ __forceinline__ void store(float* p, const float* v, std::integral_constant<int, 2>) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v,
                                      std::integral_constant<int, 2>) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

// The loads of one chunk of a row: group gi = c0 + u * THREADS + tid (G
// points each) into registers. The loads are unconditional (a group past
// the row's end reads the last group again) and sit in one basic block
// with no branch, so all of them are issued before any is used; a load
// under `if (gi < groups)` lets the compiler sink it into the block that
// uses it, and the thread then waits for one round trip per group.
template <typename T, int G>
struct Chunk {
  static constexpr int U = CHUNK / (THREADS * G);  // groups per thread
  LocG<T, G> loc[U];
  XG<G> x[U];
  MaskG<G> mask[U];

  __device__ __forceinline__ void load(const T* lp, const float* xp, const uint8_t* mp,
                                       int c0, int groups, int tid) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int gi = min(c0 + u * THREADS + tid, groups - 1);
      loc[u] = reinterpret_cast<const LocG<T, G>*>(lp)[gi];
      x[u] = reinterpret_cast<const XG<G>*>(xp)[gi];
      mask[u] = reinterpret_cast<const MaskG<G>*>(mp)[gi];
    }
  }

  // fn(gi, valid, d, m): d[j] = x - loc and m[j] the mask of the group's
  // points; valid is false for a group past the row's end
  template <typename Fn>
  __device__ __forceinline__ void each(int c0, int groups, int tid, Fn fn) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int gi = c0 + u * THREADS + tid;
      float l[G], xv[G], d[G];
      bool m[G];
      unpack(loc[u], l);
      unpack(x[u], xv);
      unpack(mask[u], m);
#pragma unroll
      for (int j = 0; j < G; ++j) d[j] = xv[j] - l[j];
      fn(gi, gi < groups, d, m);
    }
  }
};

template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
laplace_fwd_kernel(Operand loc, Operand x, Operand mask, float* __restrict__ out, long long out_k,
                   long long out_b, int n, float big, float log_obs, float log_masked) {
  const long long b = blockIdx.x, k = blockIdx.y;
  const T* lp = row_of<T>(loc, k, b);
  const float* xp = row_of<float>(x, k, b);
  const uint8_t* mp = row_of<uint8_t>(mask, k, b);
  const int tid = threadIdx.x, groups = n / G;
  float obs = 0.f, masked = 0.f;  // sums of |x - loc| over this thread's points
  int n_masked = 0;
  for (int c0 = 0; c0 < groups; c0 += CHUNK / G) {
    Chunk<T, G> c;
    c.load(lp, xp, mp, c0, groups, tid);
    c.each(c0, groups, tid, [&](int, bool valid, const float* d, const bool* m) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float a = valid ? fabsf(d[j]) : 0.f;
        obs += m[j] ? 0.f : a;
        masked += m[j] ? a : 0.f;
        n_masked += valid && m[j];
      }
    });
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    obs += __shfl_xor_sync(0xffffffffu, obs, off);
    masked += __shfl_xor_sync(0xffffffffu, masked, off);
    n_masked += __shfl_xor_sync(0xffffffffu, n_masked, off);
  }
  __shared__ float part_obs[WARPS], part_masked[WARPS];
  __shared__ int part_n[WARPS];
  if ((tid & 31) == 0) {
    part_obs[tid >> 5] = obs;
    part_masked[tid >> 5] = masked;
    part_n[tid >> 5] = n_masked;
  }
  __syncthreads();
  if (tid == 0) {
    obs = part_obs[0];
    masked = part_masked[0];
    int nm = part_n[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      obs += part_obs[w];
      masked += part_masked[w];
      nm += part_n[w];
    }
    const float logs =
        static_cast<float>(n - nm) * log_obs + static_cast<float>(nm) * log_masked;
    out[k * out_k + b * out_b] = (-obs - masked / (1.f + big)) - logs;
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
laplace_bwd_kernel(Operand loc, Operand x, Operand mask, Operand g, T* __restrict__ dloc,
                   long long dloc_k, long long dloc_b, int n, float big) {
  const long long b = blockIdx.x, k = blockIdx.y;
  const T* lp = row_of<T>(loc, k, b);
  const float* xp = row_of<float>(x, k, b);
  const uint8_t* mp = row_of<uint8_t>(mask, k, b);
  T* dp = dloc + k * dloc_k + b * dloc_b;
  const int tid = threadIdx.x, groups = n / G;
  Chunk<T, G> c;
  c.load(lp, xp, mp, 0, groups, tid);
  // g and g / s only after the first chunk's loads: a division hoisted
  // above them would hold every load of the row until g arrives
  const float gv = *row_of<float>(g, k, b);
  const float gq = gv / (1.f + big);  // g / s at a masked point
  auto put = [&](int gi, bool valid, const float* d, const bool* m) {
    float v[G];
#pragma unroll
    for (int j = 0; j < G; ++j)
      v[j] = static_cast<float>((d[j] > 0.f) - (d[j] < 0.f)) * (m[j] ? gq : gv);
    if (valid) store(dp + static_cast<long long>(gi) * G, v, std::integral_constant<int, G>{});
  };
  c.each(0, groups, tid, put);
  for (int c0 = CHUNK / G; c0 < groups; c0 += CHUNK / G) {
    c.load(lp, xp, mp, c0, groups, tid);
    c.each(c0, groups, tid, put);
  }
}

// a block per row: (B, K) blocks, B < 2^31 and K < 2^16
int grid_of(long long K, long long B, dim3* grid) {
  if (K < 1 || B < 1 || K > 65535 || B > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  *grid = dim3(static_cast<unsigned>(B), static_cast<unsigned>(K));
  return 0;
}

template <typename T, int G>
int launch_fwd(Operand loc, Operand x, Operand mask, void* out, long long out_k, long long out_b,
               long long K, long long B, int n, float big, float log_obs, float log_masked,
               cudaStream_t stream) {
  dim3 grid;
  if (const int rc = grid_of(K, B, &grid)) return rc;
  laplace_fwd_kernel<T, G><<<grid, THREADS, 0, stream>>>(
      loc, x, mask, static_cast<float*>(out), out_k, out_b, n, big, log_obs, log_masked);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int launch_bwd(Operand loc, Operand x, Operand mask, Operand g, void* dloc, long long dloc_k,
               long long dloc_b, long long K, long long B, int n, float big,
               cudaStream_t stream) {
  dim3 grid;
  if (const int rc = grid_of(K, B, &grid)) return rc;
  laplace_bwd_kernel<T, G><<<grid, THREADS, 0, stream>>>(
      loc, x, mask, g, static_cast<T*>(dloc), dloc_k, dloc_b, n, big);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of loc (and dloc): 0 = float32, 1 = bfloat16. pairs = 1 only where
// N is even and every operand's base and strides keep each row on a pair
// boundary (the wrapper checks). Each operand is (pointer, stride over k,
// stride over b) in elements; K < 2^16. log_obs and log_masked are log(2)
// and log(2 (1 + big)) in fp32. Returns the cudaError_t of the launch (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int vaesne_laplace_fwd(const void* loc, long long loc_k, long long loc_b,
                                  const void* x, long long x_k, long long x_b, const void* mask,
                                  long long mask_k, long long mask_b, void* out, long long out_k,
                                  long long out_b, long long K, long long B, int n, int dtype,
                                  int pairs, float big, float log_obs, float log_masked,
                                  void* stream) {
  const Operand l{loc, loc_k, loc_b}, xo{x, x_k, x_b}, m{mask, mask_k, mask_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || (pairs && n % 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return (pairs ? launch_fwd<float, 2> : launch_fwd<float, 1>)(
        l, xo, m, out, out_k, out_b, K, B, n, big, log_obs, log_masked, s);
  if (dtype == 1)
    return (pairs ? launch_fwd<__nv_bfloat16, 2> : launch_fwd<__nv_bfloat16, 1>)(
        l, xo, m, out, out_k, out_b, K, B, n, big, log_obs, log_masked, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int vaesne_laplace_bwd(const void* loc, long long loc_k, long long loc_b,
                                  const void* x, long long x_k, long long x_b, const void* mask,
                                  long long mask_k, long long mask_b, const void* g, long long g_k,
                                  long long g_b, void* dloc, long long dloc_k, long long dloc_b,
                                  long long K, long long B, int n, int dtype, int pairs,
                                  float big, void* stream) {
  const Operand l{loc, loc_k, loc_b}, xo{x, x_k, x_b}, m{mask, mask_k, mask_b}, go{g, g_k, g_b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || (pairs && n % 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return (pairs ? launch_bwd<float, 2> : launch_bwd<float, 1>)(
        l, xo, m, go, dloc, dloc_k, dloc_b, K, B, n, big, s);
  if (dtype == 1)
    return (pairs ? launch_bwd<__nv_bfloat16, 2> : launch_bwd<__nv_bfloat16, 1>)(
        l, xo, m, go, dloc, dloc_k, dloc_b, K, B, n, big, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
