// LayerNorm over the last axis of a [M, N] fp32 matrix, forward and
// backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package normalises with flax's
// nn.LayerNorm, which XLA fuses. It replaces torch's own kernels on the
// port's path (vectorized_layer_norm_kernel, layer_norm_grad_input_kernel,
// GammaBetaBackwardCUDAKernel), which give every row a block of threads: at
// N = 32 eight threads hold the row and the rest of the block waits, and
// each row pays for a block's scheduling and its barriers, so those kernels
// ran at ~5% of the card's memory bandwidth on the towers' [rows, 32]
// activations.
//
//   forward:  mean = sum(x) / N, var = sum((x - mean)^2) / N,
//             y = (x - mean) / sqrt(var + eps) * gamma + beta,
//             and mean, rstd = 1 / sqrt(var + eps) per row, for the backward
//   backward: xh = (x - mean) * rstd, g = dy * gamma,
//             dx = rstd / N * (N g - sum(g) - xh sum(g xh)),
//             dgamma = sum over rows of dy xh, dbeta = sum over rows of dy
//
// What bounds it: bytes. A forward reads x and writes y and the two row
// statistics, 2 M N 4 + 8 M bytes; a backward reads x, dy and the
// statistics and writes dx, 3 M N 4 + 8 M bytes (gamma, beta and the
// per-block partials are a few hundred kilobytes). At the decoder's
// [502,784, 32] a forward is 133 MB, 40 us at 3.35 TB/s; there is nothing
// to compute worth the name. The design moves those bytes and nothing else:
//   * rows packed into warps: a row is N / 4 lanes, each holding one float4
//     (8 lanes at N = 32, so a warp holds 4 rows and a block of 256 threads
//     32; 16 lanes at N = 64, the widths instantiated); every load and
//     store of x, y, dy and dx is 16 bytes, a warp's rows one contiguous
//     stretch;
//   * each row's sums are 3 or 4 steps of __shfl_xor_sync inside its lane
//     group; no shared memory and no barrier on a row's path. A butterfly
//     gives every lane of the group the same bits;
//   * a grid the size of the card's resident blocks (or of the rows, if
//     fewer: `grid` decides it, for the launches here and for the caller
//     that sizes the backward's partials) walks the rows in tiles, UNROLL
//     tiles at a time, with the loads of all of them issued before any
//     arithmetic (a tile past the
//     last row reads the last row again and stores nothing), so that each
//     thread keeps UNROLL 16-byte loads in flight;
//   * the forward's arithmetic is the plain formula's, rounded where it
//     rounds: two exact passes over the registers, IEEE division and square
//     root, and no multiply-add contraction (__fmul_rn, __fadd_rn);
//   * the backward's gamma and beta gradients are summed in registers over
//     the rows each thread visits, then over the warp's row groups by
//     shuffles and over the block's warps through shared memory, into one
//     [2, N] partial per block; a second kernel adds the partials of all
//     blocks in a fixed order. No atomics: the grid, and so every sum's
//     order, depends only on the shape and the card, and two runs give
//     equal bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int THREADS = 256;  // a block: eight warps
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 2;     // tiles of rows a thread loads before arithmetic

template <int N>
struct Rows {
  static_assert(N == 32 || N == 64, "a row is 8 or 16 lanes of a float4");
  static constexpr int LANES = N / 4;          // lanes of a row
  static constexpr int TILE = THREADS / LANES;  // rows a block covers at once
  static constexpr long long SPAN = static_cast<long long>(TILE) * UNROLL;
};

// the sum of v over the lane group of LANES lanes (aligned), in every lane
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float sum4(float4 v) {
  return __fadd_rn(__fadd_rn(v.x, v.y), __fadd_rn(v.z, v.w));
}

__device__ __forceinline__ float normed(float d, float sd, float w, float b) {
  return __fadd_rn(__fmul_rn(__fdiv_rn(d, sd), w), b);
}

template <int N>
__global__ void __launch_bounds__(THREADS)
vaesne_layer_norm_fwd_kernel(const float4* __restrict__ x, const float4* __restrict__ gamma,
                             const float4* __restrict__ beta, float4* __restrict__ y,
                             float* __restrict__ mean, float* __restrict__ rstd, long long M,
                             float eps) {
  using R = Rows<N>;
  const int lane = threadIdx.x % R::LANES, slot = threadIdx.x / R::LANES;
  const float4 w = gamma[lane], b = beta[lane];
  for (long long t0 = blockIdx.x * R::SPAN; t0 < M; t0 += gridDim.x * R::SPAN) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long row = min(t0 + u * R::TILE + slot, M - 1);
      v[u] = x[row * R::LANES + lane];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long row = t0 + u * R::TILE + slot;
      const float mu = __fdiv_rn(group_sum<R::LANES>(sum4(v[u])), static_cast<float>(N));
      const float4 d = make_float4(__fsub_rn(v[u].x, mu), __fsub_rn(v[u].y, mu),
                                   __fsub_rn(v[u].z, mu), __fsub_rn(v[u].w, mu));
      const float4 sq = make_float4(__fmul_rn(d.x, d.x), __fmul_rn(d.y, d.y),
                                    __fmul_rn(d.z, d.z), __fmul_rn(d.w, d.w));
      const float var = __fdiv_rn(group_sum<R::LANES>(sum4(sq)), static_cast<float>(N));
      const float sd = __fsqrt_rn(__fadd_rn(var, eps));
      if (row < M) {
        y[row * R::LANES + lane] = make_float4(normed(d.x, sd, w.x, b.x), normed(d.y, sd, w.y, b.y),
                                               normed(d.z, sd, w.z, b.z), normed(d.w, sd, w.w, b.w));
        if (lane == 0) {
          mean[row] = mu;
          rstd[row] = __frcp_rn(sd);
        }
      }
    }
  }
}

__device__ __forceinline__ void add4(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int off) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, off), __shfl_xor_sync(0xffffffffu, v.y, off),
                     __shfl_xor_sync(0xffffffffu, v.z, off), __shfl_xor_sync(0xffffffffu, v.w, off));
}

template <int N>
__global__ void __launch_bounds__(THREADS)
vaesne_layer_norm_bwd_kernel(const float4* __restrict__ x, const float4* __restrict__ dy,
                             const float* __restrict__ mean, const float* __restrict__ rstd,
                             const float4* __restrict__ gamma, float4* __restrict__ dx,
                             float* __restrict__ partial, long long M) {
  using R = Rows<N>;
  const int lane = threadIdx.x % R::LANES, slot = threadIdx.x / R::LANES;
  const float4 w = gamma[lane];
  float4 dg = make_float4(0.f, 0.f, 0.f, 0.f), db = dg;  // this thread's columns
  for (long long t0 = blockIdx.x * R::SPAN; t0 < M; t0 += gridDim.x * R::SPAN) {
    float4 xv[UNROLL], gv[UNROLL];
    float mu[UNROLL], rs[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long row = min(t0 + u * R::TILE + slot, M - 1);
      xv[u] = x[row * R::LANES + lane];
      gv[u] = dy[row * R::LANES + lane];
      mu[u] = mean[row];
      rs[u] = rstd[row];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long row = t0 + u * R::TILE + slot;
      const float4 xh = make_float4((xv[u].x - mu[u]) * rs[u], (xv[u].y - mu[u]) * rs[u],
                                    (xv[u].z - mu[u]) * rs[u], (xv[u].w - mu[u]) * rs[u]);
      const float4 g = make_float4(gv[u].x * w.x, gv[u].y * w.y, gv[u].z * w.z, gv[u].w * w.w);
      const float sg = group_sum<R::LANES>(sum4(g));
      const float sgx = group_sum<R::LANES>(
          sum4(make_float4(g.x * xh.x, g.y * xh.y, g.z * xh.z, g.w * xh.w)));
      const float scale = rs[u] / static_cast<float>(N);
      const float n = static_cast<float>(N);
      if (row < M) {
        dx[row * R::LANES + lane] = make_float4(scale * (n * g.x - sg - xh.x * sgx),
                                                scale * (n * g.y - sg - xh.y * sgx),
                                                scale * (n * g.z - sg - xh.z * sgx),
                                                scale * (n * g.w - sg - xh.w * sgx));
        add4(dg, make_float4(gv[u].x * xh.x, gv[u].y * xh.y, gv[u].z * xh.z, gv[u].w * xh.w));
        add4(db, gv[u]);
      }
    }
  }
  // the warp's row groups, then the block's warps, each in a fixed order
#pragma unroll
  for (int off = R::LANES; off < 32; off <<= 1) {
    add4(dg, shfl_xor4(dg, off));
    add4(db, shfl_xor4(db, off));
  }
  __shared__ float part[WARPS][2 * N];
  if ((threadIdx.x & 31) < R::LANES) {
    float* p = part[threadIdx.x >> 5];
    p[4 * lane] = dg.x;
    p[4 * lane + 1] = dg.y;
    p[4 * lane + 2] = dg.z;
    p[4 * lane + 3] = dg.w;
    p[N + 4 * lane] = db.x;
    p[N + 4 * lane + 1] = db.y;
    p[N + 4 * lane + 2] = db.z;
    p[N + 4 * lane + 3] = db.w;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * N; c += THREADS) {
    float s = part[0][c];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) s += part[k][c];
    partial[blockIdx.x * (2LL * N) + c] = s;
  }
}

// dgamma and dbeta from the [blocks, 2 N] partials: a block of 32 columns
// by PARTS strided runs of partials, each run summed in row order, the runs
// then added in order
constexpr int PARTS = 32;

__global__ void __launch_bounds__(32 * PARTS)
vaesne_layer_norm_gamma_beta_kernel(const float* __restrict__ partial, int blocks, int n,
                                    float* __restrict__ dgamma, float* __restrict__ dbeta) {
  const int col = blockIdx.x * 32 + threadIdx.x, part = threadIdx.y, cols = 2 * n;
  float s = 0.f;
  if (col < cols) {
#pragma unroll 8
    for (int r = part; r < blocks; r += PARTS) s += partial[static_cast<long long>(r) * cols + col];
  }
  __shared__ float runs[PARTS][33];
  runs[part][threadIdx.x] = s;
  __syncthreads();
  if (part == 0 && col < cols) {
    float t = runs[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < PARTS; ++k) t += runs[k][threadIdx.x];
    if (col < n)
      dgamma[col] = t;
    else
      dbeta[col - n] = t;
  }
}

// The blocks of one resident wave of the forward (kind 0) or the backward
// (kind 1) at width N on `device`, looked up once a process
template <int N>
cudaError_t resident(int device, int kind, int* blocks) {
  constexpr int DEVICES = 64;
  static std::atomic<int> known[DEVICES][2];  // 0 until looked up
  if (device < 0 || device >= DEVICES || kind < 0 || kind > 1) return cudaErrorInvalidValue;
  if ((*blocks = known[device][kind].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = kind == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, vaesne_layer_norm_fwd_kernel<N>, THREADS, 0)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, vaesne_layer_norm_bwd_kernel<N>, THREADS, 0);
  if (e != cudaSuccess) return e;
  *blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  known[device][kind].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// The grid of a launch over M rows: a block walks UNROLL tiles of TILE rows
// at a time, and no more blocks than one resident wave
template <int N>
cudaError_t grid(int device, int kind, long long M, int* blocks) {
  const cudaError_t e = resident<N>(device, kind, blocks);
  const long long need = (M + Rows<N>::SPAN - 1) / Rows<N>::SPAN;
  if (need < *blocks) *blocks = static_cast<int>(need);
  return e;
}

// `device` current for the scope (the stream a launch takes lives there),
// the caller's device restored after
struct OnDevice {
  int previous = -1;
  cudaError_t error = cudaSuccess;
  explicit OnDevice(int device) {
    int current = 0;
    error = cudaGetDevice(&current);
    if (error == cudaSuccess && current != device) {
      error = cudaSetDevice(device);
      previous = current;
    }
  }
  ~OnDevice() {
    if (previous >= 0) cudaSetDevice(previous);
  }
};

template <int N>
int launch_fwd(const void* x, const void* gamma, const void* beta, void* y, void* mean, void* rstd,
               long long M, float eps, int device, cudaStream_t stream) {
  OnDevice on(device);
  int blocks = 0;
  cudaError_t e = on.error;
  if (e == cudaSuccess) e = grid<N>(device, 0, M, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  vaesne_layer_norm_fwd_kernel<N><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(gamma),
      static_cast<const float4*>(beta), static_cast<float4*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), M, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_bwd(const void* x, const void* dy, const void* mean, const void* rstd,
               const void* gamma, void* dx, void* partial, void* dgamma, void* dbeta,
               long long M, int blocks, int device, cudaStream_t stream) {
  OnDevice on(device);
  cudaError_t e = on.error;
  if (e != cudaSuccess) return static_cast<int>(e);
  vaesne_layer_norm_bwd_kernel<N><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(dy),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const float4*>(gamma), static_cast<float4*>(dx), static_cast<float*>(partial),
      M);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  vaesne_layer_norm_gamma_beta_kernel<<<(2 * N + 31) / 32, dim3(32, PARTS), 0, stream>>>(
      static_cast<const float*>(partial), blocks, N, static_cast<float*>(dgamma),
      static_cast<float*>(dbeta));
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for width n: f<32> or f<64>, or cudaErrorInvalidValue
// for any other width
template <typename F>
int by_width(int n, F f) {
  switch (n) {
    case 32: return static_cast<int>(f(std::integral_constant<int, 32>{}));
    case 64: return static_cast<int>(f(std::integral_constant<int, 64>{}));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The grid of the forward (kind 0) or the backward (kind 1) over M >= 1
// rows of width n on `device`: the row count of the backward's [blocks,
// 2 n] partials. Returns a cudaError_t.
extern "C" int vaesne_layer_norm_blocks(int n, int kind, long long M, int device, int* blocks) {
  if (M < 1) return static_cast<int>(cudaErrorInvalidValue);
  OnDevice on(device);  // the occupancy query asks the current device
  if (on.error != cudaSuccess) return static_cast<int>(on.error);
  return by_width(n, [&](auto w) { return grid<decltype(w)::value>(device, kind, M, blocks); });
}

// x, gamma, beta and y 16-byte aligned and contiguous ([M, n], [n]); mean
// and rstd [M]; M >= 1 rows, on `device`. Returns the cudaError_t of the
// launch; the launch is asynchronous on `stream`.
extern "C" int vaesne_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                     void* mean, void* rstd, long long M, int n, float eps,
                                     int device, void* stream) {
  if (M < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(n, [&](auto w) {
    return launch_fwd<decltype(w)::value>(x, gamma, beta, y, mean, rstd, M, eps, device, s);
  });
}

// x, dy, gamma and dx as the forward's operands; mean and rstd the
// forward's; partial [blocks, 2 n] scratch, blocks as vaesne_layer_norm_blocks
// gives them for kind 1; dgamma and dbeta [n]. Two launches on `stream`:
// the row pass, then the gamma and beta stage.
extern "C" int vaesne_layer_norm_bwd(const void* x, const void* dy, const void* mean,
                                     const void* rstd, const void* gamma, void* dx, void* partial,
                                     void* dgamma, void* dbeta, long long M, int n, int blocks,
                                     int device, void* stream) {
  if (M < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(n, [&](auto w) {
    return launch_bwd<decltype(w)::value>(x, dy, mean, rstd, gamma, dx, partial, dgamma, dbeta, M,
                                          blocks, device, s);
  });
}
