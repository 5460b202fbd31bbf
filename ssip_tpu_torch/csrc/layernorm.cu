// Row LayerNorm for Hopper, forward and backward: x [N, D] in bfloat16 or
// float32, scale and bias float32 [D], float32 moments,
//   y = (x - mean) * rsqrt(var + eps) * scale + bias        (in x's type).
//
// Replaces ssip_tpu/ops/layernorm.py:_ln_fwd_kernel and :_ln_bwd_kernel (the
// Pallas kernels behind layer_norm and its custom VJP). The TPU kernels take
// 256-row blocks of VMEM and carry the dscale/dbias partials in one buffer
// that all grid steps share, which works because a TPU grid runs in order.
// On Hopper blocks run in any order, so here:
//
// - forward: one warp per row. Each lane loads its 16-byte vectors of the
//   row once and keeps them in registers; the mean is a warp-shuffle sum,
//   the variance is the mean of the squared DEVIATIONS (not E[x^2] - E[x]^2,
//   which cancels), and the row is written once. The last three operations
//   are separate roundings (no FMA contraction), as the plain version's.
// - backward: statistics are recomputed from x (nothing but x and scale is
//   saved). Each block walks its rows (grid-stride, one warp per row), keeps
//   per-column partial sums of dy*xhat and dy in registers, adds its warps'
//   partials in a fixed order through shared memory and writes its own row
//   of a [blocks, D] float32 scratch; the wrapper sums the scratch over
//   axis 0. No atomics: the result is the same from run to run.
//       g = dy*scale;  dx = r*(g - mean(g) - xhat*mean(g*xhat))
//
// Bound: bytes. The forward moves 2 row-reads' worth (x in, y out), the
// backward 3 (x, dy in, dx out) against about 8 and 20 operations a value;
// one read and one write of each row is all the design can do about it.
//
// Shapes: D a multiple of the 16-byte vector (8 bfloat16, 4 float32) and at
// most 1024 (32 values a lane); rows 16-byte aligned. The wrapper raises on
// anything else.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of T, as floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = t;
  }
};

// N consecutive float32 parameters (N is 4 or 8).
template <int N>
__device__ __forceinline__ void load_param(const float* __restrict__ p,
                                           float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = t.x;
    v[4 * i + 1] = t.y;
    v[4 * i + 2] = t.z;
    v[4 * i + 3] = t.w;
  }
}

// Loads the lane's vectors of one row into v, centres them on the row mean
// and returns r = rsqrt(var + eps). Vectors past the row's end stay 0.
template <typename T, int ITERS>
__device__ __forceinline__ float centre_row(const T* __restrict__ xr,
                                            int nvec, int d, float eps,
                                            int lane,
                                            float (&v)[ITERS][Vec<T>::kN]) {
  constexpr int N = Vec<T>::kN;
  float sum = 0.0f;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int c = lane + 32 * it;
    if (c < nvec) {
      Vec<T>::load(xr + c * N, v[it]);
#pragma unroll
      for (int k = 0; k < N; ++k) sum += v[it][k];
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) v[it][k] = 0.0f;
    }
  }
  const float inv_d = 1.0f / static_cast<float>(d);
  const float mean = warp_sum(sum) * inv_d;
  float sq = 0.0f;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    if (lane + 32 * it < nvec) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        v[it][k] -= mean;
        sq += v[it][k] * v[it][k];
      }
    }
  }
  return rsqrtf(warp_sum(sq) * inv_d + eps);
}

template <typename T, int ITERS>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int n,
                  int d, float eps) {
  constexpr int N = Vec<T>::kN;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves together
  const int nvec = d / N;
  float v[ITERS][N];
  const float r = centre_row<T, ITERS>(x + static_cast<size_t>(row) * d, nvec,
                                       d, eps, lane, v);
  T* yr = y + static_cast<size_t>(row) * d;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int c = lane + 32 * it;
    if (c < nvec) {
      float s[N], b[N], out[N];
      load_param<N>(scale + c * N, s);
      load_param<N>(bias + c * N, b);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        out[k] = __fadd_rn(__fmul_rn(__fmul_rn(v[it][k], r), s[k]), b[k]);
      }
      Vec<T>::store(yr + c * N, out);
    }
  }
}

template <typename T, int ITERS>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ ds_part, float* __restrict__ db_part,
                  int n, int d, float eps) {
  constexpr int N = Vec<T>::kN;
  constexpr int kCap = 32 * N * ITERS;
  __shared__ float s_ds[kCap];
  __shared__ float s_db[kCap];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = d / N;
  const float inv_d = 1.0f / static_cast<float>(d);

  float part_s[ITERS][N], part_b[ITERS][N];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      part_s[it][k] = 0.0f;
      part_b[it][k] = 0.0f;
    }
  }

  for (int row = blockIdx.x * kWarps + warp; row < n;
       row += gridDim.x * kWarps) {
    float xh[ITERS][N], g[ITERS][N];
    const size_t off = static_cast<size_t>(row) * d;
    const float r = centre_row<T, ITERS>(x + off, nvec, d, eps, lane, xh);
    float sum_g = 0.0f, sum_gx = 0.0f;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int c = lane + 32 * it;
      if (c < nvec) {
        float s[N];
        load_param<N>(scale + c * N, s);
        Vec<T>::load(dy + off + c * N, g[it]);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          xh[it][k] *= r;  // xhat
          part_b[it][k] += g[it][k];
          part_s[it][k] += g[it][k] * xh[it][k];
          g[it][k] *= s[k];
          sum_g += g[it][k];
          sum_gx += g[it][k] * xh[it][k];
        }
      }
    }
    const float mg = warp_sum(sum_g) * inv_d;
    const float mgx = warp_sum(sum_gx) * inv_d;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int c = lane + 32 * it;
      if (c < nvec) {
        float out[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          out[k] = r * (g[it][k] - mg - xh[it][k] * mgx);
        }
        Vec<T>::store(dx + off + c * N, out);
      }
    }
  }

  // The block's warps add their partials in warp order: a fixed order, so
  // the sums do not change from run to run.
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int c = lane + 32 * it;
        if (c < nvec) {
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const int col = c * N + k;
            s_ds[col] = (w == 0 ? 0.0f : s_ds[col]) + part_s[it][k];
            s_db[col] = (w == 0 ? 0.0f : s_db[col]) + part_b[it][k];
          }
        }
      }
    }
    __syncthreads();
  }
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  for (int col = threadIdx.x; col < d; col += kThreads) {
    ds_part[base + col] = s_ds[col];
    db_part[base + col] = s_db[col];
  }
}

template <typename T>
int launch_fwd(const void* x, const float* scale, const float* bias, void* y,
               int n, int d, float eps, cudaStream_t s) {
  const int per_lane = (d + 31) / 32;  // values a lane holds
  const unsigned int blocks = (n + kWarps - 1) / kWarps;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  constexpr int N = Vec<T>::kN;
#define SSIP_LN_FWD(ITERS)                                              \
  ln_fwd_kernel<T, ITERS><<<blocks, kThreads, 0, s>>>(xp, scale, bias, yp, \
                                                      n, d, eps)
  if (per_lane <= N) {
    SSIP_LN_FWD(1);
  } else if (per_lane <= 2 * N) {
    SSIP_LN_FWD(2);
  } else if (per_lane <= 4 * N) {
    SSIP_LN_FWD(4);
  } else if (per_lane <= 32) {
    SSIP_LN_FWD(32 / N);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSIP_LN_FWD
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const float* scale, const void* dy, void* dx,
               float* ds_part, float* db_part, int n, int d, int blocks,
               float eps, cudaStream_t s) {
  const int per_lane = (d + 31) / 32;
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  constexpr int N = Vec<T>::kN;
#define SSIP_LN_BWD(ITERS)                                   \
  ln_bwd_kernel<T, ITERS><<<blocks, kThreads, 0, s>>>(       \
      xp, scale, dyp, dxp, ds_part, db_part, n, d, eps)
  if (per_lane <= N) {
    SSIP_LN_BWD(1);
  } else if (per_lane <= 2 * N) {
    SSIP_LN_BWD(2);
  } else if (per_lane <= 4 * N) {
    SSIP_LN_BWD(4);
  } else if (per_lane <= 32) {
    SSIP_LN_BWD(32 / N);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSIP_LN_BWD
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. They launch on `stream`
// (PyTorch's current stream) on the caller's current device, do not
// synchronise, allocate nothing, and return cudaGetLastError() after the
// launch (0 on success).

// y [n, d] = LayerNorm(x [n, d]); x and y bfloat16 (is_bf16) or float32.
extern "C" int ssip_layer_norm_fwd(const void* x, const void* scale,
                                   const void* bias, void* y, int is_bf16,
                                   int n, int d, float eps, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (is_bf16) return launch_fwd<__nv_bfloat16>(x, sc, bi, y, n, d, eps, s);
  return launch_fwd<float>(x, sc, bi, y, n, d, eps, s);
}

// dx [n, d] and the per-block partial sums ds_part, db_part [blocks, d]
// (float32), whose sums over axis 0 are dscale and dbias.
extern "C" int ssip_layer_norm_bwd(const void* x, const void* scale,
                                   const void* dy, void* dx, void* ds_part,
                                   void* db_part, int is_bf16, int n, int d,
                                   int blocks, float eps, void* stream) {
  if (n == 0 || blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* dsp = static_cast<float*>(ds_part);
  float* dbp = static_cast<float*>(db_part);
  if (is_bf16) {
    return launch_bwd<__nv_bfloat16>(x, sc, dy, dx, dsp, dbp, n, d, blocks,
                                     eps, s);
  }
  return launch_bwd<float>(x, sc, dy, dx, dsp, dbp, n, d, blocks, eps, s);
}
