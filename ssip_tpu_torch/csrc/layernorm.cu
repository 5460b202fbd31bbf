// Row LayerNorm for Hopper, forward and backward: x [N, D] in bfloat16 or
// float32, scale and bias float32 [D], float32 moments,
//   y = (x - mean) * rsqrt(var + eps) * scale + bias        (in x's type).
//
// Replaces ssip_tpu/ops/layernorm.py:_ln_fwd_kernel and :_ln_bwd_kernel (the
// Pallas kernels behind layer_norm and its custom VJP). The TPU kernels take
// 256-row blocks of VMEM and carry the dscale/dbias partials in one buffer
// that all grid steps share, which works because a TPU grid runs in order.
//
// Bound: bytes. The forward moves 2 row passes (x in, y out), the backward 3
// (x and dy in, dx out) against about 8 and 20 operations a value, far
// below the card's ridge. So the design keeps enough bytes in flight on
// every SM and reads each byte once:
//
// - persistent blocks: one wave of blocks (as many as fit on every SM; the
//   wrapper sizes the grid), each warp walking a contiguous, balanced range
//   of rows, so the grid no longer grows with N;
// - the next rows in flight: each warp streams its rows through a ring of
//   slots in shared memory with 16-byte cp.async (a backward slot holds the
//   row's x and dy together): while it reduces one row the next 1 (forward)
//   or 3 (backward) are on their way, depths no slower than any of 1 to 4
//   (PERF.md, the LayerNorm findings). Each lane copies exactly the 16-byte
//   vectors it later reads, so a lane waits on its own copies
//   (cp.async.wait_group) and no barrier is needed;
// - parameters read once: a lane's columns are the same on every row, so
//   its scale and bias values are loaded into registers once a warp;
// - exact widths: the widths of the port's ViTs (192, 384, 768, 1024) are
//   templates in which a lane holds exactly kPerLane vectors, with no
//   bounds checks; a row goes to the largest power-of-two number of lanes
//   that divides its vector count (at 192 in bf16, 24 vectors: 8 lanes of 3,
//   4 rows a warp). Every other width the wrapper takes (a multiple of the
//   16-byte vector, at most 1024) runs a generic template, one row a warp,
//   with the vectors past the row's end masked.
//
// The statistics are recomputed from x in the backward (nothing but x and
// scale is saved). The mean and the variance are reductions over a row's
// lanes by xor shuffles; the variance is the mean of the squared DEVIATIONS
// (not E[x^2] - E[x]^2, which cancels). The forward's last three operations
// are separate roundings (no FMA contraction), as the plain version's.
//
// Backward, with g = dy*scale:  dx = r*(g - mean(g) - xhat*mean(g*xhat)).
// Per-column sums of dy*xhat and dy stay in registers across a warp's rows;
// a warp's row groups are added by xor shuffles, the block's warps in warp
// order through shared memory, and each block writes its row of a
// [2, blocks, D] float32 scratch; ln_colsum_kernel then adds the blocks'
// rows in block order. No atomics anywhere: the result is the same from run
// to run.
//
// Shapes: D a multiple of the 16-byte vector (8 bfloat16, 4 float32) and at
// most 1024; rows 16-byte aligned. The wrapper raises on anything else.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

using namespace ssip_mma;  // cp.async, the shared-memory opt-in, kernel_info

constexpr int kWarps = 4;  // a block; the wrapper's _WARPS
constexpr int kThreads = 32 * kWarps;
// ring slots a warp, the row reduced and those in flight: forward, backward
constexpr int kFwdStages = 2;
constexpr int kBwdStages = 4;
constexpr int kMaxWidth = 1024;
constexpr size_t kSmemDefault = 48 * 1024;  // dynamic shared memory a launch takes without the opt-in
// ln_colsum_kernel: a block is kSumCols columns by kSumSlices slices of the
// blocks' rows
constexpr int kSumCols = 32;
constexpr int kSumSlices = 8;

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

// The largest power of two, at most 32, that divides v.
__host__ __device__ constexpr int lanes_for(int v) {
  int lanes = 32;
  while (v % lanes != 0) lanes /= 2;
  return lanes;
}

// How a warp covers rows of width D (D == 0: the generic template, any
// width up to kMaxWidth, one row a warp, vectors past the row's end masked).
template <typename T, int D>
struct Layout {
  static constexpr int kN = Vec<T>::kN;  // values a vector
  static constexpr bool kExact = D != 0;
  static constexpr int kLanes = kExact ? lanes_for(D / kN) : 32;  // a row
  static constexpr int kPerLane = kExact ? D / kN / kLanes : kMaxWidth / kN / 32;
  static constexpr int kRows = 32 / kLanes;  // rows a warp takes a step
  static_assert(!kExact || D % kN == 0, "width not a multiple of the vector");
  static_assert(!kExact || D <= kMaxWidth, "width past the register budget");
};

// The ring's depth of the kernel that streams `tensors` tensors (1 the
// forward: x; 2 the backward: x and dy).
__host__ __device__ constexpr int stages(int tensors) {
  return tensors == 1 ? kFwdStages : kBwdStages;
}

// A ring slot: one step's rows of x (and, in the backward, of dy after them).
template <typename T, int D>
__host__ __device__ constexpr size_t slot_elems(int d, int tensors) {
  return static_cast<size_t>(tensors) * Layout<T, D>::kRows * d;
}

template <typename T, int D>
constexpr size_t smem_bytes(int d, int tensors) {
  const size_t ring = kWarps * stages(tensors) * slot_elems<T, D>(d, tensors) * sizeof(T);
  const size_t partials = 2 * static_cast<size_t>(d) * sizeof(float);  // backward's block sums
  return tensors == 2 && partials > ring ? partials : ring;
}

// The sum of v over the LANES lanes of a row (xor shuffles inside the group).
template <int LANES>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// The lane's parameter values: vector c = lane_in_row + kLanes * it of a row.
template <typename T, int D>
__device__ __forceinline__ void load_params(
    const float* __restrict__ p, int nvec, int lane_in_row,
    float (&v)[Layout<T, D>::kPerLane][Vec<T>::kN]) {
  using L = Layout<T, D>;
#pragma unroll
  for (int it = 0; it < L::kPerLane; ++it) {
    const int c = lane_in_row + L::kLanes * it;
    if (L::kExact || c < nvec) {
      load_param<L::kN>(p + c * L::kN, v[it]);
    } else {
#pragma unroll
      for (int k = 0; k < L::kN; ++k) v[it][k] = 0.0f;
    }
  }
}

// The warp's rows: a contiguous share of the n rows, balanced to a row,
// taken rows_a_step (the warp's row groups) at a time.
struct RowWalk {
  int first, last, rows_a_step, steps;
  __device__ RowWalk(int n, int rows_a_step_) : rows_a_step(rows_a_step_) {
    const long long warps = static_cast<long long>(gridDim.x) * kWarps;
    const long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    first = static_cast<int>(w * n / warps);
    last = static_cast<int>((w + 1) * n / warps);
    steps = (last - first + rows_a_step - 1) / rows_a_step;
  }
  // The row that row group `group` takes at `step`; live if one of the warp's.
  __device__ int row(int step, int group) const { return first + step * rows_a_step + group; }
  __device__ bool live(int row) const { return row < last; }
};

// Starts the copies of step `step`'s rows (of each of `tensors` tensors,
// src[t]) into their ring slot, the lane's own vectors only, and commits
// them as one cp.async group (empty past the last step, so that every
// iteration commits one group).
template <typename T, int D, int TENSORS>
__device__ __forceinline__ void issue_step(const T* const (&src)[TENSORS],
                                           T* ring, int step,
                                           const RowWalk& walk, int d,
                                           int nvec, int group,
                                           int lane_in_row) {
  using L = Layout<T, D>;
  if (step < walk.steps) {
    const int row = walk.row(step, group);
    if (walk.live(row)) {
      T* slot = ring + (step % stages(TENSORS)) * slot_elems<T, D>(d, TENSORS);
#pragma unroll
      for (int t = 0; t < TENSORS; ++t) {
        const T* g = src[t] + static_cast<size_t>(row) * d;
        T* s = slot + (t * L::kRows + group) * d;
#pragma unroll
        for (int it = 0; it < L::kPerLane; ++it) {
          const int c = lane_in_row + L::kLanes * it;
          if (L::kExact || c < nvec) cp_async16(s + c * L::kN, g + c * L::kN, true);
        }
      }
    }
  }
  cp_async_commit();
}

// Reads the lane's vectors of one row from its slot into v, centres them on
// the row mean and returns r = rsqrt(var + eps). Vectors past the row's end
// stay 0.
template <typename T, int D>
__device__ __forceinline__ float centre_row(
    const T* row, int nvec, float inv_d, float eps, int lane_in_row,
    float (&v)[Layout<T, D>::kPerLane][Vec<T>::kN]) {
  using L = Layout<T, D>;
  float sum = 0.0f;
#pragma unroll
  for (int it = 0; it < L::kPerLane; ++it) {
    const int c = lane_in_row + L::kLanes * it;
    if (L::kExact || c < nvec) {
      Vec<T>::load(row + c * L::kN, v[it]);
#pragma unroll
      for (int k = 0; k < L::kN; ++k) sum += v[it][k];
    } else {
#pragma unroll
      for (int k = 0; k < L::kN; ++k) v[it][k] = 0.0f;
    }
  }
  const float mean = row_sum<L::kLanes>(sum) * inv_d;
  float sq = 0.0f;
#pragma unroll
  for (int it = 0; it < L::kPerLane; ++it) {
    if (L::kExact || lane_in_row + L::kLanes * it < nvec) {
#pragma unroll
      for (int k = 0; k < L::kN; ++k) {
        v[it][k] -= mean;
        sq += v[it][k] * v[it][k];
      }
    }
  }
  return rsqrtf(row_sum<L::kLanes>(sq) * inv_d + eps);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int n,
                  int d_arg, float eps) {
  using L = Layout<T, D>;
  constexpr int N = L::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = L::kExact ? D : d_arg;
  const int nvec = d / N;
  const float inv_d = 1.0f / static_cast<float>(d);
  const int lane = threadIdx.x & 31;
  const int group = lane / L::kLanes, lane_in_row = lane % L::kLanes;
  T* ring = reinterpret_cast<T*>(smem) +
            (threadIdx.x >> 5) * kFwdStages * slot_elems<T, D>(d, 1);
  const RowWalk walk(n, L::kRows);
  const T* const src[1] = {x};

  for (int s = 0; s < kFwdStages - 1; ++s) {
    issue_step<T, D, 1>(src, ring, s, walk, d, nvec, group, lane_in_row);
  }
  float sc[L::kPerLane][N], bi[L::kPerLane][N];
  load_params<T, D>(scale, nvec, lane_in_row, sc);
  load_params<T, D>(bias, nvec, lane_in_row, bi);

  for (int step = 0; step < walk.steps; ++step) {
    // the slot refilled here was read in the previous step, whose results
    // are stored: its reads are done
    issue_step<T, D, 1>(src, ring, step + kFwdStages - 1, walk, d, nvec,
                        group, lane_in_row);
    cp_async_wait<kFwdStages - 1>();  // this step's copies have landed
    const int row = walk.row(step, group);
    const T* slot = ring + (step % kFwdStages) * slot_elems<T, D>(d, 1) + group * d;
    float v[L::kPerLane][N];
    const float r = centre_row<T, D>(slot, nvec, inv_d, eps, lane_in_row, v);
    if (walk.live(row)) {
      T* yr = y + static_cast<size_t>(row) * d;
#pragma unroll
      for (int it = 0; it < L::kPerLane; ++it) {
        const int c = lane_in_row + L::kLanes * it;
        if (L::kExact || c < nvec) {
          float out[N];
#pragma unroll
          for (int k = 0; k < N; ++k) {
            out[k] = __fadd_rn(__fmul_rn(__fmul_rn(v[it][k], r), sc[it][k]), bi[it][k]);
          }
          Vec<T>::store(yr + c * N, out);
        }
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ partials, int n, int d_arg, float eps) {
  using L = Layout<T, D>;
  constexpr int N = L::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = L::kExact ? D : d_arg;
  const int nvec = d / N;
  const float inv_d = 1.0f / static_cast<float>(d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane / L::kLanes, lane_in_row = lane % L::kLanes;
  T* ring = reinterpret_cast<T*>(smem) + warp * kBwdStages * slot_elems<T, D>(d, 2);
  const RowWalk walk(n, L::kRows);
  const T* const src[2] = {x, dy};

  for (int s = 0; s < kBwdStages - 1; ++s) {
    issue_step<T, D, 2>(src, ring, s, walk, d, nvec, group, lane_in_row);
  }
  float sc[L::kPerLane][N], part_s[L::kPerLane][N], part_b[L::kPerLane][N];
  load_params<T, D>(scale, nvec, lane_in_row, sc);
#pragma unroll
  for (int it = 0; it < L::kPerLane; ++it) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      part_s[it][k] = 0.0f;
      part_b[it][k] = 0.0f;
    }
  }

  for (int step = 0; step < walk.steps; ++step) {
    issue_step<T, D, 2>(src, ring, step + kBwdStages - 1, walk, d, nvec,
                        group, lane_in_row);
    cp_async_wait<kBwdStages - 1>();
    const int row = walk.row(step, group);
    const bool live = walk.live(row);
    const T* slot = ring + (step % kBwdStages) * slot_elems<T, D>(d, 2);
    float xh[L::kPerLane][N], g[L::kPerLane][N];
    const float r = centre_row<T, D>(slot + group * d, nvec, inv_d, eps,
                                     lane_in_row, xh);
    const T* dyr = slot + (L::kRows + group) * d;
    float sum_g = 0.0f, sum_gx = 0.0f;
#pragma unroll
    for (int it = 0; it < L::kPerLane; ++it) {
      const int c = lane_in_row + L::kLanes * it;
      if (L::kExact || c < nvec) {
        Vec<T>::load(dyr + c * N, g[it]);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          xh[it][k] *= r;  // xhat
          if (live) {
            part_b[it][k] += g[it][k];
            part_s[it][k] += g[it][k] * xh[it][k];
          }
          g[it][k] *= sc[it][k];
          sum_g += g[it][k];
          sum_gx += g[it][k] * xh[it][k];
        }
      }
    }
    const float mg = row_sum<L::kLanes>(sum_g) * inv_d;
    const float mgx = row_sum<L::kLanes>(sum_gx) * inv_d;
    if (live) {
      T* dxr = dx + static_cast<size_t>(row) * d;
#pragma unroll
      for (int it = 0; it < L::kPerLane; ++it) {
        const int c = lane_in_row + L::kLanes * it;
        if (L::kExact || c < nvec) {
          float out[N];
#pragma unroll
          for (int k = 0; k < N; ++k) {
            out[k] = r * (g[it][k] - mg - xh[it][k] * mgx);
          }
          Vec<T>::store(dxr + c * N, out);
        }
      }
    }
  }

  // The warp's row groups, then the block's warps in warp order: a fixed
  // order, so the sums do not change from run to run.
#pragma unroll
  for (int o = L::kLanes; o < 32; o <<= 1) {
#pragma unroll
    for (int it = 0; it < L::kPerLane; ++it) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        part_s[it][k] += __shfl_xor_sync(0xffffffffu, part_s[it][k], o);
        part_b[it][k] += __shfl_xor_sync(0xffffffffu, part_b[it][k], o);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: the block's sums reuse it
  float* s_ds = reinterpret_cast<float*>(smem);
  float* s_db = s_ds + d;
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && group == 0) {
#pragma unroll
      for (int it = 0; it < L::kPerLane; ++it) {
        const int c = lane_in_row + L::kLanes * it;
        if (L::kExact || c < nvec) {
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
  float* ds_part = partials + static_cast<size_t>(blockIdx.x) * d;
  float* db_part = partials + static_cast<size_t>(gridDim.x + blockIdx.x) * d;
  for (int col = threadIdx.x; col < d; col += kThreads) {
    ds_part[col] = s_ds[col];
    db_part[col] = s_db[col];
  }
}

// sums [2, d] = partials [2, blocks, d] summed over the blocks, in block
// order: a thread adds every kSumSlices-th block row of one column, then the
// slices are added in slice order.
__global__ void __launch_bounds__(kSumCols * kSumSlices)
    ln_colsum_kernel(const float* __restrict__ partials, int blocks, int d,
                     float* __restrict__ sums) {
  __shared__ float slice_sums[kSumSlices][kSumCols];
  const int i = blockIdx.x * kSumCols + threadIdx.x;  // of the 2 * d outputs
  const bool live = i < 2 * d;
  float acc = 0.0f;
  if (live) {
    const int which = i / d, col = i % d;
    const float* p = partials + static_cast<size_t>(which) * blocks * d + col;
    for (int b = threadIdx.y; b < blocks; b += kSumSlices) {
      acc += p[static_cast<size_t>(b) * d];
    }
  }
  slice_sums[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && live) {
    float total = slice_sums[0][threadIdx.x];
#pragma unroll
    for (int s = 1; s < kSumSlices; ++s) total += slice_sums[s][threadIdx.x];
    sums[i] = total;
  }
}

template <typename T, int D>
int launch_fwd(const void* x, const float* scale, const float* bias, void* y,
               int n, int d, int blocks, float eps, cudaStream_t s) {
  const size_t smem = smem_bytes<T, D>(d, 1);
  const cudaError_t err = smem > kSmemDefault ? allow_smem(ln_fwd_kernel<T, D>, smem) : cudaSuccess;
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_fwd_kernel<T, D><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), n, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* x, const float* scale, const void* dy, void* dx,
               float* partials, float* sums, int n, int d, int blocks,
               float eps, cudaStream_t s) {
  const size_t smem = smem_bytes<T, D>(d, 2);
  cudaError_t err = smem > kSmemDefault ? allow_smem(ln_bwd_kernel<T, D>, smem) : cudaSuccess;
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_kernel<T, D><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(dy),
      static_cast<T*>(dx), partials, n, d, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 sum_block(kSumCols, kSumSlices);
  ln_colsum_kernel<<<(2 * d + kSumCols - 1) / kSumCols, sum_block, 0, s>>>(
      partials, blocks, d, sums);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int info(int which, int d, int* out) {
  if (which == 0) {
    return kernel_info(ln_fwd_kernel<T, D>, kThreads, smem_bytes<T, D>(d, 1), out);
  }
  return kernel_info(ln_bwd_kernel<T, D>, kThreads, smem_bytes<T, D>(d, 2), out);
}

// Calls F<T, D>::run(args...) with the exact-width template for d, or the
// generic one.
template <typename T, template <typename, int> class F, typename... Args>
int by_width(int d, Args... args) {
  switch (d) {
    case 192: return F<T, 192>::run(args...);
    case 384: return F<T, 384>::run(args...);
    case 768: return F<T, 768>::run(args...);
    case 1024: return F<T, 1024>::run(args...);
    default: return F<T, 0>::run(args...);
  }
}

template <typename T, int D>
struct Fwd {
  template <typename... Args>
  static int run(Args... args) { return launch_fwd<T, D>(args...); }
};

template <typename T, int D>
struct Bwd {
  template <typename... Args>
  static int run(Args... args) { return launch_bwd<T, D>(args...); }
};

template <typename T, int D>
struct Info {
  template <typename... Args>
  static int run(Args... args) { return info<T, D>(args...); }
};

bool width_ok(int d, int is_bf16) {
  return d > 0 && d <= kMaxWidth && d % (is_bf16 ? 8 : 4) == 0;
}

}  // namespace

// Plain C entry points, bound with ctypes. They launch on `stream`
// (PyTorch's current stream) on the caller's current device, do not
// synchronise, allocate nothing, and return cudaGetLastError() after the
// launch (0 on success). `blocks` is the grid: the wrapper's one wave,
// from ssip_layer_norm_info's resident blocks an SM.

// y [n, d] = LayerNorm(x [n, d]); x and y bfloat16 (is_bf16) or float32.
extern "C" int ssip_layer_norm_fwd(const void* x, const void* scale,
                                   const void* bias, void* y, int is_bf16,
                                   int n, int d, int blocks, float eps,
                                   void* stream) {
  if (!width_ok(d, is_bf16) || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (is_bf16) {
    return by_width<__nv_bfloat16, Fwd>(d, x, sc, bi, y, n, d, blocks, eps, s);
  }
  return by_width<float, Fwd>(d, x, sc, bi, y, n, d, blocks, eps, s);
}

// dx [n, d], and dscale, dbias as sums [2, d] (float32). Two launches:
// ln_bwd_kernel writes each block's sums to partials [2, blocks, d]
// (float32 scratch), ln_colsum_kernel adds them up.
extern "C" int ssip_layer_norm_bwd(const void* x, const void* scale,
                                   const void* dy, void* dx, void* partials,
                                   void* sums, int is_bf16, int n, int d,
                                   int blocks, float eps, void* stream) {
  if (!width_ok(d, is_bf16) || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* part = static_cast<float*>(partials);
  float* out = static_cast<float*>(sums);
  if (is_bf16) {
    return by_width<__nv_bfloat16, Bwd>(d, x, sc, dy, dx, part, out, n, d,
                                        blocks, eps, s);
  }
  return by_width<float, Bwd>(d, x, sc, dy, dx, part, out, n, d, blocks, eps, s);
}

// What the card makes of a kernel at width d: which 0 the forward, 1 the
// backward (for x's type), 2 the column sum. out[4] = registers a thread,
// local (spilled) bytes a thread, shared memory a block (static + dynamic),
// resident blocks an SM. The wrapper sizes its grids from out[3].
extern "C" int ssip_layer_norm_info(int which, int is_bf16, int d, int* out) {
  if (which == 2) {
    return kernel_info(ln_colsum_kernel, kSumCols * kSumSlices, 0, out);
  }
  if (which < 0 || which > 2 || !width_ok(d, is_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (is_bf16) return by_width<__nv_bfloat16, Info>(d, which, d, out);
  return by_width<float, Info>(d, which, d, out);
}
