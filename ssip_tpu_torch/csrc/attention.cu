// Multi-head softmax attention straight off the packed qkv tensor, forward
// and backward, for Hopper: qkv [B, S, 3D] with columns [3, H, Dh], in
// bfloat16 or float32. Per image and head
//   s = q kT / sqrt(Dh)   (float32 sum of products of the inputs),
//   keys at index >= kv_len are masked out, p = softmax(s) in float32,
//   o = round(p) v        (p rounded to the input type before the product),
// written to o [B, S, D]; all S query rows are computed, pad rows included.
//
// Replaces ssip_tpu/ops/attention.py:_attn_qkv_kernel and
// :_attn_qkv_bwd_kernel (the Pallas kernels behind fused_attention_qkv and
// its custom VJP). The TPU kernels take one image a grid step, keep its whole
// [S, 3D] face and an [S, S] score matrix in VMEM and unroll the heads over
// 64-lane slices. A Hopper block has far less fast memory and the card wants
// a thousand blocks, so here one block serves one (image, head):
//
// - forward: K and V of the head (keys below kv_len) are staged once in
//   shared memory, read straight from the packed layout (no unpacking copy,
//   no transpose). Each warp takes 4 query rows at a time: scores with lanes
//   over keys (K rows padded to an odd word stride, so lanes hit distinct
//   banks), max and sum by warp shuffle, p normalized in float32 and THEN
//   rounded to the input type, then p v with lanes over the head's columns
//   and a float32 sum rounded once.
// - backward: probabilities are recomputed, nothing but qkv is saved. dq is
//   a sum over keys and dk, dv are sums over queries, so the block makes two
//   passes and needs no atomics and no [S, Dh] float32 accumulators in
//   shared memory. Pass A (K, V staged, a warp per 4 query rows) recomputes
//   p, forms dp = dO vT, delta = rowsum(dp * p), ds = p * (dp - delta),
//   writes dq = round(ds) k / sqrt(Dh) and leaves each row's max, sum and
//   delta in shared memory. Pass B (q, dO staged, a warp per 4 key rows)
//   recomputes the same scores (same products in the same order, so the
//   same bits), p and ds from the saved row statistics and writes
//   dv = round(p)T dO and dk = round(ds)T q / sqrt(Dh). Key rows at or past
//   kv_len get zeros. Everything lands in the packed dqkv directly.
//
// Products are float32 FMAs for both types (never TF32); tensor-core
// products (wgmma) are later work. Bound: bytes by the roofline (each
// qkv value read once), but this form is held back by shared-memory loads,
// about one for every two FMAs.
//
// Shapes: Dh 32 or 64, S at most 256 (8 key or query chunks of 32 a lane).
// The wrapper raises on anything else.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;    // rows a warp works on together
constexpr int kChunks = 8;  // 32-wide chunks a lane covers: S <= 256

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// Row stride, in elements, of a staged [rows, DH] matrix: an odd number of
// 32-bit words, so lanes reading one column of 32 rows hit 32 banks.
template <typename T, int DH>
struct Stride {
  static constexpr int value = DH + (sizeof(T) == 2 ? 2 : 1);
};

// The block copies `rows` rows of DH columns from global memory (row pitch
// `pitch` elements) into shared memory (row stride Stride<T, DH>).
template <typename T, int DH>
__device__ __forceinline__ void stage(T* __restrict__ dst,
                                      const T* __restrict__ src, int rows,
                                      int pitch) {
  constexpr int KS = Stride<T, DH>::value;
  for (int idx = threadIdx.x; idx < rows * DH; idx += kThreads) {
    const int r = idx / DH;
    const int c = idx - r * DH;
    dst[r * KS + c] = src[static_cast<size_t>(r) * pitch + c];
  }
}

// A warp loads kRows rows (first0 .. first0+kRows-1, clamped to last) of DH
// columns from global memory into vec [DH][kRows] as floats.
template <typename T, int DH>
__device__ __forceinline__ void load_rows(float* __restrict__ vec,
                                          const T* __restrict__ src,
                                          int first, int last, int pitch,
                                          int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = min(first + r, last);
    for (int c = lane; c < DH; c += 32) {
      vec[c * kRows + r] = to_float(src[static_cast<size_t>(row) * pitch + c]);
    }
  }
}

// out[r][c] = sum_d vec[d][r] * mat[c*32 + lane][d] for the lane's rows of
// the staged matrix `mat` [n, DH]; chunks at or past n stay 0. The sum runs
// over d in order with one FMA a term, wherever it is called from.
template <typename T, int DH>
__device__ __forceinline__ void dot_rows(const T* __restrict__ mat, int n,
                                         const float* __restrict__ vec,
                                         int lane,
                                         float (&out)[kRows][kChunks]) {
  constexpr int KS = Stride<T, DH>::value;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float acc[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (c * 32 < n) {  // the same for the whole warp
      const T* row = mat + min(c * 32 + lane, n - 1) * KS;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float m = to_float(row[d]);
        const float4 v = *reinterpret_cast<const float4*>(vec + d * kRows);
        acc[0] = fmaf(v.x, m, acc[0]);
        acc[1] = fmaf(v.y, m, acc[1]);
        acc[2] = fmaf(v.z, m, acc[2]);
        acc[3] = fmaf(v.w, m, acc[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[r][c] = acc[r];
  }
}

// acc[r][t] = sum_j w[j][r] * mat[j][lane*DPL + t] over the n staged rows,
// with lanes over the DH columns (DPL = DH / 32 columns a lane).
template <typename T, int DH>
__device__ __forceinline__ void weighted_rows(const T* __restrict__ mat,
                                              int n,
                                              const float* __restrict__ w,
                                              int lane,
                                              float (&acc)[kRows][DH / 32]) {
  constexpr int KS = Stride<T, DH>::value;
  constexpr int DPL = DH / 32;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[r][t] = 0.0f;
  }
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 wj = *reinterpret_cast<const float4*>(w + j * kRows);
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const float m = to_float(mat[j * KS + lane * DPL + t]);
      acc[0][t] = fmaf(wj.x, m, acc[0][t]);
      acc[1][t] = fmaf(wj.y, m, acc[1][t]);
      acc[2][t] = fmaf(wj.z, m, acc[2][t]);
      acc[3][t] = fmaf(wj.w, m, acc[3][t]);
    }
  }
}

// exp(s - max) of one scaled score, with the subtraction rounded on its own
// (no FMA contraction), so both backward passes get the same bits.
__device__ __forceinline__ float probability_numerator(float s, float mx) {
  return expf(__fsub_rn(s, mx));
}

// Softmax of the scaled scores of row r over the lane's key chunks, keys at
// or past kv left at probability 0. Returns the row's max and sum.
__device__ __forceinline__ void softmax_row(float (&s)[kChunks], int kv,
                                            float scale, int lane, float& mx,
                                            float& sum) {
  mx = -1e30f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    s[c] = __fmul_rn(s[c], scale);
    if (c * 32 + lane < kv) mx = fmaxf(mx, s[c]);
  }
  mx = warp_max(mx);
  sum = 0.0f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    s[c] = (c * 32 + lane < kv) ? probability_numerator(s[c], mx) : 0.0f;
    sum += s[c];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) s[c] = __fdiv_rn(s[c], sum);
}

// Shared memory of one block, in bytes, each part 16-byte aligned.
__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

template <typename T, int DH>
struct Layout {
  static constexpr int KS = Stride<T, DH>::value;
  // two staged matrices, then (backward) 3 row statistics, then per warp:
  // `vecs` [DH][kRows] float vectors and `ws` [s][kRows] float weights
  static __host__ __device__ size_t mat(int s) {
    return align16(static_cast<size_t>(s) * KS * sizeof(T));
  }
  static __host__ __device__ size_t stats(int s) {
    return align16(static_cast<size_t>(s) * sizeof(float));
  }
  static __host__ __device__ size_t vec() {
    return static_cast<size_t>(DH) * kRows * sizeof(float);
  }
  static __host__ __device__ size_t weights(int s) {
    return static_cast<size_t>(s) * kRows * sizeof(float);
  }
  static size_t forward_bytes(int s) {
    return 2 * mat(s) + kWarps * (vec() + weights(s));
  }
  static size_t backward_bytes(int s) {
    return 2 * mat(s) + 3 * stats(s) + kWarps * 2 * (vec() + weights(s));
  }
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    attn_qkv_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ o,
                        int heads, int s_len, int kv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = Layout<T, DH>;
  constexpr int DPL = DH / 32;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const int d_model = heads * DH;
  const int pitch = 3 * d_model;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + L::mat(s_len));
  unsigned char* mine =
      smem + 2 * L::mat(s_len) + warp * (L::vec() + L::weights(s_len));
  float* q_vec = reinterpret_cast<float*>(mine);
  float* p_w = reinterpret_cast<float*>(mine + L::vec());

  const T* base = qkv + static_cast<size_t>(b) * s_len * pitch + h * DH;
  stage<T, DH>(k_s, base + d_model, kv, pitch);
  stage<T, DH>(v_s, base + 2 * d_model, kv, pitch);
  __syncthreads();

  T* o_base = o + static_cast<size_t>(b) * s_len * d_model + h * DH;
  for (int i0 = warp * kRows; i0 < s_len; i0 += kWarps * kRows) {
    load_rows<T, DH>(q_vec, base, i0, s_len - 1, pitch, lane);
    __syncwarp();
    float p[kRows][kChunks];
    dot_rows<T, DH>(k_s, kv, q_vec, lane, p);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float mx, sum;
      softmax_row(p[r], kv, scale, lane, mx, sum);
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = c * 32 + lane;
      if (j < kv) {
        *reinterpret_cast<float4*>(p_w + j * kRows) =
            make_float4(round_to<T>(p[0][c]), round_to<T>(p[1][c]),
                        round_to<T>(p[2][c]), round_to<T>(p[3][c]));
      }
    }
    __syncwarp();
    float acc[kRows][DPL];
    weighted_rows<T, DH>(v_s, kv, p_w, lane, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (i0 + r < s_len) {
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          o_base[static_cast<size_t>(i0 + r) * d_model + lane * DPL + t] =
              from_float<T>(acc[r][t]);
        }
      }
    }
    __syncwarp();  // q_vec and p_w are rewritten by the next group
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    attn_qkv_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ d_o,
                        T* __restrict__ dqkv, int heads, int s_len, int kv,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = Layout<T, DH>;
  constexpr int DPL = DH / 32;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const int d_model = heads * DH;
  const int pitch = 3 * d_model;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  T* mat_a = reinterpret_cast<T*>(smem);                   // K, then q
  T* mat_b = reinterpret_cast<T*>(smem + L::mat(s_len));   // V, then dO
  float* row_max = reinterpret_cast<float*>(smem + 2 * L::mat(s_len));
  float* row_sum = reinterpret_cast<float*>(smem + 2 * L::mat(s_len) +
                                            L::stats(s_len));
  float* row_delta = reinterpret_cast<float*>(smem + 2 * L::mat(s_len) +
                                              2 * L::stats(s_len));
  unsigned char* mine = smem + 2 * L::mat(s_len) + 3 * L::stats(s_len) +
                        warp * 2 * (L::vec() + L::weights(s_len));
  float* vec_a = reinterpret_cast<float*>(mine);
  float* vec_b = reinterpret_cast<float*>(mine + L::vec());
  float* w_a = reinterpret_cast<float*>(mine + 2 * L::vec());
  float* w_b = reinterpret_cast<float*>(mine + 2 * L::vec() +
                                        L::weights(s_len));

  const size_t image = static_cast<size_t>(b) * s_len;
  const T* q_g = qkv + image * pitch + h * DH;
  const T* k_g = q_g + d_model;
  const T* v_g = q_g + 2 * d_model;
  const T* do_g = d_o + image * d_model + h * DH;
  T* dq_g = dqkv + image * pitch + h * DH;
  T* dk_g = dq_g + d_model;
  T* dv_g = dq_g + 2 * d_model;

  // Pass A: K and V staged, a warp per group of query rows.
  stage<T, DH>(mat_a, k_g, kv, pitch);
  stage<T, DH>(mat_b, v_g, kv, pitch);
  __syncthreads();
  for (int i0 = warp * kRows; i0 < s_len; i0 += kWarps * kRows) {
    load_rows<T, DH>(vec_a, q_g, i0, s_len - 1, pitch, lane);
    load_rows<T, DH>(vec_b, do_g, i0, s_len - 1, d_model, lane);
    __syncwarp();
    float p[kRows][kChunks], dp[kRows][kChunks];
    dot_rows<T, DH>(mat_a, kv, vec_a, lane, p);
    dot_rows<T, DH>(mat_b, kv, vec_b, lane, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float mx, sum;
      softmax_row(p[r], kv, scale, lane, mx, sum);
      float delta = 0.0f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) delta = fmaf(dp[r][c], p[r][c], delta);
      delta = warp_sum(delta);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        dp[r][c] = round_to<T>(p[r][c] * (dp[r][c] - delta));  // ds
      }
      if (lane == 0 && i0 + r < s_len) {
        row_max[i0 + r] = mx;
        row_sum[i0 + r] = sum;
        row_delta[i0 + r] = delta;
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = c * 32 + lane;
      if (j < kv) {
        *reinterpret_cast<float4*>(w_a + j * kRows) =
            make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]);
      }
    }
    __syncwarp();
    float acc[kRows][DPL];
    weighted_rows<T, DH>(mat_a, kv, w_a, lane, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (i0 + r < s_len) {
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          dq_g[static_cast<size_t>(i0 + r) * pitch + lane * DPL + t] =
              from_float<T>(acc[r][t] * scale);
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // Pass B: q and dO staged, a warp per group of key rows.
  stage<T, DH>(mat_a, q_g, s_len, pitch);
  stage<T, DH>(mat_b, do_g, s_len, d_model);
  __syncthreads();
  for (int j0 = warp * kRows; j0 < s_len; j0 += kWarps * kRows) {
    float acc_v[kRows][DPL] = {}, acc_k[kRows][DPL] = {};
    if (j0 < kv) {  // the same for the whole warp
      load_rows<T, DH>(vec_a, k_g, j0, kv - 1, pitch, lane);
      load_rows<T, DH>(vec_b, v_g, j0, kv - 1, pitch, lane);
      __syncwarp();
      float p[kRows][kChunks], dp[kRows][kChunks];
      dot_rows<T, DH>(mat_a, s_len, vec_a, lane, p);
      dot_rows<T, DH>(mat_b, s_len, vec_b, lane, dp);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int i = c * 32 + lane;
        if (i < s_len) {
          const float mx = row_max[i], sum = row_sum[i], delta = row_delta[i];
          float pc[kRows], dsc[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float pr = __fdiv_rn(
                probability_numerator(__fmul_rn(p[r][c], scale), mx), sum);
            pc[r] = round_to<T>(pr);
            dsc[r] = round_to<T>(pr * (dp[r][c] - delta));
          }
          *reinterpret_cast<float4*>(w_a + i * kRows) =
              make_float4(pc[0], pc[1], pc[2], pc[3]);
          *reinterpret_cast<float4*>(w_b + i * kRows) =
              make_float4(dsc[0], dsc[1], dsc[2], dsc[3]);
        }
      }
      __syncwarp();
      weighted_rows<T, DH>(mat_b, s_len, w_a, lane, acc_v);
      weighted_rows<T, DH>(mat_a, s_len, w_b, lane, acc_k);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = j0 + r;
      if (j < s_len) {
        const bool live = j < kv;  // masked keys get zero gradients
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const size_t at = static_cast<size_t>(j) * pitch + lane * DPL + t;
          dv_g[at] = from_float<T>(live ? acc_v[r][t] : 0.0f);
          dk_g[at] = from_float<T>(live ? acc_k[r][t] * scale : 0.0f);
        }
      }
    }
    __syncwarp();
  }
}

template <typename T, int DH>
int launch_fwd(const void* qkv, void* o, int batch, int heads, int s_len,
               int kv, float scale, cudaStream_t stream) {
  const size_t bytes = Layout<T, DH>::forward_bytes(s_len);
  cudaError_t err = cudaFuncSetAttribute(
      attn_qkv_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_qkv_fwd_kernel<T, DH><<<batch * heads, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(o), heads, s_len, kv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_bwd(const void* qkv, const void* d_o, void* dqkv, int batch,
               int heads, int s_len, int kv, float scale,
               cudaStream_t stream) {
  const size_t bytes = Layout<T, DH>::backward_bytes(s_len);
  cudaError_t err = cudaFuncSetAttribute(
      attn_qkv_bwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_qkv_bwd_kernel<T, DH><<<batch * heads, kThreads, bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(d_o),
      static_cast<T*>(dqkv), heads, s_len, kv, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. They launch on `stream`
// (PyTorch's current stream) on the caller's current device, do not
// synchronise, allocate nothing, and return the first CUDA error of the
// set-up or the launch (0 on success). `kv` is the number of real keys
// (1 <= kv <= s_len <= 256), `dh` the head width (32 or 64).

extern "C" int ssip_attention_qkv_fwd(const void* qkv, void* o, int is_bf16,
                                      int batch, int heads, int s_len, int dh,
                                      int kv, float scale, void* stream) {
  if (batch == 0 || heads == 0 || s_len == 0) return 0;
  if (s_len > 32 * kChunks || kv < 1 || kv > s_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) {
    return is_bf16 ? launch_fwd<__nv_bfloat16, 64>(qkv, o, batch, heads, s_len,
                                                   kv, scale, s)
                   : launch_fwd<float, 64>(qkv, o, batch, heads, s_len, kv,
                                           scale, s);
  }
  if (dh == 32) {
    return is_bf16 ? launch_fwd<__nv_bfloat16, 32>(qkv, o, batch, heads, s_len,
                                                   kv, scale, s)
                   : launch_fwd<float, 32>(qkv, o, batch, heads, s_len, kv,
                                           scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ssip_attention_qkv_bwd(const void* qkv, const void* d_o,
                                      void* dqkv, int is_bf16, int batch,
                                      int heads, int s_len, int dh, int kv,
                                      float scale, void* stream) {
  if (batch == 0 || heads == 0 || s_len == 0) return 0;
  if (s_len > 32 * kChunks || kv < 1 || kv > s_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) {
    return is_bf16 ? launch_bwd<__nv_bfloat16, 64>(qkv, d_o, dqkv, batch,
                                                   heads, s_len, kv, scale, s)
                   : launch_bwd<float, 64>(qkv, d_o, dqkv, batch, heads, s_len,
                                           kv, scale, s);
  }
  if (dh == 32) {
    return is_bf16 ? launch_bwd<__nv_bfloat16, 32>(qkv, d_o, dqkv, batch,
                                                   heads, s_len, kv, scale, s)
                   : launch_bwd<float, 32>(qkv, d_o, dqkv, batch, heads, s_len,
                                           kv, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
