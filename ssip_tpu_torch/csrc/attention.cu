// Multi-head softmax attention for Hopper: the C entry points of both
// attention pairs, and the float32 backward of both. The packed pair works
// straight off qkv [B, S, 3D] with columns [3, H, Dh]; per image and head
//   s = q kT / sqrt(Dh)   (float32 sum of products of the inputs),
//   keys at index >= kv_len are masked out, p = softmax(s) in float32,
//   o = round(p) v        (p rounded to the input type before the product:
//                          a no-op in float32),
// written to o [B, S, D]; all S query rows are computed, pad rows included.
// The unpacked pair takes q, k, v apart as [B, H, S, Dh] (contiguous, so a
// head's rows are Dh apart instead of 3D), every key real, and keeps p and
// ds in float32 for their products, which in float32 is the same function.
//
// Where each form runs:
// - bfloat16: ssip_attention_qkv_fwd and _bwd hand the tensors to the
//   kernels of attention_mma.cu, ssip_attention_fwd and _bwd to those of
//   attention_unpacked_mma.cu (tensor cores, mma.sync).
// - float32 forward, both pairs: attention_f32_mma.cu (3xTF32 products on
//   mma.sync, keys streamed in tiles with an online softmax).
// - float32 backward, both pairs: attn_bwd_body below, which replaces
//   ssip_tpu/ops/attention.py:_attn_qkv_bwd_kernel and :_attn_bwd_kernel
//   (the Pallas VJP kernels behind fused_attention_qkv and fused_attention).
//
// The backward: one block per (image, head). The TPU kernels take one image
// a grid step and keep its whole [S, 3D] face and an [S, S] score matrix in
// VMEM (the unpacked ones pad S to 128 lanes and mask the pad keys; here S
// is exact). A Hopper block has far less fast memory and the card wants a
// thousand blocks. Probabilities are recomputed, nothing but the inputs is
// saved. dq is a sum over keys and dk, dv are sums over queries, so the block
// makes two passes and needs no atomics and no [S, Dh] float32 accumulators
// in shared memory. Pass A (K, V staged, a warp per 4 query rows) recomputes
// p, forms dp = dO vT, delta = rowsum(dp * p), ds = p * (dp - delta), writes
// dq = round(ds) k / sqrt(Dh) and leaves each row's max, sum and delta in
// shared memory. Pass B (q, dO staged, a warp per 4 key rows) recomputes the
// same scores (same products in the same order, so the same bits), p and ds
// from the saved row statistics and writes dv = round(p)T dO and
// dk = round(ds)T q / sqrt(Dh). Key rows at or past kv_len get zeros.
// Everything lands in the packed dqkv (or dq, dk, dv) directly.
//
// In the backward products are float32 FMAs (lanes over keys, K and V rows
// padded to an odd word stride, so lanes hit distinct banks). Bound: the
// operations at the tensor cores' rate for float32-accurate products
// (3xTF32, as the forward has them), but this form is held back by
// shared-memory loads, about one for every two FMAs.
//
// Shapes: Dh 32 or 64, S at most 256 in float32 (8 key or query chunks of
// 32 a lane in the backward); the unpacked pair in bfloat16 takes S up to
// 1024. The wrapper raises on anything else.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

// The bfloat16 packed pair on the tensor cores (attention_mma.cu).
int attention_qkv_fwd_bf16(const void* qkv, void* o, int batch, int heads,
                           int s_len, int dh, int kv, float scale,
                           cudaStream_t stream);
int attention_qkv_bwd_bf16(const void* qkv, const void* d_o, void* dqkv,
                           void* stats, int batch, int heads, int s_len,
                           int dh, int kv, float scale, cudaStream_t stream);
// The float32 forward of both pairs on the tensor cores (attention_f32_mma.cu).
int attention_qkv_fwd_f32(const void* qkv, void* o, int batch, int heads,
                          int s_len, int dh, int kv, float scale,
                          cudaStream_t stream);
int attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                      int batch_heads, int s_len, int dh, float scale,
                      cudaStream_t stream);
// The bfloat16 unpacked pair on the tensor cores (attention_unpacked_mma.cu).
int attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                       int batch_heads, int s_len, int dh, float scale,
                       cudaStream_t stream);
int attention_bwd_bf16(const void* q, const void* k, const void* v,
                       const void* d_o, void* dq, void* dk, void* dv,
                       void* stats, int batch_heads, int s_len, int dh,
                       float scale, cudaStream_t stream);

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;    // rows a warp works on together
constexpr int kChunks = 8;  // 32-wide chunks a lane covers: S <= 256
constexpr int kMaxUnpackedBf16Seq = 1024;  // the JAX entry's _MAX_FUSED_SEQ

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

// Row stride, in floats, of a staged [rows, DH] matrix: an odd number of
// 32-bit words, so lanes reading one column of 32 rows hit 32 banks.
template <int DH>
struct Stride {
  static constexpr int value = DH + 1;
};

// The block copies `rows` rows of DH columns from global memory (row pitch
// `pitch` elements) into shared memory (row stride Stride<DH>).
template <int DH>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src, int rows,
                                      int pitch) {
  constexpr int KS = Stride<DH>::value;
  for (int idx = threadIdx.x; idx < rows * DH; idx += kThreads) {
    const int r = idx / DH;
    const int c = idx - r * DH;
    dst[r * KS + c] = src[static_cast<size_t>(r) * pitch + c];
  }
}

// A warp loads kRows rows (first0 .. first0+kRows-1, clamped to last) of DH
// columns from global memory into vec [DH][kRows] as floats.
template <int DH>
__device__ __forceinline__ void load_rows(float* __restrict__ vec,
                                          const float* __restrict__ src,
                                          int first, int last, int pitch,
                                          int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = min(first + r, last);
    for (int c = lane; c < DH; c += 32) {
      vec[c * kRows + r] = src[static_cast<size_t>(row) * pitch + c];
    }
  }
}

// out[r][c] = sum_d vec[d][r] * mat[c*32 + lane][d] for the lane's rows of
// the staged matrix `mat` [n, DH]; chunks at or past n stay 0. The sum runs
// over d in order with one FMA a term, wherever it is called from.
template <int DH>
__device__ __forceinline__ void dot_rows(const float* __restrict__ mat, int n,
                                         const float* __restrict__ vec,
                                         int lane,
                                         float (&out)[kRows][kChunks]) {
  constexpr int KS = Stride<DH>::value;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float acc[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (c * 32 < n) {  // the same for the whole warp
      const float* row = mat + min(c * 32 + lane, n - 1) * KS;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float m = row[d];
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
template <int DH>
__device__ __forceinline__ void weighted_rows(const float* __restrict__ mat,
                                              int n,
                                              const float* __restrict__ w,
                                              int lane,
                                              float (&acc)[kRows][DH / 32]) {
  constexpr int KS = Stride<DH>::value;
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
      const float m = mat[j * KS + lane * DPL + t];
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

template <int DH>
struct Layout {
  static constexpr int KS = Stride<DH>::value;
  // two staged matrices, then 3 row statistics, then per warp two each of
  // `vecs` [DH][kRows] float vectors and `ws` [s][kRows] float weights
  static __host__ __device__ size_t mat(int s) {
    return align16(static_cast<size_t>(s) * KS * sizeof(float));
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
  static size_t backward_bytes(int s) {
    return 2 * mat(s) + 3 * stats(s) + kWarps * 2 * (vec() + weights(s));
  }
};

// One (image, head) backward. q_g, k_g, v_g and dq_g, dk_g, dv_g point at
// the head's first row, rows `pitch` elements apart; do_g likewise with
// `do_pitch`.
template <int DH>
__device__ __forceinline__ void attn_bwd_body(
    const float* __restrict__ q_g, const float* __restrict__ k_g,
    const float* __restrict__ v_g, const float* __restrict__ do_g,
    float* __restrict__ dq_g, float* __restrict__ dk_g, float* __restrict__ dv_g,
    int pitch, int do_pitch, int s_len, int kv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = Layout<DH>;
  constexpr int DPL = DH / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float* mat_a = reinterpret_cast<float*>(smem);                   // K, then q
  float* mat_b = reinterpret_cast<float*>(smem + L::mat(s_len));   // V, then dO
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

  // Pass A: K and V staged, a warp per group of query rows.
  stage<DH>(mat_a, k_g, kv, pitch);
  stage<DH>(mat_b, v_g, kv, pitch);
  __syncthreads();
  for (int i0 = warp * kRows; i0 < s_len; i0 += kWarps * kRows) {
    load_rows<DH>(vec_a, q_g, i0, s_len - 1, pitch, lane);
    load_rows<DH>(vec_b, do_g, i0, s_len - 1, do_pitch, lane);
    __syncwarp();
    float p[kRows][kChunks], dp[kRows][kChunks];
    dot_rows<DH>(mat_a, kv, vec_a, lane, p);
    dot_rows<DH>(mat_b, kv, vec_b, lane, dp);
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
        dp[r][c] = p[r][c] * (dp[r][c] - delta);  // ds
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
    weighted_rows<DH>(mat_a, kv, w_a, lane, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (i0 + r < s_len) {
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          dq_g[static_cast<size_t>(i0 + r) * pitch + lane * DPL + t] =
              acc[r][t] * scale;
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // Pass B: q and dO staged, a warp per group of key rows.
  stage<DH>(mat_a, q_g, s_len, pitch);
  stage<DH>(mat_b, do_g, s_len, do_pitch);
  __syncthreads();
  for (int j0 = warp * kRows; j0 < s_len; j0 += kWarps * kRows) {
    float acc_v[kRows][DPL] = {}, acc_k[kRows][DPL] = {};
    if (j0 < kv) {  // the same for the whole warp
      load_rows<DH>(vec_a, k_g, j0, kv - 1, pitch, lane);
      load_rows<DH>(vec_b, v_g, j0, kv - 1, pitch, lane);
      __syncwarp();
      float p[kRows][kChunks], dp[kRows][kChunks];
      dot_rows<DH>(mat_a, s_len, vec_a, lane, p);
      dot_rows<DH>(mat_b, s_len, vec_b, lane, dp);
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
            pc[r] = pr;
            dsc[r] = pr * (dp[r][c] - delta);
          }
          *reinterpret_cast<float4*>(w_a + i * kRows) =
              make_float4(pc[0], pc[1], pc[2], pc[3]);
          *reinterpret_cast<float4*>(w_b + i * kRows) =
              make_float4(dsc[0], dsc[1], dsc[2], dsc[3]);
        }
      }
      __syncwarp();
      weighted_rows<DH>(mat_b, s_len, w_a, lane, acc_v);
      weighted_rows<DH>(mat_a, s_len, w_b, lane, acc_k);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = j0 + r;
      if (j < s_len) {
        const bool live = j < kv;  // masked keys get zero gradients
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const size_t at = static_cast<size_t>(j) * pitch + lane * DPL + t;
          dv_g[at] = live ? acc_v[r][t] : 0.0f;
          dk_g[at] = live ? acc_k[r][t] * scale : 0.0f;
        }
      }
    }
    __syncwarp();
  }
}

// Packed qkv [B, S, 3D] and dO [B, S, D] -> packed dqkv; block = (image, head).
template <int DH>
__global__ void __launch_bounds__(kThreads)
    attn_qkv_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ d_o,
                        float* __restrict__ dqkv, int heads, int s_len, int kv,
                        float scale) {
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const int d_model = heads * DH;
  const int pitch = 3 * d_model;
  const size_t image = static_cast<size_t>(b) * s_len;
  const float* q_g = qkv + image * pitch + h * DH;
  float* dq_g = dqkv + image * pitch + h * DH;
  attn_bwd_body<DH>(q_g, q_g + d_model, q_g + 2 * d_model,
                             d_o + image * d_model + h * DH, dq_g,
                             dq_g + d_model, dq_g + 2 * d_model, pitch,
                             d_model, s_len, kv, scale);
}

// q, k, v, dO [B*H, S, DH] -> dq, dk, dv of the same shape; float32 p and ds.
template <int DH>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ d_o,
                    float* __restrict__ dq, float* __restrict__ dk,
                    float* __restrict__ dv, int s_len, float scale) {
  const size_t at = static_cast<size_t>(blockIdx.x) * s_len * DH;
  attn_bwd_body<DH>(q + at, k + at, v + at, d_o + at, dq + at,
                              dk + at, dv + at, DH, DH, s_len, s_len, scale);
}

template <int DH>
int launch_bwd(const void* qkv, const void* d_o, void* dqkv, int batch,
               int heads, int s_len, int kv, float scale,
               cudaStream_t stream) {
  const size_t bytes = Layout<DH>::backward_bytes(s_len);
  cudaError_t err = cudaFuncSetAttribute(
      attn_qkv_bwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_qkv_bwd_kernel<DH><<<batch * heads, kThreads, bytes, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(d_o),
      static_cast<float*>(dqkv), heads, s_len, kv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_unpacked_bwd(const void* q, const void* k, const void* v,
                        const void* d_o, void* dq, void* dk, void* dv,
                        int batch_heads, int s_len, float scale,
                        cudaStream_t stream) {
  const size_t bytes = Layout<DH>::backward_bytes(s_len);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_kernel<DH><<<batch_heads, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(d_o),
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), s_len,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. They launch on `stream`
// (PyTorch's current stream) on the caller's current device, do not
// synchronise, allocate nothing, and return the first CUDA error of the
// set-up or the launch (0 on success). `kv` is the number of real keys
// (1 <= kv <= s_len <= 256), `dh` the head width (32 or 64). The bfloat16
// backward takes `stats`, the caller's float32 scratch of
// batch * heads * 3 * round16(s_len) values; float32 ignores it.

extern "C" int ssip_attention_qkv_fwd(const void* qkv, void* o, int is_bf16,
                                      int batch, int heads, int s_len, int dh,
                                      int kv, float scale, void* stream) {
  if (batch == 0 || heads == 0 || s_len == 0) return 0;
  if (s_len > 32 * kChunks || kv < 1 || kv > s_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return attention_qkv_fwd_bf16(qkv, o, batch, heads, s_len, dh, kv, scale,
                                  s);
  }
  return attention_qkv_fwd_f32(qkv, o, batch, heads, s_len, dh, kv, scale, s);
}

extern "C" int ssip_attention_qkv_bwd(const void* qkv, const void* d_o,
                                      void* dqkv, void* stats, int is_bf16,
                                      int batch, int heads, int s_len, int dh,
                                      int kv, float scale, void* stream) {
  if (batch == 0 || heads == 0 || s_len == 0) return 0;
  if (s_len > 32 * kChunks || kv < 1 || kv > s_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return attention_qkv_bwd_bf16(qkv, d_o, dqkv, stats, batch, heads, s_len,
                                  dh, kv, scale, s);
  }
  if (dh == 64) {
    return launch_bwd<64>(qkv, d_o, dqkv, batch, heads, s_len, kv,
                                 scale, s);
  }
  if (dh == 32) {
    return launch_bwd<32>(qkv, d_o, dqkv, batch, heads, s_len, kv,
                                 scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The unpacked pair: q, k, v (and dO, dq, dk, dv) contiguous
// [batch_heads, s_len, dh], every key real; 1 <= s_len <= 256 in float32,
// up to 1024 in bfloat16. The bfloat16 backward takes `stats`, the caller's
// float32 scratch of batch_heads * 3 * round16(s_len) values; float32
// ignores it.

extern "C" int ssip_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o, int is_bf16, int batch_heads,
                                  int s_len, int dh, float scale,
                                  void* stream) {
  if (batch_heads == 0 || s_len == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (s_len > kMaxUnpackedBf16Seq) return static_cast<int>(cudaErrorInvalidValue);
    return attention_fwd_bf16(q, k, v, o, batch_heads, s_len, dh, scale, s);
  }
  if (s_len > 32 * kChunks) return static_cast<int>(cudaErrorInvalidValue);
  return attention_fwd_f32(q, k, v, o, batch_heads, s_len, dh, scale, s);
}

extern "C" int ssip_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* d_o, void* dq, void* dk,
                                  void* dv, void* stats, int is_bf16,
                                  int batch_heads, int s_len, int dh,
                                  float scale, void* stream) {
  if (batch_heads == 0 || s_len == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (s_len > kMaxUnpackedBf16Seq) return static_cast<int>(cudaErrorInvalidValue);
    return attention_bwd_bf16(q, k, v, d_o, dq, dk, dv, stats, batch_heads, s_len, dh, scale, s);
  }
  if (s_len > 32 * kChunks) return static_cast<int>(cudaErrorInvalidValue);
  if (dh == 64) {
    return launch_unpacked_bwd<64>(q, k, v, d_o, dq, dk, dv, batch_heads, s_len, scale, s);
  }
  if (dh == 32) {
    return launch_unpacked_bwd<32>(q, k, v, d_o, dq, dk, dv, batch_heads, s_len, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
