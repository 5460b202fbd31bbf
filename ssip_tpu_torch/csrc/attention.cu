// Multi-head softmax attention for Hopper: the C entry points of both
// attention pairs. The packed pair works straight off qkv [B, S, 3D] with
// columns [3, H, Dh]; per image and head
//   s = q kT / sqrt(Dh)   (float32 sum of products of the inputs),
//   keys at index >= kv_len are masked out, p = softmax(s) in float32,
//   o = round(p) v        (p rounded to the input type before the product:
//                          a no-op in float32),
// written to o [B, S, D]; all S query rows are computed, pad rows included;
// its backward writes the packed dqkv, zeros at key rows >= kv_len. The
// unpacked pair takes q, k, v apart as [B, H, S, Dh] (contiguous, so a
// head's rows are Dh apart instead of 3D), every key real, and keeps p and
// ds in float32 for their products, which in float32 is the same function.
//
// Where each form runs (all on the tensor cores, mma.sync), at any S:
// - bfloat16, packed: attention_mma.cu (attn_qkv_fwd_mma_kernel;
//   attn_qkv_bwd_rows_kernel + attn_qkv_bwd_keys_kernel), p and ds rounded
//   to bf16 before their products.
// - bfloat16, unpacked: up to 1024 tokens attention_unpacked_mma.cu
//   (attn_unpacked_fwd_kernel; attn_unpacked_bwd_rows_kernel +
//   attn_unpacked_bwd_keys_kernel), p and ds kept to float32 precision, as
//   the JAX entry's kernels keep them; past 1024 the JAX entry computes
//   attention_xla, which rounds p to the input type, so there the packed
//   pair's kernels of attention_mma.cu run on q, k, v. 1024 is the JAX
//   entries' _MAX_FUSED_SEQ (ssip_tpu/ops/attention.py:39).
// - float32, both pairs: attention_f32_mma.cu (attn_f32_fwd_kernel;
//   attn_f32_bwd_rows_kernel + attn_f32_bwd_keys_kernel, 3xTF32 products).
//   The backward reads the forward's output o and its per-row statistics,
//   which the forward writes when given `stats`. Rounding p is a no-op in
//   float32, so one form serves every S.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

// The bfloat16 packed pair (attention_mma.cu).
int attention_qkv_fwd_bf16(const void* qkv, void* o, int batch, int heads,
                           int s_len, int dh, int kv, float scale,
                           cudaStream_t stream);
int attention_qkv_bwd_bf16(const void* qkv, const void* d_o, void* dqkv,
                           void* stats, int batch, int heads, int s_len,
                           int dh, int kv, float scale, cudaStream_t stream);
// The bfloat16 unpacked pair up to 1024 tokens (attention_unpacked_mma.cu),
// and past it (attention_mma.cu).
int attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                       int batch_heads, int s_len, int dh, float scale,
                       cudaStream_t stream);
int attention_bwd_bf16(const void* q, const void* k, const void* v,
                       const void* d_o, void* dq, void* dk, void* dv,
                       void* stats, int batch_heads, int s_len, int dh,
                       float scale, cudaStream_t stream);
int attention_rounded_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                               int batch_heads, int s_len, int dh, float scale,
                               cudaStream_t stream);
int attention_rounded_bwd_bf16(const void* q, const void* k, const void* v, const void* d_o,
                               void* dq, void* dk, void* dv, void* stats, int batch_heads,
                               int s_len, int dh, float scale, cudaStream_t stream);
// Both pairs in float32 (attention_f32_mma.cu).
int attention_qkv_fwd_f32(const void* qkv, void* o, void* stats, int batch,
                          int heads, int s_len, int dh, int kv, float scale,
                          cudaStream_t stream);
int attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                      void* stats, int batch_heads, int s_len, int dh,
                      float scale, cudaStream_t stream);
int attention_qkv_bwd_f32(const void* qkv, const void* d_o, void* dqkv,
                          const void* o, const void* stats, void* delta,
                          int batch, int heads, int s_len, int dh, int kv,
                          float scale, cudaStream_t stream);
int attention_bwd_f32(const void* q, const void* k, const void* v,
                      const void* d_o, void* dq, void* dk, void* dv,
                      const void* o, const void* stats, void* delta,
                      int batch_heads, int s_len, int dh, float scale,
                      cudaStream_t stream);

namespace {

// the JAX entries' _MAX_FUSED_SEQ: the unpacked bf16 pair keeps p in
// float32 up to it and rounds it past it
constexpr int kMaxFusedSeq = 1024;

}  // namespace

// Plain C entry points, bound with ctypes. They launch on `stream`
// (PyTorch's current stream) on the caller's current device, do not
// synchronise, allocate nothing, and return the first CUDA error of the
// set-up or the launch (0 on success). `kv` is the number of real keys
// (1 <= kv <= s_len), `dh` the head width (32 or 64); any s_len.
//
// Float32: the forward writes, when `stats` is not null, each query row's
// softmax statistics to the caller's float32 [B·H][2][round16(s_len)]; the
// backward reads them and the forward's output `o`, and takes `scratch`,
// B·H·round16(s_len) floats. Bfloat16: the forward takes no `stats` (null),
// the backward ignores `o` and `stats` and takes `scratch`,
// B·H·3·round16(s_len) floats. B·H is batch * heads (packed) or batch_heads.

extern "C" int ssip_attention_qkv_fwd(const void* qkv, void* o, void* stats,
                                      int is_bf16, int batch, int heads,
                                      int s_len, int dh, int kv, float scale,
                                      void* stream) {
  if (batch == 0 || heads == 0 || s_len == 0) return 0;
  if (kv < 1 || kv > s_len) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (stats != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return attention_qkv_fwd_bf16(qkv, o, batch, heads, s_len, dh, kv, scale,
                                  s);
  }
  return attention_qkv_fwd_f32(qkv, o, stats, batch, heads, s_len, dh, kv,
                               scale, s);
}

extern "C" int ssip_attention_qkv_bwd(const void* qkv, const void* d_o,
                                      void* dqkv, const void* o,
                                      const void* stats, void* scratch,
                                      int is_bf16, int batch, int heads,
                                      int s_len, int dh, int kv, float scale,
                                      void* stream) {
  if (batch == 0 || heads == 0 || s_len == 0) return 0;
  if (kv < 1 || kv > s_len || scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return attention_qkv_bwd_bf16(qkv, d_o, dqkv, scratch, batch, heads, s_len,
                                  dh, kv, scale, s);
  }
  if (o == nullptr || stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return attention_qkv_bwd_f32(qkv, d_o, dqkv, o, stats, scratch, batch, heads,
                               s_len, dh, kv, scale, s);
}

// The unpacked pair: q, k, v (and dO, dq, dk, dv, o) contiguous
// [batch_heads, s_len, dh], every key real. In bfloat16 past kMaxFusedSeq
// the rounded kernels run.

extern "C" int ssip_attention_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* stats, int is_bf16,
                                  int batch_heads, int s_len, int dh,
                                  float scale, void* stream) {
  if (batch_heads == 0 || s_len == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (stats != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (s_len > kMaxFusedSeq) return attention_rounded_fwd_bf16(q, k, v, o, batch_heads, s_len, dh, scale, s);
    return attention_fwd_bf16(q, k, v, o, batch_heads, s_len, dh, scale, s);
  }
  return attention_fwd_f32(q, k, v, o, stats, batch_heads, s_len, dh, scale, s);
}

extern "C" int ssip_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* d_o, void* dq, void* dk,
                                  void* dv, const void* o, const void* stats,
                                  void* scratch, int is_bf16, int batch_heads,
                                  int s_len, int dh, float scale,
                                  void* stream) {
  if (batch_heads == 0 || s_len == 0) return 0;
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (s_len > kMaxFusedSeq) {
      return attention_rounded_bwd_bf16(q, k, v, d_o, dq, dk, dv, scratch, batch_heads, s_len, dh, scale, s);
    }
    return attention_bwd_bf16(q, k, v, d_o, dq, dk, dv, scratch, batch_heads, s_len, dh, scale, s);
  }
  if (o == nullptr || stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return attention_bwd_f32(q, k, v, d_o, dq, dk, dv, o, stats, scratch, batch_heads, s_len, dh,
                           scale, s);
}
