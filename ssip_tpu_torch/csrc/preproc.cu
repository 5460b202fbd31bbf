// Fused extraction preprocess for Hopper: uint8 NHWC image batch ->
// PIL-exact bilinear Resize(short side) -> CenterCrop -> ImageNet-normalize,
// written NHWC as float32 or bfloat16, or quantized to int8 for the int8
// extraction path.
//
// Replaces ssip_tpu/ops/pallas_preproc.py:_preproc_kernel and, with the int8
// epilogue, :_preproc_quant_kernel (the TPU kernels behind
// preprocess_images_pallas). Those kernels spend two dense MXU matmuls
// against [crop, H] and [W, crop] triangle-filter matrices, because the
// matrix unit is the TPU's cheap unit. The matrices are banded: 4 nonzeros
// in each row of 512 for 512 -> 256, so a dense product here would do about
// 128x the needed work. This kernel is the direct separable-tap form: the
// host passes, per output row and per output column, the first source index,
// the tap count and the tap weights (the nonzeros of the same float32
// triangle_weights rows, padded to the largest count).
//
// One thread per output pixel (b, oy, ox), all three channels:
//   for each vertical tap row:  t = sum_j x[row, hs + j] * wh[j]  (ascending j)
//                               t = clip8(t)
//   y = clip8(sum_i t_i * wv[i]);  v = (y - off_c) * sc_c
//   out = v, or for int8: clamp(rintf(v * inv_s), -127, 127)
// (rintf rounds half to even, like the plain version's torch.round; the
// normalized float32 value never reaches device memory on the int8 path).
// clip8 is PIL's floor(x + 0.5) clamped to [0, 255]. Every product and sum
// uses the _rn intrinsics so nvcc cannot contract them into FMAs: for
// 512 -> 256 -> 224 every tap weight is dyadic (1/8, 3/8), every partial sum
// is exact, and the result is bitwise the plain PyTorch version's; other
// sizes hold to one uint8 step before the normalize.
//
// Bound: bytes. Per 512x512 image about 786 KB of uint8 in and 301 KB of
// bfloat16 out (602 KB float32, 151 KB int8) against a few hundred flops per
// output pixel.
// At the H100 data sheet's 3.35 TB/s that bounds the kernel near 3 M
// images/s (a computed figure, not a measurement). This first form reads each
// input byte through L1/L2 about 4x over (neighbouring outputs share taps),
// recomputes the horizontal pass for every vertical tap, and stores 3
// scattered values per thread; shared-memory tiling of the horizontal pass
// and vector stores are later work.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float clip8(float x) {
  const float r = floorf(__fadd_rn(x, 0.5f));
  return fminf(fmaxf(r, 0.0f), 255.0f);
}

// The epilogue: the normalized value as T. Only int8 uses inv_s.
template <typename T>
__device__ __forceinline__ T to_out(float v, float inv_s);

template <>
__device__ __forceinline__ float to_out<float>(float v, float) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v,
                                                               float) {
  return __float2bfloat16_rn(v);
}

template <>
__device__ __forceinline__ int8_t to_out<int8_t>(float v, float inv_s) {
  const float r = rintf(__fmul_rn(v, inv_s));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

template <typename T>
__global__ void preproc_taps_kernel(const uint8_t* __restrict__ in,
                                    T* __restrict__ out, int batch, int h,
                                    int w, int crop,
                                    const int* __restrict__ v_start,
                                    const int* __restrict__ v_count,
                                    const float* __restrict__ v_w, int kv,
                                    const int* __restrict__ h_start,
                                    const int* __restrict__ h_count,
                                    const float* __restrict__ h_w, int kh,
                                    float3 off, float3 sc, float inv_s) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(batch) * crop * crop;
  if (idx >= total) return;

  const int ox = static_cast<int>(idx % crop);
  const long long rest = idx / crop;
  const int oy = static_cast<int>(rest % crop);
  const long long b = rest / crop;

  const uint8_t* img = in + static_cast<size_t>(b) * h * w * 3;
  const int hs = h_start[ox];
  const int hn = h_count[ox];
  const float* hwt = h_w + static_cast<size_t>(ox) * kh;
  const int vs = v_start[oy];
  const int vn = v_count[oy];
  const float* vwt = v_w + static_cast<size_t>(oy) * kv;

  float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f;
  for (int i = 0; i < vn; ++i) {
    const uint8_t* px = img + (static_cast<size_t>(vs + i) * w + hs) * 3;
    float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;
    for (int j = 0; j < hn; ++j) {
      const float wj = hwt[j];
      t0 = __fadd_rn(t0, __fmul_rn(static_cast<float>(px[3 * j + 0]), wj));
      t1 = __fadd_rn(t1, __fmul_rn(static_cast<float>(px[3 * j + 1]), wj));
      t2 = __fadd_rn(t2, __fmul_rn(static_cast<float>(px[3 * j + 2]), wj));
    }
    const float wi = vwt[i];
    y0 = __fadd_rn(y0, __fmul_rn(clip8(t0), wi));
    y1 = __fadd_rn(y1, __fmul_rn(clip8(t1), wi));
    y2 = __fadd_rn(y2, __fmul_rn(clip8(t2), wi));
  }

  T* o = out + idx * 3;
  o[0] = to_out<T>(__fmul_rn(__fsub_rn(clip8(y0), off.x), sc.x), inv_s);
  o[1] = to_out<T>(__fmul_rn(__fsub_rn(clip8(y1), off.y), sc.y), inv_s);
  o[2] = to_out<T>(__fmul_rn(__fsub_rn(clip8(y2), off.z), sc.z), inv_s);
}

}  // namespace

// Plain C entry points, bound with ctypes. They launch on `stream` (PyTorch's
// current stream) on the caller's current device, do not synchronise,
// allocate nothing, leave the current device as it was, and return
// cudaGetLastError() after the launch (0 on success). `out_kind` is 0 for
// float32, 1 for bfloat16 and 2 for int8 quantized with `inv_s`.
namespace {

int launch_preprocess(const void* in, void* out, int out_kind, int batch,
                      int h, int w, int crop, const void* v_start,
                      const void* v_count, const void* v_w, int kv,
                      const void* h_start, const void* h_count,
                      const void* h_w, int kh, float3 off, float3 sc,
                      float inv_s, void* stream) {
  const long long total = static_cast<long long>(batch) * crop * crop;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned int blocks =
      static_cast<unsigned int>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  const int* vs = static_cast<const int*>(v_start);
  const int* vc = static_cast<const int*>(v_count);
  const float* vw = static_cast<const float*>(v_w);
  const int* hs = static_cast<const int*>(h_start);
  const int* hc = static_cast<const int*>(h_count);
  const float* hw = static_cast<const float*>(h_w);
  if (out_kind == 2) {
    preproc_taps_kernel<int8_t><<<blocks, threads, 0, s>>>(
        src, static_cast<int8_t*>(out), batch, h, w, crop, vs, vc, vw, kv, hs,
        hc, hw, kh, off, sc, inv_s);
  } else if (out_kind == 1) {
    preproc_taps_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        src, static_cast<__nv_bfloat16*>(out), batch, h, w, crop, vs, vc, vw,
        kv, hs, hc, hw, kh, off, sc, inv_s);
  } else {
    preproc_taps_kernel<float><<<blocks, threads, 0, s>>>(
        src, static_cast<float*>(out), batch, h, w, crop, vs, vc, vw, kv, hs,
        hc, hw, kh, off, sc, inv_s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssip_preprocess_u8(
    const void* in, void* out, int out_bf16, int batch, int h, int w,
    int crop, const void* v_start, const void* v_count, const void* v_w,
    int kv, const void* h_start, const void* h_count, const void* h_w,
    int kh, float off0, float off1, float off2, float sc0, float sc1,
    float sc2, void* stream) {
  return launch_preprocess(in, out, out_bf16 ? 1 : 0, batch, h, w, crop,
                           v_start, v_count, v_w, kv, h_start, h_count, h_w,
                           kh, make_float3(off0, off1, off2),
                           make_float3(sc0, sc1, sc2), 1.0f, stream);
}

// The same chain with the int8 epilogue: `out` is int8 [B, crop, crop, 3].
extern "C" int ssip_preprocess_u8_quant(
    const void* in, void* out, int batch, int h, int w, int crop,
    const void* v_start, const void* v_count, const void* v_w, int kv,
    const void* h_start, const void* h_count, const void* h_w, int kh,
    float off0, float off1, float off2, float sc0, float sc1, float sc2,
    float inv_s, void* stream) {
  return launch_preprocess(in, out, 2, batch, h, w, crop, v_start, v_count,
                           v_w, kv, h_start, h_count, h_w, kh,
                           make_float3(off0, off1, off2),
                           make_float3(sc0, sc1, sc2), inv_s, stream);
}
