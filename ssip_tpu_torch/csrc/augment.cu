// Fused training augment for Hopper: uint8 NHWC image batch -> horizontal
// flip -> nearest-neighbour rotation about the centre (zero fill) ->
// ImageNet-normalize, written NHWC as float32 or bfloat16.
//
// Replaces ssip_tpu/ops/augment.py:_rotate_mxu (its inner Pallas `kernel`,
// reached from random_rotate_nearest and train_augment), and fuses the flip
// before it and the normalize after it. The TPU kernel re-expresses the
// rotation as one-hot bf16 matmuls over a row band of the source, because
// the TPU's gather runs on its scalar unit and its matrix unit is the cheap
// one. Hopper gathers directly: each output pixel reads its one source
// pixel, so this kernel is the gather itself, with no band and no matmul.
//
// One thread per output pixel (b, y, x), all three channels. Per image the
// host passes icos = round(cos(t) * 2^16), isin = round(sin(t) * 2^16) and
// the flip flag (int32 [3, batch]). Per pixel, in int32 as the JAX package:
//   ay = icos*(2y-(h-1)) + isin*(2x-(w-1));  ax = -isin*(2y-(h-1)) + icos*(2x-(w-1))
//   iy = floor((ay + h*2^16) / 2^17);        ix = floor((ax + w*2^16) / 2^17)
// C++ division truncates toward zero, so floor_div corrects it for negative
// numerators (pixels that map outside the image). The wrapper bounds H and
// W so no product overflows. In range, the source is column
// flip ? w-1-ix : ix of row iy (flip happens before rotation); out of range
// the pixel is 0. The normalize is one __fsub_rn and one __fmul_rn, so nvcc
// cannot contract them into an FMA, and the result is bitwise the plain
// PyTorch version's in float32; bfloat16 is that value rounded to nearest
// even.
//
// Bound: bytes. At 224x224 a uint8 image is 150 KB in and 602 KB of float32
// out (301 KB bfloat16) against about 20 integer operations per pixel; the
// source sits in L2 (50 MB), so the output stores set the pace. This first
// form stores 3 scalars per thread; shared-memory band tiling and vector
// stores are later work.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 1 << 16;

// floor(a / b) for b > 0.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b < 0) ? q - 1 : q;
}

template <typename T>
__device__ __forceinline__ T to_out(float v);

template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void train_augment_kernel(const uint8_t* __restrict__ in,
                                     T* __restrict__ out, int batch, int h,
                                     int w, const int* __restrict__ coeffs,
                                     float3 off, float3 sc) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(batch) * h * w;
  if (idx >= total) return;

  const int x = static_cast<int>(idx % w);
  const long long rest = idx / w;
  const int y = static_cast<int>(rest % h);
  const int b = static_cast<int>(rest / h);

  const int icos = coeffs[b];
  const int isin = coeffs[batch + b];
  const int flip = coeffs[2 * batch + b];
  const int yy2 = 2 * y - (h - 1);
  const int xx2 = 2 * x - (w - 1);
  const int iy = floor_div(icos * yy2 + isin * xx2 + h * kQ, 2 * kQ);
  const int ix = floor_div(-isin * yy2 + icos * xx2 + w * kQ, 2 * kQ);

  float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
  if (iy >= 0 && iy < h && ix >= 0 && ix < w) {
    const int sx = flip ? w - 1 - ix : ix;
    const uint8_t* px =
        in + ((static_cast<size_t>(b) * h + iy) * w + sx) * 3;
    v0 = static_cast<float>(px[0]);
    v1 = static_cast<float>(px[1]);
    v2 = static_cast<float>(px[2]);
  }

  T* o = out + idx * 3;
  o[0] = to_out<T>(__fmul_rn(__fsub_rn(v0, off.x), sc.x));
  o[1] = to_out<T>(__fmul_rn(__fsub_rn(v1, off.y), sc.y));
  o[2] = to_out<T>(__fmul_rn(__fsub_rn(v2, off.z), sc.z));
}

}  // namespace

// Plain C entry point, bound with ctypes. `coeffs` is int32 [3, batch] on
// the device (icos, isin, flip). Launches on `stream` (PyTorch's current
// stream) on the caller's current device, does not synchronise, allocates
// nothing, and returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssip_train_augment_u8(const void* in, void* out, int out_bf16,
                                     int batch, int h, int w,
                                     const void* coeffs, float off0,
                                     float off1, float off2, float sc0,
                                     float sc1, float sc2, void* stream) {
  const long long total = static_cast<long long>(batch) * h * w;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned int blocks =
      static_cast<unsigned int>((total + threads - 1) / threads);
  const float3 off = make_float3(off0, off1, off2);
  const float3 sc = make_float3(sc0, sc1, sc2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  const int* cf = static_cast<const int*>(coeffs);
  if (out_bf16) {
    train_augment_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        src, static_cast<__nv_bfloat16*>(out), batch, h, w, cf, off, sc);
  } else {
    train_augment_kernel<float><<<blocks, threads, 0, s>>>(
        src, static_cast<float*>(out), batch, h, w, cf, off, sc);
  }
  return static_cast<int>(cudaGetLastError());
}
