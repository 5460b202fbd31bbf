// Fused int8 MLP of the quantized ViT for Hopper. Per row of the (already
// LayerNormed) [M, D] stream, bfloat16 or float32 in, float32 out:
//   xq  = int8(clamp(rint(y * inv1), -127, 127))
//   h   = float(xq . W1q) * m1 + b1          int32 sums, then one mul, one add
//   g   = 0.5 h (1 + erf(h / sqrt 2))        erf by Abramowitz & Stegun 7.1.26
//   gq  = int8(clamp(rint(g * inv2), -127, 127))
//   out = float(gq . W2q) * m2 + b2
//
// Replaces ssip_tpu/ops/qmlp.py:_qmlp_kernel (behind quantized_mlp). The TPU
// kernel takes 256 rows a grid step, keeps both weight matrices and the whole
// [256, hidden] float32 hidden block in VMEM, and walks the grid in order. A
// Hopper block has 227 KB and the card wants hundreds of blocks, so here a
// block owns 32 rows and never holds the hidden block whole:
//
// - xq [32, D] is quantized once into shared memory;
// - the hidden width is walked in chunks of 256 columns. For a chunk the 8
//   warps compute h32 = xq . W1q[:, chunk] (each warp 32 of the columns),
//   apply dequantize, GELU and requantize in registers and leave gq
//   [32, 256] in shared memory; then every warp adds
//   gq . W2q[chunk, its D/8 output columns] into int32 sums it keeps in
//   registers for the whole kernel (D = 768: 96 registers a thread). Integer
//   addition is exact, so the chunk order changes nothing. The hidden values
//   never reach device memory.
// - both products are mma.sync.m16n8k32 on int8 with int32 sums (exact). The
//   A operand comes from shared memory (rows padded by 16 bytes, so the 8
//   rows of a fragment land in distinct banks); the B operand is read
//   straight from global memory, from weights stored [out, in] so that the 4
//   consecutive inputs of one register are one aligned 32-bit word. Each block
//   reads all of both matrices (4.5 MB at ViT-B/16); they stay in the 50 MB
//   L2 across blocks.
//
// Every float operation is a single correctly rounded one (_rn intrinsics, no
// FMA contraction, expf and not __expf), in the order the plain PyTorch
// version takes, so the two differ only where the two exps differ by an ulp
// and that moves a hidden value across a .5 tie.
//
// Bound: operations. 4 M D hidden int8 operations (238 G at [25216, 768],
// hidden 3072) against 2 M D (1 or 2) + 4 M D + 2 D hidden bytes. This
// first form is held back by the unpipelined global loads of B fragments
// (one 32-bit load for every mma); staging W tiles through shared memory with
// cp.async or TMA, and wgmma, are later work.
//
// Shapes: D 192, 384 or 768; hidden a multiple of 256; any M (the last
// block's missing rows are computed on zeros and not stored).

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;    // stream rows a block owns: 2 mma row tiles
constexpr int kChunk = 256;  // hidden columns a block works on at a time
constexpr int kPad = 16;     // bytes added to each staged row (bank spread)

// double literals rounded once to float, as numpy rounds the same constants
constexpr float kInvSqrt2 = static_cast<float>(0.7071067811865476);
constexpr float kErfP = static_cast<float>(0.3275911);
constexpr float kErfA0 = static_cast<float>(0.254829592);
constexpr float kErfA1 = static_cast<float>(-0.284496736);
constexpr float kErfA2 = static_cast<float>(1.421413741);
constexpr float kErfA3 = static_cast<float>(-1.453152027);
constexpr float kErfA4 = static_cast<float>(1.061405429);

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int8_t quantize(float v, float inv_s) {
  const float r = rintf(__fmul_rn(v, inv_s));  // half to even
  return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// GELU on the polynomial erf, one rounding per operation, in the plain
// version's order.
__device__ __forceinline__ float gelu_erf(float x) {
  const float z0 = __fmul_rn(x, kInvSqrt2);
  const float sign = z0 > 0.0f ? 1.0f : (z0 < 0.0f ? -1.0f : 0.0f);
  const float z = fabsf(z0);
  const float t = __frcp_rn(__fadd_rn(1.0f, __fmul_rn(kErfP, z)));
  float poly = __fadd_rn(__fmul_rn(kErfA4, t), kErfA3);
  poly = __fadd_rn(__fmul_rn(poly, t), kErfA2);
  poly = __fadd_rn(__fmul_rn(poly, t), kErfA1);
  poly = __fadd_rn(__fmul_rn(poly, t), kErfA0);
  poly = __fmul_rn(poly, t);
  const float e = expf(-__fmul_rn(z, z));
  const float erf = __fmul_rn(sign, __fsub_rn(1.0f, __fmul_rn(poly, e)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, erf));
}

// c += a . b for one 16 x 8 tile over 32 int8 inputs. With g = lane / 4 and
// t = lane % 4: a[0], a[1] hold rows g, g + 8 at inputs 4t..4t+3, a[2], a[3]
// the same rows at inputs 16 + 4t..; b0, b1 hold output column g at inputs
// 4t.. and 16 + 4t..; c[0], c[1] are row g at columns 2t, 2t + 1 and c[2],
// c[3] row g + 8 at the same columns.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of both row tiles at inputs k0..k0+31, from a staged
// [kRows, stride] int8 matrix.
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4],
                                       const int8_t* __restrict__ staged,
                                       int stride, int k0, int g, int t) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int8_t* p = staged + (mt * 16 + g) * stride + k0 + t * 4;
    a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
    a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * stride);
    a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
    a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * stride + 16);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    qmlp_kernel(const T* __restrict__ y, const int8_t* __restrict__ w1t,
                const float* __restrict__ m1, const float* __restrict__ b1,
                const int8_t* __restrict__ w2t, const float* __restrict__ m2,
                const float* __restrict__ b2, float* __restrict__ out,
                int m_rows, int hidden, float inv1, float inv2) {
  constexpr int XS = D + kPad;       // bytes of a staged xq row
  constexpr int GS = kChunk + kPad;  // bytes of a staged gq row
  constexpr int W1 = kChunk / kWarps;  // hidden columns a warp computes
  constexpr int W2 = D / kWarps;       // output columns a warp owns
  constexpr int NT1 = W1 / 8;
  constexpr int NT2 = W2 / 8;
  __shared__ __align__(16) int8_t xq_s[kRows * XS];
  __shared__ __align__(16) int8_t gq_s[kRows * GS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kRows;

  for (int idx = threadIdx.x; idx < kRows * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4);
    const int c = (idx - r * (D / 4)) * 4;
    char4 q = make_char4(0, 0, 0, 0);
    if (row0 + r < m_rows) {
      const T* src = y + static_cast<size_t>(row0 + r) * D + c;
      q.x = quantize(to_float(src[0]), inv1);
      q.y = quantize(to_float(src[1]), inv1);
      q.z = quantize(to_float(src[2]), inv1);
      q.w = quantize(to_float(src[3]), inv1);
    }
    *reinterpret_cast<char4*>(xq_s + r * XS + c) = q;
  }
  __syncthreads();

  int acc2[2][NT2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc2[mt][nt][i] = 0;
    }
  }

  for (int h0 = 0; h0 < hidden; h0 += kChunk) {
    // h32 = xq . W1q[:, h0 + warp * W1 ...]: this warp's W1 hidden columns
    int acc1[2][NT1][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc1[mt][nt][i] = 0;
      }
    }
    const int8_t* w1_warp =
        w1t + static_cast<size_t>(h0 + warp * W1 + g) * D + t * 4;
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 32) {
      uint32_t a[2][4];
      load_a(a, xq_s, XS, k0, g, t);
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt) {
        const int8_t* wp = w1_warp + static_cast<size_t>(nt * 8) * D + k0;
        const uint32_t f0 = __ldg(reinterpret_cast<const uint32_t*>(wp));
        const uint32_t f1 = __ldg(reinterpret_cast<const uint32_t*>(wp + 16));
        mma_s8(acc1[0][nt], a[0], f0, f1);
        mma_s8(acc1[1][nt], a[1], f0, f1);
      }
    }
    // dequantize, GELU, requantize; gq into shared memory
#pragma unroll
    for (int nt = 0; nt < NT1; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int local = warp * W1 + nt * 8 + t * 2 + i;
        const float mult = m1[h0 + local];
        const float bias = b1[h0 + local];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = mt * 16 + half * 8 + g;
            const float h = __fadd_rn(
                __fmul_rn(static_cast<float>(acc1[mt][nt][half * 2 + i]), mult),
                bias);
            gq_s[row * GS + local] = quantize(gelu_erf(h), inv2);
          }
        }
      }
    }
    __syncthreads();

    // o32 += gq . W2q[h0 .. h0 + kChunk, warp * W2 ...]
    const int8_t* w2_warp =
        w2t + static_cast<size_t>(warp * W2 + g) * hidden + h0 + t * 4;
#pragma unroll 2
    for (int k0 = 0; k0 < kChunk; k0 += 32) {
      uint32_t a[2][4];
      load_a(a, gq_s, GS, k0, g, t);
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) {
        const int8_t* wp = w2_warp + static_cast<size_t>(nt * 8) * hidden + k0;
        const uint32_t f0 = __ldg(reinterpret_cast<const uint32_t*>(wp));
        const uint32_t f1 = __ldg(reinterpret_cast<const uint32_t*>(wp + 16));
        mma_s8(acc2[0][nt], a[0], f0, f1);
        mma_s8(acc2[1][nt], a[1], f0, f1);
      }
    }
    __syncthreads();  // the next chunk rewrites gq_s
  }

#pragma unroll
  for (int nt = 0; nt < NT2; ++nt) {
    const int col = warp * W2 + nt * 8 + t * 2;
    const float2 mult = *reinterpret_cast<const float2*>(m2 + col);
    const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + mt * 16 + half * 8 + g;
        if (row < m_rows) {
          const float2 v = make_float2(
              __fadd_rn(__fmul_rn(static_cast<float>(acc2[mt][nt][half * 2]),
                                  mult.x), bias.x),
              __fadd_rn(__fmul_rn(static_cast<float>(acc2[mt][nt][half * 2 + 1]),
                                  mult.y), bias.y));
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * D + col) =
              v;
        }
      }
    }
  }
}

template <typename T, int D>
int launch(const void* y, const void* w1t, const void* m1, const void* b1,
           const void* w2t, const void* m2, const void* b2, void* out,
           int m_rows, int hidden, float inv1, float inv2,
           cudaStream_t stream) {
  const int blocks = (m_rows + kRows - 1) / kRows;
  qmlp_kernel<T, D><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const int8_t*>(w1t),
      static_cast<const float*>(m1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2t), static_cast<const float*>(m2),
      static_cast<const float*>(b2), static_cast<float*>(out), m_rows, hidden,
      inv1, inv2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_width(int d, const void* y, const void* w1t, const void* m1,
                 const void* b1, const void* w2t, const void* m2,
                 const void* b2, void* out, int m_rows, int hidden, float inv1,
                 float inv2, cudaStream_t stream) {
  switch (d) {
    case 192:
      return launch<T, 192>(y, w1t, m1, b1, w2t, m2, b2, out, m_rows, hidden,
                            inv1, inv2, stream);
    case 384:
      return launch<T, 384>(y, w1t, m1, b1, w2t, m2, b2, out, m_rows, hidden,
                            inv1, inv2, stream);
    case 768:
      return launch<T, 768>(y, w1t, m1, b1, w2t, m2, b2, out, m_rows, hidden,
                            inv1, inv2, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. y [m_rows, d] bfloat16 or float32;
// w1t int8 [hidden, d] and w2t int8 [d, hidden] (the weights with the input
// axis contiguous); m1, b1 float32 [hidden]; m2, b2 float32 [d]; out float32
// [m_rows, d]. Launches on `stream` (PyTorch's current stream) on the
// caller's current device, does not synchronise, allocates nothing, and
// returns the launch's CUDA error (0 on success).
extern "C" int ssip_quantized_mlp(const void* y, int is_bf16, const void* w1t,
                                  const void* m1, const void* b1,
                                  const void* w2t, const void* m2,
                                  const void* b2, void* out, int m_rows, int d,
                                  int hidden, float inv1, float inv2,
                                  void* stream) {
  if (m_rows == 0) return 0;
  if (hidden <= 0 || hidden % kChunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_width<__nv_bfloat16>(d, y, w1t, m1, b1, w2t, m2, b2,
                                               out, m_rows, hidden, inv1, inv2,
                                               s)
                 : launch_width<float>(d, y, w1t, m1, b1, w2t, m2, b2, out,
                                       m_rows, hidden, inv1, inv2, s);
}
