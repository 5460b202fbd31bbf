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
// Bound: bytes. At [128, 512, 512, 3] -> 256 -> 224 the crop's taps reach
// 450 x 450 of each image's 512 x 512 pixels: 77.8 MB read, and 38.5 MB of
// bfloat16 written (77.1 MB float32, 19.3 MB int8), against about 16
// float operations an output value. So the design reads each source byte
// once, in 16-byte transactions, and does each pass once:
//
//  1. The host's band plan (ops/preproc.py:band_plan) cuts the crop into
//     bands of `rows` output rows by `cols` output columns (the full width
//     where it fits) and gives each band row its source rows and each band
//     column its source columns: the band's source window, and the shared
//     memory a block needs. A block is persistent (the grid is one wave)
//     and walks the bands of the batch; it stages its next band's window
//     with 16-byte cp.async, each window row from the 16-byte-aligned
//     address at or below its first byte, while it computes this one (two
//     window buffers). The tap tables (BandPlan.tables: each output
//     column's and row's weights, their addends, its first source index
//     relative to its band's window and its tap count) are read through L1.
//  2. The horizontal pass runs once per (source row, output column,
//     channel) of the band, from the staged window: ascending taps j,
//     t = __fadd_rn(t, x_j * w_j), then clip8, the result stored in shared
//     memory as uint8 (an integer in [0, 255], so nothing is lost). A thread
//     owns an output column, or in the unrolled form a pair of them, and
//     walks the window's rows; it reads a column's 12 bytes (4 taps x 3
//     channels) as 4 words funnel-shifted into 3, and where the pair's taps
//     overlap by two pixels (a downscale by 2) one set of 18 bytes serves
//     both columns.
//  3. The vertical pass reads those bytes, in the same order, then the
//     epilogue; each thread owns a run of consecutive pixels of one output
//     row that is 48 bytes of output (16 int8, 8 bf16 or 4 float32 pixels
//     of 3 channels), in chunks of at most 24 values, read from the pass
//     buffer in 8- or 4-byte words and written with three 16-byte stores
//     (element by element where the output row pitch is no multiple of 16
//     bytes or the run passes the crop's edge).
//  4. Where every column and every row has at most 4 taps of weights >= 0
//     that sum to at most 1 + 2^-10 (any downscale by up to 2, so
//     512 -> 256, and every upscale, of the triangle filter), both passes
//     unroll over 4 taps with the weights padded by zeros (a zero weight
//     adds +0, which leaves every sum as it was) and clip8 drops its
//     clamps, which cannot bind there (0 <= t < 255.5); elsewhere the taps
//     are counted loops. A plan that fits no band in shared memory (a
//     source far larger than the crop's taps can stage) runs one thread an
//     output pixel from global memory instead (preproc_pixel_kernel).
//
// What holds it back (kernels/resample_variants.py, PERF.md): the window
// staging alone takes about a third of the time, the two passes' float
// work (a byte extraction, a product and a sum a tap and value, kept as
// two roundings for the bits) the rest, and the two overlap only in part.
//
// Arithmetic, kept bitwise to the first form of this kernel: a byte x
// enters a product as the float 2^23 + x (its bits 0x4B000000 | x), and
// fma(2^23 + x, w, -2^23 w) is x*w rounded once, exactly __fmul_rn(x, w);
// clip8 is floor(t + 0.5) clamped to [0, 255], here __fadd_rn(t, 0.5)
// added to 2^23 rounding down, clamped to [2^23, 2^23 + 255], whose low
// byte is the result; the normalize is one __fsub_rn and one __fmul_rn;
// int8 adds 1.5 * 2^23 to v * inv_s (round half to even, like rintf),
// clamps to +-127 and keeps the low byte. For 512 -> 256 -> 224 every tap
// weight is dyadic (1/8, 3/8), every partial sum is exact, and the result
// is bitwise the plain PyTorch version's; other sizes hold to one uint8
// step before the normalize.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

using namespace ssip_mma;  // cp.async, pack_bf16, store_run, put_elem, allow_smem, kernel_info

constexpr int kThreads = 256;
constexpr float kMagic = 8388608.0f;     // 2^23
constexpr float kMagicQ = 12582912.0f;   // 1.5 * 2^23

// The launch's constant part of the band plan (ops/preproc.py:BandPlan).
struct Plan {
  int rows, cols;          // output rows and columns a band
  int src_rows;            // most source rows a band reads
  int src_pitch;           // bytes of a window row's slot
  int h_rows, h_pitch;     // rows and row bytes of the horizontal pass's buffer
  int n_row_bands, n_col_bands, bands;  // bands: of the batch
  int kh, kv;              // taps a table entry holds (4 when unrolled)
  int h_stride, v_stride;  // int32 words a table entry
};

struct Epilogue {
  float off[3], sc[3], inv_s;
};

// Byte k of `word` as the float 2^23 + byte.
__device__ __forceinline__ float magic(uint32_t word, int k) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, k | 0x7540));
}

__device__ __forceinline__ float magic_byte(uint8_t v) {
  return __uint_as_float(0x4B000000u | v);
}

// x * w rounded once, for a byte x given as 2^23 + x: __fmul_rn(x, w).
__device__ __forceinline__ float tap(float m, float w) {
  return __fmaf_rn(m, w, __fmul_rn(w, -kMagic));
}

// clip8(t) as 2^23 + clip8(t): its low byte is the uint8 value.
__device__ __forceinline__ float clip8_magic(float t) {
  const float r = __fadd_rd(__fadd_rn(t, 0.5f), kMagic);
  return fminf(fmaxf(r, kMagic), kMagic + 255.0f);
}

// The same where the plan has proved the clamps inactive (the unrolled
// form: every weight >= 0 and every entry's weights sum to at most
// 1 + 2^-10, so 0 <= t < 255.5).
__device__ __forceinline__ float clip8_free(float t) {
  return __fadd_rd(__fadd_rn(t, 0.5f), kMagic);
}

// N aligned words holding the bytes at byte offset o of a shared row: N + 1
// word loads and N funnel shifts.
template <int N>
__device__ __forceinline__ void load_bytes(uint32_t (&a)[N], const uint8_t* row, int o) {
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(row) + (o >> 2);
  uint32_t w[N + 1];
#pragma unroll
  for (int k = 0; k <= N; ++k) w[k] = wp[k];
  const uint32_t sh = 8u * (o & 3);
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = __funnelshift_r(w[k], w[k + 1], sh);
}

// The horizontal pass of one output column over 4 taps, its pixels' bytes
// from byte B of `a` on: the three channels' uint8 results into o8.
template <int B, int N>
__device__ __forceinline__ void column4(uint8_t* o8, const uint32_t (&a)[N], const float (&w)[4],
                                        const float (&nw)[4]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float t = __fmaf_rn(magic(a[(B + ch) >> 2], (B + ch) & 3), w[0], nw[0]);
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      const int byte = B + 3 * j + ch;
      t = __fadd_rn(t, __fmaf_rn(magic(a[byte >> 2], byte & 3), w[j], nw[j]));
    }
    o8[ch] = static_cast<uint8_t>(__float_as_uint(clip8_free(t)));
  }
}

// The int8 value of v as the low byte of the bits returned.
__device__ __forceinline__ uint32_t quantize_bits(float v, float inv_s) {
  const float r = __fadd_rn(__fmul_rn(v, inv_s), kMagicQ);
  return __float_as_uint(fminf(fmaxf(r, kMagicQ - 127.0f), kMagicQ + 127.0f));
}

template <typename T>
__device__ __forceinline__ uint32_t to_bits(float v, float inv_s);

template <>
__device__ __forceinline__ uint32_t to_bits<float>(float v, float) {
  return __float_as_uint(v);
}

template <>
__device__ __forceinline__ uint32_t to_bits<__nv_bfloat16>(float v, float) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <>
__device__ __forceinline__ uint32_t to_bits<int8_t>(float v, float inv_s) {
  return quantize_bits(v, inv_s) & 0xFFu;
}

// N normalized values of a run as their N * sizeof(T) bytes of output.
template <typename T, int N>
__device__ __forceinline__ void pack_run(uint32_t* words, const float (&v)[N], float inv_s) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < N; ++e) words[e] = __float_as_uint(v[e]);
  } else if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) words[k] = pack_bf16(v[2 * k], v[2 * k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const uint32_t lo = __byte_perm(quantize_bits(v[4 * k], inv_s), quantize_bits(v[4 * k + 1], inv_s), 0x0040);
      const uint32_t hi =
          __byte_perm(quantize_bits(v[4 * k + 2], inv_s), quantize_bits(v[4 * k + 3], inv_s), 0x0040);
      words[k] = __byte_perm(lo, hi, 0x5410);
    }
  }
}

// Words of the horizontal pass a vertical chunk reads from one row: 3 loads
// of 2 or 1 words (24 or 12 bytes).
template <int N>
struct Vec;
template <>
struct Vec<2> {
  using type = uint2;
  __device__ static void put(uint32_t* w, uint2 v) { w[0] = v.x; w[1] = v.y; }
};
template <>
struct Vec<1> {
  using type = uint32_t;
  __device__ static void put(uint32_t* w, uint32_t v) { w[0] = v; }
};

// Band `id` of the batch: image, band row, band column.
struct Band {
  int b, rb, cb;
  __device__ Band(int id, Plan p) {
    cb = id % p.n_col_bands;
    const int rest = id / p.n_col_bands;
    rb = rest % p.n_row_bands;
    b = rest / p.n_row_bands;
  }
};

// Issues the cp.async copies of band `id`'s source window into `dst`: each
// warp a row at a time, each lane 16-byte chunks. Every chunk holds a byte
// of the window, so it lies in the image's pages.
__device__ __forceinline__ void stage_window(uint8_t* dst, const uint8_t* in, int h, int w,
                                             const int* __restrict__ row_bands,
                                             const int* __restrict__ col_bands, int id, Plan p) {
  const Band band(id, p);
  const int row_bytes = 3 * w;
  const int rs = row_bands[2 * band.rb], nr = row_bands[2 * band.rb + 1];
  const int cs = col_bands[2 * band.cb], nc = col_bands[2 * band.cb + 1];
  const uint8_t* image = in + static_cast<size_t>(band.b) * h * row_bytes;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nr; r += kThreads / 32) {
    const uintptr_t start = reinterpret_cast<uintptr_t>(image + static_cast<size_t>(rs + r) * row_bytes + 3 * cs);
    const uintptr_t a0 = start & ~static_cast<uintptr_t>(15);
    const int chunks = static_cast<int>((start + 3 * nc - a0 + 15) >> 4);
    uint8_t* slot = dst + r * p.src_pitch;
    for (int k = lane; k < chunks; k += 32) {
      cp_async16(slot + 16 * k, reinterpret_cast<const void*>(a0 + 16u * k), true);
    }
  }
}

// The band kernel. Tap tables (ops/preproc.py:BandPlan.tables), one entry
// an output column (h_tab) or row (v_tab), read through L1: the weights
// padded with zeros to kh (kv), their addends -2^23 w, the first source
// index relative to the band's window and the tap count. Shared memory: two
// window buffers of src_rows slots, then the horizontal pass's buffer.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    preproc_band_kernel(const uint8_t* __restrict__ in, T* __restrict__ out, int h, int w, int crop,
                        const int* __restrict__ row_bands, const int* __restrict__ col_bands,
                        const int* __restrict__ h_tab, const int* __restrict__ v_tab, Plan p, Epilogue epi) {
  constexpr int kPixels = 48 / (3 * static_cast<int>(sizeof(T)));  // a vertical run
  constexpr int kVals = 3 * kPixels;                                // its values: bytes of a pass row
  constexpr int kChunk = kVals < 24 ? kVals : 24;                   // values the vertical pass holds at once
  constexpr int kLoad = kChunk / 12;                                // words a load, 3 loads a chunk
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int window = p.src_rows * p.src_pitch;
  uint8_t* const hbuf = smem_raw + 2 * window;
  const int row_bytes = 3 * w;
  const int rb16 = row_bytes & 15;

  int id = blockIdx.x;
  if (id < p.bands) stage_window(smem_raw, in, h, w, row_bands, col_bands, id, p);
  cp_async_commit();
  for (int step = 0; id < p.bands; id += gridDim.x, ++step) {
    const int next = id + gridDim.x;
    if (next < p.bands) {
      stage_window(smem_raw + ((step + 1) & 1) * window, in, h, w, row_bands, col_bands, next, p);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this band's window is in place
    const Band band(id, p);
    const int oy0 = band.rb * p.rows, ox0 = band.cb * p.cols;
    const int nrows = min(p.rows, crop - oy0), ncols = min(p.cols, crop - ox0);
    const int rs = row_bands[2 * band.rb], nr = row_bands[2 * band.rb + 1];
    const int cs = col_bands[2 * band.cb];

    // horizontal pass: a thread owns an output column (the counted form)
    // or a pair of them (the unrolled form), all three channels, and walks
    // the window rows part, part + parts, ...
    const uint8_t* src = smem_raw + (step & 1) * window;
    const uintptr_t first =
        reinterpret_cast<uintptr_t>(in) + (static_cast<size_t>(band.b) * h + rs) * row_bytes + 3 * cs;
    const int lead = static_cast<int>(first & 15);
    if (K == 4) {
      {
        // a thread owns the pair of output columns 2m, 2m + 1
        const int pairs = (ncols + 1) >> 1;
        int m = threadIdx.x, part = 0, parts = 1;
        if (pairs < kThreads) {
          parts = kThreads / pairs;
          part = threadIdx.x / pairs;
          m = part < parts ? threadIdx.x - part * pairs : pairs;
        }
        for (; m < pairs; m += kThreads) {
          const int c0 = 2 * m;
          const bool two = c0 + 1 < ncols;
          const int* e0 = h_tab + (ox0 + c0) * p.h_stride;
          const int* e1 = two ? e0 + p.h_stride : e0;
          float w0[4], n0[4], w1[4], n1[4];
          {
            const float4 a = __ldg(reinterpret_cast<const float4*>(e0));
            const float4 b = __ldg(reinterpret_cast<const float4*>(e0 + 4));
            const float4 c = __ldg(reinterpret_cast<const float4*>(e1));
            const float4 d = __ldg(reinterpret_cast<const float4*>(e1 + 4));
            w0[0] = a.x; w0[1] = a.y; w0[2] = a.z; w0[3] = a.w;
            n0[0] = b.x; n0[1] = b.y; n0[2] = b.z; n0[3] = b.w;
            w1[0] = c.x; w1[1] = c.y; w1[2] = c.z; w1[3] = c.w;
            n1[0] = d.x; n1[1] = d.y; n1[2] = d.z; n1[3] = d.w;
          }
          const int hs0 = 3 * __ldg(e0 + 8), hs1 = 3 * __ldg(e1 + 8);
          // the pair's taps overlap by two pixels (a downscale by 2): one
          // set of 18 bytes serves both columns
          const bool shared = two && hs1 == hs0 + 6;
#pragma unroll 2
          for (int r = part; r < nr; r += parts) {
            const uint8_t* row = src + r * p.src_pitch;
            const int lead_r = (lead + r * rb16) & 15;
            uint8_t* o8 = hbuf + r * p.h_pitch + 3 * c0;
            if (shared) {
              uint32_t a[5];
              load_bytes<5>(a, row, lead_r + hs0);
              column4<0>(o8, a, w0, n0);
              column4<6>(o8 + 3, a, w1, n1);
            } else {
              uint32_t a[3];
              load_bytes<3>(a, row, lead_r + hs0);
              column4<0>(o8, a, w0, n0);
              if (two) {
                load_bytes<3>(a, row, lead_r + hs1);
                column4<0>(o8 + 3, a, w1, n1);
              }
            }
          }
        }
      }
    } else {
      int c = threadIdx.x, part = 0, parts = 1;
      if (ncols < kThreads) {
        parts = kThreads / ncols;
        part = threadIdx.x / ncols;
        c = part < parts ? threadIdx.x - part * ncols : ncols;
      }
      for (; c < ncols; c += kThreads) {
        const int* e = h_tab + (ox0 + c) * p.h_stride;
        {
          const float* wc = reinterpret_cast<const float*>(e);
          const float* nc = wc + p.kh;
          const int hs3 = 3 * __ldg(e + 2 * p.kh);
          const int n = __ldg(e + 2 * p.kh + 1);
          for (int r = part; r < nr; r += parts) {
            const uint8_t* px = src + r * p.src_pitch + ((lead + r * rb16) & 15) + hs3;
            float t0 = __fmaf_rn(magic_byte(px[0]), __ldg(wc), __ldg(nc));
            float t1 = __fmaf_rn(magic_byte(px[1]), __ldg(wc), __ldg(nc));
            float t2 = __fmaf_rn(magic_byte(px[2]), __ldg(wc), __ldg(nc));
            for (int j = 1; j < n; ++j) {
              const float wj = __ldg(wc + j), nj = __ldg(nc + j);
              t0 = __fadd_rn(t0, __fmaf_rn(magic_byte(px[3 * j + 0]), wj, nj));
              t1 = __fadd_rn(t1, __fmaf_rn(magic_byte(px[3 * j + 1]), wj, nj));
              t2 = __fadd_rn(t2, __fmaf_rn(magic_byte(px[3 * j + 2]), wj, nj));
            }
            uint8_t* o8 = hbuf + r * p.h_pitch + 3 * c;
            o8[0] = static_cast<uint8_t>(__float_as_uint(clip8_magic(t0)));
            o8[1] = static_cast<uint8_t>(__float_as_uint(clip8_magic(t1)));
            o8[2] = static_cast<uint8_t>(__float_as_uint(clip8_magic(t2)));
          }
        }
      }
    }
    __syncthreads();  // the horizontal pass is complete

    // vertical pass and epilogue: (output row r, run q of kPixels pixels)
    {
      const int runs = (ncols + kPixels - 1) / kPixels;
      int r = threadIdx.x / runs, q = threadIdx.x - r * runs;
      const int dr = kThreads / runs, dq = kThreads - dr * runs;
      for (; r < nrows;) {
        const int n = min(kPixels, ncols - q * kPixels);
        const int* e = v_tab + (oy0 + r) * p.v_stride;
        int vs, taps;
        float wi[4], ni[4];
        if (K == 4) {
          const float4 wt = __ldg(reinterpret_cast<const float4*>(e));
          const float4 nt = __ldg(reinterpret_cast<const float4*>(e + 4));
          wi[0] = wt.x; wi[1] = wt.y; wi[2] = wt.z; wi[3] = wt.w;
          ni[0] = nt.x; ni[1] = nt.y; ni[2] = nt.z; ni[3] = nt.w;
          vs = __ldg(e + 8);
          taps = 4;
        } else {
          vs = __ldg(e + 2 * p.kv);
          taps = __ldg(e + 2 * p.kv + 1);
        }
        uint32_t out_words[12];
        // the run in chunks of at most 24 values (int8: two), which bounds
        // the registers a thread holds
#pragma unroll
        for (int chunk = 0; chunk < kVals / kChunk; ++chunk) {
          const uint8_t* col = hbuf + q * kVals + chunk * kChunk;
          float acc[kChunk];
#pragma unroll
          for (int i = 0; i < (K == 4 ? 4 : taps); ++i) {
            const float w_i = K == 4 ? wi[i] : __ldg(reinterpret_cast<const float*>(e) + i);
            const float n_i = K == 4 ? ni[i] : __ldg(reinterpret_cast<const float*>(e) + p.kv + i);
            uint32_t words[kChunk / 4];
            using V = Vec<kLoad>;
            const typename V::type* row = reinterpret_cast<const typename V::type*>(col + (vs + i) * p.h_pitch);
#pragma unroll
            for (int k = 0; k < 3; ++k) V::put(words + k * kLoad, row[k]);
#pragma unroll
            for (int v = 0; v < kChunk; ++v) {
              const float prod = __fmaf_rn(magic(words[v >> 2], v & 3), w_i, n_i);
              acc[v] = i == 0 ? prod : __fadd_rn(acc[v], prod);
            }
          }
          float vals[kChunk];
#pragma unroll
          for (int v = 0; v < kChunk; ++v) {
            const int ch = (chunk * kChunk + v) % 3;
            const float y = __fsub_rn(K == 4 ? clip8_free(acc[v]) : clip8_magic(acc[v]), kMagic);
            vals[v] = __fmul_rn(__fsub_rn(y, epi.off[ch]), epi.sc[ch]);
          }
          pack_run<T>(out_words + chunk * (kChunk * static_cast<int>(sizeof(T)) / 4), vals, epi.inv_s);
        }
        T* dst = out + ((static_cast<size_t>(band.b) * crop + oy0 + r) * crop + ox0 + q * kPixels) * 3;
        store_run(dst, out_words, 3 * n);
        q += dq;
        r += dr;
        if (q >= runs) {
          q -= runs;
          ++r;
        }
      }
    }
    __syncthreads();  // the pass buffer and this window are free again
  }
}

// One thread an output pixel (b, oy, ox), all three channels, every tap
// read from global memory: for a plan that fits no band in shared memory.
template <typename T>
__global__ void preproc_pixel_kernel(const uint8_t* __restrict__ in, T* __restrict__ out, int batch, int h,
                                     int w, int crop, const int* __restrict__ v_start,
                                     const int* __restrict__ v_count, const float* __restrict__ v_w, int kv,
                                     const int* __restrict__ h_start, const int* __restrict__ h_count,
                                     const float* __restrict__ h_w, int kh, Epilogue epi) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  if (ox >= crop) return;
  const int hs = h_start[ox], hn = h_count[ox];
  const float* hwt = h_w + static_cast<size_t>(ox) * kh;
  const int vs = v_start[oy], vn = v_count[oy];
  const float* vwt = v_w + static_cast<size_t>(oy) * kv;
  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    const uint8_t* img = in + static_cast<size_t>(b) * h * w * 3;
    float y[3] = {0.0f, 0.0f, 0.0f};
    for (int i = 0; i < vn; ++i) {
      const uint8_t* px = img + (static_cast<size_t>(vs + i) * w + hs) * 3;
      float t[3] = {0.0f, 0.0f, 0.0f};
      for (int j = 0; j < hn; ++j) {
        const float wj = hwt[j];
#pragma unroll
        for (int c = 0; c < 3; ++c) t[c] = __fadd_rn(t[c], tap(magic_byte(px[3 * j + c]), wj));
      }
      const float wi = vwt[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) y[c] = __fadd_rn(y[c], __fmul_rn(__fsub_rn(clip8_magic(t[c]), kMagic), wi));
    }
    uint32_t words[12] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = __fmul_rn(__fsub_rn(__fsub_rn(clip8_magic(y[c]), kMagic), epi.off[c]), epi.sc[c]);
      put_elem<T>(words, c, to_bits<T>(v, epi.inv_s));
    }
    store_run(out + ((static_cast<size_t>(b) * crop + oy) * crop + ox) * 3, words, 3);
  }
}

template <typename T, int K>
int launch_bands(const void* in, void* out, int h, int w, int crop, const int* tabs, const int* plan, const Plan& p,
                 size_t smem, int grid, const Epilogue& epi, cudaStream_t stream) {
  const auto kernel = preproc_band_kernel<T, K>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const uint8_t*>(in), static_cast<T*>(out), h, w, crop, tabs,
                                           tabs + 2 * p.n_row_bands, tabs + plan[13], tabs + plan[14], p, epi);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pixels(const void* in, void* out, int batch, int h, int w, int crop, const void* const* tables, int kv,
                  int kh, const Epilogue& epi, cudaStream_t stream) {
  const dim3 grid((crop + 127) / 128, crop, batch < 65535 ? batch : 65535);
  preproc_pixel_kernel<T><<<grid, 128, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<T*>(out), batch, h, w, crop,
      static_cast<const int*>(tables[0]), static_cast<const int*>(tables[1]), static_cast<const float*>(tables[2]),
      kv, static_cast<const int*>(tables[3]), static_cast<const int*>(tables[4]),
      static_cast<const float*>(tables[5]), kh, epi);
  return static_cast<int>(cudaGetLastError());
}

// plan: int32 [17] on the host, ops/preproc.py:BandPlan.header(): rows,
// cols, taps (4 or 0), src_rows, src_pitch, h_rows, h_pitch, n_row_bands,
// n_col_bands, kh, kv, shared-memory bytes, grid, then the offsets of the
// column and row tap tables in `tabs` and their entries' strides (int32
// words); rows 0 means no band fits and the pixel kernel runs. tabs: int32
// on the device, BandPlan.tables(): the row bands' (first source row, rows),
// the column bands' (first column, columns), then the two tap tables.
template <typename T>
int launch_kind(const void* in, void* out, int batch, int h, int w, int crop, const void* const* tables, int kv,
                int kh, const int* plan, const void* bands, const Epilogue& epi, cudaStream_t stream) {
  if (plan[0] == 0) return launch_pixels<T>(in, out, batch, h, w, crop, tables, kv, kh, epi, stream);
  Plan p;
  p.rows = plan[0];
  p.cols = plan[1];
  p.src_rows = plan[3];
  p.src_pitch = plan[4];
  p.h_rows = plan[5];
  p.h_pitch = plan[6];
  p.n_row_bands = plan[7];
  p.n_col_bands = plan[8];
  p.kh = plan[9];
  p.kv = plan[10];
  p.h_stride = plan[15];
  p.v_stride = plan[16];
  const long long bands_total = static_cast<long long>(batch) * p.n_row_bands * p.n_col_bands;
  if (bands_total > 0x7fffffffLL) return -1;
  p.bands = static_cast<int>(bands_total);
  const size_t smem = static_cast<size_t>(plan[11]);
  const int grid = plan[12] < p.bands ? plan[12] : p.bands;  // one wave, at most a block a band
  const int* tabs = static_cast<const int*>(bands);
  return plan[2] == 4 ? launch_bands<T, 4>(in, out, h, w, crop, tabs, plan, p, smem, grid, epi, stream)
                      : launch_bands<T, 0>(in, out, h, w, crop, tabs, plan, p, smem, grid, epi, stream);
}

int launch_preprocess(const void* in, void* out, int out_kind, int batch, int h, int w, int crop,
                      const void* v_start, const void* v_count, const void* v_w, int kv, const void* h_start,
                      const void* h_count, const void* h_w, int kh, const Epilogue& epi, const int* plan,
                      const void* bands, void* stream) {
  if (static_cast<long long>(batch) * crop == 0) return 0;
  const void* tables[6] = {v_start, v_count, v_w, h_start, h_count, h_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_kind == 2) return launch_kind<int8_t>(in, out, batch, h, w, crop, tables, kv, kh, plan, bands, epi, s);
  if (out_kind == 1) {
    return launch_kind<__nv_bfloat16>(in, out, batch, h, w, crop, tables, kv, kh, plan, bands, epi, s);
  }
  return launch_kind<float>(in, out, batch, h, w, crop, tables, kv, kh, plan, bands, epi, s);
}

}  // namespace

// Plain C entry points, bound with ctypes. They launch on `stream` (PyTorch's
// current stream) on the caller's current device, do not synchronise,
// allocate nothing, leave the current device as it was, and return -1
// without launching when the batch has more bands than a launch takes, else
// cudaGetLastError() after the launch (0 on success). `plan` and `bands`
// are the band plan (launch_kind above).
extern "C" int ssip_preprocess_u8(const void* in, void* out, int out_bf16, int batch, int h, int w, int crop,
                                  const void* v_start, const void* v_count, const void* v_w, int kv,
                                  const void* h_start, const void* h_count, const void* h_w, int kh, float off0,
                                  float off1, float off2, float sc0, float sc1, float sc2, const int* plan,
                                  const void* bands, void* stream) {
  const Epilogue epi{{off0, off1, off2}, {sc0, sc1, sc2}, 1.0f};
  return launch_preprocess(in, out, out_bf16 ? 1 : 0, batch, h, w, crop, v_start, v_count, v_w, kv, h_start,
                           h_count, h_w, kh, epi, plan, bands, stream);
}

// The same chain with the int8 epilogue: `out` is int8 [B, crop, crop, 3].
extern "C" int ssip_preprocess_u8_quant(const void* in, void* out, int batch, int h, int w, int crop,
                                        const void* v_start, const void* v_count, const void* v_w, int kv,
                                        const void* h_start, const void* h_count, const void* h_w, int kh,
                                        float off0, float off1, float off2, float sc0, float sc1, float sc2,
                                        float inv_s, const int* plan, const void* bands, void* stream) {
  const Epilogue epi{{off0, off1, off2}, {sc0, sc1, sc2}, inv_s};
  return launch_preprocess(in, out, 2, batch, h, w, crop, v_start, v_count, v_w, kv, h_start, h_count, h_w, kh,
                           epi, plan, bands, stream);
}

// What the card makes of the band kernel for output kind `out_kind` (0
// float32, 1 bfloat16, 2 int8) and `taps` (4 or 0) at `smem` bytes of
// dynamic shared memory: out[4] = registers, local bytes, shared memory a
// block, resident blocks an SM (ssip_mma::kernel_info). 0 on success.
extern "C" int ssip_preprocess_info(int out_kind, int taps, int smem, int* out) {
  const size_t dyn = static_cast<size_t>(smem);
  if (out_kind == 2) {
    return taps == 4 ? kernel_info(preproc_band_kernel<int8_t, 4>, kThreads, dyn, out)
                     : kernel_info(preproc_band_kernel<int8_t, 0>, kThreads, dyn, out);
  }
  if (out_kind == 1) {
    return taps == 4 ? kernel_info(preproc_band_kernel<__nv_bfloat16, 4>, kThreads, dyn, out)
                     : kernel_info(preproc_band_kernel<__nv_bfloat16, 0>, kThreads, dyn, out);
  }
  return taps == 4 ? kernel_info(preproc_band_kernel<float, 4>, kThreads, dyn, out)
                   : kernel_info(preproc_band_kernel<float, 0>, kThreads, dyn, out);
}
