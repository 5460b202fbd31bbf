// Nearest-neighbour rotation for Hopper, one body with two epilogues: a uint8
// NHWC image batch -> horizontal flip -> rotation about the centre (zero
// fill), written NHWC as
//   - uint8 (`ssip_rotate_u8`, ops/rotate.py:rotate_images): replaces
//     ssip_tpu/ops/augment.py:_rotate_mxu_blocked (its inner Pallas
//     `kernel`); the FixMatch strong view needs the rotated pixels themselves;
//   - float32 or bfloat16 ImageNet-normalized (`ssip_train_augment_u8`,
//     ops/rotate.py:augment_images): replaces ssip_tpu/ops/augment.py:_rotate_mxu
//     (its inner Pallas `kernel`) and fuses the flip before it and the
//     normalize after it: the whole of train_augment.
// The TPU kernels turn the gather into one-hot bf16 matmuls over a band of
// the source, because the TPU gathers on its scalar unit. Hopper gathers
// directly; what carries over is the band.
//
// Bound: bytes. At [128, 224, 224, 3] the function reads 19.3 MB of uint8
// and writes 19.3 MB (uint8), 38.5 MB (bf16) or 77.1 MB (float32) against
// about 20 integer and float operations a pixel. So the design keeps every
// byte moving in wide transactions and the per-pixel work small:
//
//  1. The grid indexes tile column, tile row and image directly
//     (blockIdx.x, .y, .z; a batch past 65,535 images walks by gridDim.z):
//     no division. A block owns an output tile of RotTile<T>::kH rows by
//     kW pixels, and each of its 256 threads at most one run of consecutive
//     pixels of one output row that is 48 bytes of output: 16 uint8, 8 bf16
//     or 4 float32 pixels of 3 channels.
//  2. The index map is the JAX package's, in int32:
//       ay = icos*(2y-(h-1)) + isin*(2x-(w-1)) + h*2^16,  iy = ay >> 17
//       ax = -isin*(2y-(h-1)) + icos*(2x-(w-1)) + w*2^16, ix = ax >> 17
//     (an arithmetic shift of an int32 is floor(./2^17) exactly). ay and ax
//     are affine in (y, x) and the floor is monotone, so the map at the
//     tile's four corners gives the exact smallest and largest iy and ix of
//     every pixel of the tile: the source window. Along a run, ay and ax
//     step by 2*isin and 2*icos, in place of a multiply a pixel. The
//     wrapper's index bound keeps every term of a pixel in the image inside
//     int32; the steps past the image's right edge wrap in unsigned
//     arithmetic and are never read.
//  3. Each warp stages window rows: each row from the 16-byte-aligned
//     address at or below its first byte, in 16-byte cp.async chunks, the
//     chunks that lie wholly outside the image row zero-filled by cp.async
//     itself and the (at most two) chunks that straddle its edges byte by
//     byte with zeros outside. A row outside the image is all zeros. So a
//     pixel whose source leaves the image reads a staged zero, with no test
//     a pixel. A flipped image is staged from its mirrored columns, so the
//     flip costs nothing. Row r of the window starts at byte
//     (image + iy*row_bytes + first byte) & 15 of its slot, a slot being
//     16 * ceil((15 + 3*cols) / 16) bytes.
//  4. Each thread gathers its run's 3 bytes a pixel from shared memory,
//     applies the epilogue, packs the run's 48 bytes into 12 words and
//     writes them with three 16-byte stores. Where the row pitch is no
//     multiple of 16 bytes (W = 36 gives 108 bytes in uint8) or the run
//     passes the image's right edge, it writes element by element. Any
//     H x W is taken, down to 5 x 3.
//
// The window of a tile of kH x kW at coefficients (icos, isin) has at most
// floor(((kH-1)|icos| + (kW-1)|isin|) / 2^16) + 2 rows and
// floor(((kH-1)|isin| + (kW-1)|icos|) / 2^16) + 2 columns. Over every angle
// the largest, slots included, is kWindowBytes below (ops/rotate.py:
// largest_window_bytes computes it; tests/test_torch_rotate.py holds the
// constants to it): 34,272 bytes for 32 x 112 and for 16 x 128 (102 x 102
// pixels at about 45 degrees), 11,328 for 16 x 64. So a static window holds
// any angle: the host neither needs an angle bound nor reads the
// coefficients back. Coefficients that are no rotation (a map that zooms
// out) can ask for more; such a tile skips the staging and gathers from
// global memory, slower and as right.
//
// The epilogue of the float forms is (v - off_c) * sc_c by one __fsub_rn
// and one __fmul_rn, so nvcc cannot contract them into an FMA: bitwise the
// plain PyTorch version in float32, and bfloat16 is that value rounded to
// nearest even. The uint8 form copies the bytes, bitwise by construction.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

using namespace ssip_mma;  // cp.async, store_run, put_elem

constexpr int kQ = 1 << 16;
constexpr int kThreads = 256;

// A block's output tile (rows, pixels) and its static source window, for
// each output type; a thread's run is 48 bytes of output. The shapes are
// measured (kernels/resample_variants.py): at [128, 224, 224, 3] wide flat
// tiles were fastest in every type, and uint8 runs 2 tiles to the 224-pixel
// row (7 runs of 16 pixels, 224 of the 256 threads).
template <typename T>
struct RotTile;
template <>
struct RotTile<uint8_t> {
  static constexpr int kH = 32, kW = 112, kWindowBytes = 34272;
};
template <>
struct RotTile<__nv_bfloat16> {
  static constexpr int kH = 16, kW = 128, kWindowBytes = 34272;
};
template <>
struct RotTile<float> {
  static constexpr int kH = 16, kW = 64, kWindowBytes = 11328;
};

// The source byte as stored: uint8 copies it; the float forms normalize it.
struct Normalize {
  float off[3], sc[3];
};

template <typename T>
__device__ __forceinline__ uint32_t epilogue(uint32_t v, int c, const Normalize& n);

template <>
__device__ __forceinline__ uint32_t epilogue<uint8_t>(uint32_t v, int, const Normalize&) {
  return v;
}

// v as a float, exactly: 2^23 + v as bits, less 2^23
__device__ __forceinline__ float byte_to_float(uint32_t v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.0f);
}

template <>
__device__ __forceinline__ uint32_t epilogue<float>(uint32_t v, int c, const Normalize& n) {
  return __float_as_uint(__fmul_rn(__fsub_rn(byte_to_float(v), n.off[c]), n.sc[c]));
}

template <>
__device__ __forceinline__ uint32_t epilogue<__nv_bfloat16>(uint32_t v, int c, const Normalize& n) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(__fsub_rn(byte_to_float(v), n.off[c]), n.sc[c])));
}

__device__ __forceinline__ int imin4(int a, int b, int c, int d) {
  return min(min(a, b), min(c, d));
}

__device__ __forceinline__ int imax4(int a, int b, int c, int d) {
  return max(max(a, b), max(c, d));
}

// Window row r (image row gy) from global into its shared slot `dst` of
// `chunks` 16-byte chunks starting at the aligned address `a0`; bytes
// outside [row, row + row_bytes) are zeros. One warp, lane by lane.
__device__ __forceinline__ void stage_row(uint8_t* dst, uintptr_t a0, int chunks, uintptr_t row,
                                          int row_bytes, int lane) {
  const uintptr_t row_end = row + row_bytes;
  for (int k = lane; k < chunks; k += 32) {
    const uintptr_t a = a0 + 16u * k;
    if (a >= row && a + 16 <= row_end) {
      cp_async16(dst + 16 * k, reinterpret_cast<const void*>(a), true);
    } else if (a + 16 <= row || a >= row_end) {
      cp_async16(dst + 16 * k, reinterpret_cast<const void*>(row), false);  // 16 zeros
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (a + j >= row && a + j < row_end) {
          w[j >> 2] |= static_cast<uint32_t>(*reinterpret_cast<const uint8_t*>(a + j)) << (8 * (j & 3));
        }
      }
      *reinterpret_cast<uint4*>(dst + 16 * k) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rotate_kernel(const uint8_t* __restrict__ in, T* __restrict__ out, int batch, int h, int w,
                  const int* __restrict__ coeffs, Normalize norm) {
  using Tile = RotTile<T>;
  constexpr int kPixels = 48 / (3 * static_cast<int>(sizeof(T)));  // a run
  constexpr int kRuns = Tile::kW / kPixels;                        // runs an output row
  static_assert(Tile::kW % kPixels == 0, "a tile row is whole runs");
  __shared__ __align__(16) uint8_t window[Tile::kWindowBytes];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_bytes = w * 3;
  const int y0 = blockIdx.y * Tile::kH, x0 = blockIdx.x * Tile::kW;
  const int y1 = min(y0 + Tile::kH, h) - 1, x1 = min(x0 + Tile::kW, w) - 1;
  const int ya = 2 * y0 - (h - 1), yb = 2 * y1 - (h - 1);
  const int xa = 2 * x0 - (w - 1), xb = 2 * x1 - (w - 1);
  const int oy = h * kQ, ox = w * kQ;

  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    const int icos = coeffs[b];
    const int isin = coeffs[batch + b];
    const int flip = coeffs[2 * batch + b];

    // the tile's corners give the window
    const int iy_lo = imin4((icos * ya + isin * xa + oy) >> 17, (icos * ya + isin * xb + oy) >> 17,
                            (icos * yb + isin * xa + oy) >> 17, (icos * yb + isin * xb + oy) >> 17);
    const int iy_hi = imax4((icos * ya + isin * xa + oy) >> 17, (icos * ya + isin * xb + oy) >> 17,
                            (icos * yb + isin * xa + oy) >> 17, (icos * yb + isin * xb + oy) >> 17);
    const int ix_lo = imin4((-isin * ya + icos * xa + ox) >> 17, (-isin * ya + icos * xb + ox) >> 17,
                            (-isin * yb + icos * xa + ox) >> 17, (-isin * yb + icos * xb + ox) >> 17);
    const int ix_hi = imax4((-isin * ya + icos * xa + ox) >> 17, (-isin * ya + icos * xb + ox) >> 17,
                            (-isin * yb + icos * xa + ox) >> 17, (-isin * yb + icos * xb + ox) >> 17);

    // the window in stored coordinates: a flipped image keeps its mirror
    const int win_h = iy_hi - iy_lo + 1;
    const int cols = ix_hi - ix_lo + 1;
    const int pitch = (15 + 3 * cols + 15) & ~15;  // a slot: the row's bytes after up to 15 of alignment
    const int col_lo = flip ? w - 1 - ix_hi : ix_lo;  // first stored column
    const uint8_t* image = in + static_cast<size_t>(b) * h * row_bytes;
    // where window row r's bytes start in global memory, mod 16: (lead + iy * rb16) & 15
    const uintptr_t first = reinterpret_cast<uintptr_t>(image) + static_cast<intptr_t>(3 * col_lo);
    const int lead = static_cast<int>(first & 15), rb16 = row_bytes & 15;
    // the same for every thread of the block; 64-bit: a map that is no
    // rotation can span more than int holds
    const bool staged = static_cast<long long>(win_h) * pitch <= Tile::kWindowBytes;
    if (staged) {
      for (int r = warp; r < win_h; r += kThreads / 32) {
        const int gy = iy_lo + r;
        uint8_t* slot = window + r * pitch;
        if (gy < 0 || gy >= h) {
          for (int k = lane; k < pitch / 16; k += 32) cp_async16(slot + 16 * k, image, false);
          continue;
        }
        const uintptr_t row = reinterpret_cast<uintptr_t>(image) + static_cast<size_t>(gy) * row_bytes;
        const uintptr_t start = row + static_cast<intptr_t>(3 * col_lo);
        const uintptr_t a0 = start & ~static_cast<uintptr_t>(15);
        const int chunks = static_cast<int>((start + 3 * cols - a0 + 15) >> 4);
        stage_row(slot, a0, chunks, row, row_bytes, lane);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }

    T* image_out = out + static_cast<size_t>(b) * h * row_bytes;
    for (int run = threadIdx.x; run < Tile::kH * kRuns; run += kThreads) {
      const int y = y0 + run / kRuns;
      const int x = x0 + (run % kRuns) * kPixels;
      if (y >= h || x >= w) continue;
      const int n = min(kPixels, w - x);
      const int yy2 = 2 * y - (h - 1), xx2 = 2 * x - (w - 1);
      uint32_t ay = static_cast<uint32_t>(icos * yy2 + isin * xx2 + oy);
      uint32_t ax = static_cast<uint32_t>(-isin * yy2 + icos * xx2 + ox);
      const uint32_t day = 2u * static_cast<uint32_t>(isin), dax = 2u * static_cast<uint32_t>(icos);
      uint32_t words[12] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
      for (int p = 0; p < kPixels; ++p) {
        if (p < n) {
          const int iy = static_cast<int>(ay) >> 17;
          const int ix = static_cast<int>(ax) >> 17;
          uint32_t v0 = 0u, v1 = 0u, v2 = 0u;
          if (staged) {
            const int col = flip ? ix_hi - ix : ix - ix_lo;
            const uint8_t* px = window + (iy - iy_lo) * pitch + ((lead + iy * rb16) & 15) + 3 * col;
            v0 = px[0];
            v1 = px[1];
            v2 = px[2];
          } else if (iy >= 0 && iy < h && ix >= 0 && ix < w) {
            const uint8_t* px = image + static_cast<size_t>(iy) * row_bytes + 3 * (flip ? w - 1 - ix : ix);
            v0 = px[0];
            v1 = px[1];
            v2 = px[2];
          }
          put_elem<T>(words, 3 * p + 0, epilogue<T>(v0, 0, norm));
          put_elem<T>(words, 3 * p + 1, epilogue<T>(v1, 1, norm));
          put_elem<T>(words, 3 * p + 2, epilogue<T>(v2, 2, norm));
        }
        ay += day;
        ax += dax;
      }
      store_run(image_out + (static_cast<size_t>(y) * w + x) * 3, words, 3 * n);
    }
    if (staged) __syncthreads();  // the window is free for the next image
  }
}

template <typename T>
int launch(const void* in, void* out, int batch, int h, int w, const void* coeffs, const Normalize& norm,
           void* stream) {
  using Tile = RotTile<T>;
  if (batch == 0 || h == 0 || w == 0) return 0;
  const dim3 grid((w + Tile::kW - 1) / Tile::kW, (h + Tile::kH - 1) / Tile::kH, batch < 65535 ? batch : 65535);
  if (grid.y > 65535u) return -1;
  rotate_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<T*>(out), batch, h, w, static_cast<const int*>(coeffs), norm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. `coeffs` is int32 [3, batch] on
// the device (icos, isin, flip). They launch on `stream` (PyTorch's current
// stream) on the caller's current device, do not synchronise, allocate
// nothing, and return -1 without launching when the image is too tall for
// the grid, else cudaGetLastError() after the launch (0 on success).
extern "C" int ssip_rotate_u8(const void* in, void* out, int batch, int h, int w, const void* coeffs,
                              void* stream) {
  return launch<uint8_t>(in, out, batch, h, w, coeffs, Normalize{}, stream);
}

extern "C" int ssip_train_augment_u8(const void* in, void* out, int out_bf16, int batch, int h, int w,
                                     const void* coeffs, float off0, float off1, float off2, float sc0,
                                     float sc1, float sc2, void* stream) {
  const Normalize norm{{off0, off1, off2}, {sc0, sc1, sc2}};
  return out_bf16 ? launch<__nv_bfloat16>(in, out, batch, h, w, coeffs, norm, stream)
                  : launch<float>(in, out, batch, h, w, coeffs, norm, stream);
}
