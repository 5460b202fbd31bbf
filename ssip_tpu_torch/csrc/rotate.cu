// Nearest-neighbour rotation for Hopper, uint8 in and uint8 out: a uint8 NHWC
// image batch -> horizontal flip -> rotation about the centre (zero fill),
// written NHWC as uint8. The FixMatch strong view needs the rotated pixels
// themselves (their per-image mean feeds the contrast jitter before the
// normalize), so it cannot use the fused kernel of augment.cu.
//
// Replaces ssip_tpu/ops/augment.py:_rotate_mxu_blocked (its inner Pallas
// `kernel`). The TPU kernel turns the gather into one-hot bf16 matmuls over a
// 2-D band of the source, because the TPU gathers on its scalar unit. Hopper
// gathers directly; what carries over is the 2-D band. A block owns one
// 16 x 64 output tile of one image:
//
//  1. It evaluates the int32 index map of the JAX package,
//       ay = icos*(2y-(h-1)) + isin*(2x-(w-1));  ax = -isin*(2y-(h-1)) + icos*(2x-(w-1))
//       iy = floor((ay + h*2^16) / 2^17);        ix = floor((ax + w*2^16) / 2^17)
//     at the tile's four corners. ay and ax are affine in (y, x) and the floor
//     division is monotone, so the corners give the exact smallest and largest
//     iy and ix of every pixel of the tile: the source window.
//  2. It stages that window, all three channels, from global into shared
//     memory with coalesced byte reads of whole window rows, writing zeros
//     where the window leaves the image. That replaces the zero-padded copy
//     of the batch that the JAX version makes first, and the out-of-range
//     test per pixel: a pixel whose source lies outside the image reads a
//     staged zero. A flipped image is staged from the mirrored columns, so
//     the flip costs nothing.
//  3. Each thread reads its 4 pixels from shared memory, and the block writes
//     the tile's output rows: neighbouring threads write neighbouring pixels.
//     Ragged edge tiles are masked, so any H x W is taken.
//
// The window of a rotation (icos = round(cos*2^16), isin = round(sin*2^16))
// is at most floor(15|cos| + 63|sin|) + 2 rows by floor(63|cos| + 15|sin|) + 2
// pixels: 28 x 67 x 3 = 5.6 KB at 10 degrees, 44 x 71 x 3 = 9.4 KB at 25, and
// never more than 57 x 57 x 3 = 9,747 bytes (at 44.75 degrees). So a static
// window of 10 KB holds any angle: the host neither needs an angle bound nor
// reads the coefficients back to check them. Coefficients that are no
// rotation (a map that zooms out) can ask for more: such a tile skips the
// staging and gathers from global memory, slower and as right.
//
// Bound: bytes (one uint8 read and one written per value, about 25 integer
// operations a pixel). This first form moves single bytes; 16-byte loads,
// cp.async or TMA staging and word stores are later work.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kQ = 1 << 16;
constexpr int kTileH = 16;
constexpr int kTileW = 64;
constexpr int kThreads = 256;
constexpr int kWindowBytes = 10 * 1024;  // >= 9,747: any rotation's window

// floor(a / b) for b > 0.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b < 0) ? q - 1 : q;
}

__device__ __forceinline__ int imin4(int a, int b, int c, int d) {
  return min(min(a, b), min(c, d));
}

__device__ __forceinline__ int imax4(int a, int b, int c, int d) {
  return max(max(a, b), max(c, d));
}

__global__ void __launch_bounds__(kThreads)
    rotate_u8_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                     int batch, int h, int w, int tiles_x, int tiles_y,
                     const int* __restrict__ coeffs) {
  __shared__ uint8_t window[kWindowBytes];

  const int tile_x = blockIdx.x % tiles_x;
  const int rest = blockIdx.x / tiles_x;
  const int tile_y = rest % tiles_y;
  const int b = rest / tiles_y;

  const int icos = coeffs[b];
  const int isin = coeffs[batch + b];
  const int flip = coeffs[2 * batch + b];

  // the tile's corners, inside the image
  const int y0 = tile_y * kTileH, y1 = min(y0 + kTileH, h) - 1;
  const int x0 = tile_x * kTileW, x1 = min(x0 + kTileW, w) - 1;
  const int ya = 2 * y0 - (h - 1), yb = 2 * y1 - (h - 1);
  const int xa = 2 * x0 - (w - 1), xb = 2 * x1 - (w - 1);
  const int oy = h * kQ, ox = w * kQ, den = 2 * kQ;
  const int iy_aa = floor_div(icos * ya + isin * xa + oy, den);
  const int iy_ab = floor_div(icos * ya + isin * xb + oy, den);
  const int iy_ba = floor_div(icos * yb + isin * xa + oy, den);
  const int iy_bb = floor_div(icos * yb + isin * xb + oy, den);
  const int ix_aa = floor_div(-isin * ya + icos * xa + ox, den);
  const int ix_ab = floor_div(-isin * ya + icos * xb + ox, den);
  const int ix_ba = floor_div(-isin * yb + icos * xa + ox, den);
  const int ix_bb = floor_div(-isin * yb + icos * xb + ox, den);
  const int iy_lo = imin4(iy_aa, iy_ab, iy_ba, iy_bb);
  const int iy_hi = imax4(iy_aa, iy_ab, iy_ba, iy_bb);
  const int ix_lo = imin4(ix_aa, ix_ab, ix_ba, ix_bb);
  const int ix_hi = imax4(ix_aa, ix_ab, ix_ba, ix_bb);

  // the window in stored coordinates: a flipped image keeps its mirror
  const int win_h = iy_hi - iy_lo + 1;
  const int pitch = (ix_hi - ix_lo + 1) * 3;            // bytes a window row
  const int col_lo = flip ? w - 1 - ix_hi : ix_lo;      // first stored column
  const int byte_lo = col_lo * 3;
  const int row_bytes = w * 3;
  const uint8_t* image = in + static_cast<size_t>(b) * h * row_bytes;

  // the same for every thread of the block; 64-bit: a map that is no rotation
  // can span more than int holds
  const bool staged =
      static_cast<long long>(win_h) * pitch <= static_cast<long long>(kWindowBytes);
  if (staged) {
    for (int i = threadIdx.x; i < win_h * pitch; i += kThreads) {
      const int r = i / pitch;
      const int gy = iy_lo + r;
      const int gb = byte_lo + (i - r * pitch);
      uint8_t v = 0;
      if (gy >= 0 && gy < h && gb >= 0 && gb < row_bytes) {
        v = image[static_cast<size_t>(gy) * row_bytes + gb];
      }
      window[i] = v;
    }
    __syncthreads();
  }

  uint8_t* image_out = out + static_cast<size_t>(b) * h * row_bytes;
  for (int p = threadIdx.x; p < kTileH * kTileW; p += kThreads) {
    const int y = y0 + p / kTileW;
    const int x = x0 + p % kTileW;
    if (y >= h || x >= w) continue;
    const int yy2 = 2 * y - (h - 1);
    const int xx2 = 2 * x - (w - 1);
    const int iy = floor_div(icos * yy2 + isin * xx2 + oy, den);
    const int ix = floor_div(-isin * yy2 + icos * xx2 + ox, den);
    uint8_t* o = image_out + (static_cast<size_t>(y) * w + x) * 3;
    if (staged) {
      const int col = flip ? ix_hi - ix : ix - ix_lo;
      const uint8_t* px = window + (iy - iy_lo) * pitch + col * 3;
      o[0] = px[0];
      o[1] = px[1];
      o[2] = px[2];
    } else if (iy >= 0 && iy < h && ix >= 0 && ix < w) {
      const uint8_t* px = image + (static_cast<size_t>(iy) * w + (flip ? w - 1 - ix : ix)) * 3;
      o[0] = px[0];
      o[1] = px[1];
      o[2] = px[2];
    } else {
      o[0] = o[1] = o[2] = 0;
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. `coeffs` is int32 [3, batch] on the
// device (icos, isin, flip). Launches on `stream` (PyTorch's current stream)
// on the caller's current device, does not synchronise, allocates nothing.
// Returns -1 without launching when the grid would not fit, else
// cudaGetLastError() after the launch (0 on success).
extern "C" int ssip_rotate_u8(const void* in, void* out, int batch, int h,
                              int w, const void* coeffs, void* stream) {
  if (batch == 0 || h == 0 || w == 0) return 0;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int tiles_y = (h + kTileH - 1) / kTileH;
  const long long blocks = static_cast<long long>(tiles_x) * tiles_y * batch;
  if (blocks > 0x7fffffffLL) return -1;
  rotate_u8_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), batch, h, w,
      tiles_x, tiles_y, static_cast<const int*>(coeffs));
  return static_cast<int>(cudaGetLastError());
}
