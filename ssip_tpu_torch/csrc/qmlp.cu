// The int8 MLP of the quantized ViT for Hopper, as two tiled int8 GEMMs.
// Per row of the (already LayerNormed) [M, D] stream, bfloat16 or float32
// in, float32 out:
//   xq  = int8(clamp(rint(y * inv1), -127, 127))
//   h   = float(xq . W1q) * m1 + b1          int32 sums, then one mul, one add
//   g   = 0.5 h (1 + erf(h / sqrt 2))        erf by Abramowitz & Stegun 7.1.26
//   gq  = int8(clamp(rint(g * inv2), -127, 127))
//   out = float(gq . W2q) * m2 + b2
//
// Replaces ssip_tpu/ops/qmlp.py:_qmlp_kernel (behind quantized_mlp). The TPU
// kernel keeps both weight matrices and a [256, hidden] float32 hidden block
// in VMEM and walks the row blocks in order. Here the work is two launches
// joined by the int8 hidden gq [M, hidden] in device memory (77 MB at
// [25216, 768], hidden 3072: written once, read once per output tile,
// mostly from L2):
//
// - qmlp_hidden_kernel: a block owns 64 stream rows. It quantizes them once
//   into shared memory (the A panel [64][D], rows padded by 16 bytes so the 8
//   rows an ldmatrix phase reads fall on 8 bank groups) and walks its share
//   of the hidden width in 256-column tiles, W1's tiles [256 hidden][64 in]
//   streaming through a 3-stage cp.async ring (16-byte chunks XOR-swizzled
//   by row). 8 warps, each a 32 x 64 tile: per 32 inputs 2 + 4 ldmatrix.x4
//   and 16 mma.sync.m16n8k32 s8 (int32 sums). A tile's epilogue applies the
//   affine, GELU and requantize in registers and stores gq as 8-byte rows
//   (the quad's four 2-byte pairs gathered by shuffles), while the ring
//   already holds the next tile's first steps. 2 blocks an SM; the hidden
//   width is split over blocks so that the last wave is full
//   (hidden_groups).
// - qmlp_output_kernel: a block owns a 128 x 128 tile of the output (128 x
//   64 at D 192), A (gq) and B (W2's [128 out][128 hidden] tiles) streaming
//   through a 3-stage cp.async ring; 8 warps, each 64 x 32; the epilogue
//   applies the output affine and stores float2s. The blocks of one row
//   tile are adjacent in the grid, so gq's rows are read from device memory
//   about once and W2 stays in L2.
// The tile shapes are what measured fastest among the variants of
// python -m ssip_tpu_torch.kernels.qmlp_variants (PERF.md).
//
// Every float operation is a single correctly rounded one (_rn intrinsics, no
// FMA contraction, expf and not __expf), in the order the plain PyTorch
// version takes, so the kernels and the plain versions differ only where the
// two exps differ by an ulp and that moves a hidden value across a .5 tie.
// Integer sums are exact in any order.
//
// Bound: operations. 4 M D hidden int8 operations (238 G at [25216, 768],
// hidden 3072: 0.1202 ms at 1,979 TOPS) against 2 M D (1 or 2) + 4 M D +
// 2 D hidden bytes, and the hidden's 2 M hidden bytes (0.046 ms). mma.sync
// takes its operands through registers by ldmatrix, so shared-memory
// bandwidth caps these tiles below the tensor cores' rate; the GELU
// epilogue (one polynomial, one exp and one correctly rounded reciprocal a
// hidden value: about 48 instructions, 77.5 M values, 0.125 ms of issue
// slots at best) does not overlap the products of its own block. wgmma and
// TMA, and an epilogue interleaved with the next tile's products, are later
// work.
//
// Shapes: D 192, 384 or 768; hidden a multiple of 256; any M (rows past M
// are computed on zeros and not stored); every pointer 16-byte aligned.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

using namespace ssip_mma;

constexpr int kThreads = 256;  // 8 warps, every block: 2 along the rows x 4 along the columns
constexpr int kPad = 16;       // bytes added to each A panel row (bank spread)
// qmlp_hidden_kernel: rows a block owns, hidden columns a tile, int8
// inputs a ring stage holds per row, ring stages, resident blocks an SM
constexpr int kHidRows = 64;
constexpr int kHidCols = 256;
constexpr int kHidK = 64;
constexpr int kHidStages = 3;
constexpr int kHidBlocksPerSm = 2;
// qmlp_output_kernel: output rows and columns a block owns (fewer columns
// where D is not a multiple: out_cols), hidden inputs a ring stage holds
// per row, ring stages, resident blocks an SM
constexpr int kOutRows = 128;
constexpr int kOutCols = 128;
constexpr int kOutK = 128;
constexpr int kOutStages = 3;
constexpr int kOutBlocksPerSm = 2;
constexpr int kHiddenMultiple = 256;

__host__ __device__ constexpr int out_cols(int d) {
  return d % kOutCols == 0 ? kOutCols : d % 128 == 0 ? 128 : 64;
}
// the hidden kernel's ring step at width d (64 where d is not a multiple of kHidK)
__host__ __device__ constexpr int hid_k(int d) { return d % kHidK == 0 ? kHidK : 64; }

// double literals rounded once to float, as numpy rounds the same constants
constexpr float kInvSqrt2 = static_cast<float>(0.7071067811865476);
constexpr float kErfP = static_cast<float>(0.3275911);
constexpr float kErfA0 = static_cast<float>(0.254829592);
constexpr float kErfA1 = static_cast<float>(-0.284496736);
constexpr float kErfA2 = static_cast<float>(1.421413741);
constexpr float kErfA3 = static_cast<float>(-1.453152027);
constexpr float kErfA4 = static_cast<float>(1.061405429);

// int8(clamp(rint(v * inv_s), -127, 127)) as its two's-complement byte, in
// the low 8 bits. rint is an add and a subtract of 1.5 * 2^23 (round half
// to even, exact for |x| < 2^22; a larger |x| clamps to ±127 either way),
// and the integer is read from the low mantissa bits of 1.5 * 2^23 plus it:
// four float adds and a mask on the FMA pipes, where rintf and the float to
// int conversion would take two slots of the SM's narrower conversion unit.
__device__ __forceinline__ uint32_t quantize(float v, float inv_s) {
  constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
  const float r = __fsub_rn(__fadd_rn(__fmul_rn(v, inv_s), kMagic), kMagic);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(r, -127.0f), 127.0f), kMagic)) & 0xffu;
}

// 1 / x rounded to nearest for 1 <= x < 2^100 (the erf's 1 + p z): the
// reciprocal refined by one Newton step, then corrected once by its
// residual (Markstein), which is IEEE's correctly rounded reciprocal without
// the range check whose branch to the slow path ends a basic block at every
// element.
__device__ __forceinline__ float rcp_unit(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  r = fmaf(r, fmaf(-x, r, 1.0f), r);
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

// GELU on the polynomial erf, one rounding per operation, in the plain
// version's order.
__device__ __forceinline__ float gelu_erf(float x) {
  const float z0 = __fmul_rn(x, kInvSqrt2);
  const float sign = z0 > 0.0f ? 1.0f : (z0 < 0.0f ? -1.0f : 0.0f);
  const float z = fabsf(z0);
  const float t = rcp_unit(__fadd_rn(1.0f, __fmul_rn(kErfP, z)));
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
// c[3] row g + 8 at the same columns. ldmatrix.x4 on 16-byte rows gives
// exactly these registers (addr_a, addr_b of mma_common.cuh, reading an
// int8 [rows][64] tile as bf16 [rows][32]).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block stages `ROWS` rows of BK int8 inputs from `src` (rows `pitch`
// bytes apart, from input `k0`) into a [ROWS][BK] tile, its 16-byte chunks
// swizzled by row (swz<BK / 2>: the tile read as bf16 [ROWS][BK / 2]);
// rows at or past `valid` are zeros.
template <int ROWS, int BK>
__device__ __forceinline__ void stage_tile(bf16* dst, const int8_t* src, size_t pitch, int k0,
                                           int valid) {
  constexpr int CH = BK / 16;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
    const int r = idx / CH, c = idx % CH;
    const bool live = r < valid;
    const int8_t* g = live ? src + r * pitch + k0 + 16 * c : src;
    cp_async16(dst + swz<BK / 2>(r, c), g, live);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// Eight inputs of one row, quantized, as two words (input 0 in the lowest byte).
template <typename T>
__device__ __forceinline__ uint2 quantize8(const T* src, float inv) {
  alignas(16) T v[8];
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
    reinterpret_cast<uint4*>(v)[0] = __ldg(reinterpret_cast<const uint4*>(src));
    reinterpret_cast<uint4*>(v)[1] = __ldg(reinterpret_cast<const uint4*>(src) + 1);
  }
  uint32_t w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    w[h] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[h] |= quantize(to_float(v[4 * h + i]), inv) << (8 * i);
    }
  }
  return make_uint2(w[0], w[1]);
}

// Shared memory of qmlp_hidden_kernel, in bytes: the A panel [kHidRows][D +
// 16] int8, then the ring of W1 tiles [kHidCols][hid_k(D)] int8.
template <int D>
struct HidLayout {
  static constexpr int pitch = D + kPad;
  static constexpr size_t panel = static_cast<size_t>(kHidRows) * pitch;
  static constexpr int k = hid_k(D);  // ring step
  static constexpr size_t tile = static_cast<size_t>(kHidCols) * k;
  static constexpr size_t bytes = panel + kHidStages * tile;
};

// Grid: (row blocks, hidden groups); a block works hidden tiles
// blockIdx.y, blockIdx.y + gridDim.y, ... of kHidCols columns.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kHidBlocksPerSm)
    qmlp_hidden_kernel(const T* __restrict__ y, const int8_t* __restrict__ w1t,
                       const float* __restrict__ m1, const float* __restrict__ b1,
                       int8_t* __restrict__ gq, int m_rows, int hidden, float inv1,
                       float inv2) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = HidLayout<D>;
  constexpr int BK = L::k;
  constexpr int KS = D / BK;          // ring steps a hidden tile
  constexpr int MT = kHidRows / 32;   // a warp's m16 tiles
  constexpr int NT = kHidCols / 32;   // its n8 tiles
  constexpr int WN = kHidCols / 4;    // its columns
  static_assert(D % BK == 0 && NT % 4 == 0, "tile shapes");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // the warp's (kHidRows / 2) x WN tile
  const int row0 = blockIdx.x * kHidRows;
  const int valid = min(kHidRows, m_rows - row0);
  int8_t* panel = reinterpret_cast<int8_t*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + L::panel);
  constexpr int TILE = static_cast<int>(L::tile / 2);  // bf16 units

  const int tiles = hidden / kHidCols;
  const int my_tiles = (tiles - static_cast<int>(blockIdx.y) + static_cast<int>(gridDim.y) - 1) /
                       static_cast<int>(gridDim.y);
  const int nsteps = my_tiles * KS;
  auto tile_col = [&](int step) {
    return (static_cast<int>(blockIdx.y) + (step / KS) * static_cast<int>(gridDim.y)) * kHidCols;
  };
  auto stage = [&](int step) {
    stage_tile<kHidCols, BK>(ring + (step % kHidStages) * TILE, w1t + static_cast<size_t>(tile_col(step)) * D,
                                D, (step % KS) * BK, kHidCols);
  };
#pragma unroll
  for (int s = 0; s < kHidStages - 1; ++s) {
    if (s < nsteps) stage(s);
    cp_async_commit();
  }

  // The A panel: the block's rows quantized once, 8 inputs a thread at a
  // time, four loads in flight.
  constexpr int CH = D / 8;
  for (int idx0 = threadIdx.x; idx0 < kHidRows * CH; idx0 += 4 * kThreads) {
    uint2 q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = idx0 + u * kThreads;
      const int r = idx / CH, c = idx - r * CH;
      q[u] = make_uint2(0u, 0u);
      if (idx < kHidRows * CH && r < valid) {
        q[u] = quantize8(y + static_cast<size_t>(row0 + r) * D + 8 * c, inv1);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = idx0 + u * kThreads;
      const int r = idx / CH, c = idx - r * CH;
      if (idx < kHidRows * CH) *reinterpret_cast<uint2*>(panel + r * L::pitch + 8 * c) = q[u];
    }
  }

  int acc[MT][NT][4];
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<kHidStages - 2>();
    __syncthreads();  // this step staged (and the panel written); the oldest stage free
    if (step + kHidStages - 1 < nsteps) stage(step + kHidStages - 1);
    cp_async_commit();
    const int kk = step % KS;
    if (kk == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
      }
    }
    const bf16* b_s = ring + (step % kHidStages) * TILE;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[MT][4], b[NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = (kHidRows / 2) * wm + 16 * mt + (lane & 15);
        ldsm_x4(a[mt], smem_addr(panel + r * L::pitch + kk * BK + 32 * ks + 16 * (lane >> 4)));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) ldsm_x4(b[np], addr_b<BK / 2>(b_s, WN * wn + 16 * np, ks, lane));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          mma_s8(acc[mt][2 * np], a[mt], b[np][0], b[np][1]);
          mma_s8(acc[mt][2 * np + 1], a[mt], b[np][2], b[np][3]);
        }
      }
    }
    if (kk == KS - 1) {
      // Epilogue of this hidden tile: dequantize, GELU, requantize; in each
      // group of 4 n tiles lane t of a quad gathers the quad's 2-byte pairs
      // of n tile t and stores them as 8 bytes.
      const int col0 = tile_col(step) + WN * wn;
#pragma unroll
      for (int n4 = 0; n4 < NT / 4; ++n4) {
        float2 mult[4], bias[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mult[j] = __ldg(reinterpret_cast<const float2*>(m1 + col0 + 32 * n4 + 8 * j + 2 * t));
          bias[j] = __ldg(reinterpret_cast<const float2*>(b1 + col0 + 32 * n4 + 8 * j + 2 * t));
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t pair[4];  // n tile 4 n4 + j's bytes at columns 2t, 2t + 1
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float h0 =
                  __fadd_rn(__fmul_rn(static_cast<float>(acc[mt][4 * n4 + j][2 * half]), mult[j].x), bias[j].x);
              const float h1 =
                  __fadd_rn(__fmul_rn(static_cast<float>(acc[mt][4 * n4 + j][2 * half + 1]), mult[j].y), bias[j].y);
              pair[j] = quantize(gelu_erf(h0), inv2) | (quantize(gelu_erf(h1), inv2) << 8);
            }
            // round r: lane t sends its pair of n tile (t + r) & 3 and
            // receives the pair of n tile t from lane s = (t - r) & 3, which
            // is columns 2s, 2s + 1 of that tile: bytes 2s, 2s + 1 of the 8
            uint32_t lo = 0, hi = 0;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int send = (t + r) & 3, s = (t - r) & 3;
              const uint32_t mine = send == 0 ? pair[0] : send == 1 ? pair[1] : send == 2 ? pair[2] : pair[3];
              const uint32_t got = __shfl_sync(0xffffffffu, mine, (lane & ~3) | s);
              lo |= s < 2 ? got << (16 * s) : 0u;
              hi |= s < 2 ? 0u : got << (16 * (s - 2));
            }
            const int row = row0 + (kHidRows / 2) * wm + 16 * mt + 8 * half + g;
            if (row < m_rows) {
              *reinterpret_cast<uint2*>(gq + static_cast<size_t>(row) * hidden + col0 + 32 * n4 + 8 * t) =
                  make_uint2(lo, hi);
            }
          }
        }
      }
    }
  }
}

// Shared memory of qmlp_output_kernel, in bytes: each stage an A tile
// [kOutRows][kOutK] int8 and a B tile [BN][kOutK] int8.
template <int BN>
struct OutLayout {
  static constexpr size_t a_tile = static_cast<size_t>(kOutRows) * kOutK;
  static constexpr size_t stage = a_tile + static_cast<size_t>(BN) * kOutK;
  static constexpr size_t bytes = kOutStages * stage;
};

// Grid: row tiles x (D / BN) column tiles, the column tiles of a row tile
// adjacent.
template <int D, int BN>
__global__ void __launch_bounds__(kThreads, kOutBlocksPerSm)
    qmlp_output_kernel(const int8_t* __restrict__ gq, const int8_t* __restrict__ w2t,
                       const float* __restrict__ m2, const float* __restrict__ b2,
                       float* __restrict__ out, int m_rows, int hidden) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = OutLayout<BN>;
  constexpr int NCOL = D / BN;
  constexpr int WN = BN / 4;         // a warp's output columns
  constexpr int MT = kOutRows / 32;  // its m16 tiles
  constexpr int NT = WN / 8;         // its n8 tiles
  static_assert(D % BN == 0 && NT % 2 == 0, "tile shapes");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // the warp's (kOutRows / 2) x WN tile
  const int row0 = (blockIdx.x / NCOL) * kOutRows;
  const int col0 = (blockIdx.x % NCOL) * BN;
  const int valid = min(kOutRows, m_rows - row0);
  const int8_t* a_g = gq + static_cast<size_t>(row0) * hidden;
  const int8_t* b_g = w2t + static_cast<size_t>(col0) * hidden;
  const int nsteps = hidden / kOutK;
  auto stage = [&](int step) {
    unsigned char* st = smem + (step % kOutStages) * L::stage;
    stage_tile<kOutRows, kOutK>(reinterpret_cast<bf16*>(st), a_g, hidden, step * kOutK, valid);
    stage_tile<BN, kOutK>(reinterpret_cast<bf16*>(st + L::a_tile), b_g, hidden, step * kOutK, BN);
  };
#pragma unroll
  for (int s = 0; s < kOutStages - 1; ++s) {
    if (s < nsteps) stage(s);
    cp_async_commit();
  }

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<kOutStages - 2>();
    __syncthreads();  // this step staged; the oldest stage free
    if (step + kOutStages - 1 < nsteps) stage(step + kOutStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (step % kOutStages) * L::stage;
    const bf16* a_s = reinterpret_cast<const bf16*>(st);
    const bf16* b_s = reinterpret_cast<const bf16*>(st + L::a_tile);
#pragma unroll
    for (int ks = 0; ks < kOutK / 32; ++ks) {
      uint32_t a[MT][4], b[NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldsm_x4(a[mt], addr_a<kOutK / 2>(a_s, (kOutRows / 2) * wm + 16 * mt, ks, lane));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) ldsm_x4(b[np], addr_b<kOutK / 2>(b_s, WN * wn + 16 * np, ks, lane));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          mma_s8(acc[mt][2 * np], a[mt], b[np][0], b[np][1]);
          mma_s8(acc[mt][2 * np + 1], a[mt], b[np][2], b[np][3]);
        }
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = col0 + WN * wn + 8 * nt + 2 * t;
    const float2 mult = __ldg(reinterpret_cast<const float2*>(m2 + col));
    const float2 bias = __ldg(reinterpret_cast<const float2*>(b2 + col));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + (kOutRows / 2) * wm + 16 * mt + 8 * half + g;
        if (row < m_rows) {
          const float2 v = make_float2(
              __fadd_rn(__fmul_rn(static_cast<float>(acc[mt][nt][2 * half]), mult.x), bias.x),
              __fadd_rn(__fmul_rn(static_cast<float>(acc[mt][nt][2 * half + 1]), mult.y), bias.y));
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * D + col) = v;
        }
      }
    }
  }
}

// Hidden groups of a hidden launch: the divisor g of the tile count that
// gives the shortest run, counted as waves of resident blocks
// (ceil(row_blocks g / slots)) times the tiles each block works (tiles / g);
// the smallest g among equals, since each group quantizes its rows again.
// At [25216, 768], hidden 3072: 394 row blocks on 264 slots run 2 waves of
// 12 tiles with g = 1 and 3 waves of 6 with g = 2.
int hidden_groups(int row_blocks, int tiles) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    sms = 132;
  }
  const long long slots = static_cast<long long>(sms) * kHidBlocksPerSm;
  int best = 1;
  long long best_time = LLONG_MAX;
  for (int g = 1; g <= tiles; ++g) {
    if (tiles % g != 0) continue;
    const long long waves = (static_cast<long long>(row_blocks) * g + slots - 1) / slots;
    const long long time = waves * (tiles / g);
    if (time < best_time) best = g, best_time = time;
  }
  return best;
}

template <typename T, int D>
int launch_hidden(const void* y, const void* w1t, const void* m1, const void* b1, void* gq,
                  int m_rows, int hidden, float inv1, float inv2, cudaStream_t stream) {
  const size_t bytes = HidLayout<D>::bytes;
  cudaError_t err = allow_smem(qmlp_hidden_kernel<T, D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (m_rows + kHidRows - 1) / kHidRows;
  const dim3 grid(row_blocks, hidden_groups(row_blocks, hidden / kHidCols));
  qmlp_hidden_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(y), static_cast<const int8_t*>(w1t), static_cast<const float*>(m1),
      static_cast<const float*>(b1), static_cast<int8_t*>(gq), m_rows, hidden, inv1, inv2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_output(const void* gq, const void* w2t, const void* m2, const void* b2, void* out,
                  int m_rows, int hidden, cudaStream_t stream) {
  constexpr int BN = out_cols(D);
  const size_t bytes = OutLayout<BN>::bytes;
  cudaError_t err = allow_smem(qmlp_output_kernel<D, BN>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((m_rows + kOutRows - 1) / kOutRows) * (D / BN);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  qmlp_output_kernel<D, BN><<<static_cast<int>(blocks), kThreads, bytes, stream>>>(
      static_cast<const int8_t*>(gq), static_cast<const int8_t*>(w2t),
      static_cast<const float*>(m2), static_cast<const float*>(b2), static_cast<float*>(out),
      m_rows, hidden);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int hidden_width(int d, const void* y, const void* w1t, const void* m1, const void* b1, void* gq,
                 int m_rows, int hidden, float inv1, float inv2, cudaStream_t stream) {
  switch (d) {
    case 192: return launch_hidden<T, 192>(y, w1t, m1, b1, gq, m_rows, hidden, inv1, inv2, stream);
    case 384: return launch_hidden<T, 384>(y, w1t, m1, b1, gq, m_rows, hidden, inv1, inv2, stream);
    case 768: return launch_hidden<T, 768>(y, w1t, m1, b1, gq, m_rows, hidden, inv1, inv2, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points, bound with ctypes. They launch on `stream`
// (PyTorch's current stream) on the caller's current device, do not
// synchronise, allocate nothing, and return the launch's CUDA error (0 on
// success).
//
// The first half: y [m_rows, d] bfloat16 or float32; w1t int8 [hidden, d]
// (W1 with the input axis contiguous); m1, b1 float32 [hidden]; gq int8
// [m_rows, hidden], the requantized GELU of the hidden layer.
extern "C" int ssip_qmlp_hidden(const void* y, int is_bf16, const void* w1t, const void* m1,
                                const void* b1, void* gq, int m_rows, int d, int hidden,
                                float inv1, float inv2, void* stream) {
  if (m_rows == 0) return 0;
  if (m_rows < 0 || hidden <= 0 || hidden % kHiddenMultiple != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? hidden_width<bf16>(d, y, w1t, m1, b1, gq, m_rows, hidden, inv1, inv2, s)
                 : hidden_width<float>(d, y, w1t, m1, b1, gq, m_rows, hidden, inv1, inv2, s);
}

// The second half: gq int8 [m_rows, hidden]; w2t int8 [d, hidden]; m2, b2
// float32 [d]; out float32 [m_rows, d].
extern "C" int ssip_qmlp_output(const void* gq, const void* w2t, const void* m2, const void* b2,
                                void* out, int m_rows, int d, int hidden, void* stream) {
  if (m_rows == 0) return 0;
  if (m_rows < 0 || hidden <= 0 || hidden % kHiddenMultiple != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 192: return launch_output<192>(gq, w2t, m2, b2, out, m_rows, hidden, s);
    case 384: return launch_output<384>(gq, w2t, m2, b2, out, m_rows, hidden, s);
    case 768: return launch_output<768>(gq, w2t, m2, b2, out, m_rows, hidden, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// For measurement: `which` 0 (hidden, bfloat16 stream) or 1 (output) at
// width `d`; out[4] = registers a thread, local bytes a thread (spills),
// shared memory bytes a block, resident blocks an SM. Returns the CUDA error
// (0 on success).
extern "C" int ssip_qmlp_info(int which, int d, int* out) {
  if (which == 0) {
    switch (d) {
      case 192: return kernel_info(qmlp_hidden_kernel<bf16, 192>, kThreads, HidLayout<192>::bytes, out);
      case 384: return kernel_info(qmlp_hidden_kernel<bf16, 384>, kThreads, HidLayout<384>::bytes, out);
      case 768: return kernel_info(qmlp_hidden_kernel<bf16, 768>, kThreads, HidLayout<768>::bytes, out);
    }
  } else if (which == 1) {
    switch (d) {
      case 192: return kernel_info(qmlp_output_kernel<192, out_cols(192)>, kThreads, OutLayout<out_cols(192)>::bytes, out);
      case 384: return kernel_info(qmlp_output_kernel<384, out_cols(384)>, kThreads, OutLayout<out_cols(384)>::bytes, out);
      case 768: return kernel_info(qmlp_output_kernel<768, out_cols(768)>, kThreads, OutLayout<out_cols(768)>::bytes, out);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
