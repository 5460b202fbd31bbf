// Multi-head softmax attention in float32 on Hopper's tensor cores, forward
// and backward: the float32 forms behind ssip_attention_qkv_fwd/_bwd (packed
// qkv [B, S, 3D], columns [3, H, Dh], keys at or past kv_len masked) and
// ssip_attention_fwd/_bwd (q, k, v [B·H, S, Dh] apart), one set of kernels
// for both. attention.cu keeps the C entry points.
//
//   attn_f32_fwd_kernel replaces, in float32,
//     ssip_tpu/ops/attention.py:_attn_qkv_kernel     (packed, fused_attention_qkv)
//     ssip_tpu/ops/attention.py:_attn_kernel         (apart, fused_attention)
//   attn_f32_bwd_rows_kernel (dq) and attn_f32_bwd_keys_kernel (dk, dv) replace
//     ssip_tpu/ops/attention.py:_attn_qkv_bwd_kernel (packed, its VJP)
//     ssip_tpu/ops/attention.py:_attn_bwd_kernel     (apart, its VJP)
//
// Function, per (image, head): s = (q kT) * scale with the scale applied
// after the float32 sum; keys at or past kv get -inf; p = softmax(s) in
// float32, never rounded (the packed pair rounds p and ds to the input type,
// a no-op in float32); o = p v summed in float32. All S query rows are
// written, pad rows included. Backward, from dO: dp = dO vT, delta = the row
// sum of dp p, ds = p (dp - delta), dq = ds k * scale, dk = dsT q * scale,
// dv = pT dO; key rows at or past kv get zeros. Nothing is rounded in
// between, so the kernels sum in their own order, and the forward's softmax
// is the online form: a running max and sum per row, the accumulator
// rescaled when the max moves, o times 1/sum at the end. The scale, folded
// with log2(e), enters each exponent by one FMA, 2^(s scale log2(e) - max
// scale log2(e)), by ex2.approx (about 2 ulp).
//
// Products: 3xTF32 on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
// One TF32 product keeps 11 bits of each operand: a score is then off by
// about 1e-3 and outputs leave the 2e-5 float32 gate, gradients the 1e-5 of
// their largest entry (tests/test_torch_attention.py emulates both forms on
// a CPU). So every operand x is split in registers: hi = x with its low 13
// bits cleared (its TF32 truncation), lo = x - hi (exact, under 2^-10 of x),
// of which the tensor core reads the TF32 truncation too; hi + lo holds x to
// about 2^-21 of itself. A product a b is three mma into one float32
// accumulator, the small terms first: a_lo b_hi + a_hi b_lo + a_hi b_hi
// (a_lo b_lo, under 2^-20 of the product, is left out). The tensor core's
// products of TF32 operands are exact, its sums float32. The split is two
// instructions, a LOP3 and an FADD; cvt.rna.tf32.f32 (rounding hi to
// nearest) put the forward at 0.68 ms against 0.42 at [128, 12, 197, 64] on
// an H100, held back by the conversion's throughput (python -m
// ssip_tpu_torch.kernels.attention_variants --f32; PERF.md). The rows a
// warp keeps (its 16 rows of q, of q and dO, or of k and v) stay as loaded,
// in registers or shared memory, and are split a step at a time, the
// streamed ones as each warp loads them, once a step (hi/lo planes in shared
// memory would double it and cost occupancy), and p and ds as they leave the
// scores' accumulator: they are never rounded to fewer bits. The tensor core
// truncates its float32 sums, so the backward sums each tile's products
// apart and adds them to its accumulators by rounded float32 adds
// (`add_weighted`).
//
// Fragments come by 16-byte shared loads, not ldmatrix (which moves 16-bit
// elements; a B operand's k index is its row):
// - A sum over d does not care about its order, so scores take d permuted:
//   of the two k steps over d = 16kk .. 16kk+15, lane (g, t) holds k = t and
//   t+4 of the first as d = 16kk+4t and +1, of the second as 16kk+4t+2 and
//   +3. The kept rows' A fragments are then one float4 of row g and one of
//   row g+8, the streamed rows' B fragments one float4 of row g: one load
//   serves two k steps (`scores`).
// - The scores' accumulator gives lane (g, t) columns 2t, 2t+1 of each
//   8-column slice, where the next product's A fragment wants k = t and t+4.
//   The order inside each slice is relabelled, k = t as column 2t and k = t+4
//   as column 2t+1, so the accumulator registers are the A fragment as they
//   stand (no shuffle, no trip through shared memory), and the B operand is
//   read with the same permutation: rows 2t and 2t+1, column g. Its columns
//   are relabelled too: n tile i of a 32-column group takes column 4j + i as
//   its column j, so lane g reads one float4 (columns 4g .. 4g+3) for 4 n
//   tiles, and the output lane (g, t) holds is columns 8t .. 8t+7 of rows g
//   and g+8: two float4 stores a row and group (`weighted`, `store_rows`).
//   The forward's P·V, the rows kernel's dS·K and the keys kernel's pT·dO and
//   dsT·Q are all this one product. (tests/test_torch_attention.py checks
//   these maps, the keys kernel's transposed ones and the swizzle lane by
//   lane.)
// - Streamed rows reach shared memory by 16-byte cp.async with their chunks
//   XOR-swizzled by the row (swz32), so that the 8 lanes of each phase of a
//   16-byte load fall on 8 bank groups in both reads.
//
// Forward: a block per (batch·head, 64 query rows), 4 warps, 16 rows a warp.
// K and V stream in 64-key tiles through two cp.async stages (2 x 2 x 64 x
// Dh x 4 bytes: 64 KB at Dh 64), the next tile in flight while one is
// worked, one barrier a tile, so shared memory does not grow with S and 3
// blocks fit on an SM. Full tiles are worked with their bounds as constants;
// only the last, ragged tile branches. Measured on an H100 at [128, 12, 197,
// 64] and 256 tokens, no variant was faster: 2 blocks an SM (206 registers,
// no spills) +2.5-4 %, 3 stages +8-10 %, every tile through the ragged path
// +7-11 % at 256 tokens, the mma of 2, 4 or 8 n tiles interleaved within
// 2.5 %. Given a `stats` pointer (autograd's forward) it also writes each
// query row's -max scale log2(e) and 1/sum, [B·H][2][S16] float32, for the
// backward.
//
// Backward: two launches and no atomics, so the same inputs give the same
// bits. In float32 o is never rounded, so delta = sum_j dp p = dO · o to
// float32 accuracy, and with the forward's max and sum p needs no second
// sweep: the backward does 7 products of 2·B·H·S²·Dh (the forward's 2 and a
// two-sweep statistics pass would make it 9).
// - attn_f32_bwd_rows_kernel, a block per (batch·head, 32 query rows), its
//   q and dO rows kept in shared memory; delta = dO · o by a quad reduction,
//   written to the caller's [B·H][S16] scratch; K and V stream in 32-key
//   tiles through two cp.async stages. Per tile: s = q kT and dp = dO vT,
//   p = 2^(s scale log2(e) - max ...) / sum from the saved statistics (0 at
//   keys past kv), ds = p (dp - delta), dq += ds K. dq is written times the
//   scale.
// - attn_f32_bwd_keys_kernel, a block per (batch·head, 32 key rows), its k
//   and v rows kept in shared memory; q, dO and the three row statistics
//   stream in 32-query tiles. Per tile: sT = k qT and dpT = v dOT, pT and
//   dsT from the statistics (0 at queries past S), dv += pT dO, dk += dsT Q.
//   dk is written times the scale; key rows at or past kv get zeros.
// - With a single key (kv 1) p is 1 and ds exactly 0, as in the plain
//   version; both kernels set ds so rather than keep dp - delta's rounding.
// - Blocks of 2 warps (32 rows) and tiles of 32 rows, 4 blocks an SM: at
//   197 tokens the last block of a head holds 5 rows, one live warp, and
//   the last tile 5 rows; with 4-warp blocks and 64-row tiles (2 blocks an
//   SM; the accumulators take 187 and 228 registers) those cost a quarter
//   of the grid and the backward took 1.74 ms at [128, 12, 197, 64] against
//   1.43 (but 1.77 against 1.95 at 256 tokens, where nothing is ragged; an
//   H100, python -m ssip_tpu_torch.kernels.attention_variants --f32). The
//   ragged last tile is worked 16 columns a step, as many as it has rows.
//
// Bound on this card at [128, 12, 197, 64]: forward q, k, v read once and o
// written once are 310 MB, 0.0925 ms at 3.35 TB/s; 4·B·H·S²·Dh = 15.26
// GFLOP, three TF32 products each, 0.0925 ms at 495 TFLOP/s. Backward: 10
// B·H·S²·Dh = 38.15 GFLOP, 0.2312 ms as 3xTF32 (its bytes 0.162 ms).
//
// Shapes: Dh 32 or 64, 1 <= kv <= S, any S: every array in shared memory
// is a fixed tile, each row offset is formed in size_t, the statistics and
// delta are [B·H][S16] per part and the grid is checked against INT_MAX
// (blocks_for). Every pointer 16-byte aligned (the wrapper checks) and every
// row pitch a multiple of 4 floats.

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

using namespace ssip_mma;

constexpr int kWarps = 4;  // of a forward block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of a forward block
constexpr int kTile = 64;           // keys of the forward's streamed tile
constexpr int kStages = 2;          // shared-memory stages of the streamed tiles
constexpr int kBlocksPerSm = 3;     // resident forward blocks an SM the launch bounds ask for
// The backward's blocks: 2 warps, 32 query (or key) rows, the other
// operand streamed in tiles of 32 rows, the ragged last tile 16 columns a
// step; 4 blocks an SM of each kernel.
constexpr int kBwdWarps = 2;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRows = 16 * kBwdWarps;
constexpr int kBwdTile = 32;
constexpr int kRaggedStep = 16;
constexpr int kRowsBlocksPerSm = 4;
constexpr int kKeysBlocksPerSm = 4;
constexpr float kLog2e = 1.4426950408889634f;

// x as a TF32 pair for the tensor core: hi = x with its low 13 bits
// cleared (TF32 rounded toward zero), lo = x - hi (exact in float32,
// |lo| < 2^-10 |x|). The tensor core reads the top 19 bits of lo's float32
// encoding, its TF32 truncation, so hi + lo enters as x to about 2^-21 of
// itself.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b for one 16 x 8 tile, k = 8, TF32 operands.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Float offset of 16-byte chunk `chunk` of row `row` in a staged float32
// [rows, DH] matrix. The chunk's low three bits are XORed with
// f(row) = 2·((row >> 1) & 3) ^ 4·(row & 1): within each 8-row group, rows
// 2q and 2q+1 land on opposite halves of a 128-byte line (`scores`: a phase
// reads chunks 4kk .. 4kk+3 of two neighbouring rows), and rows 0, 2, 4, 6
// (or 1, 3, 5, 7) on four distinct 32-byte bank groups (`weighted`: a phase
// reads chunks 2q, 2q+1 of four rows of one parity).
template <int DH>
__device__ __forceinline__ int swz32(int row, int chunk) {
  const int f = (((row >> 1) & 3) << 1) ^ ((row & 1) << 2);
  return row * DH + ((chunk ^ f) << 2);
}

// The block (THREADS threads) stages `rows` rows of DH floats (row pitch
// `pitch` floats in global memory) by cp.async; rows at or past `valid`
// (which may be <= 0) are zeros.
template <int DH, int THREADS = kThreads>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows,
                                           int valid, int pitch) {
  constexpr int CH = DH / 4;
  for (int idx = threadIdx.x; idx < rows * CH; idx += THREADS) {
    const int r = idx / CH;
    const int c = idx - r * CH;
    const bool live = r < valid;
    const float* g = live ? src + static_cast<size_t>(r) * pitch + 4 * c : src;
    cp_async16(dst + swz32<DH>(r, c), g, live);
  }
}

// A warp's 16 kept rows, lane (g, t) rows g and g+8 at d = 16kk + 4t .. + 3,
// as loaded: x[kk][0] row g, x[kk][1] row g+8 (`rows` the two rows' offsets
// from `base`, in floats).
template <int DH>
__device__ __forceinline__ void load_kept(float4 (&x)[DH / 16][2], const float* base,
                                          const size_t (&rows)[2], int t) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 2; ++r) x[kk][r] = __ldg(reinterpret_cast<const float4*>(base + rows[r] + 16 * kk + 4 * t));
  }
}

// s[n] = the warp's 16 kept rows times rows row0 + 8n + g of the staged b,
// transposed: a 16 x 8·NT tile of dot products over DH, each as three TF32
// products, a pair of k steps at a time (the kept rows split once for all n
// tiles, each b float4 as it is loaded). a_at(kk, r) gives the kept row
// g + 8r at d = 16kk + 4t .. + 3 (from registers as load_kept left them, or
// from shared memory). n tiles at or past `lim` rows of b are skipped and
// stay 0.
template <int DH, int NT, typename A>
__device__ __forceinline__ void scores(float (&s)[NT][4], A a_at, const float* b_s, int row0,
                                       int lim, int g, int t) {
  zero(s);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const float4 x0 = a_at(kk, 0), x1 = a_at(kk, 1);
    uint32_t ah[2][4], al[2][4];  // k steps 2kk and 2kk + 1
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      split(e ? x0.z : x0.x, ah[e][0], al[e][0]);  // row g, k = t
      split(e ? x1.z : x1.x, ah[e][1], al[e][1]);  // row g+8, k = t
      split(e ? x0.w : x0.y, ah[e][2], al[e][2]);  // row g, k = t+4
      split(e ? x1.w : x1.y, ah[e][3], al[e][3]);  // row g+8, k = t+4
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (row0 + 8 * n < lim) {  // the same for the whole warp
        const float4 x = *reinterpret_cast<const float4*>(b_s + swz32<DH>(row0 + 8 * n + g, 4 * kk + t));
        uint32_t bh[4], bl[4];
        split(x.x, bh[0], bl[0]);
        split(x.y, bh[1], bl[1]);
        split(x.z, bh[2], bl[2]);
        split(x.w, bh[3], bl[3]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // a_lo b_hi + a_hi b_lo, then a_hi b_hi
          mma_tf32(s[n], al[e], bh[2 * e], bh[2 * e + 1]);
          mma_tf32(s[n], ah[e], bl[2 * e], bl[2 * e + 1]);
          mma_tf32(s[n], ah[e], bh[2 * e], bh[2 * e + 1]);
        }
      }
    }
  }
}

// acc += p times rows row0 .. row0 + 8·NT - 1 of the staged b, as three TF32
// products: p [16][8·NT] as `scores` leaves its accumulator (k = t is
// column 8n + 2t, k = t+4 column 8n + 2t + 1), so b's rows are read in that
// order; n tile 4c + i of acc holds columns 32c + 4j + i of the output.
// Slices at or past `lim` rows of b are skipped.
template <int DH, int NT>
__device__ __forceinline__ void weighted(float (&acc)[DH / 8][4], const float (&p)[NT][4],
                                         const float* b_s, int row0, int lim, int g, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (row0 + 8 * n < lim) {
      uint32_t ph[4], pl[4];
      split(p[n][0], ph[0], pl[0]);  // row g, column 2t
      split(p[n][2], ph[1], pl[1]);  // row g+8, column 2t
      split(p[n][1], ph[2], pl[2]);  // row g, column 2t+1
      split(p[n][3], ph[3], pl[3]);  // row g+8, column 2t+1
      const int r0 = row0 + 8 * n + 2 * t;
#pragma unroll
      for (int c = 0; c < DH / 32; ++c) {
        const float4 x0 = *reinterpret_cast<const float4*>(b_s + swz32<DH>(r0, 8 * c + g));
        const float4 x1 = *reinterpret_cast<const float4*>(b_s + swz32<DH>(r0 + 1, 8 * c + g));
        const float v0[4] = {x0.x, x0.y, x0.z, x0.w}, v1[4] = {x1.x, x1.y, x1.z, x1.w};
        uint32_t bh[4][2], bl[4][2];  // n tile 4c + i: rows r0, r0 + 1
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split(v0[i], bh[i][0], bl[i][0]);
          split(v1[i], bh[i][1], bl[i][1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_tf32(acc[4 * c + i], pl, bh[i][0], bh[i][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_tf32(acc[4 * c + i], ph, bl[i][0], bl[i][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_tf32(acc[4 * c + i], ph, bh[i][0], bh[i][1]);
      }
    }
  }
}

// acc += p b as `weighted`, through a zeroed partial that enters acc by one
// rounded float32 add an element. The tensor core truncates its float32
// sums, so an accumulator that takes hundreds of mma drifts toward zero:
// with one accumulator for all of S the backward's dq, dk and dv left the
// float32 gate at 577 and 1024 tokens (1.4e-5 of their max on an H100), so
// each tile's products (12 mma an element) are summed apart.
template <int DH, int NT>
__device__ __forceinline__ void add_weighted(float (&acc)[DH / 8][4], const float (&p)[NT][4],
                                             const float* b_s, int row0, int lim, int g, int t) {
  float part[DH / 8][4];
  zero(part);
  weighted<DH, NT>(part, p, b_s, row0, lim, g, t);
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
}

// Rows g and g+8 of a warp's 16 x DH accumulator in `weighted`'s layout,
// times mul[r], to dst (the warp's first row) with rows `pitch` floats
// apart; rows at or past `rows` are not written. Element 2r (column j = 2t)
// of n tile 4c + i is column 32c + 8t + i, element 2r + 1 (j = 2t + 1)
// column 32c + 8t + 4 + i: two float4 stores a row and group.
template <int DH>
__device__ __forceinline__ void store_rows(float* dst, int pitch, const float (&acc)[DH / 8][4],
                                           const float (&mul)[2], int rows, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row < rows) {
      float* d = dst + static_cast<size_t>(row) * pitch + 8 * t;
#pragma unroll
      for (int c = 0; c < DH / 32; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          *reinterpret_cast<float4*>(d + 32 * c + 4 * e) = make_float4(
              acc[4 * c][2 * r + e] * mul[r], acc[4 * c + 1][2 * r + e] * mul[r],
              acc[4 * c + 2][2 * r + e] * mul[r], acc[4 * c + 3][2 * r + e] * mul[r]);
        }
      }
    }
  }
}

// Shared memory of a block, in floats of a stage and bytes a block: the
// forward and the rows kernel stage K and V tiles; the keys kernel keeps its
// own K and V rows and stages q and dO tiles with their three row statistics.
template <int DH>
struct Smem {
  static constexpr int rows_stage = 2 * kBwdTile * DH;
  static constexpr int keys_stage = 2 * kBwdTile * DH + 3 * kBwdTile;
  static constexpr size_t fwd = kStages * 2 * kTile * DH * sizeof(float);
  static constexpr size_t rows = (2 * kBwdRows * DH + kStages * rows_stage) * sizeof(float);
  static constexpr size_t keys = (2 * kBwdRows * DH + kStages * keys_stage) * sizeof(float);
};

// The forward's and the backward's per-row statistics: [B·H][2][S16]
// float32, the exponent's shift -max * scale_log2 and 1/sum.
__device__ __forceinline__ const float* stats_of(const float* stats, int bh, int sp) {
  return stats + static_cast<size_t>(bh) * 2 * sp;
}

// Block = (batch·head, 64 query rows). Image b, head h of `heads` starts at
// b·S·pitch + h·DH in q, k and v (rows `pitch` floats apart) and at
// b·S·o_pitch + h·DH in o (rows `o_pitch` apart); keys at or past kv are
// masked. Packed: heads H, pitch 3D, o_pitch D, k and v offset by D and 2D.
// Apart: heads 1, pitch and o_pitch DH. `stats` may be null.
template <int DH>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    attn_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ stats, int heads, int s_len, int kv, int tiles,
                        int pitch, int o_pitch, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NS = kTile / 8;  // n tiles of a key tile's scores
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - bh * tiles) * kRows;
  const int b = bh / heads, h = bh - b * heads;
  const size_t head = static_cast<size_t>(b) * s_len * pitch + h * DH;
  const float* k_g = k + head;
  const float* v_g = v + head;
  const int nt = (kv + kTile - 1) / kTile;

  float* kv_s = reinterpret_cast<float*>(smem);  // kStages stages: K [kTile][DH], V
  auto stage_tile = [&](int kt) {
    float* dst = kv_s + (kt % kStages) * 2 * kTile * DH;
    const int k0 = kt * kTile;
    stage_rows<DH>(dst, k_g + static_cast<size_t>(k0) * pitch, kTile, kv - k0, pitch);
    stage_rows<DH>(dst + kTile * DH, v_g + static_cast<size_t>(k0) * pitch, kTile, kv - k0,
                   pitch);
  };
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nt) stage_tile(kt);
    cp_async_commit();
  }

  const int i0 = q0 + 16 * warp;  // the warp's first query row
  const bool live = i0 < s_len;   // the same for the whole warp
  // The warp's Q (rows past S repeat the last row), split a tile at a time.
  float4 qx[DH / 16][2];
  if (live) {
    const size_t rows[2] = {static_cast<size_t>(min(i0 + g, s_len - 1)) * pitch,
                            static_cast<size_t>(min(i0 + g + 8, s_len - 1)) * pitch};
    load_kept<DH>(qx, q + head, rows, t);
  }

  // running max of the raw scores (times scale_log2 it is the exponent's),
  // running sum of e = 2^((s - max) scale_log2)
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  float acc[DH / 8][4];  // n tile 4c + i: columns 32c + 4j + i
  zero(acc);
  for (int kt = 0; kt < nt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt staged; the stage of tile kt-1 free
    if (kt + kStages - 1 < nt) stage_tile(kt + kStages - 1);
    cp_async_commit();
    const float* k_s = kv_s + (kt % kStages) * 2 * kTile * DH;
    const float* v_s = k_s + kTile * DH;
    const int valid = min(kTile, kv - kt * kTile);  // real keys of the tile
    if (live) {
      // A full tile (every tile but the last, all of them when 64 divides
      // kv) is worked with its bounds as constants: no branch splits it.
      auto work = [&](auto full) {
        const int lim = decltype(full)::value ? kTile : valid;
        float s[NS][4];
        scores<DH, NS>(s, [&](int kk, int r) { return qx[kk][r]; }, k_s, 0, lim, g, t);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (8 * n + 2 * t + (e & 1) >= lim) s[n][e] = -INFINITY;
          }
        }
        float m_new[2], shift[2];  // shift: -max * scale_log2
        row_reduce<NS>(m_new, s, MaxOp());
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m_new[r] = quad_max(fmaxf(mx[r], m_new[r]));  // finite: the tile has a real key
          const float f = exp2_approx((mx[r] - m_new[r]) * scale_log2);  // 0 on the first tile
          sum[r] *= f;
#pragma unroll
          for (int n = 0; n < DH / 8; ++n) {
            acc[n][2 * r] *= f;
            acc[n][2 * r + 1] *= f;
          }
          mx[r] = m_new[r];
          shift[r] = -m_new[r] * scale_log2;
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          if (8 * n < lim) {  // n tiles past the keys stay 0 (-inf scores)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = exp2_approx(fmaf(s[n][e], scale_log2, shift[e >> 1]));
          } else {
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
          }
        }
        float tile_sum[2];
        row_reduce<NS>(tile_sum, s, AddOp());
        sum[0] += tile_sum[0];
        sum[1] += tile_sum[1];
        weighted<DH, NS>(acc, s, v_s, 0, lim, g, t);  // o += p V
      };
      if (valid == kTile) {
        work(std::true_type());
      } else {
        work(std::false_type());
      }
    }
  }
  if (live) {
    const float inv[2] = {1.0f / quad_sum(sum[0]), 1.0f / quad_sum(sum[1])};
    store_rows<DH>(o + static_cast<size_t>(b) * s_len * o_pitch + h * DH + static_cast<size_t>(i0) * o_pitch,
                   o_pitch, acc, inv, s_len - i0, g, t);
    if (stats != nullptr && t == 0) {
      float* st = stats + static_cast<size_t>(bh) * 2 * round16(s_len);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = i0 + g + 8 * r;
        if (row < s_len) {
          st[row] = -mx[r] * scale_log2;
          st[round16(s_len) + row] = inv[r];
        }
      }
    }
  }
}

// dq. Block = (batch·head, 32 query rows), geometry as the forward's; dO
// and o share o's, dq q's. Writes each row's delta to delta [B·H][S16]. The
// block's q and dO rows stay in shared memory (in registers they and the
// two accumulators spilled).
template <int DH>
__global__ void __launch_bounds__(kBwdThreads, kRowsBlocksPerSm)
    attn_f32_bwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ o,
                             const float* __restrict__ d_o, const float* __restrict__ stats,
                             float* __restrict__ delta, float* __restrict__ dq, int heads,
                             int s_len, int kv, int tiles, int pitch, int o_pitch, float scale,
                             float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int sp = round16(s_len);
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - bh * tiles) * kBwdRows;
  const int b = bh / heads, h = bh - b * heads;
  const size_t head = static_cast<size_t>(b) * s_len * pitch + h * DH;
  const size_t o_head = static_cast<size_t>(b) * s_len * o_pitch + h * DH;
  const float* k_g = k + head;
  const float* v_g = v + head;
  const int nt = (kv + kBwdTile - 1) / kBwdTile;

  float* q_s = reinterpret_cast<float*>(smem);  // [kBwdRows][DH], rows from q0
  float* do_s = q_s + kBwdRows * DH;
  float* kv_s = do_s + kBwdRows * DH;  // kStages stages: K [kBwdTile][DH], V
  auto stage_tile = [&](int kt) {
    float* dst = kv_s + (kt % kStages) * Smem<DH>::rows_stage;
    const int k0 = kt * kBwdTile;
    stage_rows<DH, kBwdThreads>(dst, k_g + static_cast<size_t>(k0) * pitch, kBwdTile, kv - k0,
                                pitch);
    stage_rows<DH, kBwdThreads>(dst + kBwdTile * DH, v_g + static_cast<size_t>(k0) * pitch,
                                kBwdTile, kv - k0, pitch);
  };
  stage_rows<DH, kBwdThreads>(q_s, q + head + static_cast<size_t>(q0) * pitch, kBwdRows,
                              s_len - q0, pitch);
  stage_rows<DH, kBwdThreads>(do_s, d_o + o_head + static_cast<size_t>(q0) * o_pitch, kBwdRows,
                              s_len - q0, o_pitch);
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nt) stage_tile(kt);
    cp_async_commit();  // q and dO join the first group
  }

  const int i0 = q0 + 16 * warp;  // the warp's first query row
  const bool live = i0 < s_len;   // the same for the whole warp
  // the warp's q and dO rows (zeros past S) as `scores` takes them
  auto q_at = [&](int kk, int r) {
    return *reinterpret_cast<const float4*>(q_s + swz32<DH>(16 * warp + g + 8 * r, 4 * kk + t));
  };
  auto do_at = [&](int kk, int r) {
    return *reinterpret_cast<const float4*>(do_s + swz32<DH>(16 * warp + g + 8 * r, 4 * kk + t));
  };
  float shift[2], inv[2], dl[2];  // row g, row g+8 (rows past S repeat the last row)
  if (live) {
    const int row[2] = {min(i0 + g, s_len - 1), min(i0 + g + 8, s_len - 1)};
    const size_t o_at[2] = {static_cast<size_t>(row[0]) * o_pitch, static_cast<size_t>(row[1]) * o_pitch};
    float4 dx[DH / 16][2], ox[DH / 16][2];
    load_kept<DH>(dx, d_o + o_head, o_at, t);
    load_kept<DH>(ox, o + o_head, o_at, t);
    const float* st = stats_of(stats, bh, sp);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        sum = fmaf(dx[kk][r].x, ox[kk][r].x, sum);
        sum = fmaf(dx[kk][r].y, ox[kk][r].y, sum);
        sum = fmaf(dx[kk][r].z, ox[kk][r].z, sum);
        sum = fmaf(dx[kk][r].w, ox[kk][r].w, sum);
      }
      dl[r] = quad_sum(sum);
      shift[r] = st[row[r]];
      inv[r] = st[sp + row[r]];
      if (t == 0 && i0 + g + 8 * r < s_len) delta[static_cast<size_t>(bh) * sp + i0 + g + 8 * r] = dl[r];
    }
  }

  float dqa[DH / 8][4];
  zero(dqa);
  for (int kt = 0; kt < nt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt staged; the stage of tile kt-1 free
    if (kt + kStages - 1 < nt) stage_tile(kt + kStages - 1);
    cp_async_commit();
    const float* k_s = kv_s + (kt % kStages) * Smem<DH>::rows_stage;
    const float* v_s = k_s + kBwdTile * DH;
    const int valid = min(kBwdTile, kv - kt * kBwdTile);  // real keys of the tile
    if (live) {
      // keys c .. c + width - 1 of the tile
      auto step = [&](auto full, auto width, int c) {
        constexpr int NT = decltype(width)::value / 8;
        const int lim = decltype(full)::value ? kBwdTile : valid;
        if (c < lim) {  // the same for the whole warp
          float s[NT][4], dp[NT][4];
          scores<DH, NT>(s, q_at, k_s, c, lim, g, t);
          scores<DH, NT>(dp, do_at, v_s, c, lim, g, t);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float ds = 0.0f;
              if (c + 8 * n + 2 * t + (e & 1) < lim && kv > 1) {
                const float p = exp2_approx(fmaf(s[n][e], scale_log2, shift[e >> 1])) * inv[e >> 1];
                ds = p * (dp[n][e] - dl[e >> 1]);
              }
              s[n][e] = ds;
            }
          }
          add_weighted<DH, NT>(dqa, s, k_s, c, lim, g, t);  // dq += ds K
        }
      };
      // A full tile (every tile but the last, all of them when 32 divides
      // kv) is worked with its bounds as constants: no branch splits it;
      // the ragged last one 16 columns a step, as many steps as it has rows.
      if (valid == kBwdTile) {
        step(std::true_type(), std::integral_constant<int, kBwdTile>(), 0);
      } else {
#pragma unroll 1
        for (int c = 0; c < valid; c += kRaggedStep) {
          step(std::false_type(), std::integral_constant<int, kRaggedStep>(), c);
        }
      }
    }
  }
  if (live) {
    const float mul[2] = {scale, scale};
    store_rows<DH>(dq + head + static_cast<size_t>(i0) * pitch, pitch, dqa, mul, s_len - i0, g, t);
  }
}

// dk and dv. Block = (batch·head, 32 key rows), geometry as the forward's;
// dk and dv share k's. Reads the forward's statistics and the rows kernel's
// delta. The block's K and V rows stay in shared memory (in registers they
// and the three accumulators spilled).
template <int DH>
__global__ void __launch_bounds__(kBwdThreads, kKeysBlocksPerSm)
    attn_f32_bwd_keys_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ d_o,
                             const float* __restrict__ stats, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, int heads, int s_len,
                             int kv, int tiles, int pitch, int o_pitch, float scale,
                             float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int sp = round16(s_len);
  const int bh = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - bh * tiles) * kBwdRows;
  const int b = bh / heads, h = bh - b * heads;
  const size_t head = static_cast<size_t>(b) * s_len * pitch + h * DH;
  const float* q_g = q + head;
  const float* do_g = d_o + static_cast<size_t>(b) * s_len * o_pitch + h * DH;
  const float* st_g = stats_of(stats, bh, sp);
  const float* dl_g = delta + static_cast<size_t>(bh) * sp;
  const int nt = (s_len + kBwdTile - 1) / kBwdTile;  // query tiles

  float* k_s = reinterpret_cast<float*>(smem);  // [kBwdRows][DH], rows from j0
  float* v_s = k_s + kBwdRows * DH;
  // kStages stages: q [kBwdTile][DH], dO, the tile's shift, 1/sum and delta
  float* stages = v_s + kBwdRows * DH;
  auto stage_tile = [&](int it) {
    float* dst = stages + (it % kStages) * Smem<DH>::keys_stage;
    const int c0 = it * kBwdTile;
    stage_rows<DH, kBwdThreads>(dst, q_g + static_cast<size_t>(c0) * pitch, kBwdTile, s_len - c0,
                                pitch);
    stage_rows<DH, kBwdThreads>(dst + kBwdTile * DH, do_g + static_cast<size_t>(c0) * o_pitch,
                                kBwdTile, s_len - c0, o_pitch);
    float* st_t = dst + 2 * kBwdTile * DH;
    for (int idx = threadIdx.x; idx < 3 * kBwdTile / 4; idx += kBwdThreads) {
      const int part = idx / (kBwdTile / 4), i = c0 + 4 * (idx - part * (kBwdTile / 4));
      const float* src = part < 2 ? st_g + part * sp + i : dl_g + i;
      cp_async16(st_t + 4 * idx, i < sp ? src : st_g, i < sp);
    }
  };
  stage_rows<DH, kBwdThreads>(k_s, k + head + static_cast<size_t>(j0) * pitch, kBwdRows, kv - j0,
                              pitch);
  stage_rows<DH, kBwdThreads>(v_s, v + head + static_cast<size_t>(j0) * pitch, kBwdRows, kv - j0,
                              pitch);
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < nt) stage_tile(it);
    cp_async_commit();  // K and V join the first group
  }

  const int jr = j0 + 16 * warp;  // the warp's first key row
  const bool live = jr < kv;      // the same for the whole warp
  // the warp's K and V rows (zeros past kv) as `scores` takes them
  auto k_at = [&](int kk, int r) {
    return *reinterpret_cast<const float4*>(k_s + swz32<DH>(16 * warp + g + 8 * r, 4 * kk + t));
  };
  auto v_at = [&](int kk, int r) {
    return *reinterpret_cast<const float4*>(v_s + swz32<DH>(16 * warp + g + 8 * r, 4 * kk + t));
  };
  float dka[DH / 8][4], dva[DH / 8][4];
  zero(dka);
  zero(dva);
  for (int it = 0; it < nt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it staged; the stage of tile it-1 free
    if (it + kStages - 1 < nt) stage_tile(it + kStages - 1);
    cp_async_commit();
    const float* q_t = stages + (it % kStages) * Smem<DH>::keys_stage;
    const float* do_t = q_t + kBwdTile * DH;
    const float* st_t = q_t + 2 * kBwdTile * DH;
    const int valid = min(kBwdTile, s_len - it * kBwdTile);  // real query rows of the tile
    if (live) {
      // queries c .. c + width - 1 of the tile
      auto step = [&](auto full, auto width, int c) {
        constexpr int NT = decltype(width)::value / 8;
        const int lim = decltype(full)::value ? kBwdTile : valid;
        if (c < lim) {  // the same for the whole warp
          float p_t[NT][4], ds_t[NT][4];  // p and ds transposed: [key][query]
          scores<DH, NT>(p_t, k_at, q_t, c, lim, g, t);
          scores<DH, NT>(ds_t, v_at, do_t, c, lim, g, t);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int i = c + 8 * n + 2 * t;  // query columns i, i + 1 of the tile
            const float2 sh = *reinterpret_cast<const float2*>(st_t + i);
            const float2 iv = *reinterpret_cast<const float2*>(st_t + kBwdTile + i);
            const float2 dl = *reinterpret_cast<const float2*>(st_t + 2 * kBwdTile + i);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool col1 = e & 1;
              float p = 0.0f, ds = 0.0f;
              if (i + col1 < lim) {
                p = exp2_approx(fmaf(p_t[n][e], scale_log2, col1 ? sh.y : sh.x)) * (col1 ? iv.y : iv.x);
                if (kv > 1) ds = p * (ds_t[n][e] - (col1 ? dl.y : dl.x));  // 0 for a single key
              }
              p_t[n][e] = p;
              ds_t[n][e] = ds;
            }
          }
          add_weighted<DH, NT>(dva, p_t, do_t, c, lim, g, t);  // dv += pT dO
          add_weighted<DH, NT>(dka, ds_t, q_t, c, lim, g, t);  // dk += dsT q
        }
      };
      if (valid == kBwdTile) {  // as in the rows kernel
        step(std::true_type(), std::integral_constant<int, kBwdTile>(), 0);
      } else {
#pragma unroll 1
        for (int c = 0; c < valid; c += kRaggedStep) {
          step(std::false_type(), std::integral_constant<int, kRaggedStep>(), c);
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (jr + g + 8 * r >= kv) {  // a masked key: exact zeros
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          dka[n][2 * r] = dka[n][2 * r + 1] = 0.0f;
          dva[n][2 * r] = dva[n][2 * r + 1] = 0.0f;
        }
      }
    }
    const float mul_k[2] = {scale, scale}, mul_v[2] = {1.0f, 1.0f};
    const size_t at = head + static_cast<size_t>(jr) * pitch;
    store_rows<DH>(dk + at, pitch, dka, mul_k, s_len - jr, g, t);
    store_rows<DH>(dv + at, pitch, dva, mul_v, s_len - jr, g, t);
  }
  // the rows of the block's warps past kv are masked keys: zeros
  const int z0 = j0 + 16 * max(0, min(kBwdWarps, (kv - j0 + 15) / 16));
  const int z1 = min(j0 + kBwdRows, s_len);
  for (int idx = threadIdx.x; idx < (z1 - z0) * (DH / 4); idx += kBwdThreads) {
    const size_t at = head + static_cast<size_t>(z0 + idx / (DH / 4)) * pitch + 4 * (idx % (DH / 4));
    *reinterpret_cast<float4*>(dk + at) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(dv + at) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Blocks of a launch over `rows` rows of each of `batch_heads` heads, or 0
// if the grid is too large.
int blocks_for(long long batch_heads, int rows, int block_rows, int& tiles) {
  tiles = (rows + block_rows - 1) / block_rows;
  const long long blocks = batch_heads * tiles;
  return blocks > INT_MAX ? 0 : static_cast<int>(blocks);
}

template <int DH>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* stats, int batch,
               int heads, int s_len, int kv, int pitch, int o_pitch, float scale,
               cudaStream_t stream) {
  int tiles;
  const int blocks = blocks_for(static_cast<long long>(batch) * heads, s_len, kRows, tiles);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(attn_f32_fwd_kernel<DH>, Smem<DH>::fwd);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_f32_fwd_kernel<DH><<<blocks, kThreads, Smem<DH>::fwd, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(stats), heads, s_len, kv, tiles, pitch,
      o_pitch, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v, dq, dk, dv: rows `pitch` apart; o, dO: rows `o_pitch` apart.
template <int DH>
int launch_bwd(const float* q, const float* k, const float* v, const float* o,
               const float* d_o, const float* stats, float* delta, float* dq, float* dk,
               float* dv, int batch, int heads, int s_len, int kv, int pitch, int o_pitch,
               float scale, cudaStream_t stream) {
  int tiles;
  const int blocks = blocks_for(static_cast<long long>(batch) * heads, s_len, kBwdRows, tiles);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(attn_f32_bwd_rows_kernel<DH>, Smem<DH>::rows);
  if (err == cudaSuccess) err = allow_smem(attn_f32_bwd_keys_kernel<DH>, Smem<DH>::keys);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_f32_bwd_rows_kernel<DH><<<blocks, kBwdThreads, Smem<DH>::rows, stream>>>(
      q, k, v, o, d_o, stats, delta, dq, heads, s_len, kv, tiles, pitch, o_pitch, scale,
      scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_f32_bwd_keys_kernel<DH><<<blocks, kBwdThreads, Smem<DH>::keys, stream>>>(
      q, k, v, d_o, stats, delta, dk, dv, heads, s_len, kv, tiles, pitch, o_pitch, scale,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int info(int which, int* out) {
  switch (which) {
    case 0: return kernel_info(attn_f32_fwd_kernel<DH>, kThreads, Smem<DH>::fwd, out);
    case 1: return kernel_info(attn_f32_bwd_rows_kernel<DH>, kBwdThreads, Smem<DH>::rows, out);
    case 2: return kernel_info(attn_f32_bwd_keys_kernel<DH>, kBwdThreads, Smem<DH>::keys, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Called by the C entries of attention.cu for float32 tensors, which have
// checked 1 <= kv <= s_len. `stats` is [B·H][2][round16(s_len)]
// float32: written by the forward when not null, read by the backward;
// `delta` is the backward's scratch of B·H·round16(s_len) floats.

int attention_qkv_fwd_f32(const void* qkv, void* o, void* stats, int batch, int heads,
                          int s_len, int dh, int kv, float scale, cudaStream_t stream) {
  const float* base = static_cast<const float*>(qkv);
  const int d_model = heads * dh;
  if (dh == 64) {
    return launch_fwd<64>(base, base + d_model, base + 2 * d_model, o, stats, batch, heads,
                          s_len, kv, 3 * d_model, d_model, scale, stream);
  }
  if (dh == 32) {
    return launch_fwd<32>(base, base + d_model, base + 2 * d_model, o, stats, batch, heads,
                          s_len, kv, 3 * d_model, d_model, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int attention_fwd_f32(const void* q, const void* k, const void* v, void* o, void* stats,
                      int batch_heads, int s_len, int dh, float scale, cudaStream_t stream) {
  if (dh == 64) return launch_fwd<64>(q, k, v, o, stats, batch_heads, 1, s_len, s_len, 64, 64, scale, stream);
  if (dh == 32) return launch_fwd<32>(q, k, v, o, stats, batch_heads, 1, s_len, s_len, 32, 32, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int attention_qkv_bwd_f32(const void* qkv, const void* d_o, void* dqkv, const void* o,
                          const void* stats, void* delta, int batch, int heads, int s_len,
                          int dh, int kv, float scale, cudaStream_t stream) {
  const float* x = static_cast<const float*>(qkv);
  float* dx = static_cast<float*>(dqkv);
  const float* o_ = static_cast<const float*>(o);
  const float* do_ = static_cast<const float*>(d_o);
  const float* st = static_cast<const float*>(stats);
  float* dl = static_cast<float*>(delta);
  const int d = heads * dh;
  if (dh == 64) {
    return launch_bwd<64>(x, x + d, x + 2 * d, o_, do_, st, dl, dx, dx + d, dx + 2 * d, batch,
                          heads, s_len, kv, 3 * d, d, scale, stream);
  }
  if (dh == 32) {
    return launch_bwd<32>(x, x + d, x + 2 * d, o_, do_, st, dl, dx, dx + d, dx + 2 * d, batch,
                          heads, s_len, kv, 3 * d, d, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int attention_bwd_f32(const void* q, const void* k, const void* v, const void* d_o, void* dq,
                      void* dk, void* dv, const void* o, const void* stats, void* delta,
                      int batch_heads, int s_len, int dh, float scale, cudaStream_t stream) {
  const float *q_ = static_cast<const float*>(q), *k_ = static_cast<const float*>(k),
              *v_ = static_cast<const float*>(v), *o_ = static_cast<const float*>(o),
              *do_ = static_cast<const float*>(d_o), *st = static_cast<const float*>(stats);
  float *dq_ = static_cast<float*>(dq), *dk_ = static_cast<float*>(dk),
        *dv_ = static_cast<float*>(dv), *dl = static_cast<float*>(delta);
  if (dh == 64) {
    return launch_bwd<64>(q_, k_, v_, o_, do_, st, dl, dq_, dk_, dv_, batch_heads, 1, s_len,
                          s_len, 64, 64, scale, stream);
  }
  if (dh == 32) {
    return launch_bwd<32>(q_, k_, v_, o_, do_, st, dl, dq_, dk_, dv_, batch_heads, 1, s_len,
                          s_len, 32, 32, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// For measurement: `which` 0 (forward), 1 (backward rows) or 2 (backward
// keys) at head width `dh`; out[4] = registers a thread, local bytes a
// thread (spills), shared memory bytes a block, resident blocks an SM.
// Returns the CUDA error (0 on success).
extern "C" int ssip_attention_f32_info(int which, int dh, int* out) {
  if (dh == 64) return info<64>(which, out);
  if (dh == 32) return info<32>(which, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
