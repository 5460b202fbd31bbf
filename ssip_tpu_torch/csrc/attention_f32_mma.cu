// Multi-head softmax attention forward in float32 on Hopper's tensor cores:
// the float32 forms behind ssip_attention_qkv_fwd (packed qkv [B, S, 3D],
// columns [3, H, Dh], keys at or past kv_len masked) and ssip_attention_fwd
// (q, k, v [B·H, S, Dh] apart), one kernel for both. attention.cu keeps the
// C entry points and the float32 backward.
//
//   attn_f32_fwd_kernel replaces, in float32,
//     ssip_tpu/ops/attention.py:_attn_qkv_kernel (packed, fused_attention_qkv)
//     ssip_tpu/ops/attention.py:_attn_kernel     (apart, fused_attention)
//
// Function, per (image, head): s = (q kT) * scale with the scale applied
// after the float32 sum; keys at or past kv get -inf; p = softmax(s) in
// float32, never rounded (the packed pair rounds p to the input type, a
// no-op in float32); o = p v summed in float32. All S query rows are
// written, pad rows included. Nothing is rounded in between, so the kernel
// sums in its own order and the softmax is the online form: a running max
// and sum per row, the accumulator rescaled when the max moves, o times
// 1/sum at the end. The scale, folded with log2(e), enters each exponent by
// one FMA, 2^(s scale log2(e) - max scale log2(e)), by ex2.approx (about 2
// ulp).
//
// Products: 3xTF32 on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
// One TF32 product keeps 11 bits of each operand: a score is then off by
// about 1e-3 and outputs leave the 2e-5 float32 gate
// (tests/test_torch_attention.py emulates both forms on a CPU). So every
// operand x is split in registers: hi = x with its low 13 bits cleared (its
// TF32 truncation), lo = x - hi (exact, under 2^-10 of x), of which the
// tensor core reads the TF32 truncation too; hi + lo holds x to about 2^-21
// of itself. A product a b is three mma into one float32 accumulator, the
// small terms first: a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, under
// 2^-20 of the product, is left out). The tensor core's products of TF32
// operands are exact, its sums float32. The split is two instructions, a
// LOP3 and an FADD; cvt.rna.tf32.f32 (rounding hi to nearest) put the
// forward at 0.68 ms against 0.42 at [128, 12, 197, 64] on an H100, held
// back by the conversion's throughput (python -m
// ssip_tpu_torch.kernels.attention_variants --f32; PERF.md). q is split a
// tile at a time from registers, k and v as each warp loads them, once a
// tile (hi/lo planes in shared memory would double it and cost the
// occupancy this design is for), and p as it leaves the scores'
// accumulator: it is never rounded to fewer bits.
//
// Fragments come by 16-byte shared loads, not ldmatrix (which moves 16-bit
// elements; V's k index is its row):
// - A sum over d does not care about its order, so the scores take d
//   permuted: of the two k steps over d = 16kk .. 16kk+15, lane (g, t) holds
//   k = t and t+4 of the first as d = 16kk+4t and +1, of the second as
//   16kk+4t+2 and +3. Q's A fragments are then one float4 of row g and one
//   of row g+8, K's B fragments one float4 of key row g: one load serves two
//   k steps.
// - The scores' accumulator gives lane (g, t) keys 2t, 2t+1 of each 8-key
//   slice, where P·V's A fragment wants k = t and t+4. The key order inside
//   each slice is relabelled, k = t as key 2t and k = t+4 as key 2t+1, so the
//   accumulator registers are the A fragment as they stand (no shuffle, no
//   trip through shared memory), and V's B fragment is read with the same
//   permutation: rows 2t and 2t+1, column g. Its columns are relabelled too:
//   n tile i of a 32-column group takes column 4j + i as its column j, so
//   lane g reads one float4 (columns 4g .. 4g+3) for 4 n tiles, and the
//   output lane (g, t) holds is columns 8t .. 8t+7 of rows g and g+8: two
//   float4 stores a row and group. (tests/test_torch_attention.py checks
//   these maps and the swizzle lane by lane.)
// - K and V rows reach shared memory by 16-byte cp.async with their chunks
//   XOR-swizzled by the row (swz32), so that the 8 lanes of each phase of a
//   16-byte load fall on 8 bank groups in both reads.
//
// A block per (batch·head, 64 query rows): 4 warps, 16 rows a warp. K and V
// stream in 64-key tiles through two cp.async stages (2 x 2 x 64 x Dh x 4
// bytes: 64 KB at Dh 64), the next tile in flight while one is worked, one
// barrier a tile, so shared memory does not grow with S and 3 blocks fit on
// an SM. Full tiles are worked with their bounds as constants; only the last,
// ragged tile branches. Measured on an H100 at [128, 12, 197, 64] and 256
// tokens, no variant was faster: 2 blocks an SM (206 registers, no spills)
// +2.5-4 %, 3 stages +8-10 %, every tile through the ragged path +7-11 % at
// 256 tokens, the mma of 2, 4 or 8 n tiles interleaved within 2.5 %. So
// neither occupancy, staging depth nor the order of independent mma sets
// the pace (the rate of mma.sync on TF32 beside the splits is the likeliest
// limit; not measured alone).
//
// Bound on this card at [128, 12, 197, 64]: q, k, v read once and o written
// once are 310 MB, 0.0925 ms at 3.35 TB/s; 4·B·H·S²·Dh = 15.26 GFLOP, three
// TF32 products each, 0.0925 ms at 495 TFLOP/s.
//
// Shapes: Dh 32 or 64, 1 <= kv <= S; the wrapper holds S to 256, the
// float32 backward's limit. Every pointer 16-byte aligned (the wrapper
// checks) and every row pitch a multiple of 4 floats.

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

using namespace ssip_mma;

constexpr int kWarps = 4;  // of every block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of a block
constexpr int kTile = 64;           // keys of a streamed tile
constexpr int kStages = 2;          // shared-memory stages of the streamed tiles
constexpr int kBlocksPerSm = 3;     // resident blocks an SM the launch bounds ask for
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
// 2q and 2q+1 land on opposite halves of a 128-byte line (K: a phase reads
// chunks 4kk .. 4kk+3 of two neighbouring rows), and rows 0, 2, 4, 6 (or 1,
// 3, 5, 7) on four distinct 32-byte bank groups (V: a phase reads chunks
// 2q, 2q+1 of four rows of one parity).
template <int DH>
__device__ __forceinline__ int swz32(int row, int chunk) {
  const int f = (((row >> 1) & 3) << 1) ^ ((row & 1) << 2);
  return row * DH + ((chunk ^ f) << 2);
}

// The block stages `rows` rows of DH floats (row pitch `pitch` floats in
// global memory) by cp.async; rows at or past `valid` (which may be <= 0)
// are zeros.
template <int DH>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows,
                                           int valid, int pitch) {
  constexpr int CH = DH / 4;
  for (int idx = threadIdx.x; idx < rows * CH; idx += kThreads) {
    const int r = idx / CH;
    const int c = idx - r * CH;
    const bool live = r < valid;
    const float* g = live ? src + static_cast<size_t>(r) * pitch + 4 * c : src;
    cp_async16(dst + swz32<DH>(r, c), g, live);
  }
}

template <int DH>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kStages) * 2 * kTile * DH * sizeof(float);
}

// Block = (batch·head, 64 query rows). Image b, head h of `heads` starts at
// b·S·pitch + h·DH in q, k and v (rows `pitch` floats apart) and at
// b·S·o_pitch + h·DH in o (rows `o_pitch` apart); keys at or past kv are
// masked. Packed: heads H, pitch 3D, o_pitch D, k and v offset by D and 2D.
// Apart: heads 1, pitch and o_pitch DH.
template <int DH>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    attn_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o, int heads,
                        int s_len, int kv, int tiles, int pitch, int o_pitch,
                        float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NS = kTile / 8;  // n tiles of a key tile's scores
  constexpr int KK = DH / 16;    // float4 columns of a lane's q row: pairs of k steps
  constexpr int NG = DH / 32;    // 32-column groups of the output, 4 n tiles each
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
  // The warp's Q, rows g and g+8 of lane (g, t) at d = 16kk + 4t .. + 3,
  // kept as loaded and split a tile at a time (rows past S repeat the last
  // row): as the A fragments of k steps 2kk and 2kk+1, the first holds
  // d = 16kk + 4t and + 1, the second + 2 and + 3.
  float4 qx[KK][2];
  if (live) {
    const float* row_g = q + head + static_cast<size_t>(min(i0 + g, s_len - 1)) * pitch + 4 * t;
    const float* row_g8 = q + head + static_cast<size_t>(min(i0 + g + 8, s_len - 1)) * pitch + 4 * t;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      qx[kk][0] = __ldg(reinterpret_cast<const float4*>(row_g + 16 * kk));
      qx[kk][1] = __ldg(reinterpret_cast<const float4*>(row_g8 + 16 * kk));
    }
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
        // S = Q KT, a pair of k steps at a time: Q's fragments split once
        // for all n tiles, each K float4 split as it is loaded.
        float s[NS][4];
        zero(s);
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          uint32_t ah[2][4], al[2][4];  // k steps 2kk and 2kk + 1
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            split(e ? qx[kk][0].z : qx[kk][0].x, ah[e][0], al[e][0]);  // row g, k = t
            split(e ? qx[kk][1].z : qx[kk][1].x, ah[e][1], al[e][1]);  // row g+8, k = t
            split(e ? qx[kk][0].w : qx[kk][0].y, ah[e][2], al[e][2]);  // row g, k = t+4
            split(e ? qx[kk][1].w : qx[kk][1].y, ah[e][3], al[e][3]);  // row g+8, k = t+4
          }
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            if (8 * n < lim) {  // the same for the whole warp
              const float4 x = *reinterpret_cast<const float4*>(k_s + swz32<DH>(8 * n + g, 4 * kk + t));
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
        // o += p V, 8 keys a k step: k = t is key 8n + 2t, k = t+4 key 8n + 2t + 1.
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          if (8 * n < lim) {
            uint32_t ph[4], pl[4];
            split(s[n][0], ph[0], pl[0]);  // row g, key 2t
            split(s[n][2], ph[1], pl[1]);  // row g+8, key 2t
            split(s[n][1], ph[2], pl[2]);  // row g, key 2t+1
            split(s[n][3], ph[3], pl[3]);  // row g+8, key 2t+1
#pragma unroll
            for (int c = 0; c < NG; ++c) {
              const float4 x0 = *reinterpret_cast<const float4*>(v_s + swz32<DH>(8 * n + 2 * t, 8 * c + g));
              const float4 x1 = *reinterpret_cast<const float4*>(v_s + swz32<DH>(8 * n + 2 * t + 1, 8 * c + g));
              const float r0[4] = {x0.x, x0.y, x0.z, x0.w}, r1[4] = {x1.x, x1.y, x1.z, x1.w};
              uint32_t vh[4][2], vl[4][2];  // n tile 4c + i: rows 2t, 2t + 1
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                split(r0[i], vh[i][0], vl[i][0]);
                split(r1[i], vh[i][1], vl[i][1]);
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) mma_tf32(acc[4 * c + i], pl, vh[i][0], vh[i][1]);
#pragma unroll
              for (int i = 0; i < 4; ++i) mma_tf32(acc[4 * c + i], ph, vl[i][0], vl[i][1]);
#pragma unroll
              for (int i = 0; i < 4; ++i) mma_tf32(acc[4 * c + i], ph, vh[i][0], vh[i][1]);
            }
          }
        }
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
    float* o_head = o + static_cast<size_t>(b) * s_len * o_pitch + h * DH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i0 + g + 8 * r;
      if (row < s_len) {
        float* dst = o_head + static_cast<size_t>(row) * o_pitch + 8 * t;
        // element 2r (column j = 2t) of n tile 4c + i is column 32c + 8t + i,
        // element 2r + 1 (j = 2t + 1) column 32c + 8t + 4 + i
#pragma unroll
        for (int c = 0; c < NG; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            *reinterpret_cast<float4*>(dst + 32 * c + 4 * e) = make_float4(
                acc[4 * c][2 * r + e] * inv[r], acc[4 * c + 1][2 * r + e] * inv[r],
                acc[4 * c + 2][2 * r + e] * inv[r], acc[4 * c + 3][2 * r + e] * inv[r]);
          }
        }
      }
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
           int s_len, int kv, int pitch, int o_pitch, float scale, cudaStream_t stream) {
  const int tiles = (s_len + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(batch) * heads * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(attn_f32_fwd_kernel<DH>, smem_bytes<DH>());
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_f32_fwd_kernel<DH><<<static_cast<int>(blocks), kThreads, smem_bytes<DH>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), heads, s_len, kv, tiles, pitch, o_pitch, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Called by ssip_attention_qkv_fwd and ssip_attention_fwd (attention.cu)
// for float32 tensors, which have checked 1 <= kv <= s_len <= 256.

int attention_qkv_fwd_f32(const void* qkv, void* o, int batch, int heads, int s_len,
                          int dh, int kv, float scale, cudaStream_t stream) {
  const float* base = static_cast<const float*>(qkv);
  const int d_model = heads * dh;
  if (dh == 64) {
    return launch<64>(base, base + d_model, base + 2 * d_model, o, batch, heads, s_len, kv,
                      3 * d_model, d_model, scale, stream);
  }
  if (dh == 32) {
    return launch<32>(base, base + d_model, base + 2 * d_model, o, batch, heads, s_len, kv,
                      3 * d_model, d_model, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                      int batch_heads, int s_len, int dh, float scale,
                      cudaStream_t stream) {
  if (dh == 64) return launch<64>(q, k, v, o, batch_heads, 1, s_len, s_len, 64, 64, scale, stream);
  if (dh == 32) return launch<32>(q, k, v, o, batch_heads, 1, s_len, s_len, 32, 32, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// For measurement: the kernel at head width `dh`; out[4] = registers a
// thread, local bytes a thread (spills), shared memory bytes a block,
// resident blocks an SM. Returns the CUDA error (0 on success).
extern "C" int ssip_attention_f32_info(int dh, int* out) {
  if (dh == 64) return kernel_info(attn_f32_fwd_kernel<64>, kThreads, smem_bytes<64>(), out);
  if (dh == 32) return kernel_info(attn_f32_fwd_kernel<32>, kThreads, smem_bytes<32>(), out);
  return static_cast<int>(cudaErrorInvalidValue);
}
