// Multi-head softmax attention on q, k, v given apart, [B·H, S, Dh] in
// bfloat16, with every product on Hopper's tensor cores: the bf16 forms
// behind ssip_attention_fwd and ssip_attention_bwd (attention.cu keeps the
// C entry points; the float32 forms are in attention_f32_mma.cu).
//
//   attn_unpacked_fwd_kernel              replaces ssip_tpu/ops/attention.py:_attn_kernel
//   attn_unpacked_bwd_rows_kernel (dq) and
//   attn_unpacked_bwd_keys_kernel (dk, dv) replace ssip_tpu/ops/attention.py:_attn_bwd_kernel
//
// Function and rounding points, those of the TPU kernels: s = (q kT) * scale
// with the scale applied after the float32 sum; p = softmax(s) in float32;
// o = p v summed in float32 and rounded to bf16 once. p (and in the backward
// ds = p (dp - delta), delta = sum_j dp p) stay float32 for their products:
// dv = pT dO, dq = ds k * scale, dk = dsT q * scale, each rounded once.
// Nothing else is rounded, so a kernel may sum in its own order, and the
// softmax is FlashAttention's online form: a running max and sum per row,
// the accumulators rescaled when the max moves, o times 1/sum at the end.
// The scale, folded with log2(e), enters each exponent by one FMA,
// 2^(s scale log2(e) - max scale log2(e)), by ex2.approx (about 2 ulp).
//
// Products are mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (inline
// PTX): exact products of bf16 operands, float32 sums. q, k, v and dO are
// bf16 already and enter as they are. p and ds are float32, and a single
// bf16 rounding of them moves many outputs by more than the one-bf16-step
// gate the kernels are held to (tests/test_torch_attention.py emulates both
// forms on a CPU). So each enters as a pair: hi = bf16(p), lo = bf16(p -
// hi), which holds p to about 2^-17 of itself, and its product is two mma
// calls, hi M plus lo M, into one float32 accumulator. The m16n8
// accumulator layout of the scores is the m16n8k16 A-fragment layout, so p
// and ds go from registers to the next product without shared memory.
//
// Operands reach shared memory by 16-byte cp.async into rows whose 16-byte
// chunks are XOR-swizzled by the row index (the 8 rows an ldmatrix phase
// reads fall on 8 bank groups); fragments come by ldmatrix (.trans where
// the operand is stored the other way round). A block is 4 warps, 16 rows a
// warp, 64 rows a block; the streamed operand arrives in 64-row tiles
// through two shared-memory stages, the next tile in flight while one is
// worked and one barrier a tile, so shared memory does not grow with S.
//
// - forward: a block per (batch·head, 64 query rows). Q fragments live in
//   registers; K and V stream. Per key tile: S = Q KT, keys at or past S
//   at -inf, the running max and sum, p split, o += p_hi V + p_lo V.
// - backward: two launches and no atomics, joined by a [B·H, 3, S16]
//   float32 scratch (-max scale log2(e), 1/sum, delta) the wrapper
//   allocates.
//   attn_unpacked_bwd_rows_kernel, a block per (batch·head, 64 query rows),
//   Q and dO fragments in registers, K and V streamed twice: the first sweep
//   finds each row's max, sum and sum of e dp (so delta = sum_j dp p of the
//   float32 p, the TPU kernel's jnp.sum(dp * p), not rowsum(dO o): o was
//   rounded), the second forms p, ds and dq = ds k * scale.
//   attn_unpacked_bwd_keys_kernel, a block per (batch·head, 64 key rows),
//   K and V fragments in registers, Q, dO and the statistics streamed:
//   the scores again as k qT, p from the saved statistics, dv = pT dO and
//   dk = dsT q * scale.
//
// Bound on this card at [128, 12, 197, 64]: bytes. Forward 155 MB (q, k,
// v read once, o written once) -> 0.0462 ms at 3.35 TB/s, against
// 4·B·H·S²·Dh = 15.3 GFLOP -> 0.0155 ms at 989 TFLOP/s; backward 271 MB ->
// 0.0809 ms against 38.2 GFLOP. The split doubles the p and ds products and
// the backward computes scores and dp twice, so the tensor-core work is
// about twice and three times those operations, still a few hundredths of
// a millisecond at mma.sync rates. What holds the kernels above that is
// latency: 4 warps an SM sub-partition, each a chain of ldmatrix -> mma ->
// exponentials -> mma per tile. Full tiles are therefore worked with their
// bounds as constants (no branch splits the chain), which took the forward
// from 0.20 to 0.15 ms; deeper staging and 8-warp blocks moved it by under
// 3 %, and 32- or 128-row tiles were slower at 197 tokens (python -m
// ssip_tpu_torch.kernels.attention_variants; PERF.md).
//
// Shapes: Dh 32 or 64, 1 <= S <= 1024 (the JAX entry's _MAX_FUSED_SEQ:
// past it the JAX entry rounds p, and attention.cu runs attention_mma.cu's
// kernels instead), every pointer 16-byte aligned (the wrapper checks).

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

using namespace ssip_mma;

constexpr int kWarps = 4;  // of every block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query or key rows of a block
constexpr int kTile = 64;           // rows of a streamed tile
constexpr int kStep = 32;           // columns a backward warp works at once
constexpr int kStages = 2;          // shared-memory stages of the streamed tiles
// resident blocks an SM the launch bounds ask for (128 and 168 registers)
constexpr int kFwdBlocksPerSm = 4;
constexpr int kBwdBlocksPerSm = 3;
constexpr float kLog2e = 1.4426950408889634f;

// (a, b) as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi). x - hi is
// exact in float32, so hi + lo is x to about 2^-17 of x.
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo, float a,
                                           float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// The block stages `rows` rows of DH columns (rows DH apart in global
// memory) by cp.async; rows at or past `valid` (which may be <= 0) are zeros.
template <int DH>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int rows, int valid) {
  constexpr int CH = DH / 8;
  for (int idx = threadIdx.x; idx < rows * CH; idx += kThreads) {
    const int r = idx / CH;
    const int c = idx - r * CH;
    const bool live = r < valid;
    const bf16* g = live ? src + static_cast<size_t>(r) * DH + c * 8 : src;
    cp_async16(dst + swz<DH>(r, c), g, live);
  }
}

// out += x times rows m_row0 .. m_row0+15 of `m` (staged [rows, DH]), where
// x is the float32 16 x 16 tile of accumulator tiles 2s and 2s+1 (their
// columns are its k), entered as its bf16 hi/lo pair: two mma calls a tile.
template <int DH, int NT>
__device__ __forceinline__ void weighted_split(float (&out)[DH / 8][4],
                                               const float (&x)[NT][4], int s,
                                               const bf16* m, int m_row0,
                                               int lane) {
  uint32_t hi[4], lo[4];
  split_bf16(hi[0], lo[0], x[2 * s][0], x[2 * s][1]);
  split_bf16(hi[1], lo[1], x[2 * s][2], x[2 * s][3]);
  split_bf16(hi[2], lo[2], x[2 * s + 1][0], x[2 * s + 1][1]);
  split_bf16(hi[3], lo[3], x[2 * s + 1][2], x[2 * s + 1][3]);
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    uint32_t bf[4];
    ldsm_x4_trans(bf, addr_a<DH>(m, m_row0, dp, lane));
    mma_bf16(out[2 * dp], hi, bf[0], bf[1]);
    mma_bf16(out[2 * dp + 1], hi, bf[2], bf[3]);
    mma_bf16(out[2 * dp], lo, bf[0], bf[1]);
    mma_bf16(out[2 * dp + 1], lo, bf[2], bf[3]);
  }
}

// A warp's 16 x DH accumulator tile, row g times mul[0] and row g+8 times
// mul[1], rounded to bf16 into rows row0 .. row0+15 of the staged `tile`,
// then its first `rows` rows out to global memory (`dst`, rows DH apart) as
// 16-byte stores. The warp must own those tile rows.
template <int DH>
__device__ __forceinline__ void store_tile(bf16* dst, bf16* tile, int row0,
                                           const float (&acc)[DH / 8][4],
                                           const float (&mul)[2], int rows,
                                           int lane) {
  constexpr int CH = DH / 8;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      *reinterpret_cast<uint32_t*>(tile + swz<DH>(row0 + g + 8 * half, n) + 2 * t) =
          pack_bf16(acc[n][2 * half] * mul[half], acc[n][2 * half + 1] * mul[half]);
    }
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH;
    const int c = idx - r * CH;
    if (r < rows) {
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * DH + 8 * c) =
          *reinterpret_cast<const uint4*>(tile + swz<DH>(row0 + r, c));
    }
  }
}

// Shared memory of a block, in bytes: its own rows (one [kRows, DH] matrix
// in the forward, two in the backward), then kStages stages of the streamed
// tiles (K, V; or q, dO and the tile's 3 x kTile statistics).
template <int DH>
struct Smem {
  static constexpr size_t own = static_cast<size_t>(kRows) * DH * 2;
  static constexpr size_t tile = static_cast<size_t>(kTile) * DH * 2;
  static constexpr size_t fwd = own + kStages * 2 * tile;
  static constexpr size_t rows = 2 * own + kStages * 2 * tile;
  static constexpr size_t keys_stage = 2 * tile + 3 * kTile * 4;
  static constexpr size_t keys = 2 * own + kStages * keys_stage;
};

template <int DH>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm)
    attn_unpacked_fwd_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o,
                             int s_len, int tiles, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NS = kTile / 8;  // n tiles of a key tile's scores
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - bh * tiles) * kRows;
  const size_t head = static_cast<size_t>(bh) * s_len * DH;
  const bf16* k_g = k + head;
  const bf16* v_g = v + head;
  const int nt = (s_len + kTile - 1) / kTile;

  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kRows][DH]; then the output
  bf16* kv_s = q_s + kRows * DH;              // kStages stages: K [kTile][DH], V
  auto stage_tile = [&](int kt) {
    bf16* dst = kv_s + (kt % kStages) * 2 * kTile * DH;
    const int k0 = kt * kTile;
    stage_rows<DH>(dst, k_g + static_cast<size_t>(k0) * DH, kTile, s_len - k0);
    stage_rows<DH>(dst + kTile * DH, v_g + static_cast<size_t>(k0) * DH, kTile, s_len - k0);
  };
  stage_rows<DH>(q_s, q + head + static_cast<size_t>(q0) * DH, kRows, s_len - q0);
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nt) stage_tile(kt);
    cp_async_commit();  // Q joins the first group
  }

  const int i0 = 16 * warp;
  const bool live = q0 + i0 < s_len;  // the same for the whole warp
  uint32_t qf[DH / 16][4];
  // running max of the raw scores (times scale_log2 it is the exponent's),
  // running sum of e = 2^((s - max) scale_log2)
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
  float acc[DH / 8][4];
  zero(acc);
  for (int kt = 0; kt < nt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt staged; the stage of tile kt-1 free
    if (kt + kStages - 1 < nt) stage_tile(kt + kStages - 1);
    cp_async_commit();
    const bf16* k_s = kv_s + (kt % kStages) * 2 * kTile * DH;
    const bf16* v_s = k_s + kTile * DH;
    const int valid = min(kTile, s_len - kt * kTile);  // real keys of the tile
    if (live) {
      if (kt == 0) load_a<DH>(qf, q_s, i0, lane);
      // A full tile (every tile but the last, all of them when 64 divides
      // S) is worked with its bounds as constants: no branch splits it.
      auto work = [&](auto full) {
        const int lim = decltype(full)::value ? kTile : valid;
        float s[NS][4];
        frag_dot<DH, NS>(s, qf, k_s, 0, lim, lane);
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
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {
          if (16 * kk < lim) weighted_split<DH, NS>(acc, s, kk, v_s, 16 * kk, lane);
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
    store_tile<DH>(o + head + static_cast<size_t>(q0 + i0) * DH, q_s, i0, acc, inv,
                   min(16, s_len - q0 - i0), lane);
  }
}

// The backward's per-row statistics: [B·H][3][S16] float32 (the exponent's
// shift -max * scale_log2, 1/sum, delta).
__device__ __forceinline__ float* stats_of(float* stats, int bh, int sp) {
  return stats + static_cast<size_t>(bh) * 3 * sp;
}

template <int DH>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
    attn_unpacked_bwd_rows_kernel(const bf16* __restrict__ q,
                                  const bf16* __restrict__ k,
                                  const bf16* __restrict__ v,
                                  const bf16* __restrict__ d_o,
                                  bf16* __restrict__ dq,
                                  float* __restrict__ stats, int s_len,
                                  int tiles, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NA = kStep / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int sp = round16(s_len);
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - bh * tiles) * kRows;
  const size_t head = static_cast<size_t>(bh) * s_len * DH;
  const bf16* k_g = k + head;
  const bf16* v_g = v + head;
  const int nt = (s_len + kTile - 1) / kTile;

  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kRows][DH], rows from q0
  bf16* do_s = q_s + kRows * DH;
  bf16* kv_s = do_s + kRows * DH;             // kStages stages: K [kTile][DH], V
  // Two sweeps over the key tiles: steps 0 .. nt-1 for the statistics,
  // nt .. 2nt-1 for dq; step `step` works key tile step % nt.
  auto stage_tile = [&](int step) {
    bf16* dst = kv_s + (step % kStages) * 2 * kTile * DH;
    const int k0 = (step % nt) * kTile;
    stage_rows<DH>(dst, k_g + static_cast<size_t>(k0) * DH, kTile, s_len - k0);
    stage_rows<DH>(dst + kTile * DH, v_g + static_cast<size_t>(k0) * DH, kTile, s_len - k0);
  };
  stage_rows<DH>(q_s, q + head + static_cast<size_t>(q0) * DH, kRows, s_len - q0);
  stage_rows<DH>(do_s, d_o + head + static_cast<size_t>(q0) * DH, kRows, s_len - q0);
#pragma unroll
  for (int step = 0; step < kStages - 1; ++step) {
    if (step < 2 * nt) stage_tile(step);
    cp_async_commit();  // q and dO join the first group
  }

  // Rows past S up to S16 are worked too (zero q and dO give finite
  // statistics, which the keys kernel reads).
  const int i0 = 16 * warp;
  const bool live = q0 + i0 < s_len;  // the same for the whole warp
  uint32_t qf[DH / 16][4], dof[DH / 16][4];
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f}, edp[2] = {0.0f, 0.0f};
  float shift[2] = {0.0f, 0.0f}, inv[2] = {0.0f, 0.0f}, delta[2] = {0.0f, 0.0f};
  float dqa[DH / 8][4];
  zero(dqa);
  for (int step = 0; step < 2 * nt; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's tile staged; the last step's stage free
    if (step + kStages - 1 < 2 * nt) stage_tile(step + kStages - 1);
    cp_async_commit();
    const bf16* k_s = kv_s + (step % kStages) * 2 * kTile * DH;
    const bf16* v_s = k_s + kTile * DH;
    const int valid = min(kTile, s_len - (step % nt) * kTile);
    if (live) {
      if (step == 0) {
        load_a<DH>(qf, q_s, i0, lane);
        load_a<DH>(dof, do_s, i0, lane);
      }
      auto work = [&](auto full) {  // as in the forward
        const int lim = decltype(full)::value ? kTile : valid;
#pragma unroll
        for (int c = 0; c < kTile; c += kStep) {
          if (c < lim) {  // the same for the whole warp
            float s[NA][4], dp[NA][4];
            frag_dot<DH, NA>(s, qf, k_s, c, lim, lane);
            frag_dot<DH, NA>(dp, dof, v_s, c, lim, lane);
            if (step < nt) {
#pragma unroll
              for (int n = 0; n < NA; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  if (c + 8 * n + 2 * t + (e & 1) >= lim) s[n][e] = -INFINITY;
                }
              }
              float m_new[2];
              row_reduce<NA>(m_new, s, MaxOp());
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                m_new[r] = quad_max(fmaxf(mx[r], m_new[r]));
                const float f = exp2_approx((mx[r] - m_new[r]) * scale_log2);
                sum[r] *= f;
                edp[r] *= f;
                mx[r] = m_new[r];
                shift[r] = -m_new[r] * scale_log2;
              }
#pragma unroll
              for (int n = 0; n < NA; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  s[n][e] = exp2_approx(fmaf(s[n][e], scale_log2, shift[e >> 1]));  // e; 0 past the keys
                  dp[n][e] *= s[n][e];
                }
              }
              float tile_sum[2], tile_edp[2];
              row_reduce<NA>(tile_sum, s, AddOp());
              row_reduce<NA>(tile_edp, dp, AddOp());
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                sum[r] += tile_sum[r];
                edp[r] += tile_edp[r];
              }
            } else {
#pragma unroll
              for (int n = 0; n < NA; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  float ds = 0.0f;
                  if (c + 8 * n + 2 * t + (e & 1) < lim) {
                    const float p = exp2_approx(fmaf(s[n][e], scale_log2, shift[e >> 1])) * inv[e >> 1];
                    ds = p * (dp[n][e] - delta[e >> 1]);
                  }
                  s[n][e] = ds;
                }
              }
#pragma unroll
              for (int kk = 0; kk < NA / 2; ++kk) {
                if (c + 16 * kk < lim) weighted_split<DH, NA>(dqa, s, kk, k_s, c + 16 * kk, lane);
              }
            }
          }
        }
      };
      if (valid == kTile) {
        work(std::true_type());
      } else {
        work(std::false_type());
      }
      if (step == nt - 1) {  // the statistics are complete
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          inv[r] = 1.0f / quad_sum(sum[r]);
          delta[r] = quad_sum(edp[r]) * inv[r];
        }
        if (t == 0) {
          float* st = stats_of(stats, bh, sp);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = q0 + i0 + g + 8 * r;
            if (i < sp) {
              st[i] = shift[r];
              st[sp + i] = inv[r];
              st[2 * sp + i] = delta[r];
            }
          }
        }
      }
    }
  }
  if (live) {
    const float mul[2] = {scale, scale};
    store_tile<DH>(dq + head + static_cast<size_t>(q0 + i0) * DH, q_s, i0, dqa, mul,
                   min(16, s_len - q0 - i0), lane);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
    attn_unpacked_bwd_keys_kernel(const bf16* __restrict__ q,
                                  const bf16* __restrict__ k,
                                  const bf16* __restrict__ v,
                                  const bf16* __restrict__ d_o,
                                  bf16* __restrict__ dk, bf16* __restrict__ dv,
                                  const float* __restrict__ stats, int s_len,
                                  int tiles, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NB = kStep / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int sp = round16(s_len);
  const int bh = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - bh * tiles) * kRows;
  const size_t head = static_cast<size_t>(bh) * s_len * DH;
  const bf16* q_g = q + head;
  const bf16* do_g = d_o + head;
  const float* st_g = stats + static_cast<size_t>(bh) * 3 * sp;
  const int nt = (s_len + kTile - 1) / kTile;

  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kRows][DH], rows from j0
  bf16* v_s = k_s + kRows * DH;
  // kStages stages: q [kTile][DH], dO, the tile's 3 x kTile statistics
  unsigned char* stages = smem + 2 * Smem<DH>::own;
  auto stage_tile = [&](int it) {
    bf16* q_t = reinterpret_cast<bf16*>(stages + (it % kStages) * Smem<DH>::keys_stage);
    const int c0 = it * kTile;
    stage_rows<DH>(q_t, q_g + static_cast<size_t>(c0) * DH, kTile, s_len - c0);
    stage_rows<DH>(q_t + kTile * DH, do_g + static_cast<size_t>(c0) * DH, kTile, s_len - c0);
    float* st_t = reinterpret_cast<float*>(q_t + 2 * kTile * DH);
    for (int idx = threadIdx.x; idx < 3 * kTile / 4; idx += kThreads) {
      const int part = idx / (kTile / 4), i = c0 + 4 * (idx - part * (kTile / 4));
      cp_async16(st_t + 4 * idx, i < sp ? st_g + part * sp + i : st_g, i < sp);
    }
  };
  stage_rows<DH>(k_s, k + head + static_cast<size_t>(j0) * DH, kRows, s_len - j0);
  stage_rows<DH>(v_s, v + head + static_cast<size_t>(j0) * DH, kRows, s_len - j0);
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < nt) stage_tile(it);
    cp_async_commit();  // K and V join the first group
  }

  const int jr = 16 * warp;
  const bool live = j0 + jr < s_len;  // the same for the whole warp
  uint32_t kf[DH / 16][4], vf[DH / 16][4];
  float dka[DH / 8][4], dva[DH / 8][4];
  zero(dka);
  zero(dva);
  for (int it = 0; it < nt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this tile staged; the last tile's stage free
    if (it + kStages - 1 < nt) stage_tile(it + kStages - 1);
    cp_async_commit();
    const bf16* q_t = reinterpret_cast<const bf16*>(stages + (it % kStages) * Smem<DH>::keys_stage);
    const bf16* do_t = q_t + kTile * DH;
    const float* st_t = reinterpret_cast<const float*>(q_t + 2 * kTile * DH);
    const int valid = min(kTile, s_len - it * kTile);  // real query rows of the tile
    if (live) {
      if (it == 0) {
        load_a<DH>(kf, k_s, jr, lane);
        load_a<DH>(vf, v_s, jr, lane);
      }
      auto work = [&](auto full) {  // as in the forward
        const int lim = decltype(full)::value ? kTile : valid;
#pragma unroll
        for (int c = 0; c < kTile; c += kStep) {
          if (c < lim) {  // the same for the whole warp
            float pt[NB][4], dst[NB][4];  // p and ds transposed: [key][query]
            frag_dot<DH, NB>(pt, kf, q_t, c, lim, lane);
            frag_dot<DH, NB>(dst, vf, do_t, c, lim, lane);
#pragma unroll
            for (int n = 0; n < NB; ++n) {
              const int i = c + 8 * n + 2 * t;  // query columns i, i + 1 of the tile
              const float2 sh = *reinterpret_cast<const float2*>(st_t + i);
              const float2 iv = *reinterpret_cast<const float2*>(st_t + kTile + i);
              const float2 dl = *reinterpret_cast<const float2*>(st_t + 2 * kTile + i);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const bool col1 = e & 1;
                float p = 0.0f, ds = 0.0f;
                if (i + col1 < lim) {
                  p = exp2_approx(fmaf(pt[n][e], scale_log2, col1 ? sh.y : sh.x)) * (col1 ? iv.y : iv.x);
                  ds = p * (dst[n][e] - (col1 ? dl.y : dl.x));
                }
                pt[n][e] = p;
                dst[n][e] = ds;
              }
            }
#pragma unroll
            for (int kk = 0; kk < NB / 2; ++kk) {
              if (c + 16 * kk < lim) {
                weighted_split<DH, NB>(dva, pt, kk, do_t, c + 16 * kk, lane);
                weighted_split<DH, NB>(dka, dst, kk, q_t, c + 16 * kk, lane);
              }
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
    const int rows = min(16, s_len - j0 - jr);
    const float mul_k[2] = {scale, scale}, mul_v[2] = {1.0f, 1.0f};
    store_tile<DH>(dk + head + static_cast<size_t>(j0 + jr) * DH, k_s, jr, dka, mul_k, rows, lane);
    store_tile<DH>(dv + head + static_cast<size_t>(j0 + jr) * DH, v_s, jr, dva, mul_v, rows, lane);
  }
}

// Blocks of a launch over `rows` rows of each of `batch_heads` heads, or 0
// if the grid is too large.
int blocks_for(int batch_heads, int rows, int& tiles) {
  tiles = (rows + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(batch_heads) * tiles;
  return blocks > INT_MAX ? 0 : static_cast<int>(blocks);
}

template <int DH>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               int batch_heads, int s_len, float scale, cudaStream_t stream) {
  int tiles;
  const int blocks = blocks_for(batch_heads, s_len, tiles);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(attn_unpacked_fwd_kernel<DH>, Smem<DH>::fwd);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_unpacked_fwd_kernel<DH><<<blocks, kThreads, Smem<DH>::fwd, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), s_len, tiles,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bwd(const void* q, const void* k, const void* v, const void* d_o,
               void* dq, void* dk, void* dv, void* stats, int batch_heads,
               int s_len, float scale, cudaStream_t stream) {
  int tiles;
  const int blocks = blocks_for(batch_heads, s_len, tiles);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(attn_unpacked_bwd_rows_kernel<DH>, Smem<DH>::rows);
  if (err == cudaSuccess) err = allow_smem(attn_unpacked_bwd_keys_kernel<DH>, Smem<DH>::keys);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(d_o);
  attn_unpacked_bwd_rows_kernel<DH><<<blocks, kThreads, Smem<DH>::rows, stream>>>(
      q_, k_, v_, do_, static_cast<bf16*>(dq), static_cast<float*>(stats), s_len,
      tiles, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_unpacked_bwd_keys_kernel<DH><<<blocks, kThreads, Smem<DH>::keys, stream>>>(
      q_, k_, v_, do_, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<const float*>(stats), s_len, tiles, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int info(int which, int* out) {
  switch (which) {
    case 0: return kernel_info(attn_unpacked_fwd_kernel<DH>, kThreads, Smem<DH>::fwd, out);
    case 1: return kernel_info(attn_unpacked_bwd_rows_kernel<DH>, kThreads, Smem<DH>::rows, out);
    case 2: return kernel_info(attn_unpacked_bwd_keys_kernel<DH>, kThreads, Smem<DH>::keys, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Called by ssip_attention_fwd / _bwd (attention.cu) for bfloat16 tensors,
// which have checked 1 <= s_len <= 1024. `stats` is the caller's float32
// scratch of batch_heads·3·round16(s_len) values.
int attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                       int batch_heads, int s_len, int dh, float scale,
                       cudaStream_t stream) {
  if (dh == 64) return launch_fwd<64>(q, k, v, o, batch_heads, s_len, scale, stream);
  if (dh == 32) return launch_fwd<32>(q, k, v, o, batch_heads, s_len, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int attention_bwd_bf16(const void* q, const void* k, const void* v,
                       const void* d_o, void* dq, void* dk, void* dv,
                       void* stats, int batch_heads, int s_len, int dh,
                       float scale, cudaStream_t stream) {
  if (stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (dh == 64) {
    return launch_bwd<64>(q, k, v, d_o, dq, dk, dv, stats, batch_heads, s_len, scale, stream);
  }
  if (dh == 32) {
    return launch_bwd<32>(q, k, v, d_o, dq, dk, dv, stats, batch_heads, s_len, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// For measurement: `which` 0 (forward), 1 (backward rows) or 2 (backward
// keys) at head width `dh`; out[4] = registers a thread, local bytes a
// thread (spills), shared memory bytes a block, resident blocks an SM.
// Returns the CUDA error (0 on success).
extern "C" int ssip_attention_unpacked_info(int which, int dh, int* out) {
  if (dh == 64) return info<64>(which, out);
  if (dh == 32) return info<32>(which, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
