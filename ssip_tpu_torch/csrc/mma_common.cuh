// Helpers shared by the attention kernels on Hopper's tensor cores
// (attention_mma.cu, attention_unpacked_mma.cu, attention_f32_mma.cu) and,
// for cp.async and the host's helpers, the LayerNorm kernels (layernorm.cu):
// cp.async staging, ldmatrix, mma.sync on bf16, the bf16 row swizzle, quad
// reductions over an mma accumulator's row, the exponential, and the host's
// shared-memory opt-in and resource query.
//
// Everything here is in namespace ssip_mma, device code __forceinline__; a
// source takes it into its own anonymous namespace with `using namespace
// ssip_mma;`.

#ifndef SSIP_TPU_TORCH_CSRC_MMA_COMMON_CUH_
#define SSIP_TPU_TORCH_CSRC_MMA_COMMON_CUH_

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssip_mma {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when `full` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for one 16 x 8 tile, k = 16.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest even bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Max and sum over the 4 lanes of a quad: the lanes that share an
// accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x, about 2 ulp; 0 for -inf.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Element offset of 16-byte chunk `chunk` of row `row` in a staged bf16
// [rows, DH] matrix: the chunk index XOR a function of the row, so rows
// r .. r+7 (r a multiple of 8) at one logical chunk hit 8 bank groups.
template <int DH>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int CH = DH / 8;
  const int x = CH == 8 ? (row & 7) : ((row >> 1) & 3);
  return row * DH + ((chunk ^ x) << 3);
}

// Address a lane gives ldmatrix for an A fragment (rows row0 .. row0+15,
// columns 16*ks ..) or, with .trans, for the B fragments of two n tiles of
// a matrix stored [k][n] (k rows row0 .. row0+15, n columns 16*ks ..).
template <int DH>
__device__ __forceinline__ uint32_t addr_a(const bf16* base, int row0, int ks,
                                           int lane) {
  return smem_addr(base + swz<DH>(row0 + (lane & 15), 2 * ks + (lane >> 4)));
}

// Address for the B fragments of two n tiles of a matrix stored [n][k]
// (n rows row0 .. row0+15, k columns 16*ks ..): registers 0, 1 serve the
// first tile, 2, 3 the second.
template <int DH>
__device__ __forceinline__ uint32_t addr_b(const bf16* base, int row0, int ks,
                                           int lane) {
  return smem_addr(base + swz<DH>(row0 + (lane & 7) + ((lane >> 4) << 3),
                                  2 * ks + ((lane >> 3) & 1)));
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
}

// Row maxima and row sums of this thread's part of a 16 x 8·NT accumulator
// tile (row g: elements 0 and 1 of each n tile; row g+8: 2 and 3), by
// pairwise trees rather than one chain. NT is a power of two.
template <int NT, typename Op>
__device__ __forceinline__ void row_reduce(float (&out)[2], const float (&x)[NT][4], Op op) {
  float part[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    part[n][0] = op(x[n][0], x[n][1]);
    part[n][1] = op(x[n][2], x[n][3]);
  }
#pragma unroll
  for (int w = 1; w < NT; w *= 2) {
#pragma unroll
    for (int n = 0; n + w < NT; n += 2 * w) {
      part[n][0] = op(part[n][0], part[n + w][0]);
      part[n][1] = op(part[n][1], part[n + w][1]);
    }
  }
  out[0] = part[0][0];
  out[1] = part[0][1];
}

struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct AddOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

// Lets `kernel` launch with `bytes` of dynamic shared memory (past 48 KB).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// What the card makes of one kernel launched with `threads` a block and
// `dynamic` bytes of shared memory: out[4] = registers a thread, local
// (spilled) bytes a thread, shared memory a block (static + dynamic) and
// resident blocks an SM. Returns the CUDA error (0 on success).
template <typename Kernel>
int kernel_info(Kernel kernel, int threads, size_t dynamic, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = allow_smem(kernel, dynamic);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dynamic);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes + dynamic);
  out[3] = blocks;
  return 0;
}

}  // namespace ssip_mma

#endif  // SSIP_TPU_TORCH_CSRC_MMA_COMMON_CUH_
