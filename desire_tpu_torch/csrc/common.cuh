// Helpers shared by the hand-written kernels of desire_tpu_torch.
//
// CD is the compute dtype: float or __nv_bfloat16. Products round their
// operands to CD and accumulate in float32, as the TPU kernels do; the
// element-wise math runs in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace desire {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename CD>
__device__ __forceinline__ CD from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// x rounded to CD and back (a no-op for float)
template <typename CD>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<CD>(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Block-wide product with a per-output epilogue:
//   epi(r, c, sum_k A[r * lda + k] * W[k * ldw + c])  for r < m, c < ncols.
// A is float32 in shared memory, already rounded to CD, with its row count
// padded to a multiple of RG (padding rows are read, never stored). W is CD
// (shared or device memory), row-major with leading dimension ldw. Threads
// take consecutive columns, so W loads coalesce and A loads broadcast; each
// thread keeps RG row accumulators in registers.
template <int RG, typename CD, typename Epi>
__device__ __forceinline__ void block_mm(const float* A, int lda, int m,
                                         int kdim, const CD* W, int ldw,
                                         int ncols, Epi epi) {
  const int groups = (m + RG - 1) / RG;
  for (int item = threadIdx.x; item < groups * ncols; item += blockDim.x) {
    const int col = item % ncols;
    const int g = item / ncols;
    const float* a = A + g * RG * lda;
    float acc[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) acc[r] = 0.f;
    for (int k = 0; k < kdim; ++k) {
      const float w = to_f(W[(size_t)k * ldw + col]);
#pragma unroll
      for (int r = 0; r < RG; ++r) acc[r] = fmaf(a[r * lda + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RG; ++r)
      if (g * RG + r < m) epi(g * RG + r, col, acc[r]);
  }
}

// Row stride (in elements, float32 or bf16) for a block_mma operand with
// kdim columns: stride % 16 == 8 spreads the 8 rows that a fragment load
// reads at once over distinct shared-memory banks.
__host__ __device__ __forceinline__ int mma_stride(int kdim) {
  return kdim + ((8 - kdim % 16) + 16) % 16;
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two consecutive operand elements as one bf16x2 register: float32 pairs
// are rounded to bf16 (round to nearest even), bf16 pairs loaded as is.
__device__ __forceinline__ uint32_t load_pair(const float* p) {
  return pack_bf16(*reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Block-wide tensor-core product of mtiles * 16 rows, bf16 operands and
// float32 accumulation (mma.sync m16n8k16):
//   epi(r, c, sum_k A[r * lda + k] * WT[c * ldwt + k])
// A is in shared memory, float32 (rounded to bf16 as it is loaded) or bf16,
// lda even (best mma_stride(kdim)); WT is the weight matrix TRANSPOSED,
// (ncols, kdim) bf16 with an even row stride ldwt, in shared or device
// memory. kdim % 16 == 0, ncols % 8 == 0, mtiles % MT == 0. A warp's work
// item is one 8-column tile for MT row tiles: a larger MT reuses each
// weight fragment more, a smaller one spreads small products over more
// warps.
template <int MT, typename AT, typename Epi>
__device__ __forceinline__ void block_mma(const AT* A, int lda, int mtiles,
                                          int kdim, const __nv_bfloat16* WT,
                                          int ldwt, int ncols, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int ctiles = ncols / 8;
  for (int item = warp; item < ctiles * (mtiles / MT);
       item += blockDim.x / 32) {
    const int c0 = (item % ctiles) * 8, r0 = (item / ctiles) * MT * 16;
    float acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
    const __nv_bfloat16* b = WT + (size_t)(c0 + gid) * ldwt + tig * 2;
    for (int k0 = 0; k0 < kdim; k0 += 16) {
      const uint32_t b0 = load_pair(b + k0);
      const uint32_t b1 = load_pair(b + k0 + 8);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const AT* lo = A + (r0 + m * 16 + gid) * lda + k0 + tig * 2;
        const AT* hi = lo + 8 * lda;
        mma_bf16(acc[m], load_pair(lo), load_pair(hi), load_pair(lo + 8),
                 load_pair(hi + 8), b0, b1);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = r0 + m * 16 + gid, c = c0 + tig * 2;
      epi(r, c, acc[m][0]);
      epi(r, c + 1, acc[m][1]);
      epi(r + 8, c, acc[m][2]);
      epi(r + 8, c + 1, acc[m][3]);
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Offsets of a block's shared-memory regions, each 16-byte aligned; the
// host sizes the launch with the same arithmetic.
struct Bump {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t o = (off + 15) & ~size_t(15);
    off = o + bytes;
    return o;
  }
};

// The largest dynamic shared memory one block may use on Hopper.
constexpr size_t kMaxSmem = 232448;

}  // namespace desire
