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

// sigmoid and tanh from the fast exponential (ex2.approx) and division, a
// few float32 ulp from the above: the element-wise math of the bf16
// tensor-core paths, whose products round their operands to bf16 anyway
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
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

// Row stride (in elements, float32 or bf16) for an mma operand tile with
// kdim columns: stride % 16 == 8 spreads the 8 rows that a fragment load
// reads at once over distinct shared-memory banks.
__host__ __device__ __forceinline__ int mma_stride(int kdim) {
  return kdim + ((8 - kdim % 16) + 16) % 16;
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two consecutive bf16 operand elements as one bf16x2 register.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// a bf16 pair (low half first) widened, exactly, to float32
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
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

// ldmatrix: four 8 x 8 bf16 matrices from shared memory (16-byte aligned
// rows), lane l giving the address of row l % 8 of matrix l / 8; lane
// (gid, tig) receives of matrix i the elements [gid][2 tig, 2 tig + 1] in
// r[i]. For an mma A operand stored [m][k] pass A + (m0 + l % 8 + 8 ((l / 8)
// % 2)) * lda + k0 + 8 (l / 16); for a B operand stored [n][k] (two 8-column
// tiles, n0 and n0 + 8) pass B + (n0 + l % 8 + 8 (l / 16)) * ldb + k0 + 8
// ((l / 8) % 2): r[0], r[1] are then tile n0's b0, b1 and r[2], r[3] tile
// n0 + 8's.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes from device memory into shared memory without passing through
// registers (cp.async); complete after the cp_async_wait that covers its
// commit group.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// waits until at most n of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Named barriers (ids 1..15; 0 is __syncthreads), count threads in all, a
// multiple of 32. sync waits for the count; arrive counts itself and goes
// on. Shared-memory writes before either are visible to the threads that
// pass the sync.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The four float32 values of an accumulator pair (rows gid and gid + 8, two
// columns each) as the bf16 A fragment half they form: an m16n8 tile of
// columns k0..k0+7 and its neighbour k0+8..k0+15 are exactly the A operand
// of an m16n8k16 product over those 16 columns.
__device__ __forceinline__ void acc_to_a(const float (&lo)[4],
                                         const float (&hi)[4],
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(make_float2(lo[0], lo[1]));
  a[1] = pack_bf16(make_float2(lo[2], lo[3]));
  a[2] = pack_bf16(make_float2(hi[0], hi[1]));
  a[3] = pack_bf16(make_float2(hi[2], hi[3]));
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
