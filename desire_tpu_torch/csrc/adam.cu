// The optimizer step: the gradients' global norm, the clip by it and Adam,
// over every leaf of a parameter tree in two launches, for NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel. The JAX package runs optax's chain
// (clip_by_global_norm, then adam with a staircase exponential decay),
// which XLA fuses on the TPU. Eager PyTorch ran it leaf by leaf, about 20
// launches a leaf, so the step's host time went into launches. Plain
// PyTorch version and wrapper: desire_tpu_torch/ops/adam.py.
//
//   grad_sumsq  norm = sqrt(sum over every leaf of sum g^2)
//   clip_adam   g' = norm < max_norm ? g : (g / norm) * max_norm  (a NaN
//               norm fails the test: every output turns NaN, as optax's)
//               m' = (1 - b1) g' + b1 m,  v' = (1 - b2) g'^2 + b2 v
//               p' = p + ((m' / bc1) / (sqrt(v' / bc2) + eps)) * (-lr)
//
// What bounds it on this card: bytes. A few operations an element against
// 28 bytes moved (g read twice, p, m and v read once, p', m' and v'
// written once): 52.6 MB at the flagship's 1.64 M values, 15.7 us at 3.35
// TB/s.
//
// Design: two launches, the leaf table passed by value. The host writes
// the leaves' pointers and sizes into a kernel argument (`LeafTable`,
// ~12.6 KB: sm_90 takes up to 32,764 bytes of arguments from CUDA 12.1),
// so no table is copied to the card and nothing waits for it. The leaves
// are laid end to end in one index space, each leaf's start rounded up to
// a multiple of 4 values; that is also the layout of the three flat output
// buffers. A block takes one fixed chunk of that space and walks the
// leaves that overlap it (found by a binary search of the starts), so a
// 1-value leaf costs no more than its share. Loads and stores are 16
// bytes a thread where a leaf's pointers allow (every output start is 16
// bytes aligned), with a scalar tail.
//
// The norm is deterministic: a fixed grid, a fixed order of the sums in a
// thread, a block (warp shuffles, then the warps in order) and over the
// blocks' partial sums, and no float atomics. The last block of
// grad_sumsq to finish (an integer ticket, reset by that block) sums every
// block's partial in the same order and writes the norm, a 0-d tensor
// that clip_adam reads. clip_adam rounds every operation as the plain
// version does (no contraction into fused multiply-adds), so given the
// same norm it computes the plain version's numbers.
#include "common.cuh"

namespace desire {
namespace {

constexpr int kMaxLeaves = 256;
constexpr int kThreads = 256;
constexpr long long kChunk = 4096;  // values a block, a multiple of 4

constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
// 1 - b as the plain version has it: the difference in double, rounded
constexpr float kC1 = (float)(1.0 - 0.9), kC2 = (float)(1.0 - 0.999);

constexpr unsigned char kVecG = 1;    // g 16-byte aligned
constexpr unsigned char kVecAll = 2;  // g, p, m and v 16-byte aligned

struct LeafTable {
  long long start[kMaxLeaves + 1];  // start[n]: the whole padded size
  long long size[kMaxLeaves];
  const float* g[kMaxLeaves];
  const float* p[kMaxLeaves];
  const float* m[kMaxLeaves];
  const float* v[kMaxLeaves];
  unsigned char vec[kMaxLeaves];
  int n;
};

// the last leaf that starts at or before c
__device__ __forceinline__ int first_leaf(const LeafTable& t, long long c) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.start[mid] <= c) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// The sum over the block's threads, in a fixed order; valid in thread 0.
// red: kThreads / 32 floats of shared memory, free on entry.
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = threadIdx.x < kThreads / 32 ? red[threadIdx.x] : 0.f;
  return threadIdx.x < 32 ? warp_sum(x) : 0.f;
}

__global__ void __launch_bounds__(kThreads) grad_sumsq_kernel(
    const __grid_constant__ LeafTable t, float* __restrict__ partials,
    unsigned* __restrict__ ticket, float* __restrict__ norm) {
  __shared__ float red[kThreads / 32];
  __shared__ bool last;
  const long long c0 = blockIdx.x * kChunk;
  const long long c1 = min(c0 + kChunk, t.start[t.n]);
  float acc = 0.f;
  for (int l = first_leaf(t, c0); l < t.n && t.start[l] < c1; ++l) {
    const long long s = t.start[l];
    const long long a = max(c0, s) - s, b = min(c1 - s, t.size[l]);
    if (a >= b) continue;  // an empty leaf
    const float* g = t.g[l];
    long long tail = a;
    if (t.vec[l] & kVecG) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      for (long long q = a / 4 + threadIdx.x; q < b / 4; q += kThreads) {
        const float4 x = g4[q];
        acc = fmaf(x.x, x.x, acc);
        acc = fmaf(x.y, x.y, acc);
        acc = fmaf(x.z, x.z, acc);
        acc = fmaf(x.w, x.w, acc);
      }
      tail = b / 4 * 4;
    }
    for (long long i = tail + threadIdx.x; i < b; i += kThreads)
      acc = fmaf(g[i], g[i], acc);
  }
  const float part = block_sum(acc, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = part;
    __threadfence();  // the partial is visible before the ticket counts it
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  float sum = 0.f;
  for (unsigned i = threadIdx.x; i < gridDim.x; i += kThreads)
    sum += __ldcg(partials + i);  // from L2: other blocks wrote them
  sum = block_sum(sum, red);
  if (threadIdx.x == 0) {
    *norm = sqrtf(sum);
    *ticket = 0u;  // ready for the next launch on this stream
  }
}

struct Step {
  float norm, max_norm, neg_lr, bc1, bc2;
  bool keep;
};

// One value's clip and Adam update, each operation rounded as the plain
// version's.
__device__ __forceinline__ void update(const Step& s, float g, float p,
                                       float m, float v, float& po,
                                       float& mo, float& vo) {
  if (!s.keep) g = __fmul_rn(__fdiv_rn(g, s.norm), s.max_norm);
  mo = __fadd_rn(__fmul_rn(kC1, g), __fmul_rn(kB1, m));
  vo = __fadd_rn(__fmul_rn(kC2, __fmul_rn(g, g)), __fmul_rn(kB2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vo, s.bc2)), kEps);
  po = __fadd_rn(p, __fmul_rn(__fdiv_rn(__fdiv_rn(mo, s.bc1), den),
                              s.neg_lr));
}

__global__ void __launch_bounds__(kThreads) clip_adam_kernel(
    const __grid_constant__ LeafTable t, const float* __restrict__ norm,
    float* __restrict__ p_out, float* __restrict__ m_out,
    float* __restrict__ v_out, float max_norm, float lr, float bc1,
    float bc2) {
  Step st;
  st.norm = *norm;
  st.max_norm = max_norm;
  st.keep = st.norm < max_norm;  // false for a NaN norm
  st.neg_lr = -lr;
  st.bc1 = bc1;
  st.bc2 = bc2;
  const long long c0 = blockIdx.x * kChunk;
  const long long c1 = min(c0 + kChunk, t.start[t.n]);
  for (int l = first_leaf(t, c0); l < t.n && t.start[l] < c1; ++l) {
    const long long s = t.start[l];
    const long long a = max(c0, s) - s, b = min(c1 - s, t.size[l]);
    if (a >= b) continue;
    const float *g = t.g[l], *p = t.p[l], *m = t.m[l], *v = t.v[l];
    float *po = p_out + s, *mo = m_out + s, *vo = v_out + s;
    long long tail = a;
    if (t.vec[l] & kVecAll) {
      for (long long q = a / 4 + threadIdx.x; q < b / 4; q += kThreads) {
        const float4 g4 = reinterpret_cast<const float4*>(g)[q];
        const float4 p4 = reinterpret_cast<const float4*>(p)[q];
        const float4 m4 = reinterpret_cast<const float4*>(m)[q];
        const float4 v4 = reinterpret_cast<const float4*>(v)[q];
        float4 pn, mn, vn;
        update(st, g4.x, p4.x, m4.x, v4.x, pn.x, mn.x, vn.x);
        update(st, g4.y, p4.y, m4.y, v4.y, pn.y, mn.y, vn.y);
        update(st, g4.z, p4.z, m4.z, v4.z, pn.z, mn.z, vn.z);
        update(st, g4.w, p4.w, m4.w, v4.w, pn.w, mn.w, vn.w);
        reinterpret_cast<float4*>(po)[q] = pn;
        reinterpret_cast<float4*>(mo)[q] = mn;
        reinterpret_cast<float4*>(vo)[q] = vn;
      }
      tail = b / 4 * 4;
    }
    for (long long i = tail + threadIdx.x; i < b; i += kThreads)
      update(st, g[i], p[i], m[i], v[i], po[i], mo[i], vo[i]);
    // the leaf's padding, zero (a saved buffer holds no stale bytes)
    const long long pad_end = min(c1, t.start[l + 1]) - s;
    for (long long i = b + threadIdx.x; i < pad_end; i += kThreads)
      po[i] = mo[i] = vo[i] = 0.f;
  }
}

bool aligned(const void* x) { return ((uintptr_t)x & 15) == 0; }

// The table of n leaves (p, m and v may be null: grad_sumsq reads g
// alone); false when n is out of range.
bool fill(LeafTable& t, int n, const long long* size, const void* const* g,
          const void* const* p, const void* const* m, const void* const* v) {
  if (n < 1 || n > kMaxLeaves) return false;
  t.n = n;
  t.start[0] = 0;
  for (int l = 0; l < n; ++l) {
    t.size[l] = size[l];
    t.start[l + 1] = t.start[l] + (size[l] + 3) / 4 * 4;
    t.g[l] = static_cast<const float*>(g[l]);
    t.p[l] = p ? static_cast<const float*>(p[l]) : nullptr;
    t.m[l] = m ? static_cast<const float*>(m[l]) : nullptr;
    t.v[l] = v ? static_cast<const float*>(v[l]) : nullptr;
    t.vec[l] = aligned(g[l]) ? kVecG : 0;
    if (p && aligned(g[l]) && aligned(p[l]) && aligned(m[l]) &&
        aligned(v[l]))
      t.vec[l] |= kVecAll;
  }
  return true;
}

unsigned blocks(const LeafTable& t) {
  return (unsigned)((t.start[t.n] + kChunk - 1) / kChunk);
}

}  // namespace
}  // namespace desire

// The layout of n leaves of these sizes: start (n + 1 values) gets each
// leaf's start in the padded index space, the flat buffers' layout, and
// start[n] their size. Returns the number of blocks a launch takes (the
// partials grad_sumsq_launch needs), or -1 when n is not in
// [1, kMaxLeaves].
extern "C" long long adam_layout(int n, const long long* size,
                                 long long* start) {
  if (n < 1 || n > desire::kMaxLeaves) return -1;
  start[0] = 0;
  for (int l = 0; l < n; ++l) start[l + 1] = start[l] + (size[l] + 3) / 4 * 4;
  return (start[n] + desire::kChunk - 1) / desire::kChunk;
}

// g: n leaves' pointers (float32, contiguous), size: their sizes.
// partials: adam_layout's count of float32; ticket: one uint32, zero
// before the first launch on a stream (each launch leaves it zero); norm:
// one float32, written. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for n out of range.
extern "C" int grad_sumsq_launch(int n, const long long* size,
                                 const void* const* g, void* partials,
                                 void* ticket, void* norm, void* stream) {
  desire::LeafTable t;
  if (!desire::fill(t, n, size, g, nullptr, nullptr, nullptr))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = desire::blocks(t);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  desire::grad_sumsq_kernel<<<grid, desire::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      t, (float*)partials, (unsigned*)ticket, (float*)norm);
  return (int)cudaGetLastError();
}

// g, p, m, v: n leaves' pointers each (float32, contiguous), size: their
// sizes; norm: the gradients' global norm (one float32 on the card);
// p_out, m_out, v_out: flat float32 buffers in adam_layout's layout,
// 16-byte aligned, written whole (each leaf's padding zero). lr, bc1,
// bc2: the step's rate and bias corrections, max_norm the clip. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for n out of range.
extern "C" int clip_adam_launch(int n, const long long* size,
                                const void* const* g, const void* const* p,
                                const void* const* m, const void* const* v,
                                const void* norm, void* p_out, void* m_out,
                                void* v_out, float max_norm, float lr,
                                float bc1, float bc2, void* stream) {
  desire::LeafTable t;
  if (!desire::fill(t, n, size, g, p, m, v) || !desire::aligned(p_out) ||
      !desire::aligned(m_out) || !desire::aligned(v_out))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = desire::blocks(t);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  desire::clip_adam_kernel<<<grid, desire::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      t, (const float*)norm, (float*)p_out, (float*)m_out, (float*)v_out,
      max_norm, lr, bc1, bc2);
  return (int)cudaGetLastError();
}
