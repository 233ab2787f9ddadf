// The step-summed bivariate-Gaussian NLL and its gradient, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernels desire_tpu/ops/nll.py `_fwd_kernel` and
// `_bwd_kernel` (reached through `bivariate_nll_pallas`). Plain PyTorch
// version and wrapper: desire_tpu_torch/ops/nll.py.
//
//   forward   out[n, k] = sum_t -max(log N(target[n, t]; raw5[n, k, t]),
//                                    log 1e-20) * mask[n, t]
//   backward  d_raw5[n, k, t, :] = g[n, k] * d(term t)/d raw5, zero where
//             the floor is active; log sigma clamped to [-9, 6] (zero
//             gradient outside), rho = 0.999 tanh(raw).
//
// What bounds it on this card: bytes. Each (row, lane, step) reads five
// floats and does ~40 float32 operations, far below the card's ~20
// operations per byte in float32, so the floor is raw5 read once (and
// d_raw5 written once in the backward). The TPU kernel's selector
// products (broadcast and reduce over the K*T lane axis) have no place
// here: a thread owns its (row, lane) and sums the T steps in registers
// (forward), or owns one (row, lane, step) (backward). A thread's own
// floats lie T * 5 (forward) or 5 (backward) floats apart, so direct
// accesses to device memory touch ~20 sectors a warp instruction; both
// kernels stage their block's contiguous run of raw5 through shared
// memory with 16-byte coalesced accesses instead. The forward's block (one
// warp, 32 lanes) walks the steps in chunks of up to 32 (one chunk at the
// flagship's T = 12; any T fits its shared memory), also stages the
// target and mask rows of the few rows n its lanes cover, and lays each
// lane's chunk of 5-float steps at a row stride that
// is odd in its read width (16-byte pieces where T is a multiple of 4,
// else floats), so that a warp's reads of its 32 rows fall in distinct
// banks: at T = 12 a row of 60 floats is 15 pieces, odd already; a row
// read float by float at a stride of 60 words would put 32 threads on 8
// banks. Staged, the forward's loads alone take ~1.1x the bytes bound at
// the flagship shape and its arithmetic about as long again, so the
// forward's step term takes the cheaper exact forms: log sigma is the
// clamped input itself, not log(exp(.)), and (t - mu) / sigma is
// (t - mu) * exp(-log sigma). It rounds differently from the plain
// version by a few float32 ulps a term; it sums the steps in the same
// order as the plain version.
#include <type_traits>

#include "common.cuh"

namespace desire {
namespace {

constexpr float kLogFloor = -46.051701859880914f;  // log(1e-20)
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kLogSigmaMin = -9.f;
constexpr float kLogSigmaMax = 6.f;
constexpr float kRhoMax = 0.999f;

struct Step {
  float sx, sy, rho, nx, ny, omr, z, logp;
};

__device__ __forceinline__ Step step_terms(const float* r, float tx,
                                           float ty) {
  Step s;
  s.sx = expf(fminf(fmaxf(r[2], kLogSigmaMin), kLogSigmaMax));
  s.sy = expf(fminf(fmaxf(r[3], kLogSigmaMin), kLogSigmaMax));
  s.rho = tanhf(r[4]) * kRhoMax;
  s.nx = (tx - r[0]) / s.sx;
  s.ny = (ty - r[1]) / s.sy;
  s.omr = 1.f - s.rho * s.rho;
  s.z = s.nx * s.nx + s.ny * s.ny - 2.f * s.rho * s.nx * s.ny;
  s.logp = -s.z / (2.f * s.omr) - kLog2Pi - logf(s.sx) - logf(s.sy)
           - 0.5f * logf(s.omr);
  return s;
}

// log N(t; raw) of one step for the forward: step_terms' logp with
// log sigma taken as the clamped input and 1 / sigma as exp(-log sigma)
// (two logarithms and two divisions fewer).
__device__ __forceinline__ float step_logp(const float* r, float tx,
                                           float ty) {
  const float lx = fminf(fmaxf(r[2], kLogSigmaMin), kLogSigmaMax);
  const float ly = fminf(fmaxf(r[3], kLogSigmaMin), kLogSigmaMax);
  const float rho = tanhf(r[4]) * kRhoMax;
  const float nx = (tx - r[0]) * expf(-lx);
  const float ny = (ty - r[1]) * expf(-ly);
  const float omr = 1.f - rho * rho;
  const float z = nx * nx + ny * ny - 2.f * rho * nx * ny;
  return -z / (2.f * omr) - kLog2Pi - lx - ly - 0.5f * logf(omr);
}

// Block-wide copy of `count` floats between device memory and shared
// memory, either way, coalesced: 16-byte pieces where both ends are 16-byte
// aligned, else one float a thread a step. A kernel whose threads each own
// a run of floats at a stride (5 floats an item here, T * 5 a lane in the
// forward) stages the block's contiguous run through shared memory with it
// and reads its own run there.
__device__ __forceinline__ void block_copy(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int count) {
  int j0 = 0;
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
    const int n4 = count / 4;
    for (int j = threadIdx.x; j < n4; j += blockDim.x)
      reinterpret_cast<float4*>(dst)[j] =
          reinterpret_cast<const float4*>(src)[j];
    j0 = n4 * 4;
  }
  for (int j = j0 + threadIdx.x; j < count; j += blockDim.x) dst[j] = src[j];
}

constexpr int kFwdLanes = 32;  // (n, k) lanes a forward block, one a thread
// steps a forward block stages at a time: 32 lanes' rows of up to 32 steps
// and their target and mask rows take < 48 KB of shared memory at any K
constexpr int kFwdChunk = 32;

// Copies `rows` rows of `row` floats, `src_stride` floats apart in src,
// into dst at a row stride of `stride` floats, in pieces of V floats (V =
// 4: 16-byte pieces; row and both strides multiples of 4, both ends 16-byte
// aligned). Consecutive threads take consecutive pieces.
template <int V>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int rows, int row, int src_stride,
                                           int stride) {
  using Piece = typename std::conditional<V == 4, float4, float>::type;
  const int per_row = row / V;
  const int count = rows * per_row;
#pragma unroll 4
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int r = j / per_row, q = j - r * per_row;
    reinterpret_cast<Piece*>(dst)[r * (stride / V) + q] =
        reinterpret_cast<const Piece*>(src)[r * (src_stride / V) + q];
  }
}

// Rows n of target and mask that a block of `lanes` (n, k) lanes covers at
// most.
__host__ __device__ __forceinline__ int fwd_rows(int lanes, int N, int K) {
  const int rows = (lanes - 1) / K + 2;
  return rows < N ? rows : N;
}

// One warp a block, one thread a lane (n, k). The block walks the T steps
// in chunks of `chunk`: it stages its lanes' rows of the chunk into shared
// memory at a row stride of `stride` floats (odd in pieces of V floats),
// with the target and mask rows they need, and each thread adds its
// chunk's steps in order. V = 4 reads a lane's row 4 steps (20 floats) at
// a time as 16-byte pieces (T a multiple of 4), V = 1 float by float.
// Unchunked (T <= kFwdChunk) the loop runs once, folded at compile time,
// and the block's rows of raw5, target and mask are contiguous runs.
template <int V, bool kChunked>
__global__ void __launch_bounds__(kFwdLanes) nll_fwd_kernel(
    const float* __restrict__ raw5, const float* __restrict__ target,
    const float* __restrict__ mask, float* __restrict__ out, int N, int K,
    int T, int chunk, int stride) {
  extern __shared__ __align__(16) float smem[];
  const long lanes = (long)N * K;
  const long i0 = (long)blockIdx.x * blockDim.x;
  const int nl = lanes - i0 < (long)blockDim.x ? (int)(lanes - i0)
                                               : (int)blockDim.x;
  const long n0 = i0 / K;
  const int nr = (int)((i0 + nl - 1) / K - n0) + 1;
  float* r_s = smem;
  float* tg_s = r_s + blockDim.x * stride;
  float* m_s = tg_s + fwd_rows(blockDim.x, N, K) * chunk * 2;
  const long i = i0 + threadIdx.x;
  const int rn = (int)(i / K - n0);
  const float* r = r_s + threadIdx.x * stride;
  float acc = 0.f;
  for (int t0 = 0; t0 < T; t0 += kChunked ? chunk : T) {
    const int ct = !kChunked ? T : T - t0 < chunk ? T - t0 : chunk;
    if (kChunked && t0 > 0) __syncthreads();  // the last chunk's reads done
    stage_rows<V>(r_s, raw5 + (i0 * T + t0) * 5, nl, ct * 5, T * 5,
                  stride);
    if (kChunked) {
      stage_rows<1>(tg_s, target + (n0 * T + t0) * 2, nr, ct * 2,
                    T * 2, ct * 2);
      stage_rows<1>(m_s, mask + n0 * T + t0, nr, ct, T, ct);
    } else {
      block_copy(tg_s, target + n0 * T * 2, nr * T * 2);
      block_copy(m_s, mask + n0 * T, nr * T);
    }
    __syncthreads();
    if ((int)threadIdx.x >= nl) continue;
    const float* tg = tg_s + rn * ct * 2;
    const float* mk = m_s + rn * ct;
    if (V == 4) {
      for (int u0 = 0; u0 < ct; u0 += 4) {
        float4 v4[5];
#pragma unroll
        for (int q = 0; q < 5; ++q)
          v4[q] = reinterpret_cast<const float4*>(r + u0 * 5)[q];
        const float* v = reinterpret_cast<const float*>(v4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = u0 + u;
          acc += -fmaxf(step_logp(v + u * 5, tg[t * 2], tg[t * 2 + 1]),
                        kLogFloor) * mk[t];
        }
      }
    } else {
      for (int t = 0; t < ct; ++t) {
        acc += -fmaxf(step_logp(r + t * 5, tg[t * 2], tg[t * 2 + 1]),
                      kLogFloor) * mk[t];
      }
    }
  }
  if ((int)threadIdx.x < nl) out[i] = acc;
}

constexpr int kThreads = 256;

// One thread an item (n, k, t); the block's kThreads items are one
// contiguous run of raw5 and of d_raw5, staged through shared memory (an
// item's 5 floats at a 5-float stride: no bank conflicts).
__global__ void __launch_bounds__(kThreads) nll_bwd_kernel(
    const float* __restrict__ raw5, const float* __restrict__ target,
    const float* __restrict__ mask, const float* __restrict__ g,
    float* __restrict__ d_raw5, int N, int K, int T) {
  __shared__ __align__(16) float buf[kThreads * 5];
  const long items = (long)N * K * T;
  const long i0 = (long)blockIdx.x * kThreads;
  const int nb = items - i0 < kThreads ? (int)(items - i0) : kThreads;
  block_copy(buf, raw5 + i0 * 5, nb * 5);
  __syncthreads();
  if ((int)threadIdx.x < nb) {
    const long i = i0 + threadIdx.x;
    const int t = (int)(i % T);
    const long nk = i / T;
    const long n = nk / K;
    float r[5];
#pragma unroll
    for (int e = 0; e < 5; ++e) r[e] = buf[threadIdx.x * 5 + e];
    const float* tg = target + (n * T + t) * 2;
    const Step s = step_terms(r, tg[0], tg[1]);
    // d total / d logp = -g * mask * [logp above the floor]
    const float w = s.logp > kLogFloor ? -g[nk] * mask[n * T + t] : 0.f;
    float o[5];
    o[0] = w * (s.nx - s.rho * s.ny) / (s.sx * s.omr);
    o[1] = w * (s.ny - s.rho * s.nx) / (s.sy * s.omr);
    const bool in_x = r[2] > kLogSigmaMin && r[2] < kLogSigmaMax;
    const bool in_y = r[3] > kLogSigmaMin && r[3] < kLogSigmaMax;
    o[2] = in_x ? w * (s.nx * (s.nx - s.rho * s.ny) / s.omr - 1.f) : 0.f;
    o[3] = in_y ? w * (s.ny * (s.ny - s.rho * s.nx) / s.omr - 1.f) : 0.f;
    const float dlogp_drho = s.nx * s.ny / s.omr
                             - s.z * s.rho / (s.omr * s.omr) + s.rho / s.omr;
    const float th = tanhf(r[4]);
    o[4] = w * dlogp_drho * ((1.f - th * th) * kRhoMax);
#pragma unroll
    for (int e = 0; e < 5; ++e) buf[threadIdx.x * 5 + e] = o[e];
  }
  __syncthreads();
  block_copy(d_raw5 + i0 * 5, buf, nb * 5);
}


}  // namespace
}  // namespace desire

// raw5 (N, K, T, 5), target (N, T, 2), mask (N, T) float32 -> out (N, K)
// float32. Returns cudaGetLastError().
extern "C" int nll_fwd_launch(const void* raw5, const void* target,
                              const void* mask, void* out, int N, int K,
                              int T, void* stream) {
  const long lanes = (long)N * K;
  if (lanes == 0) return 0;
  const int chunk = T < desire::kFwdChunk ? T : desire::kFwdChunk;
  const bool vec = T % 4 == 0 && ((uintptr_t)raw5 & 15) == 0;
  const bool chunked = T > desire::kFwdChunk;
  // a row stride odd in the read width: conflict-free reads of 32 rows
  const int stride = vec ? 4 * ((chunk * 5 / 4) | 1) : ((chunk * 5) | 1);
  const int l = desire::kFwdLanes;
  const size_t smem =
      ((size_t)l * stride + (size_t)desire::fwd_rows(l, N, K) * chunk * 3)
      * sizeof(float);
  const unsigned grid = (unsigned)((lanes + l - 1) / l);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel =
      vec ? (chunked ? desire::nll_fwd_kernel<4, true>
                     : desire::nll_fwd_kernel<4, false>)
          : (chunked ? desire::nll_fwd_kernel<1, true>
                     : desire::nll_fwd_kernel<1, false>);
  kernel<<<grid, l, smem, st>>>((const float*)raw5, (const float*)target,
                                (const float*)mask, (float*)out, N, K, T,
                                chunk, stride);
  return (int)cudaGetLastError();
}

// raw5 (N, K, T, 5), target (N, T, 2), mask (N, T), g (N, K) float32 ->
// d_raw5 (N, K, T, 5) float32. Returns cudaGetLastError().
extern "C" int nll_bwd_launch(const void* raw5, const void* target,
                              const void* mask, const void* g, void* d_raw5,
                              int N, int K, int T, void* stream) {
  const long items = (long)N * K * T;
  if (items == 0) return 0;
  desire::nll_bwd_kernel<<<(unsigned)((items + desire::kThreads - 1)
                                      / desire::kThreads),
                           desire::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      (const float*)raw5, (const float*)target, (const float*)mask,
      (const float*)g, (float*)d_raw5, N, K, T);
  return (int)cudaGetLastError();
}
