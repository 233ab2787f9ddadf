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
// here: a thread owns its (row, lane) and loops over the T steps in
// registers (forward), or owns one (row, lane, step) (backward). The
// backward's block reads its contiguous run of raw5 into shared memory with
// 16-byte coalesced loads and writes d_raw5 back the same way (a thread's
// own 5 floats lie 20 bytes apart, so direct accesses touched ~20 sectors a
// warp instruction and wrote partial sectors).
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

__global__ void nll_fwd_kernel(const float* __restrict__ raw5,
                               const float* __restrict__ target,
                               const float* __restrict__ mask,
                               float* __restrict__ out, int N, int K,
                               int T) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;  // (n, k)
  if (i >= (long)N * K) return;
  const long n = i / K;
  const float* r = raw5 + i * T * 5;
  float acc = 0.f;
  for (int t = 0; t < T; ++t) {
    const float* tg = target + (n * T + t) * 2;
    const Step s = step_terms(r + t * 5, tg[0], tg[1]);
    acc += -fmaxf(s.logp, kLogFloor) * mask[n * T + t];
  }
  out[i] = acc;
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
  const long rows = (long)N * K;
  if (rows == 0) return 0;
  desire::nll_fwd_kernel<<<(unsigned)((rows + desire::kThreads - 1)
                                      / desire::kThreads),
                           desire::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      (const float*)raw5, (const float*)target, (const float*)mask,
      (float*)out, N, K, T);
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
