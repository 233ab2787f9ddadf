// The fused IOC rank-and-refine loop (inference) for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel desire_tpu/ops/ioc_fused.py `_kernel`, reached
// through `ioc_refine_fused`: all num_refine passes plus the final
// re-score. With collect_iters=False (inference, msg=None) it returns the
// refined positions and the scores; with collect_iters=True (the training
// forward of `make_trainable_fused_ioc`) it also writes every refine pass's
// positions, which the backward kernel (csrc/ioc_refine_bwd.cu) recomputes
// each pass from. Plain PyTorch version and wrapper:
// desire_tpu_torch/ops/ioc_fused.py.
//
// What bounds it on this card: the serial dependency chain. Each block
// walks (num_refine + 1) passes x T steps (5 x 12 at the flagship shape),
// and every step needs the previous step's GRU state; within a step, the
// work is a few small products over the lane's A agents (~31k
// multiply-adds per agent). Bytes are small: dec_h is read once per step
// and pass, the rest stays on chip.
//
// What the design does about it:
// * One block per (batch row, lane) holds all A agents of that lane.
//   Social attention mixes agents only within one lane and one step, so
//   nothing crosses blocks; B x K blocks (1,280 at flagship) fill the card.
// * All state lives in shared memory: the GRU state h (A, d) in float32,
//   the (T, A) x/y position planes, the per-step head outputs (T, A, 4)
//   (the deltas need gate/dx/dy after the pass, the scores only psi), the
//   (G, G, C) feature map and all weights, in the compute dtype. If the
//   feature map does not fit (float32 at G = 32, C = 32) it is read from
//   device memory instead.
// * In bf16 with A <= 64, d <= 128 and d, C multiples of 16 (the
//   flagship), the four per-step products (messages, social pooling, the
//   score GRU's gates, the heads) run on the tensor cores (mma.sync,
//   common.cuh) over 64 padded agent rows. The GRU's weights are laid out
//   so that one warp holds the r, z and n gates of 8 hidden units for 32
//   rows and updates h in registers. The next step's dec_h tile is
//   prefetched into registers while the current step runs. Otherwise the
//   products are loops on the CUDA cores.
// * The pass-invariant products dec_h [Wid | Wmsg] are recomputed at every
//   step from the step's dec_h tile, not staged in device memory: staging
//   would cost a (B, A, K, T, 3d) float32 buffer (2.6 GB at flagship).
// * Scene pooling is the 4-corner align-corners gather, which equals the
//   TPU kernel's tent weights over all G^2 nodes.
// * social_freeze attends at the initial positions in every pass, which
//   gives the same pooled block as attending once.
// * No agent padding in device memory: loops mask the ragged edge.
// Numerics match the TPU kernel: products round operands to the compute
// dtype and accumulate in float32; distances and the social softmax stay
// float32 under bf16; msg is rounded, plus the rounded bias, rounded again;
// the deltas are applied after the pass; scores sum psi * fut_mask over
// ascending t in float32. The tensor-core path sums the dec, scene and
// social parts of the input gates in one float32 accumulation.
#include <type_traits>

#include "common.cuh"

namespace desire {
namespace {

constexpr int kThreads = 512;
constexpr int kMmaRows = 64;  // agent rows of the tensor-core path
// dec_h tile pieces per thread on that path (A * d / 8 <= kDecPieces *
// kThreads)
constexpr int kDecPieces = 2;

// Shared-memory layout. X holds the score GRU's input blocks per agent,
// [dec_h (d) | scene (C) | social (d)]; att the social weights; msg the
// messages, (agent, d) row-major on the CUDA-core path and transposed
// (d, agent) on the tensor-core path. Weights are stored as the kernel
// takes them: row-major (in, out) on the CUDA-core path, transposed
// (out, in) on the tensor-core path, with padded rows.
template <typename CD, bool kMma>
struct IocLayout {
  using XT = typename std::conditional<kMma, __nv_bfloat16, CD>::type;
  int rows, kx, lx, la, lh, lm, lwx, lwh, lwm, lwo;
  size_t fmap, wx, wh, wmsg, headw, wiv, bi, bh, headb, bmsg;
  size_t x, y, x0, y0, fmask, out, h, hn, score, nbok, live, lg, X, att;
  size_t msg;
  size_t total;
  __host__ __device__ IocLayout(int A, int T, int d, int C, int G,
                                bool fmap_smem) {
    const int d3 = 3 * d;
    kx = 2 * d + C;
    rows = kMma ? kMmaRows : A;
    lx = kMma ? mma_stride(kx) : kx;
    la = kMma ? mma_stride(kMmaRows) : A;
    lh = kMma ? mma_stride(d) : d;
    lm = kMma ? mma_stride(kMmaRows) : d;
    lwx = kMma ? mma_stride(kx) : d3;
    lwh = kMma ? mma_stride(d) : d3;
    lwm = kMma ? mma_stride(d) : d;
    lwo = kMma ? mma_stride(d) : 4;
    const size_t cs = sizeof(CD), xs = sizeof(XT);
    Bump b;
    fmap = fmap_smem ? b.take((size_t)G * G * C * cs) : 0;
    wx = b.take((size_t)(kMma ? d3 : kx) * lwx * cs);
    wh = b.take((size_t)(kMma ? d3 : d) * lwh * cs);
    wmsg = b.take((size_t)d * lwm * cs);
    headw = b.take((size_t)(kMma ? 8 : d) * lwo * cs);
    wiv = b.take(2 * (size_t)d3 * 4);
    bi = b.take((size_t)d3 * 4);
    bh = b.take((size_t)d3 * 4);
    headb = b.take(4 * 4);
    bmsg = b.take((size_t)d * 4);
    x = b.take((size_t)T * A * 4);
    y = b.take((size_t)T * A * 4);
    x0 = b.take((size_t)T * A * 4);
    y0 = b.take((size_t)T * A * 4);
    fmask = b.take((size_t)T * A * 4);
    out = b.take((size_t)T * A * 4 * 4);
    h = b.take((size_t)rows * lh * 4);
    hn = b.take((size_t)rows * lh * 4);
    score = b.take((size_t)A * 4);
    nbok = b.take((size_t)A * 4);
    live = b.take((size_t)A * 4);
    lg = b.take((size_t)(kThreads / 32) * A * 4);
    X = b.take((size_t)rows * lx * xs);
    att = b.take((size_t)rows * la * xs);
    msg = b.take((size_t)(kMma ? d : A) * lm * xs);
    total = b.off;
  }
};

// rows x cols elements from a dense source into rows of stride dst_ld
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dst_ld, const T* src,
                                          int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
    dst[(i / cols) * dst_ld + i % cols] = src[i];
}

template <typename T>
__device__ __forceinline__ void zero(T* p, size_t bytes) {
  auto* w = reinterpret_cast<uint32_t*>(p);
  for (size_t i = threadIdx.x; i < bytes / 4; i += blockDim.x) w[i] = 0u;
}

template <typename CD, bool kMma>
__global__ void __launch_bounds__(kThreads) ioc_refine_kernel(
    const float* __restrict__ traj, const CD* __restrict__ dec_h,
    const CD* __restrict__ fmap_g, const float* __restrict__ live_g,
    const float* __restrict__ fut_mask, const float* __restrict__ wiv_g,
    const CD* __restrict__ wx_g, const CD* __restrict__ wh_g,
    const float* __restrict__ bi_g, const float* __restrict__ bh_g,
    const CD* __restrict__ headw_g, const float* __restrict__ headb_g,
    const CD* __restrict__ wmsg_g, const CD* __restrict__ bmsg_g,
    const float* __restrict__ ltau, float* __restrict__ refined,
    float* __restrict__ scores, float* __restrict__ iters, int A, int K,
    int T, int d, int G, int C, int num_refine, int social_freeze,
    float delta_scale, int fmap_smem) {
  using L_t = IocLayout<CD, kMma>;
  using XT = typename L_t::XT;
  extern __shared__ __align__(16) unsigned char smem[];
  const L_t L(A, T, d, C, G, fmap_smem != 0);
  auto cdp = [&](size_t off) { return reinterpret_cast<CD*>(smem + off); };
  auto fp = [&](size_t off) { return reinterpret_cast<float*>(smem + off); };
  auto xp = [&](size_t off) { return reinterpret_cast<XT*>(smem + off); };
  CD *wx = cdp(L.wx), *wh = cdp(L.wh), *wmsg = cdp(L.wmsg);
  CD* headw = cdp(L.headw);
  float *wiv = fp(L.wiv), *bi = fp(L.bi), *bh = fp(L.bh);
  float *headb = fp(L.headb), *bmsg = fp(L.bmsg);
  float *xs = fp(L.x), *ys = fp(L.y), *x0s = fp(L.x0), *y0s = fp(L.y0);
  float *fmask = fp(L.fmask), *out = fp(L.out);
  float *h = fp(L.h), *hn = fp(L.hn);
  float *score = fp(L.score), *nbok = fp(L.nbok), *live = fp(L.live);
  float* lgw = fp(L.lg) + (threadIdx.x / 32) * A;  // this warp's logits
  XT *X = xp(L.X), *att = xp(L.att), *msg = xp(L.msg);

  const int b = blockIdx.x / K, k = blockIdx.x % K;
  const int d3 = 3 * d, kx = L.kx, lx = L.lx, la = L.la, lh = L.lh;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nth / 32;

  // operands start at zero: the tensor-core path reads padding rows and
  // columns (rows >= A of X, att and h; agent columns >= A of att and msg)
  zero(X, (size_t)L.rows * lx * sizeof(XT));
  zero(att, (size_t)L.rows * la * sizeof(XT));
  zero(msg, (size_t)(kMma ? d : A) * L.lm * sizeof(XT));
  // weights and the feature map into shared memory
  const CD* fm = fmap_g + (size_t)b * G * G * C;
  if (fmap_smem) {
    copy_rows(cdp(L.fmap), G * G * C, fm, 1, G * G * C);
    fm = cdp(L.fmap);
  }
  copy_rows(wx, L.lwx, wx_g, kMma ? d3 : kx, kMma ? kx : d3);
  copy_rows(wh, L.lwh, wh_g, kMma ? d3 : d, kMma ? d : d3);
  copy_rows(wmsg, L.lwm, wmsg_g, d, d);
  copy_rows(headw, L.lwo, headw_g, kMma ? 8 : d, kMma ? d : 4);
  copy_rows(wiv, 2 * d3, wiv_g, 1, 2 * d3);
  copy_rows(bi, d3, bi_g, 1, d3);
  copy_rows(bh, d3, bh_g, 1, d3);
  copy_rows(headb, 4, headb_g, 1, 4);
  for (int i = tid; i < d; i += nth) bmsg[i] = to_f(bmsg_g[i]);
  // positions as (T, A) planes; row (b, a, k) of the (B, A, K, T, ·) inputs
  for (int i = tid; i < T * A; i += nth) {
    const int t = i / A, a = i % A;
    const size_t r = ((size_t)b * A + a) * K + k;
    const float px = traj[(r * T + t) * 2];
    const float py = traj[(r * T + t) * 2 + 1];
    xs[i] = px;
    ys[i] = py;
    x0s[i] = px;
    y0s[i] = py;
    fmask[i] = fut_mask[((size_t)b * A + a) * T + t];
  }
  for (int a = tid; a < A; a += nth) {
    live[a] = live_g[(size_t)b * A + a];
    score[a] = 0.f;
  }
  __syncthreads();
  for (int a = tid; a < A; a += nth) {
    float ok = 0.f;
    for (int j = 0; j < A; ++j)
      if (j != a && live[j] > 0.f) ok = 1.f;
    nbok[a] = ok;
  }
  const float tau = expf(ltau[0]) + 1e-4f;
  // Tensor-core path: the next step's dec_h tile is loaded into registers
  // (16-byte pieces, at most kDecPieces per thread) while the current step
  // runs, so its device-memory latency is off the step's critical path.
  const int pieces = d / 8;  // 16-byte pieces of an agent's dec_h row
  uint4 dec_next[kDecPieces];
  auto prefetch_dec = [&](int tt) {
#pragma unroll
    for (int r = 0; r < kDecPieces; ++r) {
      const int i = tid + r * nth;
      if (i < A * pieces)
        dec_next[r] = *reinterpret_cast<const uint4*>(
            dec_h + ((((size_t)b * A + i / pieces) * K + k) * T + tt) * d
            + (i % pieces) * 8);
    }
  };
  auto store_dec = [&]() {
#pragma unroll
    for (int r = 0; r < kDecPieces; ++r) {
      const int i = tid + r * nth;
      if (i < A * pieces)
        *reinterpret_cast<uint4*>(X + (i / pieces) * lx + (i % pieces) * 8) =
            dec_next[r];
    }
  };
  if constexpr (kMma) prefetch_dec(0);
  __syncthreads();

  for (int ip = 0; ip <= num_refine; ++ip) {
    const bool last = ip == num_refine;
    for (int i = tid; i < L.rows * lh; i += nth) h[i] = hn[i] = 0.f;
    const float* sx = social_freeze ? x0s : xs;
    const float* sy = social_freeze ? y0s : ys;
    for (int t = 0; t < T; ++t) {
      const float* px = xs + t * A;
      const float* py = ys + t * A;
      // 1. the step's decoder hiddens, scene features, attention weights
      if constexpr (kMma) {
        store_dec();
        prefetch_dec((t + 1) % T);
      } else {
        for (int i = tid; i < A * d; i += nth) {
          const int a = i / d, j = i % d;
          X[a * lx + j] =
              dec_h[((((size_t)b * A + a) * K + k) * T + t) * d + j];
        }
      }
      for (int i = tid; i < A * C; i += nth) {
        const int a = i / C, c = i % C;
        const float gx = fminf(fmaxf(px[a], 0.f), 1.f) * (G - 1);
        const float gy = fminf(fmaxf(py[a], 0.f), 1.f) * (G - 1);
        const float fx0 = floorf(gx), fy0 = floorf(gy);
        const float fx = gx - fx0, fy = gy - fy0;
        const int ix0 = (int)fx0, iy0 = (int)fy0;
        const int ix1 = min(ix0 + 1, G - 1), iy1 = min(iy0 + 1, G - 1);
        float acc = 0.f;
        acc = fmaf(rnd<CD>((1.f - fx) * (1.f - fy)),
                   to_f(fm[(iy0 * G + ix0) * C + c]), acc);
        acc = fmaf(rnd<CD>(fx * (1.f - fy)),
                   to_f(fm[(iy0 * G + ix1) * C + c]), acc);
        acc = fmaf(rnd<CD>((1.f - fx) * fy),
                   to_f(fm[(iy1 * G + ix0) * C + c]), acc);
        acc = fmaf(rnd<CD>(fx * fy), to_f(fm[(iy1 * G + ix1) * C + c]), acc);
        X[a * lx + d + c] = from_f<XT>(acc);
      }
      {
        const float* qx = sx + t * A;
        const float* qy = sy + t * A;
        for (int a = warp; a < A; a += nwarps) {
          const float xa = qx[a], ya = qy[a];
          const float sqa = xa * xa + ya * ya;
          auto logit = [&](int j) {
            if (j == a || live[j] <= 0.f) return -1e9f;
            const float xj = qx[j], yj = qy[j];
            const float d2 = (sqa + (xj * xj + yj * yj))
                             - 2.f * (xa * xj + ya * yj);
            return -d2 / tau;
          };
          // a lane touches only its own j: no barrier between the loops
          float mx = -INFINITY;
          for (int j = lane; j < A; j += 32) {
            lgw[j] = logit(j);
            mx = fmaxf(mx, lgw[j]);
          }
          mx = warp_max(mx);
          float s = 0.f;
          for (int j = lane; j < A; j += 32) {
            lgw[j] = expf(lgw[j] - mx);
            s += lgw[j];
          }
          s = warp_sum(s);
          for (int j = lane; j < A; j += 32)
            att[a * la + j] = from_f<XT>(lgw[j] / s * nbok[a]);
        }
      }
      __syncthreads();
      // 2. messages msg = round(round(dec_h Wmsg) + round(bmsg))
      if constexpr (kMma) {
        block_mma<1>(X, lx, kMmaRows / 16, d, wmsg, L.lwm, d,
                                 [&](int r, int c, float acc) {
                                   if (r < A)
                                     msg[c * L.lm + r] = from_f<XT>(
                                         rnd<CD>(acc) + bmsg[c]);
                                 });
      } else {
        for (int i = tid; i < A * d; i += nth) {
          const int a = i / d, c = i % d;
          float acc = 0.f;
          for (int j = 0; j < d; ++j)
            acc = fmaf(to_f(X[a * lx + j]), to_f(wmsg[j * d + c]), acc);
          msg[i] = from_f<XT>(rnd<CD>(acc) + bmsg[c]);
        }
      }
      __syncthreads();
      // 3. social pooling into X: soc = att msg
      if constexpr (kMma) {
        block_mma<1>(att, la, kMmaRows / 16, kMmaRows, msg, L.lm, d,
                                 [&](int r, int c, float acc) {
                                   X[r * lx + d + C + c] = from_f<XT>(acc);
                                 });
      } else {
        for (int i = tid; i < A * d; i += nth) {
          const int a = i / d, c = i % d;
          float acc = 0.f;
          for (int j = 0; j < A; ++j)
            acc = fmaf(to_f(att[a * la + j]), to_f(msg[j * d + c]), acc);
          X[a * lx + d + C + c] = from_f<XT>(acc);
        }
      }
      __syncthreads();
      // 4. score GRU step; input gates [vel | dec | scene | social]
      auto vel = [&](int a, int g) {
        const float vx = t > 0 ? px[a] - xs[(t - 1) * A + a] : 0.f;
        const float vy = t > 0 ? py[a] - ys[(t - 1) * A + a] : 0.f;
        return vx * wiv[g] + vy * wiv[d3 + g];
      };
      auto gru = [&](int a, int c, const float* gi, const float* gh) {
        const float r = sigmoid(gi[0] + gh[0]);
        const float z = sigmoid(gi[1] + gh[1]);
        const float n = tanhf(gi[2] + r * gh[2]);
        hn[a * lh + c] = (1.f - z) * n + z * h[a * lh + c];
      };
      if constexpr (kMma) {
        // a warp: hidden units j0..j0+7 (the r, z, n gate columns of each)
        // for 32 rows, input and hidden products in registers
        const int gid = lane >> 2, tig = lane & 3;
        const int groups = d / 8;
        for (int item = warp; item < groups * (kMmaRows / 32);
             item += nwarps) {
          const int j0 = (item % groups) * 8, r0 = (item / groups) * 32;
          float ai[3][2][4], ah[3][2][4];
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int e = 0; e < 4; ++e) ai[q][m][e] = ah[q][m][e] = 0.f;
          for (int k0 = 0; k0 < kx; k0 += 16) {
            uint32_t af[2][4];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const XT* lo = X + (r0 + m * 16 + gid) * lx + k0 + tig * 2;
              const XT* hi = lo + 8 * lx;
              af[m][0] = load_pair(lo);
              af[m][1] = load_pair(hi);
              af[m][2] = load_pair(lo + 8);
              af[m][3] = load_pair(hi + 8);
            }
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              const CD* wb = wx + (q * d + j0 + gid) * L.lwx + k0 + tig * 2;
              const uint32_t b0 = load_pair(wb), b1 = load_pair(wb + 8);
#pragma unroll
              for (int m = 0; m < 2; ++m)
                mma_bf16(ai[q][m], af[m][0], af[m][1], af[m][2], af[m][3],
                         b0, b1);
            }
          }
          for (int k0 = 0; k0 < d; k0 += 16) {
            uint32_t af[2][4];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const float* lo = h + (r0 + m * 16 + gid) * lh + k0 + tig * 2;
              const float* hi = lo + 8 * lh;
              af[m][0] = load_pair(lo);
              af[m][1] = load_pair(hi);
              af[m][2] = load_pair(lo + 8);
              af[m][3] = load_pair(hi + 8);
            }
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              const CD* wb = wh + (q * d + j0 + gid) * L.lwh + k0 + tig * 2;
              const uint32_t b0 = load_pair(wb), b1 = load_pair(wb + 8);
#pragma unroll
              for (int m = 0; m < 2; ++m)
                mma_bf16(ah[q][m], af[m][0], af[m][1], af[m][2], af[m][3],
                         b0, b1);
            }
          }
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int a = r0 + m * 16 + gid + (e >> 1) * 8;
              const int c = j0 + tig * 2 + (e & 1);
              if (a >= A) continue;
              float gi[3], gh[3];
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                const int g = q * d + c;
                gi[q] = vel(a, g) + (ai[q][m][e] + bi[g]);
                gh[q] = ah[q][m][e] + bh[g];
              }
              gru(a, c, gi, gh);
            }
        }
      } else {
        for (int i = tid; i < A * d; i += nth) {
          const int a = i / d, c = i % d;
          const XT* xa = X + a * lx;
          float gd[3] = {0.f, 0.f, 0.f}, gs[3] = {0.f, 0.f, 0.f};
          float go[3] = {0.f, 0.f, 0.f}, ghs[3] = {0.f, 0.f, 0.f};
          for (int j = 0; j < d; ++j) {
            const float dv = to_f(xa[j]);
            const float ov = to_f(xa[d + C + j]);
            const float hv = rnd<CD>(h[a * lh + j]);
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              gd[q] = fmaf(dv, to_f(wx[j * d3 + q * d + c]), gd[q]);
              go[q] = fmaf(ov, to_f(wx[(d + C + j) * d3 + q * d + c]), go[q]);
              ghs[q] = fmaf(hv, to_f(wh[j * d3 + q * d + c]), ghs[q]);
            }
          }
          for (int j = 0; j < C; ++j) {
            const float sv = to_f(xa[d + j]);
#pragma unroll
            for (int q = 0; q < 3; ++q)
              gs[q] = fmaf(sv, to_f(wx[(d + j) * d3 + q * d + c]), gs[q]);
          }
          float gi[3], gh[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const int g = q * d + c;
            gi[q] = (vel(a, g) + (gd[q] + bi[g])) + gs[q] + go[q];
            gh[q] = ghs[q] + bh[g];
          }
          gru(a, c, gi, gh);
        }
      }
      __syncthreads();
      {
        float* tmp = h;
        h = hn;
        hn = tmp;
      }
      // 5. heads [psi | gate | dx | dy]; the final pass accumulates scores
      auto head = [&](int a, int q, float acc) {
        const float o = acc + headb[q];
        out[(t * A + a) * 4 + q] = o;
        if (last && q == 0) score[a] = score[a] + o * fmask[t * A + a];
      };
      if constexpr (kMma) {
        block_mma<1>(h, lh, kMmaRows / 16, d, headw, L.lwo, 8,
                                 [&](int r, int c, float acc) {
                                   if (r < A && c < 4) head(r, c, acc);
                                 });
      } else {
        for (int i = tid; i < A * 4; i += nth) {
          const int a = i / 4, q = i % 4;
          float acc = 0.f;
          for (int j = 0; j < d; ++j)
            acc = fmaf(rnd<CD>(h[a * lh + j]), to_f(headw[j * 4 + q]), acc);
          head(a, q, acc);
        }
      }
    }
    __syncthreads();
    if (!last) {
      // deltas after the whole pass, masked by the future mask; with
      // iters, the pass's positions go out as iters[ip] (B, A, K, T, 2)
      float* it = iters == nullptr
                      ? nullptr
                      : iters + (size_t)ip * gridDim.x * A * T * 2;
      for (int i = tid; i < T * A; i += nth) {
        const float* o = out + i * 4;
        const float gate = sigmoid(o[1]);
        const float m = fmask[i] * delta_scale;
        const float dx = tanhf(o[2]) * gate;
        const float dy = tanhf(o[3]) * gate;
        xs[i] = xs[i] + dx * m;
        ys[i] = ys[i] + dy * m;
        if (it != nullptr) {
          const int t = i / A, a = i % A;
          const size_t r = ((size_t)b * A + a) * K + k;
          it[(r * T + t) * 2] = xs[i];
          it[(r * T + t) * 2 + 1] = ys[i];
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < T * A; i += nth) {
    const int t = i / A, a = i % A;
    const size_t r = ((size_t)b * A + a) * K + k;
    refined[(r * T + t) * 2] = xs[i];
    refined[(r * T + t) * 2 + 1] = ys[i];
  }
  for (int a = tid; a < A; a += nth)
    scores[((size_t)b * A + a) * K + k] = score[a];
}

template <typename CD, bool kMma>
int launch(const void* traj, const void* dec_h, const void* fmap,
           const void* live, const void* fut_mask, const void* wiv,
           const void* wx, const void* wh, const void* bi, const void* bh,
           const void* headw, const void* headb, const void* wmsg,
           const void* bmsg, const void* ltau, void* refined, void* scores,
           void* iters, int B, int A, int K, int T, int d, int G, int C,
           int num_refine,
           int social_freeze, float delta_scale, cudaStream_t stream) {
  using F = const float*;
  using Cp = const CD*;
  if (kMma && (A > kMmaRows || d % 16 || C % 16
               || A * (d / 8) > kDecPieces * kThreads))
    return cudaErrorInvalidValue;
  bool fmap_smem = true;
  size_t bytes = IocLayout<CD, kMma>(A, T, d, C, G, true).total;
  if (bytes > kMaxSmem) {
    fmap_smem = false;
    bytes = IocLayout<CD, kMma>(A, T, d, C, G, false).total;
  }
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaFuncSetAttribute(ioc_refine_kernel<CD, kMma>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  ioc_refine_kernel<CD, kMma><<<B * K, kThreads, bytes, stream>>>(
      F(traj), Cp(dec_h), Cp(fmap), F(live), F(fut_mask), F(wiv), Cp(wx),
      Cp(wh), F(bi), F(bh), Cp(headw), F(headb), Cp(wmsg), Cp(bmsg),
      F(ltau), (float*)refined, (float*)scores, (float*)iters, A, K, T, d,
      G, C,
      num_refine, social_freeze, delta_scale, fmap_smem ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace desire

// traj (B, A, K, T, 2), live (B, A), fut_mask (B, A, T) float32; dec_h
// (B, A, K, T, d) and fmap (B, G, G, C) in the compute dtype (bf16 when
// is_bf16, else float32). Weights: wiv (2, 3d), bi, bh (3d), headb (4),
// ltau (1) float32; bmsg (d) compute dtype. The matrices, compute dtype:
// wx = [Wdec; Wscene; Wsocial] (2d + C, 3d), wh (d, 3d), wmsg (d, d),
// headw (d, 4) = [score | gate | delta]; with use_mma (bf16, A <= 64, d and
// C multiples of 16, d <= 128) they come TRANSPOSED, (out, in), and headw
// zero-padded to (8, d). Outputs refined (B, A, K, T, 2) and scores
// (B, A, K) float32, and, unless iters is null, every refine pass's
// positions (num_refine, B, A, K, T, 2) float32. Returns
// cudaGetLastError().
extern "C" int ioc_refine_launch(
    int is_bf16, int use_mma, const void* traj, const void* dec_h,
    const void* fmap, const void* live, const void* fut_mask,
    const void* wiv, const void* wx, const void* wh, const void* bi,
    const void* bh, const void* headw, const void* headb, const void* wmsg,
    const void* bmsg, const void* ltau, void* refined, void* scores,
    void* iters, int B, int A, int K, int T, int d, int G, int C,
    int num_refine,
    int social_freeze, float delta_scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define DESIRE_IOC_ARGS                                                       \
  traj, dec_h, fmap, live, fut_mask, wiv, wx, wh, bi, bh, headw, headb, wmsg, \
      bmsg, ltau, refined, scores, iters, B, A, K, T, d, G, C, num_refine,   \
      social_freeze, delta_scale, s
  if (is_bf16 && use_mma)
    return desire::launch<__nv_bfloat16, true>(DESIRE_IOC_ARGS);
  if (is_bf16) return desire::launch<__nv_bfloat16, false>(DESIRE_IOC_ARGS);
  if (use_mma) return cudaErrorInvalidValue;
  return desire::launch<float, false>(DESIRE_IOC_ARGS);
#undef DESIRE_IOC_ARGS
}
