// The backward pass of the trainable fused IOC rank-and-refine loop, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel desire_tpu/ops/ioc_bwd.py `_kernel` (reached
// through `ioc_refine_bwd` from `make_trainable_fused_ioc(backward=
// "pallas")`). Wrapper and autograd binding: desire_tpu_torch/ops/
// ioc_bwd.py; its plain version is autograd through ops/ioc_fused.py
// `ioc_refine_plain`.
//
// Per (batch row, lane) block, reverse over the passes p = R .. 0 (R =
// num_refine refine passes, then the final re-score):
//
//   g <- d_refined                           position cotangent (T, A)
//   for p = R .. 0:
//     positions <- levels[p]                 levels = [traj, iters[0..R-1]]
//     p < R: g += d_iters[p]
//     forward sweep t = 0 .. T-1: recompute scene, attention, social pool,
//       input gates, GRU state; seed each step's hidden cotangent from the
//       heads (the score head on p = R, the gated delta heads on p < R,
//       which read g) and accumulate the head gradients
//     reverse sweep t = T-1 .. 0: the GRU adjoint; cotangents of dec_h,
//       msg, the feature map and soc_logtau; weight gradients; position
//       gradients into g only for p < R (the re-score runs on stopped
//       positions)
//   d_traj <- g
//
// Under social_freeze (the TPU kernel's frozen-attention variant,
// ioc_bwd.py:859-944) every pass pools its social block at the initial
// positions levels[0]: the block is pooled once, before the pass loop, and
// each pass reads it. The passes then skip the attention and its adjoint
// and collect the social-block cotangents in two buckets instead, one of
// the refine passes and one of the re-score. One deferred attention
// adjoint per step, after the loop, gives d_msg and d soc_logtau from both
// buckets and the position gradient from the refine bucket only (the
// re-score pools at stopped positions), added to d_traj.
//
// What bounds it on this card: the serial dependency chain, as in the
// forward kernel: (R + 1) passes x 2 sweeps x T steps per block, each step
// a handful of small products over the lane's A agents, separated by block
// barriers. In bf16 (d and C multiples of 16) the products with a weight
// matrix as second operand (input and hidden gates, the hidden and block
// cotangents) run on the tensor cores (mma.sync); the rest (weight
// gradients, the social pooling and its adjoint), and everything in
// float32, run on the CUDA cores, each thread a small register tile of
// outputs (tile_mm). Operands are rounded to the compute dtype where the
// TPU kernel rounds them, sums are float32.
//
// What the design does:
// * One block per (batch row, lane) holds all A agents of the lane, as the
//   forward kernel does: social attention mixes agents only within a lane.
// * Each pass is recomputed from its saved positions (levels[p]), never by
//   replaying earlier passes. The per-step values the reverse sweep needs
//   (input-gate preactivations, GRU states, scene and social blocks, the
//   hidden-state seeds) go to a float32 workspace in device memory, private
//   to the block: at the flagship shape they are ~1.8 MB per block, eight
//   times what shared memory holds. Attention weights are recomputed in the
//   reverse sweep from the step's positions instead of stored.
// * The forward sweep also saves the hidden gates, so the reverse sweep
//   recomputes no product to get them.
// * Deterministic, with no atomics: every weight gradient has one owning
//   thread, which adds the step's agent sum (an ascending-agent chain) to
//   the block's partial in device memory, in a fixed (pass, step) order;
//   the feature-map gradient is gathered after the passes into shared
//   memory, each (node, channel) owned by one thread that walks (pass,
//   step, agent, corner) in order over entries staged in shared memory
//   chunk by chunk. The wrapper sums the per-block partials in a fixed
//   order, as the TPU wrapper sums its per-program partials.
// * Numerics follow the TPU kernel: products round their operands to the
//   compute dtype and accumulate in float32; element-wise math, the social
//   softmax and its adjoint stay float32.
#include "common.cuh"

namespace desire {
namespace {

constexpr int kBwdThreads = 512;

// Shared-memory layout (float32). X holds a step's score-GRU input blocks
// per agent in the input-gate matrix's row order, [vel (2) | scene (C) |
// social (d) | dec_h (d)], each already rounded to the compute dtype. G and
// R hold the gate cotangents [r | z | n | n * r] of a reverse step, G as
// computed and R rounded to the compute dtype (the operands of the
// products); the forward sweep stages the input and hidden gate products
// in them. hc/hn (the GRU state of the forward sweep) double as dhc/hp (the
// hidden cotangent and the previous state of the reverse sweep). After the
// passes the feature-map accumulator (G * G * C) reuses the whole region.
struct BwdLayout {
  int lx, lg;
  size_t x, y, gx, gy, fmask, live, nbok, gsc, ltrow, veld, dout;
  size_t hc, hn, X, msg, dsoc, dsc, att, dl, G, R;
  size_t total;
  __host__ __device__ BwdLayout(int A, int T, int d, int C, int Gr) {
    const size_t f = 4;
    lx = 2 + C + 2 * d;
    lg = 4 * d;
    Bump b;
    x = b.take(T * A * f);
    y = b.take(T * A * f);
    gx = b.take(T * A * f);
    gy = b.take(T * A * f);
    fmask = b.take(T * A * f);
    live = b.take(A * f);
    nbok = b.take(A * f);
    gsc = b.take(A * f);
    ltrow = b.take(A * f);
    veld = b.take(2 * A * f);
    dout = b.take(4 * A * f);
    hc = b.take((size_t)A * d * f);
    hn = b.take((size_t)A * d * f);
    X = b.take((size_t)A * lx * f);
    msg = b.take((size_t)A * d * f);
    dsoc = b.take((size_t)A * d * f);
    dsc = b.take((size_t)A * C * f);
    att = b.take((size_t)A * A * f);
    dl = b.take((size_t)A * A * f);
    G = b.take((size_t)A * lg * f);
    R = b.take((size_t)A * lg * f);
    // the tensor-core products read whole 16-row tiles: rows up to the next
    // multiple of 16 past R's last agent stay inside the allocation
    b.take((size_t)((A + 15) / 16 * 16 - A) * lg * f);
    total = b.off;
    const size_t acc = (size_t)Gr * Gr * C * f;
    if (acc > total) total = acc;
  }
};

// Float32 words of one block's device-memory workspace: input and hidden
// gate preactivations gi, gh (T, A, 3d), hs (T, A, d), scene (T, A, C),
// social (T, A, d), hidden seeds (T, A, d), scene cotangents (R + 1, T, A,
// C); under social_freeze also the two social-cotangent buckets (refine
// passes, re-score), (T, A, d) each.
__host__ __device__ inline size_t bwd_ws_words(int A, int T, int d, int C,
                                               int R, int freeze) {
  return (size_t)T * A * (9 * d + C) + (size_t)(R + 1) * T * A * C
         + (freeze ? (size_t)2 * T * A * d : 0);
}

// Block-wide product with a per-output epilogue:
//   epi(m, n, sum_k fa(m, k) * fb(k, n))   for m < M, n < N,
// the sum an ascending-k chain of fused multiply-adds. Each thread owns
// RM x RN outputs, so that every operand it loads feeds RN (or RM)
// multiply-adds; consecutive threads take consecutive column tiles (fb
// loads coalesce, fa loads broadcast). fa and fb read shared or device
// memory and round as the caller's numerics require.
template <int RM, int RN, typename FA, typename FB, typename Epi>
__device__ __forceinline__ void tile_mm(int M, int N, int K, FA fa, FB fb,
                                        Epi epi) {
  const int tm = (M + RM - 1) / RM, tn = (N + RN - 1) / RN;
  for (int item = threadIdx.x; item < tm * tn; item += blockDim.x) {
    const int m0 = (item / tn) * RM, n0 = (item % tn) * RN;
    int mi[RM], ni[RN];
#pragma unroll
    for (int r = 0; r < RM; ++r) mi[r] = min(m0 + r, M - 1);
#pragma unroll
    for (int c = 0; c < RN; ++c) ni[c] = min(n0 + c, N - 1);
    float acc[RM][RN];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[RM], bv[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) av[r] = fa(mi[r], k);
#pragma unroll
      for (int c = 0; c < RN; ++c) bv[c] = fb(k, ni[c]);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c)
        if (m0 + r < M && n0 + c < N) epi(m0 + r, n0 + c, acc[r][c]);
  }
}

// Align-corners bilinear corners of a position clamped to [0, 1]: node
// indices and float32 weights, in the order (x0,y0) (x1,y0) (x0,y1) (x1,y1).
struct Corners {
  int n[4];
  float w[4];
  float fx, fy;
};

__device__ __forceinline__ Corners corners(float px, float py, int G) {
  Corners c;
  const float gx = fminf(fmaxf(px, 0.f), 1.f) * (G - 1);
  const float gy = fminf(fmaxf(py, 0.f), 1.f) * (G - 1);
  const float fx0 = floorf(gx), fy0 = floorf(gy);
  c.fx = gx - fx0;
  c.fy = gy - fy0;
  const int ix0 = (int)fx0, iy0 = (int)fy0;
  const int ix1 = min(ix0 + 1, G - 1), iy1 = min(iy0 + 1, G - 1);
  c.n[0] = iy0 * G + ix0;
  c.n[1] = iy0 * G + ix1;
  c.n[2] = iy1 * G + ix0;
  c.n[3] = iy1 * G + ix1;
  c.w[0] = (1.f - c.fx) * (1.f - c.fy);
  c.w[1] = c.fx * (1.f - c.fy);
  c.w[2] = (1.f - c.fx) * c.fy;
  c.w[3] = c.fx * c.fy;
  return c;
}

// kMma (bf16, d and C multiples of 16): the products whose second operand
// is a weight matrix run on the tensor cores (block_mma, common.cuh), the
// others, and all of them otherwise, as CUDA-core tiles (tile_mm). kFreeze:
// social_freeze, a variant of its own so that the default one keeps its
// registers.
template <typename CD, bool kMma, bool kFreeze>
__global__ void __launch_bounds__(kBwdThreads) ioc_refine_bwd_kernel(
    const float* __restrict__ traj, const float* __restrict__ iters,
    const CD* __restrict__ dec_h, const CD* __restrict__ msg_g,
    const CD* __restrict__ fmap_g, const float* __restrict__ live_g,
    const float* __restrict__ fut_mask, const CD* __restrict__ wi,
    const CD* __restrict__ wiT, const CD* __restrict__ wh,
    const CD* __restrict__ whT, const CD* __restrict__ hwc,
    const float* __restrict__ wiv, const float* __restrict__ bi,
    const float* __restrict__ bh, const float* __restrict__ hw,
    const float* __restrict__ hb, const float* __restrict__ ltau_g,
    const float* __restrict__ g_ref, const float* __restrict__ g_sc,
    const float* __restrict__ g_it, float* __restrict__ d_traj,
    float* __restrict__ d_dec, float* __restrict__ d_msg,
    float* __restrict__ d_fmap_p, float* __restrict__ d_wi_p,
    float* __restrict__ d_wh_p, float* __restrict__ d_bi_p,
    float* __restrict__ d_bh_p, float* __restrict__ d_hw_p,
    float* __restrict__ d_hb_p, float* __restrict__ d_ltau_p,
    float* __restrict__ ws_g, int A, int K, int T, int d, int G, int C,
    int R, float delta_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L(A, T, d, C, G);
  auto fp = [&](size_t off) { return reinterpret_cast<float*>(smem + off); };
  float *xs = fp(L.x), *ys = fp(L.y), *gx = fp(L.gx), *gy = fp(L.gy);
  float *fmask = fp(L.fmask), *live = fp(L.live), *nbok = fp(L.nbok);
  float *gsc = fp(L.gsc), *ltrow = fp(L.ltrow), *veld = fp(L.veld);
  float* dout = fp(L.dout);
  float *hc = fp(L.hc), *hn = fp(L.hn);
  float* const dhc = fp(L.hc);  // reverse sweep: hidden-state cotangent
  float* const hp = fp(L.hn);   // reverse sweep: the previous GRU state
  float *X = fp(L.X), *msg = fp(L.msg), *dsoc = fp(L.dsoc), *dsc = fp(L.dsc);
  float *att = fp(L.att), *dl = fp(L.dl), *Gc = fp(L.G), *Rc = fp(L.R);

  const int blk = blockIdx.x, b = blk / K, k = blk % K;
  const int B = gridDim.x / K;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nth / 32;
  const int d3 = 3 * d, F = 2 + C + 2 * d, lx = L.lx, lg = L.lg;
  const int rs_off = 2, ro_off = 2 + C, rd_off = 2 + C + d;  // wi row blocks
  const size_t plane = (size_t)B * A * K * T * 2;              // one level
  const int mtiles = (A + 15) / 16;  // agent-row tiles of the mma products
  auto row = [&](int a) { return ((size_t)b * A + a) * K + k; };

  float* ws = ws_g + (size_t)blk * bwd_ws_words(A, T, d, C, R, kFreeze);
  float* gi_ws = ws;                              // (T, A, 3d)
  float* gh_ws = gi_ws + (size_t)T * A * d3;      // (T, A, 3d)
  float* hs_ws = gh_ws + (size_t)T * A * d3;      // (T, A, d)
  float* sc_ws = hs_ws + (size_t)T * A * d;       // (T, A, C)
  float* so_ws = sc_ws + (size_t)T * A * C;       // (T, A, d)
  float* seed_ws = so_ws + (size_t)T * A * d;     // (T, A, d)
  float* dsc_ws = seed_ws + (size_t)T * A * d;    // (R + 1, T, A, C)
  // social_freeze: d social of the refine passes and of the re-score
  float* bkr_ws = dsc_ws + (size_t)(R + 1) * T * A * C;  // (T, A, d)
  float* bkc_ws = bkr_ws + (size_t)T * A * d;            // (T, A, d)

  float* dwi = d_wi_p + (size_t)blk * F * d3;
  float* dwh = d_wh_p + (size_t)blk * d * d3;
  float* dbi = d_bi_p + (size_t)blk * d3;
  float* dbh = d_bh_p + (size_t)blk * d3;
  float* dhw = d_hw_p + (size_t)blk * d * 4;
  float* dhb = d_hb_p + (size_t)blk * 4;
  const CD* fm = fmap_g + (size_t)b * G * G * C;

  // ---- set-up: zero this block's accumulators, load masks and cotangents
  for (int i = tid; i < F * d3; i += nth) dwi[i] = 0.f;
  for (int i = tid; i < d * d3; i += nth) dwh[i] = 0.f;
  for (int i = tid; i < d3; i += nth) dbi[i] = dbh[i] = 0.f;
  for (int i = tid; i < d * 4; i += nth) dhw[i] = 0.f;
  for (int i = tid; i < 4; i += nth) dhb[i] = 0.f;
  for (int i = tid; i < A * T * d; i += nth) {
    const int a = i / (T * d), rest = i % (T * d);
    const size_t o = row(a) * T * d + rest;
    d_dec[o] = 0.f;
    d_msg[o] = 0.f;
  }
  if constexpr (kFreeze)
    for (int i = tid; i < 2 * T * A * d; i += nth) bkr_ws[i] = 0.f;
  for (int i = tid; i < T * A; i += nth) {
    const int t = i / A, a = i % A;
    const size_t o = (row(a) * T + t) * 2;
    gx[i] = g_ref[o];
    gy[i] = g_ref[o + 1];
    fmask[i] = fut_mask[((size_t)b * A + a) * T + t];
  }
  for (int a = tid; a < A; a += nth) {
    live[a] = live_g[(size_t)b * A + a];
    gsc[a] = g_sc[row(a)];
  }
  __syncthreads();
  for (int a = tid; a < A; a += nth) {
    float ok = 0.f;
    for (int j = 0; j < A; ++j)
      if (j != a && live[j] > 0.f) ok = 1.f;
    nbok[a] = ok;
  }
  const float ltau = ltau_g[0];
  const float tau = expf(ltau) + 1e-4f;
  float ltau_acc = 0.f;  // thread 0's running d soc_logtau
  __syncthreads();

  // the social softmax of step t at the current positions, one warp per
  // agent row, into att (A, A); the logits as the forward kernel forms them
  auto attend = [&](int t) {
    const float* qx = xs + t * A;
    const float* qy = ys + t * A;
    for (int a = warp; a < A; a += nwarps) {
      const float xa = qx[a], ya = qy[a];
      const float sqa = xa * xa + ya * ya;
      float* w = att + a * A;
      float mx = -INFINITY;
      for (int j = lane; j < A; j += 32) {
        float lg_ = -1e9f;
        if (j != a && live[j] > 0.f) {
          const float xj = qx[j], yj = qy[j];
          const float d2 = (sqa + (xj * xj + yj * yj))
                           - 2.f * (xa * xj + ya * yj);
          lg_ = -d2 / tau;
        }
        w[j] = lg_;
        mx = fmaxf(mx, lg_);
      }
      mx = warp_max(mx);
      float s = 0.f;
      for (int j = lane; j < A; j += 32) {
        w[j] = expf(w[j] - mx);
        s += w[j];
      }
      s = warp_sum(s);
      for (int j = lane; j < A; j += 32) w[j] = w[j] / s * nbok[a];
    }
  };
  // the step's decoder hiddens (into X) and messages
  auto load_dec_msg = [&](int t) {
    for (int i = tid; i < A * d; i += nth) {
      const int a = i / d, j = i % d;
      const size_t o = (row(a) * T + t) * d + j;
      X[a * lx + rd_off + j] = to_f(dec_h[o]);
      msg[i] = to_f(msg_g[o]);
    }
  };
  // operand accessors of the products
  auto w_in = [&](const CD* w, int ld, int off) {
    return [=](int kk, int n) { return to_f(w[(size_t)kk * ld + off + n]); };
  };
  // the social pool soc = att msg of the attention in att, per output
  auto pool = [&](auto epi) {
    tile_mm<4, 2>(
        A, d, A, [&](int a, int j) { return rnd<CD>(att[a * A + j]); },
        [&](int j, int c) { return msg[j * d + c]; }, epi);
  };
  // the pooling adjoint for the social cotangent ds (A, d), already rounded:
  // d msg of step t += att^T ds, dl <- ds msg^T (the cotangent of att)
  auto pool_adjoint = [&](int t, const float* ds, bool to_msg) {
    if (to_msg)
      tile_mm<4, 2>(
          A, d, A, [&](int j, int a) { return rnd<CD>(att[a * A + j]); },
          [&](int a, int c) { return ds[a * d + c]; },
          [&](int j, int c, float acc) {
            d_msg[(row(j) * T + t) * d + c] += acc;
          });
    tile_mm<4, 2>(
        A, A, d, [&](int a, int c) { return ds[a * d + c]; },
        [&](int c, int j) { return msg[j * d + c]; },
        [&](int a, int j, float acc) { dl[a * A + j] = acc; });
  };
  // the softmax adjoint at positions (px, py), one warp per row: dl <- d
  // logits, ltrow[a] <- the row's sum of d logits * d^2
  auto softmax_adjoint = [&](const float* px, const float* py) {
    for (int a = warp; a < A; a += nwarps) {
      const float* w = att + a * A;
      float* r = dl + a * A;
      float dot = 0.f;
      for (int j = lane; j < A; j += 32) dot += r[j] * nbok[a] * w[j];
      dot = warp_sum(dot);
      const float xa = px[a], ya = py[a];
      const float sqa = xa * xa + ya * ya;
      float lt = 0.f;
      for (int j = lane; j < A; j += 32) {
        float v = 0.f;
        if (j != a && live[j] > 0.f) {
          const float dsm = r[j] * nbok[a];
          v = w[j] * dsm - w[j] * dot;
          const float xj = px[j], yj = py[j];
          const float d2 = (sqa + (xj * xj + yj * yj))
                           - 2.f * (xa * xj + ya * yj);
          lt += v * d2;
        }
        r[j] = v;
      }
      lt = warp_sum(lt);
      if (lane == 0) ltrow[a] = lt;
    }
  };
  auto add_ltau = [&]() {
    if (tid == 0) {
      float s = 0.f;
      for (int a = 0; a < A; ++a) s += ltrow[a];
      ltau_acc += s / (tau * tau) * expf(ltau);
    }
  };
  // agent a's position cotangent through the distances of the softmax whose
  // d logits are in dl; every lane of the calling warp gets it
  auto social_dpos = [&](int a, const float* px, const float* py) {
    const float xa = px[a], ya = py[a];
    float rsum = 0.f, csum = 0.f, mx = 0.f, my = 0.f;
    for (int j = lane; j < A; j += 32) {
      const float dra = -dl[a * A + j] / tau;
      const float dca = -dl[j * A + a] / tau;
      rsum += dra;
      csum += dca;
      const float sym = rnd<CD>(dra + dca);
      mx = fmaf(sym, rnd<CD>(px[j]), mx);
      my = fmaf(sym, rnd<CD>(py[j]), my);
    }
    rsum = warp_sum(rsum);
    csum = warp_sum(csum);
    mx = warp_sum(mx);
    my = warp_sum(my);
    return make_float2(2.f * ((rsum + csum) * xa - mx),
                       2.f * ((rsum + csum) * ya - my));
  };

  if constexpr (kFreeze) {
    // the frozen social block: pooled once at the initial positions, read
    // by every pass's forward and reverse sweeps
    for (int i = tid; i < T * A; i += nth) {
      const int t = i / A, a = i % A;
      const size_t o = (row(a) * T + t) * 2;
      xs[i] = traj[o];
      ys[i] = traj[o + 1];
    }
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      load_dec_msg(t);
      attend(t);
      __syncthreads();
      pool([&](int a, int c, float acc) {
        so_ws[((size_t)t * A + a) * d + c] = rnd<CD>(acc);
      });
      __syncthreads();
    }
  }

  for (int p = R; p >= 0; --p) {
    const bool score_pass = p == R;
    const float* lev = p == 0 ? traj : iters + (size_t)(p - 1) * plane;
    for (int i = tid; i < T * A; i += nth) {
      const int t = i / A, a = i % A;
      const size_t o = (row(a) * T + t) * 2;
      xs[i] = lev[o];
      ys[i] = lev[o + 1];
      if (!score_pass) {  // the cotangent of iters[p] = levels[p + 1]
        const float* git = g_it + (size_t)p * plane;
        gx[i] += git[o];
        gy[i] += git[o + 1];
      }
    }
    for (int i = tid; i < A * d; i += nth) hc[i] = 0.f;
    __syncthreads();

    // ---------------- forward sweep: recompute and seed ------------------
    for (int t = 0; t < T; ++t) {
      const float* px = xs + t * A;
      const float* py = ys + t * A;
      load_dec_msg(t);
      for (int i = tid; i < A * C; i += nth) {
        const int a = i / C, c = i % C;
        const Corners q = corners(px[a], py[a], G);
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc = fmaf(rnd<CD>(q.w[e]), to_f(fm[q.n[e] * C + c]), acc);
        X[a * lx + rs_off + c] = rnd<CD>(acc);
        sc_ws[(size_t)t * A * C + i] = rnd<CD>(acc);
      }
      if constexpr (kFreeze) {
        for (int i = tid; i < A * d; i += nth)
          X[(i / d) * lx + ro_off + i % d] = so_ws[(size_t)t * A * d + i];
      } else {
        attend(t);
      }
      __syncthreads();
      // social pool soc = att msg; hidden gates h W_h (staged in R)
      if constexpr (!kFreeze)
        pool([&](int a, int c, float acc) {
          X[a * lx + ro_off + c] = rnd<CD>(acc);
          so_ws[((size_t)t * A + a) * d + c] = rnd<CD>(acc);
        });
      auto stage_gh = [&](int a, int g, float acc) {
        if (a < A) Rc[a * lg + g] = acc;
      };
      auto stage_gi = [&](int a, int g, float acc) {
        if (a < A) Gc[a * lg + g] = acc;
      };
      if constexpr (kMma) {
        block_mma<1>(hc, d, mtiles, d, whT, d, d3, stage_gh);
      } else {
        tile_mm<4, 2>(
            A, d3, d, [&](int a, int j) { return rnd<CD>(hc[a * d + j]); },
            w_in(wh, d3, 0), stage_gh);
      }
      __syncthreads();
      // input gates [scene | social | dec] W (staged in G)
      if constexpr (kMma) {
        block_mma<1>(X + 2, lx, mtiles, F - 2, wiT + 2, F, d3, stage_gi);
      } else {
        tile_mm<4, 2>(
            A, d3, F - 2, [&](int a, int j) { return X[a * lx + 2 + j]; },
            w_in(wi + (size_t)2 * d3, d3, 0), stage_gi);
      }
      __syncthreads();
      // the GRU step
      for (int i = tid; i < A * d; i += nth) {
        const int a = i / d, c = i % d;
        const float vx = t > 0 ? px[a] - xs[(t - 1) * A + a] : 0.f;
        const float vy = t > 0 ? py[a] - ys[(t - 1) * A + a] : 0.f;
        float gi[3], gh[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int g = q * d + c;
          gi[q] = (vx * wiv[g] + vy * wiv[d3 + g]) + (Gc[a * lg + g] + bi[g]);
          gh[q] = Rc[a * lg + g] + bh[g];
          gi_ws[((size_t)t * A + a) * d3 + g] = gi[q];
          gh_ws[((size_t)t * A + a) * d3 + g] = gh[q];
        }
        const float r = sigmoid(gi[0] + gh[0]);
        const float z = sigmoid(gi[1] + gh[1]);
        const float n = tanhf(gi[2] + r * gh[2]);
        const float hnew = (1.f - z) * n + z * hc[i];
        hn[i] = hnew;
        hs_ws[(size_t)t * A * d + i] = hnew;
      }
      __syncthreads();
      {
        float* tmp = hc;
        hc = hn;
        hn = tmp;
      }
      // heads [psi | gate | dx | dy] and their cotangents
      for (int a = tid; a < A; a += nth) {
        float o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float acc = 0.f;
          for (int j = 0; j < d; ++j)
            acc = fmaf(rnd<CD>(hc[a * d + j]), to_f(hwc[j * 4 + q]), acc);
          o[q] = acc + hb[q];
        }
        const float fm_t = fmask[t * A + a];
        float* dq = dout + a * 4;
        if (score_pass) {
          dq[0] = gsc[a] * fm_t;
          dq[1] = dq[2] = dq[3] = 0.f;
        } else {
          const float m = fm_t * delta_scale;
          const float gate = sigmoid(o[1]);
          const float tx = tanhf(o[2]), ty = tanhf(o[3]);
          const float ddx = gx[t * A + a] * m, ddy = gy[t * A + a] * m;
          dq[0] = 0.f;
          dq[2] = ddx * gate * (1.f - tx * tx);
          dq[3] = ddy * gate * (1.f - ty * ty);
          dq[1] = (ddx * tx + ddy * ty) * gate * (1.f - gate);
        }
      }
      __syncthreads();
      for (int i = tid; i < A * d; i += nth) {
        const int a = i / d, j = i % d;
        const float* dq = dout + a * 4;
        seed_ws[(size_t)t * A * d + i] =
            dq[0] * hw[j * 4] + dq[1] * hw[j * 4 + 1] + dq[2] * hw[j * 4 + 2]
            + dq[3] * hw[j * 4 + 3];
      }
      for (int e = tid; e < d * 4 + 4; e += nth) {
        if (e < d * 4) {
          const int j = e / 4, q = e % 4;
          float s = 0.f;
          for (int a = 0; a < A; ++a)
            s = fmaf(rnd<CD>(dout[a * 4 + q]), rnd<CD>(hc[a * d + j]), s);
          dhw[e] += s;
        } else {
          const int q = e - d * 4;
          float s = 0.f;
          for (int a = 0; a < A; ++a) s += dout[a * 4 + q];
          dhb[q] += s;
        }
      }
      __syncthreads();
    }

    // ---------------- reverse sweep --------------------------------------
    for (int i = tid; i < A * d; i += nth) dhc[i] = 0.f;
    __syncthreads();
    for (int t = T - 1; t >= 0; --t) {
      const float* px = xs + t * A;
      const float* py = ys + t * A;
      load_dec_msg(t);
      for (int i = tid; i < A * d; i += nth) {
        const int a = i / d, j = i % d;
        hp[i] = t > 0 ? hs_ws[(size_t)(t - 1) * A * d + i] : 0.f;
        X[a * lx + ro_off + j] = so_ws[(size_t)t * A * d + i];
      }
      for (int i = tid; i < A * C; i += nth)
        X[(i / C) * lx + rs_off + i % C] = sc_ws[(size_t)t * A * C + i];
      for (int a = tid; a < A; a += nth) {
        X[a * lx] = rnd<CD>(t > 0 ? px[a] - xs[(t - 1) * A + a] : 0.f);
        X[a * lx + 1] = rnd<CD>(t > 0 ? py[a] - ys[(t - 1) * A + a] : 0.f);
      }
      if constexpr (!kFreeze) attend(t);
      __syncthreads();
      // GRU adjoint of step t, from the gates the forward sweep saved:
      // G <- [drp | dzp | dnp | dnp * r], R its rounded copy
      for (int i = tid; i < A * d; i += nth) {
        const int a = i / d, c = i % d;
        const float* gi = gi_ws + ((size_t)t * A + a) * d3;
        const float* gh = gh_ws + ((size_t)t * A + a) * d3;
        float* g1 = Gc + a * lg;
        float* r1 = Rc + a * lg;
        const float ghn = gh[2 * d + c];
        const float r = sigmoid(gi[c] + gh[c]);
        const float z = sigmoid(gi[d + c] + gh[d + c]);
        const float n = tanhf(gi[2 * d + c] + r * ghn);
        const float dh = seed_ws[(size_t)t * A * d + i] + dhc[i];
        const float dn = dh * (1.f - z);
        const float dz = dh * (hp[i] - n);
        const float dnp = dn * (1.f - n * n);
        const float dr = dnp * ghn;
        const float dzp = dz * z * (1.f - z);
        const float drp = dr * r * (1.f - r);
        g1[c] = drp;
        g1[d + c] = dzp;
        g1[2 * d + c] = dnp;
        g1[3 * d + c] = dnp * r;
        r1[c] = rnd<CD>(drp);
        r1[d + c] = rnd<CD>(dzp);
        r1[2 * d + c] = rnd<CD>(dnp);
        r1[3 * d + c] = rnd<CD>(dnp * r);
        dhc[i] = dh * z;
      }
      __syncthreads();
      // the hidden-side cotangents [drp | dzp | dnp * r], rounded
      auto rh = [&](int a, int g) {
        return Rc[a * lg + (g < 2 * d ? g : g + d)];
      };
      // h_prev's cotangent
      auto add_dh = [&](int a, int j, float acc) {
        if (a < A) dhc[a * d + j] += acc;
      };
      // the scene, social and dec_h blocks' cotangents
      auto block_ct = [&](int a, int n, float acc) {
            if (a >= A) return;
            if (n < C) {
              dsc[a * C + n] = acc;
              dsc_ws[((size_t)p * T + t) * A * C + a * C + n] = acc;
            } else if (n < C + d) {
              if constexpr (kFreeze)  // the deferred adjoint's bucket
                (score_pass ? bkc_ws : bkr_ws)[((size_t)t * A + a) * d + n
                                               - C] += acc;
              else
                dsoc[a * d + n - C] = rnd<CD>(acc);  // only products read it
            } else {
              d_dec[(row(a) * T + t) * d + n - C - d] += acc;
            }
          };
      if constexpr (kMma) {
        // [drp | dzp] and dnp * r in two products; a lane adds the same
        // outputs in both
        block_mma<1>(Rc, lg, mtiles, 2 * d, wh, d3, d, add_dh);
        block_mma<1>(Rc + 3 * d, lg, mtiles, d, wh + 2 * d, d3, d, add_dh);
        block_mma<1>(Rc, lg, mtiles, d3, wi + (size_t)2 * d3, d3, F - 2,
                     block_ct);
      } else {
        tile_mm<4, 2>(A, d, d3, rh, w_in(whT, d, 0), add_dh);
        tile_mm<4, 2>(
            A, F - 2, d3, [&](int a, int g) { return Rc[a * lg + g]; },
            w_in(wiT, F, 2), block_ct);
      }
      for (int i = tid; i < 2 * A; i += nth) {
        const int a = i / 2, xy = i % 2;
        const float* g1 = Gc + a * lg;
        float s[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 3; ++q)
          for (int c = 0; c < d; ++c)
            s[q] += g1[q * d + c] * wiv[xy * d3 + q * d + c];
        veld[i] = (s[0] + s[1]) + s[2];
      }
      // weight gradients: each element's ascending-agent sum, added to its
      // partial
      tile_mm<4, 4>(
          F, d3, A, [&](int f, int a) { return X[a * lx + f]; },
          [&](int a, int g) { return Rc[a * lg + g]; },
          [&](int f, int g, float acc) { dwi[(size_t)f * d3 + g] += acc; });
      tile_mm<4, 4>(
          d, d3, A, [&](int j, int a) { return rnd<CD>(hp[a * d + j]); }, rh,
          [&](int j, int g, float acc) { dwh[(size_t)j * d3 + g] += acc; });
      for (int g = tid; g < 2 * d3; g += nth) {
        const bool is_bi = g < d3;
        const int gg = is_bi ? g : g - d3;
        const int col = is_bi || gg < 2 * d ? gg : gg + d;
        float s = 0.f;
        for (int a = 0; a < A; ++a) s += Gc[a * lg + col];
        if (is_bi)
          dbi[gg] += s;
        else
          dbh[gg] += s;
      }
      __syncthreads();
      if constexpr (!kFreeze) {
        // the social pooling adjoint: d msg, then d att, then d logits
        pool_adjoint(t, dsoc, true);
        __syncthreads();
        softmax_adjoint(px, py);
        __syncthreads();
        add_ltau();
      }
      if (!score_pass) {
        // position cotangents: scene gather, social distances (deferred
        // under social_freeze), velocity; one warp per agent, its lanes
        // summing over channels and neighbours (a fixed butterfly order)
        for (int a = warp; a < A; a += nwarps) {
          const float xa = px[a], ya = py[a];
          const Corners q = corners(xa, ya, G);
          float dhot[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float s = 0.f;
            for (int c = lane; c < C; c += 32)
              s = fmaf(rnd<CD>(dsc[a * C + c]), to_f(fm[q.n[e] * C + c]), s);
            dhot[e] = warp_sum(s);
          }
          float2 soc = make_float2(0.f, 0.f);
          if constexpr (!kFreeze) soc = social_dpos(a, px, py);
          if (lane == 0) {
            const float in_x = (xa > 0.f && xa < 1.f) ? (float)(G - 1) : 0.f;
            const float in_y = (ya > 0.f && ya < 1.f) ? (float)(G - 1) : 0.f;
            float gpx = ((dhot[1] - dhot[0]) * (1.f - q.fy)
                         + (dhot[3] - dhot[2]) * q.fy) * in_x;
            float gpy = ((dhot[2] - dhot[0]) * (1.f - q.fx)
                         + (dhot[3] - dhot[1]) * q.fx) * in_y;
            if constexpr (!kFreeze) {
              gpx += soc.x;
              gpy += soc.y;
            }
            gx[t * A + a] += gpx;
            gy[t * A + a] += gpy;
            if (t > 0) {
              gx[t * A + a] += veld[2 * a];
              gy[t * A + a] += veld[2 * a + 1];
              gx[(t - 1) * A + a] -= veld[2 * a];
              gy[(t - 1) * A + a] -= veld[2 * a + 1];
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if constexpr (kFreeze) {
    // the deferred frozen-attention adjoint, once per step; xs/ys hold the
    // initial positions again (the last pass was p = 0). The attention is
    // recomputed from them, as the reverse sweeps recompute theirs.
    float* const s_all = dhc;  // rounded (refine + re-score) bucket (A, d)
    float* const s_ref = hp;   // rounded refine bucket (A, d)
    for (int t = 0; t < T; ++t) {
      const float* px = xs + t * A;
      const float* py = ys + t * A;
      load_dec_msg(t);
      attend(t);
      for (int i = tid; i < A * d; i += nth) {
        const float r = bkr_ws[(size_t)t * A * d + i];
        s_all[i] = rnd<CD>(r + bkc_ws[(size_t)t * A * d + i]);
        s_ref[i] = rnd<CD>(r);
      }
      __syncthreads();
      // d msg and d soc_logtau hear both buckets
      pool_adjoint(t, s_all, true);
      __syncthreads();
      softmax_adjoint(px, py);
      __syncthreads();
      add_ltau();
      __syncthreads();
      // the positions only the refine passes' bucket
      pool_adjoint(t, s_ref, false);
      __syncthreads();
      softmax_adjoint(px, py);
      __syncthreads();
      for (int a = warp; a < A; a += nwarps) {
        const float2 soc = social_dpos(a, px, py);
        if (lane == 0) {
          gx[t * A + a] += soc.x;
          gy[t * A + a] += soc.y;
        }
      }
      __syncthreads();
    }
  }

  // ---- outputs: position cotangents, d soc_logtau --------------------------
  for (int i = tid; i < T * A; i += nth) {
    const int t = i / A, a = i % A;
    const size_t o = (row(a) * T + t) * 2;
    d_traj[o] = gx[i];
    d_traj[o + 1] = gy[i];
  }
  if (tid == 0) d_ltau_p[blk] = ltau_acc;
  __syncthreads();

  // ---- the feature-map gradient, gathered into shared memory ---------------
  // The (pass, step, agent) entries are staged in chunks in the shared
  // memory beside the accumulator: their scene cotangents, rounded corner
  // weights and nodes (each node's band in its top byte). Thread (channel
  // c, band) owns the nodes of grid rows y % bands == band (bands a power
  // of two) and walks the entries and corners in order: each (node,
  // channel) sum has one owner and a fixed order.
  int bands = 1;
  while (bands * 2 * C <= nth) bands *= 2;
  float* acc = fp(0);
  float* sv = acc + G * G * C;                    // (chunk, C)
  const int chunk = (int)((L.total / 4 - (size_t)G * G * C) / (C + 8));
  float* sw = sv + (size_t)chunk * C;             // (chunk, 4)
  int* sn = reinterpret_cast<int*>(sw + (size_t)chunk * 4);
  for (int i = tid; i < G * G * C; i += nth) acc[i] = 0.f;
  const int entries = (R + 1) * T * A;
  for (int i0 = 0; i0 < entries; i0 += chunk) {
    const int ne = min(chunk, entries - i0);
    for (int j = tid; j < ne * C; j += nth) {
      const int i = i0 + j / C, c = j % C;
      const int p = R - i / (T * A), t = T - 1 - (i / A) % T, a = i % A;
      sv[j] = rnd<CD>(dsc_ws[((size_t)p * T + t) * A * C + a * C + c]);
    }
    for (int e = tid; e < ne; e += nth) {
      const int i = i0 + e;
      const int p = R - i / (T * A), t = T - 1 - (i / A) % T, a = i % A;
      const float* lev = p == 0 ? traj : iters + (size_t)(p - 1) * plane;
      const size_t o = (row(a) * T + t) * 2;
      const Corners q = corners(lev[o], lev[o + 1], G);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        sw[e * 4 + k4] = rnd<CD>(q.w[k4]);
        sn[e * 4 + k4] = q.n[k4] | (((q.n[k4] / G) & (bands - 1)) << 24);
      }
    }
    __syncthreads();
    for (int item = tid; item < C * bands; item += nth) {
      const int c = item % C, band = item / C;
      for (int e = 0; e < ne; ++e) {
        const float v = sv[e * C + c];
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const int n = sn[e * 4 + k4];
          if ((n >> 24) == band) {
            float* dst = acc + (n & 0xFFFFFF) * C + c;
            *dst = fmaf(sw[e * 4 + k4], v, *dst);
          }
        }
      }
    }
    __syncthreads();
  }
  float* dfm = d_fmap_p + (size_t)blk * G * G * C;
  for (int i = tid; i < G * G * C; i += nth) dfm[i] = acc[i];
}

template <typename CD, bool kMma, bool kFreeze>
int launch_bwd(const void* const* in, void* const* out, void* ws, int B,
               int A, int K, int T, int d, int G, int C, int R,
               float delta_scale, cudaStream_t stream) {
  const size_t bytes = BwdLayout(A, T, d, C, G).total;
  // the feature-map gather stages at least one entry beside its
  // accumulator, and keeps a node index in 24 bits
  if (bytes > kMaxSmem || bytes / 4 < (size_t)G * G * C + C + 8
      || G * G >= (1 << 24))
    return cudaErrorInvalidValue;
  cudaFuncSetAttribute(ioc_refine_bwd_kernel<CD, kMma, kFreeze>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  using F = const float*;
  using Cp = const CD*;
  float* const* o = reinterpret_cast<float* const*>(out);
  ioc_refine_bwd_kernel<CD, kMma, kFreeze>
      <<<B * K, kBwdThreads, bytes, stream>>>(
      F(in[0]), F(in[1]), Cp(in[2]), Cp(in[3]), Cp(in[4]), F(in[5]),
      F(in[6]), Cp(in[7]), Cp(in[8]), Cp(in[9]), Cp(in[10]), Cp(in[11]),
      F(in[12]), F(in[13]), F(in[14]), F(in[15]), F(in[16]), F(in[17]),
      F(in[18]), F(in[19]), F(in[20]), o[0], o[1], o[2], o[3], o[4], o[5],
      o[6], o[7], o[8], o[9], o[10], (float*)ws, A, K, T, d, G, C, R,
      delta_scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace desire

// Float32 words of the device-memory workspace for B * K blocks.
extern "C" long long ioc_refine_bwd_ws_words(int B, int A, int K, int T,
                                             int d, int C, int R,
                                             int social_freeze) {
  return (long long)B * K
         * (long long)desire::bwd_ws_words(A, T, d, C, R, social_freeze);
}

// in[21]: traj (B, A, K, T, 2) f32, iters (R, B, A, K, T, 2) f32, dec_h and
// msg (B, A, K, T, d) CD, fmap (B, G, G, C) CD, live (B, A) f32, fut_mask
// (B, A, T) f32, wi (F, 3d) CD with F = 2 + C + 2d rows [vel | scene |
// social | dec], wiT (3d, F) CD, wh (d, 3d) CD, whT (3d, d) CD, heads
// (d, 4) CD, wiv (2, 3d) f32, bi (3d) f32, bh (3d) f32, heads (d, 4) f32,
// heads bias (4) f32, soc_logtau (1) f32, d_refined (B, A, K, T, 2) f32,
// d_scores (B, A, K) f32, d_iters (R, B, A, K, T, 2) f32.
// out[11], float32: d_traj (B, A, K, T, 2), d_dec and d_msg (B, A, K, T, d),
// then per-block partials (B * K, ...): feature map (G * G * C), wi
// (F * 3d), wh (d * 3d), bi (3d), bh (3d), heads (d * 4), heads bias (4),
// soc_logtau (1). ws: ioc_refine_bwd_ws_words(..., social_freeze) float32
// words. CD is bfloat16 when is_bf16, else float32. social_freeze: the
// social block is pooled at the initial positions in every pass. Returns
// cudaGetLastError().
extern "C" int ioc_refine_bwd_launch(int is_bf16, const void* const* in,
                                     void* const* out, void* ws, int B,
                                     int A, int K, int T, int d, int G,
                                     int C, int R, int social_freeze,
                                     float delta_scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define DESIRE_BWD(CD, MMA)                                                \
  (social_freeze ? desire::launch_bwd<CD, MMA, true>(                      \
                       in, out, ws, B, A, K, T, d, G, C, R, delta_scale, s) \
                 : desire::launch_bwd<CD, MMA, false>(                     \
                       in, out, ws, B, A, K, T, d, G, C, R, delta_scale, s))
  if (is_bf16 && d % 16 == 0 && C % 16 == 0)
    return DESIRE_BWD(__nv_bfloat16, true);
  if (is_bf16) return DESIRE_BWD(__nv_bfloat16, false);
  return DESIRE_BWD(float, false);
#undef DESIRE_BWD
}
