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
// What bounds it on this card: chains of waits, not arithmetic. At the
// flagship shape the products are ~0.3 GFLOP (0.29 ms at the bf16 peak);
// each (batch row, lane) runs (num_refine + 1) passes x T steps (5 x 12)
// that follow one another, and the score GRU's step needs the last one's
// state. The first design (one block of 16 warps per lane, every phase of a
// step between block barriers) spent, by clock64() over a block: the
// attention 36 %, the gate products and the GRU 32 % (of a warp's item, the
// GRU's element-wise update 60 %), the scene gather 9 %, the messages 7 %,
// the social pool and the dec_h stores 4 % each, the heads 3 %.
//
// What the design does (bf16 with d <= 64 and d, C multiples of 16, A <=
// 128: the tensor-core path, ioc_refine_tc_kernel):
// * A block takes kc lanes of one batch row (2 at the flagship, fewer
//   where K is smaller, and the ragged last lanes masked), so that the
//   weights load once for kc lanes. Social attention mixes agents only
//   within one lane and one step. A block is 12 warps: a lane's consumer
//   warps (one per 16 agents), the rest producers. Past 32 agents a lane
//   takes 3 or more consumer warps, so past 64 a block holds one lane (8
//   consumer and 4 producer warps at 128 agents).
// * Within a pass the positions do not move (the deltas apply after it), so
//   the step's inputs that only read positions are made ahead of the
//   recurrence. Producer warps fill rings of nb step tiles (2, or 1 where
//   two do not fit in shared memory, as at 128 agents under
//   social_freeze): X = [dec_h | scene] (dec_h by 16-byte cp.async, the
//   scene gather by 16-byte corner pieces from L2) and the attention (a
//   row to 4 lanes up to 64 agents, to 8 lanes past 64: 16 columns a
//   thread, fast exponentials). Named barriers hand each ring slot to the
//   consumers (full) and back (empty); nothing else synchronises the two
//   sides. A consumer hands a slot back once the step's tiles are read, or,
//   when T <= nb, only after the step's deltas, so that a producer never
//   reads a position the previous pass has still to move. At the flagship
//   the two sides take ~13-14k cycles a step each.
// * A consumer warp owns 16 agent rows of one lane. Per step it makes its
//   rows' messages (Wmsg^T dec_h^T, into the lane's message tile; a barrier
//   of the lane's consumer warps), their social block (att msg, rounded to
//   bf16 in registers), the input gates ([dec_h | scene] from the tile,
//   then the social block from registers: one float32 chain in the input
//   matrix's row order), the hidden gates, the GRU, the heads, the deltas
//   and the score, with no block barrier. The GRU state h (float32) is the
//   accumulator of the products and, rounded to bf16, the next product's A
//   operand (an m16n8 accumulator pair is an m16k16 A fragment).
// * Operands are bf16 tiles in shared memory with mma_stride() rows, read
//   by ldmatrix (weights included); refined, iters and the positions go out
//   as float2.
// * The pass-invariant products dec_h [Wid | Wmsg] are recomputed every
//   pass (~30 % of the operations): staged, they would be a (B, A, K, T,
//   3d) float32 buffer, 531 MB at the flagship, or 74 KB a lane-step in
//   shared memory.
// * Scene pooling is the 4-corner align-corners gather, which equals the
//   TPU kernel's tent weights over all G^2 nodes.
// * social_freeze attends at the initial positions in every pass, which
//   gives the same pooled block as attending once; only then does a lane
//   keep the initial position planes.
// Otherwise (float32, other widths) ioc_refine_cc_kernel runs every phase
// on the CUDA cores, one block of 512 threads per lane, the feature map in
// shared memory where it fits.
//
// Numerics, both paths, as the TPU kernel: products round operands to the
// compute dtype and accumulate in float32; distances and the social softmax
// stay float32 under bf16; msg is rounded, plus the rounded bias, rounded
// again; the deltas are applied after the pass; scores sum psi * fut_mask
// over ascending t in float32. The tensor-core path departs from the TPU
// kernel's element-wise float32 math, by a few ulp: the logits are d^2 *
// (-1/tau), not -d^2 / tau; the softmax takes __expf (ex2.approx) and one
// division a row, scaling every weight by its reciprocal; the GRU's sigmoid
// and tanh use __expf and __fdividef (sigmoid_fast, tanh_fast); and it
// sums the dec, scene and social parts of the input gates in one float32
// accumulation. The CUDA-core path keeps expf, tanhf and IEEE division.
#include "common.cuh"

namespace desire {
namespace {

// ---------------------------------------------------------------------------
// Tensor-core path (bf16): warp-specialised, kc lanes a block.

constexpr int kTcThreads = 384;   // at most 12 warps: 168 registers each
constexpr int kProdWarps = 2;     // producer warps a lane
constexpr int kMaxLanes = 4;
constexpr int kTcMaxAgents = 128; // 16 columns a thread, 8 lanes a row
constexpr int kLaneBar = 5;       // + l: the consumers of lane l (1-4: ring)
constexpr int kGatherBatch = 4;   // scene pieces a thread loads at once

struct TcLayout {
  int ap, mt, lx, la, lwx, lwh;
  size_t wx, wh, wmsg, wiv, bi, bh, bmsg, fmask, live, nbok, lanes;
  size_t X, att, msgT, xs, ys, x0, y0, lane_bytes;
  size_t total;
  __host__ __device__ TcLayout(int A, int T, int d, int C, int kc, int nb,
                               bool freeze) {
    const int d3 = 3 * d, kx = 2 * d + C;
    ap = (A + 15) / 16 * 16;
    mt = ap / 16;
    lx = mma_stride(d + C);
    la = mma_stride(ap);
    lwx = mma_stride(kx);
    lwh = mma_stride(d);
    Bump b;
    wx = b.take((size_t)d3 * lwx * 2);
    wh = b.take((size_t)d3 * lwh * 2);
    wmsg = b.take((size_t)d * lwh * 2);
    wiv = b.take((size_t)2 * d3 * 4);
    bi = b.take((size_t)d3 * 4);
    bh = b.take((size_t)d3 * 4);
    bmsg = b.take((size_t)d * 4);
    fmask = b.take((size_t)T * A * 4);
    live = b.take((size_t)A * 4);
    nbok = b.take((size_t)A * 4);
    // one region per lane: rings of nb step tiles (X = [dec_h | scene],
    // the attention), the messages of two steps transposed to (d, agent)
    // and the position planes (T, A), the initial ones under social_freeze
    Bump l;
    X = l.take((size_t)nb * ap * lx * 2);
    att = l.take((size_t)nb * ap * la * 2);
    msgT = l.take((size_t)2 * d * la * 2);
    xs = l.take((size_t)T * A * 4);
    ys = l.take((size_t)T * A * 4);
    x0 = freeze ? l.take((size_t)T * A * 4) : xs;
    y0 = freeze ? l.take((size_t)T * A * 4) : ys;
    lane_bytes = (l.off + 15) & ~size_t(15);
    lanes = b.take(kc * lane_bytes);
    total = b.off;
  }
};

__device__ __forceinline__ void bf16x8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = unpack_bf16x2(w[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// rows x cols bf16 (cols a multiple of 8, 16-byte aligned rows) from a
// dense source into rows of stride ld, 16 bytes a thread
__device__ __forceinline__ void copy_rows16(__nv_bfloat16* dst, int ld,
                                            const __nv_bfloat16* src,
                                            int rows, int cols) {
  const int pieces = cols / 8;
  for (int i = threadIdx.x; i < rows * pieces; i += blockDim.x) {
    const int r = i / pieces, q = i - r * pieces;
    *reinterpret_cast<uint4*>(dst + r * ld + q * 8) =
        __ldg(reinterpret_cast<const uint4*>(src) + i);
  }
}

// LPR: the lanes that share an attention row, 4 up to 64 agents, 8 up to
// 128 (16 columns each)
template <int ND, int LPR>
__global__ void __launch_bounds__(kTcThreads, 1) ioc_refine_tc_kernel(
    const float* __restrict__ traj, const __nv_bfloat16* __restrict__ dec_h,
    const __nv_bfloat16* __restrict__ fmap_g, const float* __restrict__ live_g,
    const float* __restrict__ fut_mask, const float* __restrict__ wiv_g,
    const __nv_bfloat16* __restrict__ wx_g,
    const __nv_bfloat16* __restrict__ wh_g, const float* __restrict__ bi_g,
    const float* __restrict__ bh_g, const __nv_bfloat16* __restrict__ headw_g,
    const float* __restrict__ headb_g, const __nv_bfloat16* __restrict__ wmsg_g,
    const __nv_bfloat16* __restrict__ bmsg_g, const float* __restrict__ ltau,
    float* __restrict__ refined, float* __restrict__ scores,
    float* __restrict__ iters, int B, int A, int K, int T, int G, int C,
    int num_refine, int social_freeze, float delta_scale, int kc, int nb) {
  using bf = __nv_bfloat16;
  constexpr int d = ND * 16;
  constexpr int d3 = 3 * d;
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout L(A, T, d, C, kc, nb, social_freeze != 0);
  const int kx = 2 * d + C, ap = L.ap, lx = L.lx, la = L.la;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r8 = lane & 7, hi = (lane >> 3) & 1, top = lane >> 4;
  const int groups = (K + kc - 1) / kc;
  const int b = blockIdx.x / groups, kbase = (blockIdx.x % groups) * kc;
  const int ncw = kc * L.mt;  // consumer warps
  const int npt = nth - ncw * 32;  // producer threads

  bf* wx = reinterpret_cast<bf*>(smem + L.wx);
  bf* wh = reinterpret_cast<bf*>(smem + L.wh);
  bf* wmsg = reinterpret_cast<bf*>(smem + L.wmsg);
  float* wiv = reinterpret_cast<float*>(smem + L.wiv);
  float* bi = reinterpret_cast<float*>(smem + L.bi);
  float* bh = reinterpret_cast<float*>(smem + L.bh);
  float* bmsg = reinterpret_cast<float*>(smem + L.bmsg);
  float* fmask = reinterpret_cast<float*>(smem + L.fmask);
  float* live = reinterpret_cast<float*>(smem + L.live);
  float* nbok = reinterpret_cast<float*>(smem + L.nbok);
  auto region = [&](int l, size_t off) {
    return smem + L.lanes + l * L.lane_bytes + off;
  };
  auto Xp = [&](int l, int s) {
    return reinterpret_cast<bf*>(region(l, L.X)) + (size_t)s * ap * lx;
  };
  auto attp = [&](int l, int s) {
    return reinterpret_cast<bf*>(region(l, L.att)) + (size_t)s * ap * la;
  };
  auto msgp = [&](int l, int s) {
    return reinterpret_cast<bf*>(region(l, L.msgT)) + (size_t)s * d * la;
  };
  auto plane = [&](int l, size_t off) {
    return reinterpret_cast<float*>(region(l, off));
  };
  // a lane past K reads lane K - 1 and writes nothing
  auto lane_k = [&](int l) { return min(kbase + l, K - 1); };

  // operands start at zero: the padding rows and columns are read, never
  // written
  for (size_t i = tid; i < L.total / 16; i += nth)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  copy_rows16(wx, L.lwx, wx_g, d3, kx);
  copy_rows16(wh, L.lwh, wh_g, d3, d);
  copy_rows16(wmsg, L.lwh, wmsg_g, d, d);
  for (int i = tid; i < 2 * d3; i += nth) wiv[i] = wiv_g[i];
  for (int i = tid; i < d3; i += nth) {
    bi[i] = bi_g[i];
    bh[i] = bh_g[i];
  }
  for (int i = tid; i < d; i += nth) bmsg[i] = to_f(bmsg_g[i]);
  for (int i = tid; i < T * A; i += nth) {
    const int t = i / A, a = i - t * A;
    fmask[i] = fut_mask[((size_t)b * A + a) * T + t];
  }
  for (int a = tid; a < A; a += nth) {
    live[a] = live_g[(size_t)b * A + a];
    float ok = 0.f;
    for (int j = 0; j < A; ++j)
      if (j != a && live_g[(size_t)b * A + j] > 0.f) ok = 1.f;
    nbok[a] = ok;
  }
  // positions as (T, A) planes; row (b, a, k) of the (B, A, K, T, .) inputs
  for (int i = tid; i < kc * T * A; i += nth) {
    const int l = i / (T * A), rem = i - l * T * A;
    const int t = rem / A, a = rem - t * A;
    const size_t r = ((size_t)b * A + a) * K + lane_k(l);
    const float2 p = reinterpret_cast<const float2*>(traj)[r * T + t];
    plane(l, L.xs)[rem] = p.x;
    plane(l, L.ys)[rem] = p.y;
    if (social_freeze) {
      plane(l, L.x0)[rem] = p.x;
      plane(l, L.y0)[rem] = p.y;
    }
  }
  __syncthreads();
  const float tau = expf(ltau[0]) + 1e-4f;
  const int steps = (num_refine + 1) * T;
  const int full0 = 1, empty0 = 1 + nb;
  // A producer of step u waits for the release of step u - nb. The step's
  // positions were moved T steps before it, in the previous pass, so a
  // consumer may release a slot as soon as the step's tiles are read only
  // when T > nb; otherwise it releases it after the step's deltas.
  const bool early_release = T > nb;

  if (warp < ncw) {
    // ---- consumer: the score GRU of 16 agent rows of one lane ----------
    const int l = warp / L.mt, r0 = (warp % L.mt) * 16;
    const int k = kbase + l;
    const bool lane_ok = k < K;
    float* xs = plane(l, L.xs);
    float* ys = plane(l, L.ys);
    const int ra = r0 + gid, rb = ra + 8;
    const bool va = ra < A, vb = rb < A;
    // the heads' weights as B fragments, (8, d) [score|gate|delta|0]
    uint32_t hw[ND][2];
#pragma unroll
    for (int ks = 0; ks < ND; ++ks) {
      const bf* p = headw_g + gid * d + ks * 16 + tig * 2;
      hw[ks][0] = load_pair(p);
      hw[ks][1] = load_pair(p + 8);
    }
    const float hb0 = tig < 2 ? headb_g[2 * tig] : 0.f;
    const float hb1 = tig < 2 ? headb_g[2 * tig + 1] : 0.f;
    float h[2 * ND][4];
    float score_a = 0.f, score_b = 0.f;
    float pxa = 0.f, pya = 0.f, pxb = 0.f, pyb = 0.f;
    for (int u = 0; u < steps; ++u) {
      const int ip = u / T, t = u - ip * T, s = u % nb;
      const bool last = ip == num_refine;
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < 2 * ND; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) h[j][e] = 0.f;
      }
      const float xa = va ? xs[t * A + ra] : 0.f;
      const float ya = va ? ys[t * A + ra] : 0.f;
      const float xb = vb ? xs[t * A + rb] : 0.f;
      const float yb = vb ? ys[t * A + rb] : 0.f;
      const float vxa = t > 0 ? xa - pxa : 0.f, vya = t > 0 ? ya - pya : 0.f;
      const float vxb = t > 0 ? xb - pxb : 0.f, vyb = t > 0 ? yb - pyb : 0.f;
      pxa = xa, pya = ya, pxb = xb, pyb = yb;
      uint32_t ha[ND][4];
#pragma unroll
      for (int ks = 0; ks < ND; ++ks)
        acc_to_a(h[2 * ks], h[2 * ks + 1], ha[ks]);
      bar_sync(full0 + s, nth);
      // the messages of these rows, msg = round(round(dec_h Wmsg) +
      // round(bmsg)), into the lane's (d, agent) tile of this step's parity:
      // computed transposed, Wmsg^T dec^T, so that a lane's two agents are
      // one 4-byte store
      const bf* X = Xp(l, s) + (r0 + r8 + hi * 8) * lx + top * 8;
      bf* msg = msgp(l, u & 1);
      {
        float acc[ND][2][4];
#pragma unroll
        for (int m = 0; m < ND; ++m)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
        const bf* xb = Xp(l, s) + (r0 + r8 + top * 8) * lx + hi * 8;
#pragma unroll
        for (int ks = 0; ks < ND; ++ks) {
          uint32_t xf[4];
          ldmatrix_x4(xf, xb + ks * 16);
#pragma unroll
          for (int m = 0; m < ND; ++m) {
            uint32_t a[4];
            ldmatrix_x4(a, wmsg + (m * 16 + r8 + hi * 8) * L.lwh + ks * 16
                               + top * 8);
            mma_bf16(acc[m][0], a[0], a[1], a[2], a[3], xf[0], xf[1]);
            mma_bf16(acc[m][1], a[0], a[1], a[2], a[3], xf[2], xf[3]);
          }
        }
#pragma unroll
        for (int m = 0; m < ND; ++m)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int c = m * 16 + gid + hh * 8;
              const int ag = r0 + j * 8 + tig * 2;
              if (ag >= A) continue;
              const float v0 = rnd<bf>(acc[m][j][2 * hh]) + bmsg[c];
              const float v1 = ag + 1 < A
                                   ? rnd<bf>(acc[m][j][2 * hh + 1]) + bmsg[c]
                                   : 0.f;
              *reinterpret_cast<uint32_t*>(msg + c * la + ag) =
                  pack_bf16(make_float2(v0, v1));
            }
      }
      bar_sync(kLaneBar + l, L.mt * 32);
      // the social block of these rows, soc = att msg, rounded to bf16 in
      // registers: the last d columns of the gates' A operand
      uint32_t sa[ND][4];
      {
        float sc[2 * ND][4];
#pragma unroll
        for (int j = 0; j < 2 * ND; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
        const bf* at = attp(l, s) + (r0 + r8 + hi * 8) * la + top * 8;
        const bf* mt = msg + (r8 + top * 8) * la + hi * 8;
        for (int k0 = 0; k0 < ap; k0 += 16) {
          uint32_t a[4];
          ldmatrix_x4(a, at + k0);
#pragma unroll
          for (int np = 0; np < ND; ++np) {
            uint32_t w[4];
            ldmatrix_x4(w, mt + np * 16 * la + k0);
            mma_bf16(sc[2 * np], a[0], a[1], a[2], a[3], w[0], w[1]);
            mma_bf16(sc[2 * np + 1], a[0], a[1], a[2], a[3], w[2], w[3]);
          }
        }
#pragma unroll
        for (int ks = 0; ks < ND; ++ks)
          acc_to_a(sc[2 * ks], sc[2 * ks + 1], sa[ks]);
      }
#pragma unroll
      for (int ub = 0; ub < ND; ++ub) {
        // hidden units ub*16 .. ub*16+15 of the three gates
        float ai[3][2][4], ah[3][2][4];
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) ai[q][n][e] = ah[q][n][e] = 0.f;
        const bf* wrow = wx + (ub * 16 + r8 + top * 8) * L.lwx + hi * 8;
        // input gates: [dec_h | scene] from the tile, then the social
        // block, one float32 chain in the input matrix's row order
        for (int k0 = 0; k0 < d + C; k0 += 16) {
          uint32_t a[4];
          ldmatrix_x4(a, X + k0);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            uint32_t w[4];
            ldmatrix_x4(w, wrow + q * d * L.lwx + k0);
            mma_bf16(ai[q][0], a[0], a[1], a[2], a[3], w[0], w[1]);
            mma_bf16(ai[q][1], a[0], a[1], a[2], a[3], w[2], w[3]);
          }
        }
#pragma unroll
        for (int ks = 0; ks < ND; ++ks)
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            uint32_t w[4];
            ldmatrix_x4(w, wrow + q * d * L.lwx + d + C + ks * 16);
            mma_bf16(ai[q][0], sa[ks][0], sa[ks][1], sa[ks][2], sa[ks][3],
                     w[0], w[1]);
            mma_bf16(ai[q][1], sa[ks][0], sa[ks][1], sa[ks][2], sa[ks][3],
                     w[2], w[3]);
          }
#pragma unroll
        for (int ks = 0; ks < ND; ++ks)
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            uint32_t w[4];
            ldmatrix_x4(w, wh + (q * d + ub * 16 + r8 + top * 8) * L.lwh
                               + ks * 16 + hi * 8);
            mma_bf16(ah[q][0], ha[ks][0], ha[ks][1], ha[ks][2], ha[ks][3],
                     w[0], w[1]);
            mma_bf16(ah[q][1], ha[ks][0], ha[ks][1], ha[ks][2], ha[ks][3],
                     w[2], w[3]);
          }
        if (early_release && ub == ND - 1 && u + nb < steps) {
          // the step's tiles are read: the buffer goes back to the producers
          bar_arrive(empty0 + s, nth);
        }
        // the GRU on this thread's 16 elements (a column's weights loaded
        // once for both rows); gates [vel | dec | scene | social] as the
        // CUDA-core path sums them
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int c = ub * 16 + n * 8 + tig * 2 + p;
            float wvx[3], wvy[3], cbi[3], cbh[3];
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              wvx[q] = wiv[q * d + c];
              wvy[q] = wiv[d3 + q * d + c];
              cbi[q] = bi[q * d + c];
              cbh[q] = bh[q * d + c];
            }
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int e = p + 2 * rr;
              const float vx = rr ? vxb : vxa, vy = rr ? vyb : vya;
              float gi[3], gh[3];
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                gi[q] = (vx * wvx[q] + vy * wvy[q]) + (ai[q][n][e] + cbi[q]);
                gh[q] = ah[q][n][e] + cbh[q];
              }
              const float r = sigmoid_fast(gi[0] + gh[0]);
              const float z = sigmoid_fast(gi[1] + gh[1]);
              const float nn = tanh_fast(gi[2] + r * gh[2]);
              float& hv = h[2 * ub + n][e];
              hv = (1.f - z) * nn + z * hv;
            }
          }
      }
      // heads [psi | gate | dx | dy]: columns 2 tig, 2 tig + 1 of rows ra, rb
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < ND; ++ks) {
        uint32_t a[4];
        acc_to_a(h[2 * ks], h[2 * ks + 1], a);
        mma_bf16(o, a[0], a[1], a[2], a[3], hw[ks][0], hw[ks][1]);
      }
      const float oa0 = o[0] + hb0, oa1 = o[1] + hb1;
      const float ob0 = o[2] + hb0, ob1 = o[3] + hb1;
      const float dxa = __shfl_down_sync(0xffffffffu, oa0, 1);
      const float dya = __shfl_down_sync(0xffffffffu, oa1, 1);
      const float dxb = __shfl_down_sync(0xffffffffu, ob0, 1);
      const float dyb = __shfl_down_sync(0xffffffffu, ob1, 1);
      __syncwarp();
      if (tig == 0) {
        if (last) {
          if (va) score_a = score_a + oa0 * fmask[t * A + ra];
          if (vb) score_b = score_b + ob0 * fmask[t * A + rb];
        } else {
          // deltas, masked by the future mask; the producers read this
          // step's positions again only in the next pass
          auto move = [&](int row, float x, float y, float og, float ox,
                          float oy) {
            const float gate = sigmoid_fast(og);
            const float m = fmask[t * A + row] * delta_scale;
            const float dx = tanh_fast(ox) * gate;
            const float dy = tanh_fast(oy) * gate;
            const float nx = x + dx * m, ny = y + dy * m;
            xs[t * A + row] = nx;
            ys[t * A + row] = ny;
            if (iters != nullptr && lane_ok)
              reinterpret_cast<float2*>(iters)[(((((size_t)ip * B + b) * A
                                                  + row) * K + k) * T + t)] =
                  make_float2(nx, ny);
          };
          if (va) move(ra, xa, ya, oa1, dxa, dya);
          if (vb) move(rb, xb, yb, ob1, dxb, dyb);
        }
      }
      // the moved positions are read by the warp's other lanes T steps on
      __syncwarp();
      if (!early_release && u + nb < steps) bar_arrive(empty0 + s, nth);
    }
    if (tig == 0 && lane_ok) {
      if (va) scores[((size_t)b * A + ra) * K + k] = score_a;
      if (vb) scores[((size_t)b * A + rb) * K + k] = score_b;
    }
  } else {
    // ---- producers: the steps' tiles, kc lanes together ----------------
    const int ptid = tid - ncw * 32, pw = ptid >> 5, npw = npt >> 5;
    const int pieces = d / 8, cpieces = C / 8;
    constexpr int kRows = 32 / LPR;  // attention rows a warp at once
    const int sub = lane / LPR, q4 = lane % LPR;
    const bf* fm = fmap_g + (size_t)b * G * G * C;
    const float ninv = -1.f / tau;
    // the live agents of the batch row as bits, past 64 agents 64-127 in a
    // second word (a thread's first 8 columns of 16 lie below 64 when LPR
    // is 8)
    unsigned long long livebits = 0ull, livebits_hi = 0ull;
    for (int j = 0; j < min(A, 64); ++j)
      if (live[j] > 0.f) livebits |= 1ull << j;
    if constexpr (LPR == 8)
      for (int j = 64; j < A; ++j)
        if (live[j] > 0.f) livebits_hi |= 1ull << (j - 64);
    for (int u = 0; u < steps; ++u) {
      const int t = u % T, s = u % nb;
      // the buffers are free once their last reader has handed them back
      if (u >= nb) bar_sync(empty0 + s, nth);
      // dec_h rows, 16 bytes each, straight into the tile
      for (int i = ptid; i < kc * A * pieces; i += npt) {
        const int l = i / (A * pieces), rem = i - l * A * pieces;
        const int a = rem / pieces, q = rem - a * pieces;
        cp_async16(Xp(l, s) + a * lx + q * 8,
                   dec_h + ((((size_t)b * A + a) * K + lane_k(l)) * T + t) * d
                       + q * 8);
      }
      cp_async_commit();
      // scene block: 8 channels of an agent per piece, the four corner
      // pieces from L2; a thread sends the loads of kGatherBatch pieces
      // before it uses the first
      const int ngather = kc * A * cpieces;
      for (int i0 = ptid; i0 < ngather; i0 += kGatherBatch * npt) {
        uint4 cn[kGatherBatch][4];
        float w[kGatherBatch][4];
#pragma unroll
        for (int v = 0; v < kGatherBatch; ++v) {
          const int i = min(i0 + v * npt, ngather - 1);
          const int l = i / (A * cpieces), rem = i - l * A * cpieces;
          const int a = rem / cpieces, q = rem - a * cpieces;
          const float px = plane(l, L.xs)[t * A + a];
          const float py = plane(l, L.ys)[t * A + a];
          const float gx = fminf(fmaxf(px, 0.f), 1.f) * (G - 1);
          const float gy = fminf(fmaxf(py, 0.f), 1.f) * (G - 1);
          const float fx0 = floorf(gx), fy0 = floorf(gy);
          const float fx = gx - fx0, fy = gy - fy0;
          const int ix0 = (int)fx0, iy0 = (int)fy0;
          const int ix1 = min(ix0 + 1, G - 1), iy1 = min(iy0 + 1, G - 1);
          const uint4* base = reinterpret_cast<const uint4*>(fm + q * 8);
          const int cs = C / 8;
          cn[v][0] = __ldg(base + (iy0 * G + ix0) * cs);
          cn[v][1] = __ldg(base + (iy0 * G + ix1) * cs);
          cn[v][2] = __ldg(base + (iy1 * G + ix0) * cs);
          cn[v][3] = __ldg(base + (iy1 * G + ix1) * cs);
          w[v][0] = rnd<bf>((1.f - fx) * (1.f - fy));
          w[v][1] = rnd<bf>(fx * (1.f - fy));
          w[v][2] = rnd<bf>((1.f - fx) * fy);
          w[v][3] = rnd<bf>(fx * fy);
        }
#pragma unroll
        for (int v = 0; v < kGatherBatch; ++v) {
          const int i = i0 + v * npt;
          if (i >= ngather) break;
          const int l = i / (A * cpieces), rem = i - l * A * cpieces;
          const int a = rem / cpieces, q = rem - a * cpieces;
          float f[4][8], out[8];
#pragma unroll
          for (int c = 0; c < 4; ++c) bf16x8(cn[v][c], f[c]);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float acc = 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c) acc = fmaf(w[v][c], f[c][e], acc);
            out[e] = acc;
          }
          *reinterpret_cast<uint4*>(Xp(l, s) + a * lx + d + q * 8) =
              make_uint4(pack_bf16(make_float2(out[0], out[1])),
                         pack_bf16(make_float2(out[2], out[3])),
                         pack_bf16(make_float2(out[4], out[5])),
                         pack_bf16(make_float2(out[6], out[7])));
        }
      }
      // attention rows: LPR lanes a row, column j on lane j % LPR
      for (int row0 = pw * kRows; row0 < kc * A; row0 += npw * kRows) {
        const int row = row0 + sub;
        const bool act = row < kc * A;
        const int l = act ? row / A : 0, a = act ? row - l * A : 0;
        const float* qx = plane(l, social_freeze ? L.x0 : L.xs) + t * A;
        const float* qy = plane(l, social_freeze ? L.y0 : L.ys) + t * A;
        const float xa = qx[a], ya = qy[a];
        const float sqa = xa * xa + ya * ya;
        // logits -d^2 / tau (self and dead agents -1e9), fast exponentials
        float e[16];
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int j = q4 + LPR * i, jc = min(j, A - 1);
          const float xj = qx[jc], yj = qy[jc];
          const float d2 = (sqa + (xj * xj + yj * yj))
                           - 2.f * (xa * xj + ya * yj);
          bool excl;
          if constexpr (LPR == 4)
            excl = j == a || !((livebits >> jc) & 1ull);
          else
            excl = j == a || !(((i >= 8 ? livebits_hi : livebits)
                                >> (jc & 63)) & 1ull);
          e[i] = j < A ? (excl ? -1e9f : d2 * ninv) : -INFINITY;
          mx = fmaxf(mx, e[i]);
        }
#pragma unroll
        for (int o = 1; o < LPR; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          e[i] = __expf(e[i] - mx);  // 0 for the columns past A
          sum += e[i];
        }
#pragma unroll
        for (int o = 1; o < LPR; o <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (act) {
          bf* ar = attp(l, s) + a * la;
          const float scale = nbok[a] / sum;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int j = q4 + LPR * i;
            if (j < A) ar[j] = __float2bfloat16(e[i] * scale);
          }
        }
      }
      cp_async_wait<0>();
      bar_arrive(full0 + s, nth);
    }
  }
  __syncthreads();
  for (int i = tid; i < kc * T * A; i += nth) {
    const int l = i / (T * A), rem = i - l * T * A;
    const int t = rem / A, a = rem - t * A;
    if (kbase + l >= K) continue;
    const size_t r = ((size_t)b * A + a) * K + kbase + l;
    reinterpret_cast<float2*>(refined)[r * T + t] =
        make_float2(plane(l, L.xs)[rem], plane(l, L.ys)[rem]);
  }
}

// ---------------------------------------------------------------------------
// CUDA-core path (float32, or bf16 at other widths): one block per lane.

constexpr int kCcThreads = 512;

// Shared-memory layout. X holds the score GRU's input blocks per agent,
// [dec_h (d) | scene (C) | social (d)]; att the social weights; msg the
// messages (agent, d). Weights row-major (in, out).
template <typename CD>
struct CcLayout {
  int kx;
  size_t fmap, wx, wh, wmsg, headw, wiv, bi, bh, headb, bmsg;
  size_t x, y, x0, y0, fmask, out, h, hn, score, nbok, live, lg, X, att;
  size_t msg;
  size_t total;
  __host__ __device__ CcLayout(int A, int T, int d, int C, int G,
                               bool fmap_smem) {
    const int d3 = 3 * d;
    kx = 2 * d + C;
    const size_t cs = sizeof(CD);
    Bump b;
    fmap = fmap_smem ? b.take((size_t)G * G * C * cs) : 0;
    wx = b.take((size_t)kx * d3 * cs);
    wh = b.take((size_t)d * d3 * cs);
    wmsg = b.take((size_t)d * d * cs);
    headw = b.take((size_t)d * 4 * cs);
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
    h = b.take((size_t)A * d * 4);
    hn = b.take((size_t)A * d * 4);
    score = b.take((size_t)A * 4);
    nbok = b.take((size_t)A * 4);
    live = b.take((size_t)A * 4);
    lg = b.take((size_t)(kCcThreads / 32) * A * 4);
    X = b.take((size_t)A * kx * cs);
    att = b.take((size_t)A * A * cs);
    msg = b.take((size_t)A * d * cs);
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

template <typename CD>
__global__ void __launch_bounds__(kCcThreads) ioc_refine_cc_kernel(
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
  extern __shared__ __align__(16) unsigned char smem[];
  const CcLayout<CD> L(A, T, d, C, G, fmap_smem != 0);
  auto cdp = [&](size_t off) { return reinterpret_cast<CD*>(smem + off); };
  auto fp = [&](size_t off) { return reinterpret_cast<float*>(smem + off); };
  CD *wx = cdp(L.wx), *wh = cdp(L.wh), *wmsg = cdp(L.wmsg);
  CD* headw = cdp(L.headw);
  float *wiv = fp(L.wiv), *bi = fp(L.bi), *bh = fp(L.bh);
  float *headb = fp(L.headb), *bmsg = fp(L.bmsg);
  float *xs = fp(L.x), *ys = fp(L.y), *x0s = fp(L.x0), *y0s = fp(L.y0);
  float *fmask = fp(L.fmask), *out = fp(L.out);
  float *h = fp(L.h), *hn = fp(L.hn);
  float *score = fp(L.score), *nbok = fp(L.nbok), *live = fp(L.live);
  float* lgw = fp(L.lg) + (threadIdx.x / 32) * A;  // this warp's logits
  CD *X = cdp(L.X), *att = cdp(L.att), *msg = cdp(L.msg);

  const int b = blockIdx.x / K, k = blockIdx.x % K;
  const int d3 = 3 * d, kx = L.kx;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nth / 32;

  const CD* fm = fmap_g + (size_t)b * G * G * C;
  if (fmap_smem) {
    copy_rows(cdp(L.fmap), G * G * C, fm, 1, G * G * C);
    fm = cdp(L.fmap);
  }
  copy_rows(wx, d3, wx_g, kx, d3);
  copy_rows(wh, d3, wh_g, d, d3);
  copy_rows(wmsg, d, wmsg_g, d, d);
  copy_rows(headw, 4, headw_g, d, 4);
  copy_rows(wiv, 2 * d3, wiv_g, 1, 2 * d3);
  copy_rows(bi, d3, bi_g, 1, d3);
  copy_rows(bh, d3, bh_g, 1, d3);
  copy_rows(headb, 4, headb_g, 1, 4);
  for (int i = tid; i < d; i += nth) bmsg[i] = to_f(bmsg_g[i]);
  // positions as (T, A) planes; row (b, a, k) of the (B, A, K, T, .) inputs
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
  __syncthreads();

  for (int ip = 0; ip <= num_refine; ++ip) {
    const bool last = ip == num_refine;
    for (int i = tid; i < A * d; i += nth) h[i] = hn[i] = 0.f;
    const float* sx = social_freeze ? x0s : xs;
    const float* sy = social_freeze ? y0s : ys;
    for (int t = 0; t < T; ++t) {
      const float* px = xs + t * A;
      const float* py = ys + t * A;
      // 1. the step's decoder hiddens, scene features, attention weights
      for (int i = tid; i < A * d; i += nth) {
        const int a = i / d, j = i % d;
        X[a * kx + j] = dec_h[((((size_t)b * A + a) * K + k) * T + t) * d + j];
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
        X[a * kx + d + c] = from_f<CD>(acc);
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
            att[a * A + j] = from_f<CD>(lgw[j] / s * nbok[a]);
        }
      }
      __syncthreads();
      // 2. messages msg = round(round(dec_h Wmsg) + round(bmsg))
      for (int i = tid; i < A * d; i += nth) {
        const int a = i / d, c = i % d;
        float acc = 0.f;
        for (int j = 0; j < d; ++j)
          acc = fmaf(to_f(X[a * kx + j]), to_f(wmsg[j * d + c]), acc);
        msg[i] = from_f<CD>(rnd<CD>(acc) + bmsg[c]);
      }
      __syncthreads();
      // 3. social pooling into X: soc = att msg
      for (int i = tid; i < A * d; i += nth) {
        const int a = i / d, c = i % d;
        float acc = 0.f;
        for (int j = 0; j < A; ++j)
          acc = fmaf(to_f(att[a * A + j]), to_f(msg[j * d + c]), acc);
        X[a * kx + d + C + c] = from_f<CD>(acc);
      }
      __syncthreads();
      // 4. score GRU step; input gates [vel | dec | scene | social]
      for (int i = tid; i < A * d; i += nth) {
        const int a = i / d, c = i % d;
        const CD* xa = X + a * kx;
        float gd[3] = {0.f, 0.f, 0.f}, gs[3] = {0.f, 0.f, 0.f};
        float go[3] = {0.f, 0.f, 0.f}, ghs[3] = {0.f, 0.f, 0.f};
        for (int j = 0; j < d; ++j) {
          const float dv = to_f(xa[j]);
          const float ov = to_f(xa[d + C + j]);
          const float hv = rnd<CD>(h[a * d + j]);
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
        const float vx = t > 0 ? px[a] - xs[(t - 1) * A + a] : 0.f;
        const float vy = t > 0 ? py[a] - ys[(t - 1) * A + a] : 0.f;
        float gi[3], gh[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int g = q * d + c;
          gi[q] = ((vx * wiv[g] + vy * wiv[d3 + g]) + (gd[q] + bi[g])) + gs[q]
                  + go[q];
          gh[q] = ghs[q] + bh[g];
        }
        const float r = sigmoid(gi[0] + gh[0]);
        const float z = sigmoid(gi[1] + gh[1]);
        const float n = tanhf(gi[2] + r * gh[2]);
        hn[a * d + c] = (1.f - z) * n + z * h[a * d + c];
      }
      __syncthreads();
      {
        float* tmp = h;
        h = hn;
        hn = tmp;
      }
      // 5. heads [psi | gate | dx | dy]; the final pass accumulates scores
      for (int i = tid; i < A * 4; i += nth) {
        const int a = i / 4, q = i % 4;
        float acc = 0.f;
        for (int j = 0; j < d; ++j)
          acc = fmaf(rnd<CD>(h[a * d + j]), to_f(headw[j * 4 + q]), acc);
        const float o = acc + headb[q];
        out[(t * A + a) * 4 + q] = o;
        if (last && q == 0) score[a] = score[a] + o * fmask[t * A + a];
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

struct Args {
  const void *traj, *dec_h, *fmap, *live, *fut_mask, *wiv, *wx, *wh, *bi,
      *bh, *headw, *headb, *wmsg, *bmsg, *ltau;
  void *refined, *scores, *iters;
  int B, A, K, T, d, G, C, num_refine, social_freeze;
  float delta_scale;
  cudaStream_t stream;
};

// The tensor-core path's launch: 12 warps a block, kc lanes of mt consumer
// warps each (mt = agents / 16, rounded up) as many as leave each lane 2
// producer warps, the producers taking the other warps. The ring holds 2
// step tiles where shared memory allows (fewer lanes first), else 1 (1
// when T = 1). No layout past kTcMaxAgents agents: cudaErrorInvalidValue.
template <int ND, int LPR>
int launch_tc_lpr(const Args& g, int kc, int nb, size_t bytes) {
  using Cp = const __nv_bfloat16*;
  using F = const float*;
  cudaFuncSetAttribute(ioc_refine_tc_kernel<ND, LPR>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  const int groups = (g.K + kc - 1) / kc;
  ioc_refine_tc_kernel<ND, LPR>
      <<<g.B * groups, kTcThreads, bytes, g.stream>>>(
      F(g.traj), Cp(g.dec_h), Cp(g.fmap), F(g.live), F(g.fut_mask),
      F(g.wiv), Cp(g.wx), Cp(g.wh), F(g.bi), F(g.bh), Cp(g.headw),
      F(g.headb), Cp(g.wmsg), Cp(g.bmsg), F(g.ltau), (float*)g.refined,
      (float*)g.scores, (float*)g.iters, g.B, g.A, g.K, g.T, g.G, g.C,
      g.num_refine, g.social_freeze, g.delta_scale, kc, nb);
  return (int)cudaGetLastError();
}

// The lanes a block and the ring depth of the tensor-core path at these
// shapes, and the shared memory they take; false where none fits.
bool tc_shape(int A, int K, int T, int d, int C, bool freeze, int* kc_out,
              int* nb_out, size_t* bytes_out) {
  if (A < 1 || A > kTcMaxAgents) return false;
  const int mt = (A + 15) / 16;
  const int kc_max =
      min(min(K, kMaxLanes), kTcThreads / 32 / (mt + kProdWarps));
  for (int nb = T >= 2 ? 2 : 1; nb >= 1; --nb)
    for (int kc = kc_max; kc >= 1; --kc) {
      const size_t bytes = TcLayout(A, T, d, C, kc, nb, freeze).total;
      if (bytes <= kMaxSmem) {
        *kc_out = kc;
        *nb_out = nb;
        *bytes_out = bytes;
        return true;
      }
    }
  return false;
}

template <int ND>
int launch_tc(const Args& g) {
  int kc, nb;
  size_t bytes;
  if (!tc_shape(g.A, g.K, g.T, g.d, g.C, g.social_freeze != 0, &kc, &nb,
                &bytes))
    return cudaErrorInvalidValue;
  return g.A <= 64 ? launch_tc_lpr<ND, 4>(g, kc, nb, bytes)
                   : launch_tc_lpr<ND, 8>(g, kc, nb, bytes);
}

template <typename CD>
int launch_cc(const Args& g) {
  using F = const float*;
  using Cp = const CD*;
  bool fmap_smem = true;
  size_t bytes = CcLayout<CD>(g.A, g.T, g.d, g.C, g.G, true).total;
  if (bytes > kMaxSmem) {
    fmap_smem = false;
    bytes = CcLayout<CD>(g.A, g.T, g.d, g.C, g.G, false).total;
  }
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaFuncSetAttribute(ioc_refine_cc_kernel<CD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  ioc_refine_cc_kernel<CD><<<g.B * g.K, kCcThreads, bytes, g.stream>>>(
      F(g.traj), Cp(g.dec_h), Cp(g.fmap), F(g.live), F(g.fut_mask),
      F(g.wiv), Cp(g.wx), Cp(g.wh), F(g.bi), F(g.bh), Cp(g.headw),
      F(g.headb), Cp(g.wmsg), Cp(g.bmsg), F(g.ltau), (float*)g.refined,
      (float*)g.scores, (float*)g.iters, g.A, g.K, g.T, g.d, g.G, g.C,
      g.num_refine, g.social_freeze, g.delta_scale, fmap_smem ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace desire

// traj (B, A, K, T, 2), live (B, A), fut_mask (B, A, T) float32; dec_h
// (B, A, K, T, d) and fmap (B, G, G, C) in the compute dtype (bf16 when
// is_bf16, else float32). Weights: wiv (2, 3d), bi, bh (3d), headb (4),
// ltau (1) float32; bmsg (d) compute dtype. The matrices, compute dtype:
// wx = [Wdec; Wscene; Wsocial] (2d + C, 3d), wh (d, 3d), wmsg (d, d),
// headw (d, 4) = [score | gate | delta]; with use_mma (bf16, A <= 128, d
// and C multiples of 16, d <= 64) they come TRANSPOSED, (out, in), and
// headw zero-padded to (8, d). Outputs refined (B, A, K, T, 2) and scores
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
    int num_refine, int social_freeze, float delta_scale, void* stream) {
  const desire::Args g{traj, dec_h, fmap, live, fut_mask, wiv, wx, wh, bi,
                       bh, headw, headb, wmsg, bmsg, ltau, refined, scores,
                       iters, B, A, K, T, d, G, C, num_refine,
                       social_freeze, delta_scale,
                       static_cast<cudaStream_t>(stream)};
  if (use_mma) {
    if (!is_bf16 || A > desire::kTcMaxAgents || C % 16)
      return cudaErrorInvalidValue;
    switch (d) {
      case 16: return desire::launch_tc<1>(g);
      case 32: return desire::launch_tc<2>(g);
      case 48: return desire::launch_tc<3>(g);
      case 64: return desire::launch_tc<4>(g);
      default: return cudaErrorInvalidValue;
    }
  }
  if (is_bf16) return desire::launch_cc<__nv_bfloat16>(g);
  return desire::launch_cc<float>(g);
}

// The tensor-core path's block at these shapes: lanes a block (kc), step
// tiles in the ring (nb) and dynamic shared memory in bytes, written to
// out[3]; returns 0, or cudaErrorInvalidValue where no layout fits (more
// than 128 agents).
extern "C" int ioc_refine_tc_shape(int A, int K, int T, int d, int C,
                                   int social_freeze, long long* out) {
  int kc, nb;
  size_t bytes;
  if (!desire::tc_shape(A, K, T, d, C, social_freeze != 0, &kc, &nb, &bytes))
    return cudaErrorInvalidValue;
  out[0] = kc;
  out[1] = nb;
  out[2] = (long long)bytes;
  return 0;
}
