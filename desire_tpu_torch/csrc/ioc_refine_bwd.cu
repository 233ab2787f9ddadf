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
// What bounds it on this card: the serial dependency chain, not the
// arithmetic. A block runs (R + 1) passes x 2 sweeps x T steps, each step a
// handful of small products over the lane's A agents between block
// barriers, and shared memory (one block per SM) leaves no second block to
// fill the waits. What a step waits for: the weight fragments of the
// products, which come from device memory (L2) for every work item, the
// chains of dependent shared-memory reads and shuffles in the per-agent
// phases, and the cotangents d_dec and d_msg that are read, added to and
// written back in device memory. With kMma the weight gradients of the
// GRU's two matrices are off that chain (each reverse step only logs its
// operand tiles, and a second kernel, bound by the bytes of that log, forms
// both after the passes), and so are the step's reads of what it saved
// (asked for a phase ahead by cp.async). The kernel is also bound by its
// registers: one block of 384 threads an SM leaves 168 a thread, and most
// of the kernel runs within ~30 of that (see tid_here).
//
// What the design does:
// * One block per (batch row, lane) holds all A agents of the lane, as the
//   forward kernel does: social attention mixes agents only within a lane.
// * Each pass is recomputed from its saved positions (levels[p]), never by
//   replaying earlier passes. The per-step values the reverse sweep needs
//   (the GRU gates and the hidden n-gate preactivation, the GRU states, the
//   scene and social blocks, the heads' cotangents that seed the hidden
//   cotangent) go to a float32 workspace in device memory, private to the
//   block: at the flagship shape ~1.4 MB per block, six times what shared
//   memory holds. Attention weights are recomputed in the reverse sweep
//   from the step's positions instead of stored.
// * In bf16 with d and C multiples of 16 (kMma) every product of a step
//   runs on the tensor cores (mma.sync m16n8k16, float32 accumulation).
//   What only products read (the step's input blocks X, the messages, the
//   social cotangent, the rounded gate cotangents R, the rounded GRU state
//   and the rounded attention) lives in shared memory once, as bf16 operand
//   tiles with rows padded to 16 and strides that ldmatrix reads without
//   bank conflicts, plain or transposed: the social pool att msg, its
//   adjoints att^T ds and ds msg^T need no transposed copy. Products with a
//   weight matrix load all the weight fragments of a work item before its
//   first mma (one wait per item). Only what element-wise math reads stays
//   float32 (the gate cotangents G, the GRU state, the attention and its
//   cotangent). Otherwise (float32, or other d and C) the products run on
//   the CUDA cores, each thread a small register tile of outputs (tile_mm),
//   on float32 tiles.
// * The weight gradients of the input and hidden matrices (kMma): d Wi =
//   sum X^T R and d Wh = sum hr^T R over every (pass, step, agent) of every
//   block are one product whose depth is all those rows. Each reverse step
//   writes its three tiles X, hr and R, as they are, to the block's operand
//   log in device memory (16-byte streaming stores, ~49 KB a step at the
//   flagship; this kernel never reads them back), in the barrier interval
//   of its products. After the kernel, on the same stream,
//   ioc_bwd_wgrad_kernel streams the whole log (~3.8 GB at the flagship)
//   once through the tensor cores. The step keeps no weight-gradient item,
//   no read-modify-write of a partial in device memory and no partial of
//   the hidden matrix in shared memory.
// * 16-byte accesses (kMma): the workspace, dec_h, msg and the feature map
//   are read and written as 16-byte pieces, four (or eight bf16) channels
//   of an agent per thread. What a step reads from device memory as it is
//   (dec_h, the messages, the scene and social blocks, which the workspace
//   keeps in bf16, the saved gates, the heads' cotangents, the previous GRU
//   state) is asked for by cp.async a phase or more before the step, into
//   the shared memory it is read from, so that no thread waits for it on
//   the chain: the forward sweep asks for step t + 1's once step t's input
//   gates have read X, the reverse sweep for step t - 1's once step t's
//   products and pooling adjoint are done. More loads in flight per thread
//   into registers (the adjoint's values asked for ahead of the attention,
//   a step's rows staged in one batch) timed slower, as did a larger block.
// * The per-agent phases (attention, its adjoint, position and velocity
//   cotangents) give a row to 4 lanes, 8 rows a warp at once, instead of a
//   warp per row with the rows one after another.
// * Deterministic, with no atomics: every weight gradient has one owner,
//   which forms the step's agent sum on its own (a zeroed accumulator) and
//   adds it to the block's partial, in a fixed (pass, step) order. The
//   partials of the biases and the heads stay in shared memory until the
//   passes are done; without mma those of the input and hidden matrices are
//   read, added to and written back in device memory every step (with mma
//   the product kernel's fixed slices and the wrapper's fixed sum order
//   stand in for that order). d_dec and d_msg are written by the first
//   pass and added to by the later ones. The feature-map gradient is
//   gathered after the passes into shared memory, each (node, channel)
//   owned by one thread that walks (pass, step, agent, corner) in order
//   over entries staged in shared memory chunk by chunk. The wrapper sums
//   the per-block partials in a fixed order, as the TPU wrapper sums its
//   per-program partials.
// * Numerics follow the TPU kernel: products round their operands to the
//   compute dtype and accumulate in float32; element-wise math, the social
//   softmax and its adjoint stay float32.
#include <type_traits>

#include "common.cuh"

namespace desire {
namespace {

// Threads of a block. One block fills an SM's shared memory, so this is also
// the SM's thread count: 12 warps, which leaves each thread 168 registers
// (16 warps spilled at 128 and timed slower, as did 8, 10, 11, 14, 20 and
// 24), and divides the flagship's product items evenly (36 items each of the
// input and hidden gates, 12 of the hidden cotangent: two 16-row tiles an
// item, which timed faster than one).
constexpr int kBwdThreads = 384;

// threadIdx.x, opaque to the compiler where it is read: what is derived from
// it (a loop's first index, a lane's fragment offsets) is computed where it
// is used instead of being hoisted out of the pass loop, where each such
// value held a register for the whole kernel. The backward kernel runs at
// its register limit; with the thread index read once, the tensor-core
// variant spilled (12 to 140 bytes by variant) and timed up to 20 % slower.
__device__ __forceinline__ int tid_here() {
  int t = threadIdx.x;
  asm volatile("" : "+r"(t));
  return t;
}

// Shared-memory layout. X holds a step's score-GRU input blocks per agent,
// each already rounded to the compute dtype; G and R hold the gate
// cotangents [r | z | n | n * r] of a reverse step, G in float32 as computed
// and R rounded to the compute dtype (the operand of the products). hc/hn
// (the GRU state of the forward sweep) double as dhc/hp (the hidden
// cotangent and the previous state of the reverse sweep). The forward sweep
// stages its gate products in G as [r: input + hidden | z: input + hidden |
// n: input | n: hidden]. small holds the block's partials of the bias and
// head gradients [d bi (3d) | d bh (3d) | d heads (d, 4) | d heads' bias
// (4)]. After the passes, once these are written out, the feature-map
// accumulator (G * G * C) reuses the whole region. With mma G's rows (and
// dsc's) are padded by four floats: a warp's accesses of 8 rows x 4 columns
// then spread over the banks (with rows of 4d or C floats, a multiple of
// 32, they fell on the same ones).
//
// What only products read (X, msg, dsoc, R, and with mma the rounded GRU
// state hr and the rounded attention attb) is an operand tile. With mma
// (bf16, d and C multiples of 16) the tiles are bf16, rows padded to a
// multiple of 16 and row strides of mma_stride(), so that ldmatrix reads
// them without bank conflicts, plain or transposed; the padding rows and
// columns are zeroed once and never written. X's columns are then [scene
// (C) | social (d) | dec_h (d) | vel (2) | zeros (14)], so that every block
// starts on a 16-byte boundary. Without mma the tiles are float32, X in
// the input-gate matrix's row order [vel | scene | social | dec_h].
struct BwdLayout {
  int lx, lg, lm, lr, la, rows;
  size_t x, y, gx, gy, fmask, live, nbok, gsc, ltrow, veld, dout, small;
  size_t hc, hn, dsc, att, dl, G, X, msg, dsoc, R, hr, attb, tiles_end;
  size_t total;
  __host__ __device__ BwdLayout(int A, int T, int d, int C, int Gr,
                                bool mma) {
    const size_t f = 4, o = mma ? 2 : 4;
    rows = mma ? (A + 15) / 16 * 16 : A;
    lx = mma ? mma_stride(C + 2 * d + 16) : 2 + C + 2 * d;
    lg = mma ? 4 * d + 4 : 4 * d;
    lm = mma ? mma_stride(d) : d;
    lr = mma ? mma_stride(4 * d) : 4 * d;
    la = mma_stride(rows);
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
    small = b.take((size_t)(10 * d + 4) * f);
    hc = b.take((size_t)A * d * f);
    hn = b.take((size_t)A * d * f);
    dsc = b.take((size_t)A * (mma ? C + 4 : C) * f);
    att = b.take((size_t)A * A * f);
    dl = b.take((size_t)A * A * f);
    G = b.take((size_t)A * lg * f);
    X = b.take((size_t)rows * lx * o);
    msg = b.take((size_t)rows * lm * o);
    dsoc = b.take((size_t)rows * lm * o);
    R = b.take((size_t)rows * lr * o);
    hr = attb = b.off;
    if (mma) {
      hr = b.take((size_t)rows * lm * 2);
      attb = b.take((size_t)rows * la * 2);
    }
    tiles_end = (b.off + 15) & ~size_t(15);
    total = tiles_end;
    const size_t acc = (size_t)Gr * Gr * C * f;
    if (acc > total) total = acc;
  }
};

// The tensor-core variant: bf16 with d and C multiples of 16.
__host__ __device__ inline bool bwd_mma(int is_bf16, int d, int C) {
  return is_bf16 && d % 16 == 0 && C % 16 == 0;
}

// Float32 words of one block's device-memory scratch: the GRU gates r, z,
// n and the hidden n-gate preactivation (T, A, 4d), hs (T, A, d), scene
// (T, A, C), social (T, A, d) (kMma: both in bf16, in the first half of
// their regions), the heads' cotangents (T, A, 4), scene cotangents
// (R + 1, T, A, C); under social_freeze also the two social-cotangent
// buckets (refine passes, re-score), (T, A, d) each.
__host__ __device__ inline size_t bwd_ws_words(int A, int T, int d, int C,
                                               int R, int freeze) {
  return (size_t)T * A * (6 * d + C + 4) + (size_t)(R + 1) * T * A * C
         + (freeze ? (size_t)2 * T * A * d : 0);
}

// The operand log of the tensor-core variant: every reverse step's operand
// tiles, rows padded to 16 agents, each row W bf16 [X (C + 2d + 16) | hr
// (d) | R (4d)], a block's (R + 1) * T steps in (pass, step) order and the
// blocks one after another, so that the weight-gradient product reads one
// (rows, W) matrix.
__host__ __device__ inline int log_width(int d, int C) {
  return C + 7 * d + 16;
}
__host__ __device__ inline size_t log_rows(int A, int T, int R) {
  return (size_t)(R + 1) * T * ((A + 15) / 16 * 16);
}

// Float32 words of the whole workspace of B * K blocks: their scratch, then
// (tensor-core variant) their operand logs. The wrapper computes the same
// number (ops/ioc_bwd.py bwd_workspace_words).
__host__ __device__ inline size_t bwd_total_words(int B, int A, int K,
                                                  int T, int d, int C, int R,
                                                  int freeze, bool mma) {
  return (size_t)B * K
         * (bwd_ws_words(A, T, d, C, R, freeze)
            + (mma ? log_rows(A, T, R) * log_width(d, C) / 2 : 0));
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

// ldmatrix: four 8 x 8 bf16 matrices from shared memory, lane l giving the
// 16-byte row l % 8 of matrix l / 8; lane (gid, tig) receives of matrix i
// the elements [gid][2 tig, 2 tig + 1] in r[i], or with .trans the elements
// [2 tig, 2 tig + 1][gid].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// One warp's 16 x (16 NT) tile of a product of two bf16 operand tiles in
// shared memory, float32 accumulation (mma.sync m16n8k16):
//   acc[2 j + h] += sum_k A(m0 + .., k) B(k, bcol(j) + 8 h + ..)
// for k < 16 ksteps, in the mma accumulator layout. AT false: A is stored
// [m][k]; true: [k][m] (read transposed). BT false: B is stored [n][k];
// true: [k][n] (read transposed). Strides multiples of 8 (best
// mma_stride()), m0 and bcol(j) multiples of 16 within the padded tiles.
template <int NT, bool AT, bool BT, typename BCol>
__device__ __forceinline__ void warp_mma(const __nv_bfloat16* A, int lda,
                                         int m0, const __nv_bfloat16* B,
                                         int ldb, BCol bcol, int ksteps,
                                         float (&acc)[2 * NT][4]) {
  const int lane = tid_here() % 32;
  const int r8 = lane % 8, hi = (lane / 8) % 2, top = lane / 16;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = ks * 16;
    uint32_t a[4];
    if constexpr (AT)
      ldsm_x4_t(a, A + (k0 + r8 + top * 8) * lda + m0 + hi * 8);
    else
      ldsm_x4(a, A + (m0 + r8 + hi * 8) * lda + k0 + top * 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = bcol(j);
      uint32_t b[4];
      if constexpr (BT)
        ldsm_x4_t(b, B + (k0 + r8 + hi * 8) * ldb + n + top * 8);
      else
        ldsm_x4(b, B + (n + r8 + top * 8) * ldb + k0 + hi * 8);
      mma_bf16(acc[2 * j], a[0], a[1], a[2], a[3], b[0], b[1]);
      mma_bf16(acc[2 * j + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
    }
  }
}

// epi(row, col, value) over a warp_mma accumulator whose tile j starts at
// column bcol(j).
template <int NT, typename BCol, typename Epi>
__device__ __forceinline__ void frag_epi(const float (&acc)[2 * NT][4],
                                         int m0, BCol bcol, Epi epi) {
  const int lane = tid_here() % 32, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    const int c = bcol(j / 2) + (j % 2) * 8 + tig * 2;
    epi(m0 + gid, c, acc[j][0]);
    epi(m0 + gid, c + 1, acc[j][1]);
    epi(m0 + gid + 8, c, acc[j][2]);
    epi(m0 + gid + 8, c + 1, acc[j][3]);
  }
}

// A warp_mma accumulator added to a float32 matrix in device memory: the
// lane's pairs of rows lo and hi (null: a padding row), tile j at column
// col(j), each pair one 8-byte read and write; every read is sent before
// the first add. fresh: the matrix holds nothing yet, the accumulator is
// written as it is.
template <int NT, typename Col>
__device__ __forceinline__ void frag_add_global(
    const float (&acc)[2 * NT][4], float* lo, float* hi, Col col,
    bool fresh = false) {
  const int tig = tid_here() & 3;
  float2 vl[2 * NT], vh[2 * NT];
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    const int c = col(j / 2) + (j % 2) * 8 + tig * 2;
    vl[j] = vh[j] = make_float2(0.f, 0.f);
    if (lo && !fresh) vl[j] = *reinterpret_cast<const float2*>(lo + c);
    if (hi && !fresh) vh[j] = *reinterpret_cast<const float2*>(hi + c);
  }
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    const int c = col(j / 2) + (j % 2) * 8 + tig * 2;
    if (lo)
      *reinterpret_cast<float2*>(lo + c) =
          make_float2(vl[j].x + acc[j][0], vl[j].y + acc[j][1]);
    if (hi)
      *reinterpret_cast<float2*>(hi + c) =
          make_float2(vh[j].x + acc[j][2], vh[j].y + acc[j][3]);
  }
}

// The per-agent phases (attention rows, their adjoint, the position and
// velocity cotangents) give a row to kRowLanes neighbouring lanes, so that a
// warp works on 32 / kRowLanes rows at once: their chains of dependent
// shared-memory reads, exponentials and shuffles overlap instead of
// following one another, and the block's 12 warps take 96 rows in one go.
// Sums and maxima over a row's lanes (a fixed butterfly order); every lane
// of the row gets the result.
constexpr int kRowLanes = 4;
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kRowLanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = kRowLanes / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// What the forward sweep saved of a GRU step for its adjoint: the gates, the
// hidden n-gate preactivation and the hidden cotangent's seed.
struct Saved {
  float r, z, n, ghn, seed;
};

// Block-wide pass over n elements with the device-memory latency paid once
// per U elements of a thread: st(i, ld(i)) for i < n, a thread's U loads
// all sent before its first store.
template <int U, typename Ld, typename St>
__device__ __forceinline__ void stream_in(int n, Ld ld, St st) {
  for (int base = threadIdx.x; base < n; base += U * blockDim.x) {
    decltype(ld(0)) v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n) v[u] = ld(i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n) st(i, v[u]);
    }
  }
}

// The same over an (nrows, ncols) array, a warp per row and its lanes over
// the columns (no index divisions): st(a, j, ld(a, j)), U rows of a warp
// loaded together.
template <int U, typename Ld, typename St>
__device__ __forceinline__ void rows_in(int nrows, int ncols, Ld ld, St st) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  for (int a0 = warp; a0 < nrows; a0 += U * nw) {
    for (int j = lane; j < ncols; j += 32) {
      decltype(ld(0, 0)) v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (a0 + u * nw < nrows) v[u] = ld(a0 + u * nw, j);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (a0 + u * nw < nrows) st(a0 + u * nw, j, v[u]);
    }
  }
}

// 16-byte accesses of the vector paths (mma variant: d and C are multiples
// of 16, so every row of the workspace, of the inputs and of the operand
// tiles starts on a 16-byte boundary). The workspace streams: written once
// and read once, it should not push the weights and cotangents out of L2.
__device__ __forceinline__ void ld4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void ld4_const(const float* p, float (&f)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void st4(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void st4_stream(float* p, const float (&f)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
}
// four float32 rounded to bf16, 8 bytes of an operand tile
__device__ __forceinline__ void st4_bf16(__nv_bfloat16* p,
                                         const float (&f)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(
      pack_bf16(make_float2(f[0], f[1])), pack_bf16(make_float2(f[2], f[3])));
}
// a bf16 pair widened (exactly) to float32
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// f(row, col, value) over the accumulators of a block_mma_pre item.
template <int MT, typename F>
__device__ __forceinline__ void item_each(const float (&acc)[MT][4], int mt0,
                                          int mtiles, int c0, F f) {
  const int lane = tid_here() % 32, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (mt0 + m < mtiles) {
      const int r = (mt0 + m) * 16 + gid, c = c0 + tig * 2;
      f(r, c, acc[m][0]);
      f(r, c + 1, acc[m][1]);
      f(r + 8, c, acc[m][2]);
      f(r + 8, c + 1, acc[m][3]);
    }
  }
}

// A block_mma_pre item added to float32 rows in device memory: rowptr(r)
// is row r's pointer (null: a padding row), the lane's pairs of columns
// at c0 + 2 tig; every read is sent before the first add. fresh: the rows
// hold nothing yet, the item is written as it is.
template <int MT, typename RowPtr>
__device__ __forceinline__ void item_add_global(const float (&acc)[MT][4],
                                                int mt0, int mtiles, int c0,
                                                RowPtr rowptr,
                                                bool fresh = false) {
  const int lane = tid_here() % 32, gid = lane >> 2, tig = lane & 3;
  float2* p[MT][2];
  float2 v[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* r = mt0 + m < mtiles ? rowptr((mt0 + m) * 16 + gid + 8 * h)
                                  : nullptr;
      p[m][h] = r ? reinterpret_cast<float2*>(r + c0 + tig * 2) : nullptr;
      v[m][h] = make_float2(0.f, 0.f);
      if (p[m][h] && !fresh) v[m][h] = *p[m][h];
    }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (p[m][h])
        *p[m][h] = make_float2(v[m][h].x + acc[m][2 * h],
                               v[m][h].y + acc[m][2 * h + 1]);
}

// Block-wide tensor-core product of a bf16 operand tile in shared memory
// with a weight matrix in device memory, as block_mma (common.cuh):
//   sum_k A[r * lda + k] * WT[c * ldwt + k]
// but the A fragments come by ldmatrix and a work item's weight fragments
// (up to KC k-steps) are all loaded before its first mma, so that an item
// waits for device memory once, not once per k-step. A warp's item is one
// 8-column tile for MT row tiles; epi(mt0, c0, acc) gets the whole item
// (first row tile, first column, accumulators; item_each walks them).
// kmap(k0) is A's column for the product's k0 (a multiple of 16). rot turns
// each further group of row tiles by so many column tiles, so that the
// column tiles whose epilogue costs most (a read-modify-write of device
// memory) do not all fall to the same warps.
template <int MT, typename KMap, typename Epi>
__device__ __forceinline__ void block_mma_pre(const __nv_bfloat16* A,
                                              int lda, int mtiles, int kdim,
                                              KMap kmap,
                                              const __nv_bfloat16* WT,
                                              int ldwt, int ncols, Epi epi,
                                              int rot = 0) {
  constexpr int KC = 9;
  const int warp = tid_here() / 32, lane = tid_here() % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int r8 = lane % 8, hi = (lane / 8) % 2, top = lane / 16;
  const int ctiles = ncols / 8, mgroups = (mtiles + MT - 1) / MT;
  for (int item = warp; item < ctiles * mgroups; item += blockDim.x / 32) {
    const int mg = item / ctiles, mt0 = mg * MT;
    const int c0 = ((item + mg * rot) % ctiles) * 8;
    float acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
    const __nv_bfloat16* b = WT + (size_t)(c0 + gid) * ldwt + tig * 2;
    for (int kc = 0; kc < kdim; kc += 16 * KC) {
      uint32_t bf[KC][2];
#pragma unroll
      for (int s_ = 0; s_ < KC; ++s_) {
        const int k0 = kc + 16 * s_;
        if (k0 < kdim) {
          bf[s_][0] = load_pair(b + k0);
          bf[s_][1] = load_pair(b + k0 + 8);
        }
      }
#pragma unroll
      for (int s_ = 0; s_ < KC; ++s_) {
        const int k0 = kc + 16 * s_;
        if (k0 < kdim) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (mt0 + m < mtiles) {
              uint32_t a[4];
              ldsm_x4(a, A + ((mt0 + m) * 16 + r8 + hi * 8) * lda + kmap(k0)
                             + top * 8);
              mma_bf16(acc[m], a[0], a[1], a[2], a[3], bf[s_][0], bf[s_][1]);
            }
          }
        }
      }
    }
    epi(mt0, c0, acc);
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

// kMma (bf16, d and C multiples of 16): every product runs on the tensor
// cores, from bf16 operand tiles in shared memory (block_mma_pre where the
// second operand is a weight matrix in device memory, warp_mma where both
// are tiles); otherwise all of them run as CUDA-core tiles (tile_mm) on
// float32 operand tiles. kFreeze: social_freeze, a variant of its own so
// that the default one keeps its registers.
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
    float* __restrict__ ws_g, __nv_bfloat16* __restrict__ log_g, int A,
    int K, int T, int d, int G, int C, int R, float delta_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  using OT = std::conditional_t<kMma, __nv_bfloat16, float>;  // operand tiles
  const BwdLayout L(A, T, d, C, G, kMma);
  auto fp = [&](size_t off) { return reinterpret_cast<float*>(smem + off); };
  auto op = [&](size_t off) { return reinterpret_cast<OT*>(smem + off); };
  float *xs = fp(L.x), *ys = fp(L.y), *gx = fp(L.gx), *gy = fp(L.gy);
  float *fmask = fp(L.fmask), *live = fp(L.live), *nbok = fp(L.nbok);
  float *gsc = fp(L.gsc), *ltrow = fp(L.ltrow), *veld = fp(L.veld);
  float* dout = fp(L.dout);
  float *hc = fp(L.hc), *hn = fp(L.hn);
  float* const dhc = fp(L.hc);  // reverse sweep: hidden-state cotangent
  float* const hp = fp(L.hn);   // reverse sweep: the previous GRU state
  float *dsc = fp(L.dsc), *att = fp(L.att), *dl = fp(L.dl), *Gc = fp(L.G);
  OT *X = op(L.X), *msg = op(L.msg), *dsoc = op(L.dsoc), *Rc = op(L.R);
  // with mma: the GRU state (forward sweep) or the previous state (reverse
  // sweep) and the attention, rounded
  __nv_bfloat16* const hr = reinterpret_cast<__nv_bfloat16*>(smem + L.hr);
  __nv_bfloat16* const attb = reinterpret_cast<__nv_bfloat16*>(smem + L.attb);

  const int blk = blockIdx.x, b = blk / K, k = blk % K;
  const int B = gridDim.x / K;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nth / 32;
  const int d3 = 3 * d, F = 2 + C + 2 * d, lx = L.lx, lg = L.lg;
  const int lm = L.lm, lr = L.lr, la = L.la;
  // X's column blocks: scene, social, dec_h, vel
  const int rs_off = kMma ? 0 : 2, ro_off = rs_off + C, rd_off = ro_off + d;
  const int rv_off = kMma ? C + 2 * d : 0;
  const size_t plane = (size_t)B * A * K * T * 2;              // one level
  const int mtiles = (A + 15) / 16;  // agent-row tiles of the mma products
  auto row = [&](int a) { return ((size_t)b * A + a) * K + k; };

  float* ws = ws_g + (size_t)blk * bwd_ws_words(A, T, d, C, R, kFreeze);
  float* gate_ws = ws;                            // (T, A, 4d): r z n gh_n
  float* hs_ws = gate_ws + (size_t)T * A * 4 * d; // (T, A, d)
  float* sc_ws = hs_ws + (size_t)T * A * d;       // (T, A, C)
  float* so_ws = sc_ws + (size_t)T * A * C;       // (T, A, d)
  float* dout_ws = so_ws + (size_t)T * A * d;     // (T, A, 4)
  float* dsc_ws = dout_ws + (size_t)T * A * 4;    // (R + 1, T, A, C)
  // social_freeze: d social of the refine passes and of the re-score
  float* bkr_ws = dsc_ws + (size_t)(R + 1) * T * A * C;  // (T, A, d)
  float* bkc_ws = bkr_ws + (size_t)T * A * d;            // (T, A, d)

  // the block's weight-gradient partials: the small ones in shared memory,
  // written out after the passes; without mma the input and hidden
  // matrices' in device memory (with mma the block logs its operand tiles
  // instead, from which ioc_bwd_wgrad_kernel forms those two after it)
  float* const dwi = kMma ? nullptr : d_wi_p + (size_t)blk * F * d3;
  float* const dwh = kMma ? nullptr : d_wh_p + (size_t)blk * d * d3;
  // the log's columns [X | hr | R] and this block's first row
  const int lxw = C + 2 * d + 16, lw = log_width(d, C);
  __nv_bfloat16* const oplog =
      kMma ? log_g + (size_t)blk * log_rows(A, T, R) * lw : nullptr;
  float* const dbi = fp(L.small);   // (3d)
  float* const dbh = dbi + d3;      // (3d)
  float* const dhw = dbh + d3;      // (d, 4)
  float* const dhb = dhw + d * 4;   // (4)
  const CD* fm = fmap_g + (size_t)b * G * G * C;

  // ---- set-up: zero this block's accumulators, load masks and cotangents
  if constexpr (!kMma) {
    for (int i = tid_here(); i < F * d3; i += nth) dwi[i] = 0.f;
    for (int i = tid_here(); i < d * d3; i += nth) dwh[i] = 0.f;
  }
  for (int i = tid_here(); i < 10 * d + 4; i += nth) dbi[i] = 0.f;
  if constexpr (kFreeze)
    for (int i = tid_here(); i < 2 * T * A * d; i += nth) bkr_ws[i] = 0.f;
  if constexpr (kMma) {  // the operand tiles' padding stays zero
    uint32_t* z = reinterpret_cast<uint32_t*>(smem + L.X);
    for (int i = tid_here(); i < (int)((L.tiles_end - L.X) / 4); i += nth)
      z[i] = 0u;
  }
  for (int i = tid_here(); i < T * A; i += nth) {
    const int t = i / A, a = i % A;
    const size_t o = (row(a) * T + t) * 2;
    gx[i] = g_ref[o];
    gy[i] = g_ref[o + 1];
    fmask[i] = fut_mask[((size_t)b * A + a) * T + t];
  }
  for (int a = tid_here(); a < A; a += nth) {
    live[a] = live_g[(size_t)b * A + a];
    gsc[a] = g_sc[row(a)];
  }
  __syncthreads();
  for (int a = tid_here(); a < A; a += nth) {
    float ok = 0.f;
    for (int j = 0; j < A; ++j)
      if (j != a && live[j] > 0.f) ok = 1.f;
    nbok[a] = ok;
  }
  const float ltau = ltau_g[0];
  const float tau = expf(ltau) + 1e-4f;
  const float ninv_tau = -1.f / tau;
  float ltau_acc = 0.f;  // thread 0's running d soc_logtau
  __syncthreads();

  // Rows of agents over the block: each_row(f) calls f(a, ok, sub) with the
  // whole warp converged, a the row of the lane's group (clamped to a valid
  // row where ok is false: such a group may read but must not write) and
  // sub the lane's place among the row's kRowLanes lanes.
  auto each_row = [&](auto f) {
    constexpr int per_warp = 32 / kRowLanes;
    for (int a0 = (tid_here() / 32) * per_warp; a0 < A;
         a0 += nwarps * per_warp) {
      const int ln = tid_here() % 32;
      const int a = a0 + ln / kRowLanes;
      f(min(a, A - 1), a < A, ln % kRowLanes);
    }
  };
  // the social softmax of step t at the current positions into att (A, A);
  // the logits as the forward kernel forms them
  auto attend = [&](int t) {
    const float* qx = xs + t * A;
    const float* qy = ys + t * A;
    each_row([&](int a, bool ok, int sub) {
      const float xa = qx[a], ya = qy[a];
      const float sqa = xa * xa + ya * ya;
      float* w = att + a * A;
      float mx = -INFINITY;
      if (ok)
        for (int j = sub; j < A; j += kRowLanes) {
          float lg_ = -1e9f;
          if (j != a && live[j] > 0.f) {
            const float xj = qx[j], yj = qy[j];
            const float d2 = (sqa + (xj * xj + yj * yj))
                             - 2.f * (xa * xj + ya * yj);
            lg_ = d2 * ninv_tau;
          }
          w[j] = lg_;
          mx = fmaxf(mx, lg_);
        }
      mx = row_max(mx);
      float s = 0.f;
      if (ok)
        for (int j = sub; j < A; j += kRowLanes) {
          w[j] = expf(w[j] - mx);
          s += w[j];
        }
      s = row_sum(s);
      if (ok) {
        const float inv = nbok[a] / s;
        for (int j = sub; j < A; j += kRowLanes) {
          const float v = w[j] * inv;
          w[j] = v;
          if constexpr (kMma) attb[a * la + j] = __float2bfloat16(v);
        }
      }
    });
  };
  // the step's decoder hiddens (into X) and messages
  auto load_dec_msg = [&](int t) {
    if constexpr (kMma) {  // 8 bf16 per access, as they are
      const int d8 = d / 8;
      for (int it = tid_here(); it < 2 * A * d8; it += nth) {
        const bool is_msg = it >= A * d8;
        const int i2 = is_msg ? it - A * d8 : it;
        const int a = i2 / d8, j = (i2 % d8) * 8;
        const size_t o = (row(a) * T + t) * d + j;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            (is_msg ? msg_g : dec_h) + o));
        *reinterpret_cast<uint4*>(is_msg ? msg + a * lm + j
                                         : X + a * lx + rd_off + j) = v;
      }
    } else {
      rows_in<4>(
          A, d,
          [&](int a, int j) {
            const size_t o = (row(a) * T + t) * d + j;
            return make_float2(to_f(dec_h[o]), to_f(msg_g[o]));
          },
          [&](int a, int j, float2 v) {
            X[a * lx + rd_off + j] = from_f<OT>(v.x);
            msg[a * lm + j] = from_f<OT>(v.y);
          });
    }
  };
  // a (T, A, n) float32 workspace block of step t into X's columns at off,
  // rounded values that the operand tile holds exactly (without mma)
  auto ws_to_x = [&](const float* src, int n, int t, int off) {
    rows_in<4>(
        A, n,
        [&](int a, int j) {
          return __ldcs(src + ((size_t)t * A + a) * n + j);
        },
        [&](int a, int j, float v) { X[a * lx + off + j] = from_f<OT>(v); });
  };
  // kMma: the scene and social blocks are kept in the workspace in bf16,
  // the values the operand tile holds, so that they are copied into X as
  // they are. The operands a step reads from device memory are asked for
  // by cp.async a phase or more ahead of it, into the shared memory they
  // are read from (nothing else there reads that memory meanwhile), and
  // waited for where the step needs them: a step's device-memory round
  // trips leave its chain of barriers.
  __nv_bfloat16* const sc_b = reinterpret_cast<__nv_bfloat16*>(sc_ws);
  __nv_bfloat16* const so_b = reinterpret_cast<__nv_bfloat16*>(so_ws);
  // A rows of n 16-byte pieces, agent a's from src + a * sstride to dst +
  // a * dstride (bytes)
  auto async_rows = [&](void* dst, int dstride, const void* src,
                        size_t sstride, int n) {
    for (int it = tid_here(); it < A * n; it += nth) {
      const int a = it / n, j = (it - a * n) * 16;
      cp_async16(static_cast<char*>(dst) + a * dstride + j,
                 static_cast<const char*>(src) + a * sstride + j);
    }
  };
  // step t's dec_h (into X) or messages (into msg): agent a's row (b, a,
  // k, t) lies K * T * d elements after agent a - 1's
  auto async_dec_msg = [&](int t, bool is_msg) {
    const size_t o = (row(0) * T + t) * d, stride = (size_t)K * T * d * 2;
    if (is_msg)
      async_rows(msg, lm * 2, msg_g + o, stride, d / 8);
    else
      async_rows(X + rd_off, lx * 2, dec_h + o, stride, d / 8);
  };
  // a (T, A, n) bf16 workspace block of step t into X's columns at off
  auto async_block = [&](const __nv_bfloat16* src, int n, int t, int off) {
    async_rows(X + off, lx * 2, src + (size_t)t * A * n, n * 2, n / 8);
  };
  // the rounded GRU state of the forward sweep
  auto h_rounded = [&](const float* h, int a, int j) {
    if constexpr (kMma)
      return to_f(hr[a * lm + j]);
    else
      return rnd<CD>(h[a * d + j]);
  };
  const int n16 = d / 16;  // 16-column tiles of a d-wide block (mma)
  auto same_k = [](int k0) { return k0; };
  // operand accessors of the products
  auto w_in = [&](const CD* w, int ld, int off) {
    return [=](int kk, int n) { return to_f(w[(size_t)kk * ld + off + n]); };
  };
  // the social pool soc = att msg of the attention in att, per output
  auto pool = [&](auto epi) {
    if constexpr (kMma) {
      for (int item = tid_here() / 32; item < mtiles * n16; item += nwarps) {
        const int m0 = (item / n16) * 16, n0 = (item % n16) * 16;
        auto col = [=](int) { return n0; };
        float acc[2][4] = {};
        warp_mma<1, false, true>(attb, la, m0, msg, lm, col, mtiles, acc);
        frag_epi<1>(acc, m0, col, [&](int a, int c, float v) {
          if (a < A) epi(a, c, v);
        });
      }
    } else {
      tile_mm<4, 2>(
          A, d, A, [&](int a, int j) { return rnd<CD>(att[a * A + j]); },
          [&](int j, int c) { return msg[j * d + c]; }, epi);
    }
  };
  // the pooling adjoint for the social cotangent ds (A, d), already rounded:
  // d msg of step t += att^T ds (fresh: = att^T ds, the first time the step
  // is written), dl <- ds msg^T (the cotangent of att)
  auto pool_adjoint = [&](int t, const OT* ds, bool to_msg, bool fresh) {
    if constexpr (kMma) {
      const int n_msg = to_msg ? mtiles * n16 : 0;
      for (int item = tid_here() / 32; item < n_msg + mtiles * mtiles;
           item += nwarps) {
        float acc[2][4] = {};
        if (item < n_msg) {   // d msg (j, c) += sum_a att[a][j] ds[a][c]
          const int m0 = (item / n16) * 16, n0 = (item % n16) * 16;
          auto col = [=](int) { return n0; };
          warp_mma<1, true, true>(attb, la, m0, ds, lm, col, mtiles, acc);
          const int j0 = m0 + (lane >> 2);
          frag_add_global<1>(
              acc, j0 < A ? d_msg + (row(j0) * T + t) * d : nullptr,
              j0 + 8 < A ? d_msg + (row(j0 + 8) * T + t) * d : nullptr, col,
              fresh);
        } else {              // dl (a, j) = sum_c ds[a][c] msg[j][c]
          const int it = item - n_msg;
          const int m0 = (it / mtiles) * 16, n0 = (it % mtiles) * 16;
          auto col = [=](int) { return n0; };
          warp_mma<1, false, false>(ds, lm, m0, msg, lm, col, n16, acc);
          frag_epi<1>(acc, m0, col, [&](int a, int j, float v) {
            if (a < A && j < A) dl[a * A + j] = v;
          });
        }
      }
    } else {
      if (to_msg)
        tile_mm<4, 2>(
            A, d, A, [&](int j, int a) { return rnd<CD>(att[a * A + j]); },
            [&](int a, int c) { return ds[a * d + c]; },
            [&](int j, int c, float acc) {
              float* o = d_msg + (row(j) * T + t) * d + c;
              *o = fresh ? acc : *o + acc;
            });
      tile_mm<4, 2>(
          A, A, d, [&](int a, int c) { return ds[a * d + c]; },
          [&](int c, int j) { return msg[j * d + c]; },
          [&](int a, int j, float acc) { dl[a * A + j] = acc; });
    }
  };
  // the softmax adjoint at positions (px, py): dl <- d logits, ltrow[a] <-
  // the row's sum of d logits * d^2
  auto softmax_adjoint = [&](const float* px, const float* py) {
    each_row([&](int a, bool ok, int sub) {
      const float* w = att + a * A;
      float* r = dl + a * A;
      float dot = 0.f;
      if (ok)
        for (int j = sub; j < A; j += kRowLanes)
          dot += r[j] * nbok[a] * w[j];
      dot = row_sum(dot);
      const float xa = px[a], ya = py[a];
      const float sqa = xa * xa + ya * ya;
      float lt = 0.f;
      if (ok)
        for (int j = sub; j < A; j += kRowLanes) {
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
      lt = row_sum(lt);
      if (ok && sub == 0) ltrow[a] = lt;
    });
  };
  auto add_ltau = [&]() {
    if (tid == 0) {
      float s = 0.f;
      for (int a = 0; a < A; ++a) s += ltrow[a];
      ltau_acc += s / (tau * tau) * expf(ltau);
    }
  };
  // agent a's position cotangent through the distances of the softmax whose
  // d logits are in dl, summed over the row's lanes; each of them gets it
  auto social_dpos = [&](int a, int sub, const float* px, const float* py) {
    const float xa = px[a], ya = py[a];
    float rsum = 0.f, csum = 0.f, mx = 0.f, my = 0.f;
    for (int j = sub; j < A; j += kRowLanes) {
      const float dra = dl[a * A + j] * ninv_tau;
      const float dca = dl[j * A + a] * ninv_tau;
      rsum += dra;
      csum += dca;
      const float sym = rnd<CD>(dra + dca);
      mx = fmaf(sym, rnd<CD>(px[j]), mx);
      my = fmaf(sym, rnd<CD>(py[j]), my);
    }
    rsum = row_sum(rsum);
    csum = row_sum(csum);
    mx = row_sum(mx);
    my = row_sum(my);
    return make_float2(2.f * ((rsum + csum) * xa - mx),
                       2.f * ((rsum + csum) * ya - my));
  };

  if constexpr (kFreeze) {
    // the frozen social block: pooled once at the initial positions, read
    // by every pass's forward and reverse sweeps
    for (int i = tid_here(); i < T * A; i += nth) {
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
        if constexpr (kMma)
          so_b[((size_t)t * A + a) * d + c] = __float2bfloat16(acc);
        else
          __stcs(so_ws + ((size_t)t * A + a) * d + c, rnd<CD>(acc));
      });
      __syncthreads();
    }
  }

  for (int p = R; p >= 0; --p) {
    const bool score_pass = p == R;
    const float* lev = p == 0 ? traj : iters + (size_t)(p - 1) * plane;
    for (int i = tid_here(); i < T * A; i += nth) {
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
    for (int i = tid_here(); i < A * d; i += nth) {
      hc[i] = 0.f;
      if constexpr (kMma) hr[(i / d) * lm + i % d] = __float2bfloat16(0.f);
    }
    // kMma: step t's dec_h, and its messages or (social_freeze) its frozen
    // social block, asked for once step t - 1's input gates have read X
    auto prefetch_fwd = [&](int t) {
      async_dec_msg(t, false);
      if constexpr (kFreeze)
        async_block(so_b, d, t, ro_off);
      else
        async_dec_msg(t, true);
      cp_async_commit();
    };
    if constexpr (kMma) prefetch_fwd(0);
    __syncthreads();

    // ---------------- forward sweep: recompute and seed ------------------
    for (int t = 0; t < T; ++t) {
      const float* px = xs + t * A;
      const float* py = ys + t * A;
      if constexpr (!kMma) load_dec_msg(t);
      if constexpr (kMma) {
        // 8 channels of an agent's scene block per thread: the four corner
        // pieces asked for together, the channel's four multiply-adds in
        // corner order
        const int c8 = C / 8;
        for (int it = tid_here(); it < A * c8; it += nth) {
          const int a = it / c8, c0 = (it % c8) * 8;
          const Corners q = corners(px[a], py[a], G);
          uint4 f[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            f[e] = __ldg(reinterpret_cast<const uint4*>(fm + q.n[e] * C + c0));
          float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float w = rnd<CD>(q.w[e]);
            const uint32_t u[4] = {f[e].x, f[e].y, f[e].z, f[e].w};
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const float2 v = unpack_bf16(u[h]);
              acc[2 * h] = fmaf(w, v.x, acc[2 * h]);
              acc[2 * h + 1] = fmaf(w, v.y, acc[2 * h + 1]);
            }
          }
          uint32_t o[4];
#pragma unroll
          for (int h = 0; h < 4; ++h)
            o[h] = pack_bf16(make_float2(acc[2 * h], acc[2 * h + 1]));
          const uint4 v = make_uint4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<uint4*>(X + a * lx + rs_off + c0) = v;
          __stcs(reinterpret_cast<uint4*>(sc_b + ((size_t)t * A + a) * C
                                          + c0), v);
        }
      } else {
        rows_in<4>(
            A, C,
            [&](int a, int c) {
              const Corners q = corners(px[a], py[a], G);
              float f[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) f[e] = to_f(fm[q.n[e] * C + c]);
              float acc = 0.f;
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc = fmaf(rnd<CD>(q.w[e]), f[e], acc);
              return rnd<CD>(acc);
            },
            [&](int a, int c, float v) {
              X[a * lx + rs_off + c] = from_f<OT>(v);
              __stcs(sc_ws + ((size_t)t * A + a) * C + c, v);
            });
      }
      if constexpr (kFreeze) {
        if constexpr (!kMma) ws_to_x(so_ws, d, t, ro_off);
      } else {
        attend(t);
      }
      if constexpr (kMma) cp_async_wait<0>();  // prefetch_fwd(t)
      __syncthreads();
      // social pool soc = att msg; hidden gates h W_h, staged in G as
      // [r | z | . | n]
      if constexpr (!kFreeze)
        pool([&](int a, int c, float acc) {
          X[a * lx + ro_off + c] = from_f<OT>(rnd<CD>(acc));
          if constexpr (kMma)
            so_b[((size_t)t * A + a) * d + c] = __float2bfloat16(acc);
          else
            __stcs(so_ws + ((size_t)t * A + a) * d + c, rnd<CD>(acc));
        });
      auto stage_gh = [&](int a, int g, float acc) {
        if (a < A) Gc[a * lg + (g < 2 * d ? g : g + d)] = acc;
      };
      // the input gates join them: [r + r | z + z | n | .]
      auto stage_gi = [&](int a, int g, float acc) {
        if (a < A) {
          if (g < 2 * d)
            Gc[a * lg + g] += acc;
          else
            Gc[a * lg + g] = acc;
        }
      };
      if constexpr (kMma) {
        block_mma_pre<2>(hr, lm, mtiles, d, same_k, whT, d, d3,
                         [&](int mt0, int c0, const auto& acc) {
                           item_each(acc, mt0, mtiles, c0, stage_gh);
                         });
      } else {
        tile_mm<4, 2>(
            A, d3, d, [&](int a, int j) { return rnd<CD>(hc[a * d + j]); },
            w_in(wh, d3, 0), stage_gh);
      }
      __syncthreads();
      // input gates [scene | social | dec] W
      if constexpr (kMma) {
        block_mma_pre<2>(X + rs_off, lx, mtiles, F - 2, same_k, wiT + 2, F,
                         d3,
                         [&](int mt0, int c0, const auto& acc) {
                           item_each(acc, mt0, mtiles, c0, stage_gi);
                         });
      } else {
        tile_mm<4, 2>(
            A, d3, F - 2, [&](int a, int j) { return X[a * lx + 2 + j]; },
            w_in(wi + (size_t)2 * d3, d3, 0), stage_gi);
      }
      __syncthreads();
      if constexpr (kMma)
        if (t + 1 < T) prefetch_fwd(t + 1);
      // the GRU step
      if constexpr (kMma) {  // four channels of an agent per thread
        const int d4 = d / 4;
        for (int it = tid_here(); it < A * d4; it += nth) {
          const int a = it / d4, c = (it % d4) * 4, i = a * d + c;
          const float vx = t > 0 ? px[a] - xs[(t - 1) * A + a] : 0.f;
          const float vy = t > 0 ? py[a] - ys[(t - 1) * A + a] : 0.f;
          const float* st = Gc + a * lg + c;
          float pre[3][4], gate[4][4], hv[4], bq[4];
#pragma unroll
          for (int q = 0; q < 3; ++q) {  // r and z: input + hidden; n: input
            float wx[4], wy[4], sq[4];
            ld4_const(wiv + q * d + c, wx);
            ld4_const(wiv + d3 + q * d + c, wy);
            ld4_const(bi + q * d + c, bq);
            ld4(st + q * d, sq);
#pragma unroll
            for (int u = 0; u < 4; ++u)
              pre[q][u] = (vx * wx[u] + vy * wy[u]) + (sq[u] + bq[u]);
          }
          ld4(st + 3 * d, gate[3]);
          ld4_const(bh + 2 * d + c, bq);
#pragma unroll
          for (int u = 0; u < 4; ++u) gate[3][u] += bq[u];  // gh_n
          ld4_const(bh + c, bq);
#pragma unroll
          for (int u = 0; u < 4; ++u) gate[0][u] = sigmoid(pre[0][u] + bq[u]);
          ld4_const(bh + d + c, bq);
          ld4(hc + i, hv);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            gate[1][u] = sigmoid(pre[1][u] + bq[u]);
            gate[2][u] = tanhf(pre[2][u] + gate[0][u] * gate[3][u]);
            hv[u] = (1.f - gate[1][u]) * gate[2][u] + gate[1][u] * hv[u];
          }
          st4(hn + i, hv);
          st4_bf16(hr + a * lm + c, hv);
          st4_stream(hs_ws + (size_t)t * A * d + i, hv);
          float* gw = gate_ws + ((size_t)t * A + a) * 4 * d + c;
#pragma unroll
          for (int q = 0; q < 4; ++q) st4_stream(gw + q * d, gate[q]);
        }
      } else {
        for (int a = tid_here() / 32; a < A; a += nwarps)
        for (int c = lane; c < d; c += 32) {
          const int i = a * d + c;
          const float vx = t > 0 ? px[a] - xs[(t - 1) * A + a] : 0.f;
          const float vy = t > 0 ? py[a] - ys[(t - 1) * A + a] : 0.f;
          const float* st = Gc + a * lg;
          float pre[3];  // r and z: input + hidden; n: input
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const int g = q * d + c;
            pre[q] = (vx * wiv[g] + vy * wiv[d3 + g]) + (st[g] + bi[g]);
          }
          const float ghn = st[3 * d + c] + bh[2 * d + c];
          const float r = sigmoid(pre[0] + bh[c]);
          const float z = sigmoid(pre[1] + bh[d + c]);
          const float n = tanhf(pre[2] + r * ghn);
          const float hnew = (1.f - z) * n + z * hc[i];
          hn[i] = hnew;
          __stcs(hs_ws + (size_t)t * A * d + i, hnew);
          float* gw = gate_ws + ((size_t)t * A + a) * 4 * d + c;
          __stcs(gw, r);
          __stcs(gw + d, z);
          __stcs(gw + 2 * d, n);
          __stcs(gw + 3 * d, ghn);
        }
      }
      __syncthreads();
      {
        float* tmp = hc;
        hc = hn;
        hn = tmp;
      }
      // heads [psi | gate | dx | dy] and their cotangents: one thread per
      // (agent, head), the four of an agent neighbours in a warp
      for (int i0 = (tid_here() / 32) * 32; i0 < A * 4; i0 += nth) {
        const int i = i0 + lane;
        const bool ok = i < A * 4;
        const int a = ok ? i / 4 : 0, q = i % 4;
        float acc = 0.f;
        for (int j = 0; j < d; ++j)
          acc = fmaf(h_rounded(hc, a, j), to_f(hwc[j * 4 + q]), acc);
        const float o = acc + hb[q];
        const int base = lane & ~3;
        const float o1 = __shfl_sync(0xffffffffu, o, base + 1);
        const float o2 = __shfl_sync(0xffffffffu, o, base + 2);
        const float o3 = __shfl_sync(0xffffffffu, o, base + 3);
        if (ok) {
          const float fm_t = fmask[t * A + a];
          float v = 0.f;
          if (score_pass) {
            if (q == 0) v = gsc[a] * fm_t;
          } else if (q > 0) {
            const float m = fm_t * delta_scale;
            const float gate = sigmoid(o1);
            const float tx = tanhf(o2), ty = tanhf(o3);
            const float ddx = gx[t * A + a] * m, ddy = gy[t * A + a] * m;
            if (q == 1) v = (ddx * tx + ddy * ty) * gate * (1.f - gate);
            if (q == 2) v = ddx * gate * (1.f - tx * tx);
            if (q == 3) v = ddy * gate * (1.f - ty * ty);
          }
          dout[i] = v;
          // the reverse sweep seeds the hidden cotangent from these
          __stcs(dout_ws + (size_t)t * A * 4 + i, v);
        }
      }
      __syncthreads();
      // the heads' weight gradients; the next barrier is the next step's
      // first (nothing before it writes what these sums read)
      for (int e = tid_here(); e < d * 4 + 4; e += nth) {
        if (e < d * 4) {
          const int j = e / 4, q = e % 4;
          float s = 0.f;
          for (int a = 0; a < A; ++a)
            s = fmaf(rnd<CD>(dout[a * 4 + q]), h_rounded(hc, a, j), s);
          dhw[e] += s;
        } else {
          const int q = e - d * 4;
          float s = 0.f;
          for (int a = 0; a < A; ++a) s += dout[a * 4 + q];
          dhb[q] += s;
        }
      }
    }
    __syncthreads();

    // ---------------- reverse sweep --------------------------------------
    // kMma: step t's operands, asked for once step t + 1 no longer reads
    // where they go (after its products, and its pooling adjoint, which
    // reads the messages): dec_h and the scene and social blocks into X,
    // the messages, the saved gates into G (whose rows the adjoint then
    // overwrites in place), the heads' cotangents into dout, the previous
    // GRU state into hp
    auto prefetch_rev = [&](int t) {
      async_dec_msg(t, false);
      if constexpr (!kFreeze) async_dec_msg(t, true);
      async_block(sc_b, C, t, rs_off);
      async_block(so_b, d, t, ro_off);
      async_rows(Gc, lg * 4, gate_ws + (size_t)t * A * 4 * d, 16 * d, d);
      async_rows(dout, 16, dout_ws + (size_t)t * A * 4, 16, 1);
      if (t > 0)
        async_rows(hp, d * 4, hs_ws + (size_t)(t - 1) * A * d, d * 4, d / 4);
      else
        for (int i = tid_here(); i < A * d; i += nth) hp[i] = 0.f;
      cp_async_commit();
    };
    for (int i = tid_here(); i < A * d; i += nth) dhc[i] = 0.f;
    if constexpr (kMma) prefetch_rev(T - 1);
    __syncthreads();
    for (int t = T - 1; t >= 0; --t) {
      const float* px = xs + t * A;
      const float* py = ys + t * A;
      // GRU adjoint of step t, from the gates the forward sweep saved:
      // G <- [drp | dzp | dnp | dnp * r], R its rounded copy
      auto vel_to_x = [&]() {
        for (int a = tid_here(); a < A; a += nth) {
          X[a * lx + rv_off] =
              from_f<OT>(rnd<CD>(t > 0 ? px[a] - xs[(t - 1) * A + a] : 0.f));
          X[a * lx + rv_off + 1] =
              from_f<OT>(rnd<CD>(t > 0 ? py[a] - ys[(t - 1) * A + a] : 0.f));
        }
      };
      if constexpr (kMma) {
        // The step's operands arrive by prefetch_rev; four channels of an
        // agent per thread, 16 bytes per access.
        const int d4 = d / 4;
        auto ask = [&](int it, float (&v)[6][4]) {
          const int a = it / d4, c = (it % d4) * 4;
#pragma unroll
          for (int q = 0; q < 4; ++q) ld4(Gc + a * lg + q * d + c, v[q]);
          ld4(dout + a * 4, v[4]);
          ld4(hp + a * d + c, v[5]);
        };
        auto adjoint = [&](int it, const float (&v)[6][4]) {
          const int a = it / d4, c = (it % d4) * 4, i = a * d + c;
          float dh[4], g[4][4];
          ld4(dhc + i, dh);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float h4[4];
            ld4_const(hw + (c + u) * 4, h4);
            const float seed = v[4][0] * h4[0] + v[4][1] * h4[1]
                               + v[4][2] * h4[2] + v[4][3] * h4[3];
            const float r = v[0][u], z = v[1][u], n = v[2][u];
            const float dhu = seed + dh[u];
            const float dn = dhu * (1.f - z);
            const float dz = dhu * (v[5][u] - n);
            const float dnp = dn * (1.f - n * n);
            const float dr = dnp * v[3][u];
            g[0][u] = dr * r * (1.f - r);
            g[1][u] = dz * z * (1.f - z);
            g[2][u] = dnp;
            g[3][u] = dnp * r;
            dh[u] = dhu * z;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            st4(Gc + a * lg + q * d + c, g[q]);
            st4_bf16(Rc + a * lr + q * d + c, g[q]);
          }
          st4(dhc + i, dh);
          st4_bf16(hr + a * lm + c, v[5]);
        };
        vel_to_x();
        if constexpr (!kFreeze) attend(t);
        cp_async_wait<0>();  // prefetch_rev(t)
        __syncthreads();
        for (int it = tid_here(); it < A * d4; it += nth) {
          float sv[6][4];
          ask(it, sv);
          adjoint(it, sv);
        }
      } else {
        load_dec_msg(t);
        rows_in<4>(
            A, d,
            [&](int a, int j) {
              const size_t o = ((size_t)t * A + a) * d + j;
              return make_float2(
                  t > 0 ? __ldcs(hs_ws + o - (size_t)A * d) : 0.f,
                  __ldcs(so_ws + o));
            },
            [&](int a, int j, float2 v) {
              hp[a * d + j] = v.x;
              X[a * lx + ro_off + j] = from_f<OT>(v.y);
            });
        ws_to_x(sc_ws, C, t, rs_off);
        vel_to_x();
        if constexpr (!kFreeze) attend(t);
        __syncthreads();
        rows_in<2>(A, d, [&](int a, int c) {
          const float* gw = gate_ws + ((size_t)t * A + a) * 4 * d + c;
          const float* dq = dout_ws + ((size_t)t * A + a) * 4;
          return Saved{__ldcs(gw), __ldcs(gw + d), __ldcs(gw + 2 * d),
                       __ldcs(gw + 3 * d),
                       __ldcs(dq) * hw[c * 4] + __ldcs(dq + 1) * hw[c * 4 + 1]
                           + __ldcs(dq + 2) * hw[c * 4 + 2]
                           + __ldcs(dq + 3) * hw[c * 4 + 3]};
        }, [&](int a, int c, const Saved& sv) {
          const int i = a * d + c;
          float* g1 = Gc + a * lg;
          OT* r1 = Rc + a * lr;
          const float r = sv.r, z = sv.z, n = sv.n, ghn = sv.ghn;
          const float dh = sv.seed + dhc[i];
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
          r1[c] = from_f<OT>(rnd<CD>(drp));
          r1[d + c] = from_f<OT>(rnd<CD>(dzp));
          r1[2 * d + c] = from_f<OT>(rnd<CD>(dnp));
          r1[3 * d + c] = from_f<OT>(rnd<CD>(dnp * r));
          dhc[i] = dh * z;
        });
      }
      __syncthreads();
      // the hidden-side cotangents [drp | dzp | dnp * r], rounded
      auto rh_col = [=](int g) { return g < 2 * d ? g : g + d; };
      // h_prev's cotangent
      auto add_dh = [&](int a, int j, float acc) {
        if (a < A) dhc[a * d + j] += acc;
      };
      // the scene, social and dec_h blocks' cotangents
      auto block_ct = [&](int a, int n, float acc) {
            if (a >= A) return;
            if (n < C) {
              dsc[a * (kMma ? C + 4 : C) + n] = acc;
              __stcs(dsc_ws + ((size_t)p * T + t) * A * C + a * C + n, acc);
            } else if (n < C + d) {
              if constexpr (kFreeze)  // the deferred adjoint's bucket
                (score_pass ? bkc_ws : bkr_ws)[((size_t)t * A + a) * d + n
                                               - C] += acc;
              else
                dsoc[a * lm + n - C] = from_f<OT>(rnd<CD>(acc));
            } else {
              float* o = d_dec + (row(a) * T + t) * d + n - C - d;
              *o = score_pass ? acc : *o + acc;  // the first pass writes
            }
          };
      if constexpr (kMma) {
        auto add_dh_item = [&](int mt0, int c0, const auto& acc) {
          item_each(acc, mt0, mtiles, c0, add_dh);
        };
        // R's columns [drp | dzp | dnp * r] against wh's [r | z | n]
        block_mma_pre<2>(Rc, lr, mtiles, d3, rh_col, wh, d3, d, add_dh_item);
        // an item's 8 columns lie in one block (C and d are multiples of
        // 16): what is added to device memory goes as one batch
        block_mma_pre<2>(
            Rc, lr, mtiles, d3, same_k, wi + (size_t)2 * d3, d3, F - 2,
            [&](int mt0, int c0, const auto& acc) {
              if (c0 >= C + d) {
                item_add_global(acc, mt0, mtiles, c0 - C - d, [&](int a) {
                  return a < A ? d_dec + (row(a) * T + t) * d : nullptr;
                }, score_pass);  // the first pass writes
              } else if (kFreeze && c0 >= C) {
                float* bk = score_pass ? bkc_ws : bkr_ws;
                item_add_global(acc, mt0, mtiles, c0 - C, [&](int a) {
                  return a < A ? bk + ((size_t)t * A + a) * d : nullptr;
                });
              } else {
                item_each(acc, mt0, mtiles, c0, block_ct);
              }
            },
            (F - 2) / 16);
      } else {
        tile_mm<4, 2>(
            A, d, d3, [&](int a, int g) { return Rc[a * lr + rh_col(g)]; },
            w_in(whT, d, 0), add_dh);
        tile_mm<4, 2>(
            A, F - 2, d3, [&](int a, int g) { return Rc[a * lr + g]; },
            w_in(wiT, F, 2), block_ct);
      }
      // the velocity cotangent, an agent's sum over the 3d gate columns
      each_row([&](int a, bool ok, int sub) {
        const float* g1 = Gc + a * lg;
        float sx = 0.f, sy = 0.f;
        for (int g = sub; g < d3; g += kRowLanes) {
          sx = fmaf(g1[g], wiv[g], sx);
          sy = fmaf(g1[g], wiv[d3 + g], sy);
        }
        sx = row_sum(sx);
        sy = row_sum(sy);
        if (ok && sub == 0) {
          veld[2 * a] = sx;
          veld[2 * a + 1] = sy;
        }
      });
      if constexpr (kMma) {
        // the step's operand tiles to the log, 16 bytes a piece: the weight
        // gradients d Wi = X^T R and d Wh = hr^T [drp | dzp | dnp * r] are
        // formed after this kernel, over every block's logged rows at once
        // (ioc_bwd_wgrad_kernel); the log is never read back here
        __nv_bfloat16* const dst =
            oplog + ((size_t)p * T + t) * L.rows * lw;
        const int per = lw / 8;
        for (int it = tid_here(); it < L.rows * per; it += nth) {
          const int a = it / per, j = (it % per) * 8;
          const __nv_bfloat16* src =
              j < lxw       ? X + a * lx + j
              : j < lxw + d ? hr + a * lm + j - lxw
                            : Rc + a * lr + j - lxw - d;
          __stcs(reinterpret_cast<uint4*>(dst + (size_t)a * lw + j),
                 *reinterpret_cast<const uint4*>(src));
        }
      } else {
        // weight gradients: each element's sum over this step's agents,
        // formed on its own and then added to its partial
        tile_mm<4, 4>(
            F, d3, A, [&](int f, int a) { return X[a * lx + f]; },
            [&](int a, int g) { return Rc[a * lr + g]; },
            [&](int f, int g, float acc) { dwi[(size_t)f * d3 + g] += acc; });
        tile_mm<4, 4>(
            d, d3, A, [&](int j, int a) { return rnd<CD>(hp[a * d + j]); },
            [&](int a, int g) { return Rc[a * lr + rh_col(g)]; },
            [&](int j, int g, float acc) { dwh[(size_t)j * d3 + g] += acc; });
      }
      for (int g = tid_here(); g < 2 * d3; g += nth) {
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
        pool_adjoint(t, dsoc, true, score_pass);
        __syncthreads();
      }
      // X, G, dout, hp and msg are read: the next step's operands go there
      if constexpr (kMma)
        if (t > 0) prefetch_rev(t - 1);
      if constexpr (!kFreeze) {
        softmax_adjoint(px, py);
        __syncthreads();
        add_ltau();
      }
      if (!score_pass) {
        // position cotangents: scene gather, social distances (deferred
        // under social_freeze), velocity; an agent's lanes sum over channels
        // and neighbours (a fixed butterfly order)
        each_row([&](int a, bool ok, int sub) {
          const float xa = px[a], ya = py[a];
          const Corners q = corners(xa, ya, G);
          float dhot[4] = {0.f, 0.f, 0.f, 0.f};
          for (int c = sub; c < C; c += kRowLanes) {
            float f[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) f[e] = to_f(fm[q.n[e] * C + c]);
            const float g = rnd<CD>(dsc[a * (kMma ? C + 4 : C) + c]);
#pragma unroll
            for (int e = 0; e < 4; ++e) dhot[e] = fmaf(g, f[e], dhot[e]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) dhot[e] = row_sum(dhot[e]);
          float2 soc = make_float2(0.f, 0.f);
          if constexpr (!kFreeze) soc = social_dpos(a, sub, px, py);
          if (ok && sub == 0) {
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
        });
      }
      __syncthreads();
    }
  }

  if constexpr (kFreeze) {
    // the deferred frozen-attention adjoint, once per step; xs/ys hold the
    // initial positions again (the last pass was p = 0). The attention is
    // recomputed from them, as the reverse sweeps recompute theirs.
    // the rounded (refine + re-score) bucket and the rounded refine bucket,
    // (A, d) operand tiles
    OT *s_all, *s_ref;
    if constexpr (kMma) {
      s_all = dsoc;
      s_ref = hr;
    } else {
      s_all = dhc;
      s_ref = hp;
    }
    for (int t = 0; t < T; ++t) {
      const float* px = xs + t * A;
      const float* py = ys + t * A;
      load_dec_msg(t);
      attend(t);
      for (int i = tid_here(); i < A * d; i += nth) {
        const float r = bkr_ws[(size_t)t * A * d + i];
        const int o = (i / d) * lm + i % d;
        s_all[o] = from_f<OT>(rnd<CD>(r + bkc_ws[(size_t)t * A * d + i]));
        s_ref[o] = from_f<OT>(rnd<CD>(r));
      }
      __syncthreads();
      // d msg and d soc_logtau hear both buckets
      pool_adjoint(t, s_all, true, true);
      __syncthreads();
      softmax_adjoint(px, py);
      __syncthreads();
      add_ltau();
      __syncthreads();
      // the positions only the refine passes' bucket
      pool_adjoint(t, s_ref, false, false);
      __syncthreads();
      softmax_adjoint(px, py);
      __syncthreads();
      each_row([&](int a, bool ok, int sub) {
        const float2 soc = social_dpos(a, sub, px, py);
        if (ok && sub == 0) {
          gx[t * A + a] += soc.x;
          gy[t * A + a] += soc.y;
        }
      });
      __syncthreads();
    }
  }

  // ---- outputs: position cotangents, d soc_logtau --------------------------
  for (int i = tid_here(); i < T * A; i += nth) {
    const int t = i / A, a = i % A;
    const size_t o = (row(a) * T + t) * 2;
    d_traj[o] = gx[i];
    d_traj[o + 1] = gy[i];
  }
  if (tid == 0) d_ltau_p[blk] = ltau_acc;
  for (int i = tid_here(); i < d3; i += nth) {
    d_bi_p[(size_t)blk * d3 + i] = dbi[i];
    d_bh_p[(size_t)blk * d3 + i] = dbh[i];
  }
  for (int i = tid_here(); i < d * 4 + 4; i += nth)
    (i < d * 4 ? d_hw_p + (size_t)blk * d * 4 + i
               : d_hb_p + (size_t)blk * 4 + i - d * 4)[0] = dhw[i];
  __syncthreads();

  // ---- the feature-map gradient, gathered into shared memory ---------------
  // The (pass, step, agent) entries are staged in chunks in the shared
  // memory beside the accumulator: their scene cotangents, rounded corner
  // weights and nodes (each node's band in its top byte). Thread (channel
  // c, band) owns the nodes of grid rows y % bands == band (as many bands
  // as the block has threads for, at most 64: the top byte holds a band
  // and a sign). An entry touches two grid rows, so a band hears few of a
  // chunk's entries: the warps first list, band by band, the entries with
  // a corner in the band, in ascending order (a ballot compaction), and an
  // owner then walks only its band's list, entries and corners in order:
  // each (node, channel) sum has one owner and a fixed order.
  const int bands = max(1, min(nth / C, 64));
  float* acc = fp(0);
  int* cnt = reinterpret_cast<int*>(acc + G * G * C);   // (bands), padded
  const int bpad = (bands + 3) & ~3;
  float* sv = reinterpret_cast<float*>(cnt + bpad);     // (chunk, C)
  const int chunk = min(
      65535, (int)((L.total - ((size_t)G * G * C + bpad) * 4)
                   / ((size_t)(C + 8) * 4 + (size_t)bands * 2)));
  float* sw = sv + (size_t)chunk * C;             // (chunk, 4)
  int* sn = reinterpret_cast<int*>(sw + (size_t)chunk * 4);
  unsigned short* lists =                         // (bands, chunk)
      reinterpret_cast<unsigned short*>(sn + (size_t)chunk * 4);
  for (int i = tid_here(); i < G * G * C; i += nth) acc[i] = 0.f;
  const int entries = (R + 1) * T * A;
  for (int i0 = 0; i0 < entries; i0 += chunk) {
    const int ne = min(chunk, entries - i0);
    if (C % 4 == 0 && (reinterpret_cast<uintptr_t>(dsc_ws) & 15) == 0
        && ((G * G * C) & 3) == 0) {  // 16 bytes per access
      const int c4 = C / 4;
      stream_in<8>(
          ne * c4,
          [&](int j) {
            const int i = i0 + j / c4, c = (j % c4) * 4;
            const int p = R - i / (T * A), t = T - 1 - (i / A) % T, a = i % A;
            return __ldcs(reinterpret_cast<const float4*>(
                dsc_ws + ((size_t)p * T + t) * A * C + a * C + c));
          },
          [&](int j, float4 v) {
            *reinterpret_cast<float4*>(sv + 4 * j) = make_float4(
                rnd<CD>(v.x), rnd<CD>(v.y), rnd<CD>(v.z), rnd<CD>(v.w));
          });
    } else {
      stream_in<8>(
          ne * C,
          [&](int j) {
            const int i = i0 + j / C, c = j % C;
            const int p = R - i / (T * A), t = T - 1 - (i / A) % T, a = i % A;
            return __ldcs(dsc_ws + ((size_t)p * T + t) * A * C + a * C + c);
          },
          [&](int j, float v) { sv[j] = rnd<CD>(v); });
    }
    for (int e = tid_here(); e < ne; e += nth) {
      const int i = i0 + e;
      const int p = R - i / (T * A), t = T - 1 - (i / A) % T, a = i % A;
      const float* lev = p == 0 ? traj : iters + (size_t)(p - 1) * plane;
      const size_t o = (row(a) * T + t) * 2;
      const Corners q = corners(lev[o], lev[o + 1], G);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        sw[e * 4 + k4] = rnd<CD>(q.w[k4]);
        sn[e * 4 + k4] = q.n[k4] | (((q.n[k4] / G) % bands) << 24);
      }
    }
    __syncthreads();
    for (int band = tid_here() / 32; band < bands; band += nwarps) {
      unsigned short* list = lists + (size_t)band * chunk;
      int n = 0;
      for (int e0 = 0; e0 < ne; e0 += 32) {
        const int e = e0 + lane;
        bool hit = false;
        if (e < ne) {
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4)
            hit = hit || (sn[e * 4 + k4] >> 24) == band;
        }
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) list[n + __popc(m & ((1u << lane) - 1u))] = (unsigned short)e;
        n += __popc(m);
      }
      if (lane == 0) cnt[band] = n;
    }
    __syncthreads();
    for (int item = tid_here(); item < C * bands; item += nth) {
      const int c = item % C, band = item / C;
      const unsigned short* list = lists + (size_t)band * chunk;
      const int n = cnt[band];
      for (int l = 0; l < n; ++l) {
        const int e = list[l];
        const float v = sv[e * C + c];
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const int nd = sn[e * 4 + k4];
          if ((nd >> 24) == band) {
            float* dst = acc + (nd & 0xFFFFFF) * C + c;
            *dst = fmaf(sw[e * 4 + k4], v, *dst);
          }
        }
      }
    }
    __syncthreads();
  }
  float* dfm = d_fmap_p + (size_t)blk * G * G * C;
  for (int i = tid_here(); i < G * G * C; i += nth) dfm[i] = acc[i];
}

// ---- the weight gradients of the input and hidden matrices (kMma) ----------
// d Wi = sum X^T R[:, :3d] and d Wh = sum hr^T R[:, [r | z | n * r]] over
// every row of the operand log (log_width, log_rows): one long product whose
// depth is the log's rows. Its floor is bytes (the log is read once: 72
// operations a byte at the flagship, where the card's balance is ~295), so
// the kernel is built to stream: a persistent grid of kWgCtas blocks, each
// owning a fixed contiguous slice of the rows, a ring of kWgStages row
// chunks that cp.async keeps in flight, and the products on the tensor
// cores (ldmatrix.trans + mma.sync, float32 accumulation) from the chunk
// that has arrived. A warp owns an item of 3 x 3 output tiles of 16 x 16 for
// the whole slice, in registers; the items of X's columns and of hr's are
// apart, since they pair with different columns of R. Where there are more
// items than warps, gridDim.y rounds of blocks stream the same slice for the
// rest. Each block writes its slice's partial of both matrices, in wi's and
// wh's row order; the wrapper sums the partials in a fixed order:
// deterministic, with no atomics.
constexpr int kWgThreads = 384;
constexpr int kWgStages = 4;
constexpr int kWgCtas = 132;  // H100 SXM's SMs: one block each

struct WgShape {
  int W, ld, ch, xt, ht, nt, xg, ng, items, rounds;
  __host__ __device__ WgShape(int d, int C) {
    W = log_width(d, C);
    ld = mma_stride(W);  // ldmatrix reads 8 rows without bank conflicts
    ch = 64;             // rows a chunk, fewer where the ring would not fit
    while (ch > 16 && (size_t)kWgStages * ch * ld * 2 > kMaxSmem) ch /= 2;
    xt = (C + 2 * d + 16) / 16;  // 16-row output tiles of X's columns
    ht = d / 16;                 // of hr's
    nt = 3 * d / 16;             // 16-column output tiles
    xg = (xt + 2) / 3;
    ng = (nt + 2) / 3;
    items = (xg + (ht + 2) / 3) * ng;
    rounds = (items + kWgThreads / 32 - 1) / (kWgThreads / 32);
  }
  size_t smem() const { return (size_t)kWgStages * ch * ld * 2; }
};

// blocks of the grid's x dimension: kWgCtas, or one per chunk where fewer
__host__ __device__ inline int wg_ctas(long long nrows, int ch) {
  const long long chunks = (nrows + ch - 1) / ch;
  return (int)(chunks < kWgCtas ? chunks : kWgCtas);
}

__global__ void __launch_bounds__(kWgThreads, 1) ioc_bwd_wgrad_kernel(
    const __nv_bfloat16* __restrict__ oplog, long long nrows, int d, int C,
    float* __restrict__ d_wi_p, float* __restrict__ d_wh_p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const WgShape S(d, C);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int r8 = lane % 8, hi = (lane / 8) % 2, top = lane / 16;
  const int d3 = 3 * d, F = 2 + C + 2 * d, lxw = C + 2 * d + 16;
  // this block's slice of chunks
  const long long chunks = (nrows + S.ch - 1) / S.ch;
  const long long c0 = chunks * blockIdx.x / gridDim.x;
  const long long c1 = chunks * (blockIdx.x + 1) / gridDim.x;
  // this warp's item: up to 3 x 3 tiles, rows of X's or of hr's columns
  const int item = blockIdx.y * (kWgThreads / 32) + warp;
  const bool has = item < S.items;
  const int mg = has ? item / S.ng : 0, ngi = has ? item % S.ng : 0;
  const bool is_wi = mg < S.xg;
  const int mt0 = (is_wi ? mg : mg - S.xg) * 3;
  const int mtn = min(3, (is_wi ? S.xt : S.ht) - mt0);
  const int nt0 = ngi * 3, ntn = min(3, S.nt - nt0);
  int acol[3], bcol[3];
#pragma unroll
  for (int m = 0; m < 3; ++m)
    acol[m] = (is_wi ? 0 : lxw) + 16 * (mt0 + min(m, mtn - 1));
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    const int g = 16 * (nt0 + min(n, ntn - 1));
    bcol[n] = lxw + d + (is_wi || g < 2 * d ? g : g + d);
  }
  float acc[3][6][4];
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;

  const int per = S.W / 8;  // 16-byte pieces a row
  auto load = [&](long long c, int stage) {
    const long long r0 = c * S.ch;
    const int n = (int)min((long long)S.ch, nrows - r0);
    __nv_bfloat16* dst = ring + (size_t)stage * S.ch * S.ld;
    const __nv_bfloat16* src = oplog + (size_t)r0 * S.W;
    for (int i = threadIdx.x; i < n * per; i += kWgThreads) {
      const int r = i / per, j = (i % per) * 8;
      cp_async16(dst + r * S.ld + j, src + (size_t)r * S.W + j);
    }
  };
  for (int s_ = 0; s_ < kWgStages - 1; ++s_) {
    if (c0 + s_ < c1) load(c0 + s_, s_);
    cp_async_commit();
  }
  for (long long c = c0; c < c1; ++c) {
    cp_async_wait<kWgStages - 2>();  // chunk c has arrived
    __syncthreads();                 // and chunk c - 1 is read by all warps
    const long long next = c + kWgStages - 1;
    if (next < c1) load(next, (int)((next - c0) % kWgStages));
    cp_async_commit();
    if (!has) continue;
    const __nv_bfloat16* tile =
        ring + (size_t)((c - c0) % kWgStages) * S.ch * S.ld;
    const int ksteps = (int)min((long long)S.ch, nrows - c * S.ch) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      const __nv_bfloat16* t = tile + (size_t)ks * 16 * S.ld;
      uint32_t a[3][4], b[3][4];
#pragma unroll
      for (int m = 0; m < 3; ++m)
        if (m < mtn) ldsm_x4_t(a[m], t + (r8 + top * 8) * S.ld + acol[m]
                                         + hi * 8);
#pragma unroll
      for (int n = 0; n < 3; ++n)
        if (n < ntn) ldsm_x4_t(b[n], t + (r8 + hi * 8) * S.ld + bcol[n]
                                         + top * 8);
#pragma unroll
      for (int m = 0; m < 3; ++m)
#pragma unroll
        for (int n = 0; n < 3; ++n)
          if (m < mtn && n < ntn) {
            mma_bf16(acc[m][2 * n], a[m][0], a[m][1], a[m][2], a[m][3],
                     b[n][0], b[n][1]);
            mma_bf16(acc[m][2 * n + 1], a[m][0], a[m][1], a[m][2], a[m][3],
                     b[n][2], b[n][3]);
          }
    }
  }
  cp_async_wait<0>();
  if (!has) return;
  // the slice's partial: X's column f is wi's row f + 2 ([scene | social |
  // dec] follow vel), its columns F - 2 and F - 1 wi's rows 0 and 1 (vel),
  // its padding columns nothing; hr's column j is wh's row j
  float* const wi = d_wi_p + (size_t)blockIdx.x * F * d3;
  float* const wh = d_wh_p + (size_t)blockIdx.x * d * d3;
  auto out_row = [&](int f) -> float* {
    if (!is_wi) return wh + (size_t)f * d3;
    if (f < F - 2) return wi + (size_t)(f + 2) * d3;
    return f < F ? wi + (size_t)(f - (F - 2)) * d3 : nullptr;
  };
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    if (m >= mtn) continue;
    const int f = 16 * (mt0 + m) + gid;
    float* const lo = out_row(f);
    float* const hi8 = out_row(f + 8);
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (j / 2 >= ntn) continue;
      const int col = 16 * (nt0 + j / 2) + (j % 2) * 8 + tig * 2;
      if (lo)
        *reinterpret_cast<float2*>(lo + col) =
            make_float2(acc[m][j][0], acc[m][j][1]);
      if (hi8)
        *reinterpret_cast<float2*>(hi8 + col) =
            make_float2(acc[m][j][2], acc[m][j][3]);
    }
  }
}

// The product kernel over n rows of the log, after the backward kernel on
// the same stream: per-slice partials into wi_p (wg_ctas, F, 3d) and wh_p
// (wg_ctas, d, 3d).
int launch_wgrad(const __nv_bfloat16* oplog, long long nrows, int d, int C,
                 float* wi_p, float* wh_p, cudaStream_t stream) {
  const WgShape S(d, C);
  if (S.smem() > kMaxSmem) return cudaErrorInvalidValue;
  cudaFuncSetAttribute(ioc_bwd_wgrad_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)S.smem());
  ioc_bwd_wgrad_kernel<<<dim3(wg_ctas(nrows, S.ch), S.rounds), kWgThreads,
                         S.smem(), stream>>>(oplog, nrows, d, C, wi_p, wh_p);
  return (int)cudaGetLastError();
}

template <typename CD, bool kMma, bool kFreeze>
int launch_bwd(const void* const* in, void* const* out, void* ws, int B,
               int A, int K, int T, int d, int G, int C, int R,
               float delta_scale, cudaStream_t stream) {
  const size_t bytes = BwdLayout(A, T, d, C, G, kMma).total;
  // the feature-map gather stages at least one entry beside its
  // accumulator, and keeps a node index in 24 bits
  if (bytes > kMaxSmem
      || bytes < ((size_t)G * G * C + C + 12) * 4 + (size_t)kBwdThreads * 6
      || G * G >= (1 << 24))
    return cudaErrorInvalidValue;
  cudaFuncSetAttribute(ioc_refine_bwd_kernel<CD, kMma, kFreeze>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  using F = const float*;
  using Cp = const CD*;
  float* const* o = reinterpret_cast<float* const*>(out);
  // the blocks' scratch, then (kMma) their operand logs
  float* const scratch = static_cast<float*>(ws);
  __nv_bfloat16* const oplog =
      kMma ? reinterpret_cast<__nv_bfloat16*>(
                 scratch + (size_t)B * K * bwd_ws_words(A, T, d, C, R,
                                                        kFreeze))
           : nullptr;
  ioc_refine_bwd_kernel<CD, kMma, kFreeze>
      <<<B * K, kBwdThreads, bytes, stream>>>(
      F(in[0]), F(in[1]), Cp(in[2]), Cp(in[3]), Cp(in[4]), F(in[5]),
      F(in[6]), Cp(in[7]), Cp(in[8]), Cp(in[9]), Cp(in[10]), Cp(in[11]),
      F(in[12]), F(in[13]), F(in[14]), F(in[15]), F(in[16]), F(in[17]),
      F(in[18]), F(in[19]), F(in[20]), o[0], o[1], o[2], o[3], o[4], o[5],
      o[6], o[7], o[8], o[9], o[10], scratch, oplog, A, K, T, d, G, C, R,
      delta_scale);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || !kMma) return rc;
  return launch_wgrad(oplog, (long long)B * K * log_rows(A, T, R), d, C,
                      o[4], o[5], stream);
}

}  // namespace
}  // namespace desire

// Float32 words of the device-memory workspace for B * K blocks, with the
// operand log where is_bf16 and d, C are multiples of 16 (the tensor-core
// variant, as the launch picks it).
extern "C" long long ioc_refine_bwd_ws_words(int B, int A, int K, int T,
                                             int d, int C, int R,
                                             int social_freeze,
                                             int is_bf16) {
  return (long long)desire::bwd_total_words(
      B, A, K, T, d, C, R, social_freeze, desire::bwd_mma(is_bf16, d, C));
}

// The partials of the input and hidden matrices' gradients that a launch
// writes: with the tensor-core variant one per block of the weight-gradient
// product's grid; 0 otherwise, where every backward block writes its own
// (B * K of them).
extern "C" int ioc_refine_bwd_wgrad_ctas(int B, int A, int K, int T, int d,
                                         int C, int R, int is_bf16) {
  if (!desire::bwd_mma(is_bf16, d, C)) return 0;
  return desire::wg_ctas((long long)B * K * desire::log_rows(A, T, R),
                         desire::WgShape(d, C).ch);
}

// Dynamic shared memory of one block (BwdLayout) at these shapes, with the
// tensor-core variant where is_bf16 and d, C are multiples of 16, as the
// launch picks it; more than kMaxSmem fails the launch.
extern "C" long long ioc_refine_bwd_smem_bytes(int A, int T, int d, int C,
                                               int G, int is_bf16) {
  return (long long)desire::BwdLayout(A, T, d, C, G,
                                     desire::bwd_mma(is_bf16, d, C)).total;
}

// The most agents a lane whose block (BwdLayout) fits in kMaxSmem at these
// widths; 0 where not even one does.
extern "C" int ioc_refine_bwd_max_agents(int T, int d, int C, int G,
                                         int is_bf16) {
  int a = 0;
  while (a < 4096
         && ioc_refine_bwd_smem_bytes(a + 1, T, d, C, G, is_bf16)
                <= (long long)desire::kMaxSmem)
    ++a;
  return a;
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
// soc_logtau (1); with the tensor-core variant wi and wh hold
// ioc_refine_bwd_wgrad_ctas partials instead, which the weight-gradient
// product, launched after the backward kernel on the same stream, writes.
// ws: ioc_refine_bwd_ws_words(..., social_freeze, is_bf16) float32 words.
// CD is bfloat16 when is_bf16, else float32. social_freeze: the social
// block is pooled at the initial positions in every pass. Returns
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
  if (desire::bwd_mma(is_bf16, d, C)) return DESIRE_BWD(__nv_bfloat16, true);
  if (is_bf16) return DESIRE_BWD(__nv_bfloat16, false);
  return DESIRE_BWD(float, false);
#undef DESIRE_BWD
}
