// The fused inference CVAE sampler for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel desire_tpu/ops/sgm_fused.py `_kernel` (reached
// through `sgm_sample_decode_fused`): masked past-GRU encode, conditional
// prior, z = mu_p + sigma_p * eps for K lanes, the latent mask MLP
// (lat -> hid -> side^2 -> d softmax), the decoder seed, and the K-lane GRU
// decode over T steps. Plain PyTorch version and wrapper:
// desire_tpu_torch/ops/sgm_fused.py.
//
// What bounds it on this card: the mask MLP's operations in principle. At
// the flagship shape (N = 3840 agents, K = 20, lat 128, hid 512, side^2
// 1024, d 48) the three MLP products are ~0.11 TFLOP on 76,800 lane rows
// (0.12 ms at the bf16 peak); the encode and the decode are small next to
// them, and the bytes (eps in, hiddens out, ~80 MB) are a few tens of
// microseconds of HBM time. In practice shared-memory traffic and chains
// of waits: the first design (32 rows a block, every weight fragment read
// from L2 by 4-byte loads, float32 activation tiles) spent, by clock64()
// over a block, 48 % in the hid x side^2 product, 27 % in the decode, 8 %
// in the side^2 x d product, 7 % in the first layer; the encode launch was
// 3 % of the time. Staging the weights in shared memory (64 rows a block,
// bf16 tiles) still left each warp reloading both operands for every two
// products: ~137 cycles a k-step against ~35 of arithmetic.
//
// What the design does about it:
// * Two launches. The encode runs once per agent in its own launch and
//   writes hx and the rounded prior (mu_p, sigma_p); CUDA blocks run in no
//   order, so the TPU kernel's "encode at lane-chunk 0 and keep it in
//   scratch" cannot carry over. It stays on the CUDA cores (3 % of the
//   time).
// * In bf16 (lat <= 128, hid <= 512, d <= 64, multiples of 16; the
//   flagship's) the main launch (sgm_sample_tc_kernel) takes kTcRows = 128
//   lane rows a block and gives each warp 16 of them for the whole kernel:
//   z, the hidden layer h1 (32 bf16 A fragments), each reconstruction
//   chunk, the mask logits, the seed and the decoder state live in the
//   warp's registers, in the mma accumulator layout, which is also the A
//   operand's (an m16n8 accumulator pair is an m16k16 A fragment). Shared
//   memory holds only weights, transposed (out, in) and read by ldmatrix:
//   W1 whole, then W2 and the matching columns of Wpv in 32-row chunks
//   through a ring of kStages buffers filled by 16-byte cp.async (chunk i +
//   2 loads while i is multiplied; the four small matrices come with the
//   first chunk), and the biases b1, b2. Each
//   streamed weight byte serves 128 rows, and only the weights cross shared
//   memory. The side^2-wide reconstruction never exists whole: each chunk
//   goes straight into the logits, summed per kChunk columns as before.
//   Per-agent vectors are replicated over the K lanes by indexing (row r
//   reads agent r / K).
// * The element-wise math of that path uses the fast exponential and
//   division (sigmoid_fast, tanh_fast: a few float32 ulp).
// * Otherwise (float32, other widths) sgm_sample_cc_kernel runs the products
//   as tiled loops on the CUDA cores (block_mm), 32 rows a block.
// Numerics match the TPU kernel: operands rounded to the compute dtype,
// float32 accumulation and element-wise math, elu written as exp(x) - 1,
// and hx / mu_p / sigma_p / rho_seed rounded to the compute dtype where
// they are replicated over the lanes (the TPU's selector product rounds
// them the same way).
#include "common.cuh"

namespace desire {
namespace {

constexpr int kEncRows = 8;   // agents per encode block
constexpr int kChunk = 64;    // reconstruction columns per chunk
constexpr int kThreads = 256;
constexpr int kCcRows = 32;   // lane rows per CUDA-core sampler block
constexpr int kTcRows = 128;  // lane rows per tensor-core sampler block
constexpr int kW2Rows = 32;   // reconstruction matrix rows per ring chunk
constexpr int kStages = 3;    // ring chunks in flight or in use
constexpr int kMaxLat = 128;  // widest latent of the tensor-core path
constexpr int kMaxHid = 512;  // widest mask-MLP hidden layer of that path

__device__ __forceinline__ float gru_out(float gi_r, float gi_z, float gi_n,
                                         float gh_r, float gh_z, float gh_n,
                                         float h) {
  const float r = sigmoid(gi_r + gh_r);
  const float z = sigmoid(gi_z + gh_z);
  const float n = tanhf(gi_n + r * gh_n);
  return (1.f - z) * n + z * h;
}

// One block encodes kEncRows agents: masked GRU over `to` steps, then the
// prior head. Writes hx (n, d) and musig (n, 2 lat) = [round(mu_p) |
// round(sigma_p)].
template <typename CD>
__global__ void __launch_bounds__(kThreads)
    sgm_encode_kernel(const CD* __restrict__ feats,
                      const float* __restrict__ mask,
                      const CD* __restrict__ ewi, const CD* __restrict__ ewh,
                      const float* __restrict__ ebi,
                      const float* __restrict__ ebh,
                      const CD* __restrict__ prw,
                      const float* __restrict__ prb, float* __restrict__ hx,
                      float* __restrict__ musig, int n, int to, int emb,
                      int d, int lat) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d3 = 3 * d;
  Bump bump;
  float* f_s = reinterpret_cast<float*>(smem + bump.take(kEncRows * emb * 4));
  float* h_s = reinterpret_cast<float*>(smem + bump.take(kEncRows * d * 4));
  float* hr_s = reinterpret_cast<float*>(smem + bump.take(kEncRows * d * 4));
  float* gi_s = reinterpret_cast<float*>(smem + bump.take(kEncRows * d3 * 4));
  float* gh_s = reinterpret_cast<float*>(smem + bump.take(kEncRows * d3 * 4));
  const int row0 = blockIdx.x * kEncRows;

  for (int i = threadIdx.x; i < kEncRows * d; i += blockDim.x) {
    h_s[i] = 0.f;
    hr_s[i] = 0.f;
  }
  for (int t = 0; t < to; ++t) {
    for (int i = threadIdx.x; i < kEncRows * emb; i += blockDim.x) {
      const int row = row0 + i / emb;
      f_s[i] = row < n ? to_f(feats[((size_t)row * to + t) * emb + i % emb])
                       : 0.f;
    }
    __syncthreads();
    block_mm<kEncRows>(f_s, emb, kEncRows, emb, ewi, d3, d3,
                       [&](int r, int c, float acc) {
                         gi_s[r * d3 + c] = acc + ebi[c];
                       });
    block_mm<kEncRows>(hr_s, d, kEncRows, d, ewh, d3, d3,
                       [&](int r, int c, float acc) {
                         gh_s[r * d3 + c] = acc + ebh[c];
                       });
    __syncthreads();
    for (int i = threadIdx.x; i < kEncRows * d; i += blockDim.x) {
      const int r = i / d, j = i % d, row = row0 + r;
      const float* gi = gi_s + r * d3;
      const float* gh = gh_s + r * d3;
      const float h = h_s[i];
      const float hn = gru_out(gi[j], gi[d + j], gi[2 * d + j], gh[j],
                               gh[d + j], gh[2 * d + j], h);
      // masked steps carry the state
      const bool on = row < n && mask[(size_t)row * to + t] > 0.f;
      const float hv = on ? hn : h;
      h_s[i] = hv;
      hr_s[i] = rnd<CD>(hv);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < kEncRows * d; i += blockDim.x) {
    const int row = row0 + i / d;
    if (row < n) hx[(size_t)row * d + i % d] = h_s[i];
  }
  // prior p(z | X): zero weights give N(0, I)
  block_mm<kEncRows>(hr_s, d, kEncRows, d, prw, 2 * lat, 2 * lat,
                     [&](int r, int c, float acc) {
                       const int row = row0 + r;
                       if (row >= n) return;
                       const float v = acc + prb[c];
                       float out;
                       if (c < lat) {
                         out = v;
                       } else {
                         const float logvar = 4.f * tanhf(v / 4.f);
                         out = expf(0.5f * logvar);
                       }
                       musig[(size_t)row * 2 * lat + c] = rnd<CD>(out);
                     });
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16): kTcRows lane rows a block, 16 a warp, every
// activation in registers; shared memory holds only weights.

// Shared memory: the biases b1 and b2 (float32), then the weights, all
// transposed, (out, in), rows of mma_stride() elements: first the first
// layer's matrix whole (W1^T, (hid, lat)); once h1 is made, over it, a ring
// of kStages chunks of the reconstruction matrix (32 rows of W2^T, (side2,
// hid)) with the matching 32 columns of Wpv^T ((d, side2)), and after the
// ring the four small matrices (Wzg^T, Wzs^T (d, lat), Wdi^T, Wdh^T (3d,
// d)), which load with the first chunk. Weight offsets in elements from w0.
struct TcLayout {
  int lz, lh, ld, lp;
  size_t w0, stage, zg, zs, di, dh, total;
  __host__ __device__ TcLayout(int d, int lat, int hid, int side2) {
    lz = mma_stride(lat);
    lh = mma_stride(hid);
    ld = mma_stride(d);
    lp = mma_stride(kW2Rows);
    w0 = ((size_t)(hid + side2) * 4 + 15) & ~size_t(15);
    stage = (size_t)kW2Rows * lh + (size_t)d * lp;
    zg = kStages * stage;
    zs = zg + (size_t)d * lz;
    di = zs + (size_t)d * lz;
    dh = di + (size_t)3 * d * ld;
    size_t n = dh + (size_t)3 * d * ld;
    if ((size_t)hid * lz > n) n = (size_t)hid * lz;
    total = w0 + n * 2;
  }
};

// rows [r0, r0 + nr) of a dense (N, K) bf16 matrix into rows of stride ldw
// in shared memory, 16-byte cp.async pieces (no commit)
__device__ __forceinline__ void copy_rows_async(__nv_bfloat16* dst, int ldw,
                                                const __nv_bfloat16* src,
                                                int K, int r0, int nr) {
  const int pieces = K / 8;
  for (int i = threadIdx.x; i < nr * pieces; i += blockDim.x) {
    const int r = i / pieces, q = i - r * pieces;
    cp_async16(dst + r * ldw + q * 8, src + (size_t)(r0 + r) * K + q * 8);
  }
}

// acc[2 j], acc[2 j + 1] += A (16 x 16 ks, as bf16 fragments) times the
// 16-column tile j of a weight matrix stored [n][k] in shared memory
// (stride ldw), for the column tiles j < NP starting at row n0
template <int NP, int KS>
__device__ __forceinline__ void warp_mma_regs(const uint32_t (&a)[KS][4],
                                              int ksteps,
                                              const __nv_bfloat16* W, int ldw,
                                              int n0, float (&acc)[2 * NP][4]) {
  const int lane = threadIdx.x & 31;
  const int r8 = lane & 7, hi = (lane >> 3) & 1, top = lane >> 4;
  const __nv_bfloat16* w = W + (n0 + r8 + top * 8) * ldw + hi * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks >= ksteps) break;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      uint32_t b[4];
      ldmatrix_x4(b, w + j * 16 * ldw + ks * 16);
      mma_bf16(acc[2 * j], a[ks][0], a[ks][1], a[ks][2], a[ks][3], b[0], b[1]);
      mma_bf16(acc[2 * j + 1], a[ks][0], a[ks][1], a[ks][2], a[ks][3], b[2],
               b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

template <int ND>
__global__ void __launch_bounds__(kThreads, 1) sgm_sample_tc_kernel(
    const float* __restrict__ hx, const float* __restrict__ musig,
    const float* __restrict__ rho, const __nv_bfloat16* __restrict__ eps,
    const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    const __nv_bfloat16* __restrict__ pvw, const float* __restrict__ pvb,
    const __nv_bfloat16* __restrict__ zgw, const float* __restrict__ zgb,
    const __nv_bfloat16* __restrict__ zsw, const float* __restrict__ zsb,
    const __nv_bfloat16* __restrict__ dwi,
    const __nv_bfloat16* __restrict__ dwh, const float* __restrict__ dbi,
    const float* __restrict__ dbh, float* __restrict__ dec_h, int n, int k,
    int lat, int hid, int side2, int t_len) {
  using bf = __nv_bfloat16;
  constexpr int d = ND * 16, d3 = 3 * d;
  constexpr int LK = kMaxLat / 16, HK = kMaxHid / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout L(d, lat, hid, side2);
  const float* b1s = reinterpret_cast<const float*>(smem);
  const float* b2s = b1s + hid;
  bf* sm = reinterpret_cast<bf*>(smem + L.w0);
  const int rows = n * k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int lk = lat / 16, hk = hid / 16;
  // this thread's rows of the warp's 16 (the accumulator layout's gid and
  // gid + 8) and their agents
  const int ra = blockIdx.x * kTcRows + warp * 16 + gid, rb = ra + 8;
  const bool va = ra < rows, vb = rb < rows;

  // the biases and the first layer's matrix, whole; z meanwhile
  for (int i = threadIdx.x; i < hid / 4; i += blockDim.x)
    cp_async16(smem + 16 * i, b1 + 4 * i);
  for (int i = threadIdx.x; i < side2 / 4; i += blockDim.x)
    cp_async16(smem + 4 * hid + 16 * i, b2 + 4 * i);
  copy_rows_async(sm, L.lz, w1, lat, 0, hid);
  cp_async_commit();
  // z = mu_p + sigma_p * eps as bf16 A fragments, replicated by index;
  // made again after the reconstruction rather than kept in registers
  uint32_t za[LK][4];
  auto make_z = [&]() {
#pragma unroll
    for (int ks = 0; ks < LK; ++ks) {
      if (ks >= lk) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = (q & 1) ? rb : ra;
        const bool ok = (q & 1) ? vb : va;
        const int c = ks * 16 + (q >> 1) * 8 + tig * 2;
        float2 zv = make_float2(0.f, 0.f);
        if (ok) {
          const float* ms = musig + (size_t)(row / k) * 2 * lat;
          const float2 e = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(
              eps + (size_t)row * lat + c));
          zv = make_float2(ms[c] + ms[lat + c] * e.x,
                           ms[c + 1] + ms[lat + c + 1] * e.y);
        }
        za[ks][q] = pack_bf16(zv);
      }
    }
  };
  make_z();
  cp_async_wait<0>();
  __syncthreads();
  // h1 = elu(z W1 + b1), rounded to bf16, kept as the A fragments of the
  // reconstruction product: k-step j is h1's columns 16 j .. 16 j + 15
  uint32_t h1[HK][4];
#pragma unroll
  for (int j = 0; j < HK; ++j) {
    if (j >= hk) break;
    float acc[2][4];
    zero_acc(acc);
    warp_mma_regs<1>(za, lk, sm, L.lz, j * 16, acc);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = acc[t][e] + b1s[j * 16 + t * 8 + tig * 2 + (e & 1)];
        acc[t][e] = v > 0.f ? v : __expf(v) - 1.f;
      }
    acc_to_a(acc[0], acc[1], h1[j]);
  }
  __syncthreads();

  // recon = sigmoid(h1 W2 + b2) in kW2Rows-column chunks streamed through
  // the ring; each chunk's recon goes at once, as A fragments, into the
  // mask logits: part += recon[:, chunk] Wpv[chunk, :], added to lg every
  // kChunk columns
  float lg[2 * ND][4], part[2 * ND][4];
  zero_acc(lg);
  zero_acc(part);
  const int nchunks = side2 / kW2Rows;
  auto stage = [&](int ci) {
    if (ci == 0) {
      // the four small matrices, after the ring
      copy_rows_async(sm + L.zg, L.lz, zgw, lat, 0, d);
      copy_rows_async(sm + L.zs, L.lz, zsw, lat, 0, d);
      copy_rows_async(sm + L.di, L.ld, dwi, d, 0, d3);
      copy_rows_async(sm + L.dh, L.ld, dwh, d, 0, d3);
    }
    if (ci < nchunks) {
      bf* dst = sm + (ci % kStages) * L.stage;
      copy_rows_async(dst, L.lh, w2, hid, ci * kW2Rows, kW2Rows);
      // the chunk's Wpv^T columns: d rows of kW2Rows elements
      const int pieces = kW2Rows / 8;
      for (int i = threadIdx.x; i < d * pieces; i += blockDim.x) {
        const int r = i / pieces, q = i - r * pieces;
        cp_async16(dst + (size_t)kW2Rows * L.lh + r * L.lp + q * 8,
                   pvw + (size_t)r * side2 + ci * kW2Rows + q * 8);
      }
    }
    cp_async_commit();
  };
  for (int ci = 0; ci < kStages - 1; ++ci) stage(ci);
  for (int ci = 0; ci < nchunks; ++ci) {
    stage(ci + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const bf* W = sm + (ci % kStages) * L.stage;
    float rc[kW2Rows / 8][4];
    zero_acc(rc);
    warp_mma_regs<kW2Rows / 16>(h1, hk, W, L.lh, 0, rc);
    uint32_t ra_[kW2Rows / 16][4];
#pragma unroll
    for (int j = 0; j < kW2Rows / 16; ++j) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rc[2 * j + t][e] = sigmoid_fast(
              rc[2 * j + t][e]
              + b2s[ci * kW2Rows + j * 16 + t * 8 + tig * 2 + (e & 1)]);
      acc_to_a(rc[2 * j], rc[2 * j + 1], ra_[j]);
    }
    warp_mma_regs<ND>(ra_, kW2Rows / 16, W + (size_t)kW2Rows * L.lh, L.lp, 0,
                      part);
    if (((ci + 1) * kW2Rows) % kChunk == 0) {
#pragma unroll
      for (int j = 0; j < 2 * ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lg[j][e] += part[j][e];
          part[j][e] = 0.f;
        }
    }
    __syncthreads();
  }

  make_z();
  // logits = (recon Wpv + bpv) + z Wzg + bzg; beta = softmax(logits) * d
  // over a row's d columns, which 4 lanes hold
  {
    float acc[2 * ND][4];
    zero_acc(acc);
    warp_mma_regs<ND>(za, lk, sm + L.zg, L.lz, 0, acc);
    float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + tig * 2 + (e & 1);
        lg[j][e] = (lg[j][e] + pvb[c]) + acc[j][e] + zgb[c];
        if (e < 2)
          mxa = fmaxf(mxa, lg[j][e]);
        else
          mxb = fmaxf(mxb, lg[j][e]);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, o));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, o));
    }
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lg[j][e] = __expf(lg[j][e] - (e < 2 ? mxa : mxb));
        if (e < 2)
          sa += lg[j][e];
        else
          sb += lg[j][e];
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, o);
      sb += __shfl_xor_sync(0xffffffffu, sb, o);
    }
#pragma unroll
    for (int j = 0; j < 2 * ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        lg[j][e] = lg[j][e] / (e < 2 ? sa : sb) * float(d);
  }
  // seed = beta * hx + (z Wzs + bzs) + rho_seed, with hx and rho_seed
  // replicated by index and rounded to bf16; h0 = hx
  float h[2 * ND][4];
  uint32_t seed[ND][4];
  {
    float acc[2 * ND][4];
    zero_acc(acc);
    warp_mma_regs<ND>(za, lk, sm + L.zs, L.lz, 0, acc);
#pragma unroll
    for (int j = 0; j < 2 * ND; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = hh ? rb : ra;
        const bool ok = hh ? vb : va;
        const int c = j * 8 + tig * 2;
        const size_t ag = (size_t)(row / k) * d + c;
        const float2 hv = ok ? *reinterpret_cast<const float2*>(hx + ag)
                             : make_float2(0.f, 0.f);
        const float2 rv = ok ? *reinterpret_cast<const float2*>(rho + ag)
                             : make_float2(0.f, 0.f);
        const float hr[2] = {rnd<bf>(hv.x), rnd<bf>(hv.y)};
        const float rr[2] = {rnd<bf>(rv.x), rnd<bf>(rv.y)};
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int e = 2 * hh + p;
          acc[j][e] = lg[j][e] * hr[p] + acc[j][e] + zsb[c + p] + rr[p];
          h[j][e] = hr[p];
        }
      }
#pragma unroll
    for (int ks = 0; ks < ND; ++ks) acc_to_a(acc[2 * ks], acc[2 * ks + 1],
                                             seed[ks]);
  }
  // K-lane decode: constant input gates gi = seed Wdi + bdi, h0 = hx; the
  // state stays in registers (rounded to bf16 as the hidden product's A)
  float gi[3][2 * ND][4];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    zero_acc(gi[q]);
    warp_mma_regs<ND>(seed, ND, sm + L.di, L.ld, q * d, gi[q]);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int j = 0; j < 2 * ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gi[q][j][e] += dbi[q * d + j * 8 + tig * 2 + (e & 1)];
  float cbh[3][2 * ND][2];  // the hidden gates' biases of this thread's columns
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int j = 0; j < 2 * ND; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        cbh[q][j][p] = dbh[q * d + j * 8 + tig * 2 + p];
  for (int t = 0; t < t_len; ++t) {
    uint32_t ha[ND][4];
#pragma unroll
    for (int ks = 0; ks < ND; ++ks) acc_to_a(h[2 * ks], h[2 * ks + 1], ha[ks]);
    float gh[3][2 * ND][4];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      zero_acc(gh[q]);
      warp_mma_regs<ND>(ha, ND, sm + L.dh, L.ld, q * d, gh[q]);
    }
#pragma unroll
    for (int j = 0; j < 2 * ND; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = e & 1;
        const float r =
            sigmoid_fast(gi[0][j][e] + (gh[0][j][e] + cbh[0][j][p]));
        const float z =
            sigmoid_fast(gi[1][j][e] + (gh[1][j][e] + cbh[1][j][p]));
        const float nn = tanh_fast(gi[2][j][e]
                                   + r * (gh[2][j][e] + cbh[2][j][p]));
        h[j][e] = (1.f - z) * nn + z * h[j][e];
      }
      const int c = j * 8 + tig * 2;
      if (va)
        *reinterpret_cast<float2*>(dec_h + ((size_t)ra * t_len + t) * d + c) =
            make_float2(h[j][0], h[j][1]);
      if (vb)
        *reinterpret_cast<float2*>(dec_h + ((size_t)rb * t_len + t) * d + c) =
            make_float2(h[j][2], h[j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core path (float32, or bf16 at other widths): kCcRows lane rows a
// block, float32 tiles, weights row-major (in, out) from device memory.

struct CcLayout {
  size_t z, big, rc, lg, hxr, rho, seed, total;
  __host__ __device__ CcLayout(int d, int lat, int hid) {
    const int dec_cols = 8 * d;  // gi, gh (3d each), h, rounded h
    Bump b;
    z = b.take((size_t)kCcRows * lat * 4);
    big = b.take((size_t)kCcRows * (hid > dec_cols ? hid : dec_cols) * 4);
    rc = b.take((size_t)kCcRows * kChunk * 4);
    lg = b.take((size_t)kCcRows * d * 4);
    hxr = b.take((size_t)kCcRows * d * 4);
    rho = b.take((size_t)kCcRows * d * 4);
    seed = b.take((size_t)kCcRows * d * 4);
    total = b.off;
  }
};

// One block takes kCcRows consecutive lane rows (row = agent * K + lane):
// z, mask MLP, seed, and the T-step decode. Writes dec_h (n*K, T, d).
template <typename CD>
__global__ void __launch_bounds__(kThreads) sgm_sample_cc_kernel(
    const float* __restrict__ hx, const float* __restrict__ musig,
    const float* __restrict__ rho, const CD* __restrict__ eps,
    const CD* __restrict__ w1, const float* __restrict__ b1,
    const CD* __restrict__ w2, const float* __restrict__ b2,
    const CD* __restrict__ pvw, const float* __restrict__ pvb,
    const CD* __restrict__ zgw, const float* __restrict__ zgb,
    const CD* __restrict__ zsw, const float* __restrict__ zsb,
    const CD* __restrict__ dwi, const CD* __restrict__ dwh,
    const float* __restrict__ dbi, const float* __restrict__ dbh,
    float* __restrict__ dec_h, int n, int k, int d, int lat, int hid,
    int side2, int t_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const CcLayout L(d, lat, hid);
  float* z_s = reinterpret_cast<float*>(smem + L.z);
  float* h1_s = reinterpret_cast<float*>(smem + L.big);
  float* rc_s = reinterpret_cast<float*>(smem + L.rc);
  float* lg_s = reinterpret_cast<float*>(smem + L.lg);
  float* hxr_s = reinterpret_cast<float*>(smem + L.hxr);
  float* rho_s = reinterpret_cast<float*>(smem + L.rho);
  float* seed_s = reinterpret_cast<float*>(smem + L.seed);
  const int d3 = 3 * d;
  const int rows = n * k;
  const int row0 = blockIdx.x * kCcRows;

  // z = mu_p + sigma_p * eps, and the agent vectors, replicated by index
  for (int i = threadIdx.x; i < kCcRows * lat; i += blockDim.x) {
    const int r = i / lat, j = i % lat, row = row0 + r;
    float z = 0.f;
    if (row < rows) {
      const float* ms = musig + (size_t)(row / k) * 2 * lat;
      z = ms[j] + ms[lat + j] * to_f(eps[(size_t)row * lat + j]);
    }
    z_s[i] = rnd<CD>(z);
  }
  for (int i = threadIdx.x; i < kCcRows * d; i += blockDim.x) {
    const int row = row0 + i / d, j = i % d;
    const bool on = row < rows;
    hxr_s[i] = on ? rnd<CD>(hx[(size_t)(row / k) * d + j]) : 0.f;
    rho_s[i] = on ? rnd<CD>(rho[(size_t)(row / k) * d + j]) : 0.f;
    lg_s[i] = 0.f;
  }
  __syncthreads();

  // h1 = elu(z W1 + b1)
  block_mm<16>(z_s, lat, kCcRows, lat, w1, hid, hid,
               [&](int r, int c, float acc) {
                 const float v = acc + b1[c];
                 h1_s[r * hid + c] = rnd<CD>(v > 0.f ? v : expf(v) - 1.f);
               });
  __syncthreads();

  // recon = sigmoid(h1 W2 + b2), streamed in column chunks into the
  // logits: lg += recon[:, chunk] Wpv[chunk, :]
  for (int c0 = 0; c0 < side2; c0 += kChunk) {
    const int nc = side2 - c0 < kChunk ? side2 - c0 : kChunk;
    block_mm<8>(h1_s, hid, kCcRows, hid, w2 + c0, side2, nc,
                [&](int r, int c, float acc) {
                  rc_s[r * kChunk + c] = rnd<CD>(sigmoid(acc + b2[c0 + c]));
                });
    __syncthreads();
    block_mm<4>(rc_s, kChunk, kCcRows, nc, pvw + (size_t)c0 * d, d, d,
                [&](int r, int c, float acc) { lg_s[r * d + c] += acc; });
    __syncthreads();
  }
  // logits = (recon Wpv + bpv) + z Wzg + bzg
  block_mm<4>(z_s, lat, kCcRows, lat, zgw, d, d,
              [&](int r, int c, float acc) {
                lg_s[r * d + c] = (lg_s[r * d + c] + pvb[c]) + acc + zgb[c];
              });
  __syncthreads();
  // beta = softmax(logits) * d, one warp per row
  {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < kCcRows; r += blockDim.x / 32) {
      float* lg = lg_s + r * d;
      float mx = -INFINITY;
      for (int j = lane; j < d; j += 32) mx = fmaxf(mx, lg[j]);
      mx = warp_max(mx);
      float s = 0.f;
      for (int j = lane; j < d; j += 32) s += expf(lg[j] - mx);
      s = warp_sum(s);
      __syncwarp();
      for (int j = lane; j < d; j += 32)
        lg[j] = expf(lg[j] - mx) / s * float(d);
    }
  }
  __syncthreads();
  // seed = beta * hx + (z Wzs + bzs) + rho_seed
  block_mm<4>(z_s, lat, kCcRows, lat, zsw, d, d,
              [&](int r, int c, float acc) {
                const int i = r * d + c;
                seed_s[i] = rnd<CD>(lg_s[i] * hxr_s[i] + acc + zsb[c]
                                    + rho_s[i]);
              });
  __syncthreads();

  // K-lane decode: constant input gates, h0 = hx; h1_s is free now
  float* gi_s = h1_s;
  float* gh_s = gi_s + kCcRows * d3;
  float* h_s = gh_s + kCcRows * d3;
  float* hr_s = h_s + kCcRows * d;
  block_mm<4>(seed_s, d, kCcRows, d, dwi, d3, d3,
              [&](int r, int c, float acc) {
                gi_s[r * d3 + c] = acc + dbi[c];
              });
  for (int i = threadIdx.x; i < kCcRows * d; i += blockDim.x) {
    h_s[i] = hxr_s[i];
    hr_s[i] = hxr_s[i];
  }
  __syncthreads();
  for (int t = 0; t < t_len; ++t) {
    block_mm<4>(hr_s, d, kCcRows, d, dwh, d3, d3,
                [&](int r, int c, float acc) {
                  gh_s[r * d3 + c] = acc + dbh[c];
                });
    __syncthreads();
    for (int i = threadIdx.x; i < kCcRows * d; i += blockDim.x) {
      const int r = i / d, j = i % d, row = row0 + r;
      const float* gi = gi_s + r * d3;
      const float* gh = gh_s + r * d3;
      const float h = gru_out(gi[j], gi[d + j], gi[2 * d + j], gh[j],
                              gh[d + j], gh[2 * d + j], h_s[i]);
      h_s[i] = h;
      hr_s[i] = rnd<CD>(h);
      if (row < rows) dec_h[((size_t)row * t_len + t) * d + j] = h;
    }
    __syncthreads();
  }
}

struct Args {
  const void *feats, *mask, *rho, *eps, *ewi, *ewh, *ebi, *ebh, *prw, *prb,
      *w1, *b1, *w2, *b2, *pvw, *pvb, *zgw, *zgb, *zsw, *zsb, *dwi, *dwh,
      *dbi, *dbh;
  void *musig, *dec_h, *hx;
  int n, to, emb, d, lat, hid, side2, k, t_len;
  cudaStream_t stream;
};

template <typename CD>
int launch_encode(const Args& g) {
  using F = const float*;
  using C = const CD*;
  Bump eb;
  eb.take((size_t)kEncRows * g.emb * 4);
  eb.take((size_t)kEncRows * g.d * 4);
  eb.take((size_t)kEncRows * g.d * 4);
  eb.take((size_t)kEncRows * 3 * g.d * 4);
  eb.take((size_t)kEncRows * 3 * g.d * 4);
  if (eb.off > kMaxSmem) return cudaErrorInvalidValue;
  cudaFuncSetAttribute(sgm_encode_kernel<CD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)eb.off);
  const int blocks = (g.n + kEncRows - 1) / kEncRows;
  sgm_encode_kernel<CD><<<blocks, kThreads, eb.off, g.stream>>>(
      C(g.feats), F(g.mask), C(g.ewi), C(g.ewh), F(g.ebi), F(g.ebh),
      C(g.prw), F(g.prb), (float*)g.hx, (float*)g.musig, g.n, g.to, g.emb,
      g.d, g.lat);
  return (int)cudaGetLastError();
}

template <int ND>
int launch_tc(const Args& g) {
  using F = const float*;
  using C = const __nv_bfloat16*;
  const TcLayout L(g.d, g.lat, g.hid, g.side2);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  if (int rc = launch_encode<__nv_bfloat16>(g)) return rc;
  cudaFuncSetAttribute(sgm_sample_tc_kernel<ND>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L.total);
  const int blocks = (g.n * g.k + kTcRows - 1) / kTcRows;
  sgm_sample_tc_kernel<ND><<<blocks, kThreads, L.total, g.stream>>>(
      F(g.hx), F(g.musig), F(g.rho), C(g.eps), C(g.w1), F(g.b1), C(g.w2),
      F(g.b2), C(g.pvw), F(g.pvb), C(g.zgw), F(g.zgb), C(g.zsw), F(g.zsb),
      C(g.dwi), C(g.dwh), F(g.dbi), F(g.dbh), (float*)g.dec_h, g.n, g.k,
      g.lat, g.hid, g.side2, g.t_len);
  return (int)cudaGetLastError();
}

template <typename CD>
int launch_cc(const Args& g) {
  using F = const float*;
  using C = const CD*;
  const CcLayout L(g.d, g.lat, g.hid);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  if (int rc = launch_encode<CD>(g)) return rc;
  cudaFuncSetAttribute(sgm_sample_cc_kernel<CD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L.total);
  const int blocks = (g.n * g.k + kCcRows - 1) / kCcRows;
  sgm_sample_cc_kernel<CD><<<blocks, kThreads, L.total, g.stream>>>(
      F(g.hx), F(g.musig), F(g.rho), C(g.eps), C(g.w1), F(g.b1), C(g.w2),
      F(g.b2), C(g.pvw), F(g.pvb), C(g.zgw), F(g.zgb), C(g.zsw), F(g.zsb),
      C(g.dwi), C(g.dwh), F(g.dbi), F(g.dbh), (float*)g.dec_h, g.n, g.k, g.d,
      g.lat, g.hid, g.side2, g.t_len);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace desire

// is_bf16 selects the compute dtype of the weights, feats and eps (bf16,
// else float32); biases are float32. use_mma (bf16 only; lat and hid
// multiples of 16 up to 128 and 512, d a multiple of 16 up to 64, side2 a
// multiple of 64) runs the sampler's products on the tensor cores and then
// takes the sampler matrices w1, w2, pvw, zgw, zsw, dwi, dwh TRANSPOSED,
// (out, in); otherwise all weights are row-major (in, out). The encoder
// weights ewi, ewh, prw are row-major always. feats (n, to, emb), eps (n,
// k, lat); mask (n, to), rho (n, d) float32. musig (n, 2 lat) is scratch;
// outputs dec_h (n, k, t_len, d) and hx (n, d) float32. Returns
// cudaGetLastError().
extern "C" int sgm_sample_launch(
    int is_bf16, int use_mma, const void* feats, const void* mask,
    const void* rho, const void* eps, const void* ewi, const void* ewh,
    const void* ebi, const void* ebh, const void* prw, const void* prb,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* pvw, const void* pvb, const void* zgw, const void* zgb,
    const void* zsw, const void* zsb, const void* dwi, const void* dwh,
    const void* dbi, const void* dbh, void* musig, void* dec_h, void* hx,
    int n, int to, int emb, int d, int lat, int hid, int side2, int k,
    int t_len, void* stream) {
  const desire::Args g{feats, mask, rho, eps, ewi, ewh, ebi, ebh, prw, prb,
                       w1, b1, w2, b2, pvw, pvb, zgw, zgb, zsw, zsb, dwi,
                       dwh, dbi, dbh, musig, dec_h, hx, n, to, emb, d, lat,
                       hid, side2, k, t_len,
                       static_cast<cudaStream_t>(stream)};
  if (use_mma) {
    if (!is_bf16 || lat % 16 || lat > desire::kMaxLat || hid % 16
        || hid > desire::kMaxHid || side2 % desire::kChunk)
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
