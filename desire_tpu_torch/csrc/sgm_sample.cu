// The fused inference CVAE sampler for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel desire_tpu/ops/sgm_fused.py `_kernel` (reached
// through `sgm_sample_decode_fused`): masked past-GRU encode, conditional
// prior, z = mu_p + sigma_p * eps for K lanes, the latent mask MLP
// (lat -> hid -> side^2 -> d softmax), the decoder seed, and the K-lane GRU
// decode over T steps. Plain PyTorch version and wrapper:
// desire_tpu_torch/ops/sgm_fused.py.
//
// What bounds it on this card: the mask MLP's operations. At the flagship
// shape (N = 3840 agents, K = 20, lat 128, hid 512, side^2 1024, d 48) the
// three MLP products are ~0.11 TFLOP on 76,800 lane rows; the encode and
// the decode are small next to them, and the bytes (eps in, hiddens out,
// ~80 MB) are a few tens of microseconds of HBM time.
//
// What the design does about it:
// * Two launches. The encode runs once per agent in its own launch and
//   writes hx and the rounded prior (mu_p, sigma_p); CUDA blocks run in no
//   order, so the TPU kernel's "encode at lane-chunk 0 and keep it in
//   scratch" cannot carry over.
// * The main launch takes kRows = 32 lane rows per block. The lat x hid
//   activation stays in shared memory; the side^2-wide reconstruction is
//   streamed in kChunk-column chunks whose contribution to the (rows, d)
//   mask logits is accumulated at once, so no (rows, 1024) tile exists.
//   Per-agent vectors are replicated over the K lanes by indexing
//   (row r reads agent r / K), not by a selector product.
// * In bf16 at widths that are multiples of 16 (the flagship's), every
//   product of the main launch runs on the tensor cores (mma.sync
//   m16n8k16, common.cuh block_mma): activations come from shared memory,
//   weight fragments straight from L2, each reused for both 16-row tiles of
//   the block. Otherwise (float32, odd widths) the products are tiled loops
//   on the CUDA cores (block_mm). Both accumulate in float32.
// Numerics match the TPU kernel: operands rounded to the compute dtype,
// float32 accumulation and element-wise math, elu written as exp(x) - 1,
// and hx / mu_p / sigma_p / rho_seed rounded to the compute dtype where
// they are replicated over the lanes (the TPU's selector product rounds
// them the same way).
#include "common.cuh"

namespace desire {
namespace {

constexpr int kEncRows = 8;   // agents per encode block
constexpr int kRows = 32;     // lane rows per sampler block
constexpr int kChunk = 64;    // reconstruction columns per chunk
constexpr int kThreads = 256;

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

struct SampleLayout {
  // row strides (floats) of the buffers that are product operands
  int lz, lh1, lrc, ld;
  size_t z, big, rc, lg, hxr, rho, seed, total;
  __host__ __device__ SampleLayout(int d, int lat, int hid) {
    lz = mma_stride(lat);
    lh1 = mma_stride(hid);
    lrc = mma_stride(kChunk);
    ld = mma_stride(d);
    const int dec_cols = 7 * d + ld;  // gi, gh (3d each), h, rounded h
    Bump b;
    z = b.take((size_t)kRows * lz * 4);
    big = b.take((size_t)kRows * (lh1 > dec_cols ? lh1 : dec_cols) * 4);
    rc = b.take((size_t)kRows * lrc * 4);
    lg = b.take((size_t)kRows * d * 4);
    hxr = b.take((size_t)kRows * d * 4);
    rho = b.take((size_t)kRows * d * 4);
    seed = b.take((size_t)kRows * ld * 4);
    total = b.off;
  }
};

// A block-wide product over the kRows rows of a sampler block: on the
// tensor cores (weights transposed, see block_mma) or on the CUDA cores
// (weights row-major, see block_mm).
template <bool kMma, int RG, typename CD, typename Epi>
__device__ __forceinline__ void product(const float* A, int lda, int kdim,
                                        const CD* W, int ldw, int ncols,
                                        Epi epi) {
  if constexpr (kMma)
    block_mma<kRows / 16>(A, lda, kRows / 16, kdim, W, ldw, ncols, epi);
  else
    block_mm<RG>(A, lda, kRows, kdim, W, ldw, ncols, epi);
}

// One block takes kRows consecutive lane rows (row = agent * K + lane):
// z, mask MLP, seed, and the T-step decode. Writes dec_h (n*K, T, d).
// With kMma the weight matrices arrive transposed ((out, in), bf16) and the
// products run on the tensor cores; otherwise they are row-major (in, out).
template <typename CD, bool kMma>
__global__ void __launch_bounds__(kThreads) sgm_sample_kernel(
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
  const SampleLayout L(d, lat, hid);
  float* z_s = reinterpret_cast<float*>(smem + L.z);
  float* h1_s = reinterpret_cast<float*>(smem + L.big);
  float* rc_s = reinterpret_cast<float*>(smem + L.rc);
  float* lg_s = reinterpret_cast<float*>(smem + L.lg);
  float* hxr_s = reinterpret_cast<float*>(smem + L.hxr);
  float* rho_s = reinterpret_cast<float*>(smem + L.rho);
  float* seed_s = reinterpret_cast<float*>(smem + L.seed);
  const int d3 = 3 * d;
  const int rows = n * k;
  const int row0 = blockIdx.x * kRows;
  // leading dimension of a full (in, out) weight matrix in either layout
  auto ldw = [&](int in, int out) { return kMma ? in : out; };

  // z = mu_p + sigma_p * eps, and the agent vectors, replicated by index
  for (int i = threadIdx.x; i < kRows * lat; i += blockDim.x) {
    const int r = i / lat, j = i % lat, row = row0 + r;
    float z = 0.f;
    if (row < rows) {
      const float* ms = musig + (size_t)(row / k) * 2 * lat;
      z = ms[j] + ms[lat + j] * to_f(eps[(size_t)row * lat + j]);
    }
    z_s[r * L.lz + j] = rnd<CD>(z);
  }
  for (int i = threadIdx.x; i < kRows * d; i += blockDim.x) {
    const int row = row0 + i / d, j = i % d;
    const bool on = row < rows;
    hxr_s[i] = on ? rnd<CD>(hx[(size_t)(row / k) * d + j]) : 0.f;
    rho_s[i] = on ? rnd<CD>(rho[(size_t)(row / k) * d + j]) : 0.f;
    lg_s[i] = 0.f;
  }
  __syncthreads();

  // h1 = elu(z W1 + b1)
  product<kMma, 16>(z_s, L.lz, lat, w1, ldw(lat, hid), hid,
                    [&](int r, int c, float acc) {
                      const float v = acc + b1[c];
                      h1_s[r * L.lh1 + c] =
                          rnd<CD>(v > 0.f ? v : expf(v) - 1.f);
                    });
  __syncthreads();

  // recon = sigmoid(h1 W2 + b2), streamed in column chunks into the
  // logits: lg += recon[:, chunk] Wpv[chunk, :]
  for (int c0 = 0; c0 < side2; c0 += kChunk) {
    const int nc = side2 - c0 < kChunk ? side2 - c0 : kChunk;
    product<kMma, 8>(h1_s, L.lh1, hid,
                     kMma ? w2 + (size_t)c0 * hid : w2 + c0,
                     ldw(hid, side2), nc, [&](int r, int c, float acc) {
                       rc_s[r * L.lrc + c] =
                           rnd<CD>(sigmoid(acc + b2[c0 + c]));
                     });
    __syncthreads();
    product<kMma, 4>(rc_s, L.lrc, nc,
                     kMma ? pvw + c0 : pvw + (size_t)c0 * d,
                     ldw(side2, d), d,
                     [&](int r, int c, float acc) { lg_s[r * d + c] += acc; });
    __syncthreads();
  }
  // logits = (recon Wpv + bpv) + z Wzg + bzg
  product<kMma, 4>(z_s, L.lz, lat, zgw, ldw(lat, d), d,
                   [&](int r, int c, float acc) {
                     lg_s[r * d + c] = (lg_s[r * d + c] + pvb[c]) + acc
                                       + zgb[c];
                   });
  __syncthreads();
  // beta = softmax(logits) * d, one warp per row
  {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < kRows; r += blockDim.x / 32) {
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
  product<kMma, 4>(z_s, L.lz, lat, zsw, ldw(lat, d), d,
                   [&](int r, int c, float acc) {
                     const int i = r * d + c;
                     seed_s[r * L.ld + c] =
                         rnd<CD>(lg_s[i] * hxr_s[i] + acc + zsb[c]
                                 + rho_s[i]);
                   });
  __syncthreads();

  // K-lane decode: constant input gates, h0 = hx; h1_s is free now
  float* gi_s = h1_s;
  float* gh_s = gi_s + kRows * d3;
  float* h_s = gh_s + kRows * d3;
  float* hr_s = h_s + kRows * d;
  product<kMma, 4>(seed_s, L.ld, d, dwi, ldw(d, d3), d3,
                   [&](int r, int c, float acc) {
                     gi_s[r * d3 + c] = acc + dbi[c];
                   });
  for (int i = threadIdx.x; i < kRows * d; i += blockDim.x) {
    h_s[i] = hxr_s[i];
    hr_s[(i / d) * L.ld + i % d] = hxr_s[i];
  }
  __syncthreads();
  for (int t = 0; t < t_len; ++t) {
    product<kMma, 4>(hr_s, L.ld, d, dwh, ldw(d, d3), d3,
                     [&](int r, int c, float acc) {
                       gh_s[r * d3 + c] = acc + dbh[c];
                     });
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * d; i += blockDim.x) {
      const int r = i / d, j = i % d, row = row0 + r;
      const float* gi = gi_s + r * d3;
      const float* gh = gh_s + r * d3;
      const float h = gru_out(gi[j], gi[d + j], gi[2 * d + j], gh[j],
                              gh[d + j], gh[2 * d + j], h_s[i]);
      h_s[i] = h;
      hr_s[r * L.ld + j] = rnd<CD>(h);
      if (row < rows) dec_h[((size_t)row * t_len + t) * d + j] = h;
    }
    __syncthreads();
  }
}

template <typename CD, bool kMma>
int launch(const void* feats, const void* mask, const void* rho,
           const void* eps, const void* ewi, const void* ewh,
           const void* ebi, const void* ebh, const void* prw,
           const void* prb, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* pvw, const void* pvb, const void* zgw,
           const void* zgb, const void* zsw, const void* zsb,
           const void* dwi, const void* dwh, const void* dbi,
           const void* dbh, void* musig, void* dec_h, void* hx, int n,
           int to, int emb, int d, int lat, int hid, int side2, int k,
           int t_len, cudaStream_t stream) {
  using F = const float*;
  using C = const CD*;
  if (kMma && (lat % 16 || hid % 16 || side2 % kChunk || d % 16))
    return cudaErrorInvalidValue;
  Bump eb;
  eb.take((size_t)kEncRows * emb * 4);
  eb.take((size_t)kEncRows * d * 4);
  eb.take((size_t)kEncRows * d * 4);
  eb.take((size_t)kEncRows * 3 * d * 4);
  eb.take((size_t)kEncRows * 3 * d * 4);
  const SampleLayout L(d, lat, hid);
  if (eb.off > kMaxSmem || L.total > kMaxSmem) return cudaErrorInvalidValue;
  cudaFuncSetAttribute(sgm_encode_kernel<CD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)eb.off);
  cudaFuncSetAttribute(sgm_sample_kernel<CD, kMma>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L.total);
  const int enc_blocks = (n + kEncRows - 1) / kEncRows;
  sgm_encode_kernel<CD><<<enc_blocks, kThreads, eb.off, stream>>>(
      C(feats), F(mask), C(ewi), C(ewh), F(ebi), F(ebh), C(prw), F(prb),
      (float*)hx, (float*)musig, n, to, emb, d, lat);
  const int rows = n * k;
  const int blocks = (rows + kRows - 1) / kRows;
  sgm_sample_kernel<CD, kMma><<<blocks, kThreads, L.total, stream>>>(
      F(hx), F(musig), F(rho), C(eps), C(w1), F(b1), C(w2), F(b2), C(pvw),
      F(pvb), C(zgw), F(zgb), C(zsw), F(zsb), C(dwi), C(dwh), F(dbi),
      F(dbh), (float*)dec_h, n, k, d, lat, hid, side2, t_len);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace desire

// is_bf16 selects the compute dtype of the weights, feats and eps (bf16,
// else float32); biases are float32. use_mma (bf16 only, needs lat, hid and
// d multiples of 16 and side2 a multiple of 64) runs the sampler's products
// on the tensor cores and then takes the sampler matrices w1, w2, pvw, zgw,
// zsw, dwi, dwh TRANSPOSED, (out, in); otherwise all weights are row-major
// (in, out). The encoder weights ewi, ewh, prw are row-major always.
// feats (n, to, emb), eps (n, k, lat); mask (n, to), rho (n, d) float32.
// musig (n, 2 lat) is scratch; outputs dec_h (n, k, t_len, d) and hx (n, d)
// float32. Returns cudaGetLastError().
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
  auto s = static_cast<cudaStream_t>(stream);
#define DESIRE_SGM_ARGS                                                     \
  feats, mask, rho, eps, ewi, ewh, ebi, ebh, prw, prb, w1, b1, w2, b2, pvw, \
      pvb, zgw, zgb, zsw, zsb, dwi, dwh, dbi, dbh, musig, dec_h, hx, n, to, \
      emb, d, lat, hid, side2, k, t_len, s
  if (is_bf16 && use_mma)
    return desire::launch<__nv_bfloat16, true>(DESIRE_SGM_ARGS);
  if (is_bf16) return desire::launch<__nv_bfloat16, false>(DESIRE_SGM_ARGS);
  if (use_mma) return cudaErrorInvalidValue;
  return desire::launch<float, false>(DESIRE_SGM_ARGS);
#undef DESIRE_SGM_ARGS
}
