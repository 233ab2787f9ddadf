// Align-corners bilinear pooling of the scene feature map and its gradient,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels desire_tpu/ops/scene_pool.py `_fwd_kernel` and
// `_bwd_kernel` (reached through `bilinear_pool_pallas` and its custom
// VJP). Wrapper, autograd binding and plain PyTorch version:
// desire_tpu_torch/ops/scene_pool.py.
//
//   forward   out[b, p, :] = sum_e w_e * fmap[b, node_e, :]
//   backward  d_fmap[b, node, :] = sum over (p, e) with node_e = node of
//               w_e * g[b, p, :]
//             d_pos[b, p] = (G - 1) * [0 <= pos <= 1] * sum_c g[b, p, c] *
//               d(sum_e w_e fmap[b, node_e, c]) / d(fx, fy)
//
// with the four corners e of the position clamped to [0, 1] and scaled to
// the G x G grid, in the order (x0,y0) (x1,y0) (x0,y1) (x1,y1), and their
// weights rounded to the map's dtype, as the TPU kernel's 4-hot matrix
// holds them. g is in the map's dtype; products accumulate in float32, the
// outputs are written in the map's dtype (d_pos in float32).
//
// What bounds it on this card: bytes, and for the forward how many of them
// each thread keeps in flight. Per point the forward reads 8 bytes of
// position and 4 corner rows of the map (which stay in L2: the whole
// flagship map is 4 MB) and writes one row of C channels; at the flagship
// shape (B=64, P=14,400, G=32, C=32, bf16) that is ~71 MB. The backward
// reads the positions, the cotangent rows and the map and writes d_fmap and
// d_pos, ~86 MB. No product is needed: the TPU kernel turned the gather into
// a (512, G^2) 4-hot matrix product because a gather is slow on the TPU;
// here it is a gather.
//
// What the design does:
// * Forward, vector path (a row of C channels is a whole number of 16-byte
//   pieces: C % 8 == 0 in bf16, C % 4 == 0 in float32, 16-byte aligned
//   tensors; the wrapper decides): a thread owns one 16-byte piece of one
//   point's row, so C / 8 (or C / 4) neighbouring threads share a point and
//   a warp covers several points (8 at C = 32 bf16). The threads of a point
//   read its position as one 8-byte broadcast load, a warp's positions being
//   one contiguous run; each thread then sends its four 16-byte corner
//   loads together through the read-only path, accumulates its channels in
//   float32 (the four fused multiply-adds per channel in corner order, as
//   the channel loop does, so the result is bitwise the same) and stores 16
//   bytes. The launch is a grid-stride loop over a bounded number of blocks
//   per SM.
// * Forward, channel loop (any other C or alignment), and d_pos: one warp
//   per point, its lanes over the channels. d_pos is a warp reduction over
//   the channels.
// * d_fmap is a scatter of every point into 4 nodes, and points share
//   nodes heavily. It is deterministic, with no atomics: a block owns a
//   band of grid rows of one batch row, accumulates it in shared memory
//   and writes it once. It scans the batch row's points in chunks, keeps
//   those with a corner in its band in ascending point order (a stable
//   block-wide compaction), stages their corners, weights and cotangent
//   rows, and thread (channel c, column class s) adds the entries of its
//   nodes (x % S == s) in that order, corner by corner. Each (node,
//   channel) sum has one owner and a fixed order, so the result is bitwise
//   reproducible. Every band block reads all positions of its batch row
//   (from L2 after the first) and the cotangent rows of its points only.
#include "common.cuh"

namespace desire {
namespace {

constexpr int kPoolThreads = 256;

// Align-corners bilinear corners of a position clamped to [0, 1], as the
// TPU kernel's _corner_data: grid coordinates and fractional parts.
struct Cell {
  int x0, x1, y0, y1;
  float fx, fy;
};

__device__ __forceinline__ Cell cell_of(float px, float py, int G) {
  Cell q;
  const float gx = fminf(fmaxf(px, 0.f), 1.f) * (G - 1);
  const float gy = fminf(fmaxf(py, 0.f), 1.f) * (G - 1);
  const float fx0 = floorf(gx), fy0 = floorf(gy);
  q.fx = gx - fx0;
  q.fy = gy - fy0;
  q.x0 = (int)fx0;
  q.y0 = (int)fy0;
  q.x1 = min(q.x0 + 1, G - 1);
  q.y1 = min(q.y0 + 1, G - 1);
  return q;
}

template <typename CD>
__global__ void __launch_bounds__(kPoolThreads) scene_pool_fwd_kernel(
    const CD* __restrict__ fmap, const float* __restrict__ pos,
    CD* __restrict__ out, int B, int P, int G, int C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long i = (long)blockIdx.x * (kPoolThreads / 32) + warp;  // point
  if (i >= (long)B * P) return;
  const long b = i / P;
  const Cell q = cell_of(pos[2 * i], pos[2 * i + 1], G);
  const float w[4] = {rnd<CD>((1.f - q.fx) * (1.f - q.fy)),
                      rnd<CD>(q.fx * (1.f - q.fy)),
                      rnd<CD>((1.f - q.fx) * q.fy), rnd<CD>(q.fx * q.fy)};
  const CD* fm = fmap + b * G * G * C;
  const CD* r[4] = {fm + (q.y0 * G + q.x0) * C, fm + (q.y0 * G + q.x1) * C,
                    fm + (q.y1 * G + q.x0) * C, fm + (q.y1 * G + q.x1) * C};
  for (int c = lane; c < C; c += 32) {
    float acc = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc = fmaf(w[e], to_f(r[e][c]), acc);
    out[i * C + c] = from_f<CD>(acc);
  }
}

// 16 bytes of a row as float32: 4 float32 or 8 bf16 channels (a bf16 value
// widens exactly).
template <typename CD>
constexpr int kVec = 16 / (int)sizeof(CD);

template <typename CD>
__device__ __forceinline__ void load_row16(const CD* p, float (&f)[kVec<CD>]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (sizeof(CD) == 4) {
      f[q] = __uint_as_float(u[q]);
    } else {
      f[2 * q] = __uint_as_float(u[q] << 16);
      f[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u);
    }
  }
}

template <typename CD>
__device__ __forceinline__ void store_row16(CD* p,
                                            const float (&f)[kVec<CD>]) {
  uint4 v;
  if constexpr (sizeof(CD) == 4) {
    v = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                   __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    v = make_uint4(pack_bf16(make_float2(f[0], f[1])),
                   pack_bf16(make_float2(f[2], f[3])),
                   pack_bf16(make_float2(f[4], f[5])),
                   pack_bf16(make_float2(f[6], f[7])));
  }
  *reinterpret_cast<uint4*>(p) = v;
}

// Blocks per SM of the vector path's grid-stride launch: enough warps to
// cover the corner loads' latency, few enough that a block's share of the
// map stays hot in L2 while it strides (on an H100, 8 and 16 timed alike,
// 2, 4, 32 and one block per 256 pieces slower).
constexpr int kVecBlocksPerSm = 8;

// The forward's vector path: thread slot s owns channels [c0, c0 + kVec) of
// point s / (C / kVec). Idx is 32-bit where the slot count allows (its
// divisions are cheaper).
template <typename CD, typename Idx>
__global__ void __launch_bounds__(kPoolThreads) scene_pool_fwd_vec_kernel(
    const CD* __restrict__ fmap, const float* __restrict__ pos,
    CD* __restrict__ out, Idx slots, Idx P, int G, int C) {
  constexpr int V = kVec<CD>;
  const Idx lpp = (Idx)(C / V);
  const Idx stride = (Idx)gridDim.x * kPoolThreads;
  for (Idx s = (Idx)blockIdx.x * kPoolThreads + threadIdx.x; s < slots;
       s += stride) {
    const Idx i = s / lpp;
    const int c0 = (int)(s - i * lpp) * V;
    const float2 xy = __ldg(reinterpret_cast<const float2*>(pos) + i);
    const Cell q = cell_of(xy.x, xy.y, G);
    const float w[4] = {rnd<CD>((1.f - q.fx) * (1.f - q.fy)),
                        rnd<CD>(q.fx * (1.f - q.fy)),
                        rnd<CD>((1.f - q.fx) * q.fy), rnd<CD>(q.fx * q.fy)};
    const CD* fm = fmap + (size_t)(i / P) * G * G * C + c0;
    float f[4][V];
    load_row16<CD>(fm + (q.y0 * G + q.x0) * C, f[0]);
    load_row16<CD>(fm + (q.y0 * G + q.x1) * C, f[1]);
    load_row16<CD>(fm + (q.y1 * G + q.x0) * C, f[2]);
    load_row16<CD>(fm + (q.y1 * G + q.x1) * C, f[3]);
    float acc[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      acc[c] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c] = fmaf(w[e], f[e][c], acc[c]);
    }
    store_row16<CD>(out + (size_t)i * C + c0, acc);
  }
}

// d_pos: one warp per point. d(out_c)/d fx is (1 - fy)(f1 - f0) + fy (f3 -
// f2) with the derivative weights rounded to the map's dtype, as the TPU
// kernel's derivative 4-hot matrices; coinciding corners (at the far edge)
// cancel exactly.
template <typename CD>
__global__ void __launch_bounds__(kPoolThreads) scene_pool_dpos_kernel(
    const CD* __restrict__ fmap, const float* __restrict__ pos,
    const CD* __restrict__ g, float* __restrict__ d_pos, int B, int P,
    int G, int C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long i = (long)blockIdx.x * (kPoolThreads / 32) + warp;
  if (i >= (long)B * P) return;
  const long b = i / P;
  const float px = pos[2 * i], py = pos[2 * i + 1];
  const Cell q = cell_of(px, py, G);
  const float ax = rnd<CD>(1.f - q.fy), bx = rnd<CD>(q.fy);
  const float ay = rnd<CD>(1.f - q.fx), by = rnd<CD>(q.fx);
  const CD* fm = fmap + b * G * G * C;
  const CD* r0 = fm + (q.y0 * G + q.x0) * C;
  const CD* r1 = fm + (q.y0 * G + q.x1) * C;
  const CD* r2 = fm + (q.y1 * G + q.x0) * C;
  const CD* r3 = fm + (q.y1 * G + q.x1) * C;
  float sx = 0.f, sy = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float f0 = to_f(r0[c]), f1 = to_f(r1[c]);
    const float f2 = to_f(r2[c]), f3 = to_f(r3[c]);
    const float gc = to_f(g[i * C + c]);
    sx = fmaf(ax * (f1 - f0) + bx * (f3 - f2), gc, sx);
    sy = fmaf(ay * (f2 - f0) + by * (f3 - f1), gc, sy);
  }
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  if (lane == 0) {
    const float in_x = (px >= 0.f && px <= 1.f) ? 1.f : 0.f;
    const float in_y = (py >= 0.f && py <= 1.f) ? 1.f : 0.f;
    d_pos[2 * i] = sx * (float)(G - 1) * in_x;
    d_pos[2 * i + 1] = sy * (float)(G - 1) * in_y;
  }
}

// Shared memory of the d_fmap kernel: the band's accumulator (rows * G * C
// floats), then per staged point (a chunk of one point per thread) its
// cotangent row (C floats), its four rounded corner weights, its corner
// coordinates (x0, x1, y0, y1) and its index, and the compaction's warp
// offsets.
__host__ __device__ inline size_t dmap_smem_bytes(int rows, int G, int C) {
  return ((size_t)rows * G * C + (size_t)kPoolThreads * (C + 4)) * 4
         + (size_t)kPoolThreads * 5 * 4 + 64 * 4;
}

template <typename CD>
__global__ void __launch_bounds__(kPoolThreads) scene_pool_dmap_kernel(
    const float* __restrict__ pos, const CD* __restrict__ g,
    CD* __restrict__ d_fmap, int P, int G, int C, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int y_lo = blockIdx.x * rows, y_hi = min(y_lo + rows, G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int nwarps = kPoolThreads / 32;
  float* acc = reinterpret_cast<float*>(smem);
  float* sg = acc + (size_t)rows * G * C;                    // (chunk, C)
  float* sw = sg + (size_t)kPoolThreads * C;                  // (chunk, 4)
  int* sxy = reinterpret_cast<int*>(sw + kPoolThreads * 4);   // (chunk, 4)
  int* spt = sxy + kPoolThreads * 4;                          // (chunk)
  int* wbase = spt + kPoolThreads;                            // (nwarps + 1)
  const int S = max(1, kPoolThreads / C);  // column classes
  const int band = (y_hi - y_lo) * G * C;
  for (int j = tid; j < band; j += kPoolThreads) acc[j] = 0.f;
  const float* pb = pos + (size_t)b * P * 2;
  const CD* gb = g + (size_t)b * P * C;
  for (int p0 = 0; p0 < P; p0 += kPoolThreads) {
    // this thread's point, and whether a corner lies in the band
    const int p = p0 + tid;
    Cell q{};
    bool mine = false;
    if (p < P) {
      q = cell_of(pb[2 * p], pb[2 * p + 1], G);
      mine = (q.y0 >= y_lo && q.y0 < y_hi) || (q.y1 >= y_lo && q.y1 < y_hi);
    }
    // stable compaction: the kept points stay in ascending order
    const unsigned ballot = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) wbase[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      const int v = lane < nwarps ? wbase[lane] : 0;
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      if (lane < nwarps) wbase[lane] = incl - v;
      if (lane == 31) wbase[nwarps] = incl;
    }
    __syncthreads();
    const int n = wbase[nwarps];
    if (mine) {
      const int e = wbase[warp] + __popc(ballot & ((1u << lane) - 1u));
      sw[e * 4 + 0] = rnd<CD>((1.f - q.fx) * (1.f - q.fy));
      sw[e * 4 + 1] = rnd<CD>(q.fx * (1.f - q.fy));
      sw[e * 4 + 2] = rnd<CD>((1.f - q.fx) * q.fy);
      sw[e * 4 + 3] = rnd<CD>(q.fx * q.fy);
      sxy[e * 4 + 0] = q.x0;
      sxy[e * 4 + 1] = q.x1;
      sxy[e * 4 + 2] = q.y0;
      sxy[e * 4 + 3] = q.y1;
      spt[e] = p;
    }
    __syncthreads();
    // stage the kept points' cotangent rows (coalesced along C)
    for (int j = tid; j < n * C; j += kPoolThreads)
      sg[j] = to_f(gb[(size_t)spt[j / C] * C + j % C]);
    __syncthreads();
    // each (node, channel) has one owner, which walks the entries in order
    for (int item = tid; item < C * S; item += kPoolThreads) {
      const int c = item % C, s = item / C;
      for (int e = 0; e < n; ++e) {
        const int* xy = sxy + e * 4;
        const float v = sg[e * C + c];
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const int x = xy[k4 & 1], y = xy[2 + (k4 >> 1)];
          if (x % S == s && y >= y_lo && y < y_hi) {
            float* dst = acc + ((y - y_lo) * G + x) * C + c;
            *dst = fmaf(sw[e * 4 + k4], v, *dst);
          }
        }
      }
    }
    __syncthreads();
  }
  CD* out = d_fmap + ((size_t)b * G + y_lo) * G * C;
  for (int j = tid; j < band; j += kPoolThreads) out[j] = from_f<CD>(acc[j]);
}

unsigned point_blocks(int B, int P) {
  const long warps = (long)B * P, per = kPoolThreads / 32;
  return (unsigned)((warps + per - 1) / per);
}

// vec: the elements per 16-byte piece if the wrapper chose the vector path
// (C a multiple of it, 16-byte aligned tensors), 0 for the channel loop.
template <typename CD>
int launch_fwd(const void* fmap, const void* pos, void* out, int B, int P,
               int G, int C, int vec, cudaStream_t stream) {
  const long npts = (long)B * P;
  if (vec != 0 && (vec != kVec<CD> || C % vec != 0
                   || (((uintptr_t)fmap | (uintptr_t)out) & 15) != 0
                   || ((uintptr_t)pos & 7) != 0))
    return cudaErrorInvalidValue;
  if (npts == 0) return 0;
  if (vec == 0) {
    scene_pool_fwd_kernel<CD><<<point_blocks(B, P), kPoolThreads, 0,
                                stream>>>((const CD*)fmap, (const float*)pos,
                                          (CD*)out, B, P, G, C);
    return (int)cudaGetLastError();
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long slots = npts * (C / vec);
  const long want = (slots + kPoolThreads - 1) / kPoolThreads;
  const long cap = (long)sms * kVecBlocksPerSm;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  if (slots + (long)blocks * kPoolThreads < (1L << 32))
    scene_pool_fwd_vec_kernel<CD, uint32_t>
        <<<blocks, kPoolThreads, 0, stream>>>(
            (const CD*)fmap, (const float*)pos, (CD*)out, (uint32_t)slots,
            (uint32_t)P, G, C);
  else
    scene_pool_fwd_vec_kernel<CD, uint64_t>
        <<<blocks, kPoolThreads, 0, stream>>>(
            (const CD*)fmap, (const float*)pos, (CD*)out, (uint64_t)slots,
            (uint64_t)P, G, C);
  return (int)cudaGetLastError();
}

template <typename CD>
int launch_bwd(const void* fmap, const void* pos, const void* g,
               void* d_fmap, void* d_pos, int B, int P, int G, int C,
               cudaStream_t stream) {
  // bands of up to 4 grid rows, fewer if the accumulator must shrink
  int rows = G < 4 ? G : 4;
  while (rows > 1 && dmap_smem_bytes(rows, G, C) > kMaxSmem) --rows;
  const size_t bytes = dmap_smem_bytes(rows, G, C);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaFuncSetAttribute(scene_pool_dmap_kernel<CD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  const dim3 grid((G + rows - 1) / rows, B);
  scene_pool_dmap_kernel<CD><<<grid, kPoolThreads, bytes, stream>>>(
      (const float*)pos, (const CD*)g, (CD*)d_fmap, P, G, C, rows);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || (long)B * P == 0) return rc;
  scene_pool_dpos_kernel<CD><<<point_blocks(B, P), kPoolThreads, 0,
                               stream>>>((const CD*)fmap, (const float*)pos,
                                         (const CD*)g, (float*)d_pos, B, P,
                                         G, C);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace desire

// fmap (B, G, G, C) CD, pos (B, P, 2) float32 -> out (B, P, C) CD. CD is
// bfloat16 when is_bf16, else float32. vec: 8 (bfloat16) or 4 (float32) for
// the vector path, which needs C % vec == 0 and 16-byte aligned fmap and
// out (pos 8-byte aligned), else 0 for the channel loop. Returns
// cudaGetLastError().
extern "C" int scene_pool_fwd_launch(int is_bf16, const void* fmap,
                                     const void* pos, void* out, int B,
                                     int P, int G, int C, int vec,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return desire::launch_fwd<__nv_bfloat16>(fmap, pos, out, B, P, G, C, vec,
                                             s);
  return desire::launch_fwd<float>(fmap, pos, out, B, P, G, C, vec, s);
}

// fmap (B, G, G, C) CD, pos (B, P, 2) float32, g (B, P, C) CD -> d_fmap
// (B, G, G, C) CD and d_pos (B, P, 2) float32 (two kernels). Returns
// cudaGetLastError().
extern "C" int scene_pool_bwd_launch(int is_bf16, const void* fmap,
                                     const void* pos, const void* g,
                                     void* d_fmap, void* d_pos, int B, int P,
                                     int G, int C, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return desire::launch_bwd<__nv_bfloat16>(fmap, pos, g, d_fmap, d_pos, B,
                                             P, G, C, s);
  return desire::launch_bwd<float>(fmap, pos, g, d_fmap, d_pos, B, P, G, C,
                                   s);
}
