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
// * Forward, channel loop (any other C or alignment): one warp per point,
//   its lanes over the channels.
// * d_fmap is a scatter of every point into 4 nodes, and points share
//   nodes heavily (thousands of them where clamped positions pile onto a
//   border or corner cell). It is a gather instead, deterministic and with
//   no float atomics, in three launches:
//   1. scene_pool_bucket_kernel: a stable counting sort of each batch
//      row's points by cell (x0, y0) into a workspace (every cell's first
//      slot, the sorted point indices), each bucket cut into segments of
//      at most kSegLen points. Integer counts only, whose result does not
//      depend on their order. The scatter goes through shared memory.
//   2. scene_pool_seg_kernel: a thread (segment, 16-byte channel piece)
//      reads each of its points' cotangent piece once and sums w_e * g over
//      the points in order for each of the cell's four corners e (a long
//      bucket is so split across threads). Where a row is a power of two of
//      whole pieces it also computes the points' d_pos from the cell's four
//      corner pieces, loaded once, so the cotangent is read once in all;
//      else scene_pool_dpos_kernel does.
//   3. scene_pool_dmap_kernel: a thread owns one (node, piece) of d_fmap.
//      It adds the partial sums of the <= 4 cells with a corner on its node
//      in a fixed order (cell, segment, corner) and writes its piece once.
//   One owner per output and a fixed order of every sum: bitwise
//   reproducible from call to call. The sums are taken in another order
//   than the TPU kernel's product, so the last bits may differ from it.
//   The wrapper allocates the workspace (scene_pool_bwd_ws_bytes).
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

// d_pos, channel loop (any C or alignment): one warp per point. d(out_c)/d
// fx is (1 - fy)(f1 - f0) + fy (f3 - f2) with the derivative weights
// rounded to the map's dtype, as the TPU kernel's derivative 4-hot
// matrices; coinciding corners (at the far edge) cancel exactly.
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

// -- the gradient: bucket the points by cell, then sum --------------------
// Every bucket (the points of one cell) is cut into segments of at most
// kSegLen points. The first level sums each segment's weighted cotangents
// for each of the cell's four corners; the second adds, for each node, the
// segments of the <= 4 cells with a corner on it.
constexpr int kSegLen = 64;
constexpr int kBucketMaxWarps = 32;

// Segments of a batch row: sum over the non-empty buckets of ceil(n /
// kSegLen) <= P / kSegLen + min(G^2, P).
__host__ __device__ inline int max_segments(int P, int G) {
  return (P + kSegLen - 1) / kSegLen + (G * G < P ? G * G : P);
}

// The workspace of the gradient, carved in this order: per batch row the
// first sorted slot of every cell and the row's end (G^2 + 1), the first
// segment of every cell and the row's segment count (G^2 + 1), the cell of
// every segment and the sorted point indices; then the segments' partial
// sums, 4 corners x C float32 each.
struct PoolWs {
  size_t start, seg_start, seg_cell, idx, part, total;
  PoolWs(int B, int P, int G, int C) {
    const size_t cells1 = (size_t)G * G + 1, ms = (size_t)max_segments(P, G);
    Bump bp;
    start = bp.take((size_t)B * cells1 * 4);
    seg_start = bp.take((size_t)B * cells1 * 4);
    seg_cell = bp.take((size_t)B * ms * 4);
    idx = bp.take((size_t)B * P * 4);
    part = bp.take((size_t)B * ms * 4 * C * 4);
    total = bp.off;
  }
};

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32, at
// most 1024), in thread order; s holds 33 ints. Returns v's offset and sets
// total to the block's sum.
__device__ __forceinline__ int block_excl_scan(int v, int* s, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < nw ? s[lane] : 0;
    int u = t;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, u, o);
      if (lane >= o) u += y;
    }
    if (lane < nw) s[lane] = u - t;
    if (lane == 31) s[32] = u;
  }
  __syncthreads();
  const int r = s[warp] + x - v;
  total = s[32];
  __syncthreads();
  return r;
}

// Steps of 32 points a warp's positions are loaded ahead by.
constexpr int kBucketAhead = 4;

// The lanes of the warp whose key equals this lane's, what
// __match_any_sync gives, from one ballot per bit of the key (keys below
// 2^bits). On an H100 the flagship sort took 0.031 ms this way, 0.039 with
// __match_any_sync.
__device__ __forceinline__ unsigned match_key(int key, int bits) {
  unsigned m = 0xffffffffu;
  for (int i = 0; i < bits; ++i) {
    const bool one = (key >> i) & 1;
    const unsigned bal = __ballot_sync(0xffffffffu, one);
    m &= one ? bal : ~bal;
  }
  return m;
}

// Walks the warp's run [p_lo, p_hi) of a batch row's positions pb in
// steps of 32 points in order, calling step(p, cell, peers) with each
// lane's point, its cell (x0, y0) (`cells` for a lane past the run) and
// the lanes whose point shares that cell. Positions are loaded
// kBucketAhead steps at a time, so their latency is paid once a group.
template <typename Step>
__device__ __forceinline__ void for_run_cells(const float* pb, int p_lo,
                                              int p_hi, int G, Step step) {
  const int lane = threadIdx.x % 32, cells = G * G;
  const int bits = 32 - __clz(cells);  // keys 0..cells
  for (int p0 = p_lo; p0 < p_hi; p0 += 32 * kBucketAhead) {
    float2 xy[kBucketAhead];
#pragma unroll
    for (int u = 0; u < kBucketAhead; ++u) {
      const int p = p0 + 32 * u + lane;
      xy[u] = p < p_hi ? make_float2(pb[2 * p], pb[2 * p + 1])
                       : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBucketAhead; ++u) {
      const int p = p0 + 32 * u + lane;
      int cell = cells;
      if (p < p_hi) {
        const Cell q = cell_of(xy[u].x, xy[u].y, G);
        cell = q.y0 * G + q.x0;
      }
      step(p, cell, match_key(cell, bits));
    }
  }
}

// Stable counting sort of one batch row's points (a block) by their cell
// (x0, y0). Warp w owns a contiguous run of the row's points: it counts
// them per cell into its own histogram (one leader a step adding the count
// of the lanes that share a cell), the block turns the histograms into
// every warp's first slot per cell (cells in order, warps in order within
// a cell), and each warp scatters its run in ascending order, a lane's
// rank among its peers by their lane order. So every bucket holds its
// points in ascending point order, whatever the schedule. It also lays out
// the buckets' segments. With `staged` the scatter goes to shared memory
// and the sorted indices leave in one coalesced copy (scattered 4-byte
// stores to device memory took three quarters of the kernel's time).
__global__ void __launch_bounds__(1024, 1) scene_pool_bucket_kernel(
    const float* __restrict__ pos, int* __restrict__ start,
    int* __restrict__ seg_start, int* __restrict__ seg_cell,
    int* __restrict__ sidx, int P, int G, int staged) {
  // (warps, G * G) histograms, 33 ints of scan, then (staged) P indices
  extern __shared__ int hist[];
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cells = G * G, b = blockIdx.x, ms = max_segments(P, G);
  int* scan = hist + nw * cells;
  for (int j = threadIdx.x; j < nw * cells; j += blockDim.x) hist[j] = 0;
  __syncthreads();
  const float* pb = pos + (size_t)b * P * 2;
  const int run = (P + nw - 1) / nw;
  const int p_lo = min(warp * run, P), p_hi = min(p_lo + run, P);
  int* h = hist + warp * cells;
  for_run_cells(pb, p_lo, p_hi, G, [&](int, int cell, unsigned peers) {
    if (cell < cells && lane == __ffs(peers) - 1) h[cell] += __popc(peers);
    __syncwarp();
  });
  __syncthreads();
  int* st = start + (size_t)b * (cells + 1);
  int* ss = seg_start + (size_t)b * (cells + 1);
  int* sc = seg_cell + (size_t)b * ms;
  int carry = 0, seg_carry = 0;
  for (int c0 = 0; c0 < cells; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    int n = 0;
    if (c < cells)
      for (int w = 0; w < nw; ++w) n += hist[w * cells + c];
    const int nseg = (n + kSegLen - 1) / kSegLen;
    int tot, seg_tot;
    const int off = carry + block_excl_scan(n, scan, tot);
    const int seg_off = seg_carry + block_excl_scan(nseg, scan, seg_tot);
    if (c < cells) {
      st[c] = off;
      ss[c] = seg_off;
      int cur = off;
      for (int w = 0; w < nw; ++w) {
        const int t = hist[w * cells + c];
        hist[w * cells + c] = cur;
        cur += t;
      }
      for (int k = 0; k < nseg; ++k) sc[seg_off + k] = c;
    }
    carry += tot;
    seg_carry += seg_tot;
  }
  if (threadIdx.x == 0) {
    st[cells] = carry;
    ss[cells] = seg_carry;
  }
  __syncthreads();
  int* si = sidx + (size_t)b * P;
  int* dst = staged ? scan + 33 : si;
  const unsigned below = (1u << lane) - 1u;
  for_run_cells(pb, p_lo, p_hi, G, [&](int p, int cell, unsigned peers) {
    if (cell < cells) dst[h[cell] + __popc(peers & below)] = p;
    __syncwarp();
    if (cell < cells && lane == __ffs(peers) - 1) h[cell] += __popc(peers);
    __syncwarp();
  });
  if (staged) {
    __syncthreads();
    for (int j = threadIdx.x; j < P; j += blockDim.x) si[j] = dst[j];
  }
}

// VW channels of a row as float32: one 16-byte piece (VW == kVec) or one
// element (VW == 1).
template <typename CD, int VW>
__device__ __forceinline__ void load_piece(const CD* p, float (&f)[VW]) {
  if constexpr (VW == 1) {
    f[0] = to_f(__ldg(p));
  } else {
    load_row16<CD>(p, f);
  }
}

// Points of a segment a thread takes together: their loads go out at once.
constexpr int kSegBatch = 4;

// First level: thread (segment, piece) sums w_e * g over the segment's
// points in order, for each of the cell's four corners e, and writes the
// four partial sums. With DPOS (VW == kVec, C / VW a power of two up to 32)
// it also computes d_pos of the segment's points: it loads the cell's four
// corner pieces of the map once, and a point's C / VW threads add their
// partial sums by a shuffle tree in a fixed order; else
// scene_pool_dpos_kernel does.
template <typename CD, int VW, bool DPOS>
__global__ void __launch_bounds__(kPoolThreads) scene_pool_seg_kernel(
    const int* __restrict__ start, const int* __restrict__ seg_start,
    const int* __restrict__ seg_cell, const int* __restrict__ sidx,
    const float* __restrict__ pos, const CD* __restrict__ fmap,
    const CD* __restrict__ g, float* __restrict__ part,
    float* __restrict__ d_pos, int P, int G, int C) {
  const int pieces = C / VW, cells = G * G, b = blockIdx.y;
  const int ms = max_segments(P, G);
  const long t = (long)blockIdx.x * kPoolThreads + threadIdx.x;
  const int s = (int)(t / pieces), c0 = (int)(t % pieces) * VW;
  const int* ss = seg_start + (size_t)b * (cells + 1);
  if (s >= ms || s >= ss[cells]) return;
  const int* st = start + (size_t)b * (cells + 1);
  const int cell = seg_cell[(size_t)b * ms + s];
  const int j0 = st[cell] + (s - ss[cell]) * kSegLen;
  const int j1 = min(j0 + kSegLen, st[cell + 1]);
  const int* si = sidx + (size_t)b * P;
  const float* pb = pos + (size_t)b * P * 2;
  const CD* gb = g + (size_t)b * P * C + c0;
  float f[4][VW];
  unsigned group = 0;
  if constexpr (DPOS) {
    const int cx = cell % G, cy = cell / G;
    const int x1 = min(cx + 1, G - 1), y1 = min(cy + 1, G - 1);
    const CD* fm = fmap + (size_t)b * cells * C + c0;
    load_piece<CD, VW>(fm + (cy * G + cx) * C, f[0]);
    load_piece<CD, VW>(fm + (cy * G + x1) * C, f[1]);
    load_piece<CD, VW>(fm + (y1 * G + cx) * C, f[2]);
    load_piece<CD, VW>(fm + (y1 * G + x1) * C, f[3]);
    const int lane = threadIdx.x % 32;
    group = pieces == 32 ? 0xffffffffu
                         : ((1u << pieces) - 1u) << (lane & ~(pieces - 1));
  }
  float acc[4][VW];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[e][v] = 0.f;
  for (int j = j0; j < j1; j += kSegBatch) {
    int id[kSegBatch];
    float2 xy[kSegBatch];
    float gv[kSegBatch][VW];
#pragma unroll
    for (int u = 0; u < kSegBatch; ++u) id[u] = si[min(j + u, j1 - 1)];
#pragma unroll
    for (int u = 0; u < kSegBatch; ++u) {
      xy[u] = make_float2(__ldg(pb + 2 * id[u]), __ldg(pb + 2 * id[u] + 1));
      load_piece<CD, VW>(gb + (size_t)id[u] * C, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < kSegBatch; ++u) {
      if (j + u >= j1) break;
      const Cell q = cell_of(xy[u].x, xy[u].y, G);
      const float w[4] = {rnd<CD>((1.f - q.fx) * (1.f - q.fy)),
                          rnd<CD>(q.fx * (1.f - q.fy)),
                          rnd<CD>((1.f - q.fx) * q.fy),
                          rnd<CD>(q.fx * q.fy)};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int v = 0; v < VW; ++v)
          acc[e][v] = fmaf(w[e], gv[u][v], acc[e][v]);
      if constexpr (DPOS) {
        const float ax = rnd<CD>(1.f - q.fy), bx = rnd<CD>(q.fy);
        const float ay = rnd<CD>(1.f - q.fx), by = rnd<CD>(q.fx);
        float sx = 0.f, sy = 0.f;
#pragma unroll
        for (int v = 0; v < VW; ++v) {
          sx = fmaf(ax * (f[1][v] - f[0][v]) + bx * (f[3][v] - f[2][v]),
                    gv[u][v], sx);
          sy = fmaf(ay * (f[2][v] - f[0][v]) + by * (f[3][v] - f[1][v]),
                    gv[u][v], sy);
        }
        for (int o = pieces / 2; o > 0; o >>= 1) {
          sx += __shfl_xor_sync(group, sx, o);
          sy += __shfl_xor_sync(group, sy, o);
        }
        if (c0 == 0) {
          const float in_x = (xy[u].x >= 0.f && xy[u].x <= 1.f) ? 1.f : 0.f;
          const float in_y = (xy[u].y >= 0.f && xy[u].y <= 1.f) ? 1.f : 0.f;
          reinterpret_cast<float2*>(d_pos)[(size_t)b * P + id[u]] =
              make_float2(sx * (float)(G - 1) * in_x,
                          sy * (float)(G - 1) * in_y);
        }
      }
    }
  }
  float* out = part + ((size_t)b * ms + s) * 4 * C + c0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (VW == 1) {
      out[e * C] = acc[e][0];
    } else {
#pragma unroll
      for (int v = 0; v < VW; v += 4)
        *reinterpret_cast<float4*>(out + e * C + v) = make_float4(
            acc[e][v], acc[e][v + 1], acc[e][v + 2], acc[e][v + 3]);
    }
  }
}

// Second level: thread (node, piece) owns d_fmap[b, node, piece]. It walks
// the <= 4 cells with a corner on its node, in the order (x0, y0) = (nx -
// 1, ny - 1), (nx, ny - 1), (nx - 1, ny), (nx, ny); in each the segments
// in order, and in each segment the corners that land on the node (at the
// far edge x1 = x0 = G - 1, so 2 or 4 of a cell's corners may), in corner
// order. One owner, one fixed order, one store: bitwise reproducible.
template <typename CD, int VW>
__global__ void __launch_bounds__(kPoolThreads) scene_pool_dmap_kernel(
    const int* __restrict__ seg_start, const float* __restrict__ part,
    CD* __restrict__ d_fmap, int P, int G, int C) {
  const int pieces = C / VW, cells = G * G, b = blockIdx.y;
  const int ms = max_segments(P, G);
  const long t = (long)blockIdx.x * kPoolThreads + threadIdx.x;
  const int node = (int)(t / pieces), c0 = (int)(t % pieces) * VW;
  if (node >= cells) return;
  const int nx = node % G, ny = node / G;
  const int* ss = seg_start + (size_t)b * (cells + 1);
  const float* pb = part + (size_t)b * ms * 4 * C + c0;
  float acc[VW];
#pragma unroll
  for (int v = 0; v < VW; ++v) acc[v] = 0.f;
  for (int k = 0; k < 4; ++k) {
    const int cx = nx - 1 + (k & 1), cy = ny - 1 + (k >> 1);
    if (cx < 0 || cy < 0) continue;
    const int x1 = min(cx + 1, G - 1), y1 = min(cy + 1, G - 1);
    bool on[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      on[e] = ((e & 1) ? x1 : cx) == nx && ((e >> 1) ? y1 : cy) == ny;
    const int cell = cy * G + cx;
    for (int s = ss[cell]; s < ss[cell + 1]; ++s) {
      const float* pr = pb + (size_t)s * 4 * C;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!on[e]) continue;
        if constexpr (VW == 1) {
          acc[0] += pr[e * C];
        } else {
#pragma unroll
          for (int v = 0; v < VW; v += 4) {
            const float4 x = *reinterpret_cast<const float4*>(pr + e * C + v);
            acc[v] += x.x;
            acc[v + 1] += x.y;
            acc[v + 2] += x.z;
            acc[v + 3] += x.w;
          }
        }
      }
    }
  }
  CD* out = d_fmap + ((size_t)b * cells + node) * C + c0;
  if constexpr (VW == 1) {
    out[0] = from_f<CD>(acc[0]);
  } else {
    store_row16<CD>(out, acc);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
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
  const long slots = npts * (C / vec);
  const long want = (slots + kPoolThreads - 1) / kPoolThreads;
  const long cap = (long)sm_count() * kVecBlocksPerSm;
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

// Warps of the bucketing block: as many as fit their histograms in shared
// memory beside `extra` bytes, up to kBucketMaxWarps; 0 if even one does
// not fit.
inline int bucket_warps(int G, size_t extra) {
  const size_t per = (size_t)G * G * 4, fixed = 33 * 4 + extra;
  if (per + fixed > kMaxSmem) return 0;
  const size_t fit = (kMaxSmem - fixed) / per;
  return (int)(fit < (size_t)kBucketMaxWarps ? fit : kBucketMaxWarps);
}

template <typename CD, int VW, bool DPOS>
int launch_sums(const PoolWs& L, unsigned char* ws, const void* fmap,
                const void* pos, const void* g, void* d_fmap, void* d_pos,
                int B, int P, int G, int C, cudaStream_t stream) {
  const int* seg_start = (const int*)(ws + L.seg_start);
  const long pieces = C / VW, ms = max_segments(P, G);
  if (ms > 0) {
    const dim3 grid((unsigned)((ms * pieces + kPoolThreads - 1)
                               / kPoolThreads), B);
    scene_pool_seg_kernel<CD, VW, DPOS><<<grid, kPoolThreads, 0, stream>>>(
        (const int*)(ws + L.start), seg_start, (const int*)(ws + L.seg_cell),
        (const int*)(ws + L.idx), (const float*)pos, (const CD*)fmap,
        (const CD*)g, (float*)(ws + L.part), (float*)d_pos, P, G, C);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const dim3 grid((unsigned)(((long)G * G * pieces + kPoolThreads - 1)
                             / kPoolThreads), B);
  scene_pool_dmap_kernel<CD, VW><<<grid, kPoolThreads, 0, stream>>>(
      seg_start, (const float*)(ws + L.part), (CD*)d_fmap, P, G, C);
  return (int)cudaGetLastError();
}

template <typename CD>
int launch_bwd(const void* fmap, const void* pos, const void* g,
               void* d_fmap, void* d_pos, void* ws, int B, int P, int G,
               int C, cudaStream_t stream) {
  // the sorted indices staged in shared memory where they fit beside
  // the histograms of at least 8 warps
  const int staged_warps = bucket_warps(G, (size_t)P * 4);
  const int staged = staged_warps >= 8;
  const int warps = staged ? staged_warps : bucket_warps(G, 0);
  if (warps == 0 || B > 65535 || ((uintptr_t)ws & 15) != 0)
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  const PoolWs L(B, P, G, C);
  auto* w = static_cast<unsigned char*>(ws);
  // 1. the buckets
  const size_t smem = ((size_t)warps * G * G + 33 + (staged ? P : 0)) * 4;
  cudaFuncSetAttribute(scene_pool_bucket_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  scene_pool_bucket_kernel<<<B, warps * 32, smem, stream>>>(
      (const float*)pos, (int*)(w + L.start), (int*)(w + L.seg_start),
      (int*)(w + L.seg_cell), (int*)(w + L.idx), P, G, staged);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  // 2. the two levels of d_fmap, with d_pos where a row is whole 16-byte
  // pieces, a power of two of them up to 32, and the tensors aligned
  constexpr int V = kVec<CD>;
  const int lpp = C / V;
  const bool vec = C % V == 0
                   && (((uintptr_t)g | (uintptr_t)d_fmap) & 15) == 0;
  const bool fused = vec && lpp <= 32 && (lpp & (lpp - 1)) == 0
                     && ((uintptr_t)fmap & 15) == 0
                     && ((uintptr_t)d_pos & 7) == 0;
  rc = fused ? launch_sums<CD, V, true>(L, w, fmap, pos, g, d_fmap, d_pos,
                                        B, P, G, C, stream)
       : vec ? launch_sums<CD, V, false>(L, w, fmap, pos, g, d_fmap, d_pos,
                                         B, P, G, C, stream)
             : launch_sums<CD, 1, false>(L, w, fmap, pos, g, d_fmap, d_pos,
                                         B, P, G, C, stream);
  if (rc != 0 || fused || (long)B * P == 0) return rc;
  // 3. d_pos, channel loop
  scene_pool_dpos_kernel<CD><<<point_blocks(B, P), kPoolThreads, 0,
                               stream>>>(
      (const CD*)fmap, (const float*)pos, (const CD*)g, (float*)d_pos, B, P,
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

// Bytes of the gradient's workspace for these shapes.
extern "C" long long scene_pool_bwd_ws_bytes(int B, int P, int G, int C) {
  return (long long)desire::PoolWs(B, P, G, C).total;
}

// fmap (B, G, G, C) CD, pos (B, P, 2) float32, g (B, P, C) CD -> d_fmap
// (B, G, G, C) CD and d_pos (B, P, 2) float32, with ws (16-byte aligned,
// scene_pool_bwd_ws_bytes) as scratch: the bucketing, d_fmap's two levels
// and d_pos, four kernels. cudaErrorInvalidValue if G^2 cells' histogram
// does not fit in a block's shared memory or B > 65535; else
// cudaGetLastError().
extern "C" int scene_pool_bwd_launch(int is_bf16, const void* fmap,
                                     const void* pos, const void* g,
                                     void* d_fmap, void* d_pos, void* ws,
                                     int B, int P, int G, int C,
                                     void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return desire::launch_bwd<__nv_bfloat16>(fmap, pos, g, d_fmap, d_pos, ws,
                                             B, P, G, C, s);
  return desire::launch_bwd<float>(fmap, pos, g, d_fmap, d_pos, ws, B, P, G,
                                   C, s);
}
