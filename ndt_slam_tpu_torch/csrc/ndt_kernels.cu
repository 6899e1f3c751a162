// Hand-written CUDA kernels for the NDT hot loops, built for sm_90a
// (Hopper) by nvcc into a shared library with a plain C interface and
// loaded with ctypes (ndt_slam_tpu_torch/ndt/kernels.py).
//
// Each kernel replaces one Pallas TPU kernel of
// ndt_slam_tpu/ndt/pallas_kernels.py and keeps its math. Kernels 1 and
// 2 compute the point features (transformed points and their integral
// cell indices) themselves, in the operation order of the plain twin
// (compact.point_features): compiled without fast math and with
// -fmad=false, so every product and sum rounds once as the twin's
// separate tensor operations do, the window test passes exactly the
// twin's (point, cell) pairs, and each pair takes the twin's f32
// roundings and the accurate expf.
//
// No float atomics anywhere: every sum runs in a fixed order, so a
// rerun is bitwise equal. Every launcher runs on the caller's stream,
// allocates nothing, takes every scalar by value and every tensor by
// pointer (capturable in a CUDA graph), and returns cudaGetLastError()
// (0 on success).

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWinThreads = 128;   // threads a block of kernels 1 and 2
constexpr int kWinWarps = kWinThreads / 32;
constexpr int kSghValues = 12;     // sums a point feeds into kernel 1
constexpr int kSghRow = 16;        // floats a pose in kernel 1's output
constexpr int kMaxPoses = 65535;   // poses a launch of kernels 1 and 2:
                                   // the limit of gridDim.y
constexpr int kNnThreads = 128;    // threads a block of kernel 3
constexpr int kNnWarps = kNnThreads / 32;
constexpr int kNnSources = 2;      // sources a thread holds in registers
constexpr int kNnTargets = 2;      // targets a thread stages from a chunk
constexpr int kNnTile = kNnThreads * kNnSources;    // sources a block
constexpr int kNnChunk = kNnThreads * kNnTargets;   // targets a chunk
constexpr int kNnSeg = 32 * kNnTargets;             // targets a warp stages
constexpr int kNnAhead = 4;        // chunks whose mask bytes are read ahead
constexpr int kNnFinThreads = 1024;  // threads a block of its finish step
constexpr int kNnFinWarps = kNnFinThreads / 32;
constexpr int kNnFinShare = 8;     // warps that share one source's partials
constexpr int kNnFinRounds = 2;    // sources a thread takes at a time
constexpr int kNnFinAhead = 8;     // rows of partials a thread loads at once
constexpr int kNnFinStep =         // sources a block takes at a time
    kNnFinThreads / kNnFinShare * kNnFinRounds;
constexpr int kNnFinCluster = 8;   // blocks of the fitness finish, one cluster
constexpr float kBig = 1.0e12f;    // "no neighbour", the twin's BIG

// Operands shared by kernels 1 and 2, passed by value. A launch covers
// one grid shape (nx, ny, resolution, d1, d2: one loop-closure ladder
// stage) and G stacked grids of it; pose p reads grid grid_of[p] and
// source row grid_of[p] (grid 0 for every pose when grid_of is null).
struct Window {
  const float2* xy;              // [rows, n] source points, sensor frame
  const unsigned char* mask;     // [rows, n] bool
  const float* poses;            // [poses, 3] (tx, ty, theta in rad)
  const int* grid_of;            // [poses] grid of a pose, or null
  const float* origin;           // [G, 2] lower-left corner of each grid
  const float4* table;           // [G, K, 2] cells: (kx, ky, mx, my),
                                 //                  (b00, b01, b11, valid)
  const int* cell_slot;          // [G, nx*ny] table slot of a cell id, or -1
  int n, nx, ny, r, k, grids;
  int src_stride;                // points between source rows; 0: one
                                 // source shared by every pose
  float inv_res;                 // f32 reciprocal of the resolution
  float d1, neg_half_d2, md_cap, coef_scale, d2;
};

// What one pose reads: its grid and its source row.
struct GridView {
  const float2* xy;
  const unsigned char* mask;
  const float* origin;
  const float4* table;
  const int* cell_slot;
  bool ok;                       // the grid index is in [0, G)
};

__device__ __forceinline__ GridView grid_view(const Window& w, int pose) {
  const int g = w.grid_of != nullptr ? __ldg(w.grid_of + pose) : 0;
  GridView v;
  v.ok = g >= 0 && g < w.grids;
  const size_t gs = v.ok ? (size_t)g : 0;
  v.xy = w.xy + gs * w.src_stride;
  v.mask = w.mask + gs * w.src_stride;
  v.origin = w.origin + 2 * gs;
  v.table = w.table + 2 * gs * w.k;
  v.cell_slot = w.cell_slot + gs * w.nx * w.ny;
  return v;
}

// A source point under one pose: the twin's point_features.
struct Feature {
  float c, s, tx, ty;    // cos, sin of the heading; translation
  float x, y;            // the point, sensor frame
  float px, py;          // transformed point
  float fx, fy;          // its cell index (integral, or NaN / huge)
};

// The twin divides by the resolution, a host scalar, which the tensor
// library turns on the card into a product with the f32 reciprocal; a
// true division floors differently for a few points, since 0.3 is no
// power of two.
__device__ __forceinline__ Feature point_feature(const float* p, float2 q,
                                                 const float* origin,
                                                 float inv_res) {
  Feature f;
  f.tx = p[0];
  f.ty = p[1];
  f.c = cosf(p[2]);
  f.s = sinf(p[2]);
  f.x = q.x;
  f.y = q.y;
  f.px = f.c * q.x - f.s * q.y + f.tx;
  f.py = f.s * q.x + f.c * q.y + f.ty;
  f.fx = floorf((f.px - origin[0]) * inv_res);
  f.fy = floorf((f.py - origin[1]) * inv_res);
  return f;
}

// Sums of one block's threads in a fixed tree: a shuffle butterfly
// inside each warp, then the warps in order. Thread k < V of the block
// ends with the block's sum of value k. Called by every thread of a
// block of W warps.
template <int V, int W = kWinWarps>
__device__ __forceinline__ float block_sum(float (&v)[V],
                                           float (*s_warp)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) s_warp[warp][k] = v[k];
  }
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x < V) {
    for (int wp = 0; wp < W; ++wp) total += s_warp[wp][threadIdx.x];
  }
  return total;
}

// Kernels 1 and 2 -- replace _sgh_kernel (ndt_slam_tpu/ndt/
// pallas_kernels.py:106) and _score_many_kernel (:213).
//
// The TPU kernels compare every point with every table cell as a dense
// [TILE, K] mask, because a TPU has no gather. Here the window test
// |fx-kx| <= r and |fy-ky| <= r is an index lookup: one thread per
// (pose, point) computes the point's cell and visits the (2r+1)^2
// cells around it through cell_slot, dx outer and dy inner, both
// ascending. That is ascending cell id, hence ascending table slot:
// the order in which a scan of the table adds the matched pairs.
// kDerivs (kernel 1) also accumulates the gradient and Hessian terms
// and applies the pose Jacobian per point (the twin's pose_terms);
// without it (kernel 2) only E is formed. Each block reduces its
// threads' values to partials[pose][block][V]; window_sum_kernel sums the
// blocks in index order.
//
// Bound on this card: ~9 matched cells a point, ~0.3 MB a call, so
// neither bytes nor operations but latency: a dependent chain of a
// cell_slot load, two 16-byte table loads and an expf per cell, plus
// the launch itself. The design spreads the (pose, point) pairs over
// the card (16 x poses blocks for 2048 points), keeps the index and the
// table in L2 (147 KB + 64 KB), and leaves a wrapper call at two
// launches with no tensor op around them.
//
// The grid axis (loop-closure verification: G candidate keyframe grids
// of one ladder stage, up to 240 line-search poses a call) is a
// per-pose grid index and strides over the stacked tables, slot maps
// and origins, and over the source rows: blockIdx.y stays the pose, so
// the launch shape, the reduction order and, with one grid, every bit
// are those of the single-grid call. A pose whose grid index is outside
// [0, G) matches nothing.
template <bool kDerivs>
__global__ void window_kernel(Window w, float* __restrict__ partials) {
  constexpr int V = kDerivs ? kSghValues : 1;
  __shared__ float s_warp[kWinWarps][V];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int pose = blockIdx.y;
  const GridView gv = grid_view(w, pose);
  float v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = 0.f;

  if (gv.ok && i < w.n && gv.mask[i]) {
    const Feature f = point_feature(w.poses + 3 * pose, gv.xy[i], gv.origin,
                                    w.inv_res);
    // Range test in float, before the conversion: a masked slot sits at
    // 1e8 and a diverged pose may be NaN or inf (every comparison with
    // NaN is false).
    const float r = (float)w.r;
    if (f.fx >= -r && f.fx <= (float)(w.nx - 1) + r &&
        f.fy >= -r && f.fy <= (float)(w.ny - 1) + r) {
      const int cx = (int)f.fx, cy = (int)f.fy;
      float se = 0.f, sw = 0.f, gqx = 0.f, gqy = 0.f;
      float h00 = 0.f, h01 = 0.f, h11 = 0.f;
      for (int dx = -w.r; dx <= w.r; ++dx) {
        const int gx = cx + dx;
        if (gx < 0 || gx >= w.nx) continue;
        for (int dy = -w.r; dy <= w.r; ++dy) {
          const int gy = cy + dy;
          if (gy < 0 || gy >= w.ny) continue;
          const int slot = __ldg(gv.cell_slot + gx * w.ny + gy);
          if (slot < 0) continue;
          const float4 t0 = __ldg(gv.table + 2 * slot);
          const float4 t1 = __ldg(gv.table + 2 * slot + 1);
          const float qx = f.px - t0.z;
          const float qy = f.py - t0.w;
          const float b00 = t1.x, b01 = t1.y, b11 = t1.z;
          const float bqx = b00 * qx + b01 * qy;
          const float bqy = b01 * qx + b11 * qy;
          const float md = qx * bqx + qy * bqy;
          const float e = expf(w.neg_half_d2 * fminf(md, w.md_cap));
          se += e;
          if constexpr (kDerivs) {
            const float coef = w.coef_scale * e;
            sw += 1.f;
            gqx += coef * bqx;
            gqy += coef * bqy;
            h00 += coef * (b00 - w.d2 * bqx * bqx);
            h01 += coef * (b01 - w.d2 * bqx * bqy);
            h11 += coef * (b11 - w.d2 * bqy * bqy);
          }
        }
      }
      v[0] = w.d1 * se;
      if constexpr (kDerivs) {
        // the twin's pose_terms, per point
        const float a = -f.s * f.x - f.c * f.y;
        const float b = f.c * f.x - f.s * f.y;
        const float d2x = -(f.px - f.tx);
        const float d2y = -(f.py - f.ty);
        v[1] = sw;
        v[2] = gqx;
        v[3] = gqy;
        v[4] = a * gqx + b * gqy;
        v[5] = h00;
        v[6] = h01;
        v[7] = a * h00 + b * h01;
        v[8] = h11;
        v[9] = a * h01 + b * h11;
        v[10] = a * a * h00 + 2.0f * a * b * h01 + b * b * h11;
        v[11] = gqx * d2x + gqy * d2y;
      }
    }
  }
  const float total = block_sum<V>(v, s_warp);
  if (threadIdx.x < V)
    partials[(pose * gridDim.x + blockIdx.x) * V + threadIdx.x] = total;
}

// Where each float of kernel 1's output row comes from: E, matched,
// grad[3], the symmetric hess[3][3] row-major, two floats of padding.
// Sums 10 and 11 are the two parts of h22 (rotation, translation).
__constant__ int kSghRowSource[kSghRow] = {0, 1, 2, 3, 4, 5, 6, 7,
                                           6, 8, 9, 7, 9, 10, -1, -1};

// Second launch of kernels 1 and 2: one block per pose sums the
// per-block partials [poses][blocks][values] in block order. values ==
// 1 writes out[pose] (kernel 2); values == kSghValues writes the pose's
// output row (kernel 1).
__global__ void window_sum_kernel(const float* __restrict__ partials,
                              float* __restrict__ out, int blocks,
                              int values) {
  __shared__ float s_sum[kSghRow];
  const int pose = blockIdx.x, k = threadIdx.x;
  float acc = 0.f;
  if (k < values) {
    const float* p = partials + (size_t)pose * blocks * values + k;
    for (int b = 0; b < blocks; ++b) acc += p[(size_t)b * values];
  }
  if (values == 1) {
    if (k == 0) out[pose] = acc;
    return;
  }
  s_sum[k] = acc;
  __syncthreads();
  const int src = kSghRowSource[k];
  float val = src < 0 ? 0.f : s_sum[src];
  if (src == 10) val += s_sum[11];
  out[pose * kSghRow + k] = val;
}

// The features kernels 1 and 2 compute, written out as [poses, n, 4] =
// (px, py, fx, fy) so that a check can hold them bit for bit against
// the twin's point_features. Not on any hot path.
__global__ void features_kernel(Window w, float4* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w.n) return;
  const Feature f = point_feature(w.poses + 3 * blockIdx.y, w.xy[i],
                                  w.origin, w.inv_res);
  out[blockIdx.y * w.n + i] = make_float4(f.px, f.py, f.fx, f.fy);
}

// Launched alone to time what a launch costs on this card.
__global__ void empty_kernel() {}

// Kernel 3 -- replaces _nn_kernel (pallas_kernels.py:303).
// Brute-force nearest neighbour in the difference form (dx*dx + dy*dy,
// no |s|^2+|t|^2-2s.t cancellation): for each source slot the least
// squared distance to a valid target, a masked target as 1e12; the
// finish step clamps at 0, puts 1e12 for a masked source and, in
// fitness mode, takes the mean over the valid sources. The TPU kernel
// walks a dense [TILE, chunk] block of every (source, target) slot and
// carries the running minimum in the output block across its
// sequential grid axis. Here:
//
// What bounds it on this card. At low fill (a young map: ~160 live of
// 2048 sources, ~6000 live of 131072 targets, under a million live
// pairs) neither bytes nor operations: the live work is microseconds
// and the cost is the two launches, the mask bytes every block has to
// look at, and the one staged chunk a thread walks alone. At full fill
// (2048 x 131072 live) it is operations: 2 sub, 2 mul, 1 add, 1 min a
// pair without FMA, 1.6e9 f32 instructions a call against the card's
// issue rate of SMs x 128 lanes a clock, plus the shared-memory loads
// that feed them.
//
// What the design does about each.
// - The operands as the callers hold them: [n, 2] and [m, 2] points as
//   float2, the masks as bytes. No cast, stack or copy before the
//   launch.
// - Live pairs only. A block reads the target mask bytes of a chunk,
//   kNnTargets a thread and byte by byte, so a mask may start at any
//   address (a sliced view) and end anywhere (a 16-byte read a thread
//   would make a chunk 2048 targets, which one block then walks alone:
//   measured four times slower on a young map), and each warp compacts
//   its live targets into its own segment of shared memory by ballot
//   and popcount. A chunk without a live target costs
//   its mask bytes and nothing else; a source tile without a live
//   source leaves at once and a warp without one skips the pair loop.
//   The mask bytes of kNnAhead chunks are read together, so that a run
//   of dead chunks costs one memory latency, not one each.
// - A live prefix spread over the card. Chunks are small and dealt
//   round-robin: block b of B takes chunks b, b+B, ..., so the live
//   prefix of a registration target lands on every block. Arbitrary
//   masks (the scattered candidate mask of the dynamic-removal pass)
//   take the same path.
// - Sources tiled in registers. A thread holds kNnSources sources, so
//   one 8-byte shared-memory load (a broadcast) serves that many pairs
//   and the inner loop has no mask test. Two sources a thread and 256
//   targets a chunk: a real scan fills ~200 of the 2048 source slots,
//   all in the first tile, so the time of a call is the time one thread
//   needs for its share of the live targets, which grows with both; 4
//   sources and 512 targets a chunk measured 8 % faster when every slot
//   is live and up to twice as slow on a real scan.
// - The staged chunk is double-buffered: one barrier a chunk.
// - The twin's NaN rule. fminf drops a NaN where the twin's minimum
//   carries it, so the pair loop has a second form that carries it,
//   taken from the first chunk on in which a warp holds a live source
//   or a chunk a live target that is not finite (finite operands cannot
//   make a NaN).
// - No float atomics, no counter kept between calls: the block
//   partials [B, n] go to a second launch, nn_finish_kernel, which
//   takes the minimum over them (exact in any order), clamps, applies
//   the source mask and, in fitness mode, sums in a fixed order.
//
// Two variants for loop-closure verification, which holds B candidate
// keyframes at a time:
// - A batch axis (blockIdx.z): B independent problems, each its own
//   sources, targets and masks at [B, n] / [B, m] strides, one launch
//   pair for all. B = 1 is the single call, bit for bit.
// - The argmin form (kArgmin), for the trimmed ICP (ndt_slam_tpu/ndt/
//   icp.py:43-86): the index of the nearest target rides beside its
//   coordinates in the staged segment and beside the distance in
//   registers and in the block partials. A pair replaces the best one
//   when its distance is lower or, on an equal distance, its target
//   index is lower (nn_better), so the result is the lowest-index
//   nearest target whatever order the chunks, the warps' ballot
//   compaction and the blocks deliver the pairs in: JAX's argmin inside
//   a chunk and its strict < across chunks give the same target. A NaN
//   distance wins and stays, the lowest-index NaN among several. The
//   running best starts at +inf rather than 1e12, so a live target
//   farther than 1e12 still names the index; the finish step caps the
//   distance at 1e12 as the distance form does, so the distances equal
//   that form's bit for bit. A masked source, and a source without a
//   live target, get index 0.

// best[s] = min(best[s], |src_s - t|^2) over the targets of one staged
// segment. kCarryNan: a NaN distance wins and stays, as in the twin.
template <bool kCarryNan>
__device__ __forceinline__ void nn_pairs(const float2* __restrict__ seg,
                                         int count,
                                         const float (&sx)[kNnSources],
                                         const float (&sy)[kNnSources],
                                         float (&best)[kNnSources]) {
#pragma unroll 4
  for (int j = 0; j < count; ++j) {
    const float2 t = seg[j];
#pragma unroll
    for (int s = 0; s < kNnSources; ++s) {
      const float dx = sx[s] - t.x;
      const float dy = sy[s] - t.y;
      const float d2 = dx * dx + dy * dy;
      if constexpr (kCarryNan)
        best[s] = (d2 < best[s] || d2 != d2) ? d2 : best[s];
      else
        best[s] = fminf(best[s], d2);
    }
  }
}

// Does (d2, j) replace (best, bj) in the argmin form? The lower
// distance, on a tie the lower index; kCarryNan: a NaN beats every
// number and, among NaNs, the lower index wins.
template <bool kCarryNan>
__device__ __forceinline__ bool nn_better(float d2, int j, float best,
                                          int bj) {
  if constexpr (kCarryNan) {
    if (d2 != d2) return best == best || j < bj;
    if (best != best) return false;
  }
  return d2 < best || (d2 == best && j < bj);
}

// nn_pairs of the argmin form: seg_j holds the targets' indices.
template <bool kCarryNan>
__device__ __forceinline__ void nn_pairs_argmin(
    const float2* __restrict__ seg, const int* __restrict__ seg_j,
    int count, const float (&sx)[kNnSources], const float (&sy)[kNnSources],
    float (&best)[kNnSources], int (&bidx)[kNnSources]) {
#pragma unroll 4
  for (int j = 0; j < count; ++j) {
    const float2 t = seg[j];
    const int tj = seg_j[j];
#pragma unroll
    for (int s = 0; s < kNnSources; ++s) {
      const float dx = sx[s] - t.x;
      const float dy = sy[s] - t.y;
      const float d2 = dx * dx + dy * dy;
      if (nn_better<kCarryNan>(d2, tj, best[s], bidx[s])) {
        best[s] = d2;
        bidx[s] = tj;
      }
    }
  }
}

__device__ __forceinline__ bool not_finite(float v) {
  return !(fabsf(v) < INFINITY);
}

// Bit e of the result: target j0 + e is inside [0, m) and its mask
// byte is set.
__device__ __forceinline__ unsigned live_bits(
    const unsigned char* __restrict__ mask, int j0, int m) {
  unsigned bits = 0;
#pragma unroll
  for (int e = 0; e < kNnTargets; ++e)
    if (j0 + e < m && __ldg(mask + j0 + e)) bits |= 1u << e;
  return bits;
}

// First launch. grid (B, source tiles, batch), kNnThreads threads,
// kNnSources sources and kNnTargets targets of a chunk a thread. Each
// batch row reads src [n], src_mask [n], tgt [m], tgt_mask [m] at its
// own offset and writes its own part, part_idx and live. part [B, n]:
// the block's minimum for each source of its tile (kArgmin: part_idx
// [B, n], the index that goes with it). live [tiles, B]: the live
// targets the block met, or -1 where the tile had no live source and
// the block left without looking.
template <bool kArgmin>
__global__ void __launch_bounds__(kNnThreads)
nn_kernel(const float2* __restrict__ src,
          const unsigned char* __restrict__ src_mask,
          const float2* __restrict__ tgt,
          const unsigned char* __restrict__ tgt_mask,
          float* __restrict__ part, int* __restrict__ part_idx,
          int* __restrict__ live, int n, int m) {
  constexpr int S = kNnSources, E = kNnTargets;
  __shared__ float2 s_t[2][kNnChunk];
  __shared__ int s_j[2][kArgmin ? kNnChunk : 1];
  __shared__ int s_count[2][kNnWarps];
  __shared__ int s_bad[2][kNnWarps];
  const unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = (blockIdx.y * kNnThreads + threadIdx.x) * S;
  {
    const size_t row = blockIdx.z;
    src += row * n;
    src_mask += row * n;
    tgt += row * m;
    tgt_mask += row * m;
    part += row * gridDim.x * n;
    if constexpr (kArgmin) part_idx += row * gridDim.x * n;
    live += row * gridDim.y * gridDim.x;
  }

  float sx[S], sy[S], best[S];
  int bidx[S];
  bool src_live = false, src_bad = false;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = i0 + s;
    sx[s] = 0.f;
    sy[s] = 0.f;
    best[s] = kArgmin ? INFINITY : kBig;
    bidx[s] = INT_MAX;
    if (i < n) {
      const float2 q = src[i];
      sx[s] = q.x;
      sy[s] = q.y;
      if (src_mask[i]) {
        src_live = true;
        src_bad |= not_finite(q.x) || not_finite(q.y);
      }
    }
  }
  if (!__syncthreads_or(src_live)) {
    if (threadIdx.x == 0) live[blockIdx.y * gridDim.x + blockIdx.x] = -1;
    return;
  }
  const bool warp_live = __any_sync(kFull, src_live);
  const bool warp_bad = __any_sync(kFull, src_bad);

  // chunks dealt round-robin: block b of B takes b, b + B, ...
  const int chunks = (m + kNnChunk - 1) / kNnChunk;
  int met = 0;
  int buf = 0;
  // the NaN-carrying pair loop from the first chunk on that needs it:
  // fminf would drop a NaN that `best` already holds
  bool carry = warp_bad;
  for (int c0 = blockIdx.x; c0 < chunks; c0 += kNnAhead * gridDim.x) {
    // the mask bytes of the next few chunks, their loads in flight
    // together: most chunks of a young map hold no live target
    unsigned ahead[kNnAhead];
#pragma unroll
    for (int g = 0; g < kNnAhead; ++g) {
      const int c = c0 + g * gridDim.x;
      ahead[g] = c < chunks
                     ? live_bits(tgt_mask, c * kNnChunk + threadIdx.x * E, m)
                     : 0u;
    }
#pragma unroll
    for (int g = 0; g < kNnAhead; ++g) {
      const int c = c0 + g * gridDim.x;
      if (c >= chunks) break;
      const int j0 = c * kNnChunk + threadIdx.x * E;
      float2* seg = s_t[buf] + warp * kNnSeg;
      int* seg_j = s_j[buf] + (kArgmin ? warp * kNnSeg : 0);
      float2 t[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        t[e] = make_float2(0.f, 0.f);
        if ((ahead[g] >> e) & 1u) t[e] = tgt[j0 + e];
      }
      int count = 0;
      bool bad = false;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const bool on = (ahead[g] >> e) & 1u;
        const unsigned vote = __ballot_sync(kFull, on);
        if (on) {
          const int at = count + __popc(vote & ((1u << lane) - 1u));
          seg[at] = t[e];
          if constexpr (kArgmin) seg_j[at] = j0 + e;
        }
        bad |= not_finite(t[e].x) || not_finite(t[e].y);
        count += __popc(vote);
      }
      bad = __any_sync(kFull, bad);
      if (lane == 0) {
        s_count[buf][warp] = count;
        s_bad[buf][warp] = bad;
      }
      // One barrier a chunk: this chunk is staged in s_t[buf] while a
      // slower thread may still read s_t[buf ^ 1]; nobody writes that
      // one again before passing the next barrier.
      __syncthreads();
      int total = 0;
#pragma unroll
      for (int w = 0; w < kNnWarps; ++w) {
        carry |= s_bad[buf][w] != 0;
        total += s_count[buf][w];
      }
      met += total;
      if (warp_live && total > 0) {
#pragma unroll
        for (int w = 0; w < kNnWarps; ++w) {
          const float2* from = s_t[buf] + w * kNnSeg;
          if constexpr (kArgmin) {
            const int* from_j = s_j[buf] + w * kNnSeg;
            if (carry)
              nn_pairs_argmin<true>(from, from_j, s_count[buf][w], sx, sy,
                                    best, bidx);
            else
              nn_pairs_argmin<false>(from, from_j, s_count[buf][w], sx, sy,
                                     best, bidx);
          } else if (carry) {
            nn_pairs<true>(from, s_count[buf][w], sx, sy, best);
          } else {
            nn_pairs<false>(from, s_count[buf][w], sx, sy, best);
          }
        }
      }
      buf ^= 1;
    }
  }
  if (threadIdx.x == 0) live[blockIdx.y * gridDim.x + blockIdx.x] = met;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (i0 + s < n) {
      part[(size_t)blockIdx.x * n + i0 + s] = best[s];
      if constexpr (kArgmin)
        part_idx[(size_t)blockIdx.x * n + i0 + s] = bidx[s];
    }
  }
}

// The twin's minimum: a NaN on either side wins.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}

// Second launch of kernel 3, kNnFinThreads threads. A warp reads 32
// neighbouring sources of one row of the partials [B, n] as one line;
// kNnFinShare warps share the rows of the same sources (warp w takes
// rows w % 8, w % 8 + 8, ...) and meet in shared memory; a thread takes
// kNnFinRounds sources at a time, so a block takes 256 a step. Inside a
// live warp the loads are unconditional (a lane without a live source
// reads column 0 and drops it: a branch around each load would put it
// and its use into a basic block of their own, one L2 latency after the
// other). d2_out
// [n] (may be null): minimum over the partials, clamped at 0, 1e12 for
// a masked source. kFitness (launched as one cluster of kNnFinCluster
// blocks): fit_out[0] = the mean of d2 over the live sources, or 1e12
// with no live source or no live target (n_live entries of `live`, any
// > 0). The sum runs per thread in step order, then through block_sum,
// then over the cluster's blocks in rank order, read by block 0 from
// their shared memory: a fixed order, no atomics, no third launch.
template <bool kFitness>
__global__ void __launch_bounds__(kNnFinThreads)
nn_finish_kernel(const float* __restrict__ part,
                 const int* __restrict__ live,
                 const unsigned char* __restrict__ src_mask,
                 float* __restrict__ d2_out, float* __restrict__ fit_out,
                 int n, int blocks, int n_live) {
  constexpr int kPerRound = kNnFinThreads / kNnFinShare;   // 128 sources
  if constexpr (!kFitness) {   // the batch row: blockIdx.y
    const size_t row = blockIdx.y;
    part += row * blocks * n;
    src_mask += row * n;
    d2_out += row * n;
  }
  __shared__ float s_min[kNnFinRounds][kNnFinShare][kPerRound];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = warp % kNnFinShare;
  const int slot = warp / kNnFinShare * 32 + lane;   // source of the round
  float v[3] = {0.f, 0.f, 0.f};   // sum of d2, live sources, live targets
  for (int base = blockIdx.x * kNnFinStep; base < n;
       base += gridDim.x * kNnFinStep) {
    int idx[kNnFinRounds];
    bool on[kNnFinRounds];
    float best[kNnFinRounds];
#pragma unroll
    for (int q = 0; q < kNnFinRounds; ++q) {
      idx[q] = base + q * kPerRound + slot;
      on[q] = idx[q] < n && __ldg(src_mask + min(idx[q], n - 1));
      best[q] = kBig;
    }
    // A warp without a live source skips the rows. The others walk
    // them by pointer (the address arithmetic of 1024 threads, not the
    // loads, was what this kernel spent its time on), kNnFinAhead rows a
    // pass with every load issued before the first use.
    bool any_on = false;
#pragma unroll
    for (int q = 0; q < kNnFinRounds; ++q) any_on |= on[q];
    if (__any_sync(0xffffffffu, any_on)) {
      const size_t stride = (size_t)kNnFinShare * n;
      const float* p[kNnFinRounds];
#pragma unroll
      for (int q = 0; q < kNnFinRounds; ++q)
        p[q] = part + (size_t)sub * n + (on[q] ? idx[q] : 0);
      int b = sub;
      for (; b + (kNnFinAhead - 1) * kNnFinShare < blocks;
           b += kNnFinAhead * kNnFinShare) {
        float row[kNnFinAhead][kNnFinRounds];
#pragma unroll
        for (int u = 0; u < kNnFinAhead; ++u) {
#pragma unroll
          for (int q = 0; q < kNnFinRounds; ++q)
            row[u][q] = __ldg(p[q] + u * stride);
        }
#pragma unroll
        for (int q = 0; q < kNnFinRounds; ++q) {
          p[q] += kNnFinAhead * stride;
#pragma unroll
          for (int u = 0; u < kNnFinAhead; ++u)
            best[q] = nan_min(best[q], row[u][q]);
        }
      }
      for (; b < blocks; b += kNnFinShare) {
#pragma unroll
        for (int q = 0; q < kNnFinRounds; ++q) {
          best[q] = nan_min(best[q], __ldg(p[q]));
          p[q] += stride;
        }
      }
    }
    __syncthreads();   // the step before has been read
#pragma unroll
    for (int q = 0; q < kNnFinRounds; ++q) s_min[q][sub][slot] = best[q];
    __syncthreads();
    if (sub == 0) {
#pragma unroll
      for (int q = 0; q < kNnFinRounds; ++q) {
        float d2 = best[q];
#pragma unroll
        for (int w = 1; w < kNnFinShare; ++w)
          d2 = nan_min(d2, s_min[q][w][slot]);
        d2 = d2 < 0.f ? 0.f : d2;   // a NaN stays
        d2 = on[q] ? d2 : kBig;
        v[0] += on[q] ? d2 : 0.f;
        v[1] += on[q] ? 1.f : 0.f;
        if (idx[q] < n && d2_out != nullptr) d2_out[idx[q]] = d2;
      }
    }
  }
  if constexpr (kFitness) {
    namespace cg = cooperative_groups;
    __shared__ float s_warp[kNnFinWarps][3];
    __shared__ float s_total[3];
    cg::cluster_group cluster = cg::this_cluster();
    for (int k = blockIdx.x * kNnFinThreads + threadIdx.x; k < n_live;
         k += gridDim.x * kNnFinThreads)
      v[2] += live[k] > 0 ? 1.f : 0.f;
    const float total = block_sum<3, kNnFinWarps>(v, s_warp);
    if (threadIdx.x < 3) s_total[threadIdx.x] = total;
    cluster.sync();
    if (cluster.block_rank() == 0 && threadIdx.x == 0) {
      float sum = 0.f, count = 0.f, targets = 0.f;
      for (unsigned r = 0; r < cluster.num_blocks(); ++r) {
        const float* theirs = cluster.map_shared_rank(s_total, r);
        sum += theirs[0];
        count += theirs[1];
        targets += theirs[2];
      }
      const float mean = sum / fmaxf(count, 1.f);
      fit_out[0] = (count > 0.f && targets > 0.f) ? mean : kBig;
    }
    cluster.sync();   // the others' shared memory lives until it is read
  }
}

// Second launch of the argmin form, kNnArgThreads threads, grid
// (source blocks, batch): one thread a source takes the best (distance,
// index) over the block partials by nn_better (a NaN carried), caps the
// distance at 1e12, clamps it at 0 and applies the source mask. The
// partials are few (the blocks of one source tile), so a plain loop.
constexpr int kNnArgThreads = 256;

__global__ void __launch_bounds__(kNnArgThreads)
nn_argmin_finish_kernel(const float* __restrict__ part,
                        const int* __restrict__ part_idx,
                        const unsigned char* __restrict__ src_mask,
                        float* __restrict__ d2_out, int* __restrict__ idx_out,
                        int n, int blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t row = blockIdx.y;
  const size_t at = row * n + i;
  const bool on = src_mask[at];
  float best = INFINITY;
  int bj = INT_MAX;
  if (on) {
    const float* p = part + row * blocks * n + i;
    const int* q = part_idx + row * blocks * n + i;
    for (int b = 0; b < blocks; ++b) {
      const float d = __ldg(p + (size_t)b * n);
      const int j = __ldg(q + (size_t)b * n);
      if (nn_better<true>(d, j, best, bj)) {
        best = d;
        bj = j;
      }
    }
  }
  float d2 = nan_min(kBig, best);
  d2 = d2 < 0.f ? 0.f : d2;   // a NaN stays
  d2_out[at] = on ? d2 : kBig;
  idx_out[at] = (on && bj != INT_MAX) ? bj : 0;
}

// Both launches of kernel 1 (derivs) or kernel 2 on `stream`.
int window_launch(const Window& w, int poses, bool derivs, float* partials,
                  float* out, void* stream) {
  if (poses < 1 || poses > kMaxPoses || w.n < 0 || w.r < 0 || w.grids < 1 ||
      w.src_stride < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (w.n + kWinThreads - 1) / kWinThreads;
  if (blocks > 0) {
    const dim3 grid(blocks, poses);
    if (derivs)
      window_kernel<true><<<grid, kWinThreads, 0, st>>>(w, partials);
    else
      window_kernel<false><<<grid, kWinThreads, 0, st>>>(w, partials);
  }
  window_sum_kernel<<<poses, kSghRow, 0, st>>>(partials, out, blocks,
                                           derivs ? kSghValues : 1);
  return (int)cudaGetLastError();
}

Window make_window(const float* xy, const unsigned char* mask,
                   const float* poses, const int* grid_of,
                   const float* origin, const float* table,
                   const int* cell_slot, int n, int nx, int ny, int r, int k,
                   int grids, int src_stride, float inv_res, float d1,
                   float neg_half_d2, float md_cap, float coef_scale,
                   float d2) {
  return Window{(const float2*)xy, mask, poses, grid_of, origin,
                (const float4*)table, cell_slot, n, nx, ny, r, k, grids,
                src_stride, inv_res, d1, neg_half_d2, md_cap, coef_scale,
                d2};
}

}  // namespace

extern "C" {

// out [poses, 16]; partials [poses, ceil(n / 128), 12] scratch.
// grid_of [poses] (null: every pose on grid 0); origin [grids, 2], table
// [grids, k, 8], cell_slot [grids, nx*ny]; xy [rows, n, 2] and mask
// [rows, n] with rows src_stride / n apart (src_stride 0: one source).
int ndt_sgh(const float* xy, const unsigned char* mask, const float* poses,
            const int* grid_of, const float* origin, const float* table,
            const int* cell_slot, float* partials, float* out, int n,
            int n_poses, int nx, int ny, int r, int k, int grids,
            int src_stride, float inv_res, float d1, float neg_half_d2,
            float md_cap, float coef_scale, float d2, void* stream) {
  const Window w = make_window(xy, mask, poses, grid_of, origin, table,
                               cell_slot, n, nx, ny, r, k, grids, src_stride,
                               inv_res, d1, neg_half_d2, md_cap, coef_scale,
                               d2);
  return window_launch(w, n_poses, true, partials, out, stream);
}

// out [poses]; partials [poses, ceil(n / 128)] scratch; the operands as
// for ndt_sgh.
int ndt_score_many(const float* xy, const unsigned char* mask,
                   const float* poses, const int* grid_of,
                   const float* origin, const float* table,
                   const int* cell_slot, float* partials, float* out, int n,
                   int n_poses, int nx, int ny, int r, int k, int grids,
                   int src_stride, float inv_res, float d1,
                   float neg_half_d2, float md_cap, void* stream) {
  const Window w = make_window(xy, mask, poses, grid_of, origin, table,
                               cell_slot, n, nx, ny, r, k, grids, src_stride,
                               inv_res, d1, neg_half_d2, md_cap, 0.f, 0.f);
  return window_launch(w, n_poses, false, partials, out, stream);
}

// out [poses, n, 4] = (px, py, fx, fy).
int ndt_features(const float* xy, const float* poses, const float* origin,
                 float* out, int n, int n_poses, float inv_res,
                 void* stream) {
  if (n > 0 && n_poses > 0) {
    Window w{};
    w.xy = (const float2*)xy;
    w.poses = poses;
    w.origin = origin;
    w.n = n;
    w.inv_res = inv_res;
    const dim3 grid((n + kWinThreads - 1) / kWinThreads, n_poses);
    features_kernel<<<grid, kWinThreads, 0, (cudaStream_t)stream>>>(
        w, (float4*)out);
  }
  return (int)cudaGetLastError();
}

int ndt_empty(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// Kernel 3, both launches on `stream`, over `batch` rows: src [batch,
// n, 2], src_mask [batch, n], tgt [batch, m, 2], tgt_mask [batch, m].
// part [batch, blocks, n] and live [batch, tiles, blocks] are scratch,
// tiles = ceil(n / ndt_nn_tile()); part_idx [batch, blocks, n] too for
// the argmin form. Out: d2_out [batch, n]; with idx_out [batch, n] not
// null also the index of the nearest live target (the argmin form);
// with fit_out [1] not null (batch 1, no index) the fitness mean
// instead of d2. blocks: the blocks that share the target chunks of one
// source tile.
int ndt_nn(const float* src, const unsigned char* src_mask, const float* tgt,
           const unsigned char* tgt_mask, float* part, int* part_idx,
           int* live, float* d2_out, int* idx_out, float* fit_out, int n,
           int m, int batch, int blocks, void* stream) {
  if (n < 1 || m < 1 || blocks < 1 || batch < 1 || batch > 65535 ||
      (fit_out != nullptr && (batch != 1 || idx_out != nullptr)) ||
      (idx_out != nullptr && (part_idx == nullptr || d2_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (n + kNnTile - 1) / kNnTile;
  const dim3 grid(blocks, tiles, batch);
  if (idx_out != nullptr) {
    nn_kernel<true><<<grid, kNnThreads, 0, st>>>(
        (const float2*)src, src_mask, (const float2*)tgt, tgt_mask, part,
        part_idx, live, n, m);
    nn_argmin_finish_kernel<<<dim3((n + kNnArgThreads - 1) / kNnArgThreads,
                                   batch),
                              kNnArgThreads, 0, st>>>(
        part, part_idx, src_mask, d2_out, idx_out, n, blocks);
    return (int)cudaGetLastError();
  }
  nn_kernel<false><<<grid, kNnThreads, 0, st>>>(
      (const float2*)src, src_mask, (const float2*)tgt, tgt_mask, part,
      nullptr, live, n, m);
  if (fit_out != nullptr) {
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = kNnFinCluster;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(kNnFinCluster);
    config.blockDim = dim3(kNnFinThreads);
    config.stream = st;
    config.attrs = &cluster;
    config.numAttrs = 1;
    const cudaError_t rc = cudaLaunchKernelEx(
        &config, nn_finish_kernel<true>, (const float*)part,
        (const int*)live, src_mask, d2_out, fit_out, n, blocks,
        tiles * blocks);
    if (rc != cudaSuccess) return (int)rc;
  } else {
    nn_finish_kernel<false><<<dim3((n + kNnFinStep - 1) / kNnFinStep, batch),
                              kNnFinThreads, 0, st>>>(
        part, live, src_mask, d2_out, fit_out, n, blocks, tiles * blocks);
  }
  return (int)cudaGetLastError();
}

int ndt_window_threads() { return kWinThreads; }
int ndt_max_poses() { return kMaxPoses; }
int ndt_nn_tile() { return kNnTile; }
int ndt_nn_chunk() { return kNnChunk; }

}  // extern "C"
