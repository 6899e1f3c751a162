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
constexpr int kNewtonThreads = 1024;  // threads a block (a row) of the
                                      // Newton kernel
constexpr int kNewtonWarps = kNewtonThreads / 32;
constexpr int kCands = 12;         // line-search poses an iteration:
                                   // 6 scales x 2 directions
// solve.py's _LS_SCALES; candidate j takes scale j / 2 and direction
// j % 2 (the damped Newton step, the steepest descent)
__constant__ float kLsScales[kCands / 2] = {1.0f, 0.5f, 0.25f, 0.1f, 0.04f,
                                            0.015f};

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
// c, s: cosf and sinf of the heading, computed once a pose by the
// callers that visit many points under it.
__device__ __forceinline__ Feature point_feature(float tx, float ty, float c,
                                                 float s, float2 q,
                                                 const float* origin,
                                                 float inv_res) {
  Feature f;
  f.tx = tx;
  f.ty = ty;
  f.c = c;
  f.s = s;
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
template <int V>
__device__ __forceinline__ void warp_sum(float (&v)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
}

template <int V, int W = kWinWarps>
__device__ __forceinline__ float block_sum(float (&v)[V],
                                           float (*s_warp)[V]) {
  warp_sum<V>(v);
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

// One (pose, point) pair of kernels 1 and 2 and of the Newton kernel,
// the point's feature f given: the (2r+1)^2 window cells around its
// cell, dx outer and dy inner, both ascending. v (zeros on entry) takes
// the pair's values, left at 0 where the point's cell lies off the
// window's range. Every kernel that scores a pose goes through here, so
// a pair's bits are the same in all of them. The table and slot map are
// read through the read-only cache.
template <bool kDerivs>
__device__ __forceinline__ void window_visit(
    const Window& w, const GridView& gv, const Feature& f,
    float (&v)[kDerivs ? kSghValues : 1]) {
  // Range test in float, before the conversion: a masked slot sits at
  // 1e8 and a diverged pose may be NaN or inf (every comparison with
  // NaN is false).
  const float r = (float)w.r;
  if (!(f.fx >= -r && f.fx <= (float)(w.nx - 1) + r &&
        f.fy >= -r && f.fy <= (float)(w.ny - 1) + r))
    return;
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
    const float* p = w.poses + 3 * pose;
    const Feature f = point_feature(p[0], p[1], cosf(p[2]), sinf(p[2]),
                                    gv.xy[i], gv.origin, w.inv_res);
    window_visit<kDerivs>(w, gv, f, v);
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
  const float* p = w.poses + 3 * blockIdx.y;
  const Feature f = point_feature(p[0], p[1], cosf(p[2]), sinf(p[2]),
                                  w.xy[i], w.origin, w.inv_res);
  out[blockIdx.y * w.n + i] = make_float4(f.px, f.py, f.fx, f.fy);
}

// The Newton kernel's operands beyond the Window: the loop's settings
// and the row outputs (every field of ndt/solve.py's NDTResult).
struct Newton {
  int max_iterations;
  bool matvec;               // one pose a call (no grid index): _solve3's
                             // matrix-vector form
  float step_size, trans_eps;
  float* pose;               // [rows, 3]
  int* iterations;           // [rows]
  unsigned char* usable;     // [rows] bool
  float* objective;          // [rows]
  float* hessian;            // [rows, 3, 3]
  float* matched;            // [rows]
};

// torch's elementwise operations where C's differ: a clamp and a
// maximum that carry a NaN (fmaxf / fminf drop it), isfinite.
__device__ __forceinline__ float t_clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float t_clamp_max(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}
__device__ __forceinline__ float t_maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ bool t_finite(float v) {
  return fabsf(v) < INFINITY;
}

// torch.linalg.vector_norm of a 3-vector on the card: its reduction
// splits the 3 elements over two lanes (lane 0 takes elements 0 and 2,
// lane 1 element 1) and adds the lanes after, each square rounded once.
__device__ __forceinline__ float t_norm3(float a, float b, float c) {
  return sqrtf((a * a + c * c) + b * b);
}

// solve.py's _clamp_norm of one 3-vector: v scaled to a norm of at most
// step_size.
__device__ __forceinline__ void t_clamp_norm(const float (&v)[3],
                                             float step_size,
                                             float (&out)[3]) {
  const float nrm = t_norm3(v[0], v[1], v[2]);
  const float ratio = t_clamp_max(nrm, step_size) / t_clamp_min(nrm, 1e-12f);
#pragma unroll
  for (int a = 0; a < 3; ++a) out[a] = v[a] * ratio;
}

// One Newton iteration's two search directions from kernel 1's sums s
// (E, matched, grad[3], the Hessian's parts as window_sum_kernel reads
// them): solve.py's _sym3_eig_bounds, the Levenberg ridge, _solve3,
// the non-finite guard, then _clamp_norm of the damped Newton step and
// of the steepest descent. Written out as the stepwise loop runs it in
// torch, one rounding an operation: a division by a host scalar is
// torch's product with the f32 reciprocal, x * 0 and x - 0 are kept
// (they turn inf into NaN and -0 into +0 there too). _solve3 takes two
// forms there: rows write the products out; one pose takes torch's
// [3,3] @ [3] on the card, which rounds as fma(a1, b1, a0 * b0) + a2 *
// b2 (matvec; probed on 20000 random products of wide range, every bit
// equal).
__device__ __noinline__ void newton_directions(const float* s,
                                               float step_size, bool matvec,
                                               float (&dirs)[2][3]) {
  constexpr float kThird = 1.f / 3.f;
  constexpr float kSixth = 1.f / 6.f;
  constexpr float kTwoPiThirds = (float)(2.0 * 3.141592653589793 / 3.0);
  const float g[3] = {s[2], s[3], s[4]};
  const float H[3][3] = {{s[5], s[6], s[7]},
                         {s[6], s[8], s[9]},
                         {s[7], s[9], s[10] + s[11]}};
  // _sym3_eig_bounds: Smith's closed form
  const float q = ((H[0][0] + H[1][1]) + H[2][2]) * kThird;
  const float p1 = (H[0][1] * H[0][1] + H[0][2] * H[0][2]) + H[1][2] * H[1][2];
  const float a0 = H[0][0] - q, a1 = H[1][1] - q, a2 = H[2][2] - q;
  const float p2 = ((a0 * a0 + a1 * a1) + a2 * a2) + 2.0f * p1;
  const float p = sqrtf(t_clamp_min(p2 * kSixth, 0.f));
  const float safe_p = t_clamp_min(p, 1e-20f);
  float B[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      B[i][j] = (H[i][j] - q * (i == j ? 1.f : 0.f)) / safe_p;
  const float detB =
      (B[0][0] * (B[1][1] * B[2][2] - B[1][2] * B[2][1]) -
       B[0][1] * (B[1][0] * B[2][2] - B[1][2] * B[2][0])) +
      B[0][2] * (B[1][0] * B[2][1] - B[1][1] * B[2][0]);
  const float r = t_clamp_max(t_clamp_min(detB * 0.5f, -1.f), 1.f);
  const float phi = acosf(r) * kThird;
  const float two_p = 2.0f * p;
  float e_max = q + two_p * cosf(phi);
  float e_min = q + two_p * cosf(phi + kTwoPiThirds);
  e_max = p2 > 0.f ? e_max : q;
  e_min = p2 > 0.f ? e_min : q;
  const float e_absmax = t_maximum(fabsf(e_min), fabsf(e_max));
  // the Levenberg ridge
  const float abs_max = t_clamp_min(e_absmax, 1e-6f);
  const float lam = e_min < 0.001f * abs_max
                        ? -t_clamp_max(e_min, 0.f) + 0.01f * abs_max
                        : 0.f;
  float A[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) A[i][j] = H[i][j] + lam * (i == j ? 1.f : 0.f);
  // _solve3, the adjugate
  const float c00 = A[1][1] * A[2][2] - A[1][2] * A[2][1];
  const float c01 = A[1][2] * A[2][0] - A[1][0] * A[2][2];
  const float c02 = A[1][0] * A[2][1] - A[1][1] * A[2][0];
  const float det = (A[0][0] * c00 + A[0][1] * c01) + A[0][2] * c02;
  const float c10 = A[0][2] * A[2][1] - A[0][1] * A[2][2];
  const float c11 = A[0][0] * A[2][2] - A[0][2] * A[2][0];
  const float c12 = A[0][1] * A[2][0] - A[0][0] * A[2][1];
  const float c20 = A[0][1] * A[1][2] - A[0][2] * A[1][1];
  const float c21 = A[0][2] * A[1][0] - A[0][0] * A[1][2];
  const float c22 = A[0][0] * A[1][1] - A[0][1] * A[1][0];
  const float inv_det = fabsf(det) > 1e-30f ? 1.f / det : 0.f;
  const float adj[3][3] = {{c00, c10, c20}, {c01, c11, c21},
                           {c02, c12, c22}};
  float x[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    x[a] = matvec ? __fmaf_rn(adj[a][1], g[1], adj[a][0] * g[0]) +
                        adj[a][2] * g[2]
                  : (adj[a][0] * g[0] + adj[a][1] * g[1]) + adj[a][2] * g[2];
  float step[3], descent[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float v = -(inv_det * x[a]);
    step[a] = t_finite(v) ? v : 0.f;
    descent[a] = -g[a];
  }
  t_clamp_norm(step, step_size, dirs[0]);
  t_clamp_norm(descent, step_size, dirs[1]);
}

// One phase of a Newton iteration, every thread of the block: the
// warp tasks (pose p of `poses` from s_pose[pose0], live chunk li), a
// lane a source slot through window_visit, the chunk's sums by warp_sum
// into part: [live][kSghValues] with kDerivs, else [poses][live].
template <bool kDerivs>
__device__ __forceinline__ void newton_tasks(
    const Window& w, const GridView& gv, float (*s_pose)[4], const int* s_live, const unsigned* s_bits,
    int live, int poses, int pose0, float* part) {
  constexpr int V = kDerivs ? kSghValues : 1;
  const int lane = threadIdx.x & 31;
  const int tasks = poses * live;
  for (int t = threadIdx.x >> 5; t < tasks; t += kNewtonWarps) {
    const int p = t / live, li = t - p * live;
    float v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = 0.f;
    if ((s_bits[li] >> lane) & 1u) {
      const float* q = s_pose[pose0 + p];
      const Feature f = point_feature(q[0], q[1], q[2], q[3],
                                      gv.xy[s_live[li] * 32 + lane],
                                      gv.origin, w.inv_res);
      window_visit<kDerivs>(w, gv, f, v);
    }
    warp_sum<V>(v);
    if (lane == 0) {
      if constexpr (kDerivs) {
#pragma unroll
        for (int k = 0; k < V; ++k) part[li * V + k] = v[k];
      } else {
        part[p * live + li] = v[0];
      }
    }
  }
}

// A pose's sum of one value over the live chunks' sums part[li * stride]
// in the order of kernels 1 and 2: the chunks of a 128-slot tile in
// order from +0 (block_sum), the tiles in order from +0
// (window_sum_kernel). A chunk or tile without a live point, which those
// kernels add as +0, is left out: adding +0 to a sum that started at +0
// changes no bit.
__device__ __forceinline__ float tile_ordered_sum(const float* part,
                                                  int stride,
                                                  const int* s_live,
                                                  int live) {
  float acc = 0.f;
  int li = 0;
  while (li < live) {
    const int tile = s_live[li] / kWinWarps;
    float t = 0.f;
    do {
      t += part[li * stride];
      ++li;
    } while (li < live && s_live[li] / kWinWarps == tile);
    acc += t;
  }
  return acc;
}

// The Newton kernel -- replaces no Pallas kernel: it runs the whole loop
// of ndt/solve.py's `align` (the JAX package's lax.while_loop around
// _sgh_kernel and _score_many_kernel) for R rows in one launch, the
// stop included, where the stepwise loop runs ~60 tensor operations,
// kernels 1 and 2 and a host read of the done flag every second
// iteration.
//
// What bounds it on this card: neither bytes nor operations (an
// iteration of a row is 13 poses x the live source points x 9 window
// cells: ~0.3 MB and a few hundred thousand f32 operations at full load)
// but latency: the chain of a slot, two table reads and an expf a cell,
// and the iteration's own chain (the sums, the 3x3 algebra, the line
// search's argmin, the next pose), which no parallelism shortens.
//
// What the design does about it.
// - One block a row, kNewtonThreads threads, resident for the whole
//   solve: no launch, no host read and no tensor operation between
//   iterations. A row that is done leaves the loop; its pose and count
//   are those of the masked loop, where a done row never changes.
// - The table and slot map read through the read-only cache, as
//   kernels 1 and 2 read them. Staging them in shared memory (211 KB at
//   the production window) measured no faster at the cells' loads: the
//   same time at one iteration, 8-12 % less kernel time only from
//   several iterations on, microseconds a scan.
// - Warp tasks: (pose, 32-slot chunk) pairs over the chunks that hold a
//   live source point, found once from the mask, dealt to the warps in
//   turn. A dead chunk costs nothing.
// - The sums in the order of kernels 1 and 2 (tile_ordered_sum), every
//   pair through window_visit: E, the gradient, the Hessian and the 12
//   line-search scores are those of ndt_sgh and ndt_score_many at the
//   same pose, bit for bit.
// - The 3x3 algebra in one thread, operation for operation as the
//   stepwise loop runs it (newton_directions), the candidates' poses
//   and the step broadcast through shared memory.
__global__ void __launch_bounds__(kNewtonThreads, 1)
newton_kernel(Window w, Newton nt) {
  extern __shared__ float s_dyn[];
  __shared__ float s_pose[1 + kCands][4];   // tx, ty, cos, sin of a pose
  __shared__ float s_cand_th[kCands];
  __shared__ float s_sum[kSghValues];
  __shared__ float s_ec[kCands];
  __shared__ int s_nlive, s_stop;

  const int row = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const GridView gv = grid_view(w, row);
  const int chunks = (w.n + 31) / 32;
  // the pose's partials [chunks][12], the candidates' [12][chunks], the
  // live chunks, their mask bits: newton_smem_bytes
  float* s_part = s_dyn;
  float* s_cpart = s_part + chunks * kSghValues;
  int* s_live = (int*)(s_cpart + kCands * chunks);
  unsigned* s_bits = (unsigned*)(s_live + chunks);
  // the mask bits of each chunk, a warp a chunk
  for (int c = warp; c < chunks; c += kNewtonWarps) {
    const int i = c * 32 + lane;
    const unsigned bits =
        __ballot_sync(0xffffffffu, gv.ok && i < w.n && gv.mask[i] != 0);
    if (lane == 0) s_bits[c] = bits;
  }
  // the row's state, held by thread 0
  float px = 0.f, py = 0.f, pth = 0.f;
  int it = 0, n_src = 0;
  bool done = false;
  float cand_step[kCands][3];
  __syncthreads();
  if (tid == 0) {
    int live = 0;
    for (int c = 0; c < chunks; ++c) {
      const unsigned bits = s_bits[c];
      n_src += __popc(bits);
      if (bits != 0u) {
        s_bits[live] = bits;
        s_live[live++] = c;
      }
    }
    s_nlive = live;
    const float* p = w.poses + 3 * row;
    px = p[0];
    py = p[1];
    pth = p[2];
    s_pose[0][0] = px;
    s_pose[0][1] = py;
    s_pose[0][2] = cosf(pth);
    s_pose[0][3] = sinf(pth);
  }
  __syncthreads();
  const int live = s_nlive;

  for (;;) {
    // score, gradient and Hessian at the pose: the next iteration's, or
    // the final derivatives once the row is done
    newton_tasks<true>(w, gv, s_pose, s_live, s_bits, live, 1, 0, s_part);
    __syncthreads();
    if (tid < kSghValues)
      s_sum[tid] = tile_ordered_sum(s_part + tid, kSghValues, s_live, live);
    __syncthreads();
    if (tid == 0) {
      const int stop = done || it >= nt.max_iterations;
      s_stop = stop;
      if (!stop) {
        float dirs[2][3];
        newton_directions(s_sum, nt.step_size, nt.matvec, dirs);
        for (int j = 0; j < kCands; ++j) {
          const float scale = kLsScales[j / 2];
#pragma unroll
          for (int a = 0; a < 3; ++a) cand_step[j][a] = scale * dirs[j % 2][a];
          s_pose[1 + j][0] = px + cand_step[j][0];
          s_pose[1 + j][1] = py + cand_step[j][1];
          s_cand_th[j] = pth + cand_step[j][2];
        }
      }
    }
    __syncthreads();
    if (s_stop) break;
    if (tid < kCands) {
      s_pose[1 + tid][2] = cosf(s_cand_th[tid]);
      s_pose[1 + tid][3] = sinf(s_cand_th[tid]);
    }
    __syncthreads();
    // the 12 line-search candidates
    newton_tasks<false>(w, gv, s_pose, s_live, s_bits, live, kCands, 1,
                        s_cpart);
    __syncthreads();
    if (tid < kCands)
      s_ec[tid] = tile_ordered_sum(s_cpart + tid * live, 1, s_live, live);
    __syncthreads();
    if (tid == 0) {
      // torch.argmin: a NaN first, else the least, the lower index on a
      // tie
      int best = 0;
      for (int j = 1; j < kCands; ++j) {
        const float a = s_ec[j], b = s_ec[best];
        if (a != a ? b == b : (b == b && a < b)) best = j;
      }
      const bool improved = s_ec[best] < s_sum[0];
      const float on = improved ? 1.f : 0.f;
      const float ax = on * cand_step[best][0];
      const float ay = on * cand_step[best][1];
      const float ath = on * cand_step[best][2];
      done = !improved || t_norm3(ax, ay, ath) < nt.trans_eps ||
             s_sum[1] < 1.f;
      px = px + ax;
      py = py + ay;
      pth = pth + ath;
      ++it;
      s_pose[0][0] = px;
      s_pose[0][1] = py;
      s_pose[0][2] = cosf(pth);
      s_pose[0][3] = sinf(pth);
    }
    __syncthreads();
  }
  if (tid == 0) {
    nt.pose[3 * row] = px;
    nt.pose[3 * row + 1] = py;
    nt.pose[3 * row + 2] = pth;
    nt.iterations[row] = it;
    nt.usable[row] = s_sum[1] >= 1.f && n_src >= 1 && t_finite(px) &&
                     t_finite(py) && t_finite(pth);
    nt.objective[row] = s_sum[0];
    nt.matched[row] = s_sum[1];
    // the Hessian as window_sum_kernel lays it out
    const float h[9] = {s_sum[5], s_sum[6], s_sum[7],
                        s_sum[6], s_sum[8], s_sum[9],
                        s_sum[7], s_sum[9], s_sum[10] + s_sum[11]};
#pragma unroll
    for (int a = 0; a < 9; ++a) nt.hessian[9 * row + a] = h[a];
  }
}

// The fuse kernel -- replaces no Pallas kernel: the accept-and-fuse
// stage of a registration, which the JAX package leaves to XLA
// (ndt_slam_tpu/fuse/ekf.py's gate_and_fuse and the tail of
// pipeline/frontend.py's _register_with_grid). Its plain twin is the
// torch code of fuse/ekf.py (fuse_stage_plain, gate_and_fuse_plain):
// the cost, the Hessian repair, the NDT covariance Q from the Hessian's
// eigen-decomposition, the degenerate-direction projection of the
// innovation, the fitness and innovation gates, the odometry covariance,
// the Kalman blend, the fused-pose gate, the accept / dead-reckon
// select, then the map-frame scan, error_pose and trans_probability.
//
// What bounds it on this card: nothing of the work. A row is a few
// hundred f32 operations of 3x3 algebra and N point transforms; the
// torch twin issues some 250 tensor operations for it, half of them
// launches, and torch.linalg.eigh goes through cuSOLVER, whose info
// check is a device-to-host copy and a sync. So the cost was launches
// and one host round trip a scan.
//
// What the design does about it: one launch for R rows, one block a
// row, no sync and no scratch.
// - Thread 0 runs the row's 3x3 algebra in registers, each operation as
//   the twin writes it (one rounding an operation, -fmad=false; a
//   division by a host scalar is torch's product with the f32
//   reciprocal, a scalar over a tensor torch's reciprocal times the
//   scalar; angles wrap by torch's remainder on the card, fmod moved
//   onto the divisor's sign). The 3x3 products sum in index order,
//   where cuBLAS may take another: the kernel is held to the twin
//   within tolerances, not bit for bit.
// - The symmetric eigen-decomposition is cyclic Jacobi (sym3_eigh), a
//   fixed kJacobiSweeps sweeps of the three rotations in f32, reading
//   the lower triangle as torch.linalg.eigh does, eigenvalues sorted
//   ascending with their vectors. Jacobi keeps the eigenvectors
//   orthonormal to rounding and has no special case at repeated roots
//   (where Smith's closed form needs a fallback for its vectors): Q and
//   the projection are sums over eigenspaces, which a repeated root
//   leaves free to rotate without changing them.
// - K solves S^T K^T = cov_hat^T by Gaussian elimination with partial
//   pivoting (solve3_rows), as solve_ex factors and solves.
// - The block counts the live source slots (__syncthreads_count, exact)
//   while thread 0 waits for it, and transforms the row's scan to the
//   map frame at the fused pose once thread 0 has published it, in
//   pose2.global_points' operation order, PAD_COORD where masked.
// - No atomics: a rerun is bitwise equal.
constexpr int kFuseThreads = 256;
constexpr int kJacobiSweeps = 8;
constexpr float kPadCoord = 1.0e8f;   // core/points.py PAD_COORD
// the Python constants of core/angles.py as torch casts them to f32
constexpr float kDeg2Rad = (float)(3.141592653589793 / 180.0);
constexpr float kRad2Deg = (float)(180.0 / 3.141592653589793);
constexpr float kPi = (float)3.141592653589793;
constexpr float kTwoPi = (float)(2.0 * 3.141592653589793);

// Operands of the fuse kernel, R rows, every row-major. The tail
// (converged, odo_pose, objective, src_mask, scan_xy, scan_mask and
// their outputs) may be null: gate_and_fuse alone, `fit` then the cost.
struct Fuse {
  const float* pred;             // [R, 3] predicted pose (deg)
  const float* est;              // [R, 3] NDT pose (deg)
  const float* odo_motion;       // [R, 3]
  const float* last_pose;        // [R, 3]
  const float* last_cov;         // [R, 3, 3]
  const float* hessian;          // [R, 3, 3]
  const float* fit;              // [R] fitness mean (or the cost)
  const unsigned char* converged;  // [R] bool, or null
  const float* odo_pose;         // [R, 3], or null
  const float* objective;        // [R], or null
  const unsigned char* src_mask;   // [R, s] bool, or null
  const float2* scan_xy;         // [R, n] sensor frame, or null
  const unsigned char* scan_mask;  // [R, n] bool
  int s, n;
  int project;                   // fuse_degenerate_ratio > 0
  float coe_ndt_cov, degenerate_ratio, score_thre, max_trans, max_rot;
  float del_time, coe_vel, coe_omega, failed_cost;
  float* cost;                   // [R], or null
  float* fused;                  // [R, 3]
  float* cov;                    // [R, 3, 3]
  unsigned char* accept;         // [R] bool
  float2* global_xy;             // [R, n], or null
  float* error_pose;             // [R, 3], or null
  float* trans_prob;             // [R], or null
};

// torch.remainder of f32 on the card.
__device__ __forceinline__ float t_remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m += b;
  return m;
}
// core/angles.py
__device__ __forceinline__ float sub_deg(float a, float b) {
  return t_remainder((a - b) + 180.f, 360.f) - 180.f;
}
__device__ __forceinline__ float wrap_rad(float a) {
  return t_remainder(a + kPi, kTwoPi) - kPi;
}

// out = a @ b of 3x3 matrices, each sum in index order.
__device__ __forceinline__ void mm3(const float (&a)[3][3],
                                    const float (&b)[3][3],
                                    float (&out)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[i][j] = (a[i][0] * b[0][j] + a[i][1] * b[1][j]) + a[i][2] * b[2][j];
}

// out = (v * d[None, :]) @ v^T: the twin's (evecs * w[..., None, :]) @
// evecs.mT.
__device__ __forceinline__ void scaled_outer3(const float (&v)[3][3],
                                              const float (&d)[3],
                                              float (&out)[3][3]) {
  float vd[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) vd[i][k] = v[i][k] * d[k];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[i][j] =
          (vd[i][0] * v[j][0] + vd[i][1] * v[j][1]) + vd[i][2] * v[j][2];
}

// fuse/ekf.py's odometry_covariance: F C F^T + A M A^T.
__device__ void odometry_cov(const float* mo, const float* lp,
                             const float* lc, float dt, float coe_vel,
                             float coe_omega, float (&out)[3][3]) {
  const float inv_dt = 1.f / dt;
  const float v = sqrtf(mo[0] * mo[0] + mo[1] * mo[1]) * inv_dt;
  const float omega = (mo[2] * kDeg2Rad) * inv_dt;
  const float th = lp[2] * kDeg2Rad;
  const float c = cosf(th), s = sinf(th);
  const float m0 = (coe_vel * v) * v, m1 = (coe_omega * omega) * omega;
  const float F[3][3] = {{1.f, 0.f, ((-v) * dt) * s},
                         {0.f, 1.f, (v * dt) * c},
                         {0.f, 0.f, 1.f}};
  const float Ft[3][3] = {{F[0][0], F[1][0], F[2][0]},
                          {F[0][1], F[1][1], F[2][1]},
                          {F[0][2], F[1][2], F[2][2]}};
  float C[3][3], FC[3][3], FCFt[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) C[i / 3][i % 3] = lc[i];
  mm3(F, C, FC);
  mm3(FC, Ft, FCFt);
  // A = [[dt c, 0], [dt s, 0], [0, dt]], M = diag(m0, m1): (A M A^T)_ij
  // = (A_i0 m0) A_j0 + (A_i1 m1) A_j1
  const float A[3][2] = {{c * dt, 0.f}, {s * dt, 0.f}, {0.f, dt}};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[i][j] = FCFt[i][j] +
                  ((A[i][0] * m0) * A[j][0] + (A[i][1] * m1) * A[j][1]);
}

// Eigenvalues w (ascending) and eigenvectors (the columns of V) of the
// symmetric matrix whose lower triangle H holds: cyclic Jacobi, the
// rotations of Numerical Recipes' jacobi (the angle from
// theta = (a_qq - a_pp) / (2 a_pq), the small root t, a_pq set to 0).
__device__ void sym3_eigh(const float (&H)[3][3], float (&w)[3],
                          float (&V)[3][3]) {
  float a[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = i >= j ? H[i][j] : H[j][i];
      V[i][j] = i == j ? 1.f : 0.f;
    }
  const int P[3] = {0, 0, 1}, Q[3] = {1, 2, 2};
  for (int sweep = 0; sweep < kJacobiSweeps; ++sweep) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int p = P[k], q = Q[k], r = 3 - p - q;
      const float apq = a[p][q];
      if (apq == 0.f) continue;
      const float h = a[q][q] - a[p][p];
      float t;
      if (fabsf(h) + 100.f * fabsf(apq) == fabsf(h)) {
        t = apq / h;
      } else {
        const float theta = 0.5f * h / apq;
        t = 1.f / (fabsf(theta) + sqrtf(1.f + theta * theta));
        if (theta < 0.f) t = -t;
      }
      const float c = 1.f / sqrtf(t * t + 1.f), s = t * c;
      a[p][p] -= t * apq;
      a[q][q] += t * apq;
      a[p][q] = a[q][p] = 0.f;
      const float arp = a[r][p], arq = a[r][q];
      a[r][p] = a[p][r] = c * arp - s * arq;
      a[r][q] = a[q][r] = s * arp + c * arq;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float vp = V[i][p], vq = V[i][q];
        V[i][p] = c * vp - s * vq;
        V[i][q] = s * vp + c * vq;
      }
    }
  }
  w[0] = a[0][0];
  w[1] = a[1][1];
  w[2] = a[2][2];
  // ascending, each vector with its value
  const int sp[3][2] = {{0, 1}, {1, 2}, {0, 1}};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i = sp[k][0], j = sp[k][1];
    if (w[i] > w[j]) {
      const float tw = w[i];
      w[i] = w[j];
      w[j] = tw;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float tv = V[m][i];
        V[m][i] = V[m][j];
        V[m][j] = tv;
      }
    }
  }
}

// K with K S = C, row by row: S^T x = (row i of C)^T by an LU of S^T
// with partial pivoting (the first largest pivot, as LAPACK's getrf).
__device__ void solve3_rows(const float (&S)[3][3], const float (&C)[3][3],
                            float (&K)[3][3]) {
  float lu[3][3];
  int perm[3] = {0, 1, 2};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) lu[i][j] = S[j][i];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int piv = k;
#pragma unroll
    for (int i = k + 1; i < 3; ++i)
      if (fabsf(lu[i][k]) > fabsf(lu[piv][k])) piv = i;
    if (piv != k) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float t = lu[k][j];
        lu[k][j] = lu[piv][j];
        lu[piv][j] = t;
      }
      const int t = perm[k];
      perm[k] = perm[piv];
      perm[piv] = t;
    }
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      lu[i][k] = lu[i][k] / lu[k][k];
#pragma unroll
      for (int j = k + 1; j < 3; ++j) lu[i][j] = lu[i][j] - lu[i][k] * lu[k][j];
    }
  }
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    float y[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float acc = C[row][perm[i]];
#pragma unroll
      for (int j = 0; j < i; ++j) acc = acc - lu[i][j] * y[j];
      y[i] = acc;
    }
#pragma unroll
    for (int i = 2; i >= 0; --i) {
      float acc = y[i];
#pragma unroll
      for (int j = i + 1; j < 3; ++j) acc = acc - lu[i][j] * K[row][j];
      K[row][i] = acc / lu[i][i];
    }
  }
}

// One row of gate_and_fuse (and the cost, error_pose and
// trans_probability of the tail), in registers; writes the row's
// outputs and returns the pose the scan is transformed at.
__device__ __noinline__ void fuse_row(const Fuse& f, int row, int n_src,
                                      float (&out_pose)[3]) {
  const float* pred = f.pred + 3 * row;
  const float* est = f.est + 3 * row;
  const float* hin = f.hessian + 9 * row;
  // the Hessian repair: a non-finite entry gives the identity
  bool finite = true;
  float H[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    H[i / 3][i % 3] = hin[i];
    finite = finite && t_finite(hin[i]);
  }
  if (!finite) {
#pragma unroll
    for (int i = 0; i < 9; ++i) H[i / 3][i % 3] = i % 4 == 0 ? 1.f : 0.f;
  }
  float evals[3], V[3][3];
  sym3_eigh(H, evals, V);
  float inv_e[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // coe / clamp(evals, 1e-3), clamped into [1e-6, 1e-2]
    inv_e[k] = (1.f / t_clamp_min(evals[k], 1e-3f)) * f.coe_ndt_cov;
    inv_e[k] = t_clamp_max(t_clamp_min(inv_e[k], 1e-6f), 1e-2f);
  }
  float Qm[3][3];
  scaled_outer3(V, inv_e, Qm);

  float zh[3] = {est[0] - pred[0], est[1] - pred[1],
                 sub_deg(est[2], pred[2]) * kDeg2Rad};
  if (f.project) {
    const float wmax = t_clamp_min(evals[2], 1e-9f);
    const float thre = f.degenerate_ratio * wmax;
    float keep[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) keep[k] = evals[k] > thre ? 1.f : 0.f;
    float Pm[3][3];
    scaled_outer3(V, keep, Pm);
    float pz[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      pz[i] = (Pm[i][0] * zh[0] + Pm[i][1] * zh[1]) + Pm[i][2] * zh[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) zh[i] = pz[i];
  }

  const float innov_t = hypotf(est[0] - pred[0], est[1] - pred[1]);
  const float innov_r = fabsf(sub_deg(est[2], pred[2]));
  const bool plausible = innov_t <= f.max_trans && innov_r <= f.max_rot;
  const float fit = f.fit[row];
  const float cost = (f.converged == nullptr || f.converged[row])
                         ? fit : f.failed_cost;
  const bool successful = cost <= f.score_thre && plausible;

  // the Kalman blend
  float cov_hat[3][3];
  odometry_cov(f.odo_motion + 3 * row, f.last_pose + 3 * row,
               f.last_cov + 9 * row, f.del_time, f.coe_vel, f.coe_omega,
               cov_hat);
  float S[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) S[i][j] = Qm[i][j] + cov_hat[i][j];
  float Ss[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Ss[i][j] = 0.5f * (S[i][j] + S[j][i]);
  const float jitter = 1e-6f * ((Ss[0][0] + Ss[1][1]) + Ss[2][2]) + 1e-9f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Ss[i][j] += jitter * (i == j ? 1.f : 0.f);
  float K[3][3];
  solve3_rows(Ss, cov_hat, K);
  float IK[3][3], cv[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) IK[i][j] = (i == j ? 1.f : 0.f) - K[i][j];
  mm3(IK, cov_hat, cv);
  const float mu_hat[3] = {pred[0], pred[1], pred[2] * kDeg2Rad};
  float fk[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    fk[i] = ((K[i][0] * zh[0] + K[i][1] * zh[1]) + K[i][2] * zh[2]) +
            mu_hat[i];
  fk[2] = wrap_rad(fk[2]) * kRad2Deg;

  // the fused pose must also stay within the innovation gate
  const float fused_t = hypotf(fk[0] - pred[0], fk[1] - pred[1]);
  const float fused_r = fabsf(sub_deg(fk[2], pred[2]));
  const bool fused_ok = fused_t <= f.max_trans && fused_r <= f.max_rot &&
                        t_finite(fk[0]) && t_finite(fk[1]) && t_finite(fk[2]);
  const bool accept = successful && fused_ok;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    out_pose[a] = accept ? fk[a] : pred[a];
    f.fused[3 * row + a] = out_pose[a];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      f.cov[9 * row + 3 * i + j] =
          accept ? 0.5f * (cv[i][j] + cv[j][i]) : cov_hat[i][j];
  f.accept[row] = accept;
  if (f.cost != nullptr) f.cost[row] = cost;
  if (f.error_pose != nullptr) {
    const float* odo = f.odo_pose + 3 * row;
    f.error_pose[3 * row] = out_pose[0] - odo[0];
    f.error_pose[3 * row + 1] = out_pose[1] - odo[1];
    f.error_pose[3 * row + 2] = sub_deg(out_pose[2], odo[2]);
  }
  if (f.trans_prob != nullptr)
    f.trans_prob[row] =
        -f.objective[row] / t_clamp_min((float)n_src, 1.f);
}

__global__ void __launch_bounds__(kFuseThreads) fuse_kernel(Fuse f) {
  __shared__ float s_pose[4];   // fused x, y, cos, sin of the heading
  const int row = blockIdx.x, tid = threadIdx.x;
  // the live source slots, exactly
  int n_src = 0;
  if (f.src_mask != nullptr) {
    const unsigned char* m = f.src_mask + (size_t)row * f.s;
    for (int i0 = 0; i0 < f.s; i0 += kFuseThreads) {
      const int i = i0 + tid;
      n_src += __syncthreads_count(i < f.s && m[i] != 0);
    }
  }
  if (tid == 0) {
    float pose[3];
    fuse_row(f, row, n_src, pose);
    const float th = pose[2] * kDeg2Rad;
    s_pose[0] = pose[0];
    s_pose[1] = pose[1];
    s_pose[2] = cosf(th);
    s_pose[3] = sinf(th);
  }
  if (f.scan_xy == nullptr) return;
  __syncthreads();
  const float px = s_pose[0], py = s_pose[1], c = s_pose[2], s = s_pose[3];
  const size_t base = (size_t)row * f.n;
  for (int i = tid; i < f.n; i += kFuseThreads) {
    const float2 p = f.scan_xy[base + i];
    float2 g;
    if (f.scan_mask[base + i]) {
      g.x = (c * p.x - s * p.y) + px;
      g.y = (s * p.x + c * p.y) + py;
    } else {
      g.x = kPadCoord;
      g.y = kPadCoord;
    }
    f.global_xy[base + i] = g;
  }
}

// sym3_eigh alone, one thread a matrix: h [rows, 3, 3] in, w [rows, 3]
// and V [rows, 3, 3] (the vectors as columns) out, for a check of the
// fuse kernel's eigen-decomposition against a float64 one.
__global__ void sym3_eigh_kernel(const float* __restrict__ h, float* w,
                                 float* V, int rows) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float H[3][3], ww[3], VV[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) H[i / 3][i % 3] = h[9 * row + i];
  sym3_eigh(H, ww, VV);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w[3 * row + i] = ww[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) V[9 * row + 3 * i + j] = VV[i][j];
  }
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
// other). The batch row is blockIdx.y. d2_out
// [batch, n] (may be null): minimum over the partials, clamped at 0,
// 1e12 for a masked source. kFitness (launched as one cluster of
// kNnFinCluster blocks a row): fit_out[row] = the mean of d2 over the
// row's live sources, or 1e12 with no live source or no live target
// (n_live entries of the row's `live`, any > 0). The sum runs per
// thread in step order, then through block_sum, then over the cluster's
// blocks in rank order, read by block 0 from their shared memory: a
// fixed order, no atomics, no third launch. That order depends on n
// and the cluster's shape only, not on the batch or on how many blocks
// the first launch used (the minimum over their partials is exact in
// any order), so row b of a batch gives the mean of a call on row b
// alone bit for bit.
template <bool kFitness>
__global__ void __launch_bounds__(kNnFinThreads)
nn_finish_kernel(const float* __restrict__ part,
                 const int* __restrict__ live,
                 const unsigned char* __restrict__ src_mask,
                 float* __restrict__ d2_out, float* __restrict__ fit_out,
                 int n, int blocks, int n_live) {
  constexpr int kPerRound = kNnFinThreads / kNnFinShare;   // 128 sources
  {
    const size_t row = blockIdx.y;
    part += row * blocks * n;
    src_mask += row * n;
    if (d2_out != nullptr) d2_out += row * n;
    if constexpr (kFitness) {
      live += row * n_live;
      fit_out += row;
    }
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

// Dynamic shared memory of a Newton launch: the partials and the
// live-chunk lists of n source slots (6.5 KB at 2048).
size_t newton_smem_bytes(int n) {
  const size_t chunks = (size_t)(n + 31) / 32;
  return chunks * (kSghValues + kCands) * 4 + chunks * 8;
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

// The whole Newton solve of `rows` rows in one launch: row r from
// poses[r] against grid grid_of[r] (grid 0 for every row when grid_of
// is null, and the 3x3 solve in one pose's form) and its source row,
// the operands as for ndt_sgh (xy [rows or 1, n, 2] at src_stride). Out: pose [rows, 3], iterations [rows],
// usable [rows] (bool), objective [rows], hessian [rows, 3, 3], matched
// [rows].
int ndt_newton(const float* xy, const unsigned char* mask,
               const float* poses, const int* grid_of, const float* origin,
               const float* table, const int* cell_slot, float* pose_out,
               int* iterations, unsigned char* usable, float* objective,
               float* hessian, float* matched, int n, int rows, int nx,
               int ny, int r, int k, int grids, int src_stride,
               float inv_res, float d1, float neg_half_d2, float md_cap,
               float coef_scale, float d2, int max_iterations,
               float step_size, float trans_eps, void* stream) {
  if (rows < 1 || n < 0 || r < 0 || k < 0 || grids < 1 || src_stride < 0 ||
      max_iterations < 0)
    return (int)cudaErrorInvalidValue;
  const Window w = make_window(xy, mask, poses, grid_of, origin, table,
                               cell_slot, n, nx, ny, r, k, grids, src_stride,
                               inv_res, d1, neg_half_d2, md_cap, coef_scale,
                               d2);
  const Newton nt{max_iterations, grid_of == nullptr, step_size, trans_eps,
                  pose_out, iterations, usable, objective, hessian, matched};
  // past the 48 KB of shared memory a launch takes unasked (over
  // ~15000 source slots) the launch is refused
  newton_kernel<<<rows, kNewtonThreads, newton_smem_bytes(n),
                  (cudaStream_t)stream>>>(w, nt);
  return (int)cudaGetLastError();
}

// The accept-and-fuse stage of `rows` rows in one launch (fuse_kernel):
// pred, est, odo_motion, last_pose [rows, 3], last_cov, hessian [rows,
// 3, 3], fit [rows]; with the tail also converged [rows] (bool; cost =
// converged ? fit : failed_cost), odo_pose [rows, 3], objective [rows],
// src_mask [rows, s], scan_xy [rows, n, 2] and scan_mask [rows, n].
// Out: fused [rows, 3], cov [rows, 3, 3], accept [rows] (bool); with
// the tail cost [rows], global_xy [rows, n, 2], error_pose [rows, 3]
// and trans_prob [rows]. Without it (scan_xy null) every tail pointer
// is null, s = n = 0, and fit is the cost.
int ndt_fuse(const float* pred, const float* est, const float* odo_motion,
             const float* last_pose, const float* last_cov,
             const float* hessian, const float* fit,
             const unsigned char* converged, const float* odo_pose,
             const float* objective, const unsigned char* src_mask,
             const float* scan_xy, const unsigned char* scan_mask,
             float* cost, float* fused, float* cov, unsigned char* accept,
             float* global_xy, float* error_pose, float* trans_prob,
             int rows, int s, int n, int project, float coe_ndt_cov,
             float degenerate_ratio, float score_thre, float max_trans,
             float max_rot, float del_time, float coe_vel, float coe_omega,
             float failed_cost, void* stream) {
  const bool tail = scan_xy != nullptr;
  if (rows < 1 || s < 0 || n < 0 ||
      (tail && (converged == nullptr || odo_pose == nullptr ||
                objective == nullptr || src_mask == nullptr ||
                scan_mask == nullptr || cost == nullptr ||
                global_xy == nullptr || error_pose == nullptr ||
                trans_prob == nullptr)) ||
      (!tail && (s != 0 || n != 0 || converged != nullptr ||
                 src_mask != nullptr || cost != nullptr)))
    return (int)cudaErrorInvalidValue;
  const Fuse f{pred, est, odo_motion, last_pose, last_cov, hessian, fit,
               converged, odo_pose, objective, src_mask,
               (const float2*)scan_xy, scan_mask, s, n, project,
               coe_ndt_cov, degenerate_ratio, score_thre, max_trans, max_rot,
               del_time, coe_vel, coe_omega, failed_cost, cost, fused, cov,
               accept, (float2*)global_xy, error_pose, trans_prob};
  fuse_kernel<<<rows, kFuseThreads, 0, (cudaStream_t)stream>>>(f);
  return (int)cudaGetLastError();
}

// The fuse kernel's eigen-decomposition of rows symmetric 3x3 matrices
// (their lower triangles): h [rows, 3, 3]; out w [rows, 3] ascending,
// V [rows, 3, 3] with the vectors as columns.
int ndt_sym3_eigh(const float* h, float* w, float* V, int rows,
                  void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  sym3_eigh_kernel<<<(rows + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      h, w, V, rows);
  return (int)cudaGetLastError();
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
// with fit_out [batch] not null (no index) each row's fitness mean
// instead of d2. blocks: the blocks that share the target chunks of one
// source tile.
int ndt_nn(const float* src, const unsigned char* src_mask, const float* tgt,
           const unsigned char* tgt_mask, float* part, int* part_idx,
           int* live, float* d2_out, int* idx_out, float* fit_out, int n,
           int m, int batch, int blocks, void* stream) {
  if (n < 1 || m < 1 || blocks < 1 || batch < 1 || batch > 65535 ||
      (fit_out != nullptr && idx_out != nullptr) ||
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
    config.gridDim = dim3(kNnFinCluster, batch);
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
