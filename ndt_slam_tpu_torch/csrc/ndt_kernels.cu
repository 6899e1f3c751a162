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

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWinThreads = 128;   // threads a block of kernels 1 and 2
constexpr int kWinWarps = kWinThreads / 32;
constexpr int kSghValues = 12;     // sums a point feeds into kernel 1
constexpr int kSghRow = 16;        // floats a pose in kernel 1's output
constexpr int kMaxPoses = 128;     // poses a launch of kernels 1 and 2
constexpr int kNnThreads = 128;
constexpr int kNnChunk = 2048;     // targets staged per pass: 3*2048*4 = 24 KB

// Operands shared by kernels 1 and 2, passed by value.
struct Window {
  const float2* xy;              // [n] source points, sensor frame
  const unsigned char* mask;     // [n] bool
  const float* poses;            // [poses, 3] (tx, ty, theta in rad)
  const float* origin;           // [2] lower-left corner of the grid
  const float4* table;           // [K, 2] cells: (kx, ky, mx, my),
                                 //               (b00, b01, b11, valid)
  const int* cell_slot;          // [nx*ny] table slot of a cell id, or -1
  int n, nx, ny, r;
  float inv_res;                 // f32 reciprocal of the resolution
  float d1, neg_half_d2, md_cap, coef_scale, d2;
};

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
__device__ __forceinline__ Feature point_feature(const Window& w, int pose,
                                                 int i) {
  Feature f;
  const float* p = w.poses + 3 * pose;
  f.tx = p[0];
  f.ty = p[1];
  f.c = cosf(p[2]);
  f.s = sinf(p[2]);
  const float2 q = w.xy[i];
  f.x = q.x;
  f.y = q.y;
  f.px = f.c * q.x - f.s * q.y + f.tx;
  f.py = f.s * q.x + f.c * q.y + f.ty;
  f.fx = floorf((f.px - w.origin[0]) * w.inv_res);
  f.fy = floorf((f.py - w.origin[1]) * w.inv_res);
  return f;
}

// Sums of one block's threads in a fixed tree: a shuffle butterfly
// inside each warp, then the warps in order. Thread k < V of the block
// ends with the block's sum of value k. Called by every thread.
template <int V>
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
    for (int wp = 0; wp < kWinWarps; ++wp) total += s_warp[wp][threadIdx.x];
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
// launches with no tensor op around them. A batch over grids can come
// as blockIdx.z and a stride on table, cell_slot and origin.
template <bool kDerivs>
__global__ void window_kernel(Window w, float* __restrict__ partials) {
  constexpr int V = kDerivs ? kSghValues : 1;
  __shared__ float s_warp[kWinWarps][V];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int pose = blockIdx.y;
  float v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = 0.f;

  if (i < w.n && w.mask[i]) {
    const Feature f = point_feature(w, pose, i);
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
          const int slot = __ldg(w.cell_slot + gx * w.ny + gy);
          if (slot < 0) continue;
          const float4 t0 = __ldg(w.table + 2 * slot);
          const float4 t1 = __ldg(w.table + 2 * slot + 1);
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
  const Feature f = point_feature(w, blockIdx.y, i);
  out[blockIdx.y * w.n + i] = make_float4(f.px, f.py, f.fx, f.fy);
}

// Launched alone to time what a launch costs on this card.
__global__ void empty_kernel() {}

// Kernel 3 -- replaces _nn_kernel (pallas_kernels.py:303).
// Brute-force nearest neighbour in the difference form (dx*dx + dy*dy,
// no |s|^2+|t|^2-2s.t cancellation). Sources go across blockIdx.x; the
// target range is split across blockIdx.y so 2048 sources still fill
// the card, and each block streams its range through shared memory in
// 2048-target chunks, keeping a running minimum per source. A masked
// target counts as 1e12. Partial minima [splits, N] are reduced by
// torch (a minimum is exact in any order). Bound on this card: one
// subtract-multiply-add-min per (source, target) pair, 2048 x 131072 a
// call, fed from shared memory.
__global__ void nn_kernel(const float* __restrict__ src,
                          const float* __restrict__ tgt,
                          float* __restrict__ part, int n, int m,
                          int per_split) {
  __shared__ float s_x[kNnChunk], s_y[kNnChunk], s_v[kNnChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int lo = blockIdx.y * per_split;
  const int hi = min(m, lo + per_split);
  float sx = 0.f, sy = 0.f;
  if (live) { sx = src[2 * i]; sy = src[2 * i + 1]; }
  float best = 1.0e12f;
  for (int base = lo; base < hi; base += kNnChunk) {
    const int len = min(kNnChunk, hi - base);
    __syncthreads();
    for (int t = threadIdx.x; t < len; t += blockDim.x) {
      s_x[t] = tgt[base + t];
      s_y[t] = tgt[m + base + t];
      s_v[t] = tgt[2 * m + base + t];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < len; ++j) {
      const float dx = sx - s_x[j];
      const float dy = sy - s_y[j];
      const float d2 = s_v[j] > 0.f ? dx * dx + dy * dy : 1.0e12f;
      best = fminf(best, d2);
    }
  }
  if (live) part[blockIdx.y * n + i] = best;
}

// Both launches of kernel 1 (derivs) or kernel 2 on `stream`.
int window_launch(const Window& w, int poses, bool derivs, float* partials,
                  float* out, void* stream) {
  if (poses < 1 || poses > kMaxPoses || w.n < 0 || w.r < 0)
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
                   const float* poses, const float* origin,
                   const float* table, const int* cell_slot, int n, int nx,
                   int ny, int r, float inv_res, float d1, float neg_half_d2,
                   float md_cap, float coef_scale, float d2) {
  return Window{(const float2*)xy, mask, poses, origin,
                (const float4*)table, cell_slot, n, nx, ny, r, inv_res,
                d1, neg_half_d2, md_cap, coef_scale, d2};
}

}  // namespace

extern "C" {

// out [poses, 16]; partials [poses, ceil(n / 128), 12] scratch.
int ndt_sgh(const float* xy, const unsigned char* mask, const float* poses,
            const float* origin, const float* table, const int* cell_slot,
            float* partials, float* out, int n, int n_poses, int nx, int ny,
            int r, float inv_res, float d1, float neg_half_d2, float md_cap,
            float coef_scale, float d2, void* stream) {
  const Window w = make_window(xy, mask, poses, origin, table, cell_slot, n,
                               nx, ny, r, inv_res, d1, neg_half_d2, md_cap,
                               coef_scale, d2);
  return window_launch(w, n_poses, true, partials, out, stream);
}

// out [poses]; partials [poses, ceil(n / 128)] scratch.
int ndt_score_many(const float* xy, const unsigned char* mask,
                   const float* poses, const float* origin,
                   const float* table, const int* cell_slot, float* partials,
                   float* out, int n, int n_poses, int nx, int ny, int r,
                   float inv_res, float d1, float neg_half_d2, float md_cap,
                   void* stream) {
  const Window w = make_window(xy, mask, poses, origin, table, cell_slot, n,
                               nx, ny, r, inv_res, d1, neg_half_d2, md_cap,
                               0.f, 0.f);
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

int ndt_nn(const float* src, const float* tgt, float* part, int n, int m,
           int splits, void* stream) {
  if (n > 0 && splits > 0) {
    const int per_split = (m + splits - 1) / splits;
    const dim3 grid((n + kNnThreads - 1) / kNnThreads, splits);
    nn_kernel<<<grid, kNnThreads, 0, (cudaStream_t)stream>>>(
        src, tgt, part, n, m, per_split);
  }
  return (int)cudaGetLastError();
}

int ndt_window_threads() { return kWinThreads; }
int ndt_max_poses() { return kMaxPoses; }

}  // extern "C"
