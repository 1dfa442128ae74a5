// NoncentralGeneric projection kernel: ncg_projection_kernel<kThreads, kStaged>.
//
// Replaces no TPU kernel.  The reference package projects NoncentralGeneric
// points in XLA (camera_calibration_tpu/models/noncentral_generic.py,
// project_points), and so does the port's plain version
// (models/noncentral_generic.py, project_points), which stays this kernel's
// reference and serves the CPU.  On the card that plain loop was most of
// the time of a NoncentralGeneric bundle adjustment: every iteration is
// dozens of batched 3x3 and 3x2 products over all points, and a read of the
// loop test on the host.  This kernel runs the whole loop of a point in one
// thread, in one launch.
//
// What it computes, per point n (one thread per point), in float32, the loop
// of project_points:
//   the grid coordinates g whose observation line passes through the
//   camera-frame point x_n, by a damped 2x2 Levenberg-Marquardt loop that
//   minimises |offset(g)|^2, the perpendicular offset of x_n from the line
//   through o(g) along u(g)/|u(g)| (the B-spline grids of line origins and
//   directions).  g starts at the warm-start pixel mapped to grid
//   coordinates, or at the calibrated area's center; lambda starts at
//   0.01 * tr(H)/2, is halved on accept and doubled on reject; test points
//   are clamped to [lo, hi] (NaN stays NaN, as with torch.clamp) and
//   accepted where their cost is below the current one.  A point is done
//   after the step of the iteration whose starting cost is below eps, or
//   after `iters` iterations, and leaves the loop then: the plain loop
//   freezes done points, so leaving gives its result.  Written: g, its
//   pixel, the cost there and valid = sqrt(cost) < 1e-4 * max(|x_n|, 1e-6).
//   The window is the plain version's (ops/bspline.gather_window_2d): it
//   starts at base = floor(g) - 1, a negative base counts from the grid's
//   far end, the start is then held to [0, size - 4], and the weights are
//   those of g - (base + 1).
//
// What bounds it on an H100: reading the window and the loop's arithmetic.
// An evaluation at one g reads 16 knots of 6 floats (384 B) from shared
// memory and takes about 700 FLOP (the window with both derivatives, the
// offset and its 3x2 Jacobian); an iteration is one evaluation and a 2x2
// solve.  From device memory a point reads 20 B and writes 21 B.  At the
// 1080p bundle adjustment's N = 1,036,200 with 4 iterations, its points
// need 4.43 M evaluations (a point leaves after the iteration whose
// starting cost is below eps): 1.70 GB of shared-memory reads (0.051 ms at
// 128 B a clock on each of 132 SMs at 1.98 GHz) and 3.2 GFLOP (0.048 ms at
// 67 TFLOP/s).
// The design:
// - One evaluation per iteration: the test point is evaluated with its
//   derivatives, and on accept that state is the next iteration's, so no
//   point is evaluated twice and the final cost comes out of the loop.
// - Both grids are staged once per block in shared memory as one array of
//   packed 6-float knots (direction, origin), 85,320 B at 45x79, so a
//   window tap is three 8-byte loads.
// - Where they do not fit one block's 227 KB (above 9,685 knots, e.g.
//   100x100), the same kernel runs with kStaged = false and reads the two
//   (gh, gw, 3) grids through the read-only path; they stay in the 50 MB
//   L2.
// - Persistent blocks, as many as are resident on the card, each staging
//   once and walking tiles of kThreads points with a stride; warps leave
//   the loop on their own.  Blocks of 256 threads where four fit in an SM's
//   shared memory (and unstaged), 512 where two fit (45x79), else 1024: 32
//   warps an SM, 64 registers a thread.
// - Divisions and square roots are IEEE, as in the plain version; they are
//   a few of an evaluation's operations.
// Outputs are (N, 2) pixels and grid coordinates, (N) cost and (N) valid
// bytes.  No grid size is built in: shared memory is sized from (gh, gw)
// at launch, and no grid of at least 4x4 is refused for its size.

#include <cuda_runtime.h>
#include <math.h>

#include "spline.cuh"

namespace {

using cct::cubic_weight_derivs;
using cct::cubic_weights;
using cct::kBlockReservedBytes;
using cct::kMaxSmemBytes;
using cct::kSmSmemBytes;
using cct::persistent_blocks;
using cct::resident_blocks;
using cct::safe_floor;

// A staged knot: direction (3 floats), then origin (3 floats).
constexpr int kKnotFloats = 6;

inline size_t staged_bytes(int gh, int gw) {
  return sizeof(float) * kKnotFloats * static_cast<size_t>(gh) * gw;
}

inline bool staged(int gh, int gw) {
  return staged_bytes(gh, gw) <= kMaxSmemBytes;
}

inline size_t smem_bytes(int gh, int gw) {
  return staged(gh, gw) ? staged_bytes(gh, gw) : 0;
}

// 256 threads where four blocks fit in one SM's shared memory, 512 where
// two do, else 1024: 32 warps an SM in each case.
inline int threads_per_block(int gh, int gw) {
  const size_t fit = kSmSmemBytes / (smem_bytes(gh, gw) + kBlockReservedBytes);
  return fit >= 4 ? 256 : fit >= 2 ? 512 : 1024;
}

struct Args {
  const float* points;   // (N, 3) camera-frame points
  const float* init;     // (N, 2) warm-start pixels, or null: (cx, cy)
  const float* dirs;     // (gh, gw, 3) direction grid
  const float* origins;  // (gh, gw, 3) origin grid
  int n, gh, gw;
  float min_x, min_y, ext_x, ext_y;  // calibrated area: corner, extent
  float cx, cy;
  float lo_x, lo_y, hi_x, hi_y;
  int iters;
  float eps;
  float* px_out;             // (N, 2)
  float* g_out;              // (N, 2)
  float* cost_out;           // (N)
  unsigned char* valid_out;  // (N)
};

// The window's first knot along an axis: a negative base counts from the
// far end, then the start is held inside the grid.
__device__ __forceinline__ int window_start(int base, int size) {
  return min(max(base < 0 ? base + size : base, 0), size - 4);
}

// min(max(v, lo), hi), NaN kept.
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// Knot k's direction and origin: three 8-byte loads from the staged array,
// or six read-only loads from the two grids.
template <bool kStaged>
__device__ __forceinline__ void load_knot(const float* __restrict__ sknots,
                                          const Args& a, int k, float v[6]) {
  if (kStaged) {
    const float2* p = reinterpret_cast<const float2*>(sknots + kKnotFloats * k);
    const float2 p0 = p[0], p1 = p[1], p2 = p[2];
    v[0] = p0.x;
    v[1] = p0.y;
    v[2] = p1.x;
    v[3] = p1.y;
    v[4] = p2.x;
    v[5] = p2.y;
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = __ldg(a.dirs + 3 * k + c);
      v[3 + c] = __ldg(a.origins + 3 * k + c);
    }
  }
}

// The offset of x from the line at g, its Jacobian columns d offset / d gx
// and d offset / d gy, and the cost |offset|^2.
struct State {
  float r[3], jx[3], jy[3], cost;
};

// One Jacobian column from du = d u / d g and dorg = d o / d g, with
// d = u/|u|, v = x - o, vd = v.d:
//   d offset / d g = -(d (v.P du) + vd P du) / |u| - P dorg, P = I - d d^T.
__device__ __forceinline__ void offset_column(const float d[3],
                                              const float v[3], float vd,
                                              float inv_norm,
                                              const float du[3],
                                              const float dorg[3],
                                              float j[3]) {
  const float dd = d[0] * du[0] + d[1] * du[1] + d[2] * du[2];
  const float dq = d[0] * dorg[0] + d[1] * dorg[1] + d[2] * dorg[2];
  float p[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) p[c] = du[c] - d[c] * dd;
  const float vp = v[0] * p[0] + v[1] * p[1] + v[2] * p[2];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    j[c] = -(d[c] * vp + vd * p[c]) * inv_norm - (dorg[c] - d[c] * dq);
}

template <bool kStaged>
__device__ __forceinline__ State state_at(const float* __restrict__ sknots,
                                          const Args& a, float gx, float gy,
                                          const float x[3]) {
  const float fx = safe_floor(gx), fy = safe_floor(gy);
  float wx[4], wy[4], dwx[4], dwy[4];
  cubic_weights(gx - fx, wx);
  cubic_weights(gy - fy, wy);
  cubic_weight_derivs(gx - fx, dwx);
  cubic_weight_derivs(gy - fy, dwy);
  const int x0 = window_start(static_cast<int>(fx) - 1, a.gw);
  const int y0 = window_start(static_cast<int>(fy) - 1, a.gh);
  // val, and its derivatives along gx and gy: (u, o) each
  float val[6], dvx[6], dvy[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) val[c] = dvx[c] = dvy[c] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float col[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float dcol[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float knot[6];
      load_knot<kStaged>(sknots, a, (y0 + k) * a.gw + x0 + i, knot);
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        col[c] += wy[k] * knot[c];
        dcol[c] += dwy[k] * knot[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      val[c] += wx[i] * col[c];
      dvx[c] += dwx[i] * col[c];
      dvy[c] += wx[i] * dcol[c];
    }
  }
  const float norm =
      sqrtf(val[0] * val[0] + val[1] * val[1] + val[2] * val[2]);
  const float inv_norm = 1.0f / norm;
  float d[3], v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d[c] = val[c] * inv_norm;
    v[c] = x[c] - val[3 + c];
  }
  const float vd = v[0] * d[0] + v[1] * d[1] + v[2] * d[2];
  State s;
  s.cost = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.r[c] = v[c] - vd * d[c];
    s.cost += s.r[c] * s.r[c];
  }
  offset_column(d, v, vd, inv_norm, dvx, dvx + 3, s.jx);
  offset_column(d, v, vd, inv_norm, dvy, dvy + 3, s.jy);
  return s;
}

template <bool kStaged>
__device__ __forceinline__ void project_point(const Args& a,
                                              const float* __restrict__ sknots,
                                              int n) {
  const size_t i = static_cast<size_t>(n);
  const float x[3] = {a.points[3 * i], a.points[3 * i + 1],
                      a.points[3 * i + 2]};
  const float ix = a.init ? a.init[2 * i] : a.cx;
  const float iy = a.init ? a.init[2 * i + 1] : a.cy;
  float gx = 1.0f + (a.gw - 3.0f) * (ix - a.min_x) / a.ext_x;
  float gy = 1.0f + (a.gh - 3.0f) * (iy - a.min_y) / a.ext_y;
  float lam = -1.0f;
  State s = state_at<kStaged>(sknots, a, gx, gy, x);

  for (int it = 0; it < a.iters; ++it) {
    float b0 = 0.0f, b1 = 0.0f, h00 = 0.0f, h11 = 0.0f, h01 = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b0 += s.jx[c] * s.r[c];
      b1 += s.jy[c] * s.r[c];
      h00 += s.jx[c] * s.jx[c];
      h11 += s.jy[c] * s.jy[c];
      h01 += s.jx[c] * s.jy[c];
    }
    if (lam < 0.0f) lam = 0.005f * (h00 + h11);
    const float a00 = h00 + lam, a11 = h11 + lam;
    const float det = a00 * a11 - h01 * h01;
    const float inv_det = fabsf(det) > 1e-30f ? 1.0f / det : 0.0f;
    const float s0 = (a11 * b0 - h01 * b1) * inv_det;
    const float s1 = (a00 * b1 - h01 * b0) * inv_det;
    const float tx = clamp_keep_nan(gx - s0, a.lo_x, a.hi_x);
    const float ty = clamp_keep_nan(gy - s1, a.lo_y, a.hi_y);
    const State t = state_at<kStaged>(sknots, a, tx, ty, x);
    const float cost = s.cost;
    if (t.cost < cost) {
      gx = tx;
      gy = ty;
      s = t;
      lam *= 0.5f;
    } else {
      lam *= 2.0f;
    }
    if (cost < a.eps) break;
  }
  a.g_out[2 * i] = gx;
  a.g_out[2 * i + 1] = gy;
  a.px_out[2 * i] = a.min_x + (gx - 1.0f) / (a.gw - 3.0f) * a.ext_x;
  a.px_out[2 * i + 1] = a.min_y + (gy - 1.0f) / (a.gh - 3.0f) * a.ext_y;
  a.cost_out[i] = s.cost;
  const float scale =
      fmaxf(sqrtf(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]), 1e-6f);
  a.valid_out[i] = sqrtf(s.cost) < 1e-4f * scale;
}

// Both grids into the packed knot array, four loads in flight per thread.
template <int kThreads>
__device__ __forceinline__ void stage_knots(float* sknots,
                                            const float* __restrict__ dirs,
                                            const float* __restrict__ origins,
                                            int count) {
  for (int i = threadIdx.x; i < count; i += 4 * kThreads) {
    float d[4], o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = i + j * kThreads;
      d[j] = k < count ? dirs[k] : 0.0f;
      o[j] = k < count ? origins[k] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = i + j * kThreads;
      if (k < count) {
        const int knot = k / 3, c = k - 3 * knot;
        sknots[kKnotFloats * knot + c] = d[j];
        sknots[kKnotFloats * knot + 3 + c] = o[j];
      }
    }
  }
}

// Persistent blocks: each stages the grids once (kStaged), then takes tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... of kThreads points.
template <int kThreads, bool kStaged>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    ncg_projection_kernel(const Args a) {
  extern __shared__ __align__(16) float sknots[];
  if (kStaged) {
    stage_knots<kThreads>(sknots, a.dirs, a.origins, 3 * a.gh * a.gw);
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long n = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       n < a.n; n += stride)
    project_point<kStaged>(a, sknots, static_cast<int>(n));
}

// Blocks of the kernel resident on one SM at this grid (0 if none fits).
int blocks_per_sm(int gh, int gw) {
  const size_t smem = smem_bytes(gh, gw);
  if (!staged(gh, gw))
    return resident_blocks(ncg_projection_kernel<256, false>, 256, 0);
  switch (threads_per_block(gh, gw)) {
    case 256:
      return resident_blocks(ncg_projection_kernel<256, true>, 256, smem);
    case 512:
      return resident_blocks(ncg_projection_kernel<512, true>, 512, smem);
    default:
      return resident_blocks(ncg_projection_kernel<1024, true>, 1024, smem);
  }
}

cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.n <= 0) return cudaSuccess;
  if (a.gh < 4 || a.gw < 4) return cudaErrorInvalidValue;
  const int per_sm = blocks_per_sm(a.gh, a.gw);
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  int sms = 0;
  const cudaError_t err = cct::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(a.gh, a.gw);
  const int threads = threads_per_block(a.gh, a.gw);
  const int blocks = persistent_blocks(a.n, threads, per_sm, sms);
  if (!staged(a.gh, a.gw))
    ncg_projection_kernel<256, false><<<blocks, 256, 0, stream>>>(a);
  else if (threads == 256)
    ncg_projection_kernel<256, true><<<blocks, 256, smem, stream>>>(a);
  else if (threads == 512)
    ncg_projection_kernel<512, true><<<blocks, 512, smem, stream>>>(a);
  else
    ncg_projection_kernel<1024, true><<<blocks, 1024, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// init may be null: every point then starts at the pixel (cx, cy).
extern "C" int cct_project_noncentral(
    const void* points, const void* init, const void* dirs,
    const void* origins, int n, int gh, int gw, float min_x, float min_y,
    float ext_x, float ext_y, float cx, float cy, float lo_x, float lo_y,
    float hi_x, float hi_y, int iters, float eps, void* px_out, void* g_out,
    void* cost_out, void* valid_out, void* stream) {
  const Args a{static_cast<const float*>(points),
               static_cast<const float*>(init),
               static_cast<const float*>(dirs),
               static_cast<const float*>(origins),
               n, gh, gw, min_x, min_y, ext_x, ext_y, cx, cy,
               lo_x, lo_y, hi_x, hi_y, iters, eps,
               static_cast<float*>(px_out), static_cast<float*>(g_out),
               static_cast<float*>(cost_out),
               static_cast<unsigned char*>(valid_out)};
  return static_cast<int>(launch(a, static_cast<cudaStream_t>(stream)));
}

// The launch plan at this grid: out[0] 1 where the grids are staged in
// shared memory, out[1] threads per block, out[2] dynamic shared memory of
// a block, out[3] blocks resident on one SM (0 if none fits).
extern "C" int cct_project_noncentral_plan(int gh, int gw, int* out) {
  out[0] = staged(gh, gw) ? 1 : 0;
  out[1] = threads_per_block(gh, gw);
  out[2] = static_cast<int>(smem_bytes(gh, gw));
  out[3] = blocks_per_sm(gh, gw);
  return 0;
}
