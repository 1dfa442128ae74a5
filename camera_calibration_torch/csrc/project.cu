// CentralGeneric projection kernels: project_kernel<kBlocks, kThreads, kStaged>.
//
// Replaces the two Pallas projection kernels of the reference package,
// camera_calibration_tpu/models/central_generic_pallas.py:
//   project_kernel<false, *>  <-  _project_kernel (:163-173),
//                                 called by project_grid_coords_pallas (:341);
//   project_kernel<true, *>   <-  _blocks_kernel (:176-290),
//                                 called by project_blocks_pallas (:388).
// Both share the in-kernel LM loop of _lm_project_loop (:83-160).
//
// What it computes, per point n (one thread per point):
//   a damped 2x2 Levenberg-Marquardt inversion of the normalized cubic
//   B-spline direction surface on grid coordinates g, minimising
//   |normalize(spline(g)) - d_n|^2.  lambda starts at 0.01 * tr(H)/2, is
//   halved on accept and doubled on reject; test steps are clamped to
//   [lo, hi]; a point is done when its cost is below eps or after three
//   rejects in a row, and then leaves the loop (a done point never moves).
//   The cost written is the cost at the final g.  With kBlocks it then
//   evaluates, at the optimum, the implicit-function sensitivities
//   p_px = (U^T U)^-1 U^T / s, pn = p_px (I - n n^T)/|u| and the
//   4x4-window knot Jacobian
//     j_win[i*32 + (y*4+x)*2 + j, n] = -w_y w_x (pn_i . frame_j(knot)).
//   The reference kernel also returns pn, which its caller discards
//   (residuals.py:166); this kernel does not write it.
//   A knot of the window that lies outside the grid has weight 0, as in the
//   dense one-hot form of the reference.
//
// What bounds it on an H100: the LM loop's instruction stream and its
// latency (about 550 FLOP per iteration against 20 B read and 12 B written
// per point); the blocks form also writes 4*(2+1+6+64+2) B per point, which
// bounds it by bytes.  The design:
// - One surface evaluation per iteration: the test point is evaluated with
//   derivatives, and on accept that state is the next iteration's, so the
//   loop never evaluates a point twice, and the final cost and the blocks
//   tail's Jacobian come out of the loop.
// - No IEEE division or square root: the 1/6 of the spline weights is
//   folded into the polynomials, 1/|u| and the 2x2 solve's reciprocal are
//   one MUFU instruction each (the build has no fast-math flag).
// - The grid (and, for kBlocks, both frame fields) is staged once per block
//   in shared memory as packed 12-byte knots; the 16 taps are straight-line
//   code, each reading a clamped index with its weight zeroed outside the
//   grid.
// - Where the staged fields do not fit one block's 227 KB (project above
//   19,370 knots, e.g. 140x140; project_blocks above 6,456, e.g. the 84x100
//   grid of a 2448x2048 camera at 25 px a cell), the same kernel runs with
//   kStaged = false: the taps read the (gh, gw, 3) arrays, whose layout is
//   the staged one, straight from device memory through the read-only
//   path.  300 KB of fields stay resident in the 50 MB L2, so the taps hit
//   L2 instead of shared memory; the launch then takes no dynamic shared
//   memory and blocks of 256 threads.
// - Persistent blocks: as many as are resident on the card, each staging
//   once and walking tiles of kThreads points with a stride; the warps of a
//   block do not wait for each other after the staging, so one warp's
//   stores overlap the loops of others.  Blocks of 256 threads where four
//   fit in an SM's shared memory, else one block of 1024; both at 64
//   registers a thread, 32 warps an SM.
// Outputs are written row-major (rows, N) with N contiguous, so the stores
// of a warp coalesce.  No grid size is built in: shared memory is sized
// from (gh, gw) at launch, and no grid is refused for its size.

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

// Bytes of the staged fields: the grid and, for the blocks form, the two
// frame fields, 12 bytes a knot each.
inline size_t staged_bytes(bool blocks, int gh, int gw) {
  return (blocks ? 36 : 12) * static_cast<size_t>(gh) * gw;
}

// Whether the fields are staged in shared memory (they fit one block).
// Mirrored by project_staged in models/central_generic_cuda.py.
inline bool staged(bool blocks, int gh, int gw) {
  return staged_bytes(blocks, gh, gw) <= kMaxSmemBytes;
}

// Dynamic shared memory of one block: the staged fields, or none.
// Mirrored by project_smem_bytes in models/central_generic_cuda.py.
inline size_t smem_bytes(bool blocks, int gh, int gw) {
  return staged(blocks, gh, gw) ? staged_bytes(blocks, gh, gw) : 0;
}

// Threads per block: 256 where four such blocks fit in one SM's shared
// memory (always, unstaged), else 1024, so that an SM holds 32 warps either
// way.  Mirrored by threads() in models/central_generic_cuda.py.
inline int threads_per_block(bool blocks, int gh, int gw) {
  return 4 * (smem_bytes(blocks, gh, gw) + kBlockReservedBytes) <=
                 kSmSmemBytes
             ? 256
             : 1024;
}

struct Args {
  const float* dirs;  // (N, 3)
  const float* g0;    // (N, 2)
  const float* grid;  // (gh, gw, 3)
  const float* t1;    // (gh, gw, 3), kBlocks only
  const float* t2;
  int n, gh, gw;
  float lo_x, lo_y, hi_x, hi_y;
  int iters;
  float eps, inv_sx, inv_sy;
  float* g_out;     // (2, N)
  float* cost_out;  // (N)
  float* ppx_out;   // (6, N), kBlocks only
  float* jwin_out;  // (64, N)
  int* base_out;    // (2, N)
};

// 1/x and 1/sqrt(x), one MUFU instruction each (1 ulp, and 2^-22.9
// relative; denormal inputs read as 0).  The build has no fast-math flag,
// so `1.0f / x` or `sqrtf` would compile to the IEEE-exact sequence with its
// range check and slow path.  The reference kernel uses rsqrt as well.
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One value of a field: from shared memory when staged, else from device
// memory through the read-only (non-coherent) path.
template <bool kStaged>
__device__ __forceinline__ float field(const float* __restrict__ p) {
  if (kStaged) return *p;
  return __ldg(p);
}

// dst[i] = src[i] for i < count, four loads in flight per thread.
__device__ __forceinline__ void copy_to_smem(float* dst,
                                             const float* __restrict__ src,
                                             int count) {
  for (int i = threadIdx.x; i < count; i += 4 * blockDim.x) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = i + j * blockDim.x;
      v[j] = k < count ? src[k] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = i + j * blockDim.x;
      if (k < count) dst[k] = v[j];
    }
  }
}

// Surface value u and its derivatives du/dgx, du/dgy at grid coords
// (gx, gy).  Each tap reads a knot index clamped into the grid; the weights
// of taps outside it are 0.
template <bool kStaged>
__device__ __forceinline__ void eval_surface(const float* __restrict__ sgrid,
                                             int gh, int gw, float gx,
                                             float gy, float u[3],
                                             float dux[3], float duy[3]) {
  const float fx = safe_floor(gx), fy = safe_floor(gy);
  const int bx = static_cast<int>(fx) - 1, by = static_cast<int>(fy) - 1;
  float wx[4], wy[4], dwx[4], dwy[4];
  cubic_weights(gx - fx, wx);
  cubic_weights(gy - fy, wy);
  cubic_weight_derivs(gx - fx, dwx);
  cubic_weight_derivs(gy - fy, dwy);
  int ox[4], oy[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool in_x = bx + i >= 0 && bx + i < gw;
    const bool in_y = by + i >= 0 && by + i < gh;
    ox[i] = min(max(bx + i, 0), gw - 1);
    oy[i] = min(max(by + i, 0), gh - 1) * gw;
    wx[i] = in_x ? wx[i] : 0.0f;
    dwx[i] = in_x ? dwx[i] : 0.0f;
    wy[i] = in_y ? wy[i] : 0.0f;
    dwy[i] = in_y ? dwy[i] : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) u[c] = dux[c] = duy[c] = 0.0f;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    float row[3] = {0.0f, 0.0f, 0.0f}, drow[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float* k = sgrid + 3 * (oy[y] + ox[x]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float kc = field<kStaged>(k + c);
        row[c] += wx[x] * kc;
        drow[c] += dwx[x] * kc;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u[c] += wy[y] * row[c];
      dux[c] += wy[y] * drow[c];
      duy[c] += dwy[y] * row[c];
    }
  }
}

// The surface at one point g: the normalized direction n, the columns
// U[:, 0] = d n / d gx, U[:, 1] = d n / d gy, 1/|u|, and the cost
// |n - d|^2.
struct State {
  float n[3], jx[3], jy[3], inv, cost;
};

template <bool kStaged>
__device__ __forceinline__ State state_at(const float* __restrict__ sgrid,
                                          int gh, int gw, float gx, float gy,
                                          const float d[3]) {
  float u[3], dux[3], duy[3];
  eval_surface<kStaged>(sgrid, gh, gw, gx, gy, u, dux, duy);
  State s;
  s.inv = rsqrt_approx(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]);
#pragma unroll
  for (int c = 0; c < 3; ++c) s.n[c] = u[c] * s.inv;
  const float sx = s.n[0] * dux[0] + s.n[1] * dux[1] + s.n[2] * dux[2];
  const float sy = s.n[0] * duy[0] + s.n[1] * duy[1] + s.n[2] * duy[2];
  s.cost = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.jx[c] = (dux[c] - s.n[c] * sx) * s.inv;
    s.jy[c] = (duy[c] - s.n[c] * sy) * s.inv;
    const float r = s.n[c] - d[c];
    s.cost += r * r;
  }
  return s;
}

// Everything for point n.  The loop evaluates the surface once per
// iteration, at the test point: on accept that state is the next
// iteration's, on reject the current one stays.  sgrid, st1 and st2 are the
// staged fields (kStaged) or the arguments' own.
template <bool kBlocks, bool kStaged>
__device__ __forceinline__ void project_point(const Args a,
                                              const float* __restrict__ sgrid,
                                              const float* __restrict__ st1,
                                              const float* __restrict__ st2,
                                              int n) {
  const int gh = a.gh, gw = a.gw;
  const size_t N = static_cast<size_t>(a.n), idx = static_cast<size_t>(n);
  const float d[3] = {a.dirs[3 * idx], a.dirs[3 * idx + 1],
                      a.dirs[3 * idx + 2]};
  float gx = a.g0[2 * idx], gy = a.g0[2 * idx + 1];
  float lam = -1.0f;
  int rejects = 0;
  State s = state_at<kStaged>(sgrid, gh, gw, gx, gy, d);

  for (int it = 0; it < a.iters; ++it) {
    float b0 = 0.0f, b1 = 0.0f, h00 = 0.0f, h11 = 0.0f, h01 = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float r = s.n[c] - d[c];
      b0 += s.jx[c] * r;
      b1 += s.jy[c] * r;
      h00 += s.jx[c] * s.jx[c];
      h11 += s.jy[c] * s.jy[c];
      h01 += s.jx[c] * s.jy[c];
    }
    if (lam < 0.0f) lam = 0.01f * (0.5f * (h00 + h11));
    const float a00 = h00 + lam, a11 = h11 + lam;
    const float det = a00 * a11 - h01 * h01;
    const float inv_det = fabsf(det) > 1e-30f ? rcp_approx(det) : 0.0f;
    const float s0 = (a11 * b0 - h01 * b1) * inv_det;
    const float s1 = (a00 * b1 - h01 * b0) * inv_det;
    const float tx = fminf(fmaxf(gx - s0, a.lo_x), a.hi_x);
    const float ty = fminf(fmaxf(gy - s1, a.lo_y), a.hi_y);
    const State t = state_at<kStaged>(sgrid, gh, gw, tx, ty, d);
    const float cost = s.cost;
    if (t.cost < cost) {
      gx = tx;
      gy = ty;
      s = t;
      lam *= 0.5f;
      rejects = 0;
    } else {
      lam *= 2.0f;
      ++rejects;
    }
    if (cost < a.eps || rejects >= 3) break;
  }
  a.g_out[n] = gx;
  a.g_out[N + n] = gy;
  a.cost_out[n] = s.cost;
  if (!kBlocks) return;

  // ---- implicit-function-theorem sensitivities at the optimum ----
  const float a00 = s.jx[0] * s.jx[0] + s.jx[1] * s.jx[1] + s.jx[2] * s.jx[2];
  const float a11 = s.jy[0] * s.jy[0] + s.jy[1] * s.jy[1] + s.jy[2] * s.jy[2];
  const float a01 = s.jx[0] * s.jy[0] + s.jx[1] * s.jy[1] + s.jx[2] * s.jy[2];
  const float det = a00 * a11 - a01 * a01;
  const float inv_det = fabsf(det) > 1e-30f ? rcp_approx(det) : 0.0f;
  float p[2][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p[0][c] = (a11 * s.jx[c] - a01 * s.jy[c]) * inv_det * a.inv_sx;
    p[1][c] = (a00 * s.jy[c] - a01 * s.jx[c]) * inv_det * a.inv_sy;
    a.ppx_out[c * N + n] = p[0][c];
    a.ppx_out[(3 + c) * N + n] = p[1][c];
  }
  float pn[2][3];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float pd = p[i][0] * s.n[0] + p[i][1] * s.n[1] + p[i][2] * s.n[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) pn[i][c] = (p[i][c] - pd * s.n[c]) * s.inv;
  }

  // ---- window base + per-knot Jacobian rows ----
  const float fx = safe_floor(gx), fy = safe_floor(gy);
  const int bx = static_cast<int>(fx) - 1, by = static_cast<int>(fy) - 1;
  a.base_out[n] = bx;
  a.base_out[N + n] = by;
  float wx[4], wy[4];
  cubic_weights(gx - fx, wx);
  cubic_weights(gy - fy, wy);
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const int ky = by + y;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int kx = bx + x;
      // A knot outside the grid reads a clamped one and weighs 0.
      const bool inside = ky >= 0 && ky < gh && kx >= 0 && kx < gw;
      const float wgt = inside ? wy[y] * wx[x] : 0.0f;
      const int k = 3 * (min(max(ky, 0), gh - 1) * gw + min(max(kx, 0), gw - 1));
      float f1[3], f2[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        f1[c] = field<kStaged>(st1 + k + c);
        f2[c] = field<kStaged>(st2 + k + c);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = i * 32 + (y * 4 + x) * 2;
        a.jwin_out[row * N + n] =
            -wgt * (pn[i][0] * f1[0] + pn[i][1] * f1[1] + pn[i][2] * f1[2]);
        a.jwin_out[(row + 1) * N + n] =
            -wgt * (pn[i][0] * f2[0] + pn[i][1] * f2[1] + pn[i][2] * f2[2]);
      }
    }
  }
}

// Persistent blocks: each stages the grid (and the frames) once, unless
// kStaged is false, then takes tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// of kThreads points.  Registers are held to 64 a thread, so that an SM
// holds 32 warps.
template <bool kBlocks, int kThreads, bool kStaged>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    project_kernel(const Args a) {
  extern __shared__ __align__(16) float sgrid[];
  const int cells3 = 3 * a.gh * a.gw;
  const float* grid = a.grid;
  const float* t1 = a.t1;
  const float* t2 = a.t2;
  if (kStaged) {
    copy_to_smem(sgrid, a.grid, cells3);
    grid = sgrid;
    if (kBlocks) {
      copy_to_smem(sgrid + cells3, a.t1, cells3);
      copy_to_smem(sgrid + 2 * cells3, a.t2, cells3);
      t1 = sgrid + cells3;
      t2 = sgrid + 2 * cells3;
    }
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long n = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       n < a.n; n += stride)
    project_point<kBlocks, kStaged>(a, grid, t1, t2, static_cast<int>(n));
}

// Blocks of the kernel resident on one SM at this grid (0 if none fits).
template <bool kBlocks>
int blocks_per_sm(int gh, int gw) {
  const size_t smem = smem_bytes(kBlocks, gh, gw);
  if (!staged(kBlocks, gh, gw))
    return resident_blocks(project_kernel<kBlocks, 256, false>, 256, 0);
  return threads_per_block(kBlocks, gh, gw) == 256
             ? resident_blocks(project_kernel<kBlocks, 256, true>, 256, smem)
             : resident_blocks(project_kernel<kBlocks, 1024, true>, 1024,
                               smem);
}

template <bool kBlocks>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.n <= 0) return cudaSuccess;
  const int per_sm = blocks_per_sm<kBlocks>(a.gh, a.gw);
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  int sms = 0;
  const cudaError_t err = cct::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(kBlocks, a.gh, a.gw);
  const int threads = threads_per_block(kBlocks, a.gh, a.gw);
  const int blocks = persistent_blocks(a.n, threads, per_sm, sms);
  if (!staged(kBlocks, a.gh, a.gw))
    project_kernel<kBlocks, 256, false><<<blocks, 256, 0, stream>>>(a);
  else if (threads == 256)
    project_kernel<kBlocks, 256, true><<<blocks, 256, smem, stream>>>(a);
  else
    project_kernel<kBlocks, 1024, true><<<blocks, 1024, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cct_project(const void* dirs, const void* g0, const void* grid,
                           int n, int gh, int gw, float lo_x, float lo_y,
                           float hi_x, float hi_y, int iters, float eps,
                           void* g_out, void* cost_out, void* stream) {
  Args a{static_cast<const float*>(dirs), static_cast<const float*>(g0),
         static_cast<const float*>(grid), nullptr, nullptr, n, gh, gw,
         lo_x, lo_y, hi_x, hi_y, iters, eps, 1.0f, 1.0f,
         static_cast<float*>(g_out), static_cast<float*>(cost_out), nullptr,
         nullptr, nullptr};
  return static_cast<int>(launch<false>(a, static_cast<cudaStream_t>(stream)));
}

extern "C" int cct_project_blocks(const void* dirs, const void* g0,
                                  const void* grid, const void* t1,
                                  const void* t2, int n, int gh, int gw,
                                  float lo_x, float lo_y, float hi_x,
                                  float hi_y, int iters, float eps,
                                  float inv_sx, float inv_sy, void* g_out,
                                  void* cost_out, void* ppx_out,
                                  void* jwin_out, void* base_out,
                                  void* stream) {
  Args a{static_cast<const float*>(dirs), static_cast<const float*>(g0),
         static_cast<const float*>(grid), static_cast<const float*>(t1),
         static_cast<const float*>(t2), n, gh, gw, lo_x, lo_y, hi_x, hi_y,
         iters, eps, inv_sx, inv_sy, static_cast<float*>(g_out),
         static_cast<float*>(cost_out), static_cast<float*>(ppx_out),
         static_cast<float*>(jwin_out), static_cast<int*>(base_out)};
  return static_cast<int>(launch<true>(a, static_cast<cudaStream_t>(stream)));
}

// Blocks of cct_project (blocks = 0) or cct_project_blocks (blocks = 1)
// resident on one SM at this grid, in the block size it launches with (0 if
// none fits).
extern "C" int cct_project_blocks_per_sm(int blocks, int gh, int gw) {
  return blocks ? blocks_per_sm<true>(gh, gw) : blocks_per_sm<false>(gh, gw);
}

// Threads per block of cct_project (blocks = 0) or cct_project_blocks
// (blocks = 1) at this grid.
extern "C" int cct_project_threads(int blocks, int gh, int gw) {
  return threads_per_block(blocks != 0, gh, gw);
}

// Dynamic shared memory of one block of cct_project (blocks = 0) or
// cct_project_blocks (blocks = 1) at this grid (0 where the fields are read
// from device memory).
extern "C" long long cct_project_smem_bytes(int blocks, int gh, int gw) {
  return static_cast<long long>(smem_bytes(blocks != 0, gh, gw));
}

// Whether cct_project (blocks = 0) or cct_project_blocks (blocks = 1) stages
// its fields in shared memory at this grid (1) or reads them from device
// memory (0).
extern "C" int cct_project_staged(int blocks, int gh, int gw) {
  return staged(blocks != 0, gh, gw) ? 1 : 0;
}
