// CentralGeneric projection kernels: project_kernel<kBlocks>.
//
// Replaces the two Pallas projection kernels of the reference package,
// camera_calibration_tpu/models/central_generic_pallas.py:
//   project_kernel<false>  <-  _project_kernel (:163-173),
//                              called by project_grid_coords_pallas (:341);
//   project_kernel<true>   <-  _blocks_kernel (:176-290),
//                              called by project_blocks_pallas (:388).
// Both share the in-kernel LM loop of _lm_project_loop (:83-160).
//
// What it computes, per point n (one thread per point):
//   a damped 2x2 Levenberg-Marquardt inversion of the normalized cubic
//   B-spline direction surface on grid coordinates g, minimising
//   |normalize(spline(g)) - d_n|^2.  lambda starts at 0.01 * tr(H)/2, is
//   halved on accept and doubled on reject; test steps are clamped to
//   [lo, hi]; a point is done when its cost is below eps or after three
//   rejects in a row, and then leaves the loop (a done point never moves).
//   With kBlocks it then evaluates, at the optimum, the implicit-function
//   sensitivities p_px = (U^T U)^-1 U^T / s, pn = p_px (I - n n^T)/|u| and
//   the 4x4-window knot Jacobian
//     j_win[i*32 + (y*4+x)*2 + j, n] = -w_y w_x (pn_i . frame_j(knot)).
//   The reference kernel also returns pn, which its caller discards
//   (residuals.py:166); this kernel does not write it.
//   A knot of the window that lies outside the grid has weight 0 (never a
//   clamped index), as in the dense one-hot form of the reference.
//
// What bounds it on an H100: arithmetic.  Each LM iteration evaluates the
// surface twice (with derivatives, then at the test point): 2 x 16 knots x
// ~10 FLOP plus the 2x2 solve, about 450 FLOP per iteration, against 20 B
// read and 12 B written per point (kBlocks: 20 B in, 4*(2+1+6+64+2) B
// out).  The grid (and, for kBlocks, the two tangent-frame fields) is
// staged once per block into shared memory, so every window read is an
// on-chip read; outputs are written row-major (rows, N) with N contiguous,
// so the stores of a warp coalesce.  The ragged last block is handled by a
// bounds check.  No grid size is built in: shared memory is sized from
// (gh, gw) at launch, and the wrapper refuses sizes above 227 KB.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cubic_weights(float t, float w[4]) {
  const float t2 = t * t, t3 = t2 * t, om = 1.0f - t;
  w[0] = (om * om * om) / 6.0f;
  w[1] = (3.0f * t3 - 6.0f * t2 + 4.0f) / 6.0f;
  w[2] = (-3.0f * t3 + 3.0f * t2 + 3.0f * t + 1.0f) / 6.0f;
  w[3] = t3 / 6.0f;
}

__device__ __forceinline__ void cubic_weight_derivs(float t, float d[4]) {
  const float t2 = t * t, om = 1.0f - t;
  d[0] = -(om * om) / 2.0f;
  d[1] = (9.0f * t2 - 12.0f * t) / 6.0f;
  d[2] = (-9.0f * t2 + 6.0f * t + 3.0f) / 6.0f;
  d[3] = t2 / 2.0f;
}

// floor(g) held to a range where every window knot is outside the grid
// (NaN maps to one end), so the integer conversion is always defined.
__device__ __forceinline__ float safe_floor(float g) {
  return fminf(fmaxf(floorf(g), -1.0e6f), 1.0e6f);
}

// Surface value u (and, if kDerivs, du/dgx, du/dgy) at grid coords (gx, gy).
template <bool kDerivs>
__device__ void eval_surface(const float* __restrict__ sgrid, int gh, int gw,
                             float gx, float gy, float u[3], float dux[3],
                             float duy[3]) {
  const float fx = safe_floor(gx), fy = safe_floor(gy);
  const int bx = static_cast<int>(fx) - 1, by = static_cast<int>(fy) - 1;
  float wx[4], wy[4], dwx[4], dwy[4];
  cubic_weights(gx - fx, wx);
  cubic_weights(gy - fy, wy);
  if (kDerivs) {
    cubic_weight_derivs(gx - fx, dwx);
    cubic_weight_derivs(gy - fy, dwy);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) u[c] = dux[c] = duy[c] = 0.0f;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const int ky = by + y;
    if (ky < 0 || ky >= gh) continue;
    float row[3] = {0.0f, 0.0f, 0.0f}, drow[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int kx = bx + x;
      if (kx < 0 || kx >= gw) continue;
      const float* k = sgrid + 3 * (ky * gw + kx);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        row[c] += wx[x] * k[c];
        if (kDerivs) drow[c] += dwx[x] * k[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u[c] += wy[y] * row[c];
      if (kDerivs) {
        dux[c] += wy[y] * drow[c];
        duy[c] += dwy[y] * row[c];
      }
    }
  }
}

__device__ __forceinline__ float dir_cost(const float* __restrict__ sgrid,
                                          int gh, int gw, float gx, float gy,
                                          const float d[3]) {
  float u[3], unused0[3], unused1[3];
  eval_surface<false>(sgrid, gh, gw, gx, gy, u, unused0, unused1);
  const float inv = 1.0f / sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]);
  float cost = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float r = u[c] * inv - d[c];
    cost += r * r;
  }
  return cost;
}

// Columns U[:, 0] = d un / d gx, U[:, 1] = d un / d gy of the normalized
// surface, with un itself and 1/|u|.
__device__ __forceinline__ void normalized_jacobian(
    const float u[3], const float dux[3], const float duy[3], float n[3],
    float ux[3], float uy[3], float* inv_out) {
  const float inv = 1.0f / sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]);
#pragma unroll
  for (int c = 0; c < 3; ++c) n[c] = u[c] * inv;
  const float sx = n[0] * dux[0] + n[1] * dux[1] + n[2] * dux[2];
  const float sy = n[0] * duy[0] + n[1] * duy[1] + n[2] * duy[2];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ux[c] = (dux[c] - n[c] * sx) * inv;
    uy[c] = (duy[c] - n[c] * sy) * inv;
  }
  *inv_out = inv;
}

template <bool kBlocks>
__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ dirs, const float* __restrict__ g0,
               const float* __restrict__ grid, const float* __restrict__ t1,
               const float* __restrict__ t2, int n_pts, int gh, int gw,
               float lo_x, float lo_y, float hi_x, float hi_y, int iters,
               float eps, float inv_sx, float inv_sy,
               float* __restrict__ g_out, float* __restrict__ cost_out,
               float* __restrict__ ppx_out, float* __restrict__ jwin_out,
               int* __restrict__ base_out) {
  extern __shared__ float smem[];
  const int cells3 = 3 * gh * gw;
  float* sgrid = smem;
  float* st1 = smem + cells3;
  float* st2 = smem + 2 * cells3;
  for (int i = threadIdx.x; i < cells3; i += blockDim.x) {
    sgrid[i] = grid[i];
    if (kBlocks) {
      st1[i] = t1[i];
      st2[i] = t2[i];
    }
  }
  __syncthreads();

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_pts) return;
  const size_t N = static_cast<size_t>(n_pts);
  const float d[3] = {dirs[3 * n], dirs[3 * n + 1], dirs[3 * n + 2]};
  float gx = g0[2 * n], gy = g0[2 * n + 1];
  float lam = -1.0f;
  int rejects = 0;
  float u[3], dux[3], duy[3], nv[3], jx[3], jy[3], inv;

  for (int it = 0; it < iters; ++it) {
    eval_surface<true>(sgrid, gh, gw, gx, gy, u, dux, duy);
    normalized_jacobian(u, dux, duy, nv, jx, jy, &inv);
    float cost = 0.0f, b0 = 0.0f, b1 = 0.0f;
    float h00 = 0.0f, h11 = 0.0f, h01 = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float r = nv[c] - d[c];
      cost += r * r;
      b0 += jx[c] * r;
      b1 += jy[c] * r;
      h00 += jx[c] * jx[c];
      h11 += jy[c] * jy[c];
      h01 += jx[c] * jy[c];
    }
    if (lam < 0.0f) lam = 0.01f * (0.5f * (h00 + h11));
    const float a00 = h00 + lam, a11 = h11 + lam;
    const float det = a00 * a11 - h01 * h01;
    const float inv_det = fabsf(det) > 1e-30f ? 1.0f / det : 0.0f;
    const float s0 = (a11 * b0 - h01 * b1) * inv_det;
    const float s1 = (a00 * b1 - h01 * b0) * inv_det;
    const float tx = fminf(fmaxf(gx - s0, lo_x), hi_x);
    const float ty = fminf(fmaxf(gy - s1, lo_y), hi_y);
    if (dir_cost(sgrid, gh, gw, tx, ty, d) < cost) {
      gx = tx;
      gy = ty;
      lam *= 0.5f;
      rejects = 0;
    } else {
      lam *= 2.0f;
      ++rejects;
    }
    if (cost < eps || rejects >= 3) break;
  }
  g_out[n] = gx;
  g_out[N + n] = gy;
  cost_out[n] = dir_cost(sgrid, gh, gw, gx, gy, d);
  if (!kBlocks) return;

  // ---- implicit-function-theorem sensitivities at the optimum ----
  eval_surface<true>(sgrid, gh, gw, gx, gy, u, dux, duy);
  normalized_jacobian(u, dux, duy, nv, jx, jy, &inv);
  const float a00 = jx[0] * jx[0] + jx[1] * jx[1] + jx[2] * jx[2];
  const float a11 = jy[0] * jy[0] + jy[1] * jy[1] + jy[2] * jy[2];
  const float a01 = jx[0] * jy[0] + jx[1] * jy[1] + jx[2] * jy[2];
  const float det = a00 * a11 - a01 * a01;
  const float inv_det = fabsf(det) > 1e-30f ? 1.0f / det : 0.0f;
  float p[2][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p[0][c] = (a11 * jx[c] - a01 * jy[c]) * inv_det * inv_sx;
    p[1][c] = (a00 * jy[c] - a01 * jx[c]) * inv_det * inv_sy;
    ppx_out[c * N + n] = p[0][c];
    ppx_out[(3 + c) * N + n] = p[1][c];
  }
  float pn[2][3];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float pd = p[i][0] * nv[0] + p[i][1] * nv[1] + p[i][2] * nv[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) pn[i][c] = (p[i][c] - pd * nv[c]) * inv;
  }

  // ---- window base + per-knot Jacobian rows ----
  const float fx = safe_floor(gx), fy = safe_floor(gy);
  const int bx = static_cast<int>(fx) - 1, by = static_cast<int>(fy) - 1;
  base_out[n] = bx;
  base_out[N + n] = by;
  float wx[4], wy[4];
  cubic_weights(gx - fx, wx);
  cubic_weights(gy - fy, wy);
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const int ky = by + y;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int kx = bx + x;
      float f1[3] = {0.0f, 0.0f, 0.0f}, f2[3] = {0.0f, 0.0f, 0.0f};
      float wgt = 0.0f;
      if (ky >= 0 && ky < gh && kx >= 0 && kx < gw) {
        const int k = 3 * (ky * gw + kx);
        wgt = wy[y] * wx[x];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          f1[c] = st1[k + c];
          f2[c] = st2[k + c];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = i * 32 + (y * 4 + x) * 2;
        jwin_out[row * N + n] =
            -wgt * (pn[i][0] * f1[0] + pn[i][1] * f1[1] + pn[i][2] * f1[2]);
        jwin_out[(row + 1) * N + n] =
            -wgt * (pn[i][0] * f2[0] + pn[i][1] * f2[1] + pn[i][2] * f2[2]);
      }
    }
  }
}

template <bool kBlocks>
cudaError_t launch(const float* dirs, const float* g0, const float* grid,
                   const float* t1, const float* t2, int n, int gh, int gw,
                   float lo_x, float lo_y, float hi_x, float hi_y, int iters,
                   float eps, float inv_sx, float inv_sy, float* g_out,
                   float* cost_out, float* ppx_out, float* jwin_out,
                   int* base_out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * gh * gw * (kBlocks ? 3 : 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        project_kernel<kBlocks>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  project_kernel<kBlocks><<<blocks, kThreads, smem, stream>>>(
      dirs, g0, grid, t1, t2, n, gh, gw, lo_x, lo_y, hi_x, hi_y, iters, eps,
      inv_sx, inv_sy, g_out, cost_out, ppx_out, jwin_out, base_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cct_project(const void* dirs, const void* g0, const void* grid,
                           int n, int gh, int gw, float lo_x, float lo_y,
                           float hi_x, float hi_y, int iters, float eps,
                           void* g_out, void* cost_out, void* stream) {
  return static_cast<int>(launch<false>(
      static_cast<const float*>(dirs), static_cast<const float*>(g0),
      static_cast<const float*>(grid), nullptr, nullptr, n, gh, gw, lo_x,
      lo_y, hi_x, hi_y, iters, eps, 1.0f, 1.0f, static_cast<float*>(g_out),
      static_cast<float*>(cost_out), nullptr, nullptr, nullptr,
      static_cast<cudaStream_t>(stream)));
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
  return static_cast<int>(launch<true>(
      static_cast<const float*>(dirs), static_cast<const float*>(g0),
      static_cast<const float*>(grid), static_cast<const float*>(t1),
      static_cast<const float*>(t2), n, gh, gw, lo_x, lo_y, hi_x, hi_y, iters,
      eps, inv_sx, inv_sy, static_cast<float*>(g_out),
      static_cast<float*>(cost_out), static_cast<float*>(ppx_out),
      static_cast<float*>(jwin_out), static_cast<int*>(base_out),
      static_cast<cudaStream_t>(stream)));
}
