// J_intr . v for spline-grid intrinsics: apply_j_kernel<K, E>.
//
// Replaces the Pallas kernel _apply_j_kernel of the reference package,
// camera_calibration_tpu/ba/window_pallas.py:133-154, called through
// _apply_j_call (:165-188, pallas_call at :171) by window_apply_j
// (:243-268).
//
// What it computes, per observation n:
//   out[n, i] = sum_{y,x,j} j_win[i*16K + (y*4+x)*K + j, n]
//                           * v[by+y, bx+x, j],
// with (bx, by) = base[n]; a knot outside the grid contributes nothing.
// K = 2 (central models) and K = 5 (noncentral) are instantiated, each for
// a float32 and a bfloat16 j_win (the reference kernel's bf16 read, :152:
// the CG matvecs' copies); bf16 values are widened on load and the sums
// are float32.
//
// What bounds it on an H100: memory bandwidth.  Each observation reads
// 32K values of j_win once (256 B at K = 2 in float32) for 64K FLOP, far
// below the card's ~20 FLOP/B balance point.  At the pipelines' sizes
// (N = 57,600 at K = 2, 9,500 at K = 5) the whole read is 6-15 MB, a few
// microseconds: the card is full only if every SM has loads in flight
// from the start.
//
// The design.  Each observation is split over kParts = 4 warps, one per
// window row y (both outputs); the 32 lanes of a warp take 32 consecutive
// observations, so every j_win row a warp reads is 128 contiguous bytes
// (64 in bf16): whole sectors.  After the window base, a warp loads all
// its row's j_win values of knots in the grid into registers, without
// allocating them in L1, before it reads any tangent value; the tangent
// is read through the read-only path, where the few lines a block's
// windows touch stay in the SM's L1.  Each row's taps are added in a
// fixed order (x, then j); the rows' sums meet in shared memory and one
// thread adds them in the order y = 0..3, so the result repeats bit for
// bit, with no atomics.  One block per kObs observations, all launched at
// once; no dynamic shared memory, so no launch sets a function attribute.
// A copy of the tangent in shared memory (by one bulk copy a persistent
// block, or by each block on small grids), one warp per (y, i) at K = 5,
// one or two warps per observation, blocks of 512 threads, and j_win
// loads that do not wait for the base were slower or no faster on the
// card.  The TPU version's base-indicator matmuls and bf16 hi/lo splits
// are MXU devices and are not carried over.

#include <cuda_runtime.h>

#include <cstddef>

#include "element.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Warps per observation, and observations per block.  Mirrored by
// APPLY_J_PARTS and APPLY_J_OBS_PER_BLOCK in ba/window_cuda.py.
constexpr int kParts = 4;
constexpr int kObs = 32 * kWarps / kParts;

template <int K, class E>
__global__ void __launch_bounds__(kThreads)
apply_j_kernel(const E* __restrict__ jwin, const int* __restrict__ base,
               int base_sn, int base_sc, const float* __restrict__ tangent,
               int n_obs, int gh, int gw, float* __restrict__ out) {
  __shared__ float red[kWarps / kParts][4][2][32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int y = warp % kParts, group = warp / kParts;
  const int n = blockIdx.x * kObs + group * 32 + lane;
  const size_t N = static_cast<size_t>(n_obs);
  int bx = 0, ky = -1;
  if (n < n_obs) {
    bx = __ldg(base + n * static_cast<size_t>(base_sn));
    ky = __ldg(base + n * static_cast<size_t>(base_sn) + base_sc) + y;
  }
  unsigned inside = 0;  // bit x: knot (ky, bx + x) lies in the grid
  if (ky >= 0 && ky < gh) {
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if (bx + x >= 0 && bx + x < gw) inside |= 1u << x;
  }
  // every j_win value of this row's knots in the grid, before any tangent
  // read
  float jv[4][K][2];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const size_t row =
            static_cast<size_t>(i * 16 * K + (y * 4 + x) * K + j);
        jv[x][j][i] = (inside >> x & 1u) ? cct::load_once(jwin + row * N + n)
                                         : 0.0f;
      }
  float acc[2] = {0.0f, 0.0f};
  const int t0 = (ky * gw + bx) * K;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    if (!(inside >> x & 1u)) continue;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float v = __ldg(tangent + t0 + x * K + j);
#pragma unroll
      for (int i = 0; i < 2; ++i) acc[i] = fmaf(jv[x][j][i], v, acc[i]);
    }
  }
  red[group][y][0][lane] = acc[0];
  red[group][y][1][lane] = acc[1];
  __syncthreads();
  if (threadIdx.x < kObs) {
    const int g = threadIdx.x >> 5, l = threadIdx.x & 31;
    const int m = blockIdx.x * kObs + threadIdx.x;
    float s[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      s[i] = ((red[g][0][i][l] + red[g][1][i][l]) + red[g][2][i][l]) +
             red[g][3][i][l];
    if (m < n_obs) reinterpret_cast<float2*>(out)[m] = make_float2(s[0], s[1]);
  }
}

int blocks_for(int n) { return (n + kObs - 1) / kObs; }

template <int K, class E>
cudaError_t launch(const void* jwin, const int* base, int base_sn,
                   int base_sc, const float* tangent, int n, int gh, int gw,
                   float* out, cudaStream_t stream) {
  apply_j_kernel<K, E><<<blocks_for(n), kThreads, 0, stream>>>(
      static_cast<const E*>(jwin), base, base_sn, base_sc, tangent, n, gh,
      gw, out);
  return cudaGetLastError();
}

template <class E>
cudaError_t launch_k(int k, const void* jwin, const int* base, int base_sn,
                     int base_sc, const float* tangent, int n, int gh, int gw,
                     float* out, cudaStream_t stream) {
  if (k == 2)
    return launch<2, E>(jwin, base, base_sn, base_sc, tangent, n, gh, gw,
                        out, stream);
  if (k == 5)
    return launch<5, E>(jwin, base, base_sn, base_sc, tangent, n, gh, gw,
                        out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// The launch plan of cct_window_apply_j for N observations at this K:
// out[0] warps per observation, out[1] threads per block, out[2] blocks.
extern "C" int cct_window_apply_j_plan(int k, int n, int* out) {
  if (k != 2 && k != 5) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = kParts;
  out[1] = kThreads;
  out[2] = blocks_for(n);
  return 0;
}

// elem_bytes: 4 for a float32 j_win, 2 for a bfloat16 one.
extern "C" int cct_window_apply_j(const void* jwin, const void* base,
                                  int base_sn, int base_sc,
                                  const void* tangent, int n, int gh, int gw,
                                  int k, int elem_bytes, void* out,
                                  void* stream) {
  const int* b = static_cast<const int*>(base);
  const float* t = static_cast<const float*>(tangent);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return static_cast<int>(launch_k<float>(k, jwin, b, base_sn, base_sc, t,
                                            n, gh, gw, o, s));
  if (elem_bytes == 2)
    return static_cast<int>(launch_k<__nv_bfloat16>(
        k, jwin, b, base_sn, base_sc, t, n, gh, gw, o, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
