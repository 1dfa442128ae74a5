// J_intr . v for spline-grid intrinsics: apply_j_kernel<K, E, kStaged>.
//
// Replaces the Pallas kernel _apply_j_kernel of the reference package,
// camera_calibration_tpu/ba/window_pallas.py:133-154, called through
// _apply_j_call (:165-188, pallas_call at :171) by window_apply_j
// (:243-268).
//
// What it computes, per observation n (one thread each):
//   out[n, i] = sum_{y,x,j} j_win[i*16K + (y*4+x)*K + j, n]
//                           * v[by+y, bx+x, j],
// with (bx, by) = base[n]; a knot outside the grid contributes nothing.
// K = 2 (central models) and K = 5 (noncentral) are instantiated, each for
// a float32 and a bfloat16 j_win (the reference kernel's bf16 read, :152:
// the CG matvecs' copies); bf16 values are widened on load and the sums
// are float32.
//
// What bounds it on an H100: memory bandwidth.  Each observation reads
// 32K floats of j_win once (256 B at K = 2) for 64K FLOP, far below the
// card's ~20 FLOP/B balance point (bf16 halves the bytes).  The design
// therefore reads j_win once, coalesced: n is the contiguous axis of every
// j_win row, so the 32 threads of a warp read 128 (bf16: 64) contiguous
// bytes per row.  The small tangent grid
// (gh*gw*K floats, 2 KB at 16x16, K = 2) is staged once per block in shared
// memory, so the window gathers never touch device memory.  Where it does
// not fit one block's 227 KB (above 11,622 knots at K = 5, e.g. 108x108),
// the same kernel runs with kStaged = false and reads the tangent straight
// from device memory through the read-only path: the tangent's few hundred
// KB stay resident in the 50 MB L2, and the launch takes no dynamic shared
// memory.  The TPU
// version's base-indicator matmuls and bf16 hi/lo splits are MXU devices
// and are not carried over.

#include <cuda_runtime.h>

#include "element.cuh"

namespace {

constexpr int kThreads = 256;

// Shared memory one block may use on Hopper (227 KB).
constexpr size_t kMaxSmemBytes = 232448;

// Whether the (gh, gw, K) tangent is staged in shared memory.  Mirrored by
// apply_j_staged in ba/window_cuda.py.
inline bool staged(int k, int gh, int gw) {
  return sizeof(float) * static_cast<size_t>(gh) * gw * k <= kMaxSmemBytes;
}

template <int K, class E, bool kStaged>
__global__ void __launch_bounds__(kThreads)
apply_j_kernel(const E* __restrict__ jwin, const int* __restrict__ base,
               int base_sn, int base_sc, const float* __restrict__ tangent,
               int n_obs, int gh, int gw, float* __restrict__ out) {
  extern __shared__ float stan[];
  if (kStaged) {
    const int cells = gh * gw * K;
    for (int i = threadIdx.x; i < cells; i += blockDim.x)
      stan[i] = tangent[i];
    __syncthreads();
  }

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_obs) return;
  const size_t N = static_cast<size_t>(n_obs);
  const int bx = base[static_cast<size_t>(n) * base_sn];
  const int by = base[static_cast<size_t>(n) * base_sn + base_sc];
  float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const int ky = by + y;
    if (ky < 0 || ky >= gh) continue;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int kx = bx + x;
      if (kx < 0 || kx >= gw) continue;
      const int v = (ky * gw + kx) * K;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int f = (y * 4 + x) * K + j;
        const float vj = kStaged ? stan[v + j] : __ldg(tangent + v + j);
        acc0 += cct::to_float(jwin[f * N + n]) * vj;
        acc1 += cct::to_float(jwin[(16 * K + f) * N + n]) * vj;
      }
    }
  }
  reinterpret_cast<float2*>(out)[n] = make_float2(acc0, acc1);
}

template <int K, class E>
cudaError_t launch(const void* jwin, const int* base, int base_sn,
                   int base_sc, const float* tangent, int n, int gh, int gw,
                   float* out, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (!staged(K, gh, gw)) {
    apply_j_kernel<K, E, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const E*>(jwin), base, base_sn, base_sc, tangent, n, gh,
        gw, out);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(float) * gh * gw * K;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        apply_j_kernel<K, E, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  apply_j_kernel<K, E, true><<<blocks, kThreads, smem, stream>>>(
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

// Whether cct_window_apply_j stages the tangent in shared memory at this K
// and grid (1) or reads it from device memory (0).
extern "C" int cct_window_apply_j_staged(int k, int gh, int gw) {
  return staged(k, gh, gw) ? 1 : 0;
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
