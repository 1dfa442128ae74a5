// J_intr . v for spline-grid intrinsics: apply_j_kernel<K>.
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
// K = 2 (central models) and K = 5 (noncentral) are instantiated.
//
// What bounds it on an H100: memory bandwidth.  Each observation reads
// 32K floats of j_win once (256 B at K = 2) for 64K FLOP, far below the
// card's ~20 FLOP/B balance point.  The design therefore reads j_win once,
// coalesced: n is the contiguous axis of every j_win row, so the 32 threads
// of a warp read 128 contiguous bytes per row.  The small tangent grid
// (gh*gw*K floats, 2 KB at 16x16, K = 2) is staged once per block in shared
// memory, so the window gathers never touch device memory.  The TPU
// version's base-indicator matmuls and bf16 hi/lo splits are MXU devices
// and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int K>
__global__ void __launch_bounds__(kThreads)
apply_j_kernel(const float* __restrict__ jwin, const int* __restrict__ base,
               int base_sn, int base_sc, const float* __restrict__ tangent,
               int n_obs, int gh, int gw, float* __restrict__ out) {
  extern __shared__ float stan[];
  const int cells = gh * gw * K;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) stan[i] = tangent[i];
  __syncthreads();

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
      const float* v = stan + (ky * gw + kx) * K;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int f = (y * 4 + x) * K + j;
        acc0 += jwin[f * N + n] * v[j];
        acc1 += jwin[(16 * K + f) * N + n] * v[j];
      }
    }
  }
  reinterpret_cast<float2*>(out)[n] = make_float2(acc0, acc1);
}

template <int K>
cudaError_t launch(const float* jwin, const int* base, int base_sn,
                   int base_sc, const float* tangent, int n, int gh, int gw,
                   float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * gh * gw * K;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        apply_j_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  apply_j_kernel<K><<<blocks, kThreads, smem, stream>>>(
      jwin, base, base_sn, base_sc, tangent, n, gh, gw, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cct_window_apply_j(const void* jwin, const void* base,
                                  int base_sn, int base_sc,
                                  const void* tangent, int n, int gh, int gw,
                                  int k, void* out, void* stream) {
  const float* j = static_cast<const float*>(jwin);
  const int* b = static_cast<const int*>(base);
  const float* t = static_cast<const float*>(tangent);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 2) return static_cast<int>(launch<2>(j, b, base_sn, base_sc, t, n, gh, gw, o, s));
  if (k == 5) return static_cast<int>(launch<5>(j, b, base_sn, base_sc, t, n, gh, gw, o, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
