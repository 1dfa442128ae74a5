// Per-knot K x K blocks of diag(J^T W J) for the block-Jacobi
// preconditioner.
//
// Replaces the Pallas kernel _block_diag_kernel of the reference package,
// camera_calibration_tpu/ba/window_pallas.py:99-130, called through
// _block_diag_call (:215-237, pallas_call at :222) by window_block_diag
// (:306-333), which shift-adds base-indexed planes in XLA afterwards.  Here
// the (gh, gw, K, K) output is written directly.
//
// What it computes, for knot (h, w) = (by+y, bx+x) inside the grid:
//   B[h, w, j, l] += w_n * sum_i j_win[i, (y, x, j), n] * j_win[i, (y, x, l), n]
// over all observations n; the upper pairs (j <= l) are accumulated and
// mirrored.  K = 2 and K = 5 are instantiated.
//
// What bounds it on an H100: memory bandwidth (32K j_win floats read once
// per observation, 16 * K(K+1)/2 * 4 FLOP).  The design is the deterministic
// two-pass window reduction of window_reduce.cuh: coalesced tile staging in
// shared memory, one owner thread per knot, per-block partial grids summed
// in block order by a second kernel.  No atomics.

#include "window_reduce.cuh"

namespace {

template <int K>
struct BlockDiagOp {
  static constexpr int kPerKnot = K * (K + 1) / 2;
  static constexpr int kPerObs = 1;  // w[n]
  static constexpr int S = cct::Tile<K>::kStride;

  __device__ static void accumulate(float* a, const float* col, int f0,
                                    const float* w) {
    float jx[K], jy[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      jx[j] = col[(f0 + j) * S];
      jy[j] = col[(16 * K + f0 + j) * S];
    }
    int r = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int l = j; l < K; ++l) a[r++] += (jx[j] * jx[l] + jy[j] * jy[l]) * w[0];
    }
  }

  // value r of a knot is the upper pair (j, l), j <= l, in row order
  __device__ static void store(float* out, int knot, int r, float v) {
    int j = 0;
    while (r >= K - j) {
      r -= K - j;
      ++j;
    }
    const int l = j + r;
    float* blk = out + static_cast<size_t>(knot) * K * K;
    blk[j * K + l] = v;
    blk[l * K + j] = v;
  }
};

}  // namespace

extern "C" int cct_window_block_diag(const void* jwin, const void* base,
                                     int base_sn, int base_sc, const void* w,
                                     int n, int gh, int gw, int k,
                                     void* partial, int nblocks, void* out,
                                     void* stream) {
  const float* j = static_cast<const float*>(jwin);
  const int* b = static_cast<const int*>(base);
  const float* wt = static_cast<const float*>(w);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 2)
    return static_cast<int>(cct::launch_window_reduce<2, BlockDiagOp<2>>(
        j, b, base_sn, base_sc, wt, n, gh, gw, p, nblocks, o, s));
  if (k == 5)
    return static_cast<int>(cct::launch_window_reduce<5, BlockDiagOp<5>>(
        j, b, base_sn, base_sc, wt, n, gh, gw, p, nblocks, o, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
