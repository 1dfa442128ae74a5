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
// mirrored.  K = 2 and K = 5 are instantiated, for a float32 j_win only:
// the LM step builds the preconditioner from the float32 blocks.
//
// What bounds it on an H100: its least time is set by bytes (32K j_win
// floats read once per observation, 16 * K(K+1)/2 * 4 FLOP); on the bench
// problem the owner visits of clustered tiles set the time, as for
// window_apply_jtw.  The design is the deterministic two-pass window
// reduction of window_reduce.cuh: a cp.async ring of tiles in shared
// memory, the K(K+1)/2 weighted products of each window slot formed once
// per observation where they fit in the slot's 2K rows (K = 2), one owner
// thread per knot that adds the observations its row and column masks
// select, per-block partial grids summed in a fixed order by a second
// kernel.  No atomics.

#include "window_reduce.cuh"

namespace {

template <int K>
struct BlockDiagOp {
  static constexpr int kPerKnot = K * (K + 1) / 2;
  static constexpr int kPerObs = 1;  // w[n]
  // Where a slot's kPerKnot products fit in its 2K rows (K <= 3), prepare
  // writes them there; otherwise accumulate forms them from j_win and w.
  static constexpr bool kFolded = kPerKnot <= 2 * K;
  static constexpr bool kUsesWeights = !kFolded;

  // row of product r of the slot whose rows start at f0
  __device__ static int row(int f0, int r) {
    return r < K ? f0 + r : 16 * K + f0 + (r - K);
  }

  template <int S>
  __device__ static void products(float* v, const float* col, int f0,
                                  float w) {
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
      for (int l = j; l < K; ++l) v[r++] = (jx[j] * jx[l] + jy[j] * jy[l]) * w;
    }
  }

  template <int S>
  __device__ static void prepare(float* col, int slot, const float* w) {
    if constexpr (kFolded) {
      float v[kPerKnot];
      products<S>(v, col, slot * K, w[0]);
#pragma unroll
      for (int r = 0; r < kPerKnot; ++r) col[row(slot * K, r) * S] = v[r];
    }
  }

  template <int S>
  __device__ static void accumulate(float* a, const float* col, int f0,
                                    const float* w) {
    if constexpr (kFolded) {
#pragma unroll
      for (int r = 0; r < kPerKnot; ++r) a[r] += col[row(f0, r) * S];
    } else {
      float v[kPerKnot];
      products<S>(v, col, f0, w[0]);
#pragma unroll
      for (int r = 0; r < kPerKnot; ++r) a[r] += v[r];
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

// elem_bytes: the element size of j_win; only 4 (float32) is taken.
extern "C" int cct_window_block_diag(const void* jwin, const void* base,
                                     int base_sn, int base_sc, const void* w,
                                     int n, int gh, int gw, int k,
                                     int elem_bytes, int band_rows,
                                     void* partial, int nblocks, void* out,
                                     void* stream) {
  if (elem_bytes != 4) return static_cast<int>(cudaErrorInvalidValue);
  const float* j = static_cast<const float*>(jwin);
  const int* b = static_cast<const int*>(base);
  const float* wt = static_cast<const float*>(w);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 2)
    return static_cast<int>(cct::launch_window_reduce<2, BlockDiagOp<2>, float>(
        j, b, base_sn, base_sc, wt, n, gh, gw, band_rows, p, nblocks, o, s));
  if (k == 5)
    return static_cast<int>(cct::launch_window_reduce<5, BlockDiagOp<5>, float>(
        j, b, base_sn, base_sc, wt, n, gh, gw, band_rows, p, nblocks, o, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The entries below take the element size of j_win like
// window_apply_jtw's; only 4 (float32) is built, anything else gives 0.

// Blocks of the partial pass that fit on one SM at once (0 if none does).
extern "C" int cct_window_block_diag_blocks_per_sm(int k, int gh, int gw,
                                                   int elem_bytes) {
  if (elem_bytes != 4) return 0;
  if (k == 2)
    return cct::window_reduce_blocks_per_sm<2, BlockDiagOp<2>, float>(gh, gw);
  if (k == 5)
    return cct::window_reduce_blocks_per_sm<5, BlockDiagOp<5>, float>(gh, gw);
  return 0;
}

// Shared memory of one block of the partial pass (0 for another K).
extern "C" long long cct_window_block_diag_smem_bytes(int k, int gh, int gw,
                                                      int elem_bytes) {
  if (elem_bytes != 4) return 0;
  if (k == 2)
    return cct::partial_smem_bytes<2, float>(gh, gw, BlockDiagOp<2>::kPerKnot);
  if (k == 5)
    return cct::partial_smem_bytes<5, float>(gh, gw, BlockDiagOp<5>::kPerKnot);
  return 0;
}

// Grid rows per band of the partial pass (0 where one row does not fit).
extern "C" int cct_window_block_diag_band_rows(int k, int gh, int gw,
                                               int elem_bytes) {
  if (elem_bytes != 4) return 0;
  if (k == 2) return cct::band_rows<2, float>(gh, gw, BlockDiagOp<2>::kPerKnot);
  if (k == 5) return cct::band_rows<5, float>(gh, gw, BlockDiagOp<5>::kPerKnot);
  return 0;
}
