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
// mirrored.  K = 2 and K = 5 are instantiated, each for a float32 and a
// bfloat16 j_win (the reference kernel widens a bf16 j_win, :113, and
// forms the products in float32).  A bf16 tile is staged in half the
// bytes and widened, all 32K rows, into a float32 area; from there the
// products are those of the float32 kernel on the widened values (the sums
// split over as many blocks as the bf16 plan's occupancy gives, so the last
// bits may differ from the float32 kernel's).  The LM step builds the
// preconditioner from the float32 blocks, as the reference's does.
//
// What bounds it on an H100: its least time is set by bytes (32K j_win
// elements read once per observation, 16 * K(K+1)/2 * 4 FLOP); on the bench
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
  // a bf16 tile is widened whole: the products read both halves
  static constexpr int kPrepRows = 32 * K;

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

  // widen the slot's 2K rows of a staged bf16 column `in` (row stride SI)
  // into the float32 column `col` (row stride S), then prepare them there
  template <int SI, int S>
  __device__ static void prepare_from(const __nv_bfloat16* in, float* col,
                                      int slot, const float* w) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int f = slot * K + j;
      col[f * S] = cct::to_float(in[f * SI]);
      col[(16 * K + f) * S] = cct::to_float(in[(16 * K + f) * SI]);
    }
    prepare<S>(col, slot, w);
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

template <class E>
cudaError_t launch(const void* jwin, const int* b, int base_sn, int base_sc,
                   const float* w, int n, int gh, int gw, int k,
                   int band_rows, float* p, int nblocks, float* o,
                   cudaStream_t s) {
  const E* j = static_cast<const E*>(jwin);
  if (k == 2)
    return cct::launch_window_reduce<2, BlockDiagOp<2>, E>(
        j, b, base_sn, base_sc, w, n, gh, gw, band_rows, p, nblocks, o, s);
  if (k == 5)
    return cct::launch_window_reduce<5, BlockDiagOp<5>, E>(
        j, b, base_sn, base_sc, w, n, gh, gw, band_rows, p, nblocks, o, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// elem_bytes: 4 for a float32 j_win, 2 for a bfloat16 one (in every entry
// below).
extern "C" int cct_window_block_diag(const void* jwin, const void* base,
                                     int base_sn, int base_sc, const void* w,
                                     int n, int gh, int gw, int k,
                                     int elem_bytes, int band_rows,
                                     void* partial, int nblocks, void* out,
                                     void* stream) {
  const int* b = static_cast<const int*>(base);
  const float* wt = static_cast<const float*>(w);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return static_cast<int>(launch<float>(jwin, b, base_sn, base_sc, wt, n,
                                          gh, gw, k, band_rows, p, nblocks,
                                          o, s));
  if (elem_bytes == 2)
    return static_cast<int>(launch<__nv_bfloat16>(
        jwin, b, base_sn, base_sc, wt, n, gh, gw, k, band_rows, p, nblocks,
        o, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the partial pass that fit on one SM at once (0 if none does).
extern "C" int cct_window_block_diag_blocks_per_sm(int k, int gh, int gw,
                                                   int elem_bytes) {
  if (elem_bytes == 4) {
    if (k == 2)
      return cct::window_reduce_blocks_per_sm<2, BlockDiagOp<2>, float>(gh, gw);
    if (k == 5)
      return cct::window_reduce_blocks_per_sm<5, BlockDiagOp<5>, float>(gh, gw);
  } else if (elem_bytes == 2) {
    if (k == 2)
      return cct::window_reduce_blocks_per_sm<2, BlockDiagOp<2>,
                                              __nv_bfloat16>(gh, gw);
    if (k == 5)
      return cct::window_reduce_blocks_per_sm<5, BlockDiagOp<5>,
                                              __nv_bfloat16>(gh, gw);
  }
  return 0;
}

// Shared memory of one block of the partial pass (0 for another K).
extern "C" long long cct_window_block_diag_smem_bytes(int k, int gh, int gw,
                                                      int elem_bytes) {
  if (elem_bytes == 4) {
    if (k == 2) return cct::partial_smem_bytes<2, BlockDiagOp<2>, float>(gh, gw);
    if (k == 5) return cct::partial_smem_bytes<5, BlockDiagOp<5>, float>(gh, gw);
  } else if (elem_bytes == 2) {
    if (k == 2)
      return cct::partial_smem_bytes<2, BlockDiagOp<2>, __nv_bfloat16>(gh, gw);
    if (k == 5)
      return cct::partial_smem_bytes<5, BlockDiagOp<5>, __nv_bfloat16>(gh, gw);
  }
  return 0;
}

// Grid rows per band of the partial pass (0 where one row does not fit).
extern "C" int cct_window_block_diag_band_rows(int k, int gh, int gw,
                                               int elem_bytes) {
  if (elem_bytes == 4) {
    if (k == 2) return cct::band_rows<2, BlockDiagOp<2>, float>(gh, gw);
    if (k == 5) return cct::band_rows<5, BlockDiagOp<5>, float>(gh, gw);
  } else if (elem_bytes == 2) {
    if (k == 2) return cct::band_rows<2, BlockDiagOp<2>, __nv_bfloat16>(gh, gw);
    if (k == 5) return cct::band_rows<5, BlockDiagOp<5>, __nv_bfloat16>(gh, gw);
  }
  return 0;
}
