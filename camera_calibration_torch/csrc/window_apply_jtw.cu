// J_intr^T (W s) scattered onto the knot grid: the JtW window reduction.
//
// Replaces the Pallas kernel _apply_jtw_kernel of the reference package,
// camera_calibration_tpu/ba/window_pallas.py:78-96, called through
// _apply_jtw_call (:191-212, pallas_call at :197) by window_apply_jtw
// (:285-303), which shift-adds 16K base-indexed planes in XLA afterwards
// (:271-282).  Here the (gh, gw, K) output is written directly.
//
// What it computes:
//   out[by+y, bx+x, j] += sum_i j_win[i*16K + (y*4+x)*K + j, n] * ws[n, i]
// over all observations n, for knots inside the grid.  K = 2 and K = 5 are
// instantiated, each for a float32 and a bfloat16 j_win (the reference
// kernel's bf16 read, :91: the CG matvecs' copies): a bf16 tile is staged
// in half the bytes and widened to float32 as ws is folded in, so every
// sum is float32.
//
// What bounds it on an H100: its least time is set by bytes, since each
// observation's 32K j_win floats are read once (coalesced, n contiguous)
// for 64K FLOP; on the bench problem the owner visits set the time
// instead, because a clustered tile sends tens of observations to a few
// knots whose owners add them one by one.  The design (window_reduce.cuh)
// streams tiles of observations through a cp.async ring in shared memory,
// folds ws into each staged column once (prepare: K values per window slot
// remain), lets the owner thread of each knot add the columns its row and
// column masks select, and sums the per-block grids in a fixed order in a
// second small kernel: the result is the same from run to run, with no
// atomics.

#include "window_reduce.cuh"

namespace {

template <int K>
struct JtwOp {
  static constexpr int kPerKnot = K;
  static constexpr int kPerObs = 2;  // ws[n, 0], ws[n, 1]
  static constexpr bool kUsesWeights = false;
  static constexpr int kPrepRows = 16 * K;

  // rows (slot*K + j) become j_win[0, slot, j]*ws0 + j_win[1, slot, j]*ws1
  template <int S>
  __device__ static void prepare(float* col, int slot, const float* ws) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int f = slot * K + j;
      col[f * S] = col[f * S] * ws[0] + col[(16 * K + f) * S] * ws[1];
    }
  }

  // the same from a staged bf16 column (row stride SI) into a float32
  // column (row stride S)
  template <int SI, int S>
  __device__ static void prepare_from(const __nv_bfloat16* in, float* col,
                                      int slot, const float* ws) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int f = slot * K + j;
      col[f * S] = cct::to_float(in[f * SI]) * ws[0] +
                   cct::to_float(in[(16 * K + f) * SI]) * ws[1];
    }
  }

  template <int S>
  __device__ static void accumulate(float* a, const float* col, int f0,
                                    const float*) {
#pragma unroll
    for (int j = 0; j < K; ++j) a[j] += col[(f0 + j) * S];
  }

  __device__ static void store(float* out, int knot, int r, float v) {
    out[knot * K + r] = v;
  }
};

template <class E>
cudaError_t launch(const void* jwin, const int* b, int base_sn, int base_sc,
                   const float* w, int n, int gh, int gw, int k,
                   int band_rows, float* p, int nblocks, float* o,
                   cudaStream_t s) {
  const E* j = static_cast<const E*>(jwin);
  if (k == 2)
    return cct::launch_window_reduce<2, JtwOp<2>, E>(
        j, b, base_sn, base_sc, w, n, gh, gw, band_rows, p, nblocks, o, s);
  if (k == 5)
    return cct::launch_window_reduce<5, JtwOp<5>, E>(
        j, b, base_sn, base_sc, w, n, gh, gw, band_rows, p, nblocks, o, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// elem_bytes: 4 for a float32 j_win, 2 for a bfloat16 one (in every entry
// below).
extern "C" int cct_window_apply_jtw(const void* jwin, const void* base,
                                    int base_sn, int base_sc, const void* ws,
                                    int n, int gh, int gw, int k,
                                    int elem_bytes, int band_rows,
                                    void* partial, int nblocks, void* out,
                                    void* stream) {
  const int* b = static_cast<const int*>(base);
  const float* w = static_cast<const float*>(ws);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return static_cast<int>(launch<float>(jwin, b, base_sn, base_sc, w, n,
                                          gh, gw, k, band_rows, p, nblocks,
                                          o, s));
  if (elem_bytes == 2)
    return static_cast<int>(launch<__nv_bfloat16>(
        jwin, b, base_sn, base_sc, w, n, gh, gw, k, band_rows, p, nblocks, o,
        s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the partial pass that fit on one SM at once (0 if none does).
extern "C" int cct_window_apply_jtw_blocks_per_sm(int k, int gh, int gw,
                                                  int elem_bytes) {
  if (elem_bytes == 4) {
    if (k == 2) return cct::window_reduce_blocks_per_sm<2, JtwOp<2>, float>(gh, gw);
    if (k == 5) return cct::window_reduce_blocks_per_sm<5, JtwOp<5>, float>(gh, gw);
  } else if (elem_bytes == 2) {
    if (k == 2)
      return cct::window_reduce_blocks_per_sm<2, JtwOp<2>, __nv_bfloat16>(gh, gw);
    if (k == 5)
      return cct::window_reduce_blocks_per_sm<5, JtwOp<5>, __nv_bfloat16>(gh, gw);
  }
  return 0;
}

// Shared memory of one block of the partial pass (0 for another K).
extern "C" long long cct_window_apply_jtw_smem_bytes(int k, int gh, int gw,
                                                     int elem_bytes) {
  if (elem_bytes == 4) {
    if (k == 2) return cct::partial_smem_bytes<2, JtwOp<2>, float>(gh, gw);
    if (k == 5) return cct::partial_smem_bytes<5, JtwOp<5>, float>(gh, gw);
  } else if (elem_bytes == 2) {
    if (k == 2)
      return cct::partial_smem_bytes<2, JtwOp<2>, __nv_bfloat16>(gh, gw);
    if (k == 5)
      return cct::partial_smem_bytes<5, JtwOp<5>, __nv_bfloat16>(gh, gw);
  }
  return 0;
}

// Grid rows per band of the partial pass (0 where one row does not fit).
extern "C" int cct_window_apply_jtw_band_rows(int k, int gh, int gw,
                                              int elem_bytes) {
  if (elem_bytes == 4) {
    if (k == 2) return cct::band_rows<2, JtwOp<2>, float>(gh, gw);
    if (k == 5) return cct::band_rows<5, JtwOp<5>, float>(gh, gw);
  } else if (elem_bytes == 2) {
    if (k == 2) return cct::band_rows<2, JtwOp<2>, __nv_bfloat16>(gh, gw);
    if (k == 5) return cct::band_rows<5, JtwOp<5>, __nv_bfloat16>(gh, gw);
  }
  return 0;
}
