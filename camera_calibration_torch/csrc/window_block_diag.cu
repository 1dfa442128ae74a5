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
// forms the products in float32).  A bf16 tile is read in half the bytes
// and widened as it is stored; from there the products and the sums are
// those of the float32 kernel on the widened values, in the same layout
// and order, so both give the same bits where both plans take the same
// block count.  The LM step builds the preconditioner from the float32
// blocks, as the reference's does.
//
// What bounds it on an H100: its least time is set by bytes (32K j_win
// elements read once per observation, 16 * K(K+1)/2 * 4 FLOP).  The design
// is the deterministic two-pass window reduction of window_reduce.cuh:
// tiles pass through registers into a shared-memory stage (for K = 2 the
// K(K+1)/2 weighted products of each window slot, formed once per
// observation; for K = 5 the 2K values of each slot and the weight, from
// which a visit forms the products), knot owners on small grids and slot
// classes on larger ones, per-block grids summed over a cluster and then
// in a fixed order by a second kernel.  No atomics.

#include "window_reduce.cuh"

namespace {

template <int K>
struct BlockDiagOp {
  static constexpr int kPerKnot = K * (K + 1) / 2;
  static constexpr int kPerObs = 1;  // w[n]
  // Where a slot's kPerKnot products take no more rows than its 2K values
  // (K <= 3), the stage keeps the products; otherwise the values and the
  // weight, and a visit forms the products.
  static constexpr bool kFolded = kPerKnot <= 2 * K;
  static constexpr int kPrepRows = kFolded ? 16 * kPerKnot : 32 * K + 1;
  static constexpr int kMinBlocks = kFolded ? 2 : 1;

  // Folded: group g reads slots g and g + kLoadGroups, K values each;
  // otherwise rows g, g + kLoadGroups, ...
  __device__ static int row(int g, int i) {
    return kFolded ? (g + cct::kLoadGroups * (i / K)) * K + i % K
                   : g + cct::kLoadGroups * i;
  }

  // the upper products (j <= l) of one slot from its values jx, jy
  __device__ static void products(float* v, const float* jx, const float* jy,
                                  float w) {
    int r = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int l = j; l < K; ++l) v[r++] = (jx[j] * jx[l] + jy[j] * jy[l]) * w;
    }
  }

  __device__ static void store(float* stage, const float* a, const float* b,
                               const float* w, int p, int g) {
    constexpr int S = cct::kStride;
    if constexpr (kFolded) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v[kPerKnot];
        products(v, a + q * K, b + q * K, w[0]);
        const int slot = g + cct::kLoadGroups * q;
#pragma unroll
        for (int r = 0; r < kPerKnot; ++r)
          stage[(slot * kPerKnot + r) * S + p] = v[r];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2 * K; ++i) {
        stage[row(g, i) * S + p] = a[i];
        stage[(16 * K + row(g, i)) * S + p] = b[i];
      }
      if (g == 0) stage[32 * K * S + p] = w[0];
    }
  }

  __device__ static void contribution(float* v, const float* stage, int p,
                                      int slot) {
    constexpr int S = cct::kStride;
    if constexpr (kFolded) {
#pragma unroll
      for (int r = 0; r < kPerKnot; ++r)
        v[r] = stage[(slot * kPerKnot + r) * S + p];
    } else {
      float jx[K], jy[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        jx[j] = stage[(slot * K + j) * S + p];
        jy[j] = stage[(16 * K + slot * K + j) * S + p];
      }
      products(v, jx, jy, stage[32 * K * S + p]);
    }
  }

  // value r of a knot is the upper pair (j, l), j <= l, in row order
  __device__ static void store_out(float* out, int knot, int r, float v) {
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

// Shared memory of one block of the partial pass, the same for both
// element types (0 for another K or element size).
extern "C" long long cct_window_block_diag_smem_bytes(int k, int gh, int gw,
                                                      int elem_bytes) {
  if (elem_bytes != 4 && elem_bytes != 2) return 0;
  if (k == 2) return cct::partial_smem_bytes<BlockDiagOp<2>>(gh, gw);
  if (k == 5) return cct::partial_smem_bytes<BlockDiagOp<5>>(gh, gw);
  return 0;
}

// Grid rows per band of the partial pass (0 where one row does not fit),
// the same for both element types.
extern "C" int cct_window_block_diag_band_rows(int k, int gh, int gw,
                                               int elem_bytes) {
  if (elem_bytes != 4 && elem_bytes != 2) return 0;
  if (k == 2) return cct::band_rows<BlockDiagOp<2>>(gh, gw);
  if (k == 5) return cct::band_rows<BlockDiagOp<5>>(gh, gw);
  return 0;
}
