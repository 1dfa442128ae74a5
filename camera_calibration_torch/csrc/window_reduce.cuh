// Deterministic window reductions onto the knot grid, shared by
// window_apply_jtw.cu and window_block_diag.cu.
//
// Every observation n adds a few values to each knot of its 4x4 window at
// base (bx, by).  On the TPU the grid steps ran in order and one VMEM
// accumulator took every tile.  Here blocks run in parallel and in no
// order, so the reduction has two passes, and both sum in a fixed order:
//
// 1. window_partial_kernel: each block walks a fixed set of observation
//    tiles (tile t of block b covers observations (b + t*gridDim.x)*T ...).
//    A tile's j_win columns, per-observation weights and bases are staged
//    in shared memory with coalesced loads (n is the contiguous axis of
//    j_win).  Then each thread owns knots of the grid, scans the tile's
//    observations in order and adds those whose window covers its knot.
//    No two threads write one accumulator, so no atomics are needed and
//    the result does not depend on scheduling.  The block's accumulator
//    grid (gh*gw*R floats) is written to its row of the scratch array.
// 2. window_sum_kernel: one thread per output value sums the blocks' rows
//    in block order and writes the (gh, gw, ...) output directly.
//
// The scan costs N * gh * gw compares in all, cheap next to the j_win
// reads on a 16x16 grid; it grows with the grid, which a later change can
// cut by binning observations by window base.

#pragma once

#include <cuda_runtime.h>

namespace cct {

// Observations per tile (= threads per block) of the partial pass.
template <int K>
struct Tile {
  static constexpr int kObs = K <= 2 ? 128 : 64;
  static constexpr int kStride = kObs + 1;  // padded: no bank conflicts
};

// No knot of a window at this base lies inside any grid.
constexpr int kFarBase = -(1 << 20);

template <int K>
inline size_t partial_smem_bytes(int gh, int gw, int per_knot) {
  return sizeof(float) * (static_cast<size_t>(gh) * gw * per_knot +
                          32 * K * Tile<K>::kStride + 4 * Tile<K>::kObs);
}

// Op supplies kPerKnot (values per knot), kPerObs (floats per observation
// in per_obs) and accumulate(a, col, f0, ws), where col points at the
// observation's j_win column in shared memory (row stride Tile<K>::kStride)
// and f0 = (y*4 + x)*K is the window slot's first row.
template <int K, class Op>
__global__ void __launch_bounds__(Tile<K>::kObs)
window_partial_kernel(const float* __restrict__ jwin,
                      const int* __restrict__ base, int base_sn, int base_sc,
                      const float* __restrict__ per_obs, int n_obs, int gh,
                      int gw, float* __restrict__ partial) {
  constexpr int T = Tile<K>::kObs;
  constexpr int S = Tile<K>::kStride;
  constexpr int R = Op::kPerKnot;
  extern __shared__ float smem[];
  const int knots = gh * gw;
  float* acc = smem;                // knots * R
  float* sj = acc + knots * R;      // 32K rows of S
  float* sp = sj + 32 * K * S;      // Op::kPerObs rows of T
  int* sb = reinterpret_cast<int*>(sp + 2 * T);  // bx row, by row
  for (int i = threadIdx.x; i < knots * R; i += T) acc[i] = 0.0f;

  const size_t N = static_cast<size_t>(n_obs);
  for (int start = blockIdx.x * T; start < n_obs; start += gridDim.x * T) {
    __syncthreads();  // the previous tile is consumed
    const int n = start + threadIdx.x;
    if (n < n_obs) {
#pragma unroll 8
      for (int f = 0; f < 32 * K; ++f) sj[f * S + threadIdx.x] = jwin[f * N + n];
#pragma unroll
      for (int q = 0; q < Op::kPerObs; ++q)
        sp[q * T + threadIdx.x] = per_obs[static_cast<size_t>(n) * Op::kPerObs + q];
      sb[threadIdx.x] = base[static_cast<size_t>(n) * base_sn];
      sb[T + threadIdx.x] = base[static_cast<size_t>(n) * base_sn + base_sc];
    } else {
      sb[threadIdx.x] = kFarBase;
      sb[T + threadIdx.x] = kFarBase;
    }
    __syncthreads();
    const int count = min(T, n_obs - start);
    for (int knot = threadIdx.x; knot < knots; knot += T) {
      const int h = knot / gw;
      const int w = knot - h * gw;
      float a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = acc[knot * R + r];
      for (int p = 0; p < count; ++p) {
        const unsigned y = static_cast<unsigned>(h - sb[T + p]);
        const unsigned x = static_cast<unsigned>(w - sb[p]);
        if (y < 4u && x < 4u) {
          float ws[Op::kPerObs];
#pragma unroll
          for (int q = 0; q < Op::kPerObs; ++q) ws[q] = sp[q * T + p];
          Op::accumulate(a, sj + p, static_cast<int>((y * 4 + x) * K), ws);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) acc[knot * R + r] = a[r];
    }
  }
  __syncthreads();
  float* row = partial + static_cast<size_t>(blockIdx.x) * knots * R;
  for (int i = threadIdx.x; i < knots * R; i += T) row[i] = acc[i];
}

// out = sum over blocks (in block order) of the partial rows; Op::store
// writes value r of knot k into the output layout.
template <class Op>
__global__ void window_sum_kernel(const float* __restrict__ partial,
                                  int nblocks, int knots,
                                  float* __restrict__ out) {
  constexpr int R = Op::kPerKnot;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= knots * R) return;
  float s = 0.0f;
  for (int b = 0; b < nblocks; ++b) s += partial[static_cast<size_t>(b) * knots * R + i];
  Op::store(out, i / R, i % R, s);
}

template <int K, class Op>
cudaError_t launch_window_reduce(const float* jwin, const int* base,
                                 int base_sn, int base_sc,
                                 const float* per_obs, int n, int gh, int gw,
                                 float* partial, int nblocks, float* out,
                                 cudaStream_t stream) {
  const size_t smem = partial_smem_bytes<K>(gh, gw, Op::kPerKnot);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_partial_kernel<K, Op>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  window_partial_kernel<K, Op><<<nblocks, Tile<K>::kObs, smem, stream>>>(
      jwin, base, base_sn, base_sc, per_obs, n, gh, gw, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = gh * gw * Op::kPerKnot;
  window_sum_kernel<Op><<<(total + 255) / 256, 256, 0, stream>>>(
      partial, nblocks, gh * gw, out);
  return cudaGetLastError();
}

}  // namespace cct
