// Deterministic window reductions onto the knot grid, shared by
// window_apply_jtw.cu and window_block_diag.cu.
//
// Every observation n adds a few values to each knot of its 4x4 window at
// base (bx, by).  On the TPU the grid steps ran in order and one VMEM
// accumulator took every tile.  Here blocks run in parallel and in no
// order, so the reduction has two passes, and both sum in a fixed order:
//
// 1. window_partial_kernel: each block walks a fixed set of observation
//    tiles (tile i of block b covers observations (b + i*gridDim.x)*T ...)
//    and keeps the whole accumulator grid (gh*gw*R floats) in shared
//    memory.  Per tile:
//    - Loads in flight: tiles are staged with cp.async (16-byte copies
//      where N % 4 == 0 and j_win is 16-byte aligned, 4-byte copies
//      otherwise).  Where it fits, a ring of two 64-observation stages lets
//      the next tile's j_win columns, weights and bases load while this one
//      is reduced; grids whose accumulator leaves no room for the ring take
//      one stage of 32 observations, which loads while the block waits (the
//      layouts' largest grids are listed at Tile).
//    - Candidate lists: the warps of the first T threads each own 32
//      observations and set, with one __ballot_sync per grid row, bit p of
//      the row's mask word iff the window of observation p covers the row
//      (0 <= h - by < 4); the same for columns.  Meanwhile the other
//      threads fold each observation's weights into its staged column
//      (Op::prepare), so that a visit reads fewer values.
//    - Each knot has one owner thread for the tile (knot i*NT + lane*NW +
//      warp: neighbouring knots, which a clustered tile hits together, go
//      to different warps).  The owner visits the set bits of row mask AND
//      column mask in increasing order, so its observations are added in
//      tile order, with no atomics and independent of scheduling.
//    The block's grid is written to its row of the scratch array.
// 2. window_sum_kernel: a block of kSumWarps warps takes 32 consecutive
//    output values; warp y sums rows y, y + kSumWarps, ... in order, and
//    warp 0 adds the kSumWarps sums in warp order.
//
// Results are bit-identical from run to run for a given nblocks.  Every
// knot is visited once per tile (2 * kWords mask loads), so finding the
// candidates costs gh*gw visits per tile, not gh*gw*T tests.  What
// bounds the visits is SIMT use on clustered tiles: the few owners of hot
// knots add tens of observations each while the rest of their warps idle.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace cct {

// The tile layout of a partial-pass block.  kRing: two stages of 64
// observations, one loading while one is reduced.  Otherwise (compact): one
// stage of 32.  Largest square grids of one block (227 KB), ring / compact:
// K=2 JtW 155 / 166, block diagonal 127 / 135; K=5 JtW 84 / 102, block
// diagonal 48 / 58.  The compact layout takes every grid the single-stage
// kernel it replaced took.
template <int K, bool kRing>
struct Tile {
  // Observations per tile (32 per mask word).  Small tiles keep four
  // blocks (32 warps) on an SM, enough to hide the latency of the owner
  // visits.
  static constexpr int kObs = kRing ? 64 : 32;
  // Threads per block of the partial pass: the first kObs build the masks,
  // the rest prepare the columns; all own knots.
  static constexpr int kThreads = 256;
  // j_win row stride in shared memory: rows stay 16-byte aligned for
  // cp.async and start 4 banks apart.
  static constexpr int kStride = kObs + 4;
  // Tiles in shared memory at once.
  static constexpr int kStages = kRing ? 2 : 1;
  // Mask words per grid row or column.
  static constexpr int kWords = kObs / 32;
  // One stage: 32K j_win rows, two per-observation floats, two base ints.
  static constexpr int kStageFloats = 32 * K * kStride + 4 * kObs;
};

// Warps per block of the sum pass.
constexpr int kSumWarps = 16;

// Shared memory one block may use on Hopper (227 KB).
constexpr size_t kMaxSmemBytes = 232448;

// Shared memory of one partial-pass block in a layout: the stages, the row
// and column masks ((gh + gw) * kWords words), the accumulator grid.
template <int K, bool kRing>
inline size_t layout_smem_bytes(int gh, int gw, int per_knot) {
  using Tl = Tile<K, kRing>;
  return sizeof(float) *
         (static_cast<size_t>(Tl::kStages) * Tl::kStageFloats +
          static_cast<size_t>(gh + gw) * Tl::kWords +
          static_cast<size_t>(gh) * gw * per_knot);
}

// The ring wherever it fits in one block.
template <int K>
inline bool use_ring(int gh, int gw, int per_knot) {
  return layout_smem_bytes<K, true>(gh, gw, per_knot) <= kMaxSmemBytes;
}

// Shared memory of one partial-pass block in the layout it takes at this
// grid.  Mirrored by reduction_smem_bytes in ba/window_cuda.py.
template <int K>
inline size_t partial_smem_bytes(int gh, int gw, int per_knot) {
  return use_ring<K>(gh, gw, per_knot)
             ? layout_smem_bytes<K, true>(gh, gw, per_knot)
             : layout_smem_bytes<K, false>(gh, gw, per_knot);
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory, the first `bytes` of them from global memory
// and the rest zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending committed groups of this thread are still in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start the copies of the tile at `start` into stage `st`: j_win rows
// (stride kStride), then kPerObs floats per observation, then the bx and
// by rows.  Observations past n_obs are not copied.
template <class Tl, int K, int kPerObs>
__device__ __forceinline__ void stage_tile(float* st, const float* jwin,
                                           const int* base, int base_sn,
                                           int base_sc, const float* per_obs,
                                           int n_obs, int start, bool vec) {
  constexpr int T = Tl::kObs;
  constexpr int NT = Tl::kThreads;
  constexpr int S = Tl::kStride;
  constexpr int F = 32 * K;
  const size_t N = static_cast<size_t>(n_obs);
  const int count = min(T, n_obs - start);
  const int t = threadIdx.x;
  if (vec) {
    constexpr int C = T / 4;  // 16-byte chunks per row
    for (int c = t; c < F * C; c += NT) {
      const int f = c / C;
      const int q = (c - f * C) * 4;
      const int left = count - q;
      if (left > 0)
        cp_async16(st + f * S + q, jwin + f * N + start + q, min(left, 4) * 4);
    }
  } else {
    for (int c = t; c < F * T; c += NT) {
      const int f = c / T;
      const int p = c - f * T;
      if (p < count) cp_async4(st + f * S + p, jwin + f * N + start + p);
    }
  }
  float* sp = st + F * S;
  const float* po = per_obs + static_cast<size_t>(start) * kPerObs;
  for (int i = t; i < kPerObs * count; i += NT) cp_async4(sp + i, po + i);
  if (t < count) {
    int* sb = reinterpret_cast<int*>(sp + 2 * T);
    const int* b = base + static_cast<size_t>(start + t) * base_sn;
    cp_async4(sb + t, b);
    cp_async4(sb + T + t, b + base_sc);
  }
}

// Op supplies
// - kPerKnot: values per knot; kPerObs: floats per observation in per_obs
//   (at most 2); kUsesWeights: whether accumulate reads them;
// - prepare<S>(col, slot, ws): rewrites in place the rows of window slot
//   `slot` (0..15) of one observation's staged column (col points at it,
//   row stride S) so that accumulate reads fewer values;
// - accumulate<S>(a, col, f0, ws): adds the observation's prepared
//   contribution to window slot f0 / K (f0 = (y*4 + x)*K) to a[kPerKnot];
// - store(out, knot, r, v): writes value r of a knot to the output.
template <int K, class Op, bool kRing>
__global__ void __launch_bounds__(Tile<K, kRing>::kThreads)
window_partial_kernel(const float* __restrict__ jwin,
                      const int* __restrict__ base, int base_sn, int base_sc,
                      const float* __restrict__ per_obs, int n_obs, int gh,
                      int gw, float* __restrict__ partial) {
  using Tl = Tile<K, kRing>;
  constexpr int T = Tl::kObs;
  constexpr int NT = Tl::kThreads;
  constexpr int NW = NT / 32;
  constexpr int S = Tl::kStride;
  constexpr int P = Tl::kStages;
  constexpr int Q = Tl::kStageFloats;
  constexpr int W = Tl::kWords;
  constexpr int R = Op::kPerKnot;
  static_assert(Op::kPerObs <= 2, "a stage holds two floats per observation");
  static_assert(NT > T, "threads past the first kObs prepare the columns");
  extern __shared__ __align__(16) float smem[];
  const int knots = gh * gw;
  float* ring = smem;
  unsigned* rowm = reinterpret_cast<unsigned*>(ring + P * Q);
  unsigned* colm = rowm + gh * W;
  float* acc = reinterpret_cast<float*>(colm + gw * W);
  for (int i = threadIdx.x; i < knots * R; i += NT) acc[i] = 0.0f;

  const int ntiles = (n_obs + T - 1) / T;
  const int b = blockIdx.x;
  const int mine = b < ntiles ? (ntiles - 1 - b) / gridDim.x + 1 : 0;
  const bool vec = n_obs % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(jwin) & 15) == 0;
  auto tile_start = [&](int i) {
    return (b + i * static_cast<int>(gridDim.x)) * T;
  };
  for (int i = 0; i < P - 1; ++i) {
    if (i < mine)
      stage_tile<Tl, K, Op::kPerObs>(ring + i * Q, jwin, base, base_sn,
                                     base_sc, per_obs, n_obs, tile_start(i),
                                     vec);
    cp_async_commit();
  }

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int first_knot = lane * NW + warp;
  for (int i = 0; i < mine; ++i) {
    if constexpr (P == 1) {
      __syncthreads();  // tile i - 1 and the masks are consumed
      stage_tile<Tl, K, Op::kPerObs>(ring, jwin, base, base_sn, base_sc,
                                     per_obs, n_obs, tile_start(i), vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();  // everyone's copies of tile i have landed
    } else {
      cp_async_wait<P - 2>();  // this thread's copies of tile i have landed
      __syncthreads();  // everyone's have; tile i - 1 and the masks are consumed
      if (i + P - 1 < mine)
        stage_tile<Tl, K, Op::kPerObs>(ring + ((i + P - 1) % P) * Q, jwin,
                                       base, base_sn, base_sc, per_obs, n_obs,
                                       tile_start(i + P - 1), vec);
      cp_async_commit();
    }

    float* sj = ring + (i % P) * Q;
    const float* sp = sj + 32 * K * S;
    int* sb = reinterpret_cast<int*>(sj + 32 * K * S + 2 * T);
    const int count = min(T, n_obs - tile_start(i));
    if (t < T) {
      // masks of this warp's 32 observations; then sb[p] becomes the
      // observation's slot offset (by*4 + bx)*K
      const bool valid = t < count;
      const int bx = valid ? sb[t] : 0;
      const int by = valid ? sb[T + t] : 0;
      for (int h = 0; h < gh; ++h) {
        const unsigned m = __ballot_sync(
            0xffffffffu, valid && static_cast<unsigned>(h - by) < 4u);
        if (lane == (h & 31)) rowm[h * W + warp] = m;
      }
      for (int w = 0; w < gw; ++w) {
        const unsigned m = __ballot_sync(
            0xffffffffu, valid && static_cast<unsigned>(w - bx) < 4u);
        if (lane == (w & 31)) colm[w * W + warp] = m;
      }
      if (valid) sb[t] = (by * 4 + bx) * K;
    } else {
      for (int j = t - T; j < 16 * T; j += NT - T) {
        const int p = j % T;
        if (p < count)
          Op::template prepare<S>(sj + p, j / T, sp + p * Op::kPerObs);
      }
    }
    __syncthreads();

    for (int knot = first_knot; knot < knots; knot += NT) {
      const int h = knot / gw;
      const int w = knot - h * gw;
      unsigned hit[W];
      unsigned any = 0u;
#pragma unroll
      for (int q = 0; q < W; ++q) {
        hit[q] = rowm[h * W + q] & colm[w * W + q];
        any |= hit[q];
      }
      if (!any) continue;
      const int hw = (h * 4 + w) * K;
      float a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = acc[knot * R + r];
#pragma unroll
      for (int q = 0; q < W; ++q) {
        for (unsigned m = hit[q]; m; m &= m - 1u) {
          const int p = q * 32 + __ffs(static_cast<int>(m)) - 1;
          float ws[Op::kPerObs];
#pragma unroll
          for (int c = 0; c < Op::kPerObs; ++c)
            ws[c] = Op::kUsesWeights ? sp[p * Op::kPerObs + c] : 0.0f;
          Op::template accumulate<S>(a, sj + p, hw - sb[p], ws);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) acc[knot * R + r] = a[r];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* row = partial + static_cast<size_t>(b) * knots * R;
  for (int i = t; i < knots * R; i += NT) row[i] = acc[i];
}

// out = the sum of the nblocks partial rows; Op::store writes value r of
// knot k into the output layout.  Block (32, kSumWarps) takes 32
// consecutive values: warp y sums rows y, y + kSumWarps, ... in order,
// then warp 0 adds the kSumWarps sums in warp order.
template <class Op>
__global__ void __launch_bounds__(32 * kSumWarps)
window_sum_kernel(const float* __restrict__ partial, int nblocks, int knots,
                  float* __restrict__ out) {
  constexpr int R = Op::kPerKnot;
  __shared__ float sums[kSumWarps][33];
  const int cols = knots * R;
  const int i = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (i < cols) {
#pragma unroll 4
    for (int r = threadIdx.y; r < nblocks; r += kSumWarps)
      s += partial[static_cast<size_t>(r) * cols + i];
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < cols) {
    float t = sums[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < kSumWarps; ++y) t += sums[y][threadIdx.x];
    Op::store(out, i / R, i % R, t);
  }
}

template <int K, class Op, bool kRing>
cudaError_t set_partial_smem(int gh, int gw, size_t* smem) {
  *smem = layout_smem_bytes<K, kRing>(gh, gw, Op::kPerKnot);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(window_partial_kernel<K, Op, kRing>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <int K, class Op, bool kRing>
int blocks_per_sm(int gh, int gw) {
  size_t smem = 0;
  if (set_partial_smem<K, Op, kRing>(gh, gw, &smem) != cudaSuccess) return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, window_partial_kernel<K, Op, kRing>,
          Tile<K, kRing>::kThreads, smem) != cudaSuccess)
    return 0;
  return blocks;
}

// Partial-pass blocks that fit on one SM at once (0 if none does).
template <int K, class Op>
int window_reduce_blocks_per_sm(int gh, int gw) {
  return use_ring<K>(gh, gw, Op::kPerKnot) ? blocks_per_sm<K, Op, true>(gh, gw)
                                           : blocks_per_sm<K, Op, false>(gh, gw);
}

template <int K, class Op, bool kRing>
cudaError_t launch_partial(const float* jwin, const int* base, int base_sn,
                           int base_sc, const float* per_obs, int n, int gh,
                           int gw, float* partial, int nblocks,
                           cudaStream_t stream) {
  size_t smem = 0;
  const cudaError_t err = set_partial_smem<K, Op, kRing>(gh, gw, &smem);
  if (err != cudaSuccess) return err;
  window_partial_kernel<K, Op, kRing>
      <<<nblocks, Tile<K, kRing>::kThreads, smem, stream>>>(
          jwin, base, base_sn, base_sc, per_obs, n, gh, gw, partial);
  return cudaGetLastError();
}

template <int K, class Op>
cudaError_t launch_window_reduce(const float* jwin, const int* base,
                                 int base_sn, int base_sc,
                                 const float* per_obs, int n, int gh, int gw,
                                 float* partial, int nblocks, float* out,
                                 cudaStream_t stream) {
  cudaError_t err =
      use_ring<K>(gh, gw, Op::kPerKnot)
          ? launch_partial<K, Op, true>(jwin, base, base_sn, base_sc, per_obs,
                                        n, gh, gw, partial, nblocks, stream)
          : launch_partial<K, Op, false>(jwin, base, base_sn, base_sc,
                                         per_obs, n, gh, gw, partial, nblocks,
                                         stream);
  if (err != cudaSuccess) return err;
  const int cols = gh * gw * Op::kPerKnot;
  window_sum_kernel<Op><<<(cols + 31) / 32, dim3(32, kSumWarps), 0, stream>>>(
      partial, nblocks, gh * gw, out);
  return cudaGetLastError();
}

}  // namespace cct
