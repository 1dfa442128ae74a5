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
//    and keeps its band's rows of the accumulator grid (band_rows*gw*R
//    floats) in shared memory.  Per tile:
//    - Loads in flight: tiles are staged with cp.async: 16-byte copies
//      where every j_win row is 16-byte aligned (N a multiple of 4 floats
//      or 8 bf16, j_win 16-byte aligned), else 4-byte copies where every
//      row is 4-byte aligned (always for float32; bf16 needs N even and
//      j_win 4-byte aligned), else (bf16 only) plain 2-byte loads and
//      stores.  Where it fits, a ring of two 64-observation stages lets
//      the next tile's j_win columns, weights and bases load while this one
//      is reduced; grids whose accumulator leaves no room for the ring take
//      one stage of 32 observations, which loads while the block waits (the
//      layouts' largest grids are listed at Tile).
//    - Candidate lists: the warps of the first T threads each own 32
//      observations and set, with one __ballot_sync per grid row, bit p of
//      the row's mask word iff the window of observation p covers the row
//      (0 <= h - by < 4); the same for columns.  Meanwhile the other
//      threads fold each observation's weights into its staged column
//      (Op::prepare), so that a visit reads fewer values.  A float32 tile
//      is prepared in place.  A bfloat16 tile is staged as bf16, half the
//      bytes, and prepared into one float32 area beside the ring
//      (Op::prepare_from; Op::kPrepRows rows), which the visits read:
//      every sum stays float32.
//    - Each knot has one owner thread for the tile (knot i*NT + lane*NW +
//      warp: neighbouring knots, which a clustered tile hits together, go
//      to different warps).  The owner visits the set bits of row mask AND
//      column mask in increasing order, so its observations are added in
//      tile order, with no atomics and independent of scheduling.
//    The block's band is written to its slice of its row of the scratch
//    array.
//    Bands: where the whole (gh, gw, R) grid leaves no room for a stage in
//    one block, the launch grid gets a second dimension over bands of
//    band_rows grid rows (the fewest bands whose compact layout fits; see
//    band_rows()).  Block (b, y) walks the same tiles as block (b, 0) and
//    keeps only band y's rows: its row masks cover those rows, so an
//    observation whose window misses the band is never visited, and the
//    columns of its window slots outside the band are not prepared.  Each
//    knot belongs to one band, so every knot's sum runs over the same
//    tiles in the same order whatever the band count: results do not
//    depend on it.  A grid that fits one block takes one band.
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
#include <type_traits>

#include "element.cuh"

namespace cct {

// The tile layout of a partial-pass block for j_win elements of type E
// (float or __nv_bfloat16).  kRing: two stages of 64 observations, one
// loading while one is reduced.  Otherwise (compact): one stage of 32.
// Largest square grids of one float32 block (227 KB) in one band, ring /
// compact: K=2 JtW 155 / 166, block diagonal 127 / 135; K=5 JtW 84 / 102,
// block diagonal 48 / 58.  Past those the grid is split into bands of rows
// (band_rows()).
template <int K, bool kRing, class E>
struct Tile {
  // Observations per tile (32 per mask word).  Small tiles keep four
  // blocks (32 warps) on an SM, enough to hide the latency of the owner
  // visits.
  static constexpr int kObs = kRing ? 64 : 32;
  // Threads per block of the partial pass: the first kObs build the masks,
  // the rest prepare the columns; all own knots.
  static constexpr int kThreads = 256;
  // Row stride, in floats, of the prepared (float32) j_win rows: rows stay
  // 16-byte aligned for cp.async and start 4 banks apart.
  static constexpr int kStride = kObs + 4;
  // Whether staged rows are bf16 and prepared into a float32 area apart
  // (prep_floats).
  static constexpr bool kWiden = !std::is_same<E, float>::value;
  // Row stride, in elements, of the staged j_win rows (16-byte aligned).
  static constexpr int kStrideE = kWiden ? kObs + 8 : kStride;
  // Tiles in shared memory at once.
  static constexpr int kStages = kRing ? 2 : 1;
  // Mask words per grid row or column.
  static constexpr int kWords = kObs / 32;
  // The staged j_win rows of one stage, in floats.
  static constexpr int kRowsFloats =
      32 * K * kStrideE * static_cast<int>(sizeof(E)) / 4;
  // One stage: 32K j_win rows, two per-observation floats, two base ints.
  static constexpr int kStageFloats = kRowsFloats + 4 * kObs;
};

// The float32 area a bf16 tile is prepared into: the Op::kPrepRows rows
// that the visits read (JtW: its 16K prepared values; the block diagonal:
// all 32K rows widened).  None for a float32 tile.
template <class Tl, class Op>
constexpr int prep_floats = Tl::kWiden ? Op::kPrepRows * Tl::kStride : 0;

// Warps per block of the sum pass.
constexpr int kSumWarps = 16;

// Shared memory one block may use on Hopper (227 KB).
constexpr size_t kMaxSmemBytes = 232448;

// Shared memory of one partial-pass block in a layout: the stages, a bf16
// tile's float32 area, the row and column masks ((gh + gw) * kWords
// words), the accumulator grid of Op::kPerKnot values a knot.
template <int K, class Op, bool kRing, class E>
inline size_t layout_smem_bytes(int gh, int gw) {
  using Tl = Tile<K, kRing, E>;
  return sizeof(float) *
         (static_cast<size_t>(Tl::kStages) * Tl::kStageFloats +
          prep_floats<Tl, Op> + static_cast<size_t>(gh + gw) * Tl::kWords +
          static_cast<size_t>(gh) * gw * Op::kPerKnot);
}

// The ring wherever it fits in one block.
template <int K, class Op, class E>
inline bool use_ring(int gh, int gw) {
  return layout_smem_bytes<K, Op, true, E>(gh, gw) <= kMaxSmemBytes;
}

// Shared memory of one partial-pass block that keeps `rows` grid rows, in
// the layout it takes there.
template <int K, class Op, class E>
inline size_t band_smem_bytes(int rows, int gw) {
  return use_ring<K, Op, E>(rows, gw)
             ? layout_smem_bytes<K, Op, true, E>(rows, gw)
             : layout_smem_bytes<K, Op, false, E>(rows, gw);
}

// Rows per band: ceil(gh / nb) for the fewest bands nb whose compact layout
// fits one block; gh where the whole grid fits.  0 where one grid row does
// not fit.  Mirrored by reduction_plan in ba/window_cuda.py.
template <int K, class Op, class E>
inline int band_rows(int gh, int gw) {
  for (int nb = 1; nb <= gh; ++nb) {
    const int rows = (gh + nb - 1) / nb;
    if (layout_smem_bytes<K, Op, false, E>(rows, gw) <= kMaxSmemBytes)
      return rows;
  }
  return 0;
}

// Shared memory of one partial-pass block at this grid (its band's rows, in
// its layout; one row in the compact layout where even that does not fit).
// Mirrored by reduction_smem_bytes in ba/window_cuda.py.
template <int K, class Op, class E>
inline size_t partial_smem_bytes(int gh, int gw) {
  const int rows = band_rows<K, Op, E>(gh, gw);
  return rows > 0 ? band_smem_bytes<K, Op, E>(rows, gw)
                  : layout_smem_bytes<K, Op, false, E>(1, gw);
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

// How a tile's j_win rows are copied: 16-byte cp.async copies where every
// row is 16-byte aligned, 4-byte ones where every row is 4-byte aligned,
// else plain loads and stores of single elements (bf16 only).
enum StageMode { kCopy16 = 2, kCopy4 = 1, kScalar = 0 };

template <class E>
__device__ __forceinline__ int stage_mode(const E* jwin, int n_obs) {
  constexpr int V16 = 16 / static_cast<int>(sizeof(E));
  constexpr int V4 = 4 / static_cast<int>(sizeof(E));
  const uintptr_t a = reinterpret_cast<uintptr_t>(jwin);
  if (n_obs % V16 == 0 && (a & 15) == 0) return kCopy16;
  if (n_obs % V4 == 0 && (a & 3) == 0) return kCopy4;
  return kScalar;
}

// Start the copies of the tile at `start` into stage `st`: j_win rows
// (kStrideE elements apart), then kPerObs floats per observation, then the
// bx and by rows.  Observations past n_obs are not copied.  A bf16 tile
// holds an even count in kCopy4 (N is even there and tiles start at
// multiples of 32), so its pairs never straddle the end.
template <class Tl, int K, int kPerObs, class E>
__device__ __forceinline__ void stage_tile(float* st, const E* jwin,
                                           const int* base, int base_sn,
                                           int base_sc, const float* per_obs,
                                           int n_obs, int start, int mode) {
  constexpr int T = Tl::kObs;
  constexpr int NT = Tl::kThreads;
  constexpr int SE = Tl::kStrideE;
  constexpr int F = 32 * K;
  constexpr int EB = static_cast<int>(sizeof(E));
  const size_t N = static_cast<size_t>(n_obs);
  const int count = min(T, n_obs - start);
  const int t = threadIdx.x;
  E* rows = reinterpret_cast<E*>(st);
  if (mode == kCopy16) {
    constexpr int V = 16 / EB;  // elements per 16-byte chunk
    constexpr int C = T / V;    // chunks per row
    for (int c = t; c < F * C; c += NT) {
      const int f = c / C;
      const int q = (c - f * C) * V;
      const int left = count - q;
      if (left > 0)
        cp_async16(rows + f * SE + q, jwin + f * N + start + q,
                   min(left, V) * EB);
    }
  } else if (mode == kCopy4) {
    constexpr int V = 4 / EB;  // elements per 4-byte copy
    constexpr int C = T / V;
    for (int c = t; c < F * C; c += NT) {
      const int f = c / C;
      const int p = (c - f * C) * V;
      if (p < count) cp_async4(rows + f * SE + p, jwin + f * N + start + p);
    }
  } else {
    for (int c = t; c < F * T; c += NT) {
      const int f = c / T;
      const int p = c - f * T;
      if (p < count) rows[f * SE + p] = jwin[f * N + start + p];
    }
  }
  float* sp = st + Tl::kRowsFloats;
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
//   (at most 2); kUsesWeights: whether accumulate reads them; kPrepRows:
//   the float32 rows of a column that prepare_from writes;
// - prepare<S>(col, slot, ws): rewrites in place the rows of window slot
//   `slot` (0..15) of one observation's staged float32 column (col points
//   at it, row stride S) so that accumulate reads fewer values;
// - for a bf16 j_win, prepare_from<SI, S>(in, col, slot, ws): the same
//   from the staged bf16 column `in` (row stride SI) into the float32
//   column `col` (row stride S), within its first kPrepRows rows;
// - accumulate<S>(a, col, f0, ws): adds the observation's prepared
//   contribution to window slot f0 / K (f0 = (y*4 + x)*K) to a[kPerKnot];
// - store(out, knot, r, v): writes value r of a knot to the output.
template <int K, class Op, bool kRing, class E>
__global__ void __launch_bounds__(Tile<K, kRing, E>::kThreads)
window_partial_kernel(const E* __restrict__ jwin,
                      const int* __restrict__ base, int base_sn, int base_sc,
                      const float* __restrict__ per_obs, int n_obs, int gh,
                      int gw, int band_rows, float* __restrict__ partial) {
  using Tl = Tile<K, kRing, E>;
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
  // this block's band: grid rows h0 .. h0 + hb - 1
  const int h0 = blockIdx.y * band_rows;
  const int hb = min(band_rows, gh - h0);
  const int knots = hb * gw;
  float* ring = smem;
  // a bf16 tile's prepared float32 rows (none for float32 tiles)
  float* prep = ring + P * Q;
  unsigned* rowm = reinterpret_cast<unsigned*>(prep + prep_floats<Tl, Op>);
  unsigned* colm = rowm + band_rows * W;
  float* acc = reinterpret_cast<float*>(colm + gw * W);
  for (int i = threadIdx.x; i < knots * R; i += NT) acc[i] = 0.0f;

  const int ntiles = (n_obs + T - 1) / T;
  const int b = blockIdx.x;
  const int mine = b < ntiles ? (ntiles - 1 - b) / gridDim.x + 1 : 0;
  const int mode = stage_mode(jwin, n_obs);
  auto tile_start = [&](int i) {
    return (b + i * static_cast<int>(gridDim.x)) * T;
  };
  for (int i = 0; i < P - 1; ++i) {
    if (i < mine)
      stage_tile<Tl, K, Op::kPerObs>(ring + i * Q, jwin, base, base_sn,
                                     base_sc, per_obs, n_obs, tile_start(i),
                                     mode);
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
                                     per_obs, n_obs, tile_start(i), mode);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();  // everyone's copies of tile i have landed
    } else {
      cp_async_wait<P - 2>();  // this thread's copies of tile i have landed
      __syncthreads();  // everyone's have; tile i - 1 and the masks are consumed
      if (i + P - 1 < mine)
        stage_tile<Tl, K, Op::kPerObs>(ring + ((i + P - 1) % P) * Q, jwin,
                                       base, base_sn, base_sc, per_obs, n_obs,
                                       tile_start(i + P - 1), mode);
      cp_async_commit();
    }

    float* sj = ring + (i % P) * Q;
    const float* sp = sj + Tl::kRowsFloats;
    int* sb = reinterpret_cast<int*>(sj + Tl::kRowsFloats + 2 * T);
    // the prepared float32 columns that the visits read
    const float* cols = Tl::kWiden ? prep : sj;
    const int count = min(T, n_obs - tile_start(i));
    if (t < T) {
      // masks of this warp's 32 observations; then sb[p] becomes the
      // observation's slot offset (by*4 + bx)*K
      const bool valid = t < count;
      const int bx = valid ? sb[t] : 0;
      const int by = valid ? sb[T + t] : 0;
      for (int h = 0; h < hb; ++h) {
        const unsigned m = __ballot_sync(
            0xffffffffu, valid && static_cast<unsigned>(h0 + h - by) < 4u);
        if (lane == (h & 31)) rowm[h * W + warp] = m;
      }
      for (int w = 0; w < gw; ++w) {
        const unsigned m = __ballot_sync(
            0xffffffffu, valid && static_cast<unsigned>(w - bx) < 4u);
        if (lane == (w & 31)) colm[w * W + warp] = m;
      }
      if (valid) sb[t] = (by * 4 + bx) * K;
    } else {
      const int* sby = sb + T;
      for (int j = t - T; j < 16 * T; j += NT - T) {
        const int p = j % T;
        const int slot = j / T;
        // slots whose grid row is outside the band are never read
        if (p < count &&
            static_cast<unsigned>(sby[p] + slot / 4 - h0) < static_cast<unsigned>(hb)) {
          if constexpr (Tl::kWiden)
            Op::template prepare_from<Tl::kStrideE, S>(
                reinterpret_cast<const E*>(sj) + p, prep + p, slot,
                sp + p * Op::kPerObs);
          else
            Op::template prepare<S>(sj + p, slot, sp + p * Op::kPerObs);
        }
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
      const int hw = ((h0 + h) * 4 + w) * K;
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
          Op::template accumulate<S>(a, cols + p, hw - sb[p], ws);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) acc[knot * R + r] = a[r];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* row = partial + (static_cast<size_t>(b) * gh + h0) * gw * R;
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

template <int K, class Op, bool kRing, class E>
cudaError_t set_partial_smem(int rows, int gw, size_t* smem) {
  *smem = layout_smem_bytes<K, Op, kRing, E>(rows, gw);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(window_partial_kernel<K, Op, kRing, E>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <int K, class Op, bool kRing, class E>
int blocks_per_sm(int rows, int gw) {
  size_t smem = 0;
  if (set_partial_smem<K, Op, kRing, E>(rows, gw, &smem) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, window_partial_kernel<K, Op, kRing, E>,
          Tile<K, kRing, E>::kThreads, smem) != cudaSuccess)
    return 0;
  return blocks;
}

// Partial-pass blocks that fit on one SM at once at this grid's band (0 if
// none does).
template <int K, class Op, class E>
int window_reduce_blocks_per_sm(int gh, int gw) {
  const int rows = band_rows<K, Op, E>(gh, gw);
  if (rows == 0) return 0;
  return use_ring<K, Op, E>(rows, gw)
             ? blocks_per_sm<K, Op, true, E>(rows, gw)
             : blocks_per_sm<K, Op, false, E>(rows, gw);
}

template <int K, class Op, bool kRing, class E>
cudaError_t launch_partial(const E* jwin, const int* base, int base_sn,
                           int base_sc, const float* per_obs, int n, int gh,
                           int gw, int rows, float* partial, int nblocks,
                           cudaStream_t stream) {
  size_t smem = 0;
  const cudaError_t err = set_partial_smem<K, Op, kRing, E>(rows, gw, &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nblocks, (gh + rows - 1) / rows);
  window_partial_kernel<K, Op, kRing, E>
      <<<grid, Tile<K, kRing, E>::kThreads, smem, stream>>>(
          jwin, base, base_sn, base_sc, per_obs, n, gh, gw, rows, partial);
  return cudaGetLastError();
}

// `rows`: grid rows per band (band_rows() unless a caller asks for
// narrower bands; the results are the same).
template <int K, class Op, class E>
cudaError_t launch_window_reduce(const E* jwin, const int* base,
                                 int base_sn, int base_sc,
                                 const float* per_obs, int n, int gh, int gw,
                                 int rows, float* partial, int nblocks,
                                 float* out, cudaStream_t stream) {
  if (rows < 1 || rows > gh || nblocks < 1) return cudaErrorInvalidValue;
  cudaError_t err =
      use_ring<K, Op, E>(rows, gw)
          ? launch_partial<K, Op, true, E>(jwin, base, base_sn, base_sc,
                                           per_obs, n, gh, gw, rows, partial,
                                           nblocks, stream)
          : launch_partial<K, Op, false, E>(jwin, base, base_sn, base_sc,
                                            per_obs, n, gh, gw, rows,
                                            partial, nblocks, stream);
  if (err != cudaSuccess) return err;
  const int cols = gh * gw * Op::kPerKnot;
  window_sum_kernel<Op><<<(cols + 31) / 32, dim3(32, kSumWarps), 0, stream>>>(
      partial, nblocks, gh * gw, out);
  return cudaGetLastError();
}

}  // namespace cct
