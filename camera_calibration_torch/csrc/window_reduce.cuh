// Deterministic window reductions onto the knot grid, shared by
// window_apply_jtw.cu and window_block_diag.cu.
//
// Every observation n adds a few values to each knot of its 4x4 window at
// base (bx, by).  On the TPU the grid steps ran in order and one VMEM
// accumulator took every tile.  Here blocks run in parallel and in no
// order, so the reduction has two passes, and both sum in a fixed order:
//
// 1. window_partial_kernel: each block walks a fixed set of observation
//    tiles (tile i of block b covers observations (b + i*gridDim.x)*kTile
//    ...) and keeps its band's rows of the accumulator grid.
//    - Tiles through registers.  While a tile is visited, every thread
//      has its loads of the next tile in flight: the 32K j_win rows of one
//      observation (of kLoadGroups) in pairs (f, 16K + f), its per-
//      observation floats and its window base.  After the visits it
//      writes them prepared (Op::store) into the one float32 stage: JtW
//      folds ws in (16K rows), the K = 2 block diagonal its products
//      (48 rows), the K = 5 one keeps the 32K values and the weight.  A
//      bf16 j_win is read in half the bytes and widened there: every sum
//      is float32, and both element types share one layout.
//    - Who adds what where is one of two visit schemes, chosen by grid
//      (use_owners()), since each is faster on one side of kOwnerKnots:
//      - Knot owners (grids of at most kOwnerKnots knots, the bench's
//        16x16).  Each knot has two owner threads, one for each 32
//        observations of a tile, which keep its sums in registers for the
//        whole walk.  Per tile the first two warps set, with one
//        __ballot_sync per grid row and per grid column, bit p of the
//        row's (column's) mask word iff the window of observation p
//        covers it; an owner visits the set bits of its row mask AND
//        column mask in increasing order.  On a small grid a tile's 64
//        observations fall on few knots, which the owners take in
//        registers.  The two halves are added in a fixed order at the end.
//      - Slot classes (larger grids).  Knot (h, w) of a band starting at
//        row h0 belongs to class (a, c) = ((h - h0) & 3, w & 3).  A 4x4
//        window holds exactly one knot of each class, so observation p
//        adds exactly one window slot, (y, x) = ((a - (by - h0)) & 3,
//        (c - bx) & 3), to class (a, c).  Warp a + 4c of the 16 owns class
//        (a, c): it takes the tile's observations 32 at a time, one a lane,
//        and adds each one's slot to its class knot.  Lanes whose knots
//        coincide (__match_any_sync) pass their values to the lowest of
//        them (__shfl_sync), which adds them in lane order and then to the
//        knot.  A tile costs the same whatever the grid: no mask or knot
//        scan, and no warp idles on a clustered tile.  The accumulator is
//        laid out class by class, each class's knots row by row
//        ((h - h0) >> 2, w >> 2): a warp's neighbouring knots sit in
//        neighbouring words.
//      Either way every knot's sum runs in an order fixed by the data
//      alone, with no atomics.
//    - Bands.  Where the whole (gh, gw) grid leaves no room in one block,
//      the launch grid's second dimension runs over bands of band_rows
//      grid rows (the fewest bands that fit; band_rows()).  Block (b, y)
//      walks the same tiles as block (b, 0) and keeps band y's rows; an
//      observation whose knot lies outside the band adds nothing there.
//      The persistent grid holds every band's blocks at once, so the
//      blocks of one tile sequence read it from device memory about
//      together.  Each knot belongs to one band, so its sum runs over the
//      same tiles in the same order whatever the band height.
//    - Clusters.  The kCluster blocks of a thread-block cluster (along x)
//      sum their accumulators in rank order over distributed shared
//      memory and write one partial row: gridDim.x / kCluster rows.
// 2. window_sum_kernel: a block of kSumWarps warps takes 32 consecutive
//    output values; warp y sums rows y, y + kSumWarps, ... in order, and
//    warp 0 adds the kSumWarps sums in warp order.
//
// Results are bit-identical from run to run for a given block count,
// which the plan sets from the occupancy at the plan's band height: bands
// of another height give the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "element.cuh"

namespace cct {

namespace cgrp = cooperative_groups;

// Observations per tile.
constexpr int kTile = 64;
// Mask words per grid row or column in the owner scheme.
constexpr int kWords = kTile / 32;
// Threads per block of the partial pass: one warp per slot class.
constexpr int kThreads = 512;
constexpr int kClassWarps = kThreads / 32;
static_assert(kClassWarps == 16, "one warp per slot class");
// Threads that load one observation of a tile, each a share of its rows.
constexpr int kLoadGroups = kThreads / kTile;
// Row stride of the stage, in floats.
constexpr int kStride = kTile + 1;
// Blocks of a cluster, which reduce their accumulators into one partial
// row.
constexpr int kCluster = 2;
// Warps per block of the sum pass.
constexpr int kSumWarps = 16;
// Grids of at most this many knots take the owner scheme: two owner
// threads a knot.
constexpr int kOwnerKnots = kThreads / kWords;
// Shared memory one block may use on Hopper (227 KB).
constexpr size_t kMaxSmemBytes = 232448;

// Whether a grid takes the owner scheme.
inline bool use_owners(int gh, int gw) {
  return static_cast<long long>(gh) * gw <= kOwnerKnots;
}

// Shared memory of one partial-pass block that keeps `rows` grid rows: the
// stage (Op::kPrepRows float rows of kStride, two int rows of kTile bases),
// in the owner scheme the row and column masks ((rows + gw) * kWords
// words), and the accumulator (rows * gw * Op::kPerKnot floats).
template <class Op>
inline size_t band_smem_bytes(int rows, int gw, bool owners) {
  return sizeof(float) *
         (static_cast<size_t>(Op::kPrepRows) * kStride + 2 * kTile +
          (owners ? static_cast<size_t>(rows + gw) * kWords : 0) +
          static_cast<size_t>(rows) * gw * Op::kPerKnot);
}

// Of n rows (or columns) 0..n-1, those of class a (i & 3 == a).
__device__ __forceinline__ int class_count(int n, int a) {
  return (n - a + 3) >> 2;
}

// Of n rows (or columns), those of the classes before a.
__device__ __forceinline__ int classes_before(int n, int a) {
  return a * (n >> 2) + min(a, n & 3);
}

// First knot of class (a, c) in the accumulator of a band of hb rows:
// classes in order a-major, each class's knots row by row.
__device__ __forceinline__ int class_offset(int hb, int gw, int a, int c) {
  return classes_before(hb, a) * gw +
         class_count(hb, a) * classes_before(gw, c);
}

// Rows per band: ceil(gh / nb) for the fewest bands nb that fit one block;
// gh where the whole grid fits (always in the owner scheme).  0 where one
// grid row does not fit.  Mirrored by reduction_plan in ba/window_cuda.py.
template <class Op>
inline int band_rows(int gh, int gw) {
  const bool owners = use_owners(gh, gw);
  for (int nb = 1; nb <= gh; ++nb) {
    const int rows = (gh + nb - 1) / nb;
    if (band_smem_bytes<Op>(rows, gw, owners) <= kMaxSmemBytes) return rows;
  }
  return 0;
}

// Shared memory of one partial-pass block at this grid (its band's rows;
// one row where even that does not fit).  Mirrored by
// reduction_smem_bytes in ba/window_cuda.py.
template <class Op>
inline size_t partial_smem_bytes(int gh, int gw) {
  const int rows = band_rows<Op>(gh, gw);
  return band_smem_bytes<Op>(rows > 0 ? rows : 1, gw, use_owners(gh, gw));
}

// Op supplies
// - kPerKnot: values per knot; kPerObs: floats per observation in per_obs
//   (at most 2); kPrepRows: float rows of one observation in the stage;
//   kMinBlocks: the blocks per SM its registers are bounded for;
// - row(g, i): the row f of the i-th of the 2K pairs (f, 16K + f) of
//   j_win rows that load group g (0..kLoadGroups-1) reads;
// - store(stage, a, b, w, p, g): writes observation p's prepared rows
//   from group g's pairs (a[i], b[i]) and its per-observation floats w;
// - contribution(v, stage, p, slot): observation p's kPerKnot values for
//   window slot `slot` (y*4 + x);
// - store_out(out, knot, r, v): writes value r of a knot to the output.
template <int K, class Op, class E, bool kOwners>
__global__ void __launch_bounds__(kThreads, Op::kMinBlocks)
window_partial_kernel(const E* __restrict__ jwin,
                      const int* __restrict__ base, int base_sn, int base_sc,
                      const float* __restrict__ per_obs, int n_obs, int gh,
                      int gw, int band_rows, float* __restrict__ partial) {
  constexpr int T = kTile;
  constexpr int NT = kThreads;
  constexpr int S = kStride;
  constexpr int R = Op::kPerKnot;
  constexpr int NP = 2 * K;  // row pairs a thread loads
  constexpr int kObsBatches = T / 32;
  static_assert(16 * K == kLoadGroups * NP, "every row pair has a loader");
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;
  int* sbx = reinterpret_cast<int*>(stage + Op::kPrepRows * S);
  int* sby = sbx + T;
  // owner scheme: the masks of the band's rows and of the grid's columns
  unsigned* rowm = reinterpret_cast<unsigned*>(sby + T);
  unsigned* colm = rowm + (kOwners ? band_rows * kWords : 0);
  float* acc = reinterpret_cast<float*>(colm + (kOwners ? gw * kWords : 0));
  // this block's band: grid rows h0 .. h0 + hb - 1
  const int h0 = blockIdx.y * band_rows;
  const int hb = min(band_rows, gh - h0);
  const int t = threadIdx.x;
  const int ntiles = (n_obs + T - 1) / T;
  const int b = blockIdx.x;
  const int mine = b < ntiles ? (ntiles - 1 - b) / gridDim.x + 1 : 0;
  const size_t N = static_cast<size_t>(n_obs);
  // this thread loads observation lp of each tile, pairs of group lg
  const int lp = t % T;
  const int lg = t / T;
  E ra[NP], rb[NP];
  float rw[Op::kPerObs];
  int rbx = 0, rby = 0;
  auto load_tile = [&](int start) {
    // an observation past the end reads observation 0: it is never visited
    const size_t n = start + lp < n_obs ? static_cast<size_t>(start + lp) : 0;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int f = Op::row(lg, i);
      ra[i] = jwin[f * N + n];
      rb[i] = jwin[(16 * K + f) * N + n];
    }
#pragma unroll
    for (int c = 0; c < Op::kPerObs; ++c) rw[c] = per_obs[n * Op::kPerObs + c];
    if (lg == 0) {
      rbx = base[n * base_sn];
      rby = base[n * base_sn + base_sc];
    }
  };
  auto store_tile = [&]() {
    float a[NP], bb[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      a[i] = to_float(ra[i]);
      bb[i] = to_float(rb[i]);
    }
    Op::store(stage, a, bb, rw, lp, lg);
    if (lg == 0) {
      sbx[lp] = rbx;
      sby[lp] = rby;
    }
  };
  auto tile_start = [&](int i) {
    return (b + i * static_cast<int>(gridDim.x)) * T;
  };
  if (mine > 0) load_tile(tile_start(0));
  if constexpr (!kOwners)
    for (int i = t; i < hb * gw * R; i += NT) acc[i] = 0.0f;
  if (mine > 0) store_tile();
  __syncthreads();

  const int lane = t & 31;
  const int warp = t >> 5;
  // slot classes: this warp's class, rows h - h0 = ca, columns w = cc
  // (mod 4)
  const int ca = warp & 3;
  const int cc = warp >> 2;
  const int ccols = class_count(gw, cc);
  const unsigned lower = (1u << lane) - 1u;
  float* cacc = acc + class_offset(hb, gw, ca, cc) * R;
  // owners: this thread's knot (neighbouring knots on other warps) and its
  // half of each tile's observations; its sums
  const int own = lane * (kClassWarps / kWords) + warp % (kClassWarps / kWords);
  const int half = warp / (kClassWarps / kWords);
  float a[R];
#pragma unroll
  for (int j = 0; j < R; ++j) a[j] = 0.0f;
  for (int i = 0; i < mine; ++i) {
    if (i + 1 < mine) load_tile(tile_start(i + 1));
    const int count = min(T, n_obs - tile_start(i));
    if constexpr (kOwners) {
      if (t < T) {
        // masks of this warp's 32 observations
        const bool valid = t < count;
        const int bx = sbx[t];
        const int by = sby[t];
        for (int h = 0; h < hb; ++h) {
          const unsigned m = __ballot_sync(
              0xffffffffu, valid && static_cast<unsigned>(h0 + h - by) < 4u);
          if (lane == (h & 31)) rowm[h * kWords + warp] = m;
        }
        for (int w = 0; w < gw; ++w) {
          const unsigned m = __ballot_sync(
              0xffffffffu, valid && static_cast<unsigned>(w - bx) < 4u);
          if (lane == (w & 31)) colm[w * kWords + warp] = m;
        }
      }
      __syncthreads();  // the masks are set
      if (own < hb * gw) {
        const int kh = own / gw;
        const int kw = own - kh * gw;
        for (unsigned m = rowm[kh * kWords + half] & colm[kw * kWords + half];
             m; m &= m - 1u) {
          const int p = half * 32 + __ffs(static_cast<int>(m)) - 1;
          float v[R];
          Op::contribution(v, stage, p,
                           (h0 + kh - sby[p]) * 4 + (kw - sbx[p]));
#pragma unroll
          for (int j = 0; j < R; ++j) a[j] += v[j];
        }
      }
    } else {
      for (int q = 0; q < kObsBatches; ++q) {
        const int p = q * 32 + lane;
        const int bx = sbx[p];
        const int by = sby[p] - h0;  // within the band
        const int y = (ca - by) & 3;
        const int x = (cc - bx) & 3;
        const int h = by + y;
        const int w = bx + x;
        const bool valid =
            p < count && static_cast<unsigned>(h) < static_cast<unsigned>(hb) &&
            static_cast<unsigned>(w) < static_cast<unsigned>(gw);
        // the class knot, or a key of this lane alone
        const int key = valid ? (h >> 2) * ccols + (w >> 2) : -1 - lane;
        const unsigned same = __match_any_sync(0xffffffffu, key);
        const int rank = __popc(same & lower);
        const int rounds = __reduce_max_sync(0xffffffffu, rank);
        float v[R];
#pragma unroll
        for (int j = 0; j < R; ++j) v[j] = 0.0f;
        if (valid) Op::contribution(v, stage, p, y * 4 + x);
        // the lowest lane of each group adds the others' values in lane
        // order, then the group's knot takes that sum
        unsigned rest = same & (same - 1u);
        for (int r = 0; r < rounds; ++r) {
          const int src = rest ? __ffs(static_cast<int>(rest)) - 1 : lane;
          rest &= rest - 1u;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const float o = __shfl_sync(0xffffffffu, v[j], src);
            if (rank == 0 && src != lane) v[j] += o;
          }
        }
        if (valid && rank == 0) {
          float* ak = cacc + key * R;
#pragma unroll
          for (int j = 0; j < R; ++j) ak[j] += v[j];
        }
        __syncwarp();
      }
    }
    __syncthreads();  // tile i is consumed
    if (i + 1 < mine) store_tile();
    __syncthreads();  // tile i + 1 is in the stage
  }
  if constexpr (kOwners) {
    // the two halves of each knot, in order, into the accumulator (the
    // second half's sums pass through the stage, which is free now)
    if (half == 1 && own < hb * gw)
#pragma unroll
      for (int j = 0; j < R; ++j) stage[own * R + j] = a[j];
    __syncthreads();
    if (half == 0 && own < hb * gw)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[own * R + j] = a[j] + stage[own * R + j];
  }

  // The cluster's accumulators, summed in rank order into its partial row.
  cgrp::cluster_group cluster = cgrp::this_cluster();
  cluster.sync();
  const int crank = static_cast<int>(cluster.block_rank());
  float* row = partial +
               (static_cast<size_t>(b / kCluster) * gh + h0) * gw * R;
  const float* accs[kCluster];
#pragma unroll
  for (int k = 0; k < kCluster; ++k) accs[k] = cluster.map_shared_rank(acc, k);
  // kBatch values a thread at a time, their loads all in flight
  constexpr int kBatch = 8;
  constexpr int kStep = kCluster * NT;
  const int total = hb * gw * R;
  for (int i0 = crank * NT + t; i0 < total; i0 += kBatch * kStep) {
    float s[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kStep;
      s[u] = 0.0f;
      if (i < total) {
        int idx = i;
        if constexpr (!kOwners) {
          const int knot = i / R;
          const int hr = knot / gw;
          const int w = knot - hr * gw;
          idx = (class_offset(hb, gw, hr & 3, w & 3) +
                 (hr >> 2) * class_count(gw, w & 3) + (w >> 2)) * R +
                i - knot * R;
        }
#pragma unroll
        for (int k = 0; k < kCluster; ++k) s[u] += accs[k][idx];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * kStep < total) row[i0 + u * kStep] = s[u];
  }
  cluster.sync();  // no block leaves while another reads its accumulator
}

// out = the sum of the partial rows; Op::store_out writes value r of
// knot k into the output layout.  Block (32, kSumWarps) takes 32
// consecutive values: warp y sums rows y, y + kSumWarps, ... in order,
// then warp 0 adds the kSumWarps sums in warp order.
template <class Op>
__global__ void __launch_bounds__(32 * kSumWarps)
window_sum_kernel(const float* __restrict__ partial, int nrows, int knots,
                  float* __restrict__ out) {
  constexpr int R = Op::kPerKnot;
  __shared__ float sums[kSumWarps][33];
  const int cols = knots * R;
  const int i = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (i < cols) {
#pragma unroll 4
    for (int r = threadIdx.y; r < nrows; r += kSumWarps)
      s += partial[static_cast<size_t>(r) * cols + i];
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < cols) {
    float t = sums[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < kSumWarps; ++y) t += sums[y][threadIdx.x];
    Op::store_out(out, i / R, i % R, t);
  }
}

template <int K, class Op, class E, bool kOwners>
cudaError_t set_partial_smem(int rows, int gw, size_t* smem) {
  *smem = band_smem_bytes<Op>(rows, gw, kOwners);
  if (*smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(window_partial_kernel<K, Op, E, kOwners>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <int K, class Op, class E, bool kOwners>
int blocks_per_sm(int rows, int gw) {
  size_t smem = 0;
  if (set_partial_smem<K, Op, E, kOwners>(rows, gw, &smem) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, window_partial_kernel<K, Op, E, kOwners>, kThreads,
          smem) != cudaSuccess)
    return 0;
  return blocks;
}

// Partial-pass blocks that fit on one SM at once at this grid's band (0 if
// none does).
template <int K, class Op, class E>
int window_reduce_blocks_per_sm(int gh, int gw) {
  const int rows = band_rows<Op>(gh, gw);
  if (rows == 0) return 0;
  return use_owners(gh, gw) ? blocks_per_sm<K, Op, E, true>(rows, gw)
                            : blocks_per_sm<K, Op, E, false>(rows, gw);
}

template <int K, class Op, class E, bool kOwners>
cudaError_t launch_partial(const E* jwin, const int* base, int base_sn,
                           int base_sc, const float* per_obs, int n, int gh,
                           int gw, int rows, float* partial, int nblocks,
                           cudaStream_t stream) {
  size_t smem = 0;
  const cudaError_t err =
      set_partial_smem<K, Op, E, kOwners>(rows, gw, &smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks, (gh + rows - 1) / rows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, window_partial_kernel<K, Op, E, kOwners>,
                            jwin, base, base_sn, base_sc, per_obs, n, gh, gw,
                            rows, partial);
}

// `rows`: grid rows per band (band_rows() unless a caller asks for
// narrower bands; the results are the same).  `nblocks`: blocks per band,
// a multiple of kCluster; `partial` holds nblocks / kCluster rows of
// gh * gw * Op::kPerKnot floats.  The visit scheme is the grid's
// (use_owners()), whatever the band height.
template <int K, class Op, class E>
cudaError_t launch_window_reduce(const E* jwin, const int* base,
                                 int base_sn, int base_sc,
                                 const float* per_obs, int n, int gh, int gw,
                                 int rows, float* partial, int nblocks,
                                 float* out, cudaStream_t stream) {
  if (rows < 1 || rows > gh || nblocks < kCluster || nblocks % kCluster)
    return cudaErrorInvalidValue;
  const cudaError_t err =
      use_owners(gh, gw)
          ? launch_partial<K, Op, E, true>(jwin, base, base_sn, base_sc,
                                           per_obs, n, gh, gw, rows, partial,
                                           nblocks, stream)
          : launch_partial<K, Op, E, false>(jwin, base, base_sn, base_sc,
                                            per_obs, n, gh, gw, rows, partial,
                                            nblocks, stream);
  if (err != cudaSuccess) return err;
  const int cols = gh * gw * Op::kPerKnot;
  window_sum_kernel<Op><<<(cols + 31) / 32, dim3(32, kSumWarps), 0, stream>>>(
      partial, nblocks / kCluster, gh * gw, out);
  return cudaGetLastError();
}

}  // namespace cct
