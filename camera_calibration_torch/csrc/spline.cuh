// What the two projection kernels (project.cu, project_noncentral.cu)
// share: the cubic B-spline weights of a 4x4 window and their derivatives,
// the window's floor, and the launch plan of a persistent kernel whose
// blocks stage a grid in shared memory.  Both kernels must read the grids
// with the same B-spline convention, so it is written once, here.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>

namespace cct {

// Shared memory one block may use on Hopper (227 KB), and one SM's (228 KB,
// of which each resident block takes 1 KB for the system).  Mirrored by
// _cuda.MAX_SMEM_BYTES, SM_SMEM_BYTES and BLOCK_RESERVED_SMEM.
constexpr size_t kMaxSmemBytes = 232448;
constexpr size_t kSmSmemBytes = 233472;
constexpr size_t kBlockReservedBytes = 1024;

constexpr float kSixth = 1.0f / 6.0f;

// Cubic B-spline weights of the fractional part t, with the 1/6 folded into
// the polynomials: (1-t)^3/6, (3t^3 - 6t^2 + 4)/6, (-3t^3 + 3t^2 + 3t + 1)/6,
// t^3/6.
__device__ __forceinline__ void cubic_weights(float t, float w[4]) {
  const float t2 = t * t, t3 = t2 * t, om = 1.0f - t;
  w[0] = om * om * om * kSixth;
  w[1] = 0.5f * t3 - t2 + 2.0f / 3.0f;
  w[2] = 0.5f * (t + t2 - t3) + kSixth;
  w[3] = t3 * kSixth;
}

// d/dt of cubic_weights.
__device__ __forceinline__ void cubic_weight_derivs(float t, float d[4]) {
  const float t2 = t * t, om = 1.0f - t;
  d[0] = -0.5f * om * om;
  d[1] = 1.5f * t2 - 2.0f * t;
  d[2] = -1.5f * t2 + t + 0.5f;
  d[3] = 0.5f * t2;
}

// floor(g) held to [-1e6, 1e6] (NaN maps to -1e6), as
// ops/bspline.window_base holds it, so the integer conversion is always
// defined.
__device__ __forceinline__ float safe_floor(float g) {
  return fminf(fmaxf(floorf(g), -1.0e6f), 1.0e6f);
}

// Sets `kernel`'s shared-memory size and returns how many of its blocks of
// `threads` threads one SM holds (0 if none fits).
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem) {
  if (smem > kMaxSmemBytes) return 0;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  return blocks;
}

// The persistent grid: at most the blocks resident on the card at once, and
// no more than it takes to give every block the same number of tiles (but
// for the last few).  Mirrored by _cuda.persistent_blocks.
inline int persistent_blocks(int n, int tile, int per_sm, int sms) {
  const int tiles = (n - 1) / tile + 1;  // n > 0
  const int per_block = (tiles + per_sm * sms - 1) / (per_sm * sms);
  return (tiles + per_block - 1) / per_block;
}

// The SMs of the current device.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

}  // namespace cct
