// The element types a kernel reads j_win in: float32, or bfloat16 (the CG
// matvecs' copies), which is widened to float32 on load; every sum is
// taken in float32.

#pragma once

#include <cuda_bf16.h>

namespace cct {

__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

}  // namespace cct
