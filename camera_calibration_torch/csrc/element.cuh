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

// A value read once, widened to float32: through the read-only path
// without allocating in L1 (ld.global.nc.L1::no_allocate), so a stream of
// such values leaves L1 to what is read again; L2 keeps its usual policy.
__device__ __forceinline__ float load_once(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float load_once(const __nv_bfloat16* p) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.b16 %0, [%1];" : "=h"(v) : "l"(p));
  return __bfloat162float(__ushort_as_bfloat16(v));
}

}  // namespace cct
