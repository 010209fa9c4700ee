// Shared helpers of the hand-written Hopper kernels (plain C interface,
// loaded with ctypes by pastix_tpu_torch/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Load one operand element as fp32.  ROUND rounds an fp32 element to
// bf16 first: the update dtype is bf16 but the element comes from the
// fp32 pool (the reference casts such operands before its dot).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool ROUND>
__device__ __forceinline__ float load_op(const float* p) {
  float x = __ldg(p);
  if (ROUND) x = round_bf16(x);
  return x;
}

template <bool ROUND>
__device__ __forceinline__ float load_op(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Load an a-operand element from the fp32 pool, scaled by the pivot s
// of its column when SCALED (the D of LDL^T: the reference scales a's
// columns by d[gk] before its cast), then rounded to bf16 when ROUND.
template <bool ROUND, bool SCALED>
__device__ __forceinline__ float load_scaled(const float* p, float s) {
  float x = __ldg(p);
  if (SCALED) x *= s;
  if (ROUND) x = round_bf16(x);
  return x;
}

// The same for an a operand stored in bf16 (an operand array rounded
// when it was produced): the pivot scaling, then a second rounding when
// ROUND, as the reference computes round(round(L) d).
template <bool ROUND, bool SCALED>
__device__ __forceinline__ float load_scaled(const __nv_bfloat16* p,
                                             float s) {
  float x = __bfloat162float(*p);
  if (SCALED) {
    x *= s;
    if (ROUND) x = round_bf16(x);
  }
  return x;
}
