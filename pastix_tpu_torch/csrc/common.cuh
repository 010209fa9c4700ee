// Shared helpers of the hand-written Hopper kernels (plain C interface,
// loaded with ctypes by pastix_tpu_torch/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Load one operand element as fp32 (the fp32 bodies of K1 and K3, whose
// operands are not rounded: fp32 updates, or bf16 arrays rounded when
// they were made).
__device__ __forceinline__ float load_op(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_op(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Load an a-operand element scaled by the pivot s of its column when
// SCALED (the D of LDL^T: the reference scales a's columns by d[gk]).
template <bool SCALED, typename OP>
__device__ __forceinline__ float load_scaled(const OP* p, float s) {
  const float x = load_op(p);
  return SCALED ? x * s : x;
}
