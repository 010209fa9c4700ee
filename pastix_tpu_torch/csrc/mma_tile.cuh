// bf16 tensor-core tiles for the E2 kernels: asynchronous 16-byte copies
// into a shared-memory ring, and one warp's product of a (16 MI) x (8 NI)
// output block over a 16-deep k step with mma.sync m16n8k16 (bf16 in,
// fp32 accumulators in registers).
//
// Operands sit in shared memory k-contiguous: a as [m][k], b as [n][k]
// (both tiles of an E2 pair are read as stored: C = a . b^T), rows
// padded to 40 elements so that the eight rows an ldmatrix (bf16) or a
// float2 load (fp32) touches fall into distinct banks.  Either operand is
// bf16 (ldmatrix), or fp32 rounded to bf16 (cvt.rn) as its fragment is
// loaded, which is where the plain twins round it.  a's columns may be
// scaled by the pivots dk first: an fp32 a is scaled and rounded once,
// round(a d); a bf16 a, already rounded when it was stored, is widened,
// scaled and rounded again, round(round(a) d), so it cannot go through
// ldmatrix as stored.
#pragma once

#include "common.cuh"

namespace mma_tile {

constexpr int LD = 40;  // padded row of a k slice, in elements (<= 32 used)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; with valid == false the 16 bytes are zeroed
// and nothing is read (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two fp32 values -> one bf16x2 register (lo in the low half), rounded
// to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive k elements of row r of an operand slice as fp32
template <bool F32>
__device__ __forceinline__ float2 load_pair(const void* s, int r, int k) {
  if constexpr (F32) {
    return *(const float2*)((const float*)s + r * LD + k);
  } else {
    return __bfloat1622float2(
        *(const __nv_bfloat162*)((const __nv_bfloat16*)s + r * LD + k));
  }
}

// a fragment of rows m0..m0+15, k kk..kk+15 (the m16n8k16 A layout); an
// fp32 a, or any a with dk != nullptr, is built from fp32 values (scaled
// by dk, then rounded), a bf16 a without dk goes through ldmatrix
template <bool F32>
__device__ __forceinline__ void load_a(uint32_t a[4], const void* s, int m0,
                                       int kk, const float* dk) {
  const int lane = threadIdx.x & 31;
  if (F32 || dk != nullptr) {
    const int g = lane >> 2, c = (lane & 3) * 2;
    float2 x0 = load_pair<F32>(s, m0 + g, kk + c);
    float2 x1 = load_pair<F32>(s, m0 + g + 8, kk + c);
    float2 x2 = load_pair<F32>(s, m0 + g, kk + c + 8);
    float2 x3 = load_pair<F32>(s, m0 + g + 8, kk + c + 8);
    if (dk != nullptr) {  // a's columns scaled by the pivots, then rounded
      const float2 s0 = *(const float2*)(dk + kk + c);
      const float2 s1 = *(const float2*)(dk + kk + c + 8);
      x0.x *= s0.x; x0.y *= s0.y; x1.x *= s0.x; x1.y *= s0.y;
      x2.x *= s1.x; x2.y *= s1.y; x3.x *= s1.x; x3.y *= s1.y;
    }
    a[0] = pack_bf16(x0.x, x0.y);
    a[1] = pack_bf16(x1.x, x1.y);
    a[2] = pack_bf16(x2.x, x2.y);
    a[3] = pack_bf16(x3.x, x3.y);
  } else {
    const __nv_bfloat16* h = (const __nv_bfloat16*)s;
    ldmatrix_x4(a, h + (m0 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
  }
}

// b fragments of two n8 tiles, rows n0..n0+15 of b, k kk..kk+15:
// b[0..1] for n0..n0+7, b[2..3] for n0+8..n0+15; an fp32 b is rounded
template <bool F32>
__device__ __forceinline__ void load_b2(uint32_t b[4], const void* s, int n0,
                                        int kk) {
  const int lane = threadIdx.x & 31;
  if constexpr (F32) {
    const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 x0 = load_pair<true>(s, n0 + 8 * h + g, kk + c);
      const float2 x1 = load_pair<true>(s, n0 + 8 * h + g, kk + c + 8);
      b[2 * h] = pack_bf16(x0.x, x0.y);
      b[2 * h + 1] = pack_bf16(x1.x, x1.y);
    }
  } else {
    const __nv_bfloat16* h = (const __nv_bfloat16*)s;
    ldmatrix_x4(b, h + (n0 + (lane >> 4) * 8 + (lane & 7)) * LD + kk +
                       ((lane >> 3) & 1) * 8);
  }
}

// acc[mi][ni] += a(m0 + 16 mi) . b(n0 + 8 ni)^T over one 16-deep k step
// of a stage; row groups with live[mi] false issue no mma (the warp
// decides uniformly)
template <int MI, int NI, bool A_F32, bool B_F32>
__device__ __forceinline__ void warp_mma_k16(float acc[MI][NI][4],
                                             const void* sa, const void* sb,
                                             int m0, int n0, int kk,
                                             const float* dk,
                                             const bool live[MI]) {
  uint32_t a[MI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    if (live[mi]) load_a<A_F32>(a[mi], sa, m0 + 16 * mi, kk, dk);
#pragma unroll
  for (int nj = 0; nj < NI; nj += 2) {
    uint32_t b[4];
    load_b2<B_F32>(b, sb, n0 + 8 * nj, kk);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if (!live[mi]) continue;
      mma16816(acc[mi][nj], a[mi], b);
      mma16816(acc[mi][nj + 1], a[mi], b + 2);
    }
  }
}

}  // namespace mma_tile
