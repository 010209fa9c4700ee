// The per-pair product of the segment-walking E2 kernels on the CUDA
// cores: K9/K10 (segment_gemm_scatter.cu, fp32 and bf16 updates) and K3's
// fp32 updates (pipelined_gemm_scatter.cu; K3's bf16 updates run on the
// tensor cores, seg_mma.cuh).
//
// A CTA of NT = (BM / 4)^2 threads owns one BM x BM block (rows r0.., cols
// c0..) of a T x T dst tile and keeps it in registers, 4 x 4 a thread,
// over every pair of its dst segment; each pair's a and b are staged
// through shared memory in BK-deep k slices, all loads of a slice issued
// before its first store.  Operands are tiles of OP (fp32, or bf16 already
// rounded); an fp32 tile is rounded to bf16 on load when ROUND; a's column
// k is scaled by dk[k] first when SCALED (common.cuh's load_scaled).
//
// What bounds it: the products run on the fp32 CUDA cores (67 TFLOP/s at
// best, 4 x 4 a thread), and each slice is loaded synchronously, two
// barriers a slice with no load in flight during the products: K9 and
// K10 run 9-11x above their byte bounds on an H100 (PERF.md §6).  Moving
// them onto seg_mma.cuh, as K3's bf16 path did, is queued work.
#pragma once

#include "common.cuh"

namespace seg {

constexpr int BK = 32;

template <int T>
struct Shape {
  static constexpr int BM = T < 64 ? T : 64;  // dst block edge
  static constexpr int NB = T / BM;           // blocks per tile edge
  static constexpr int NT = (BM / 4) * (BM / 4);
};

// acc += op(a[r0:r0+BM, :] diag(dk)) . op(b[c0:c0+BM, :])^T
template <int T, typename OP, bool ROUND, bool SCALED>
__device__ __forceinline__ void pair_product(
    float (&acc)[4][4], const OP* a, const OP* b,
    const float* __restrict__ dk, int r0, int c0,
    float (*As)[Shape<T>::BM + 1], float (*Bs)[Shape<T>::BM + 1]) {
  constexpr int BM = Shape<T>::BM;
  constexpr int NT = Shape<T>::NT;
  constexpr int LD = BM * BK / NT;  // slice elements per thread
  const int tid = threadIdx.x;
  const int tx = tid % (BM / 4);
  const int ty = tid / (BM / 4);
  for (int k0 = 0; k0 < T; k0 += BK) {
    float av_ld[LD], bv_ld[LD];
#pragma unroll
    for (int l = 0; l < LD; ++l) {
      const int e = tid + l * NT;
      const int kk = k0 + e % BK;
      av_ld[l] = load_scaled<ROUND, SCALED>(
          a + (int64_t)(r0 + e / BK) * T + kk, SCALED ? __ldg(dk + kk) : 1.f);
      bv_ld[l] = load_op<ROUND>(b + (int64_t)(c0 + e / BK) * T + kk);
    }
#pragma unroll
    for (int l = 0; l < LD; ++l) {
      const int e = tid + l * NT;
      As[e % BK][e / BK] = av_ld[l];
      Bs[e % BK][e / BK] = bv_ld[l];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) av[u] = As[kk][ty * 4 + u];
#pragma unroll
      for (int v = 0; v < 4; ++v) bv[v] = Bs[kk][tx * 4 + v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    __syncthreads();
  }
}

// dst[r0:r0+BM, c0:c0+BM] -= acc, one read-modify-write
template <int T>
__device__ __forceinline__ void subtract_block(float* dst,
                                               float (&acc)[4][4], int r0,
                                               int c0) {
  constexpr int BM = Shape<T>::BM;
  const int tx = threadIdx.x % (BM / 4);
  const int ty = threadIdx.x / (BM / 4);
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      dst[(int64_t)(r0 + ty * 4 + u) * T + c0 + tx * 4 + v] -= acc[u][v];
}

}  // namespace seg
