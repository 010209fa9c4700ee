// K9 and K10: E2 update over a dst-sorted pair list whose segments are
// marked by flags, pool[gd] -= sum over a dst segment of op(a) . op(b)^T.
//
// Replaces two Pallas kernels of pastix_tpu/numeric/pallas_kernels.py,
// each with its plain, scaled (d: LDL^T) and cross-pool (LU) variants:
// - K9, gemm_scatter_fused (_mk_kernel_src, the round-2 E2), one pair per
//   TPU grid step over sort_triples output: a is pool tile ga[p], b tile
//   gb[p] of the pool itself or of the other pool of LU;
// - K10, gemm_scatter_blockspec (_mk_blockspec_kernel), one chunk of a
//   group-1 build_pipeline_schedule table: the host gathers the chunk's
//   distinct a tiles (Xa, from the pool) and b tiles (Xb), fp32, as the
//   reference does outside its kernel, and pair p reads Xa[ga_c[p]] and
//   Xb[gb_c[p]].
// Both are one launch of the kernel below: a pair reads a_src[pos_a[p]]
// and b_src[pos_b[p]], its dst is pool tile pair_d[p], and flags[p] bit 1
// marks the first pair of a dst segment and bit 2 its last (the
// schedule's flags; K9's first/last arrays are packed so on the host).
// Every segment subtracts the sum of its pairs' op(a) . op(b)^T from its
// dst tile; op rounds an fp32 tile to bf16 when the update dtype is bf16
// and leaves it fp32 otherwise, after the scaled variant multiplies a's
// column k by d[pair_k[p] * T + k]; products accumulate in fp32.  The
// reference forms fp32 products from three bf16 passes (its TPU has no
// fp32 matrix unit); here they are fp32 FMAs.
//
// What bounds it on an H100 at T = 128: as K3, a pair is 2 T^3 = 4.2 MFLOP
// against two 64 KB fp32 operand tiles that repeat across pairs and stay
// in the 50 MB L2; this design multiplies on the fp32 CUDA cores and is
// bound by their 67 TFLOP/s.
//
// First design: on the TPU the dst tile stays in VMEM from a segment's
// first pair to its last (B6 walks the pairs one grid step at a time, B7's
// BlockSpec pipeline skips the dst refetch while consecutive steps name
// the same dst).  Here the grid is (pair, 64 x 64 block of the dst tile):
// a CTA whose pair has no first flag exits at once; the others walk their
// segment to its last flag with the dst block in registers (K3's per-pair
// product, segment_gemm.cuh) and write it once.  A dst tile lies in one
// segment (the host checks), so CTAs never share a dst and need no
// atomics.  Segments run concurrently: K9's wrapper refuses pair lists
// whose dst tiles meet their a tiles (or b tiles read from the same
// pool); K10's operands are copies made before the launch.

#include "segment_gemm.cuh"

namespace {

constexpr int F_FIRST = 1, F_LAST = 2;

template <int T, bool ROUND, bool SCALED>
__global__ void __launch_bounds__(seg::Shape<T>::NT)
segment_gemm_scatter_kernel(float* pool, const float* a_src,
                            const float* b_src,
                            const int64_t* __restrict__ pos_a,
                            const int64_t* __restrict__ pos_b,
                            const int64_t* __restrict__ pair_d,
                            const int* __restrict__ flags,
                            const float* __restrict__ d,
                            const int64_t* __restrict__ pair_k, int64_t n) {
  constexpr int BM = seg::Shape<T>::BM;
  constexpr int NB = seg::Shape<T>::NB;
  constexpr int64_t TT = (int64_t)T * T;
  const int64_t p0 = blockIdx.x;
  if (!(flags[p0] & F_FIRST)) return;
  __shared__ float As[seg::BK][BM + 1];
  __shared__ float Bs[seg::BK][BM + 1];
  const int r0 = (blockIdx.y / NB) * BM;
  const int c0 = (blockIdx.y % NB) * BM;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
  for (int64_t p = p0; p < n; ++p) {
    seg::pair_product<T, float, ROUND, SCALED>(
        acc, a_src + pos_a[p] * TT, b_src + pos_b[p] * TT,
        SCALED ? d + pair_k[p] * T : nullptr, r0, c0, As, Bs);
    if (flags[p] & F_LAST) break;
  }
  seg::subtract_block<T>(pool + pair_d[p0] * TT, acc, r0, c0);
}

template <int T, bool ROUND, bool SCALED>
cudaError_t launch(float* pool, const float* A, const float* B,
                   const int64_t* pa, const int64_t* pb, const int64_t* pd,
                   const int* flags, const float* d, const int64_t* pk,
                   int64_t n, cudaStream_t s) {
  constexpr int NB = seg::Shape<T>::NB;
  dim3 grid((unsigned)n, NB * NB);
  segment_gemm_scatter_kernel<T, ROUND, SCALED>
      <<<grid, seg::Shape<T>::NT, 0, s>>>(pool, A, B, pa, pb, pd, flags, d,
                                          pk, n);
  return cudaGetLastError();
}

template <bool ROUND, bool SCALED>
cudaError_t dispatch_t(int T, float* pool, const float* A, const float* B,
                       const int64_t* pa, const int64_t* pb,
                       const int64_t* pd, const int* flags, const float* d,
                       const int64_t* pk, int64_t n, cudaStream_t s) {
  switch (T) {
    case 32:
      return launch<32, ROUND, SCALED>(pool, A, B, pa, pb, pd, flags, d, pk,
                                       n, s);
    case 64:
      return launch<64, ROUND, SCALED>(pool, A, B, pa, pb, pd, flags, d, pk,
                                       n, s);
    case 128:
      return launch<128, ROUND, SCALED>(pool, A, B, pa, pb, pd, flags, d,
                                        pk, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// a_src, b_src: fp32 (n, T, T) arrays the pairs' a and b tiles are read
// from (K9: the pools; K10: the gathered Xa, Xb).
// bf16 = 1: operands rounded to bf16 on load; 0: fp32 operands.
// d != NULL: a's columns scaled by d[pair_k * T + k].
extern "C" int pastix_segment_gemm_scatter(
    void* pool, const void* a_src, const void* b_src, const void* pos_a,
    const void* pos_b, const void* pair_d, const void* flags, const void* d,
    const void* pair_k, long long n, int T, int bf16, void* stream) {
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (d != nullptr && pair_k == nullptr) return (int)cudaErrorInvalidValue;
  auto P = (float*)pool;
  auto A = (const float*)a_src;
  auto B = (const float*)b_src;
  auto pa = (const int64_t*)pos_a;
  auto pb = (const int64_t*)pos_b;
  auto pd = (const int64_t*)pair_d;
  auto f = (const int*)flags;
  auto dd = (const float*)d;
  auto pk = (const int64_t*)pair_k;
  auto s = (cudaStream_t)stream;
  if (d != nullptr)
    return bf16 ? (int)dispatch_t<true, true>(T, P, A, B, pa, pb, pd, f, dd,
                                              pk, n, s)
                : (int)dispatch_t<false, true>(T, P, A, B, pa, pb, pd, f, dd,
                                               pk, n, s);
  return bf16 ? (int)dispatch_t<true, false>(T, P, A, B, pa, pb, pd, f, dd,
                                             pk, n, s)
              : (int)dispatch_t<false, false>(T, P, A, B, pa, pb, pd, f, dd,
                                              pk, n, s);
}
