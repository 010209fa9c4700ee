// K3: right-looking E2 update, pool[dst] -= sum over a segment of a . b^T.
//
// Replaces the Pallas kernel pastix_tpu/numeric/pallas_kernels.py
// gemm_scatter_pipelined (_mk_pipelined_kernel): the plain, the scaled
// (d: LDL^T) and the cross-pool (src_pool: LU) variants, and the operand
// arrays of its compact forms (xab: the panel TRSM's bf16 stream;
// compact: per-chunk gathers of the distinct operand tiles; ab_pack:
// stacked (a, b) pairs).
// Semantics: for every dst segment of a chunk (pairs sorted by dst on the
// host), subtract the sum of its pairs' op(a) . op(b)^T over the full
// T x T dst tile, where op rounds an fp32 tile to bf16 when the update
// dtype is bf16 and leaves it fp32 otherwise; products accumulate in
// fp32.  a is tile pair_a[p] of a_src, b tile pair_b[p] of b_src: the
// pools themselves (a_src the destination pool, b_src the same pool or
// the other pool of LU), or operand arrays of fp32 or bf16 tiles built
// on the host side, which the kernel reads directly (a bf16 operand is
// already rounded).  The scaled variant multiplies a's column k by
// d[gk * T + k] (the pivot of the pair's source column) before the
// rounding, as the reference does: round(a d) from the pool,
// round(round(a) d) from a bf16 array.  The reference forms fp32 products
// from three bf16 passes; here they are fp32 FMAs.  Schur diagonal tiles
// are full, not lower, so no triangle is masked.
//
// What bounds it on an H100 at T = 128: a pair is 2 T^3 = 4.2 MFLOP
// against two 64 KB fp32 operand tiles, about 32 FLOP per byte; operands
// repeat within a segment and stay in the 50 MB L2, so this first design,
// which multiplies on the fp32 CUDA cores, is bound by their 67 TFLOP/s,
// not by memory.
//
// First design: one CTA per (segment, 64 x 64 block of the dst tile).
// Within a chunk each dst tile lies in exactly one segment, so CTAs never
// share a dst and need no atomics.  A segment cut by a chunk boundary
// writes its dst in two chunks, which stay ordered because chunks are
// launched in order on one stream.  Sources and dsts of one level are
// disjoint (the host schedule asserts it), so no CTA reads a tile another
// CTA writes.  The CTA keeps its 64 x 64 block in registers (4 x 4 per
// thread) over all pairs of the segment, staging 32-deep k slices of a and
// b through shared memory (segment_gemm.cuh, shared with K9/K10), then
// does one read-modify-write of the dst block.  wgmma/TMA tensor-core
// tiles are later work.

#include "segment_gemm.cuh"

namespace {

template <int T, typename OP, bool ROUND, bool SCALED>
__global__ void __launch_bounds__(seg::Shape<T>::NT)
pipelined_gemm_scatter_kernel(float* __restrict__ pool,
                              const OP* __restrict__ a_src,
                              const OP* __restrict__ b_src,
                              const int64_t* __restrict__ seg_ptr,
                              const int64_t* __restrict__ seg_dst,
                              const int64_t* __restrict__ pair_a,
                              const int64_t* __restrict__ pair_b,
                              const float* __restrict__ d,
                              const int64_t* __restrict__ pair_k) {
  constexpr int BM = seg::Shape<T>::BM;
  constexpr int NB = seg::Shape<T>::NB;
  constexpr int64_t TT = (int64_t)T * T;
  __shared__ float As[seg::BK][BM + 1];
  __shared__ float Bs[seg::BK][BM + 1];

  const int64_t sg = blockIdx.x;
  const int r0 = (blockIdx.y / NB) * BM;
  const int c0 = (blockIdx.y % NB) * BM;

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  const int64_t p_end = seg_ptr[sg + 1];
  for (int64_t p = seg_ptr[sg]; p < p_end; ++p)
    seg::pair_product<T, OP, ROUND, SCALED>(
        acc, a_src + pair_a[p] * TT, b_src + pair_b[p] * TT,
        SCALED ? d + pair_k[p] * T : nullptr, r0, c0, As, Bs);
  seg::subtract_block<T>(pool + seg_dst[sg] * TT, acc, r0, c0);
}

template <int T, typename OP, bool ROUND, bool SCALED>
cudaError_t launch(float* pool, const void* a_src, const void* b_src,
                   const int64_t* seg_ptr, const int64_t* seg_dst,
                   const int64_t* pair_a, const int64_t* pair_b,
                   const float* d, const int64_t* pair_k, int64_t nseg,
                   cudaStream_t stream) {
  constexpr int NB = seg::Shape<T>::NB;
  dim3 grid((unsigned)nseg, NB * NB);
  pipelined_gemm_scatter_kernel<T, OP, ROUND, SCALED>
      <<<grid, seg::Shape<T>::NT, 0, stream>>>(
          pool, (const OP*)a_src, (const OP*)b_src, seg_ptr, seg_dst, pair_a,
          pair_b, d, pair_k);
  return cudaGetLastError();
}

template <typename OP, bool ROUND, bool SCALED>
cudaError_t dispatch_t(int T, float* pool, const void* a_src,
                       const void* b_src, const int64_t* seg_ptr,
                       const int64_t* seg_dst, const int64_t* pair_a,
                       const int64_t* pair_b, const float* d,
                       const int64_t* pair_k, int64_t nseg, cudaStream_t s) {
  switch (T) {
    case 32:
      return launch<32, OP, ROUND, SCALED>(pool, a_src, b_src, seg_ptr,
                                           seg_dst, pair_a, pair_b, d, pair_k,
                                           nseg, s);
    case 64:
      return launch<64, OP, ROUND, SCALED>(pool, a_src, b_src, seg_ptr,
                                           seg_dst, pair_a, pair_b, d, pair_k,
                                           nseg, s);
    case 128:
      return launch<128, OP, ROUND, SCALED>(pool, a_src, b_src, seg_ptr,
                                            seg_dst, pair_a, pair_b, d,
                                            pair_k, nseg, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename OP>
cudaError_t dispatch_op(int bf16, int T, float* pool, const void* a_src,
                        const void* b_src, const int64_t* seg_ptr,
                        const int64_t* seg_dst, const int64_t* pair_a,
                        const int64_t* pair_b, const float* d,
                        const int64_t* pair_k, int64_t nseg, cudaStream_t s) {
  if (d != nullptr)
    return bf16 ? dispatch_t<OP, true, true>(T, pool, a_src, b_src, seg_ptr,
                                             seg_dst, pair_a, pair_b, d,
                                             pair_k, nseg, s)
                : dispatch_t<OP, false, true>(T, pool, a_src, b_src, seg_ptr,
                                              seg_dst, pair_a, pair_b, d,
                                              pair_k, nseg, s);
  return bf16 ? dispatch_t<OP, true, false>(T, pool, a_src, b_src, seg_ptr,
                                            seg_dst, pair_a, pair_b, d,
                                            pair_k, nseg, s)
              : dispatch_t<OP, false, false>(T, pool, a_src, b_src, seg_ptr,
                                             seg_dst, pair_a, pair_b, d,
                                             pair_k, nseg, s);
}

}  // namespace

// bf16 = 1: operands rounded to bf16 on load; bf16 = 0: fp32 operands.
// a_src, b_src: the tiles a and b are read from, (n, T, T) arrays of
// fp32 (op_bf16 = 0: the pools, or fp32 operand arrays) or of bf16
// (op_bf16 = 1: operand arrays rounded when they were made).
// d != NULL: a's columns scaled by d[pair_k * T + k].
extern "C" int pastix_pipelined_gemm_scatter(
    void* pool, const void* a_src, const void* b_src, const void* seg_ptr,
    const void* seg_dst, const void* pair_a, const void* pair_b,
    const void* d, const void* pair_k, long long nseg, int T, int bf16,
    int op_bf16, void* stream) {
  if (nseg <= 0) return 0;
  if (nseg > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (d != nullptr && pair_k == nullptr) return (int)cudaErrorInvalidValue;
  auto P = (float*)pool;
  auto sp = (const int64_t*)seg_ptr;
  auto sd = (const int64_t*)seg_dst;
  auto pa = (const int64_t*)pair_a;
  auto pb = (const int64_t*)pair_b;
  auto dd = (const float*)d;
  auto pk = (const int64_t*)pair_k;
  auto s = (cudaStream_t)stream;
  return op_bf16 ? (int)dispatch_op<__nv_bfloat16>(bf16, T, P, a_src, b_src,
                                                   sp, sd, pa, pb, dd, pk,
                                                   nseg, s)
                 : (int)dispatch_op<float>(bf16, T, P, a_src, b_src, sp, sd,
                                           pa, pb, dd, pk, nseg, s);
}
