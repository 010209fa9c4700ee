// K3: right-looking E2 update, pool[dst] -= sum over a segment of a . b^T.
//
// Replaces the Pallas kernel pastix_tpu/numeric/pallas_kernels.py
// gemm_scatter_pipelined (_mk_pipelined_kernel): the plain, the scaled
// (d: LDL^T) and the cross-pool (src_pool: LU) variants.
// Semantics: for every dst segment of a chunk (pairs sorted by dst on the
// host), subtract the sum of its pairs' op(a) . op(b)^T over the full
// T x T dst tile, where op rounds an fp32 tile to bf16 when the update
// dtype is bf16 and leaves it fp32 otherwise; products accumulate in
// fp32.  a is read from the destination pool, b from b_src (the same
// pool, or the other pool of LU); the scaled variant multiplies a's column
// k by d[gk * T + k] (the pivot of the pair's source column) before the
// rounding, as the reference does.  The reference forms fp32 products from three bf16 passes;
// here they are fp32 FMAs.  Schur diagonal tiles are full, not lower, so
// no triangle is masked.
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
// b through shared memory, then does one read-modify-write of the dst
// block.  wgmma/TMA tensor-core tiles are later work.

#include "common.cuh"

namespace {

constexpr int BK = 32;

template <int T, int BM, bool ROUND, bool SCALED>
__global__ void __launch_bounds__((BM / 4) * (BM / 4))
pipelined_gemm_scatter_kernel(float* __restrict__ pool,
                              const float* __restrict__ b_src,
                              const int64_t* __restrict__ seg_ptr,
                              const int64_t* __restrict__ seg_dst,
                              const int64_t* __restrict__ pair_a,
                              const int64_t* __restrict__ pair_b,
                              const float* __restrict__ d,
                              const int64_t* __restrict__ pair_k) {
  constexpr int BN = BM;
  constexpr int NT = (BM / 4) * (BN / 4);
  constexpr int NB = T / BM;
  constexpr int LD = BM * BK / NT;  // slice elements per thread
  constexpr int64_t TT = (int64_t)T * T;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int64_t seg = blockIdx.x;
  const int r0 = (blockIdx.y / NB) * BM;
  const int c0 = (blockIdx.y % NB) * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4);
  const int ty = tid / (BN / 4);

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  const int64_t p_end = seg_ptr[seg + 1];
  for (int64_t p = seg_ptr[seg]; p < p_end; ++p) {
    const float* a = pool + pair_a[p] * TT;
    const float* b = b_src + pair_b[p] * TT;
    const float* dk = SCALED ? d + pair_k[p] * T : nullptr;
    for (int k0 = 0; k0 < T; k0 += BK) {
      // LD loads of a and of b per thread, all issued before the first
      // store to shared memory (element e = tid + l NT of the slice)
      float av_ld[LD], bv_ld[LD];
#pragma unroll
      for (int l = 0; l < LD; ++l) {
        const int e = tid + l * NT;
        const int kk = k0 + e % BK;
        av_ld[l] = load_scaled<ROUND, SCALED>(
            a + (int64_t)(r0 + e / BK) * T + kk, SCALED ? __ldg(dk + kk) : 1.f);
        bv_ld[l] = load_op<ROUND>(b + (int64_t)(c0 + e / BK) * T + k0 +
                                  e % BK);
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
  float* dst = pool + seg_dst[seg] * TT;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      dst[(int64_t)(r0 + ty * 4 + u) * T + c0 + tx * 4 + v] -= acc[u][v];
}

template <int T, bool ROUND, bool SCALED>
cudaError_t launch(float* pool, const float* b_src, const int64_t* seg_ptr,
                   const int64_t* seg_dst, const int64_t* pair_a,
                   const int64_t* pair_b, const float* d,
                   const int64_t* pair_k, int64_t nseg, cudaStream_t stream) {
  constexpr int BM = T < 64 ? T : 64;
  constexpr int NB = T / BM;
  dim3 grid((unsigned)nseg, NB * NB);
  pipelined_gemm_scatter_kernel<T, BM, ROUND, SCALED>
      <<<grid, (BM / 4) * (BM / 4), 0, stream>>>(
          pool, b_src, seg_ptr, seg_dst, pair_a, pair_b, d, pair_k);
  return cudaGetLastError();
}

template <bool ROUND, bool SCALED>
cudaError_t dispatch_t(int T, float* pool, const float* b_src,
                       const int64_t* seg_ptr, const int64_t* seg_dst,
                       const int64_t* pair_a, const int64_t* pair_b,
                       const float* d, const int64_t* pair_k, int64_t nseg,
                       cudaStream_t s) {
  switch (T) {
    case 32:
      return launch<32, ROUND, SCALED>(pool, b_src, seg_ptr, seg_dst, pair_a,
                                       pair_b, d, pair_k, nseg, s);
    case 64:
      return launch<64, ROUND, SCALED>(pool, b_src, seg_ptr, seg_dst, pair_a,
                                       pair_b, d, pair_k, nseg, s);
    case 128:
      return launch<128, ROUND, SCALED>(pool, b_src, seg_ptr, seg_dst,
                                        pair_a, pair_b, d, pair_k, nseg, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 = 1: operands rounded to bf16 on load; bf16 = 0: fp32 operands.
// b_src: the pool b is read from (pool itself, or the other LU pool).
// d != NULL: a's columns scaled by d[pair_k * T + k].
extern "C" int pastix_pipelined_gemm_scatter(
    void* pool, const void* b_src, const void* seg_ptr, const void* seg_dst,
    const void* pair_a, const void* pair_b, const void* d,
    const void* pair_k, long long nseg, int T, int bf16, void* stream) {
  if (nseg <= 0) return 0;
  if (nseg > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (d != nullptr && pair_k == nullptr) return (int)cudaErrorInvalidValue;
  auto P = (float*)pool;
  auto bs = (const float*)b_src;
  auto sp = (const int64_t*)seg_ptr;
  auto sd = (const int64_t*)seg_dst;
  auto pa = (const int64_t*)pair_a;
  auto pb = (const int64_t*)pair_b;
  auto dd = (const float*)d;
  auto pk = (const int64_t*)pair_k;
  auto s = (cudaStream_t)stream;
  if (d != nullptr)
    return bf16 ? (int)dispatch_t<true, true>(T, P, bs, sp, sd, pa, pb, dd,
                                              pk, nseg, s)
                : (int)dispatch_t<false, true>(T, P, bs, sp, sd, pa, pb, dd,
                                               pk, nseg, s);
  return bf16 ? (int)dispatch_t<true, false>(T, P, bs, sp, sd, pa, pb, dd, pk,
                                             nseg, s)
              : (int)dispatch_t<false, false>(T, P, bs, sp, sd, pa, pb, dd,
                                              pk, nseg, s);
}
