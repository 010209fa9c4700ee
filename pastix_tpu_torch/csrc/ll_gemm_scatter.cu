// K1: left-looking E2 update, pool[dst] -= sum over a segment of a . b^T.
//
// Replaces the Pallas kernel pastix_tpu/numeric/leftlook.py
// gemm_scatter_ll (_mk_ll_kernel).  Semantics: for every dst segment of a
// chunk (pairs sorted by dst on the host), subtract the sum of its pairs'
// a . b^T, computed from operands cast to the update dtype and
// accumulated in fp32.  Row-bounded chunks (H < T) touch only rows
// [rl, rl + H) of the dst tile for each pair.  Two variants: scaled
// (LDL^T), where a's column k is multiplied by the pivot
// d[gk * T + k] of the pair's source column before the rounding; and
// cross-pool (LU), where b comes from the other pool: b_src is already a
// separate operand, so the wrapper passes that pool (or a bf16 cache
// gathered from it) and a is read from the destination pool.
//
// What bounds it on an H100 at T = 128: each full-height pair is
// 2 T^3 = 4.2 MFLOP against 64 KB (fp32) + 32 KB (bf16) of operand tiles,
// about 44 FLOP per byte; operands repeat within a segment and stay in the
// 50 MB L2, so this first design, which multiplies on the fp32 CUDA
// cores, is bound by their 67 TFLOP/s, far below the 989 TFLOP/s of the
// bf16 tensor cores.
//
// First design: one CTA per (segment, 64 x 64 output block).  Within a
// chunk each dst tile lies in exactly one segment, so CTAs never share a
// dst and need no atomics; chunks run in order on one stream because a
// dst may recur in a later chunk.  The CTA keeps its 64 x 64 block in
// registers (4 x 4 per thread) over all pairs of the segment, staging
// 32-deep k slices of a and b through shared memory, then does one
// read-modify-write of the dst block.  A pair whose row window misses the
// block is skipped.  wgmma/TMA tensor-core tiles are later work.

#include "common.cuh"

namespace {

constexpr int BK = 32;

template <int T, int BM, typename TA, typename TB, bool ROUND, bool SCALED>
__global__ void __launch_bounds__((BM / 4) * (BM / 4))
ll_gemm_scatter_kernel(float* __restrict__ pool,
                       const TA* __restrict__ a_src,
                       const TB* __restrict__ b_src,
                       const int64_t* __restrict__ seg_ptr,
                       const int64_t* __restrict__ seg_dst,
                       const int64_t* __restrict__ pair_a,
                       const int64_t* __restrict__ pair_b,
                       const int64_t* __restrict__ pair_rl,
                       const float* __restrict__ d,
                       const int64_t* __restrict__ pair_k, int H) {
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
    const int rl = (int)pair_rl[p];
    const int lo = max(rl, r0);
    const int hi = min(rl + H, r0 + BM);
    if (lo >= hi) continue;  // uniform over the CTA
    const TA* a = a_src + pair_a[p] * TT;
    const TB* b = b_src + pair_b[p] * TT;
    const float* dk = SCALED ? d + pair_k[p] * T : nullptr;
    for (int k0 = 0; k0 < T; k0 += BK) {
      // LD loads of a and of b per thread, all issued before the first
      // store to shared memory (element e = tid + l NT of the slice)
      float av_ld[LD], bv_ld[LD];
#pragma unroll
      for (int l = 0; l < LD; ++l) {
        const int e = tid + l * NT;
        const int r = r0 + e / BK;
        const int kk = k0 + e % BK;
        if constexpr (SCALED)
          av_ld[l] = (r >= lo && r < hi)
                         ? load_scaled<ROUND, true>(a + (int64_t)r * T + kk,
                                                    __ldg(dk + kk))
                         : 0.f;
        else
          av_ld[l] = (r >= lo && r < hi)
                         ? load_op<ROUND>(a + (int64_t)r * T + kk)
                         : 0.f;
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

template <int T, typename TA, typename TB, bool ROUND, bool SCALED>
cudaError_t launch(float* pool, const void* a_src, const void* b_src,
                   const int64_t* seg_ptr, const int64_t* seg_dst,
                   const int64_t* pair_a, const int64_t* pair_b,
                   const int64_t* pair_rl, const float* d,
                   const int64_t* pair_k, int64_t nseg, int H,
                   cudaStream_t stream) {
  constexpr int BM = T < 64 ? T : 64;
  constexpr int NB = T / BM;
  dim3 grid((unsigned)nseg, NB * NB);
  ll_gemm_scatter_kernel<T, BM, TA, TB, ROUND, SCALED>
      <<<grid, (BM / 4) * (BM / 4), 0, stream>>>(
          pool, (const TA*)a_src, (const TB*)b_src, seg_ptr, seg_dst,
          pair_a, pair_b, pair_rl, d, pair_k, H);
  return cudaGetLastError();
}

template <typename TA, typename TB, bool ROUND, bool SCALED>
cudaError_t dispatch_t(int T, float* pool, const void* a_src,
                       const void* b_src, const int64_t* seg_ptr,
                       const int64_t* seg_dst, const int64_t* pair_a,
                       const int64_t* pair_b, const int64_t* pair_rl,
                       const float* d, const int64_t* pair_k, int64_t nseg,
                       int H, cudaStream_t s) {
  switch (T) {
    case 32:
      return launch<32, TA, TB, ROUND, SCALED>(pool, a_src, b_src, seg_ptr,
                                               seg_dst, pair_a, pair_b,
                                               pair_rl, d, pair_k, nseg, H,
                                               s);
    case 64:
      return launch<64, TA, TB, ROUND, SCALED>(pool, a_src, b_src, seg_ptr,
                                               seg_dst, pair_a, pair_b,
                                               pair_rl, d, pair_k, nseg, H,
                                               s);
    case 128:
      return launch<128, TA, TB, ROUND, SCALED>(pool, a_src, b_src, seg_ptr,
                                                seg_dst, pair_a, pair_b,
                                                pair_rl, d, pair_k, nseg, H,
                                                s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// variant 0: fp32 update dtype, a and b fp32
// variant 1: bf16 update dtype, a from the fp32 pool (rounded), b bf16
// variant 2: bf16 update dtype, a and b bf16
// d != NULL (variants 0 and 1): a's columns scaled by d[pair_k * T + k]
extern "C" int pastix_ll_gemm_scatter(
    void* pool, const void* a_src, const void* b_src, const void* seg_ptr,
    const void* seg_dst, const void* pair_a, const void* pair_b,
    const void* pair_rl, const void* d, const void* pair_k, long long nseg,
    int T, int H, int variant, void* stream) {
  if (nseg <= 0) return 0;
  if (H <= 0 || H > T) return (int)cudaErrorInvalidValue;
  if (d != nullptr && (variant == 2 || pair_k == nullptr))
    return (int)cudaErrorInvalidValue;
  auto sp = (const int64_t*)seg_ptr;
  auto sd = (const int64_t*)seg_dst;
  auto pa = (const int64_t*)pair_a;
  auto pb = (const int64_t*)pair_b;
  auto pr = (const int64_t*)pair_rl;
  auto dd = (const float*)d;
  auto pk = (const int64_t*)pair_k;
  auto s = (cudaStream_t)stream;
  float* P = (float*)pool;
  const bool sc = d != nullptr;
  switch (variant) {
    case 0:
      return sc ? (int)dispatch_t<float, float, false, true>(
                      T, P, a_src, b_src, sp, sd, pa, pb, pr, dd, pk, nseg,
                      H, s)
                : (int)dispatch_t<float, float, false, false>(
                      T, P, a_src, b_src, sp, sd, pa, pb, pr, dd, pk, nseg,
                      H, s);
    case 1:
      return sc ? (int)dispatch_t<float, __nv_bfloat16, true, true>(
                      T, P, a_src, b_src, sp, sd, pa, pb, pr, dd, pk, nseg,
                      H, s)
                : (int)dispatch_t<float, __nv_bfloat16, true, false>(
                      T, P, a_src, b_src, sp, sd, pa, pb, pr, dd, pk, nseg,
                      H, s);
    case 2:
      return (int)dispatch_t<__nv_bfloat16, __nv_bfloat16, true, false>(
          T, P, a_src, b_src, sp, sd, pa, pb, pr, dd, pk, nseg, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
