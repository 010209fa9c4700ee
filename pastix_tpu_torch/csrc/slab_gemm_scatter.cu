// K6: panel-slab E2 update with row-bounded a operands:
// pool[dst][r0 : r0 + ha] -= op(a[r0 : r0 + ha]) . op(b)^T per pair.
//
// Replaces the Pallas kernel pastix_tpu/numeric/slab_kernels.py
// gemm_scatter_slab (_mk_slab_kernel), plain and scaled (d: LDL^T).
// Semantics: the schedule reads a and b from C-tile runs of one
// contiguous source panel and accumulates into H-tile dst windows; each
// pair's a tile is bounded to the rows [r0, r0 + ha) of its scalar row
// support (r0 a multiple of 8, ha in {T/4, T/2, 3T/4, T}), the rows
// outside being structural zeros of the panel, so only those rows of the
// dst change.  op rounds an fp32 tile to bf16 when the update dtype is
// bf16 and leaves it fp32 otherwise; the scaled variant multiplies a's
// column k by d[k_src * T + k] first and rounds once (the reference
// scales the fp32 a-slab); products accumulate in fp32.
//
// The host decodes the TPU schedule (offsets into the slabs and the
// window, r0, the height class, the double-buffer flags) into the dst
// tiles of each window, in window order, each with its pairs in plan
// order (a tile, b tile, source column, r0, ha).
//
// What bounds it on an H100 at T = 128: a pair is 2 ha T^2 FLOP against a
// b tile of 64 KB and ha rows of a, operands that repeat within a window
// and stay in the 50 MB L2, so it is bound by the 67 TFLOP/s of the fp32
// CUDA cores it multiplies on, and the row bounds cut that work.
//
// First design: one CTA per (dst tile, 32-row band).  An H-tile window
// of fp32 128 x 128 tiles (up to 4 MB) does not fit one SM's shared
// memory, so a window is split into its tiles and their bands; each band
// is read once and written once, and accumulates in registers (4 x 4 per
// thread) over all pairs of its tile.  The row bounds are what the band
// saves: a pair whose rows miss the band is skipped, and rows of a
// outside [r0, r0 + ha) load as zeros.  Each 32-deep k slice of a's band
// rows and of the whole b tile is staged in shared memory.  Within one
// launch (one chunk) a dst tile is one window's, so CTAs never share a
// dst: no atomics; a window cut by a chunk boundary is written by two
// launches, ordered on one stream.  Sources and dsts of one level are
// disjoint.  The products run on the fp32 CUDA cores.

#include "common.cuh"

namespace {

constexpr int BK = 32;
constexpr int BM = 32;  // rows per band

template <int T, bool ROUND, bool SCALED>
__global__ void __launch_bounds__((BM / 4) * (T / 4))
slab_gemm_scatter_kernel(float* __restrict__ pool,
                         const int64_t* __restrict__ seg_ptr,
                         const int64_t* __restrict__ seg_dst,
                         const int64_t* __restrict__ pair_a,
                         const int64_t* __restrict__ pair_b,
                         const float* __restrict__ d,
                         const int64_t* __restrict__ pair_k,
                         const int* __restrict__ pair_r0,
                         const int* __restrict__ pair_ha) {
  constexpr int NT = (BM / 4) * (T / 4);
  constexpr int LDA = BM * BK / NT;  // a slice elements per thread
  constexpr int LDB = T * BK / NT;   // b slice elements per thread
  constexpr int64_t TT = (int64_t)T * T;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][T + 1];

  const int64_t seg = blockIdx.x;
  const int R0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int tx = tid % (T / 4);
  const int ty = tid / (T / 4);

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  const int64_t p_end = seg_ptr[seg + 1];
  for (int64_t p = seg_ptr[seg]; p < p_end; ++p) {
    const int lo = pair_r0[p];
    const int hi = lo + pair_ha[p];
    if (hi <= R0 || lo >= R0 + BM) continue;  // uniform across the CTA
    const float* a = pool + pair_a[p] * TT;
    const float* b = pool + pair_b[p] * TT;
    const float* dk = SCALED ? d + pair_k[p] * T : nullptr;
    for (int k0 = 0; k0 < T; k0 += BK) {
      float av_ld[LDA], bv_ld[LDB];
#pragma unroll
      for (int l = 0; l < LDA; ++l) {
        const int e = tid + l * NT;
        const int r = R0 + e / BK;
        const int kk = k0 + e % BK;
        av_ld[l] = (r >= lo && r < hi)
                       ? load_scaled<ROUND, SCALED>(
                             a + (int64_t)r * T + kk,
                             SCALED ? __ldg(dk + kk) : 1.f)
                       : 0.f;
      }
#pragma unroll
      for (int l = 0; l < LDB; ++l) {
        const int e = tid + l * NT;
        bv_ld[l] = load_op<ROUND>(b + (int64_t)(e / BK) * T + k0 + e % BK);
      }
#pragma unroll
      for (int l = 0; l < LDA; ++l) {
        const int e = tid + l * NT;
        As[e % BK][e / BK] = av_ld[l];
      }
#pragma unroll
      for (int l = 0; l < LDB; ++l) {
        const int e = tid + l * NT;
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
      dst[(int64_t)(R0 + ty * 4 + u) * T + tx * 4 + v] -= acc[u][v];
}

template <int T, bool ROUND, bool SCALED>
cudaError_t launch(float* pool, const int64_t* seg_ptr,
                   const int64_t* seg_dst, const int64_t* pair_a,
                   const int64_t* pair_b, const float* d,
                   const int64_t* pair_k, const int* pair_r0,
                   const int* pair_ha, int64_t nseg, cudaStream_t stream) {
  dim3 grid((unsigned)nseg, T / BM);
  slab_gemm_scatter_kernel<T, ROUND, SCALED>
      <<<grid, (BM / 4) * (T / 4), 0, stream>>>(
          pool, seg_ptr, seg_dst, pair_a, pair_b, d, pair_k, pair_r0,
          pair_ha);
  return cudaGetLastError();
}

template <bool ROUND, bool SCALED>
cudaError_t dispatch_t(int T, float* pool, const int64_t* seg_ptr,
                       const int64_t* seg_dst, const int64_t* pair_a,
                       const int64_t* pair_b, const float* d,
                       const int64_t* pair_k, const int* pair_r0,
                       const int* pair_ha, int64_t nseg, cudaStream_t s) {
  switch (T) {
    case 32:
      return launch<32, ROUND, SCALED>(pool, seg_ptr, seg_dst, pair_a,
                                       pair_b, d, pair_k, pair_r0, pair_ha,
                                       nseg, s);
    case 64:
      return launch<64, ROUND, SCALED>(pool, seg_ptr, seg_dst, pair_a,
                                       pair_b, d, pair_k, pair_r0, pair_ha,
                                       nseg, s);
    case 128:
      return launch<128, ROUND, SCALED>(pool, seg_ptr, seg_dst, pair_a,
                                        pair_b, d, pair_k, pair_r0, pair_ha,
                                        nseg, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 = 1: operands rounded to bf16 on load; bf16 = 0: fp32 operands.
// seg_ptr: [nseg + 1] pair offsets of the dst tiles seg_dst: [nseg];
// pair_a, pair_b, pair_k: [n] int64; pair_r0, pair_ha: [n] int32.
// d != NULL: a's columns scaled by d[pair_k * T + k].
extern "C" int pastix_slab_gemm_scatter(void* pool, const void* seg_ptr,
                                        const void* seg_dst,
                                        const void* pair_a,
                                        const void* pair_b, const void* d,
                                        const void* pair_k,
                                        const void* pair_r0,
                                        const void* pair_ha, long long nseg,
                                        int T, int bf16, void* stream) {
  if (nseg <= 0) return 0;
  if (nseg > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto P = (float*)pool;
  auto sp = (const int64_t*)seg_ptr;
  auto sd = (const int64_t*)seg_dst;
  auto pa = (const int64_t*)pair_a;
  auto pb = (const int64_t*)pair_b;
  auto dd = (const float*)d;
  auto pk = (const int64_t*)pair_k;
  auto r0 = (const int*)pair_r0;
  auto ha = (const int*)pair_ha;
  auto s = (cudaStream_t)stream;
  if (d != nullptr)
    return bf16 ? (int)dispatch_t<true, true>(T, P, sp, sd, pa, pb, dd, pk,
                                              r0, ha, nseg, s)
                : (int)dispatch_t<false, true>(T, P, sp, sd, pa, pb, dd, pk,
                                               r0, ha, nseg, s);
  return bf16 ? (int)dispatch_t<true, false>(T, P, sp, sd, pa, pb, dd, pk,
                                             r0, ha, nseg, s)
              : (int)dispatch_t<false, false>(T, P, sp, sd, pa, pb, dd, pk, r0,
                                              ha, nseg, s);
}
