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
// What bounds it on an H100: a full-height pair at T = 128 is 2 T^3 = 4.2
// MFLOP against 64 KB (fp32) + 32 KB (bf16) of operand tiles, about 44
// FLOP per byte, far below the 295 FLOP per byte at which the bf16
// tensor cores (989 TFLOP/s) would outrun device memory (3.35 TB/s).  So
// with bf16 updates the kernel is bound by the bytes of its operands and
// by how many of them are in flight, not by its products.  The first
// design multiplied on the fp32 CUDA cores (67 TFLOP/s, 4 x 4 a thread)
// and loaded each 32-deep k slice synchronously: it ran at 5.4 TFLOP/s,
// 10.9x above its byte bound.
//
// The design for bf16 updates (variants 1 and 2): the tensor-core body of
// seg_mma.cuh (shared with K3), with row windows.
// - mma.sync m16n8k16 bf16 products with fp32 accumulators in registers.
//   At the main path's busiest level the products need about 0.011 ms
//   on the tensor cores against a 0.18 ms byte bound, so wgmma's higher
//   rate would buy nothing measurable here.
// - One CTA per piece of a dst segment and dst tile, or per piece and
//   128 x 64 half at T = 128 when the wrapper finds fewer pieces than
//   SMs; the dense tail's top tiles have 5-10x the mean segment, so long
//   segments are cut into pieces (numeric/leftlook.ll_pieces) whose sums
//   the last piece adds in piece order: runs repeat bit for bit.
// - A 3-stage cp.async ring of 32-deep slices.  A T = 128 stage is 20 KB
//   (variant 2) or 30 KB (variant 1), so a CTA keeps 40-60 KB in flight,
//   two CTAs an SM.  (A fourth stage in unpadded, permuted rows measured
//   22-26 % slower on an H100: PERF.md §6.)
// - a in fp32 (variant 1, from the pool) is copied as stored and rounded
//   to bf16 as its fragment is loaded, after its columns are scaled by d
//   (LDL^T): exactly where the twin rounds it.  b, and a in variant 2,
//   come from the wrapper's per-chunk bf16 cache through ldmatrix.
// - The row window: rows of a outside [rl, rl + H) enter as zeros, and a
//   warp issues no mma for a 16-row group wholly outside it.  Any rl and
//   any H in 1..T work.
//
// fp32 updates (variant 0: update_dtype None, the shift-invert LDL^T
// path) keep the first design's FMA body below, unchanged: the port's
// fp32 is full fp32, with TF32 off, so it has no tensor-core route here.

#include "seg_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// variant 0: fp32 operands on the CUDA cores (the first design)

template <int T, int BM, bool SCALED>
__global__ void __launch_bounds__((BM / 4) * (BM / 4))
ll_fp32_kernel(const Chunk x) {
  const float* __restrict__ a_src = (const float*)x.a_src;
  const float* __restrict__ b_src = (const float*)x.b_src;
  const int64_t* __restrict__ seg_ptr = x.seg_ptr;
  const int64_t* __restrict__ pair_rl = x.pair_rl;
  const int H = x.H;
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
    const float* a = a_src + x.pair_a[p] * TT;
    const float* b = b_src + x.pair_b[p] * TT;
    const float* dk = SCALED ? x.d + x.pair_k[p] * T : nullptr;
    for (int k0 = 0; k0 < T; k0 += BK) {
      // LD loads of a and of b per thread, all issued before the first
      // store to shared memory (element e = tid + l NT of the slice)
      float av_ld[LD], bv_ld[LD];
#pragma unroll
      for (int l = 0; l < LD; ++l) {
        const int e = tid + l * NT;
        const int r = r0 + e / BK;
        const int kk = k0 + e % BK;
        av_ld[l] = (r >= lo && r < hi)
                       ? load_scaled<false, SCALED>(
                             a + (int64_t)r * T + kk,
                             SCALED ? __ldg(dk + kk) : 1.f)
                       : 0.f;
        bv_ld[l] = load_op<false>(b + (int64_t)(c0 + e / BK) * T + k0 +
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
  float* dst = x.pool + x.seg_dst[seg] * TT;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      dst[(int64_t)(r0 + ty * 4 + u) * T + c0 + tx * 4 + v] -= acc[u][v];
}

template <int T, bool SCALED>
cudaError_t launch_fp32(const Chunk& x, cudaStream_t stream) {
  constexpr int BM = T < 64 ? T : 64;
  constexpr int NB = T / BM;
  dim3 grid((unsigned)x.nseg, NB * NB);
  ll_fp32_kernel<T, BM, SCALED><<<grid, (BM / 4) * (BM / 4), 0, stream>>>(x);
  return cudaGetLastError();
}

template <bool SCALED>
cudaError_t dispatch_fp32(const Chunk& x, int T, cudaStream_t s) {
  switch (T) {
    case 32: return launch_fp32<32, SCALED>(x, s);
    case 64: return launch_fp32<64, SCALED>(x, s);
    case 128: return launch_fp32<128, SCALED>(x, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// variant 0: fp32 update dtype, a and b fp32 (CUDA cores, a CTA per
//            segment and 64 x 64 block)
// variant 1: bf16 update dtype, a from the fp32 pool (rounded), b bf16
// variant 2: bf16 update dtype, a and b bf16
// d != NULL (variants 0 and 1): a's columns scaled by d[pair_k * T + k]
// variants 1 and 2 run a CTA per piece and bn dst columns (T, or 64 at
// T = 128); pieces: the four piece tables, scratch and count as in Chunk
extern "C" int pastix_ll_gemm_scatter(
    void* pool, const void* a_src, const void* b_src, const void* seg_ptr,
    const void* seg_dst, const void* pair_a, const void* pair_b,
    const void* pair_rl, const void* d, const void* pair_k,
    const void* piece_ptr, const void* piece_seg, const void* seg_piece_ptr,
    const void* piece_slot, void* scratch, void* count, long long nseg,
    long long npiece, int T, int H, int variant, int bn, void* stream) {
  if (nseg <= 0) return 0;
  if (H <= 0 || H > T) return (int)cudaErrorInvalidValue;
  if (d != nullptr && (variant == 2 || pair_k == nullptr))
    return (int)cudaErrorInvalidValue;
  if (variant != 0 && (npiece < nseg || piece_ptr == nullptr))
    return (int)cudaErrorInvalidValue;
  auto I = [](const void* p) { return (const int64_t*)p; };
  const Chunk x{(float*)pool, a_src, b_src, I(seg_ptr), I(seg_dst),
                I(pair_a), I(pair_b), I(pair_rl), I(pair_k),
                (const float*)d, I(piece_ptr), I(piece_seg),
                I(seg_piece_ptr), I(piece_slot), (float*)scratch,
                (int*)count, nseg, npiece, H};
  auto s = (cudaStream_t)stream;
  const bool sc = d != nullptr;
  switch (variant) {
    case 0:
      return (int)(sc ? dispatch_fp32<true>(x, T, s)
                      : dispatch_fp32<false>(x, T, s));
    case 1:
      return (int)(sc ? dispatch_mma<true, false, true, true>(x, T, bn, s)
                      : dispatch_mma<true, false, false, true>(x, T, bn, s));
    case 2:
      return (int)dispatch_mma<false, false, false, true>(x, T, bn, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
