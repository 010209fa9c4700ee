// K3: right-looking E2 update, pool[dst] -= sum over a segment of a . b^T.
//
// Replaces the Pallas kernel pastix_tpu/numeric/pallas_kernels.py
// gemm_scatter_pipelined (_mk_pipelined_kernel): the plain, the scaled
// (d: LDL^T) and the cross-pool (src_pool: LU) variants, and the operand
// arrays of its compact forms (xab: the panel TRSM's bf16 stream;
// compact: per-chunk gathers of the distinct operand tiles; ab_pack:
// stacked (a, b) pairs).  numeric/cache.py also launches it for K11
// (exp_cache.py's gemm_scatter_vcache): a and b read by slot from one
// bf16 array, the chunk's operand cache; numeric/fused.py for K9
// (gemm_scatter_fused: a and b from the pools, one chunk of sort_triples
// output) and K10 (gemm_scatter_blockspec): a and b read from the
// chunk's compact gathers, b in bf16, a in bf16 too unless it is scaled
// (then fp32: its twin rounds round(a d)), with bf16 updates; both fp32
// with fp32 updates; and numeric/block.py for K5.
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
// round(round(a) d) from a bf16 array.  Schur diagonal tiles are full,
// not lower, so no triangle is masked.
//
// What bounds it on an H100: a pair at T = 128 is 2 T^3 = 4.2 MFLOP
// against two operand tiles, 64 KB in bf16 (64 FLOP per byte) or 128 KB
// in fp32 (32), far below the 295 FLOP per byte at which the bf16 tensor
// cores (989 TFLOP/s) would outrun device memory (3.35 TB/s).  Operands
// repeat within a level and mostly come from the 50 MB L2, so what has
// to fall is the bytes in flight and each pair's latency.  The first
// design multiplied bf16 updates on the fp32 CUDA cores (4 x 4 a
// thread), loaded each 32-deep k slice synchronously (2 bytes a load
// from bf16 arrays) and waited on two barriers a slice with no load in
// flight: about 22 TFLOP/s on a 38,008-pair level, 11-20x above its
// bound, and a long segment held its whole chunk.
//
// The design for bf16 updates: the tensor-core body of K1 (seg_mma.cuh,
// without row windows): mma.sync m16n8k16 with fp32 accumulators in
// registers over all pairs of a piece, a 3-stage ring of 32-deep slices
// filled by 16-byte cp.async copies with the next pair's indices fetched
// one pair ahead, and dst segments cut into pieces on the host
// (numeric/pipelined.pipeline_plan, by leftlook.ll_pieces) whose partial
// sums the last piece adds in piece order, so runs repeat bit for bit.
// Operands as mma_tile.cuh takes them: bf16 arrays through ldmatrix
// (a bf16 a scaled by d widened, scaled and rounded again); fp32 tiles
// (the pools, or fp32 arrays) copied as stored and rounded as their
// fragments load.  At T = 128 the wrapper gives a CTA 128 x 64 halves of
// the dst when both operands are fp32 (a 40 KB stage would leave one CTA
// an SM) or when the chunk has fewer pieces than SMs.
//
// fp32 updates (update_dtype None: the shift-invert LDL^T Schur residue)
// keep the first design's FMA body unchanged: one CTA per (segment,
// 64 x 64 block of the dst tile) holding its block in registers over the
// segment (segment_gemm.cuh; K5's, K9's and K10's fp32 updates run
// here).  The port's fp32 is full fp32, with TF32 off, so it has no
// tensor-core route.

#include "seg_mma.cuh"
#include "segment_gemm.cuh"

namespace {

template <int T, typename OP, bool SCALED>
__global__ void __launch_bounds__(seg::Shape<T>::NT)
pipelined_fp32_kernel(float* __restrict__ pool, const OP* __restrict__ a_src,
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
    seg::pair_product<T, OP, SCALED>(
        acc, a_src + pair_a[p] * TT, b_src + pair_b[p] * TT,
        SCALED ? d + pair_k[p] * T : nullptr, r0, c0, As, Bs);
  seg::subtract_block<T>(pool + seg_dst[sg] * TT, acc, r0, c0);
}

template <int T, typename OP, bool SCALED>
cudaError_t launch_fp32(const Chunk& x, cudaStream_t stream) {
  constexpr int NB = seg::Shape<T>::NB;
  dim3 grid((unsigned)x.nseg, NB * NB);
  pipelined_fp32_kernel<T, OP, SCALED>
      <<<grid, seg::Shape<T>::NT, 0, stream>>>(
          x.pool, (const OP*)x.a_src, (const OP*)x.b_src, x.seg_ptr,
          x.seg_dst, x.pair_a, x.pair_b, x.d, x.pair_k);
  return cudaGetLastError();
}

template <typename OP, bool SCALED>
cudaError_t dispatch_fp32(const Chunk& x, int T, cudaStream_t s) {
  switch (T) {
    case 32: return launch_fp32<32, OP, SCALED>(x, s);
    case 64: return launch_fp32<64, OP, SCALED>(x, s);
    case 128: return launch_fp32<128, OP, SCALED>(x, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 = 1: bf16 update dtype, the tensor-core body over the pieces (the
// four piece tables, scratch and count as in seg_mma.cuh's Chunk), bn dst
// columns a CTA (T, or 64 at T = 128); bf16 = 0: fp32 updates on the CUDA
// cores, a CTA per segment and 64 x 64 block (the piece arguments unused).
// a_src, b_src: the tiles a and b are read from, (n, T, T) arrays of
// fp32 (a_bf16, b_bf16 = 0: the pools, or fp32 operand arrays) or of
// bf16 (1: operand arrays rounded when they were made); both of one
// dtype, or (K10, scaled bf16 updates) a fp32 and b bf16.
// d != NULL: a's columns scaled by d[pair_k * T + k].
extern "C" int pastix_pipelined_gemm_scatter(
    void* pool, const void* a_src, const void* b_src, const void* seg_ptr,
    const void* seg_dst, const void* pair_a, const void* pair_b,
    const void* d, const void* pair_k, const void* piece_ptr,
    const void* piece_seg, const void* seg_piece_ptr, const void* piece_slot,
    void* scratch, void* count, long long nseg, long long npiece, int T,
    int bf16, int a_bf16, int b_bf16, int bn, void* stream) {
  if (nseg <= 0) return 0;
  if (nseg > 0x7fffffffLL || npiece > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (d != nullptr && pair_k == nullptr) return (int)cudaErrorInvalidValue;
  if (bf16 && (npiece < nseg || piece_ptr == nullptr || count == nullptr))
    return (int)cudaErrorInvalidValue;
  auto I = [](const void* p) { return (const int64_t*)p; };
  const Chunk x{(float*)pool, a_src, b_src, I(seg_ptr), I(seg_dst),
                I(pair_a), I(pair_b), nullptr, I(pair_k),
                (const float*)d, I(piece_ptr), I(piece_seg),
                I(seg_piece_ptr), I(piece_slot), (float*)scratch,
                (int*)count, nseg, npiece, T};
  auto s = (cudaStream_t)stream;
  const bool sc = d != nullptr;
  if (a_bf16 != b_bf16) {  // only K10's scaled fp32 a with bf16 b
    if (!bf16 || !sc || a_bf16) return (int)cudaErrorInvalidValue;
    return (int)dispatch_mma<true, false, true, false>(x, T, bn, s);
  }
  if (!bf16) {
    if (a_bf16)
      return (int)(sc ? dispatch_fp32<__nv_bfloat16, true>(x, T, s)
                      : dispatch_fp32<__nv_bfloat16, false>(x, T, s));
    return (int)(sc ? dispatch_fp32<float, true>(x, T, s)
                    : dispatch_fp32<float, false>(x, T, s));
  }
  if (a_bf16)
    return (int)(sc ? dispatch_mma<false, false, true, false>(x, T, bn, s)
                    : dispatch_mma<false, false, false, false>(x, T, bn, s));
  return (int)(sc ? dispatch_mma<true, true, true, false>(x, T, bn, s)
                  : dispatch_mma<true, true, false, false>(x, T, bn, s));
}
