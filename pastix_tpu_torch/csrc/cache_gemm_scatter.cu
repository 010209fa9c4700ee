// K12: right-looking E2 update from a chunk-resident operand cache in
// steps of G pairs, pool[dst] -= sum over a dst segment of a . b^T, a and
// b bf16 tiles of the cache, products accumulated in fp32.
//
// Replaces the Pallas kernel of the reference's measurement script
// exp_mp.py, gemm_scatter_mp (mk_mp_kernel): per chunk, the chunk's
// distinct tiles of the bf16 panel stream are gathered into one compact
// array Xc that the TPU kernel copies into VMEM with one DMA, plus a
// zeroed slot; each dst segment is padded to a multiple of G with null
// pairs that read that slot; per TPU grid step the G products of one
// segment are summed (variant loop: G T-deep dots added; dot2: one
// (T, G.T) x (G.T, T) contraction), then subtracted from the
// accumulator, which holds the dst tile from the segment's first step to
// its last.  The host fills the cache buffer per chunk (buf[:nu] =
// xab[cu], the rest zero), as the reference gathers Xc in XLA outside
// its kernel, then launches once per chunk.
//
// K11, exp_cache.py's gemm_scatter_vcache (mk_kernel), reads the same
// kind of cache with one pair a step: numeric/cache.py launches K3
// (pipelined_gemm_scatter.cu) on the filled buffer for it, a and b both
// read from the buffer by slot, so this file holds K12 only.
//
// Where the data sits on Hopper: the reference keeps the chunk's Xc in
// VMEM.  One SM has 227 KB of shared memory, and the cache is CT x 32 KB
// at T = 128 (megabytes), so the card's analog of VMEM is the 50 MB L2:
// the buffer is written just before the launch and the chunk's CTAs read
// it while it is resident there (chip_smoke.py logs CT and the buffer's
// MiB against 50 MB).  An L2 persistence window (cudaAccessPolicyWindow)
// over the buffer is later work.
//
// What bounds it on an H100 at T = 128: a pair is 2 T^3 = 4.2 MFLOP on
// two 32 KB bf16 tiles that repeat across the chunk's pairs; counted as
// the level's work (each distinct stream tile read once, each dst tile
// read and written once) it is bound by bytes, as K3 on the stream.  This
// first design multiplies on the fp32 CUDA cores (segment_gemm.cuh's
// per-pair product, shared with K3, K9 and K10, so the tensor-core
// rewrite of that header covers K12 too).
//
// Design: one CTA per (dst segment, 64 x 64 block of the dst tile), as
// K3.  A chunk's segments have distinct dst tiles and read only the
// cache, so CTAs need no atomics.  A segment cut by a chunk boundary
// writes its dst in two launches, ordered on one stream.  The CTA loads
// its dst block into registers at the segment's first step, sums each
// step's G products into a step tile and subtracts that from the block,
// then writes it once: the reference's order.  loop and dot2 differ only
// in summation order: loop sums each pair into its own tile and adds the
// G tiles, dot2 runs one G.T-deep sum.  Null pairs (slot zslot, the zero
// slot) are skipped: their product is zero.

#include "segment_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void zero(float (&t)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) t[u][v] = 0.f;
}

// the thread's 4 x 4 elements of dst[r0:r0+BM, c0:c0+BM], read or written
template <int T, bool STORE>
__device__ __forceinline__ void block_io(float* dst, float (&t)[4][4],
                                         int r0, int c0) {
  constexpr int BM = seg::Shape<T>::BM;
  const int tx = threadIdx.x % (BM / 4);
  const int ty = threadIdx.x / (BM / 4);
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      float* p = dst + (int64_t)(r0 + ty * 4 + u) * T + c0 + tx * 4 + v;
      if (STORE)
        *p = t[u][v];
      else
        t[u][v] = *p;
    }
}

template <int T, bool DOT2>
__global__ void __launch_bounds__(seg::Shape<T>::NT)
mp_kernel(float* __restrict__ pool, const bf16* __restrict__ buf,
          const int64_t* __restrict__ seg_ptr,
          const int64_t* __restrict__ seg_dst,
          const int64_t* __restrict__ pos_a,
          const int64_t* __restrict__ pos_b, int G, int64_t zslot) {
  constexpr int BM = seg::Shape<T>::BM;
  constexpr int NB = seg::Shape<T>::NB;
  constexpr int64_t TT = (int64_t)T * T;
  __shared__ float As[seg::BK][BM + 1];
  __shared__ float Bs[seg::BK][BM + 1];
  const int64_t sg = blockIdx.x;
  const int r0 = (blockIdx.y / NB) * BM;
  const int c0 = (blockIdx.y % NB) * BM;
  float* dst = pool + seg_dst[sg] * TT;
  float acc[4][4], step[4][4];
  block_io<T, false>(dst, acc, r0, c0);
  for (int64_t s = seg_ptr[sg]; s < seg_ptr[sg + 1]; ++s) {
    zero(step);
    for (int u = 0; u < G; ++u) {
      const int64_t pa = pos_a[s * G + u], pb = pos_b[s * G + u];
      if (pa == zslot || pb == zslot) continue;  // a null pair: zero
      if (DOT2) {
        seg::pair_product<T, bf16, false, false>(step, buf + pa * TT,
                                                 buf + pb * TT, nullptr, r0,
                                                 c0, As, Bs);
      } else {
        float one[4][4];
        zero(one);
        seg::pair_product<T, bf16, false, false>(one, buf + pa * TT,
                                                 buf + pb * TT, nullptr, r0,
                                                 c0, As, Bs);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) step[i][j] += one[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] -= step[i][j];
  }
  block_io<T, true>(dst, acc, r0, c0);
}

template <int T>
cudaError_t launch_mp(float* pool, const bf16* buf, const int64_t* sp,
                      const int64_t* sd, const int64_t* pa,
                      const int64_t* pb, int64_t nseg, int G, int64_t zslot,
                      int dot2, cudaStream_t s) {
  constexpr int NB = seg::Shape<T>::NB;
  const dim3 grid((unsigned)nseg, NB * NB);
  if (dot2)
    mp_kernel<T, true><<<grid, seg::Shape<T>::NT, 0, s>>>(pool, buf, sp, sd,
                                                          pa, pb, G, zslot);
  else
    mp_kernel<T, false><<<grid, seg::Shape<T>::NT, 0, s>>>(pool, buf, sp, sd,
                                                           pa, pb, G, zslot);
  return cudaGetLastError();
}

}  // namespace

// K12.  seg_ptr: step offsets of the nseg dst segments; pos_a, pos_b: G
// cache slots a step, zslot (the zero slot) for a null pair; dot2 = 1:
// one G.T-deep sum a step, 0: G T-deep sums added (loop).
extern "C" int pastix_mp_gemm_scatter(void* pool, const void* buf,
                                      const void* seg_ptr,
                                      const void* seg_dst, const void* pos_a,
                                      const void* pos_b, long long nseg,
                                      int G, long long zslot, int T,
                                      int dot2, void* stream) {
  if (nseg <= 0) return 0;
  if (nseg > 0x7fffffffLL || G < 1) return (int)cudaErrorInvalidValue;
  auto P = (float*)pool;
  auto B = (const bf16*)buf;
  auto sp = (const int64_t*)seg_ptr;
  auto sd = (const int64_t*)seg_dst;
  auto pa = (const int64_t*)pos_a;
  auto pb = (const int64_t*)pos_b;
  auto s = (cudaStream_t)stream;
  switch (T) {
    case 32:
      return (int)launch_mp<32>(P, B, sp, sd, pa, pb, nseg, G, zslot, dot2,
                                s);
    case 64:
      return (int)launch_mp<64>(P, B, sp, sd, pa, pb, nseg, G, zslot, dot2,
                                s);
    case 128:
      return (int)launch_mp<128>(P, B, sp, sd, pa, pb, nseg, G, zslot, dot2,
                                 s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
