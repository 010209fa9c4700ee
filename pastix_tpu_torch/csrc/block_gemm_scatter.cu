// K5: dst-block E2 update, pool[dst] -= op(a) . op(b)^T for every cross
// product of a dst-block schedule.
//
// Replaces the Pallas kernel pastix_tpu/numeric/block_kernels.py
// gemm_scatter_block (_mk_block_kernel), plain and scaled (d: LDL^T).
// Semantics: a dst block is the stored tiles of an 8 x 4 rectangle of
// the tile grid; an entry (one source panel K) multiplies its a-slab
// (the tiles (I, K) of the block's rows) by its b-slab (the tiles (J, K)
// of its columns) and subtracts each cross product that the schedule
// maps to a stored tile (I, J) from it.  op rounds an fp32 tile to bf16
// when the update dtype is bf16 and leaves it fp32 otherwise; the scaled
// variant multiplies a's column k by d[K * T + k] first and rounds once
// (the reference scales the fp32 a-slab); products accumulate in fp32.
//
// The host decodes the TPU schedule (flags, size classes, DMA and
// scatter segments) into rows: one tile row I of one dst block, with its
// up to four dst tiles (I, J_0..3), and per entry that reaches the row
// the a tile (I, K), K, and the b tile (J_j, K) of each block column or
// -1.  Every cross product of the row shares its a tile.
//
// What bounds it on an H100 at T = 128: a cross product is 2 T^3 = 4.2
// MFLOP against two 64 KB fp32 operand tiles that repeat across the
// block's products and stay in the 50 MB L2, so this first design, which
// multiplies on the fp32 CUDA cores, is bound by their 67 TFLOP/s, not by
// memory.
//
// First design: one CTA per (row, 64 x 64 block of the tile).  The CTA
// keeps that block of all four dst tiles of its row in registers (4 x
// 4 x 4 per thread) over all entries of the row: each 32-deep k slice of
// a is staged once in shared memory and multiplied against the slices of
// the present b tiles, so an a tile is read once per entry for up to four
// products.  Then one read-modify-write of each present dst block.
// Blocks are disjoint and a row's dst tiles are its own, so CTAs never
// share a dst: no atomics.  A block cut by a chunk boundary is written by
// two launches, which stay ordered on one stream.  Sources and dsts of
// one level are disjoint, so no CTA reads a tile another CTA writes.  The
// products run on the fp32 CUDA cores; tensor-core tiles are later work.

#include "common.cuh"

namespace {

constexpr int BK = 32;
constexpr int BJ = 4;  // dst tiles per block row (B_J)

template <int T, int BM, bool ROUND, bool SCALED>
__global__ void __launch_bounds__((BM / 4) * (BM / 4))
block_gemm_scatter_kernel(float* __restrict__ pool,
                          const int64_t* __restrict__ row_dst,
                          const int64_t* __restrict__ ent_ptr,
                          const int64_t* __restrict__ ent_a,
                          const int64_t* __restrict__ ent_b,
                          const float* __restrict__ d,
                          const int64_t* __restrict__ ent_k) {
  constexpr int BN = BM;
  constexpr int NT = (BM / 4) * (BN / 4);
  constexpr int NB = T / BM;
  constexpr int LD = BM * BK / NT;  // slice elements per thread
  constexpr int64_t TT = (int64_t)T * T;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BJ][BK][BN + 1];

  const int64_t row = blockIdx.x;
  const int r0 = (blockIdx.y / NB) * BM;
  const int c0 = (blockIdx.y % NB) * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4);
  const int ty = tid / (BN / 4);

  float acc[BJ][4][4];
#pragma unroll
  for (int j = 0; j < BJ; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[j][u][v] = 0.f;

  const int64_t e_end = ent_ptr[row + 1];
  for (int64_t e = ent_ptr[row]; e < e_end; ++e) {
    const float* a = pool + ent_a[e] * TT;
    const float* dk = SCALED ? d + ent_k[e] * T : nullptr;
    const float* b[BJ];
    bool has[BJ];
#pragma unroll
    for (int j = 0; j < BJ; ++j) {
      const int64_t bj = ent_b[e * BJ + j];
      has[j] = bj >= 0;
      b[j] = pool + (has[j] ? bj : 0) * TT;
    }
    for (int k0 = 0; k0 < T; k0 += BK) {
      // all loads of the slice issued before the first store
      float av_ld[LD], bv_ld[BJ][LD];
#pragma unroll
      for (int l = 0; l < LD; ++l) {
        const int e2 = tid + l * NT;
        const int kk = k0 + e2 % BK;
        av_ld[l] = load_scaled<ROUND, SCALED>(
            a + (int64_t)(r0 + e2 / BK) * T + kk,
            SCALED ? __ldg(dk + kk) : 1.f);
#pragma unroll
        for (int j = 0; j < BJ; ++j)
          bv_ld[j][l] = has[j] ? load_op<ROUND>(
                                     b[j] + (int64_t)(c0 + e2 / BK) * T + kk)
                               : 0.f;
      }
#pragma unroll
      for (int l = 0; l < LD; ++l) {
        const int e2 = tid + l * NT;
        As[e2 % BK][e2 / BK] = av_ld[l];
#pragma unroll
        for (int j = 0; j < BJ; ++j) Bs[j][e2 % BK][e2 / BK] = bv_ld[j][l];
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float av[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) av[u] = As[kk][ty * 4 + u];
#pragma unroll
        for (int j = 0; j < BJ; ++j) {
          if (!has[j]) continue;  // uniform across the CTA
          float bv[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) bv[v] = Bs[j][kk][tx * 4 + v];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              acc[j][u][v] = fmaf(av[u], bv[v], acc[j][u][v]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < BJ; ++j) {
    const int64_t dj = row_dst[row * BJ + j];
    if (dj < 0) continue;
    float* dst = pool + dj * TT;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        dst[(int64_t)(r0 + ty * 4 + u) * T + c0 + tx * 4 + v] -= acc[j][u][v];
  }
}

template <int T, bool ROUND, bool SCALED>
cudaError_t launch(float* pool, const int64_t* row_dst,
                   const int64_t* ent_ptr, const int64_t* ent_a,
                   const int64_t* ent_b, const float* d,
                   const int64_t* ent_k, int64_t nrow, cudaStream_t stream) {
  constexpr int BM = T < 64 ? T : 64;
  constexpr int NB = T / BM;
  dim3 grid((unsigned)nrow, NB * NB);
  block_gemm_scatter_kernel<T, BM, ROUND, SCALED>
      <<<grid, (BM / 4) * (BM / 4), 0, stream>>>(pool, row_dst, ent_ptr,
                                                 ent_a, ent_b, d, ent_k);
  return cudaGetLastError();
}

template <bool ROUND, bool SCALED>
cudaError_t dispatch_t(int T, float* pool, const int64_t* row_dst,
                       const int64_t* ent_ptr, const int64_t* ent_a,
                       const int64_t* ent_b, const float* d,
                       const int64_t* ent_k, int64_t nrow, cudaStream_t s) {
  switch (T) {
    case 32:
      return launch<32, ROUND, SCALED>(pool, row_dst, ent_ptr, ent_a, ent_b,
                                       d, ent_k, nrow, s);
    case 64:
      return launch<64, ROUND, SCALED>(pool, row_dst, ent_ptr, ent_a, ent_b,
                                       d, ent_k, nrow, s);
    case 128:
      return launch<128, ROUND, SCALED>(pool, row_dst, ent_ptr, ent_a, ent_b,
                                        d, ent_k, nrow, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 = 1: operands rounded to bf16 on load; bf16 = 0: fp32 operands.
// row_dst: [nrow, 4] dst tiles of each block row (-1: none);
// ent_ptr: [nrow + 1]; ent_a, ent_k: [nent]; ent_b: [nent, 4] (-1: none).
// d != NULL: a's columns scaled by d[ent_k * T + k].
extern "C" int pastix_block_gemm_scatter(void* pool, const void* row_dst,
                                         const void* ent_ptr,
                                         const void* ent_a,
                                         const void* ent_b, const void* d,
                                         const void* ent_k, long long nrow,
                                         int T, int bf16, void* stream) {
  if (nrow <= 0) return 0;
  if (nrow > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto P = (float*)pool;
  auto rd = (const int64_t*)row_dst;
  auto ep = (const int64_t*)ent_ptr;
  auto ea = (const int64_t*)ent_a;
  auto eb = (const int64_t*)ent_b;
  auto dd = (const float*)d;
  auto ek = (const int64_t*)ent_k;
  auto s = (cudaStream_t)stream;
  if (d != nullptr)
    return bf16 ? (int)dispatch_t<true, true>(T, P, rd, ep, ea, eb, dd, ek,
                                              nrow, s)
                : (int)dispatch_t<false, true>(T, P, rd, ep, ea, eb, dd, ek,
                                               nrow, s);
  return bf16 ? (int)dispatch_t<true, false>(T, P, rd, ep, ea, eb, dd, ek,
                                             nrow, s)
              : (int)dispatch_t<false, false>(T, P, rd, ep, ea, eb, dd, ek,
                                              nrow, s);
}
