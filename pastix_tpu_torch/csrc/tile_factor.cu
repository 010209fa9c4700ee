// K4: in-place static-pivot factorization of a batch of diagonal tiles.
//
// Replaces the T-step lax.fori_loops of pastix_tpu/numeric/kernels.py
// (_getrf_single / getrf_inv_batch for LU, _ldlt_single / ldlt_inv_batch
// for LDL^T), which the reference runs without a Pallas kernel.
// Semantics, for every tile b of the batch (pool tile diag[b]):
//
//   LU   : unpivoted LU; the tile becomes the combined unit-L / U tile.
//   LDL^T: unpivoted LDL^T of the symmetric tile whose lower triangle is
//          stored; the tile becomes the unit lower L (zeros above the
//          diagonal) and d_out[b * T + j] the pivot of column j.
//
// A pivot with |p| < eps is clamped to +eps or -eps by its sign (+eps for
// 0), as _clamp_pivot does, and each clamp adds one to *npiv.
//
// What bounds it on an H100: a tile is 2/3 T^3 flop (LU) or 1/3 T^3
// (LDL^T) against 2 x 64 KiB of traffic at T = 128, about 10.7 and 5.3
// flop per byte, below the fp32 ridge of 67 TFLOP/s over 3.35 TB/s (20),
// so the bound is memory traffic; but the T elimination steps are serial
// within a tile, so a tile's latency is T steps of a rank-1 update and
// two barriers each.
//
// First design: one CTA per tile, the tile resident in shared memory
// (T x (T + 1) fp32, 66 KB at T = 128: the padded row keeps column reads
// free of bank conflicts; dynamic shared memory above the 48 KB default,
// opted into at launch).  Step j: (A) the threads of rows i > j scale
// column j by the pivot into a shared vector; barrier; (B) every thread
// owns one column k and a stride of rows and applies the rank-1 update to
// the trailing block (for LDL^T its lower triangle only); barrier.  A
// batched tile can so leave room for a Cholesky variant (B4/B5) later:
// only phase A's pivot changes.

#include "common.cuh"

namespace {

constexpr int NT = 256;

template <int T, bool LU>
__global__ void __launch_bounds__(NT)
tile_factor_kernel(float* __restrict__ pool, const int64_t* __restrict__ diag,
                   float* __restrict__ d_out, int* __restrict__ npiv,
                   float eps) {
  constexpr int LDS = T + 1;
  constexpr int ROWS = NT / T;  // rows of the trailing block per pass
  extern __shared__ float sm[];
  float* M = sm;              // T x LDS
  float* lcol = sm + T * LDS;  // column j scaled by its pivot
  float* raw = lcol + T;       // LDL^T: column j before the scaling

  const int tid = threadIdx.x;
  float* tile = pool + diag[blockIdx.x] * (int64_t)T * T;
  for (int e = tid; e < T * T; e += NT) M[(e / T) * LDS + e % T] = tile[e];
  __syncthreads();

  const int k = tid % T;  // phase B: the column this thread owns
  const int r0 = tid / T;
  for (int j = 0; j < T; ++j) {
    const float piv = M[j * LDS + j];
    const bool small = fabsf(piv) < eps;
    const float pc = small ? (piv >= 0.f ? eps : -eps) : piv;
    // phase A: no thread writes M[j][j] or row j here
    if (tid > j && tid < T) {
      const float v = M[tid * LDS + j];
      raw[tid] = v;
      const float l = v / pc;
      lcol[tid] = l;
      M[tid * LDS + j] = l;
    }
    if (tid == 0) {
      if (small) atomicAdd(npiv, 1);
      if (!LU) d_out[(int64_t)blockIdx.x * T + j] = pc;
    }
    __syncthreads();
    // phase B: reads lcol, row j (LU) or raw (LDL^T); writes rows > j,
    // columns > j, and M[j][j] for LU, which no thread reads here
    if (k > j) {
      const float rv = LU ? M[j * LDS + k] : raw[k];
      for (int i = j + 1 + r0; i < T; i += ROWS)
        if (LU || i >= k) M[i * LDS + k] = fmaf(-lcol[i], rv, M[i * LDS + k]);
    }
    if (LU && tid == 0) M[j * LDS + j] = pc;
    __syncthreads();
  }
  for (int e = tid; e < T * T; e += NT) {
    const int i = e / T, c = e % T;
    tile[e] = LU ? M[i * LDS + c]
                 : (i > c ? M[i * LDS + c] : (i == c ? 1.f : 0.f));
  }
}

template <int T, bool LU>
cudaError_t launch(float* pool, const int64_t* diag, float* d_out, int* npiv,
                   int64_t B, float eps, cudaStream_t s) {
  const size_t smem = (size_t)(T * (T + 1) + 2 * T) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tile_factor_kernel<T, LU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  tile_factor_kernel<T, LU><<<(unsigned)B, NT, smem, s>>>(pool, diag, d_out,
                                                           npiv, eps);
  return cudaGetLastError();
}

template <bool LU>
cudaError_t dispatch_t(int T, float* pool, const int64_t* diag, float* d_out,
                       int* npiv, int64_t B, float eps, cudaStream_t s) {
  switch (T) {
    case 32:
      return launch<32, LU>(pool, diag, d_out, npiv, B, eps, s);
    case 64:
      return launch<64, LU>(pool, diag, d_out, npiv, B, eps, s);
    case 128:
      return launch<128, LU>(pool, diag, d_out, npiv, B, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// lu = 1: LU (d_out unused); lu = 0: LDL^T, d_out (B, T).
extern "C" int pastix_tile_factor(void* pool, const void* diag, void* d_out,
                                  void* npiv, long long B, int T, int lu,
                                  float eps, void* stream) {
  if (B <= 0) return 0;
  if (B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto dg = (const int64_t*)diag;
  return lu ? (int)dispatch_t<true>(T, (float*)pool, dg, (float*)d_out,
                                    (int*)npiv, B, eps, s)
            : (int)dispatch_t<false>(T, (float*)pool, dg, (float*)d_out,
                                     (int*)npiv, B, eps, s);
}
