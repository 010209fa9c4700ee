// K7, K8: fused Cholesky + inverse of a batch of diagonal tiles.
//
// Replaces the Pallas kernels of pastix_tpu/numeric/pallas_kernels.py
// chol_inv_pool_pallas (B4: in place on the tile pool, by diagonal index)
// and chol_inv_pallas (B5: a batch of full symmetric tiles).  Semantics,
// for every tile b of the batch: read its lower triangle M (the upper
// triangle is ignored: pool tiles hold scatter garbage there), form the
// lower Cholesky factor L (M = L L^T) and X = L^-1, both written lower
// triangular with zeros above.  K7 reads tile idx[b] of the pool and
// writes L back in its place; an index outside [0, npool), the
// reference's padding, reads and writes no tile and gives a zero X.  K8
// reads tile b of `in` and writes L and X to tile b of l_out and x_out.
// A pivot that is not positive gives NaN, as the reference's does.
// (in and l_out alias for K7, so neither is __restrict__.)
//
// What bounds it on an H100: a tile is T^3 / 3 flop for L and as much
// again for X against 160 KB of traffic at T = 128 (the lower triangle of
// M read, L and X written), about 8.5 flop per byte: below the fp32 ridge
// of 67 TFLOP/s over 3.35 TB/s (20), so the bound is memory traffic.  But
// the T elimination steps are serial within a tile, so a tile's latency
// is T steps of a rank-1 update with two barriers each.
//
// First design, after K4 (tile_factor.cu): one CTA per tile, the tile
// resident in shared memory.  The right-looking elimination of B4 needs
// only the lower triangle of M, and X = L^-1 is lower triangular, so one
// T x (T + 1) array holds both: on and below the diagonal, M turning into
// L column by column; strictly above it, X transposed (X[i][c] at
// A[c][i]); X's diagonal in a vector.  That is 66 KB at T = 128 (dynamic
// shared memory, opted into at launch) and leaves room for three CTAs an
// SM, where separate M and X arrays would fit one.  Step j, as in
// _chol_inv_kernel: (A) pivot p = sqrt(A[j][j]); the threads of rows
// i > j scale column j to L's column l; the threads of rows c < j take
// row j of X (stored in column j above the diagonal) into a vector and
// divide it by p in place; barrier.  (B) every thread owns one column
// k > j and a stride of rows: rows r <= j of its column are X[k][r] -=
// (l_k / p) X_j[r] (the rank-1 row update X := E_j^-1 X), rows r >= k
// the trailing Cholesky update M[r][k] -= l_r l_k; barrier.

#include "common.cuh"

namespace {

constexpr int NT = 256;

template <int T>
__global__ void __launch_bounds__(NT)
chol_inv_kernel(const float* in, const int64_t* __restrict__ idx,
                int64_t npool, float* l_out, float* __restrict__ x_out) {
  constexpr int LDS = T + 1;
  constexpr int ROWS = NT / T;  // rows of one column per pass
  constexpr int64_t TT = (int64_t)T * T;
  extern __shared__ float sm[];
  float* A = sm;               // T x LDS: L / M below, X^T above
  float* lcol = A + T * LDS;   // column j of L (rows > j)
  float* xrow = lcol + T;      // row j of X before step j (cols <= j)
  float* xd = xrow + T;        // diagonal of X

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  float* xt = x_out + b * TT;
  const float* src;
  float* dst;
  if (idx != nullptr) {
    const int64_t t = idx[b];
    if (t < 0 || t >= npool) {  // padding: no tile
      for (int e = tid; e < T * T; e += NT) xt[e] = 0.f;
      return;
    }
    src = in + t * TT;
    dst = l_out + t * TT;
  } else {
    src = in + b * TT;
    dst = l_out + b * TT;
  }
  for (int e = tid; e < T * T; e += NT) {
    const int i = e / T, c = e % T;
    A[i * LDS + c] = i >= c ? src[e] : 0.f;
  }
  __syncthreads();

  const int k = tid % T;  // phase B: the column this thread owns
  const int r0 = tid / T;
  for (int j = 0; j < T; ++j) {
    const float piv = sqrtf(A[j * LDS + j]);
    // phase A: column j only; A[j][j] is written in phase B
    if (tid < T) {
      if (tid > j) {
        const float l = A[tid * LDS + j] / piv;
        A[tid * LDS + j] = l;
        lcol[tid] = l;
      } else if (tid < j) {
        const float x = A[tid * LDS + j];
        xrow[tid] = x;
        A[tid * LDS + j] = x / piv;
      } else {
        xrow[j] = 1.f;
        xd[j] = 1.f / piv;
      }
    }
    __syncthreads();
    // phase B: columns k > j; rows r <= j (X) and r >= k (trailing M)
    if (k > j) {
      const float lk = lcol[k];
      const float s = lk / piv;
      for (int r = r0; r <= j; r += ROWS)
        A[r * LDS + k] = fmaf(-s, xrow[r], A[r * LDS + k]);
      for (int r = k + ((r0 - k) & (ROWS - 1)); r < T; r += ROWS)
        A[r * LDS + k] = fmaf(-lcol[r], lk, A[r * LDS + k]);
    }
    if (tid == 0) A[j * LDS + j] = piv;
    __syncthreads();
  }
  for (int e = tid; e < T * T; e += NT) {
    const int i = e / T, c = e % T;
    dst[e] = i >= c ? A[i * LDS + c] : 0.f;
    xt[e] = i > c ? A[c * LDS + i] : (i == c ? xd[i] : 0.f);
  }
}

template <int T>
cudaError_t launch(const float* in, const int64_t* idx, int64_t npool,
                   float* l_out, float* x_out, int64_t B, cudaStream_t s) {
  const size_t smem = (size_t)(T * (T + 1) + 3 * T) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chol_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  chol_inv_kernel<T><<<(unsigned)B, NT, smem, s>>>(in, idx, npool, l_out,
                                                    x_out);
  return cudaGetLastError();
}

}  // namespace

// idx != NULL (K7): tile idx[b] of the pool `in`, L written in place
// (l_out == in), X to x_out[b]; idx == NULL (K8): tile b of in, L and X
// to tile b of l_out and x_out.
extern "C" int pastix_chol_inv(const void* in, const void* idx,
                               long long npool, void* l_out, void* x_out,
                               long long B, int T, void* stream) {
  if (B <= 0) return 0;
  if (B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto src = (const float*)in;
  auto ix = (const int64_t*)idx;
  auto L = (float*)l_out;
  auto X = (float*)x_out;
  switch (T) {
    case 32:
      return (int)launch<32>(src, ix, npool, L, X, B, s);
    case 64:
      return (int)launch<64>(src, ix, npool, L, X, B, s);
    case 128:
      return (int)launch<128>(src, ix, npool, L, X, B, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
