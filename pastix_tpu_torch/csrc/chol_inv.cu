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
// A pivot that is not positive gives NaN, as the reference's does: L's
// columns and X's rows from that pivot on.  (in and l_out alias for K7,
// so neither is __restrict__.)
//
// What bounds it on an H100: a tile is T^3 / 3 flop for L and as much
// again for X against 160 KB of traffic at T = 128, about 8.5 flop per
// byte, below the fp32 ridge of 67 TFLOP/s over 3.35 TB/s (20): memory
// bounds a large batch.  But the dense tail factors one tile a call, one
// call after another (K8), and there a tile's latency is everything.
// The first design took a tile through T strictly serial rank-1 steps,
// two CTA barriers each, and in each step one thread walked half a
// column in shared memory with no register blocking: 0.273 ms a tile at
// T = 128, 2.8x cholesky_ex + solve_triangular on it.
//
// This design: blocked, in fp32 FMAs (TF32 stays off), with 32 x 32
// blocks, NB = T / 32 block steps, one CTA a tile, the tile in shared
// memory.  Step k:
//   1. warp 0 factors the diagonal block, A_kk = L_kk L_kk^T, with lane i
//      holding row i in registers (pivots and columns by shuffles, no
//      barrier), then inverts it, lane c solving column c of
//      X_kk = L_kk^-1.  Meanwhile the other warps form
//      S_kj = sum_{m=j..k-1} L_km X_mj (j < k) and subtract step k-1's
//      panel from the trailing columns beyond k (a look-ahead: only
//      column k had to be ready for this step).
//   2. the other warps: the panel L_ik = A_ik L_kk^-T (i > k), a thread
//      a row by substitution, as the twin orders it (multiplying by X_kk
//      instead measured up to twice the twin's error in X on a tile of
//      condition 1e4), and X's off-diagonal row X_kj = -X_kk S_kj (j < k).
//   3. the trailing update of column k + 1 alone,
//      A_{i,k+1} -= L_ik L_{k+1,k}^T, so that step k + 1 can start.
// Block products run over 64 threads, 4 x 4 outputs a thread, float4
// shared-memory loads.  That is 3 CTA barriers a step (12 a tile at
// T = 128, with the load's and the store's) instead of 256.  Storage: A
// (T x (T + 4)) holds M turning into L on and below the diagonal; the
// block above the diagonal at (k, i) holds L_ik^T from step k's panel
// until step i, then X_ik.  X_kk and S have 32 x 36 buffers of their
// own: 97.5 KB at T = 128, two CTAs an SM for K7's batches.  A one-tile
// call (K8) uses the same 288 threads: steps 2 and 3 have at most 3
// block products, and step 1's diagonal factorization, which no more
// threads could shorten, is the critical path.

#include "common.cuh"

namespace {

constexpr int NBS = 32;          // block edge
constexpr int LDX = NBS + 4;     // row of a 32 x 32 buffer (16-byte rows)
constexpr int BUF = NBS * LDX;   // floats a buffer
constexpr unsigned FULL = 0xffffffffu;

template <int T>
struct Ci {
  static constexpr int NB = T / NBS;
  static constexpr int LDA = T + 4;
  // 64-thread groups beside warp 0: as many as step 1 has block products
  static constexpr int SLOTS = NB == 1 ? 0 : NB == 2 ? 1 : 4;
  static constexpr int NT = 32 + 64 * SLOTS;
  // A, then X_kk (NB) and S (NB - 1) buffers
  static constexpr int SMEM = (T * LDA + (2 * NB - 1) * BUF) * 4;
  static_assert(NB - 1 <= SLOTS || NB == 1, "steps 2 and 3 fit one round");
};

// acc (rows tr + 8u, columns 4 tc + v) += a . b over 32 k, a and b 32 x 32
// blocks read row-major from shared memory
__device__ __forceinline__ void mm32(float (&acc)[4][4], const float* a,
                                     int lda, const float* b, int ldb,
                                     int tr, int tc) {
#pragma unroll 2
  for (int q = 0; q < NBS; q += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      av[u] = *(const float4*)(a + (tr + 8 * u) * lda + q);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      bv[s] = *(const float4*)(b + (q + s) * ldb + 4 * tc);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float ar[4] = {av[u].x, av[u].y, av[u].z, av[u].w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        acc[u][0] = fmaf(ar[s], bv[s].x, acc[u][0]);
        acc[u][1] = fmaf(ar[s], bv[s].y, acc[u][1]);
        acc[u][2] = fmaf(ar[s], bv[s].z, acc[u][2]);
        acc[u][3] = fmaf(ar[s], bv[s].w, acc[u][3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
}

// p[rows tr + 8u, columns 4 tc..] = sign * acc (add: p += sign * acc)
template <bool ADD>
__device__ __forceinline__ void put(float* p, int ld, const float (&acc)[4][4],
                                    float sign, int tr, int tc) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float4* q = (float4*)(p + (tr + 8 * u) * ld + 4 * tc);
    float4 v = ADD ? *q : make_float4(0.f, 0.f, 0.f, 0.f);
    v.x += sign * acc[u][0];
    v.y += sign * acc[u][1];
    v.z += sign * acc[u][2];
    v.w += sign * acc[u][3];
    *q = v;
  }
}

// warp 0, step 1: the diagonal block D (in A, leading dimension lda)
// becomes L_kk on and below its diagonal; X_kk = L_kk^-1 goes to xd
// (row-major, zeros above its diagonal) and the pivots' reciprocals
// 1 / L_jj to rd.  A pivot p gives rsqrt(p) once: L_jj = p rsqrt(p) and
// every division by L_jj a multiplication, which shortens the warp's
// dependent chain (a correctly rounded sqrt or division is a sequence of
// dependent instructions; the L and X this gives differ from the twin's
// by a few ulp more, far inside 1e-5).  p <= 0 gives a NaN pivot.
__device__ __forceinline__ void diag_block(float* D, int lda, float* xd,
                                           float* rd, int lane) {
  float row[NBS];  // lane i: row i of the block (above the diagonal unused)
#pragma unroll
  for (int c = 0; c < NBS; c += 4) {
    const float4 v = *(const float4*)(D + lane * lda + c);
    row[c] = v.x; row[c + 1] = v.y; row[c + 2] = v.z; row[c + 3] = v.w;
  }
  float myr = 0.f;  // lane j: 1 / L_jj
#pragma unroll
  for (int j = 0; j < NBS; ++j) {
    const float p = __shfl_sync(FULL, row[j], j);
    const float rs = rsqrtf(p);
    const float l = row[j] * rs;
    if (lane == j) myr = rs;
    if (lane >= j) row[j] = lane == j ? p * rs : l;
    // rows below j: row[c] -= l_i l_c (lanes <= j touch only their unused
    // upper part)
#pragma unroll
    for (int c = j + 1; c < NBS; ++c)
      row[c] = fmaf(-l, __shfl_sync(FULL, l, c), row[c]);
  }
#pragma unroll
  for (int c = 0; c < NBS; c += 4)
    *(float4*)(D + lane * lda + c) =
        make_float4(row[c], row[c + 1], row[c + 2], row[c + 3]);
  // lane c: column c of X, x_q = (delta_qc - sum_{m<q} L_qm x_m) / L_qq
  float x[NBS];
#pragma unroll
  for (int q = 0; q < NBS; ++q) x[q] = q == lane ? 1.f : 0.f;
#pragma unroll
  for (int m = 0; m < NBS; ++m) {
    x[m] *= __shfl_sync(FULL, myr, m);
#pragma unroll
    for (int q = m + 1; q < NBS; ++q)
      x[q] = fmaf(-__shfl_sync(FULL, row[m], q), x[m], x[q]);
  }
#pragma unroll
  for (int q = 0; q < NBS; ++q) xd[q * LDX + lane] = x[q];
  rd[lane] = myr;
}

// step 2, thread r of a panel block: row r of L_ik = A_ik L_kk^-T by
// substitution against the factored diagonal block D and its pivots'
// reciprocals rd (the twin's order: l_rc = (a_rc - sum_{q<c} l_rq L_cq)
// / L_cc; multiplying by X_kk instead measured up to twice the twin's
// error in X on a tile of condition 1e4), written to the panel's row r
// and, transposed, to column r of the block above the diagonal at (k, i)
__device__ __forceinline__ void panel_row(float* P, float* up, int lda,
                                          const float* D, const float* rd,
                                          int r) {
  float l[NBS];
#pragma unroll
  for (int c = 0; c < NBS; c += 4) {
    const float4 v = *(const float4*)(P + r * lda + c);
    l[c] = v.x; l[c + 1] = v.y; l[c + 2] = v.z; l[c + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < NBS; ++c) {
    l[c] *= rd[c];
#pragma unroll
    for (int q = c + 1; q < NBS; ++q)
      l[q] = fmaf(-l[c], D[q * lda + c], l[q]);
    up[c * lda + r] = l[c];
  }
#pragma unroll
  for (int c = 0; c < NBS; c += 4)
    *(float4*)(P + r * lda + c) = make_float4(l[c], l[c + 1], l[c + 2],
                                              l[c + 3]);
}

template <int T>
__global__ void __launch_bounds__(Ci<T>::NT, 2)
chol_inv_kernel(const float* in, const int64_t* __restrict__ idx,
                int64_t npool, float* l_out, float* __restrict__ x_out) {
  using C = Ci<T>;
  constexpr int NB = C::NB, LDA = C::LDA, NT = C::NT, Q = T / 4;
  constexpr int64_t TT = (int64_t)T * T;
  extern __shared__ __align__(16) float sm[];
  float* A = sm;                // T x LDA: M -> L below, L^T / X above
  float* XD = A + T * LDA;      // X_kk, one buffer a block
  float* S = XD + NB * BUF;     // S_kj, j < k
  __shared__ float RD[NBS];     // 1 / L_jj of the current diagonal block

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  float* xt = x_out + b * TT;
  const float* src;
  float* dst;
  if (idx != nullptr) {
    const int64_t t = idx[b];
    if (t < 0 || t >= npool) {  // padding: no tile
      for (int e = tid; e < T * Q; e += NT)
        ((float4*)xt)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      return;
    }
    src = in + t * TT;
    dst = l_out + t * TT;
  } else {
    src = in + b * TT;
    dst = l_out + b * TT;
  }
  // the 16-byte pieces of M that reach its diagonal or lie below it, 8
  // loads in flight a thread before their stores
  for (int e0 = tid; e0 < T * Q; e0 += 8 * NT) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * NT, i = e / Q, c = e % Q * 4;
      if (e < T * Q && c <= i)
        v[u] = __ldg((const float4*)(src + i * T + c));
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * NT, i = e / Q, c = e % Q * 4;
      if (e < T * Q && c <= i) *(float4*)(A + i * LDA + c) = v[u];
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int w = tid - 32;           // worker index (warps 1..)
  const int slot = w >> 6;          // its 64-thread group
  const int tr = w & 7, tc = (w & 63) >> 3;
  auto blk = [&](int i, int j) { return A + i * NBS * LDA + j * NBS; };
  float acc[4][4];

  for (int k = 0; k < NB; ++k) {
    // 1. the diagonal block; S_kj, and step k-1's panel subtracted from
    //    the columns beyond k (i >= j >= k + 1)
    if (warp == 0) {
      diag_block(blk(k, k), LDA, XD + k * BUF, RD, lane);
    } else {
      const int nrest = k ? (NB - k - 1) * (NB - k) / 2 : 0;
      for (int t = slot; t < k + nrest; t += C::SLOTS) {
        zero(acc);
        if (t < k) {
          const int j = t;
          for (int m = j; m < k; ++m)
            mm32(acc, blk(k, m), LDA, m == j ? XD + j * BUF : blk(j, m),
                 m == j ? LDX : LDA, tr, tc);
          put<false>(S + j * BUF, LDX, acc, 1.f, tr, tc);
        } else {
          int u = t - k, j = k + 1;
          while (u >= NB - j) u -= NB - j++;
          const int i = j + u;
          mm32(acc, blk(i, k - 1), LDA, blk(k - 1, j), LDA, tr, tc);
          put<true>(blk(i, j), LDA, acc, -1.f, tr, tc);
        }
      }
    }
    __syncthreads();
    // 2. the panel L_ik = A_ik L_kk^-T (i > k; also kept transposed
    //    above the diagonal, at block (k, i)), a thread a row, and
    //    X_kj = -X_kk S_kj (j < k)
    const int npanel = NB - 1 - k;
    if (warp > 0 && slot < NB - 1) {
      if (slot < npanel) {
        const int i = k + 1 + slot;
        if ((w & 63) < NBS)
          panel_row(blk(i, k), blk(k, i), LDA, blk(k, k), RD, w & 63);
      } else {
        const int j = slot - npanel;
        zero(acc);
        mm32(acc, XD + k * BUF, LDX, S + j * BUF, LDX, tr, tc);
        put<false>(blk(j, k), LDA, acc, -1.f, tr, tc);
      }
    }
    if (npanel == 0) continue;  // the last step: no panel, no update
    __syncthreads();
    // 3. column k + 1: A_{i,k+1} -= L_ik L_{k+1,k}^T (i >= k + 1)
    if (warp > 0 && slot < npanel) {
      const int i = k + 1 + slot;
      zero(acc);
      mm32(acc, blk(i, k), LDA, blk(k, k + 1), LDA, tr, tc);
      put<true>(blk(i, k + 1), LDA, acc, -1.f, tr, tc);
    }
    __syncthreads();
  }
  __syncthreads();

  // L and X, lower triangular with zeros above: X's off-diagonal block
  // (bi, bj) sits above the diagonal at (bj, bi), its diagonal blocks in XD
  for (int e = tid; e < T * Q; e += NT) {
    const int i = e / Q, c = e % Q * 4;
    const int bi = i / NBS, bj = c / NBS, r = i % NBS, cc = c % NBS;
    float4 lv = make_float4(0.f, 0.f, 0.f, 0.f), xv = lv;
    if (bj < bi) {
      lv = *(const float4*)(A + i * LDA + c);
      xv = *(const float4*)(blk(bj, bi) + r * LDA + cc);
    } else if (bj == bi) {
      const float4 l4 = *(const float4*)(A + i * LDA + c);
      const float4 x4 = *(const float4*)(XD + bi * BUF + r * LDX + cc);
      lv = make_float4(cc <= r ? l4.x : 0.f, cc + 1 <= r ? l4.y : 0.f,
                       cc + 2 <= r ? l4.z : 0.f, cc + 3 <= r ? l4.w : 0.f);
      xv = make_float4(cc <= r ? x4.x : 0.f, cc + 1 <= r ? x4.y : 0.f,
                       cc + 2 <= r ? x4.z : 0.f, cc + 3 <= r ? x4.w : 0.f);
    }
    *(float4*)(dst + i * T + c) = lv;
    *(float4*)(xt + i * T + c) = xv;
  }
}

template <int T>
cudaError_t launch(const float* in, const int64_t* idx, int64_t npool,
                   float* l_out, float* x_out, int64_t B, cudaStream_t s) {
  static bool sized = false;  // once per instantiation
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        chol_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Ci<T>::SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  chol_inv_kernel<T><<<(unsigned)B, Ci<T>::NT, Ci<T>::SMEM, s>>>(
      in, idx, npool, l_out, x_out);
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
