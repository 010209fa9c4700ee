// K4: in-place static-pivot factorization of a batch of diagonal tiles.
//
// Replaces the T-step lax.fori_loops of pastix_tpu/numeric/kernels.py
// (_getrf_single / getrf_inv_batch for LU, _ldlt_single / ldlt_inv_batch
// for LDL^T), which the reference runs without a Pallas kernel.
// Semantics, for every tile b of the batch (pool tile diag[b]):
//
//   LU   : unpivoted LU; the tile becomes the combined unit-L / U tile,
//          the clamped pivots on its diagonal.
//   LDL^T: unpivoted LDL^T of the symmetric tile whose lower triangle is
//          stored (the upper one is not read); the tile becomes the unit
//          lower L (zeros above the diagonal) and d_out[b * T + j] the
//          pivot of column j.
//
// A pivot with |p| < eps is clamped to +eps or -eps by its sign (+eps for
// 0), as _clamp_pivot does, and each clamp adds one to *npiv.
//
// What bounds it on an H100: a tile is 2/3 T^3 flop (LU) or 1/3 T^3
// (LDL^T).  LU reads and writes the tile (2 x 64 KiB at T = 128); LDL^T
// reads its lower triangle and writes the tile and the pivots (about
// 97 KiB).  That is about 10.7 and 7.1 flop per byte, below the fp32
// ridge of 67 TFLOP/s over 3.35 TB/s (20), so a large batch is bound by
// memory.
//
// The design, as K7/K8's (chol_inv.cu): blocked, in fp32 FMAs (TF32
// stays off), 32 x 32 blocks, NB = T / 32 block steps, one CTA a tile,
// the tile in shared memory (LDL^T mirrors each diagonal block's lower
// triangle into its upper one once loaded, and then factors it whole, as
// the twin factors its symmetrized tile).  Step k:
//   1. warp 0 subtracts step k-1's product from the diagonal block and
//      factors it, lane i holding row i in registers, each pivot clamped
//      as the twin clamps it, the pivot row broadcast by shuffles.
//      Meanwhile the other warps, in 64-thread groups (a 32 x 32
//      block a group, 4 x 4 outputs a thread from float4 loads), subtract
//      step k-1's panel product from the rest of the trailing blocks (LU
//      all of them, LDL^T those on or below the diagonal): a look-ahead,
//      since only the diagonal block had to be ready.
//   2. the panels, a warp a block.  LU: U_kj = L_kk^-1 A_kj (j > k), a
//      thread a column by forward substitution, and L_ik = A_ik U_kk^-1
//      (i > k), a thread a row by substitution.  LDL^T: a thread a row of
//      A_ik (i > k) turns it into W_ik = L_ik D_k and L_ik against the
//      diagonal block's pivot rows, and keeps W_ik transposed above the
//      diagonal, at block (k, i).
// The trailing update of step k, A_ij -= L_ik U_kj (LU) or L_ik W_jk^T
// (LDL^T, i >= j), is step k+1's phase 1.  Every element so sees the
// twin's subtractions in the twin's order (ascending elimination step,
// each a fused multiply-add where the twin rounds the product first);
// a division by a pivot is a multiplication by its reciprocal, within an
// ulp of the twin's quotient (an IEEE division takes its slow path on
// many values of the LU and LDL^T paths' sparse tiles, and measured
// slower there).  That is 2 CTA barriers a step (8 a tile at T = 128
// with the load's; LDL^T's mirror adds one).  Storage: the
// tile (T x (T + 4): 16-byte rows without bank conflicts) and the
// reciprocals, 66.1 KB at T = 128: three CTAs of 160 threads an SM.

#include "common.cuh"

namespace {

constexpr int NBS = 32;         // block edge
constexpr unsigned FULL = 0xffffffffu;

template <int T>
struct Tf {
  static constexpr int NB = T / NBS;
  static constexpr int LDA = T + 4;
  // 64-thread groups beside warp 0, a block of step 1's look-ahead each,
  // in rounds (at most 8 blocks at T = 128); step 2's panels take their
  // warps in rounds too (at most 6 blocks of 32 rows or columns).  Two
  // groups at T = 128 leave room for three CTAs an SM (four groups and
  // two CTAs measured slower on the busiest levels' batches)
  static constexpr int SLOTS = NB == 1 ? 0 : NB == 2 ? 1 : 2;
  static constexpr int NT = 32 + 64 * SLOTS;
  static constexpr int MINB = NB == 1 ? 16 : NB == 2 ? 6 : 3;
  // the tile, then the pivots' reciprocals
  static constexpr int SMEM = (T * LDA + NBS) * 4;
};

// c (rows tr + 8u, columns 4 tc + v) -= a . b over 32 k, a, b and c 32 x
// 32 blocks read row-major from shared memory with leading dimension ld;
// the sum starts from c, so each element takes the 32 subtractions one
// after another in k order
__device__ __forceinline__ void mms32(float* c, const float* a,
                                      const float* b, int ld, int tr,
                                      int tc) {
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 v = *(const float4*)(c + (tr + 8 * u) * ld + 4 * tc);
    acc[u][0] = v.x; acc[u][1] = v.y; acc[u][2] = v.z; acc[u][3] = v.w;
  }
#pragma unroll 2
  for (int q = 0; q < NBS; q += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      av[u] = *(const float4*)(a + (tr + 8 * u) * ld + q);
#pragma unroll
    for (int s = 0; s < 4; ++s)
      bv[s] = *(const float4*)(b + (q + s) * ld + 4 * tc);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float ar = s == 0 ? av[u].x : s == 1 ? av[u].y
                       : s == 2 ? av[u].z : av[u].w;
        acc[u][0] = fmaf(-ar, bv[s].x, acc[u][0]);
        acc[u][1] = fmaf(-ar, bv[s].y, acc[u][1]);
        acc[u][2] = fmaf(-ar, bv[s].z, acc[u][2]);
        acc[u][3] = fmaf(-ar, bv[s].w, acc[u][3]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    *(float4*)(c + (tr + 8 * u) * ld + 4 * tc) =
        make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
}

__device__ __forceinline__ float clamp_pivot(float p, float eps, int& n) {
  const bool small = fabsf(p) < eps;
  n += small;
  return small ? (p >= 0.f ? eps : -eps) : p;
}

// warp 0, step 1: the diagonal block D (leading dimension lda) less the
// product lp . up (step k-1's panels, none at k = 0), then factored in
// place, lane i holding row i.  LDL^T factors the whole symmetric block
// (its upper triangle mirrored at the tile's load and updated with the
// rest), as LU does: L below the diagonal (unit for LU), the clamped
// pivots on it, and above it LU's U or, for LDL^T, the rows M_jc of the
// pivot j as the twin reads them (the panels' W_kk^T).  At step j lane
// j's row goes to the lanes below by shuffles (a broadcast through
// shared memory, two buffers and a __syncwarp a step, measured slower).
// rd[j] = 1 / pivot j, and a division by a pivot is a
// multiplication by it: an IEEE division takes a slow path on many of
// the sparse tiles' values.  Returns the clamps; ``pivot``: lane i's
// clamped pivot.
__device__ __forceinline__ int diag_block(float* D, const float* lp,
                                          const float* up, int lda,
                                          float* rd, float eps, int lane,
                                          float& pivot) {
  float row[NBS];
#pragma unroll
  for (int c = 0; c < NBS; c += 4) {
    const float4 v = *(const float4*)(D + lane * lda + c);
    row[c] = v.x; row[c + 1] = v.y; row[c + 2] = v.z; row[c + 3] = v.w;
  }
  if (lp != nullptr) {
    for (int q = 0; q < NBS; q += 4) {
      const float4 lv = *(const float4*)(lp + lane * lda + q);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float l = s == 0 ? lv.x : s == 1 ? lv.y : s == 2 ? lv.z : lv.w;
        const float* u = up + (q + s) * lda;
#pragma unroll
        for (int c = 0; c < NBS; c += 4) {
          const float4 v = *(const float4*)(u + c);  // a broadcast
          row[c] = fmaf(-l, v.x, row[c]);
          row[c + 1] = fmaf(-l, v.y, row[c + 1]);
          row[c + 2] = fmaf(-l, v.z, row[c + 2]);
          row[c + 3] = fmaf(-l, v.w, row[c + 3]);
        }
      }
    }
  }
  int clamps = 0;
#pragma unroll
  for (int j = 0; j < NBS; ++j) {
    const float pc = clamp_pivot(__shfl_sync(FULL, row[j], j), eps, clamps);
    const float rp = __frcp_rn(pc);
    const float l = row[j] * rp;  // lanes below j
    // rows below j: row[c] -= l_i M_jc, the pivot row from lane j
#pragma unroll
    for (int c = j + 1; c < NBS; ++c) {
      const float v = __shfl_sync(FULL, row[c], j);
      if (lane > j) row[c] = fmaf(-l, v, row[c]);
    }
    if (lane == j) {
      row[j] = pc;
      pivot = pc;
      rd[j] = rp;
    } else if (lane > j) {
      row[j] = l;
    }
  }
#pragma unroll
  for (int c = 0; c < NBS; c += 4)
    *(float4*)(D + lane * lda + c) =
        make_float4(row[c], row[c + 1], row[c + 2], row[c + 3]);
  return clamps;
}

// LU step 2, a thread a column: P (column c of block (k, j), leading
// dimension lda) becomes U_kj's column, u_q = a_q - sum_{m<q} L_qm u_m,
// against the factored diagonal block D
__device__ __forceinline__ void u_col(float* P, const float* D, int lda) {
  float u[NBS];
#pragma unroll
  for (int q = 0; q < NBS; ++q) u[q] = P[q * lda];
#pragma unroll
  for (int m = 0; m < NBS; ++m)
#pragma unroll
    for (int q = m + 1; q < NBS; ++q)
      u[q] = fmaf(-D[q * lda + m], u[m], u[q]);
#pragma unroll
  for (int q = 0; q < NBS; ++q) P[q * lda] = u[q];
}

// step 2, a thread a row: P (row r of block (i, k)) becomes L_ik's row,
// w_c = a_c - sum_{q<c} l_q D_cq and l_c = w_c / D_cc, against the
// factored diagonal block D (above its diagonal LU's U or LDL^T's M_cq)
// and its pivots' reciprocals rd.  LDL^T (``up`` not null) keeps w, W_ik
// before the division, in column r of block (k, i): W_ik^T for the
// trailing update.
__device__ __forceinline__ void l_row(float* P, float* up, const float* D,
                                      const float* rd, int lda) {
  float l[NBS];
#pragma unroll
  for (int c = 0; c < NBS; c += 4) {
    const float4 v = *(const float4*)(P + c);
    l[c] = v.x; l[c + 1] = v.y; l[c + 2] = v.z; l[c + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < NBS; ++c) {
    if (up != nullptr) up[c * lda] = l[c];
    l[c] *= rd[c];
#pragma unroll
    for (int q = c + 1; q < NBS; ++q) l[q] = fmaf(-l[c], D[c * lda + q], l[q]);
  }
#pragma unroll
  for (int c = 0; c < NBS; c += 4)
    *(float4*)(P + c) = make_float4(l[c], l[c + 1], l[c + 2], l[c + 3]);
}

template <int T, bool LU>
__global__ void __launch_bounds__(Tf<T>::NT, Tf<T>::MINB)
tile_factor_kernel(float* __restrict__ pool, const int64_t* __restrict__ diag,
                   float* __restrict__ d_out, int* __restrict__ npiv,
                   float eps) {
  using C = Tf<T>;
  constexpr int NB = C::NB, LDA = C::LDA, NT = C::NT, Q = T / 4;
  constexpr int SLOTS = C::SLOTS > 0 ? C::SLOTS : 1;
  extern __shared__ __align__(16) float sm[];
  float* A = sm;             // T x LDA: the tile, factored in place
  float* RD = A + T * LDA;   // 1 / pivot of the current diagonal block

  const int tid = threadIdx.x;
  float* tile = pool + diag[blockIdx.x] * (int64_t)T * T;
  // the 16-byte pieces of the tile (LDL^T: those reaching its diagonal or
  // below), 8 loads in flight a thread before their stores
  for (int e0 = tid; e0 < T * Q; e0 += 8 * NT) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * NT, i = e / Q, c = e % Q * 4;
      if (e < T * Q && (LU || c <= i))
        v[u] = __ldg((const float4*)(tile + i * T + c));
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * NT, i = e / Q, c = e % Q * 4;
      if (e < T * Q && (LU || c <= i)) *(float4*)(A + i * LDA + c) = v[u];
    }
  }
  __syncthreads();
  if (!LU) {
    // the diagonal blocks' upper triangles mirrored from the lower ones
    for (int e = tid; e < NB * NBS * NBS; e += NT) {
      const int b = e / (NBS * NBS) * NBS, r = e / NBS % NBS, s = e % NBS;
      if (s > r) A[(b + r) * LDA + b + s] = A[(b + s) * LDA + b + r];
    }
    __syncthreads();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int w = tid - 32;           // worker index (warps 1..)
  const int slot = w >> 6;          // its 64-thread group
  const int tr = w & 7, tc = (w & 63) >> 3;
  auto blk = [&](int i, int j) { return A + i * NBS * LDA + j * NBS; };
  int clamps = 0;
  float pivot = 0.f;

  for (int k = 0; k < NB; ++k) {
    // 1. the diagonal block; the rest of step k-1's trailing update
    if (warp == 0) {
      clamps += diag_block(blk(k, k), k ? blk(k, k - 1) : nullptr,
                           k ? blk(k - 1, k) : nullptr, LDA, RD, eps, lane,
                           pivot);
      if (!LU) d_out[(int64_t)blockIdx.x * T + k * NBS + lane] = pivot;
    } else if (k > 0) {
      // blocks (i, j), i, j >= k, LDL^T j <= i, row by row, but (k, k)
      const int m = NB - k;
      const int nblk = (LU ? m * m : m * (m + 1) / 2) - 1;
      for (int t = slot; t < nblk; t += SLOTS) {
        int i = k, j;
        if (LU) {
          i = k + (t + 1) / m;
          j = k + (t + 1) % m;
        } else {
          int u = t + 1;
          while (u > i - k) u -= i++ - k + 1;
          j = k + u;
        }
        mms32(blk(i, j), blk(i, k - 1), blk(k - 1, j), LDA, tr, tc);
      }
    }
    __syncthreads();
    const int np = NB - 1 - k;  // panel blocks
    if (np == 0) break;
    // 2. the panels, a warp a block, a thread a row (L, and LDL^T's W)
    //    or a column (U)
    if (warp > 0) {
      const int r = w & 31;
      for (int pb = w >> 5; pb < (LU ? 2 * np : np); pb += 2 * SLOTS) {
        if (pb < np) {
          const int i = k + 1 + pb;
          l_row(blk(i, k) + r * LDA, LU ? nullptr : blk(k, i) + r,
                blk(k, k), RD, LDA);
        } else {
          u_col(blk(k, k + 1 + pb - np) + r, blk(k, k), LDA);
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0 && clamps) atomicAdd(npiv, clamps);

  // LU: the combined tile; LDL^T: the unit lower L, zeros above
  for (int e = tid; e < T * Q; e += NT) {
    const int i = e / Q, c = e % Q * 4;
    float4 v = *(const float4*)(A + i * LDA + c);
    if (!LU) {
      v.x = c < i ? v.x : (c == i ? 1.f : 0.f);
      v.y = c + 1 < i ? v.y : (c + 1 == i ? 1.f : 0.f);
      v.z = c + 2 < i ? v.z : (c + 2 == i ? 1.f : 0.f);
      v.w = c + 3 < i ? v.w : (c + 3 == i ? 1.f : 0.f);
    }
    *(float4*)(tile + i * T + c) = v;
  }
}

template <int T, bool LU>
cudaError_t launch(float* pool, const int64_t* diag, float* d_out, int* npiv,
                   int64_t B, float eps, cudaStream_t s) {
  static bool sized = false;  // once per instantiation
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_factor_kernel<T, LU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tf<T>::SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  tile_factor_kernel<T, LU><<<(unsigned)B, Tf<T>::NT, Tf<T>::SMEM, s>>>(
      pool, diag, d_out, npiv, eps);
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
