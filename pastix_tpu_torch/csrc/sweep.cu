// K2: one level phase of the whole-sweep triangular solve.
//
// Replaces the Pallas kernel pastix_tpu/numeric/sweep_kernels.py
// run_sweep (_mk_sweep_kernel; entries sweep_fwd / sweep_bwd).  The RHS is
// in the reference's row-vector layout, y[(blk * R + r) * T + i].
//
//   diag phase  : y[c] = D[c] . y[c] for every column c of the level
//   update phase: y[dst] -= sum over the dst's ops of M[tile] . y[src]
//
// with M(i, k) = tile[i, k] in the forward sweep and tile[k, i] (the
// transpose) in the backward sweep.
//
// What bounds it on an H100: every stored tile is read once per sweep
// (64 KB at T = 128) for 2 T^2 R FLOP, a quarter FLOP per byte at R = 1,
// so a sweep is bound by HBM bandwidth (3.35 TB/s) and, between the
// levels, by launch latency.  On the TPU the sweep was one program whose
// grid ran in order; blocks on Hopper run in no order, so this first
// design launches per level and phase (level order is the launch order).
// Diag: one CTA per column, y[c] is read into shared memory before it is
// overwritten.  Update: the host sorts the phase's ops by dst and cuts each
// dst's run into sub-segments of a few ops; pass 1 gives each sub-segment
// a CTA that writes its partial sum to scratch, pass 2 gives each dst a
// CTA that adds its partials in a fixed order.  A dst with hundreds of ops
// (a separator row, a long column in the backward sweep) so spreads over
// many SMs, and runs repeat bit for bit without atomics.  Tiles stream
// through shared memory in coalesced 32-column slices.

#include "common.cuh"

namespace {

constexpr int KC = 32;    // k slice of a tile staged in shared memory
constexpr int RC = 4;     // right-hand sides per register pass
constexpr int TMAX = 128;

// acc[u] += sum_k M(i, k) * ys[u][k] for one tile, i = threadIdx.x
template <bool TRANS>
__device__ __forceinline__ void tile_matvec(const float* __restrict__ tile,
                                            int T, const float* ys, int nr,
                                            float* Ms, float acc[RC]) {
  const int i = threadIdx.x;
  for (int k0 = 0; k0 < T; k0 += KC) {
    // KC loads per thread, all issued before the first store: element
    // e = i + j T of the slice, coalesced across i in both layouts
    float v[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (TRANS) {  // kk = j, ii = i
        v[j] = __ldg(tile + (int64_t)(k0 + j) * T + i);
      } else {  // ii = e / KC, kk = e % KC = i % KC (T is a multiple of KC)
        const int e = i + j * T;
        v[j] = __ldg(tile + (int64_t)(e / KC) * T + k0 + e % KC);
      }
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int e = i + j * T;
      if (TRANS)
        Ms[i * (KC + 1) + j] = v[j];
      else
        Ms[(e / KC) * (KC + 1) + e % KC] = v[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float m = Ms[i * (KC + 1) + kk];
#pragma unroll
      for (int u = 0; u < RC; ++u)
        if (u < nr) acc[u] = fmaf(m, ys[u * T + k0 + kk], acc[u]);
    }
    __syncthreads();
  }
}

template <bool TRANS>
__global__ void __launch_bounds__(TMAX)
sweep_diag_kernel(float* __restrict__ y, const float* __restrict__ dinv,
                  const int64_t* __restrict__ cols, int T, int R) {
  __shared__ float Ms[TMAX * (KC + 1)];
  __shared__ float ys[RC * TMAX];
  const int i = threadIdx.x;
  const int64_t c = cols[blockIdx.x];
  const float* tile = dinv + c * T * T;
  float* yc = y + c * R * T;
  for (int r0 = 0; r0 < R; r0 += RC) {
    const int nr = min(RC, R - r0);
    for (int u = 0; u < nr; ++u) ys[u * T + i] = yc[(int64_t)(r0 + u) * T + i];
    __syncthreads();
    float acc[RC] = {0.f, 0.f, 0.f, 0.f};
    tile_matvec<TRANS>(tile, T, ys, nr, Ms, acc);
    for (int u = 0; u < nr; ++u) yc[(int64_t)(r0 + u) * T + i] = acc[u];
  }
}

// Update phase, pass 1: one CTA per sub-segment (a few consecutive ops of
// one dst) writes its partial sum sum_q M[tile_q] . y[src_q] to scratch.
template <bool TRANS>
__global__ void __launch_bounds__(TMAX)
sweep_partial_kernel(float* __restrict__ partial,
                     const float* __restrict__ y,
                     const float* __restrict__ pool,
                     const int64_t* __restrict__ sub_ptr,
                     const int64_t* __restrict__ op_tile,
                     const int64_t* __restrict__ op_src, int T, int R) {
  __shared__ float Ms[TMAX * (KC + 1)];
  __shared__ float ys[RC * TMAX];
  const int i = threadIdx.x;
  const int64_t sub = blockIdx.x;
  const int64_t q0 = sub_ptr[sub], q1 = sub_ptr[sub + 1];
  float* out = partial + sub * R * T;
  for (int r0 = 0; r0 < R; r0 += RC) {
    const int nr = min(RC, R - r0);
    float acc[RC] = {0.f, 0.f, 0.f, 0.f};
    for (int64_t q = q0; q < q1; ++q) {
      const float* ysrc = y + op_src[q] * R * T;
      for (int u = 0; u < nr; ++u)
        ys[u * T + i] = ysrc[(int64_t)(r0 + u) * T + i];
      // tile_matvec syncs before its first read of ys, and after its
      // last, so the next op's ys load cannot race this op's reads
      tile_matvec<TRANS>(pool + op_tile[q] * T * T, T, ys, nr, Ms, acc);
    }
    for (int u = 0; u < nr; ++u) out[(int64_t)(r0 + u) * T + i] = acc[u];
  }
}

// Update phase, pass 2: one CTA per dst adds its sub-segments' partial
// sums in a fixed order and subtracts them from y[dst].
__global__ void __launch_bounds__(TMAX)
sweep_reduce_kernel(float* __restrict__ y, const float* __restrict__ partial,
                    const int64_t* __restrict__ seg_sub_ptr,
                    const int64_t* __restrict__ seg_dst, int T, int R) {
  const int i = threadIdx.x;
  const int64_t s = blockIdx.x;
  const int64_t b0 = seg_sub_ptr[s], b1 = seg_sub_ptr[s + 1];
  float* yd = y + seg_dst[s] * R * T;
  for (int r = 0; r < R; ++r) {
    float sum = 0.f;
    for (int64_t b = b0; b < b1; ++b)
      sum += partial[(b * R + r) * T + i];
    yd[(int64_t)r * T + i] -= sum;
  }
}

}  // namespace

extern "C" const char* pastix_cuda_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int pastix_sweep_diag(void* y, const void* dinv, const void* cols,
                                 long long ncols, int T, int R, int trans,
                                 void* stream) {
  if (ncols <= 0) return 0;
  if (T % KC != 0 || T > TMAX || R < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (trans)
    sweep_diag_kernel<true><<<(unsigned)ncols, T, 0, s>>>(
        (float*)y, (const float*)dinv, (const int64_t*)cols, T, R);
  else
    sweep_diag_kernel<false><<<(unsigned)ncols, T, 0, s>>>(
        (float*)y, (const float*)dinv, (const int64_t*)cols, T, R);
  return (int)cudaGetLastError();
}

extern "C" int pastix_sweep_update(void* y, const void* pool, void* partial,
                                   const void* sub_ptr,
                                   const void* seg_sub_ptr,
                                   const void* seg_dst, const void* op_tile,
                                   const void* op_src, long long nsub,
                                   long long nseg, int T, int R, int trans,
                                   void* stream) {
  if (nseg <= 0) return 0;
  if (T % KC != 0 || T > TMAX || R < 1) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto sp = (const int64_t*)sub_ptr;
  auto ot = (const int64_t*)op_tile;
  auto os = (const int64_t*)op_src;
  if (trans)
    sweep_partial_kernel<true><<<(unsigned)nsub, T, 0, s>>>(
        (float*)partial, (const float*)y, (const float*)pool, sp, ot, os, T,
        R);
  else
    sweep_partial_kernel<false><<<(unsigned)nsub, T, 0, s>>>(
        (float*)partial, (const float*)y, (const float*)pool, sp, ot, os, T,
        R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweep_reduce_kernel<<<(unsigned)nseg, T, 0, s>>>(
      (float*)y, (const float*)partial, (const int64_t*)seg_sub_ptr,
      (const int64_t*)seg_dst, T, R);
  return (int)cudaGetLastError();
}
