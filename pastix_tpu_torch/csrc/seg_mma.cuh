// The tensor-core body of the segment-walking E2 kernels with bf16
// updates: K1 (ll_gemm_scatter.cu, left-looking, with row windows; K6
// launches it with a window height a pair), K3
// (pipelined_gemm_scatter.cu, right-looking, full tiles; K5, K9, K10 and
// K11 launch it on their own operands) and K12 (cache_gemm_scatter.cu, in
// steps of pairs).  pool[dst] -= sum over a piece of a dst segment of
// op(a diag(d)) . op(b)^T, products by mma.sync m16n8k16 (bf16 in, fp32
// accumulators in registers; mma_tile.cuh).
//
// - One CTA per piece of a dst segment and BN dst columns (T, or 64 at
//   T = 128).  Its warps share the T x BN output, each warp a 32 x BN/2
//   block (16 x 32 at T = 32), kept in registers over all pairs of the
//   piece.  A piece is the whole segment unless the segment is longer
//   than the chunk's piece length (numeric/leftlook.ll_pieces): the
//   longest segment would otherwise hold the whole chunk.  Then one
//   read-modify-write of the dst in fp32; a cut segment's pieces leave
//   their sums in scratch slots, and the last piece to arrive (an atomic
//   counter) adds them in piece order.  Within a chunk each dst tile lies
//   in one segment, so no two segments share a dst, and every sum runs in
//   a fixed order: runs repeat bit for bit.  Chunks run in order on one
//   stream because a dst may recur in a later chunk.
// - The pairs' 32-deep k slices stream through a ring of 3 stages in
//   dynamic shared memory by cp.async (16 bytes a thread), two stages
//   ahead of the products, the next pair's indices fetched one pair
//   ahead.  Rows are padded against bank conflicts (mma_tile::LD).
// - Operands: a and b each bf16 (ldmatrix) or fp32 (copied as stored,
//   rounded to bf16 as the fragment is loaded); SCALED multiplies a's
//   columns by d[pair_k * T + k] first (round(a d) from fp32,
//   round(round(a) d) from bf16), exactly where the twins round.
// - WINDOW (K1, K6): rows of a outside [rl, rl + h) enter as zeros (the
//   copy reads nothing for them), and a warp issues no mma for a 16-row
//   group wholly outside the window; a group the window cuts runs whole,
//   on the zeros.  h is the launch's H (K1: one height a chunk) or each
//   pair's pair_h (K6: heights T/4..T in one chunk), staged beside rl.
//   Without it every pair is a full tile.
// - STEP (K12): the pairs come in steps, pair_last set at each step's
//   last pair, and pieces end at step boundaries.  A step's products are
//   summed in a step accumulator (STEP_DOT2: one chain over the step's
//   depth; STEP_LOOP: each pair's T-deep chain in a pair accumulator,
//   added to the step's), which is then added to the piece's sum: the
//   reference's order, in three fragment sets a thread (seg_mma_steps,
//   bounded to two CTAs an SM).
#pragma once

#include <type_traits>

#include "mma_tile.cuh"

namespace {

// One chunk as the E2 kernels read it (int64 tables on the device).
struct Chunk {
  float* pool;
  const void* a_src;
  const void* b_src;
  const int64_t* seg_ptr;  // [nseg + 1] pair offsets of the dst segments
  const int64_t* seg_dst;  // [nseg] the dst tile of each segment
  const int64_t* pair_a;
  const int64_t* pair_b;
  const int64_t* pair_rl;  // first row of each pair's window (WINDOW)
  const int64_t* pair_k;   // source column of each pair (d's row)
  const float* d;
  // the tensor-core kernel's pieces: piece p runs the pairs
  // piece_ptr[p]..piece_ptr[p+1] of segment piece_seg[p]; segment s has
  // the pieces seg_piece_ptr[s]..seg_piece_ptr[s+1]; a piece of a
  // segment cut in more than one writes its partial sum to scratch slot
  // piece_slot[p], and count holds one arrival counter per segment and
  // column block (zero between launches)
  const int64_t* piece_ptr;
  const int64_t* piece_seg;
  const int64_t* seg_piece_ptr;
  const int64_t* piece_slot;
  float* scratch;
  int* count;
  int64_t nseg;
  int64_t npiece;
  int H;  // row-window height of every pair (WINDOW, pair_h null)
  const int64_t* pair_last;  // nonzero at each step's last pair (STEP)
  const int64_t* pair_h;  // each pair's window height (WINDOW; null: H)
};

constexpr int BK = 32;  // k slice
// how a piece's pairs are summed: one chain over all of them (K1, K3), or
// in steps (K12; pair_last ends a step)
constexpr int ONE_SUM = 0, STEP_DOT2 = 1, STEP_LOOP = 2;

// d += s, then s = 0 (a thread's fragments of one accumulator set)
template <int MI, int NI>
__device__ __forceinline__ void drain(float (&d)[MI][NI][4],
                                      float (&s)[MI][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[mi][ni][e] += s[mi][ni][e];
        s[mi][ni][e] = 0.f;
      }
}

template <int T, int BN, bool A_F32, bool B_F32, bool SCALED>
struct Tc {
  static constexpr int KS = T / BK;  // k slices a pair
  static constexpr int STAGES = 3;
  static constexpr int WARPS_M = T == 32 ? 2 : T / 32;
  static constexpr int WARPS_N = T == 32 ? 1 : 2;
  static constexpr int NT = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = T / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int EA = A_F32 ? 4 : 2, EB = B_F32 ? 4 : 2;
  static constexpr int CA = BK * EA / 16;  // 16-byte copies a row of a
  static constexpr int CB = BK * EB / 16;
  static constexpr int SA = T * mma_tile::LD * EA;  // bytes a stage
  static constexpr int SB = BN * mma_tile::LD * EB;
  static constexpr int SD = SCALED ? BK * 4 : 0;
  static constexpr int STAGE = SA + SB + SD;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(NI % 2 == 0 && MI >= 1, "warp tile");
};

// the body of a CTA (the kernels below)
template <int T, int BN, bool A_F32, bool B_F32, bool SCALED, bool WINDOW,
          int STEP>
__device__ __forceinline__ void seg_mma_body(const Chunk x) {
  const int64_t* __restrict__ pair_a = x.pair_a;
  const int64_t* __restrict__ pair_b = x.pair_b;
  const int64_t* __restrict__ pair_rl = x.pair_rl;
  const int64_t* __restrict__ pair_k = x.pair_k;
  const int64_t* __restrict__ pair_h = x.pair_h;
  const float* __restrict__ d = x.d;
  // a pair's window height: its own (pair_h, K6) or the launch's (K1)
  auto height = [&](int64_t p) {
    return pair_h != nullptr ? (int)__ldg(pair_h + p) : x.H;
  };
  using C = Tc<T, BN, A_F32, B_F32, SCALED>;
  using TA = std::conditional_t<A_F32, float, __nv_bfloat16>;
  using TB = std::conditional_t<B_F32, float, __nv_bfloat16>;
  constexpr int64_t TT = (int64_t)T * T;
  constexpr int LD = mma_tile::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int st_rl[C::STAGES];  // row window of each stage's pair
  __shared__ int st_h[C::STAGES];
  __shared__ int st_end[C::STAGES];  // a stage that ends a step (STEP)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int64_t piece = blockIdx.x;
  const int64_t seg = x.piece_seg[piece];
  const int n0 = blockIdx.y * BN;  // the CTA's first dst column
  const int64_t p0 = x.piece_ptr[piece], p_end = x.piece_ptr[piece + 1];
  const int total = (int)(p_end - p0) * C::KS;

  // the producer's position (pair ip, k slice iks), its pair's indices
  // and the next pair's, fetched one pair ahead
  int64_t ip = p0;
  int iks = 0;
  int64_t ca = __ldg(pair_a + p0), cb = __ldg(pair_b + p0);
  int crl = WINDOW ? (int)__ldg(pair_rl + p0) : 0;
  int ch = WINDOW ? height(p0) : T;
  int64_t ck = SCALED ? __ldg(pair_k + p0) : 0;
  bool cl = STEP != ONE_SUM && __ldg(x.pair_last + p0) != 0;
  int64_t na = 0, nb = 0, nk = 0;
  int nrl = 0, nh = T;
  bool nl = false;
  if (p0 + 1 < p_end) {
    na = __ldg(pair_a + p0 + 1);
    nb = __ldg(pair_b + p0 + 1);
    if (WINDOW) {
      nrl = (int)__ldg(pair_rl + p0 + 1);
      nh = height(p0 + 1);
    }
    if (SCALED) nk = __ldg(pair_k + p0 + 1);
    if (STEP != ONE_SUM) nl = __ldg(x.pair_last + p0 + 1) != 0;
  }

  auto issue = [&](int stage) {
    unsigned char* base = smem + stage * C::STAGE;
    const int k0 = iks * BK;
    const TA* a = (const TA*)x.a_src + ca * TT + k0;
    for (int q = tid; q < T * C::CA; q += C::NT) {
      const int r = q / C::CA, k = q % C::CA * (16 / C::EA);
      mma_tile::cp_async16(base + (r * LD + k) * C::EA, a + (int64_t)r * T + k,
                           !WINDOW || (r >= crl && r < crl + ch));
    }
    const TB* b = (const TB*)x.b_src + cb * TT + (int64_t)n0 * T + k0;
    for (int q = tid; q < BN * C::CB; q += C::NT) {
      const int r = q / C::CB, k = q % C::CB * (16 / C::EB);
      mma_tile::cp_async16(base + C::SA + (r * LD + k) * C::EB,
                           b + (int64_t)r * T + k, true);
    }
    if constexpr (SCALED) {
      if (tid < BK / 4)
        mma_tile::cp_async16(base + C::SA + C::SB + tid * 16,
                             d + ck * T + k0 + tid * 4, true);
    }
    if (WINDOW && tid == 0) {
      st_rl[stage] = crl;
      st_h[stage] = ch;
    }
    if (STEP != ONE_SUM && tid == 0) st_end[stage] = cl && iks == C::KS - 1;
    if (++iks == C::KS) {
      iks = 0;
      if (++ip < p_end) {
        ca = na;
        cb = nb;
        crl = nrl;
        ch = nh;
        ck = nk;
        cl = nl;
        if (ip + 1 < p_end) {
          na = __ldg(pair_a + ip + 1);
          nb = __ldg(pair_b + ip + 1);
          if (WINDOW) {
            nrl = (int)__ldg(pair_rl + ip + 1);
            nh = height(ip + 1);
          }
          if (SCALED) nk = __ldg(pair_k + ip + 1);
          if (STEP != ONE_SUM) nl = __ldg(x.pair_last + ip + 1) != 0;
        }
      }
    }
  };

  // acc: the piece's sum; STEP: sacc the step's, pacc (STEP_LOOP) the
  // pair's, which the products go into
  float acc[C::MI][C::NI][4], sacc[C::MI][C::NI][4], pacc[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0.f;
        if (STEP != ONE_SUM) sacc[mi][ni][e] = 0.f;
        if (STEP == STEP_LOOP) pacc[mi][ni][e] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < total) issue(s);
    mma_tile::cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    mma_tile::cp_async_wait<C::STAGES - 2>();
    // stage it has landed for every thread, and every thread is done
    // with stage it - 1, which the issue below refills
    __syncthreads();
    if (it + C::STAGES - 1 < total) issue((it + C::STAGES - 1) % C::STAGES);
    mma_tile::cp_async_commit();
    const int stage = it % C::STAGES;
    const unsigned char* base = smem + stage * C::STAGE;
    bool live[C::MI];
    if constexpr (WINDOW) {
      const int rl = st_rl[stage], h = st_h[stage];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi) {
        const int g0 = wm * C::WM + 16 * mi;
        live[mi] = g0 < rl + h && g0 + 16 > rl;
      }
    } else {
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi) live[mi] = true;
    }
    const float* dk = SCALED ? (const float*)(base + C::SA + C::SB) : nullptr;
    auto slice = [&](float (&t)[C::MI][C::NI][4]) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16)
        mma_tile::warp_mma_k16<C::MI, C::NI, A_F32, B_F32>(
            t, base, base + C::SA, wm * C::WM, wn * C::WN, kk, dk, live);
    };
    if constexpr (STEP == STEP_LOOP)
      slice(pacc);
    else if constexpr (STEP == STEP_DOT2)
      slice(sacc);
    else
      slice(acc);
    if constexpr (STEP != ONE_SUM) {
      // read before the next iteration's barrier, after which the stage
      // and its flag are refilled
      if (STEP == STEP_LOOP && it % C::KS == C::KS - 1) drain(sacc, pacc);
      if (st_end[stage]) drain(acc, sacc);
    }
  }
  mma_tile::cp_async_wait<0>();

  // a segment cut in pieces: each piece leaves its partial sum in its
  // slot, and the last to arrive adds them all, in piece order
  const int64_t sp0 = x.seg_piece_ptr[seg], sp1 = x.seg_piece_ptr[seg + 1];
  constexpr int E = C::MI * C::NI * 4;  // accumulators a thread
  if (sp1 - sp0 > 1) {
    const int64_t ny = T / BN;
    const int64_t stride = (int64_t)E * C::NT;
    float* mine = x.scratch + (x.piece_slot[piece] * ny + blockIdx.y) * stride;
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[((mi * C::NI + ni) * 4 + e) * C::NT + tid] = acc[mi][ni][e];
    __threadfence();
    __syncthreads();
    __shared__ int s_last;
    int* cnt = x.count + seg * ny + blockIdx.y;
    if (tid == 0) s_last = atomicAdd(cnt, 1) == sp1 - sp0 - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    for (int64_t q = sp0; q < sp1; ++q) {
      const float* part =
          x.scratch + (x.piece_slot[q] * ny + blockIdx.y) * stride + tid;
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mi][ni][e] += __ldcg(part + ((mi * C::NI + ni) * 4 + e) * C::NT);
    }
    if (tid == 0) *cnt = 0;  // zero again for the next launch
  }

  // one read-modify-write of the dst (the m16n8 C layout: rows g and
  // g + 8, columns c and c + 1 of each 16 x 8 block)
  float* dst = x.pool + x.seg_dst[seg] * TT;
  const int lane = tid & 31;
  const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * C::WM + 16 * mi + g + 8 * h;
        const int col = n0 + wn * C::WN + 8 * ni + c;
        float2* p = (float2*)(dst + (int64_t)r * T + col);
        float2 v = *p;
        v.x -= acc[mi][ni][2 * h];
        v.y -= acc[mi][ni][2 * h + 1];
        *p = v;
      }
}

template <int T, int BN, bool A_F32, bool B_F32, bool SCALED, bool WINDOW>
__global__ void __launch_bounds__((Tc<T, BN, A_F32, B_F32, SCALED>::NT))
seg_mma_kernel(const Chunk x) {
  seg_mma_body<T, BN, A_F32, B_F32, SCALED, WINDOW, ONE_SUM>(x);
}

// K12's step mode, bf16 operands: at most 128 registers a thread, so
// that two CTAs share an SM (STEP_LOOP's three fragment sets took 158
// and one CTA an SM without the bound; no spills with it)
template <int T, int BN, int STEP>
__global__ void __launch_bounds__((Tc<T, BN, false, false, false>::NT), 2)
seg_mma_steps(const Chunk x) {
  seg_mma_body<T, BN, false, false, false, false, STEP>(x);
}

template <int T, int BN, bool A_F32, bool B_F32, bool SCALED, bool WINDOW,
          int STEP>
auto seg_kernel() {
  if constexpr (STEP == ONE_SUM)
    return seg_mma_kernel<T, BN, A_F32, B_F32, SCALED, WINDOW>;
  else
    return seg_mma_steps<T, BN, STEP>;
}

template <int T, int BN, bool A_F32, bool B_F32, bool SCALED, bool WINDOW,
          int STEP = ONE_SUM>
cudaError_t launch_mma(const Chunk& x, cudaStream_t stream) {
  static_assert(STEP == ONE_SUM || !(A_F32 || B_F32 || SCALED || WINDOW),
                "the step mode takes unscaled bf16 operands");
  using C = Tc<T, BN, A_F32, B_F32, SCALED>;
  auto kernel = seg_kernel<T, BN, A_F32, B_F32, SCALED, WINDOW, STEP>();
  static bool sized = false;  // once per instantiation
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  dim3 grid((unsigned)x.npiece, T / BN);
  kernel<<<grid, C::NT, C::SMEM, stream>>>(x);
  return cudaGetLastError();
}

// launch_mma at a tile size and column block known only at run time: bn
// is T, or 64 at T = 128
template <bool A_F32, bool B_F32, bool SCALED, bool WINDOW>
cudaError_t dispatch_mma(const Chunk& x, int T, int bn, cudaStream_t s) {
  switch (T * 1000 + bn) {
    case 32032: return launch_mma<32, 32, A_F32, B_F32, SCALED, WINDOW>(x, s);
    case 64064: return launch_mma<64, 64, A_F32, B_F32, SCALED, WINDOW>(x, s);
    case 128128:
      return launch_mma<128, 128, A_F32, B_F32, SCALED, WINDOW>(x, s);
    case 128064:
      return launch_mma<128, 64, A_F32, B_F32, SCALED, WINDOW>(x, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
