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
// The design for bf16 updates (variants 1 and 2):
// - mma.sync m16n8k16 bf16 products with fp32 accumulators in registers
//   (mma_tile.cuh).  At the main path's busiest level the products need
//   about 0.011 ms on the tensor cores against a 0.18 ms byte bound, so
//   wgmma's higher rate would buy nothing measurable here.
// - One CTA per piece of a dst segment and dst tile, or per piece and
//   128 x 64 half at T = 128 when the wrapper finds fewer pieces than
//   SMs.  Its warps share the T x BN output, each warp a 32 x BN/2 block
//   (16 x 32 at T = 32), kept in registers over all pairs of the piece.
//   A piece is the whole segment unless the segment is longer than the
//   chunk's piece length (numeric/leftlook.ll_pieces): the longest
//   segment would otherwise hold the whole chunk (the dense tail's top
//   tiles have 5-10x the mean).  Then one read-modify-write of the dst in
//   fp32; a cut segment's pieces leave their sums in scratch slots, and
//   the last piece to arrive (an atomic counter) adds them in piece
//   order.  Within a chunk each dst tile lies in one segment, so no two
//   segments share a dst, and every sum runs in a fixed order: runs
//   repeat bit for bit.  Chunks run in order on one stream because a dst
//   may recur in a later chunk.
// - The pairs' 32-deep k slices stream through a ring of 3 stages in
//   dynamic shared memory by cp.async (16 bytes a thread), two stages
//   ahead of the products, the next pair's indices fetched one pair
//   ahead.  A T = 128 stage is 20 KB (variant 2) or 30 KB (variant 1)
//   with its rows padded against bank conflicts, so a CTA keeps 40-60 KB
//   in flight, two CTAs an SM.  (A fourth stage in unpadded, permuted
//   rows measured 22-26 % slower on an H100: PERF.md §6.)
// - a in fp32 (variant 1, from the pool) is copied as stored and rounded
//   to bf16 as its fragment is loaded, after its columns are scaled by d
//   (LDL^T): exactly where the twin rounds it.  A bf16 operand (the
//   wrapper's per-chunk cache) goes through ldmatrix.
// - The row window: rows of a outside [rl, rl + H) enter as zeros (the
//   copy reads nothing for them), and a warp issues no mma for a 16-row
//   group wholly outside the window.  Any rl and any H in 1..T work.
//
// fp32 updates (variant 0: update_dtype None, the shift-invert LDL^T
// path) keep the first design's FMA body below, unchanged: the port's
// fp32 is full fp32, with TF32 off, so it has no tensor-core route here.

#include <type_traits>

#include "mma_tile.cuh"

namespace {

// One chunk as both kernels read it (int64 tables on the device).
struct Chunk {
  float* pool;
  const void* a_src;
  const void* b_src;
  const int64_t* seg_ptr;  // [nseg + 1] pair offsets of the dst segments
  const int64_t* seg_dst;  // [nseg] the dst tile of each segment
  const int64_t* pair_a;
  const int64_t* pair_b;
  const int64_t* pair_rl;  // first row of each pair's window
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
  int H;
};

// ---------------------------------------------------------------------------
// variant 0: fp32 operands on the CUDA cores (the first design)

constexpr int BK = 32;

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

// ---------------------------------------------------------------------------
// variants 1-3: bf16 products on the tensor cores

template <int T, int BN, bool A_F32, bool SCALED>
struct Tc {
  static constexpr int KS = T / BK;  // k slices a pair
  static constexpr int STAGES = 3;
  static constexpr int WARPS_M = T == 32 ? 2 : T / 32;
  static constexpr int WARPS_N = T == 32 ? 1 : 2;
  static constexpr int NT = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = T / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int EA = A_F32 ? 4 : 2, EB = 2;
  static constexpr int CA = BK * EA / 16;  // 16-byte copies a row of a
  static constexpr int CB = BK * EB / 16;
  static constexpr int SA = T * mma_tile::LD * EA;  // bytes a stage
  static constexpr int SB = BN * mma_tile::LD * EB;
  static constexpr int SD = SCALED ? BK * 4 : 0;
  static constexpr int STAGE = SA + SB + SD;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(NI % 2 == 0 && MI >= 1, "warp tile");
};

template <int T, int BN, bool A_F32, bool SCALED>
__global__ void __launch_bounds__((Tc<T, BN, A_F32, SCALED>::NT))
ll_mma_kernel(const Chunk x) {
  const int64_t* __restrict__ pair_a = x.pair_a;
  const int64_t* __restrict__ pair_b = x.pair_b;
  const int64_t* __restrict__ pair_rl = x.pair_rl;
  const int64_t* __restrict__ pair_k = x.pair_k;
  const float* __restrict__ d = x.d;
  const int H = x.H;
  using C = Tc<T, BN, A_F32, SCALED>;
  using TA = std::conditional_t<A_F32, float, __nv_bfloat16>;
  using TB = __nv_bfloat16;
  constexpr int64_t TT = (int64_t)T * T;
  constexpr int LD = mma_tile::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int st_rl[C::STAGES];  // row window of each stage's pair

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
  int crl = (int)__ldg(pair_rl + p0);
  int64_t ck = SCALED ? __ldg(pair_k + p0) : 0;
  int64_t na = 0, nb = 0, nk = 0;
  int nrl = 0;
  if (p0 + 1 < p_end) {
    na = __ldg(pair_a + p0 + 1);
    nb = __ldg(pair_b + p0 + 1);
    nrl = (int)__ldg(pair_rl + p0 + 1);
    if (SCALED) nk = __ldg(pair_k + p0 + 1);
  }

  auto issue = [&](int stage) {
    unsigned char* base = smem + stage * C::STAGE;
    const int k0 = iks * BK;
    const TA* a = (const TA*)x.a_src + ca * TT + k0;
    for (int q = tid; q < T * C::CA; q += C::NT) {
      const int r = q / C::CA, k = q % C::CA * (16 / C::EA);
      mma_tile::cp_async16(base + (r * LD + k) * C::EA, a + (int64_t)r * T + k,
                           r >= crl && r < crl + H);
    }
    const TB* b = (const TB*)x.b_src + cb * TT + (int64_t)n0 * T + k0;
    for (int q = tid; q < BN * C::CB; q += C::NT) {
      const int r = q / C::CB, k = q % C::CB * 8;
      mma_tile::cp_async16(base + C::SA + (r * LD + k) * 2,
                           b + (int64_t)r * T + k, true);
    }
    if constexpr (SCALED) {
      if (tid < BK / 4)
        mma_tile::cp_async16(base + C::SA + C::SB + tid * 16,
                             d + ck * T + k0 + tid * 4, true);
    }
    if (tid == 0) st_rl[stage] = crl;
    if (++iks == C::KS) {
      iks = 0;
      if (++ip < p_end) {
        ca = na;
        cb = nb;
        crl = nrl;
        ck = nk;
        if (ip + 1 < p_end) {
          na = __ldg(pair_a + ip + 1);
          nb = __ldg(pair_b + ip + 1);
          nrl = (int)__ldg(pair_rl + ip + 1);
          if (SCALED) nk = __ldg(pair_k + ip + 1);
        }
      }
    }
  };

  float acc[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

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
    const int rl = st_rl[stage];
    bool live[C::MI];
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
      const int g0 = wm * C::WM + 16 * mi;
      live[mi] = g0 < rl + H && g0 + 16 > rl;
    }
    const float* dk = SCALED ? (const float*)(base + C::SA + C::SB) : nullptr;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
      mma_tile::warp_mma_k16<C::MI, C::NI, A_F32>(
          acc, base, base + C::SA, wm * C::WM, wn * C::WN, kk, dk, live);
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

template <int T, int BN, bool A_F32, bool SCALED>
cudaError_t launch_mma(const Chunk& x, cudaStream_t stream) {
  using C = Tc<T, BN, A_F32, SCALED>;
  auto kernel = ll_mma_kernel<T, BN, A_F32, SCALED>;
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

template <int T, bool A_F32, bool SCALED>
cudaError_t dispatch_bn(const Chunk& x, int bn, cudaStream_t s) {
  if (bn == T) return launch_mma<T, T, A_F32, SCALED>(x, s);
  if constexpr (T == 128) {
    if (bn == 64) return launch_mma<128, 64, A_F32, SCALED>(x, s);
  }
  return cudaErrorInvalidValue;
}

template <bool A_F32, bool SCALED>
cudaError_t dispatch_mma(const Chunk& x, int T, int bn, cudaStream_t s) {
  switch (T) {
    case 32: return dispatch_bn<32, A_F32, SCALED>(x, bn, s);
    case 64: return dispatch_bn<64, A_F32, SCALED>(x, bn, s);
    case 128: return dispatch_bn<128, A_F32, SCALED>(x, bn, s);
    default: return cudaErrorInvalidValue;
  }
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
      return (int)(sc ? dispatch_mma<true, true>(x, T, bn, s)
                      : dispatch_mma<true, false>(x, T, bn, s));
    case 2:
      return (int)dispatch_mma<false, false>(x, T, bn, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
