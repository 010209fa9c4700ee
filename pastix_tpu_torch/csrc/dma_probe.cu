// K13: random-address copies of S consecutive tiles from device memory
// into shared memory, D copies a step, over reps x steps steps; row 0 of
// every copy's first tile and the last row of its last tile are added
// into a (2, D, T) fp32 accumulator.
//
// Replaces the Pallas probes of exp_dma.py, probe and probe_sub: per grid
// step of (reps, steps) the TPU kernel keeps the D copies of the next step
// (view[idx[i+1, d] : +S], idx reused across repeats) in flight while it
// waits on the current step's, double-buffered in a (2, D, S, rows, T)
// VMEM scratch, and adds row 0 of copy 0's first tile to a (1, T)
// accumulator.  The probe times copies; that row is all it computes.
// Here the accumulator starts at zero (the reference never zeroes its
// scratch, so its output is undefined), and every copy adds its first row
// into out[0, d] and its last row into out[1, d], so that a kernel that
// skipped a copy, or the end of one, could not pass the check against
// reps * sum_i view[idx[i, d], 0, :] and reps * sum_i view[idx[i, d] + S
// - 1, rows - 1, :]: out[0, 0] is the reference's output.
//
// The reference's buffer does not fit: (2, D, S, 128, 128) fp32 is 256 KB
// at S = 1, D = 2 and 8 MB at S = 32, and one SM has 227 KB of shared
// memory.  So a copy is cut into equal pieces of at most `piece` bytes
// (4 KB unless the caller asks otherwise; the bytes are gcd(copy bytes,
// piece)), each one bulk TMA copy (cp.async.bulk, completion counted on
// its stage's mbarrier), and the pieces stream through a ring of W = 2 D
// stages.
//
// What "D in flight" means on the card: per CTA, D copies in flight, each
// double-buffered.  Pieces go in the order (step, piece k, copy d), so
// the ring holds pieces k and k + 1 of each of the step's D copies (with
// one piece a copy: the D copies of the current step and of the next, as
// the reference's double buffer).  One thread (warp 1) issues a piece as
// soon as its stage is free; warp 0 waits for each piece in turn, adds
// its rows and frees the stage.  So D sets the depth: a CTA keeps 2 D
// pieces in flight, 8 D KB at 4 KB pieces.  The grid has one CTA per SM
// (132 on an H100) unless the caller asks for fewer, CTA b taking steps
// b, b + CTAs, ... of the reps x steps, so that the card walks the steps
// in the reference's order and a step's copies are read again only one
// repeat later (with contiguous shares, CTAs 33 apart read the same
// steps at once and the probe reported up to 7.5 TB/s, from L2, on an
// H100).  The card holds CTAs x 2 D pieces in flight.  Rows that vary D,
// the CTA count or the piece size thus vary the copies and the bytes in
// flight: by Little's law a rate that grows with the bytes in flight is
// held by latency, one that grows with the piece size at the same count
// by a cost per copy, and one that grows with neither by bandwidth.
// Each CTA sums its rows in shared memory and adds them into the result
// with atomics (the sum order differs from the plain version's; the
// values are exact copies).
//
// What bounds it: bytes, every copy read once over the 3.35 TB/s of
// device memory, as the reference reports GB/s.  A probe whose distinct
// copies of one repeat fit in the 50 MB L2 may read repeats from L2.

#include "common.cuh"

namespace {

constexpr int MAX_RING = 48;  // stages: D <= 24
constexpr int NTHREADS = 64;  // warp 0 reads, warp 1 issues

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// the arrival of the one issuing thread, with the bytes the copy brings
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// a plain arrival: the reader is done with the stage
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct Probe {
  const float* view;  // (N, rows, T)
  const int* idx;     // (steps, D): first tile of each step's copies
  float* out;         // (2, D, T), zeroed by the host
  int64_t tile;       // rows * T floats
  int T, D, steps;
  int64_t total;      // reps * steps
  int S, piece;       // tiles a copy; bytes a piece
};

// Where a piece stands in the order (step, piece k, copy d), d the
// fastest, and in the ring; advanced one piece at a time, so that the
// loops do no 64-bit division (with several a piece, a CTA took 0.87 us
// a piece on an H100)
struct Cursor {
  int stage = 0, phase = 0, k = 0, d = 0;
  int64_t i = 0;  // row of idx: the step modulo steps

  // hop: the grid modulo steps (a CTA takes every grid-th step)
  __device__ void next(const Probe& p, int W, int ppc, int64_t hop) {
    if (++stage == W) stage = 0, phase ^= 1;
    if (++d == p.D) {
      d = 0;
      if (++k == ppc) {
        k = 0;
        i += hop;
        if (i >= p.steps) i -= p.steps;
      }
    }
  }
};

// Warp 1's lane 0 issues the pieces as fast as the ring frees stages;
// warp 0 waits for each piece in turn, adds its rows and frees its stage
// (full[s]: the copy has landed; empty[s]: warp 0 is done with it), so
// neither waits on the other's bookkeeping
__global__ void __launch_bounds__(NTHREADS) dma_probe_kernel(Probe p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[MAX_RING], empty[MAX_RING];
  const int ppc = (int)(p.S * p.tile * 4 / p.piece);  // pieces a copy
  const int W = 2 * p.D;
  const int DT = p.D * p.T;
  float* acc = reinterpret_cast<float*>(smem + (size_t)W * p.piece);
  // steps blockIdx.x, + gridDim.x, ...: the grid walks the steps in the
  // reference's order, so a step's copies are read again one repeat
  // later, as there
  const int64_t nsteps = (p.total - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int64_t nq = nsteps * p.D * ppc;  // this CTA's pieces
  const int64_t hop = gridDim.x % p.steps;
  const int lane = threadIdx.x % 32;

  for (int e = threadIdx.x; e < 2 * DT; e += NTHREADS) acc[e] = 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W; ++s) mbar_init(&full[s]), mbar_init(&empty[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Cursor c;
  c.i = blockIdx.x % p.steps;  // idx is reused across repeats
  if (threadIdx.x == 32) {  // the issuer
    const unsigned char* view =
        reinterpret_cast<const unsigned char*>(p.view);
    for (int64_t q = 0; q < nq; ++q) {
      if (q >= W) mbar_wait(&empty[c.stage], (uint32_t)(c.phase ^ 1));
      const unsigned char* src =
          view + ((int64_t)p.idx[c.i * p.D + c.d] * p.tile * 4 +
                  (int64_t)c.k * p.piece);
      mbar_expect(&full[c.stage], (uint32_t)p.piece);
      bulk_copy(smem + (size_t)c.stage * p.piece, src, (uint32_t)p.piece,
                &full[c.stage]);
      c.next(p, W, ppc, hop);
    }
  } else if (threadIdx.x < 32) {  // the reader
    for (int64_t q = 0; q < nq; ++q) {
      mbar_wait(&full[c.stage], (uint32_t)c.phase);
      const float* piece =
          reinterpret_cast<const float*>(smem + (size_t)c.stage * p.piece);
      if (c.k == 0)  // the copy's first row
        for (int t = lane; t < p.T; t += 32) acc[c.d * p.T + t] += piece[t];
      if (c.k == ppc - 1) {  // the copy's last row
        const float* row = piece + p.piece / 4 - p.T;
        for (int t = lane; t < p.T; t += 32)
          acc[DT + c.d * p.T + t] += row[t];
      }
      // every lane's reads have returned: the next copy into the stage
      // may start
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[c.stage]);
      c.next(p, W, ppc, hop);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * DT; e += NTHREADS)
    atomicAdd(p.out + e, acc[e]);
}

int64_t gcd(int64_t a, int64_t b) { return b ? gcd(b, a % b) : a; }

}  // namespace

// view: contiguous fp32 (N, rows, T), 16-byte aligned; idx: int32
// (steps, D), each in [0, N - S], D at most MAX_RING / 2; out: fp32
// (2, D, T), zeroed; ctas: CTAs of the grid, 0 for one per SM; piece:
// bytes a bulk copy at most.  A piece (gcd(copy bytes, piece)) must be a
// multiple of 16 bytes (the bulk copy's unit) and of a row, and the ring
// of 2 D pieces must fit in shared memory.
extern "C" int pastix_dma_probe(const void* view, const void* idx, void* out,
                                int rows, int T, int steps, int D, int S,
                                long long reps, int ctas, int piece,
                                void* stream) {
  if (steps <= 0 || D <= 0 || 2 * D > MAX_RING || S <= 0 || reps <= 0 ||
      T <= 0 || rows <= 0 || ctas < 0 || piece <= 0)
    return (int)cudaErrorInvalidValue;
  Probe p;
  p.view = (const float*)view;
  p.idx = (const int*)idx;
  p.out = (float*)out;
  p.tile = (int64_t)rows * T;
  p.T = T;
  p.D = D;
  p.steps = steps;
  p.total = reps * steps;
  p.S = S;
  p.piece = (int)gcd((int64_t)S * rows * T * 4, piece);
  if (p.piece % 16 != 0 || p.piece % (T * 4) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t shmem = (size_t)2 * D * p.piece + (size_t)2 * D * T * 4;
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (shmem + 2 * MAX_RING * sizeof(uint64_t) > (size_t)smem_max)
    return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(dma_probe_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)shmem);
  if (e != cudaSuccess) return (int)e;
  const int64_t want = ctas > 0 ? ctas : sms;
  const int64_t grid = p.total < want ? p.total : want;
  dma_probe_kernel<<<(unsigned)grid, NTHREADS, shmem,
                     (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
