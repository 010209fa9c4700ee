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
// its last.  Here the host fills the cache buffer per chunk (buf[:nu] =
// xab[cu]; no pair of this kernel reads the zero slot), as the reference
// gathers Xc in XLA outside its kernel, then launches once per chunk.
//
// K11, exp_cache.py's gemm_scatter_vcache (mk_kernel), reads the same
// kind of cache with one pair a step: numeric/cache.py launches K3
// (pipelined_gemm_scatter.cu) on the filled buffer for it, so this file
// holds K12 only.
//
// What bounds it on an H100 at T = 128: a pair is 2 T^3 = 4.2 MFLOP on
// two 32 KB bf16 tiles that repeat across the chunk's pairs.  Counted as
// the level's work (each distinct stream tile read once, each dst tile
// read and written once) it is bound by bytes: 0.656 ms on the busiest
// level of poisson_3d(64) (38,008 pairs), 64 FLOP a byte read against
// the 295 at which the bf16 tensor cores (989 TFLOP/s) would outrun
// device memory.  The reference keeps the chunk's Xc in VMEM; the card's
// analog is the 50 MB L2, which holds the buffer by size (CT x 32 KB):
// it is written just before the launch and the chunk's CTAs read it
// while it is resident there.  So what has to fall is each pair's
// latency and the bytes in flight, as for K3.
//
// Design: the tensor-core body of K1 and K3 (seg_mma.cuh) in its step
// mode.  The host drops the null pairs (their product is exactly zero)
// and marks each step's last real pair; the CTA runs a piece of a dst
// segment on mma.sync with the operands streaming through a 3-stage
// cp.async ring (ldmatrix from bf16), sums each step in a step
// accumulator (dot2: one chain over the step's pairs; loop: each pair's
// chain in a pair accumulator, added to the step's), adds the step to
// the piece's sum, and writes the dst once.  Segments are cut into
// pieces at step boundaries only (numeric/cache.mp_plan, by
// leftlook.ll_pieces' rule), so the longest segment no longer holds its
// whole chunk; a cut segment's last piece adds the partial sums in piece
// order, so runs repeat bit for bit.  A CTA takes 64 dst columns at
// T = 128 (128 x 64 halves): the three accumulator sets then take 96
// floats a thread, and the kernel is bounded to 128 registers so that
// two CTAs share an SM (without the bound loop took 158 and ran 1.3x
// slower); at T = 32 and 64 the whole tile.  An L2 persistence window
// (cudaAccessPolicyWindow) over the buffer is later work: it is a
// device-wide setting.

#include "seg_mma.cuh"

namespace {

template <int STEP>
cudaError_t dispatch_steps(const Chunk& x, int T, cudaStream_t s) {
  switch (T) {
    case 32:
      return launch_mma<32, 32, false, false, false, false, STEP>(x, s);
    case 64:
      return launch_mma<64, 64, false, false, false, false, STEP>(x, s);
    case 128:
      return launch_mma<128, 64, false, false, false, false, STEP>(x, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K12 over one chunk's real pairs (null pairs dropped), in step order.
// buf: the chunk's (CT, T, T) bf16 cache; seg_ptr: pair offsets of the
// nseg dst segments; pos_a, pos_b: each pair's cache slots; pair_last:
// nonzero at each step's last pair; the piece tables, scratch and count
// as in seg_mma.cuh's Chunk, pieces ending at step boundaries; dot2 = 1:
// one sum over a step's pairs, 0: each pair's sum added (loop).
extern "C" int pastix_mp_gemm_scatter(
    void* pool, const void* buf, const void* seg_ptr, const void* seg_dst,
    const void* pos_a, const void* pos_b, const void* pair_last,
    const void* piece_ptr, const void* piece_seg, const void* seg_piece_ptr,
    const void* piece_slot, void* scratch, void* count, long long nseg,
    long long npiece, int T, int dot2, void* stream) {
  if (nseg <= 0) return 0;
  if (nseg > 0x7fffffffLL || npiece > 0x7fffffffLL || npiece < nseg ||
      pair_last == nullptr || piece_ptr == nullptr || count == nullptr)
    return (int)cudaErrorInvalidValue;
  auto I = [](const void* p) { return (const int64_t*)p; };
  const Chunk x{(float*)pool, buf, buf, I(seg_ptr), I(seg_dst), I(pos_a),
                I(pos_b), nullptr, nullptr, nullptr, I(piece_ptr),
                I(piece_seg), I(seg_piece_ptr), I(piece_slot),
                (float*)scratch, (int*)count, nseg, npiece, T,
                I(pair_last)};
  auto s = (cudaStream_t)stream;
  return (int)(dot2 ? dispatch_steps<STEP_DOT2>(x, T, s)
                    : dispatch_steps<STEP_LOOP>(x, T, s));
}
