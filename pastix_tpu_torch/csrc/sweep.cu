// K2: one direction of the whole-sweep triangular solve in one launch.
//
// Replaces the Pallas kernel pastix_tpu/numeric/sweep_kernels.py
// run_sweep (_mk_sweep_kernel; entries sweep_fwd / sweep_bwd).  The RHS is
// in the reference's row-vector layout, y[(blk * R + r) * T + i].  In
// level order, per level:
//
//   diag  : y[c] = D[c] . y[c] for every column c of the level
//   update: y[dst] -= sum over the dst's ops of M[tile] . y[src]
//
// with M(i, k) = tile[i, k] in the forward sweep and tile[k, i] (the
// transpose) in the backward sweep (TRANS_UPD); the diagonal likewise
// (TRANS_DIAG; the LU backward sweep keeps it untransposed).
//
// What bounds it on an H100: every stored tile is read once per sweep
// (64 KB at T = 128) for 2 T^2 R FLOP, a quarter FLOP per byte at R = 1,
// so the bytes bound it (3.35 TB/s), and between the levels the
// dependent chain: about one diag and one update hop per level.  The
// first design launched per level and phase (about 370 launches per
// forward + backward sweep at Poisson 64^3), each behind a host call of
// about 20 us, and left the card idle 39 % of the solve.
//
// The design: one persistent launch per direction.  The host
// (numeric/sweep_kernels.py, sweep_items) lists the work items in the
// first design's phase order, a topological order of the sweep: a diag
// item per column, an update item per sub-segment (at most 4 ops of one
// dst in the forward sweep, 1 in the backward one, whose longest chain
// runs through columns with many ops; a dst with hundreds of ops so
// spreads over many SMs), and a flush
// item per dst that no diag item of this sweep owns (the Schur rows of
// the forward sweep), after everything else.  Each CTA takes the next
// item by an atomic ticket and finishes it before it takes another.
//   - update item: y_src is read once its column's diag item has set
//     state[src] to DONE (acquire); the item's partial sum goes to its own
//     slot, then state[dst] += 1 (release);
//   - diag / flush item of column c: waits until state[c] counts every
//     slot that feeds c, then y[c] -= (the sum of those slots, in ticket
//     order: a fixed order, so runs repeat bit for bit), applies D (diag
//     only), writes y[c] and sets state[c] = DONE (release).
// Why it cannot deadlock: an item waits only on items with smaller
// tickets (the host checks this when it builds the tables), and a ticket
// is taken only by a CTA that is running and holds it until the item is
// done; so the smallest unfinished ticket waits on nothing unfinished.
// No co-residency is needed: a CTA that never starts holds no ticket.
// The grid is the SM count times the CTAs an SM holds, at most the item
// count.  state (and the ticket) are zeroed by one cudaMemsetAsync per
// call.  A wait that outlasts about a second traps, so a broken table
// fails the launch instead of hanging the card.
//
// Tiles: a tile goes into registers as 16-byte loads, a whole T x T tile
// in one batch per CTA (64 KB in flight at T = 128, 16 float4 a thread),
// issued before the item waits on its dependency, so the wait hides the
// tile's latency; a diag item likewise fetches its slot ids and y[c]
// before it waits, and sums its slots with 16-byte loads spread over all
// its threads (the forward sweep's chain runs through columns fed by
// about 60 slots).  A release by thread 0 after a barrier publishes the
// whole CTA's writes.  y and the partial slots are written by other CTAs
// during the launch, so they are read with ld.global.cg (L2, not the
// SM's L1).  The right-hand sides go RC = 4 at a time through shared
// memory while the tile stays in registers, and an update item writes
// each pass's partial sum to its slot as the pass ends, so the static
// shared memory (about 31 KB at T = 128) does not grow with R.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int RC = 4;  // right-hand sides per pass
constexpr int DONE = 1 << 30;
constexpr long long SPIN_MAX = 1LL << 24;  // polls of 64 ns: about a second

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// polls (acquire) until ready(*p); after a barrier the whole CTA reads
// what the releasing CTA wrote
template <typename Ready>
__device__ __forceinline__ void spin(const int* p, Ready ready) {
  long long n = 0;
  while (!ready(ld_acquire(p))) {
    if (++n > SPIN_MAX) __trap();
    __nanosleep(64);
  }
}


template <int T>
struct Tile {
  static constexpr int CPR = T / 4;     // float4 a row
  static constexpr int RPJ = NT / CPR;  // rows a load step covers
  static constexpr int J = T * T / 4 / NT;  // float4 a thread
};

// a whole tile into registers: thread t holds rows t / CPR + RPJ j,
// columns 4 (t % CPR) .. + 3 (a warp reads whole rows: coalesced)
template <int T>
__device__ __forceinline__ void load_tile(float4 (&v)[Tile<T>::J],
                                          const float* __restrict__ tile) {
  const float4* p = (const float4*)tile + threadIdx.x;
#pragma unroll
  for (int j = 0; j < Tile<T>::J; ++j) v[j] = __ldg(p + j * NT);
}

// acc[u][i] += sum_k M(i, k) ys[u][k] for u < nr, the tile in v.
// red: 4 NT RC floats of scratch (the transposed reduction).
template <int T, bool TRANS>
__device__ __forceinline__ void tile_matvec(const float4 (&v)[Tile<T>::J],
                                            const float* ys, int nr,
                                            float* acc, float* red) {
  using S = Tile<T>;
  const int t = threadIdx.x;
  const int c4 = t % S::CPR, r0 = t / S::CPR;
  if constexpr (!TRANS) {
    // rows i = r0 + RPJ j, k = 4 c4..: a dot of 4, then a sum over the
    // CPR lanes of the row (a fixed butterfly)
    for (int u = 0; u < nr; ++u) {
      const float4 y4 = *(const float4*)(ys + u * T + 4 * c4);
      float s[S::J];
#pragma unroll
      for (int j = 0; j < S::J; ++j)
        s[j] = v[j].x * y4.x + v[j].y * y4.y + v[j].z * y4.z + v[j].w * y4.w;
#pragma unroll
      for (int off = S::CPR / 2; off >= 1; off >>= 1)
#pragma unroll
        for (int j = 0; j < S::J; ++j)
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      if (c4 == 0) {
#pragma unroll
        for (int j = 0; j < S::J; ++j) acc[u * T + r0 + S::RPJ * j] += s[j];
      }
    }
  } else {
    // rows k = r0 + RPJ j, columns i = 4 c4..: partial sums over the
    // thread's k, then over the RPJ row groups in order through shared
    // memory
    for (int u = 0; u < nr; ++u) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < S::J; ++j) {
        const float yk = ys[u * T + r0 + S::RPJ * j];
        s.x = fmaf(v[j].x, yk, s.x);
        s.y = fmaf(v[j].y, yk, s.y);
        s.z = fmaf(v[j].z, yk, s.z);
        s.w = fmaf(v[j].w, yk, s.w);
      }
      *(float4*)(red + (r0 * RC + u) * T + 4 * c4) = s;
    }
    __syncthreads();
    for (int e = t; e < nr * T; e += NT) {
      const int u = e / T, i = e % T;
      float s = 0.f;
      for (int g = 0; g < S::RPJ; ++g) s += red[(g * RC + u) * T + i];
      acc[u * T + i] += s;
    }
  }
}

struct Sweep {
  float* y;
  float* partial;  // [nslot][R][T]
  int* state;      // [nbc] arrivals, or DONE; state[nbc]: the ticket
  const float* pool;
  const float* dinv;
  const int64_t* item;  // [nitems][5]: kind, col, lo, hi, slot
  const int64_t* slot_list;
  const int64_t* op_tile;
  const int64_t* op_src;
  const int64_t* op_wait;
  int64_t nitems;
  int64_t nbc;
  int R;
};

enum { DIAG = 0, UPD = 1, FLUSH = 2 };
constexpr int OPS = 4;     // ops an update item at most (the host's cut)
constexpr int SLOTS = 1024;  // slot ids staged in shared memory at once

template <int T, bool TRANS_UPD, bool TRANS_DIAG>
__global__ void __launch_bounds__(NT) sweep_kernel(Sweep w) {
  // fixed sizes whatever R: the right-hand sides go RC at a time
  __shared__ __align__(16) float ys[OPS * RC * T];  // [OPS][RC][T]
  __shared__ __align__(16) float red[4 * NT * RC];  // [NT / CPR][RC][T]
  __shared__ __align__(16) float acc[RC * T];       // [RC][T]
  __shared__ int64_t s_item;
  __shared__ int s_slot[SLOTS];
  const int t = threadIdx.x;
  const int R = w.R;
  const int64_t RT = (int64_t)R * T;
  constexpr int64_t TT = (int64_t)T * T;
  float4 v[Tile<T>::J];

  // thread 0 holds the next ticket, taken while the current item runs
  int64_t next = t == 0 ? atomicAdd(w.state + w.nbc, 1) : 0;
  for (;;) {
    if (t == 0) s_item = next;
    __syncthreads();
    const int64_t it = s_item;
    if (it >= w.nitems) break;
    if (t == 0) next = atomicAdd(w.state + w.nbc, 1);
    const int64_t* e = w.item + it * 5;
    const int kind = (int)e[0];
    const int64_t col = e[1], lo = e[2], hi = e[3];

    if (kind == UPD) {
      // the first tile in flight, then every src's diagonal done, then
      // the srcs' y for RC right-hand sides at a time
      const int nq = (int)(hi - lo);
      load_tile<T>(v, w.pool + w.op_tile[lo] * TT);
      int loaded = 0;
      if (t == 0)
        for (int q = 0; q < nq; ++q)
          if (w.op_wait[lo + q])
            spin(w.state + w.op_src[lo + q], [](int s) { return s >= DONE; });
      __syncthreads();
      float* out = w.partial + e[4] * RT;
      for (int r0 = 0; r0 < R; r0 += RC) {
        const int nr = min(RC, R - r0);
        for (int x = t; x < nr * T; x += NT) acc[x] = 0.f;
        for (int x = t; x < nq * nr * T; x += NT) {
          const int q = x / (nr * T), xe = x % (nr * T);
          ys[x] = __ldcg(w.y + w.op_src[lo + q] * RT + (int64_t)r0 * T + xe);
        }
        __syncthreads();
        for (int q = 0; q < nq; ++q) {
          if (q != loaded) {
            load_tile<T>(v, w.pool + w.op_tile[lo + q] * TT);
            loaded = q;
          }
          tile_matvec<T, TRANS_UPD>(v, ys + q * nr * T, nr, acc, red);
          __syncthreads();
        }
        // this pass's partial goes out now: acc holds one pass
        for (int x = t; x < nr * T; x += NT) out[(int64_t)r0 * T + x] = acc[x];
      }
      __syncthreads();  // every write before thread 0's release
      if (t == 0) red_release_add(w.state + col, 1);
    } else {
      // before the wait: the diagonal tile, the first SLOTS slot ids and
      // y[c] of the first RC right-hand sides (no other item writes y[c])
      if (kind == DIAG) load_tile<T>(v, w.dinv + col * TT);
      const int need = (int)(hi - lo);
      for (int k = t; k < min(need, SLOTS); k += NT)
        s_slot[k] = (int)w.slot_list[lo + k];
      float* yc = w.y + col * RT;
      for (int x = t; x < min(RC, R) * T; x += NT) ys[x] = __ldcg(yc + x);
      if (t == 0) spin(w.state + col, [need](int s) { return s == need; });
      __syncthreads();
      for (int r0 = 0; r0 < R; r0 += RC) {
        const int nr = min(RC, R - r0);
        const int E4 = nr * T / 4;  // float4 of a slot's RC-row block
        if (r0 > 0) {
          for (int x = t; x < nr * T; x += NT)
            ys[x] = __ldcg(yc + (int64_t)r0 * T + x);
        }
        // the column's slots summed by G thread groups, group g every
        // G-th slot in order; then the G sums in order: a fixed order
        // whatever the timing
        const int G = max(1, NT / E4);
        float4* red4 = (float4*)red;
        for (int x = t; x < G * E4; x += NT)
          red4[x] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int64_t k0 = lo; k0 < hi; k0 += SLOTS) {
          const int n = (int)min((int64_t)SLOTS, hi - k0);
          if (k0 > lo || (r0 > 0 && need > SLOTS)) {
            __syncthreads();
            for (int k = t; k < n; k += NT)
              s_slot[k] = (int)w.slot_list[k0 + k];
          }
          __syncthreads();
          for (int x = t; x < G * E4; x += NT) {
            const int g = x / E4;
            const float4* p =
                (const float4*)(w.partial + (int64_t)r0 * T) + x % E4;
            float4 s = red4[x];
#pragma unroll 4
            for (int k = g; k < n; k += G) {
              const float4 q = __ldcg(p + s_slot[k] * (RT / 4));
              s.x += q.x;
              s.y += q.y;
              s.z += q.z;
              s.w += q.w;
            }
            red4[x] = s;
          }
        }
        __syncthreads();
        for (int x = t; x < E4; x += NT) {
          float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int g = 0; g < G; ++g) {
            const float4 q = red4[g * E4 + x];
            s.x += q.x;
            s.y += q.y;
            s.z += q.z;
            s.w += q.w;
          }
          float4 yv = ((float4*)ys)[x];
          yv.x -= s.x;
          yv.y -= s.y;
          yv.z -= s.z;
          yv.w -= s.w;
          ((float4*)ys)[x] = yv;
          ((float4*)acc)[x] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        __syncthreads();
        if (kind == DIAG) {
          tile_matvec<T, TRANS_DIAG>(v, ys, nr, acc, red);
          __syncthreads();
        }
        const float* res = kind == DIAG ? acc : ys;
        for (int x = t; x < nr * T; x += NT) yc[(int64_t)r0 * T + x] = res[x];
        __syncthreads();
      }
      // the barrier above orders every thread's writes before thread 0's
      // release (cumulative at gpu scope)
      if (t == 0) st_release(w.state + col, DONE);
    }
  }
}

template <int T, bool TU, bool TD>
cudaError_t launch(const Sweep& w, cudaStream_t s) {
  auto kernel = sweep_kernel<T, TU, TD>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t grid = std::min<int64_t>((int64_t)sms * per_sm, w.nitems);
  err = cudaMemsetAsync(w.state, 0, (size_t)(w.nbc + 1) * sizeof(int), s);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, NT, 0, s>>>(w);
  return cudaGetLastError();
}

template <bool TU, bool TD>
cudaError_t dispatch(const Sweep& w, int T, cudaStream_t s) {
  switch (T) {
    case 32: return launch<32, TU, TD>(w, s);
    case 64: return launch<64, TU, TD>(w, s);
    case 128: return launch<128, TU, TD>(w, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* pastix_cuda_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One sweep direction over the item tables of
// numeric/sweep_kernels.sweep_items (ops: the most ops of an update item);
// state holds nbc + 1 ints (zeroed here), partial nslot * R * T floats.
extern "C" int pastix_sweep_run(void* y, const void* pool, const void* dinv,
                                void* partial, void* state, const void* item,
                                const void* slot_list, const void* op_tile,
                                const void* op_src, const void* op_wait,
                                long long nitems, long long nbc, int T,
                                int R, int ops, int trans_upd,
                                int trans_diag, void* stream) {
  if (nitems <= 0) return 0;
  if (R < 1 || ops > OPS || (trans_diag && !trans_upd))
    return (int)cudaErrorInvalidValue;
  const Sweep w{(float*)y, (float*)partial, (int*)state,
                (const float*)pool, (const float*)dinv,
                (const int64_t*)item, (const int64_t*)slot_list,
                (const int64_t*)op_tile, (const int64_t*)op_src,
                (const int64_t*)op_wait, nitems, nbc, R};
  auto s = (cudaStream_t)stream;
  if (!trans_upd) return (int)dispatch<false, false>(w, T, s);
  return (int)(trans_diag ? dispatch<true, true>(w, T, s)
                          : dispatch<true, false>(w, T, s));
}
