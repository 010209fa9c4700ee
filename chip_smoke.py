#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pastix_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--nx N] [--schur-nx N] [--lu-nx N] [--ldlt-nx N]

Phases; any failed check raises, so the script exits non-zero and never
prints the final ``ok`` line:

1. device: a CUDA device is required; prints the card's name and power
   limit (nvidia-smi);
2. build: compiles the hand-written CUDA kernels K1-K13 from ``csrc/``
   (one nvcc per source, in parallel; ptxas registers, shared memory and
   spills, and K1's, K3's, K5's, K6's, K10's and K12's HMMA counts from
   ``cuobjdump -sass`` where the toolkit has it, K5's (and K9's) those of
   K3's kernel with fp32 operands, K6's those of K1's windowed kernel
   with fp32 operands, K10's those with fp32 a and bf16 b: none fails,
   and the first designs of K6 and K9 must be gone from the library) and
   the port's native host library (g++; prints whether it was built or
   the Python ordering runs);
3. kernels: each kernel against its plain PyTorch twin on the same inputs,
   max|d| <= 1e-4 max|ref| for K1 and K3, 1e-5 for K2 (summation order
   only) and K4 (plus equal clamp counts); K1, K2, K3, K4, K5, K6, K9,
   K10 and K12 also run twice and must repeat bit for bit (K3, K4, K5,
   K6, K9 and K10 wherever they are checked, phases 7, 8, 11 and 13 too;
   K12 in phase 14), and K2 must launch once a
   sweep direction: on the
   poisson_3d(24) T=128 layout, K1 (left-looking E2) on the busiest
   level's chunks and the dense-tail pre-pass, bf16 and fp32 updates,
   K2 (sweeps) forward + backward at R = 1 and R = 3; on the poisson_3d(24) T=128 Schur layout
   (Schur = its last 24^2 unknowns), K3 (right-looking E2) on the busiest
   residue level and on every residue pair in one list cut into chunks
   that split dst segments, bf16 and fp32; that layout's ``get_schur``
   against A22 - A21 A11^-1 A12 from a sparse LU (fp32 updates,
   1e-4 max|S|); then slice 2 on T=128 layouts: K1 scaled (``d``) on the
   shift-invert poisson_3d(24) LDLᵗ layout, K1 cross-pool (``src_pool``,
   the pool side and the pool_u mirror, with a forced ``"full"`` plan) on
   the convection_diffusion_3d(24) LU layout, bf16 and fp32; K3 ``d`` and
   ``src_pool`` on those layouts in Schur mode (the plane z = 23); K2's
   LU backward at R = 1 and R = 3; K4 (static-pivot tile factorization)
   LU and LDLᵗ on the busiest level's diagonal tiles and on batches with
   planted zero pivots at T = 32, 64 and 128 (either side of its first
   32 x 32 block step too); ``get_schur`` under LU against the sparse-LU
   S;
   then slice 3 on the busiest level's pairs of the poisson_3d(24) (LLᵗ,
   LDLᵗ) and convection_diffusion_3d(24) (LU) T=128 layouts, bf16 and
   fp32, 1e-4 max|ref|: K3 reading operand arrays (the panel stream
   ``xab`` plain, ``d`` and LU's (L, Uᵗ) with its mirror; ``compact``
   plain, ``d`` and ``src_pool``), K5 (dst-block E2, every entry kept)
   and K6 (panel-slab E2, cost gate off) plain and ``d``; then slice 4 on
   the same pairs and dtypes: the E2 harness's variants, K3 on the pools
   at G=1 and 2, K3 ``ab_pack`` at G=1, 2 and 4, K9 (one-pair-per-step
   E2 over ``sort_triples``) and K10 (compact-gather E2 over a group-1
   schedule), plain, ``d`` and ``src_pool``; and K7 (fused Cholesky +
   inverse in place on the pool) on the poisson_3d(24) level with the
   most diagonal tiles, garbage planted above their diagonals and a pad
   sentinel in the index (every other tile bit-identical), and K8 on the
   same tiles symmetrized, 1e-5 max|ref|;
4. main path: ``Pastix(poisson_3d(--nx), T=128, bf16 updates)`` through
   order, symbfact, analyze, factorize (twice, the second timed) and a
   refined solve of b = A.1 to a fp64 residual <= 1e-10; the launch counts
   of K1 and K2 must rise and the twins' stay 0, and K2 may launch at
   most twice a fwd+bwd sweep pair (the first solve and one a refinement
   step; so on every path that calls ``solve``);
5. main-path shapes: K1 on the main path's busiest level and tail
   pre-pass and K2 on its sweeps, each against its twin as in 3, then
   each kernel and its twin timed (CUDA events), K1's per-chunk bf16
   operand gather timed alone, and K2 on a chain of 256 dependent
   columns (its latency an item);
6. Schur path: ``Pastix(poisson_3d(--schur-nx), T=128, bf16 updates)``
   with the plane z = nx-1 (its last nx^2 unknowns) as Schur unknowns:
   order, symbfact, analyze, factorize twice (the second timed),
   ``get_schur`` (shape, finite, symmetric), ``solve_with_schur(A.1)`` to
   a fp64 residual <= 1e-10; K1, K2 and K3 must launch and no twin may
   run; then K1 on the busiest level and K2 against their twins, and K3
   against its twin on the path's busiest residue level, and timed;
7. LU path: ``Pastix(convection_diffusion_3d(--lu-nx), T=128, bf16
   updates, LU)`` (n = 343,000 at the default 70: the reference's
   convdiff rung) as in 4; K1, K2 and K4 must launch, no twin; one more
   factorize under ``torch.profiler``: K4's device time summed by kernel
   name, its share of ``fact_ms`` and the longest kernels; then K1
   cross-pool, K2's LU sweeps and K4 LU against their twins and timed at
   the path's busiest level, and ``tri_inv_batch`` (upper, then unit) on
   the same factored tiles;
8. LDLᵗ path: ``Pastix(poisson_3d(--ldlt-nx) - σI, T=128, fp32 updates,
   LDLT)``, σ halfway between the two smallest eigenvalues of the
   Laplacian (a shift-and-invert matrix, one negative eigenvalue), as in
   7; with no clamped pivot exactly one pivot of d is negative
   (Sylvester); K4's device time over one factorize as in 7; K1 scaled
   (against its twin, and timed, in fp32, the path's dtype), K2 against
   its twin, and K4 LDLᵗ, with ``tri_inv_batch`` (unit) on its tiles;
   then, not checked, what bf16 updates leave
   on this matrix (their error is not contracted by the refinement at
   nx=64);
9. LU Schur path: ``convection_diffusion_3d(--schur-nx)`` with the plane
   z = nx-1 as Schur unknowns: ``get_schur`` (shape, finite),
   ``solve_with_schur(A.1)`` to <= 1e-10, K3 launched in its cross-pool
   variant; K1 and K2 (LU) against their twins as in 6; K3 ``src_pool``
   against its twin and timed (bf16);
10. LDLᵗ Schur path: the shift-invert poisson_3d(--schur-nx) with its
   plane z = nx-1, fp32 updates: as 9 (S symmetric), K3 launched in its
   scaled variant; K3 ``d`` against its twin and timed in fp32;
11. right-looking paths (the reference's ``PASTIX_E2_LL=0`` schedules,
   bf16 updates): LLᵗ on ``poisson_3d(--nx)`` (dense tail on) in stream,
   block, slab, pair and pair+compact; LDLᵗ on the same (unshifted)
   Laplacian in stream, block and slab; LU on
   ``convection_diffusion_3d(--lu-nx)`` in stream.  Per matrix the host
   analysis once and the left-looking ``fact_ms`` for reference (no
   claim); per schedule its own factorize program
   (``build_factorize_fn(e2=...)``): factorize twice (the second timed)
   and a refined solve to <= 1e-10, the schedule's kernel (K3, K5 or K6)
   launched, K1 not, no twin; where the reference's cost gate keeps no
   block or slab pair of the matrix the gate is opened, and the log says
   so; on the LDLᵗ slab path one more factorize under ``torch.profiler``
   (K4's and K6's device time and their shares of ``fact_ms``); then
   that kernel against its twin (twice, bit for bit) at the path's
   busiest level, timed and bound, and per matrix K2 against its twin;
12. fused-diagonal LLᵗ path (the reference's ``PASTIX_FUSED_DIAG=1``):
   ``poisson_3d(--nx)``, dense tail on, bf16 updates, left-looking and
   right-looking stream, each as in 4 (factorize twice, the second
   timed; a refined solve to <= 1e-10): K7 and K8 must launch (K1; or K3
   and not K1), no twin may run, and ``cholesky_ex`` runs only at the
   levels without panels; ``fact_ms`` beside the unfused one of phases 4
   and 11; then K7 on the left path's level with the most diagonal tiles
   against its twin and against ``cholesky_ex`` + ``solve_triangular``
   (two library calls), and K8 on one tile (the dense tail's call), both
   timed and bound; K1 (left) and K2 (both) against their twins; then K8
   on one tile at T = 32, 64 and 128 against its twin and timed beside
   the two library calls, on a tile of condition 1e4 (L against the twin,
   X against fp64 within T u cond(L)) and on a tile with a negative
   pivot (NaN where the twin has it);
13. E2 A/B harness (the reference's ``exp_pipe.py``): on exp_pipe's
   default triples (ng=8192, a pool of 12000 T=128 tiles, segments of
   about 3 pairs) and on the busiest right-looking level of phase 12's
   stream solver (its factored pool), bf16 and fp32, every variant of
   phase 3's slice 4 (K3 G=1/2, ``ab_pack`` G=1/2/4, K9, K10) against its
   twin (1e-4 max|ref|; each also twice, bit for bit), then kernel and
   twin timed and bound; the launches are those of the timed runs,
   counted from 0;
14. operand-cache harness (the reference's ``exp_cache.py`` and
   ``exp_mp.py``) on phase 13's poisson level with its bf16 panel stream:
   K11 (``gemm_scatter_vcache``, chunk 1536, group 2) and K12
   (``gemm_scatter_mp`` ``loop`` and ``dot2``, chunk 1536, G = 4 and 8),
   each against its twin and against ``kernels.gemm_scatter`` with bf16
   operands (1e-4 max|ref|; K12 also twice, bit for bit), beside the
   reference's K3 baselines (pools
   at G=2; ``xab`` at chunk 1536 and 6144); kernels and twins timed and
   bound, the cache's size (CT, MiB) and the mp padding logged; the
   launches those of the timed runs, counted from 0;
15. copy probe (the reference's ``exp_dma.py``): every row of its table
   (S = 1..32 tiles of 64 KB, D = 2..8 in flight; 32 KB and 16 KB
   sub-tiles, D = 2..16) in 4 KB bulk copies, then its first row on 1,
   4, 16 and 66 CTAs (on one at D = 8 and 16 too) and in 8, 16 and 32 KB
   bulk copies (32 KB on one CTA too), on a 786 MB pool, K13's (2, D, T)
   first- and last-row sums against
   ``probe_ref`` (1e-5 max|ref|), then K13, its twin and
   ``index_select`` of the same copies timed, µs per copy, GB/s and the
   bytes in flight logged against the bytes bound;
16. front door and refinement: on ``poisson_3d(--nx)`` (the main path's
   configuration, one host analysis saved with ``IOStrategy.SAVE`` and
   loaded by every later solver) the device loops ``CG``, ``GMRES`` and
   ``BICGSTAB``, then ``CG`` with ``device_refine=False`` and with
   ``fast_solve=False``: each solver analyzed, factorized and solved
   twice (the second solve timed), residual <= 1e-10, its iterations, its
   host steps and its preconditioner applications; K1 and K2 must launch
   (no K2 under ``fast_solve=False``, whose factors hold no inverse
   diagonal tiles; its peak device memory beside the fast path's), no
   twin may run, and the timed solve launches K2 at most twice an
   application; then ``factorize(values)`` with the stored diagonal
   raised by 10 % (refactor ms beside the first factorize's) against a
   fresh solver on the new matrix (equal iterations, solutions within
   1e-12, max|pool difference| logged), ``as_preconditioner`` under
   ``scipy.sparse.linalg.cg`` to 1e-10 within phase 4's iterations + 2,
   the array API ``pastix()`` with the phase window ORDERING..ANALYSE (no
   solution, no factors) and ORDERING..CLEAN (residual <= 1e-10), and
   ``clean()`` (the allocated bytes back within 64 MiB of their level
   before the solver); on ``convection_diffusion_3d(--lu-nx)`` LU
   ``GMRES`` and ``BICGSTAB`` the same way (K1, K2 and K4 launched); at
   ``poisson_3d(24)`` once each: ``MurgeSolver`` (graph, assembly, solve,
   then new values on the cached analysis), ``dspsolve`` over 4 CSCD
   parts and ``cli.main(["-lap3", "24", "--refine", "gmres",
   "--steps"])`` (exit code 0);

then the card's nvidia-smi line, one JSON line of the kernels (each
variant on its own line of the list, ``launches`` from the path that runs
it), and last ``{"ok": true, "device": {...}}``.  --nx 64 is
n = 262,144; --nx 100 is the 1M-unknown flagship of bench.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

TOL_E2 = 1e-4  # max|kernel - twin| / max|twin| for K1 and K3
TOL_K2 = 1e-5  # the same for the sweeps
TOL_K4 = 1e-5  # the same for the static-pivot tile factorization
TOL_K7 = 1e-5  # the same for the fused Cholesky + inverse (K7, K8)
TOL_K13 = 1e-5  # the copy probe's (2, D, T) sums against the closed form
TOL_RES = 1e-10  # fp64 ||b - A x|| / ||b|| after refinement
TOL_S = 1e-4  # max|S - S_ref| / max|S_ref| with fp32 updates
TOL_REFAC = 1e-12  # factorize(values) against a fresh solver, relative
CLEAN_SLACK = 64 * 2 ** 20  # bytes clean() may leave allocated
# the card's published peaks (H100 SXM data sheet, dense, at 700 W)
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` runs after one
    warm-up, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int = 20):
    """Mean device time of ``fn()`` in ms, the sum of every kernel, copy
    and fill it runs on the card, by ``torch.profiler`` over ``reps``
    runs after one warm-up: free of the host's launch overhead, which
    :func:`cuda_ms` includes when the host is the slower side.  None if
    the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / reps / 1e3 or None


def bound(flops: float, peak: float, nbytes: float):
    """(bound_ms, bound_by): the larger of operations over the peak rate
    and bytes over the memory rate."""
    t_op, t_by = flops / peak, nbytes / PEAK_BYTES
    return max(t_op, t_by) * 1e3, ("operations" if t_op >= t_by else "bytes")


def k1_flops(c, T=128):
    """A K1 chunk's operations: 2 H T² per pair (row-bounded a)."""
    return c.n_pairs * 2.0 * c.H * T ** 2


def k3_flops(c, T=128):
    """A K3 chunk's operations: 2 T³ per pair (full tiles)."""
    return c.n_pairs * 2.0 * T ** 3


def e2_bound_lists(lists, T, pair_flops, upd):
    """Bound of E2 lists ``(chunks, dst_pool, src_pool)`` run as one step
    (the LU pool side and its pool_u mirror) with ``upd`` operands: a read
    from the dst pool, b from the src pool, each distinct (pool, tile)
    once; each dst tile read and written once; the pivot rows of d that
    the pairs name, once."""
    import torch

    flops, reads, dsts, krows = 0.0, {}, {}, set()
    for chunks, dk, sk in lists:
        flops += sum(pair_flops(c) for c in chunks)
        for c in chunks:
            reads.setdefault(dk, set()).update(c.pair_a.tolist())
            reads.setdefault(sk, set()).update(c.pair_b.tolist())
            dsts.setdefault(dk, set()).update(c.seg_dst.tolist())
            if c.pair_k is not None:
                krows.update(c.pair_k.tolist())
    tile = T * T * 4
    nbytes = (sum(map(len, reads.values())) * tile
              + 2 * sum(map(len, dsts.values())) * tile + len(krows) * T * 4)
    peak = PEAK_BF16 if upd == torch.bfloat16 else PEAK_FP32
    return bound(flops, peak, nbytes)


def check_e2(name, run, run_ref, pool, chunks, update_dtype, label,
             repeat=False, **kw):
    """An E2 kernel (K1, K3, K5 or K6) against its twin on copies of
    ``pool`` (``kw``: the ``d`` or ``src_pool`` variant, K3's operand
    arrays); ``repeat``: a second run must be bit-identical.  Returns
    max|d|."""
    import torch

    got = run(pool.clone(), chunks, update_dtype, **kw)
    if repeat and not torch.equal(got, run(pool.clone(), chunks,
                                           update_dtype, **kw)):
        raise AssertionError(f"{name} {label}: two runs differ")
    ref = run_ref(pool.clone(), chunks, update_dtype, **kw)
    torch.cuda.synchronize()
    touched = torch.cat([c.seg_dst for c in chunks]).unique()
    scale = float(ref[touched].abs().max())
    err = float((got - ref).abs().max())
    ok = err <= TOL_E2 * scale
    log(f"{name} {label}: {len(chunks)} chunks, "
        f"{sum(c.n_pairs for c in chunks)} pairs, max|d|={err:.3e} "
        f"max|ref|={scale:.3e}{', two runs bit-identical' if repeat else ''}"
        f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label} disagrees with its twin")
    return err


def check_k1(pool, chunks, update_dtype, label, **kw):
    from pastix_tpu_torch.numeric import leftlook as LL

    return check_e2("K1", LL.gemm_scatter_ll, LL.gemm_scatter_ll_ref, pool,
                    chunks, update_dtype, label, repeat=True, **kw)


def check_k3(pool, chunks, update_dtype, label, **kw):
    from pastix_tpu_torch.numeric import pipelined as PL

    return check_e2("K3", PL.gemm_scatter_pipelined,
                    PL.gemm_scatter_pipelined_ref, pool, chunks,
                    update_dtype, label, repeat=True, **kw)


def sweep_pair(solver):
    """The (pool, dinv, lu) of the solver's forward and backward sweeps:
    LU sweeps backward over the Uᵗ pool with the upper inverses."""
    f = solver.factors
    if f.pool_u is not None:
        return (f.pool, f.dinv, False), (f.pool_u, f.dinv_u, True)
    return (f.pool, f.dinv, False), (f.pool, f.dinv, False)


def check_k2(solver, R, seed):
    """K2 forward + backward against its twin, one launch a direction and
    a second run bit-identical; returns max|d|."""
    import torch
    from pastix_tpu_torch.numeric import sweep_kernels as SW

    lay, f = solver.layout, solver.factors
    plan = solver._solve_fn.plan
    g = torch.Generator(device=f.pool.device).manual_seed(seed)
    y2 = torch.randn(lay.nbc * R, lay.T, generator=g, device=f.pool.device)
    got, again, ref = y2.clone(), y2.clone(), y2.clone()
    n0 = SW.run_sweep.launches
    for key, (pool, dinv, lu) in zip(("fwd", "bwd"), sweep_pair(solver)):
        SW.run_sweep(pool, dinv, got, plan, key, lu)
        SW.run_sweep(pool, dinv, again, plan, key, lu)
        SW.run_sweep_ref(pool, dinv, ref, plan, key, lu)
    torch.cuda.synchronize()
    if SW.run_sweep.launches != n0 + 4 or not torch.equal(got, again):
        raise AssertionError("K2: not one launch a direction, or two runs "
                             "differ")
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    ok = err <= TOL_K2 * scale
    kind = "LU " if f.pool_u is not None else ""
    log(f"K2 {kind}fwd+bwd R={R}: max|d|={err:.3e} max|ref|={scale:.3e} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K2 {kind}R={R} disagrees with its twin")
    return err


def k2_timed(solver):
    """K2 fwd + bwd at R = 1, kernel and twin, with its bound: every op
    one (T, T) x (T, 1) product; every pool tile and inverse diagonal the
    plan names read once (from both pools for LU), y read and written
    once."""
    import torch
    from pastix_tpu_torch.numeric import sweep_kernels as SW

    lay, plan = solver.layout, solver._solve_fn.plan
    y2 = torch.randn(lay.nbc, lay.T, device=solver.factors.pool.device)
    sides = sweep_pair(solver)

    def sweeps(run):
        for key, (pool, dinv, lu) in zip(("fwd", "bwd"), sides):
            run(pool, dinv, y2, plan, key, lu)

    ms = cuda_ms(lambda: sweeps(SW.run_sweep))
    plain = cuda_ms(lambda: sweeps(SW.run_sweep_ref))
    nops = sum(ph.op_tile.numel() if ph.kind == "upd" else ph.cols.numel()
               for key in ("fwd", "bwd") for ph in plan[key])
    tiles = torch.cat([ph.op_tile for ph in plan["fwd"] if ph.kind == "upd"])
    ncols = sum(ph.cols.numel() for ph in plan["fwd"] if ph.kind == "diag")
    npools = 2 if sides[1][2] else 1
    bd = bound(nops * 2.0 * lay.T ** 2, PEAK_FP32,
               npools * (tiles.unique().numel() + ncols) * lay.T ** 2 * 4
               + 2 * lay.nbc * lay.T * 4)
    items = {k: plan["items"][k].nitems for k in ("fwd", "bwd")}
    for key in ("fwd", "bwd"):
        n, slots, most, ops = k2_critical_chain(plan["items"][key], lay.nbc)
        log(f"  K2 {key}: longest dependent chain {n} items; its diag "
            f"items sum {slots:.1f} slots (at most {most}), its update "
            f"items hold {ops:.2f} ops")
    log(f"timing K2 {'LU ' if npools == 2 else ''}fwd+bwd R=1 "
        f"({len(plan['fwd']) + len(plan['bwd'])} phases, items {items}): "
        f"kernel {ms:.3f} ms, twin {plain:.3f} ms, bound {bd[0]:.3f} ms "
        f"({bd[1]})")
    return ms, plain, bd


def k2_critical_chain(items, nbc):
    """The longest chain of dependent work items of one K2 direction,
    from its host tables: (items on it, the mean and largest slot count
    of its diag items, the mean op count of its update items)."""
    it = items.item.cpu().numpy()
    slots = items.slot_list.cpu().numpy()
    src, wait = items.op_src.cpu().numpy(), items.op_wait.cpu().numpy()
    kind, col, lo, hi = it[:, 0], it[:, 1], it[:, 2], it[:, 3]
    red = np.flatnonzero(kind != 1)
    owner = np.full(nbc, -1)
    owner[col[red]] = red
    upd = np.flatnonzero(kind == 1)
    depth, parent = np.zeros(len(it), np.int64), np.full(len(it), -1)
    for t in range(len(it)):
        if kind[t] == 1:
            deps = owner[src[lo[t]:hi[t]][wait[lo[t]:hi[t]] != 0]]
        else:
            deps = upd[slots[lo[t]:hi[t]]]
        if deps.size:
            j = deps[np.argmax(depth[deps])]
            depth[t], parent[t] = depth[j] + 1, j
    chain, t = [], int(np.argmax(depth))
    while t >= 0:
        chain.append(t)
        t = parent[t]
    n = (hi - lo)[chain]
    on_upd = kind[chain] == 1
    return (len(chain), float(n[~on_upd].mean()), int(n[~on_upd].max()),
            float(n[on_upd].mean()))


def k2_chain_timed(dev, n=256, T=128):
    """K2 on a chain of ``n`` columns, each column's one update feeding
    the next column's diagonal: every item waits on the one before, so
    the time over the 2 n - 1 items is K2's latency an item on a
    dependent path (the sweeps' critical path is such a chain, about 185
    items a direction at Poisson 64^3).  Checked against the twin."""
    import torch
    from pastix_tpu_torch.numeric import sweep_kernels as SW

    g = torch.Generator(device=dev).manual_seed(7)
    phases = []
    for c in range(n):
        phases.append(("diag", np.array([c])))
        if c + 1 < n:
            phases.append(("upd", np.array([c]), np.array([c]),
                           np.array([c + 1])))
    tabs = SW.sweep_direction(phases, n, dev)
    plan = {"nbc": n, "T": T, "fwd": tabs[0], "items": {"fwd": tabs[1]}}
    pool = torch.randn(n, T, T, device=dev, generator=g) / T
    dinv = (torch.eye(T, device=dev)
            + torch.randn(n, T, T, device=dev, generator=g) / (4 * T))
    y2 = torch.randn(n, T, device=dev, generator=g)
    got, ref = y2.clone(), y2.clone()
    SW.run_sweep(pool, dinv, got, plan, "fwd")
    SW.run_sweep_ref(pool, dinv, ref, plan, "fwd")
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not err <= TOL_K2 * float(ref.abs().max()):
        raise AssertionError(f"K2 chain disagrees with its twin ({err:.3e})")
    ms = cuda_ms(lambda: SW.run_sweep(pool, dinv, y2.clone(), plan, "fwd"))
    log(f"timing K2 chain of {n} columns ({2 * n - 1} dependent items): "
        f"{ms:.3f} ms, {ms * 1e3 / (2 * n - 1):.2f} us an item; max|d| "
        f"{err:.3e}")
    return ms


def planted_tiles(T, lu, n=6, seed=0):
    """(tiles, clamps): ``n`` random diagonally dominant tiles with zero
    pivots planted by a zero row and column, which stay exactly zero
    through the updates, each clamped once: tile 0 at 0, tile 1 at 0 and
    5, tile 2 at T - 1, and either side of K4's first 32 x 32 block
    step, tile 3 at 31 and tile 4 at 32 (T > 32)."""
    import torch

    rng = np.random.default_rng(seed)
    R = rng.standard_normal((n, T, T))
    M = R + (0 if lu else R.transpose(0, 2, 1)) + 2 * T * np.eye(T)
    planted = ((0, 0), (1, 0), (1, 5), (2, T - 1), (3, 31)) + (
        ((4, 32),) if T > 32 else ())
    for t, k in planted:
        M[t, k, :] = M[t, :, k] = 0.0
    return torch.tensor(M, dtype=torch.float32, device="cuda"), len(planted)


def check_k4(tiles, eps, lu, label, expect=None):
    """K4 against its twin on copies of ``tiles`` (all factored): equal
    clamp counts (and ``expect`` when given), max|d| <= 1e-5 max|ref| on
    the tiles and, for LDLᵗ, on d, and a second K4 run bit-identical to
    the first; returns max|d|."""
    import torch
    from pastix_tpu_torch.numeric import tile_factor as TF

    idx = torch.arange(tiles.shape[0], device=tiles.device)
    got, again, ref = tiles.clone(), tiles.clone(), tiles.clone()
    n_got = torch.zeros((), dtype=torch.int32, device=tiles.device)
    n_again, n_ref = torch.zeros_like(n_got), torch.zeros_like(n_got)
    d_got = TF.tile_factor(got, idx, eps, n_got, lu)
    d_again = TF.tile_factor(again, idx, eps, n_again, lu)
    d_ref = TF.tile_factor_ref(ref, idx, eps, n_ref, lu)
    torch.cuda.synchronize()
    same = torch.equal(got, again) and int(n_got) == int(n_again) and (
        d_got is None or torch.equal(d_got, d_again))
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    ok = same and err <= TOL_K4 * scale and int(n_got) == int(n_ref)
    if expect is not None:
        ok = ok and int(n_got) == expect
    if d_got is not None:
        d_err = float((d_got - d_ref).abs().max())
        ok = ok and d_err <= TOL_K4 * float(d_ref.abs().max())
        err = max(err, d_err)
    log(f"K4 {'LU' if lu else 'LDLT'} {label}: {tiles.shape[0]} tiles, "
        f"clamps {int(n_got)} (twin {int(n_ref)}), max|d|={err:.3e} "
        f"max|ref|={scale:.3e}, two runs "
        f"{'bit-identical' if same else 'DIFFER'} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K4 {label} disagrees with its twin")
    return err


def busiest_level(fact_fn):
    return max(fact_fn.levels, key=lambda lv: sum(c.n_pairs for c in lv.ll))


def busiest_residue(fact_fn):
    return max(fact_fn.levels,
               key=lambda lv: sum(c.n_pairs for c in lv.schur)).schur


def analyzed(A, cfg, dev, schur=None):
    from pastix_tpu_torch import Pastix

    s = Pastix(A, cfg, device=dev)
    if schur is not None:
        s.set_schur_unknowns(schur)
    t = {}
    for phase in ("order", "symbfact", "analyze"):
        t0 = time.perf_counter()
        getattr(s, phase)()
        t[phase] = time.perf_counter() - t0
    return s, t


def last_plane(nx):
    """The Schur unknowns: the plane z = nx-1, the last nx^2 unknowns of
    the generator's lexicographic numbering."""
    n = nx ** 3
    return np.arange(n - nx * nx, n)


def schur_reference(A, schur):
    """A22 - A21 A11^-1 A12 in fp64, through a sparse LU of A11."""
    import scipy.sparse.linalg as spla

    M = A.to_scipy().tocsc()
    rest = np.setdiff1d(np.arange(A.n), schur)
    A11 = M[rest][:, rest].tocsc()
    X = spla.splu(A11).solve(M[rest][:, schur].toarray())
    return M[schur][:, schur].toarray() - M[schur][:, rest] @ X


def counters():
    from pastix_tpu_torch.numeric import block as BK
    from pastix_tpu_torch.numeric import cache as CA
    from pastix_tpu_torch.numeric import chol_inv as CI
    from pastix_tpu_torch.numeric import dma_probe as DP
    from pastix_tpu_torch.numeric import fused as FU
    from pastix_tpu_torch.numeric import leftlook as LL
    from pastix_tpu_torch.numeric import pipelined as PL
    from pastix_tpu_torch.numeric import slab as SB
    from pastix_tpu_torch.numeric import sweep_kernels as SW
    from pastix_tpu_torch.numeric import tile_factor as TF

    return {"K1": LL.gemm_scatter_ll, "K2": SW.run_sweep,
            "K3": PL.gemm_scatter_pipelined, "K4": TF.tile_factor,
            "K5": BK.gemm_scatter_block, "K6": SB.gemm_scatter_slab,
            "K7": CI.chol_inv_pool, "K8": CI.chol_inv,
            "K9": FU.gemm_scatter_fused, "K10": FU.gemm_scatter_blockspec,
            "K11": CA.gemm_scatter_vcache, "K12": CA.gemm_scatter_mp,
            "K13": DP.probe}


def reset_counts():
    from pastix_tpu_torch.numeric import leftlook as LL

    for fn in counters().values():
        fn.launches = fn.twin_launches = 0
    LL.gemm_scatter_ll.half_launches = 0


def read_counts(path, need, forbid=()):
    """The launch counts since :func:`reset_counts`; fails unless every
    kernel of ``need`` launched, none of ``forbid`` did and no twin ran."""
    launches = {k: fn.launches for k, fn in counters().items()}
    twins = {k: fn.twin_launches for k, fn in counters().items()}
    log(f"  {path}: launches {launches}, twin calls {twins}")
    if (min((launches[k] for k in need), default=1) == 0
            or max(twins.values()) != 0
            or any(launches[k] for k in forbid)):
        raise AssertionError(
            f"the {path} did not run through all of {need}, ran one of "
            f"{forbid}, or ran a twin")
    return launches


def shift_invert(nx):
    """poisson_3d(nx) - σI, σ halfway between the two smallest eigenvalues
    of the 7-point Laplacian, λ = Σ 2 - 2 cos(k π / (nx + 1)): exactly one
    negative eigenvalue.  Returns (matrix, σ)."""
    import scipy.sparse as sp
    from pastix_tpu_torch.generators import poisson_3d
    from pastix_tpu_torch.sparse import SparseMatrix

    mu = lambda k: 2.0 - 2.0 * np.cos(k * np.pi / (nx + 1))
    sigma = (3 * mu(1) + 2 * mu(1) + mu(2)) / 2
    M = (poisson_3d(nx).to_scipy() - sigma * sp.eye(nx ** 3)).tocsc()
    return SparseMatrix.from_scipy(M, symmetric_storage=True), sigma


def kind_cfg(kind, upd="bfloat16"):
    from pastix_tpu_torch.config import PastixConfig

    return PastixConfig(tile_size=128, update_dtype=upd, factorization=kind)


def drive(path, A, cfg, dev, need, schur=None, forbid=()):
    """One path at full width, its counts set to 0 just before and read
    just after: order, symbfact, analyze, factorize twice (the second
    timed), then a refined solve of b = A.1 (``schur``: ``get_schur`` and
    ``solve_with_schur``) to a fp64 residual <= 1e-10.  Returns (solver,
    launches, numbers)."""
    import torch
    from pastix_tpu_torch.numeric import leftlook as LL

    dev_ = torch.device(dev)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev_)
    s, t = analyzed(A, cfg, dev, schur=schur)
    lay = s.layout
    npools = 2 if cfg.factorization.name == "LU" else 1
    pool_gib = npools * lay.npool * lay.T ** 2 * 4 / 2 ** 30
    log(f"{path}: n={A.n} T={lay.T} nbc={lay.nbc} npool={lay.npool} "
        f"pools={pool_gib:.3f} GiB levels={s.report.n_levels} "
        f"dense_tail_m={s.report.dense_tail_m}"
        + (f" schur={schur.size}" if schur is not None else ""))
    log(f"  order {t['order']:.3f} s  symbfact {t['symbfact']:.3f} s  "
        f"analyze {t['analyze']:.3f} s")
    fact_s = []
    for _ in range(2):
        s.factorize()
        fact_s.append(s.report.fact_time)
    gflops = s.report.fact_flops / fact_s[1] / 1e9
    log(f"  factorize {fact_s[0] * 1e3:.1f} ms (first), "
        f"{fact_s[1] * 1e3:.1f} ms (second); useful {gflops:.1f} GFLOP/s "
        f"(flops {s.report.fact_flops:.4e}, padded "
        f"{s.report.fact_flops_padded:.4e}); static_pivots "
        f"{s.report.static_pivots}")
    M = A.to_scipy()
    b = M @ np.ones(A.n)
    get_ms = None
    if schur is None:
        x = s.solve(b)
        what = "solve+refine"
    else:
        t0 = time.perf_counter()
        S = s.get_schur()
        get_ms = (time.perf_counter() - t0) * 1e3
        asym = float(np.abs(S - S.T).max())
        log(f"  get_schur {S.shape} in {get_ms:.1f} ms, finite "
            f"{bool(np.isfinite(S).all())}, max|S - S^T| {asym}")
        if S.shape != (schur.size, schur.size) or not np.isfinite(S).all():
            raise AssertionError("Schur complement has the wrong shape or "
                                 "is not finite")
        if npools == 1 and asym != 0:
            raise AssertionError("Schur complement is not symmetric")
        x = s.solve_with_schur(b)
        what = "solve_with_schur"
    res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
    peak = torch.cuda.max_memory_allocated(dev_) / 2 ** 30
    log(f"  {what} {s.report.solve_time * 1e3:.1f} ms, refine_iters "
        f"{s.report.refine_iters}, residual {s.report.residual:.3e} "
        f"(original order {res:.3e}), max|x-1| {np.abs(x - 1).max():.3e}")
    log(f"  peak device memory {peak:.3f} GiB")
    if x.shape != (A.n,) or not np.isfinite(x).all():
        raise AssertionError("solution has the wrong shape or is not finite")
    if not max(res, s.report.residual) <= TOL_RES:
        raise AssertionError(f"{path}: residual {res:.3e} above {TOL_RES}")
    launches = read_counts(path, need, forbid)
    log(f"  K1 launches on 128 x 64 halves: "
        f"{LL.gemm_scatter_ll.half_launches} of {launches['K1']}")
    if schur is None:
        # K2: one launch a sweep direction, a fwd+bwd pair a precondition
        # (the first solve and one a refinement step)
        pairs = s.report.refine_iters + 1
        log(f"  K2 launches {launches['K2']} for {pairs} fwd+bwd sweep "
            f"pairs")
        if launches["K2"] > 2 * pairs:
            raise AssertionError(f"{path}: more than 2 K2 launches a "
                                 "fwd+bwd sweep pair")
    return s, launches, {
        "fact_ms": fact_s[1] * 1e3, "gflops": gflops,
        "solve_ms": s.report.solve_time * 1e3, "get_schur_ms": get_ms,
        "iters": s.report.refine_iters,
        "residual": s.report.residual, "static_pivots": s.report.static_pivots,
        "tiles": lay.npool, "levels": s.report.n_levels,
        "pool_gib": pool_gib, "peak_gib": peak,
    }


def k1_lists(solver, lv):
    """The K1 lists of one level as (chunks, kwargs, dst, src): LDLᵗ the
    scaled pass, LU the pool pass and its pool_u mirror."""
    f = solver.factors
    if f.pool_u is not None:
        out = [(lv.ll, {"src_pool": f.pool_u}, f.pool, "pool")]
        if lv.ll_nd:
            out.append((lv.ll_nd, {"src_pool": f.pool}, f.pool_u, "pool_u"))
        return out
    if f.d is not None:
        return [(lv.ll, {"d": f.d}, f.pool, "pool")]
    return [(lv.ll, {}, f.pool, "pool")]


def k3_lists(solver, lv):
    """The K3 lists of one level, as :func:`k1_lists`."""
    f = solver.factors
    if f.pool_u is not None:
        out = [(lv.schur, {"src_pool": f.pool_u}, f.pool, "pool")]
        if lv.schur_nd:
            out.append((lv.schur_nd, {"src_pool": f.pool}, f.pool_u,
                        "pool_u"))
        return out
    return [(lv.schur, {"d": f.d} if f.d is not None else {}, f.pool,
             "pool")]


def upd_of(solver):
    """The torch dtype of the solver's trailing updates."""
    import torch

    return torch.bfloat16 if solver.config.update_dtype else torch.float32


def e2_timed(name, run, run_ref, lists, T, pair_flops, upd):
    """One level's E2 lists (``k1_lists``/``k3_lists``) run as one step
    on copies of their pools with ``upd`` operands, kernel and twin, with
    the bound at that dtype's peak."""
    other = {"pool": "pool_u", "pool_u": "pool"}
    pools = {}
    for _, kw, pool, key in lists:
        pools[key] = pool
        if "src_pool" in kw:
            pools[other[key]] = kw["src_pool"]
    work = {key: pool.clone() for key, pool in pools.items()}

    def step(fn):
        for chunks, kw, _, key in lists:
            kw = dict(kw)
            if "src_pool" in kw:
                kw["src_pool"] = work[other[key]]
            fn(work[key], chunks, upd, **kw)

    ms = cuda_ms(lambda: step(run))
    plain = cuda_ms(lambda: step(run_ref))
    bd = e2_bound_lists(
        [(c, key, other[key] if "src_pool" in kw else key)
         for c, kw, _, key in lists], T, pair_flops, upd)
    pairs = sum(ch.n_pairs for c, _, _, _ in lists for ch in c)
    log(f"timing {name} ({sum(len(c) for c, _, _, _ in lists)} chunks, "
        f"{pairs} pairs, {str(upd)[6:]}): kernel {ms:.3f} ms, twin "
        f"{plain:.3f} ms, bound {bd[0]:.4f} ms ({bd[1]})")
    del work, pools
    return ms, plain, bd


def k4_timed(solver, lu):
    """K4 on the busiest level's diagonal tiles of A (most tiles), kernel,
    twin and, for LU, ``torch.linalg.lu_factor_ex(pivot=False)`` (the same
    function when no pivot is clamped); each call factors a fresh copy,
    whose time is measured alone and taken off.  Bound: 2/3 T^3 (LU) or
    1/3 T^3 (LDLᵗ) flop per tile at the fp32 peak, or the bytes per tile at
    the memory rate: LU reads and writes the tile (2 T^2 floats), LDLᵗ
    reads its lower triangle and writes the tile and the pivots
    (T(T+1)/2 + T^2 + T floats)."""
    import scipy.sparse as sp
    import torch
    from pastix_tpu_torch.numeric import tile_factor as TF
    from pastix_tpu_torch.numeric.kernels import tri_inv_batch

    lay = solver.layout
    T = lay.T
    lv = max(solver._fact_fn.levels, key=lambda lv: lv.diag.numel())
    vals = torch.as_tensor(sp.coo_matrix(solver._A_perm).data.astype(
        np.float32), device=lv.diag.device)
    pools = solver._coef_fn(vals)
    pool = pools[0] if isinstance(pools, tuple) else pools
    tiles = pool[lv.diag].clone()
    del pools, pool
    B = tiles.shape[0]
    work = tiles.clone()
    idx = torch.arange(B, device=tiles.device)
    npiv = torch.zeros((), dtype=torch.int32, device=tiles.device)
    eps = 1e-14 * float(abs(solver._A_perm).max())
    copy_ms = cuda_ms(lambda: work.copy_(tiles))
    ms = cuda_ms(lambda: (work.copy_(tiles),
                          TF.tile_factor(work, idx, eps, npiv, lu))) - copy_ms
    plain = cuda_ms(lambda: (work.copy_(tiles),
                             TF.tile_factor_ref(work, idx, eps, npiv, lu)),
                    reps=2) - copy_ms
    lib = None
    if lu:
        lib = cuda_ms(lambda: torch.linalg.lu_factor_ex(tiles, pivot=False))
    floats = 2 * T * T if lu else T * (T + 1) // 2 + T * T + T
    bd = bound(B * (2.0 if lu else 1.0) / 3.0 * T ** 3, PEAK_FP32,
               B * floats * 4)
    log(f"timing K4 {'LU' if lu else 'LDLT'} busiest level ({B} tiles): "
        f"kernel {ms:.3f} ms, twin {plain:.3f} ms, bound {bd[0]:.4f} ms "
        f"({bd[1]}), lu_factor_ex(pivot=False) "
        f"{'n/a' if lib is None else f'{lib:.3f} ms'}")
    err = check_k4(tiles, eps, lu, f"{'LU' if lu else 'LDLT'} path busiest "
                   "level")
    # the inverses the factorization takes after K4 (numeric/factorize.py:
    # LU U^-1 and the unit L^-1, LDLᵗ the unit L^-1), on the same tiles
    work.copy_(tiles)
    TF.tile_factor(work, idx, eps, npiv, lu)
    tri = ((lambda: (tri_inv_batch(work, upper=True),
                     tri_inv_batch(work, unit=True))) if lu
           else (lambda: tri_inv_batch(work, unit=True)))
    tri_ms = cuda_ms(tri)
    log(f"timing tri_inv_batch on the same {B} factored tiles "
        f"({'two calls, upper then unit' if lu else 'one call, unit'}): "
        f"{tri_ms:.3f} ms")
    return ms, plain, bd, lib, err, tri_ms


def factor_kernels(solver, num, launches):
    """One more ``factorize()`` of a solver under ``torch.profiler``: K4's
    device time summed by kernel name (``tile_factor_kernel``) and its
    share of ``num["fact_ms"]`` (the path's second, unprofiled call), the
    run's device time over every kernel, copy and fill, and its eight
    longest kernels by name, logged; the numbers go into ``num``.  K4's
    profiled launches must be those of one factorization (half of the
    path's ``launches``, which counted two).  Where the path launched K6,
    K6 is summed and checked so (its kernels by :data:`K6_NAMES`), its
    numbers in ``num`` as ``k6_device_ms`` and ``k6_share``."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solver.factorize()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    k4 = [r for r in rows if "tile_factor_kernel" in r[0]]
    k4_ms, k4_n = sum(r[1] for r in k4), sum(r[2] for r in k4)
    log(f"  one factorize under the profiler: device {total:.3f} ms; K4 "
        f"{k4_ms:.3f} ms in {k4_n} launches (path's count "
        f"{launches['K4'] // 2} a factorization), "
        f"{100 * k4_ms / num['fact_ms']:.1f} % of fact_ms "
        f"{num['fact_ms']:.1f}")
    for name, ms, n in rows[:8]:
        log(f"    {ms:9.3f} ms {n:5d}x {name[:100]}")
    if not total or k4_n != launches["K4"] // 2:
        raise AssertionError("the profiler did not see one factorization's "
                             "K4 launches")
    num.update(k4_device_ms=k4_ms, k4_share=k4_ms / num["fact_ms"],
               fact_device_ms=total)
    if launches["K6"]:
        k6 = [r for r in rows if re.search(K6_NAMES, r[0])]
        k6_ms, k6_n = sum(r[1] for r in k6), sum(r[2] for r in k6)
        log(f"  K6: {k6_ms:.3f} ms in {k6_n} launches (path's count "
            f"{launches['K6'] // 2} a factorization), "
            f"{100 * k6_ms / num['fact_ms']:.1f} % of fact_ms")
        if k6_n != launches["K6"] // 2:
            raise AssertionError("the profiler did not see one "
                                 "factorization's K6 launches")
        num.update(k6_device_ms=k6_ms, k6_share=k6_ms / num["fact_ms"])


def k1_gather_timed(lists, T):
    """The per-chunk bf16 operand gather of ``gemm_scatter_ll`` alone
    over one level's K1 lists (CUDA events), as the wrapper runs it."""
    import torch

    nu = max(c.cu.numel() for chunks, _, _, _ in lists for c in chunks)
    pool = lists[0][2]
    cache = torch.empty((nu, T, T), dtype=torch.bfloat16, device=pool.device)

    def run():
        for chunks, kw, pool, _ in lists:
            src = kw.get("src_pool", pool)
            for c in chunks:
                cache[: c.cu.numel()].copy_(src.index_select(0, c.cu))

    return cuda_ms(run)


def check_lists(check, lists, label, errs, key, upd):
    """``check`` (check_k1 / check_k3) on each list of
    ``k1_lists``/``k3_lists`` with ``upd`` operands; the largest max|d|
    goes to ``errs[key]``."""
    for chunks, kw, pool, side in lists:
        errs[key] = max(errs[key], check(pool, chunks, upd,
                                         f"{label} {side} {str(upd)[6:]}",
                                         **kw))


def main_path(nx, dev, errs):
    """Phases 4 and 5: the LLᵗ main path, then K1 (busiest level and the
    dense tail's pre-pass) and K2 against their twins and timed at its
    shapes."""
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.generators import poisson_3d
    from pastix_tpu_torch.numeric import leftlook as LL

    s, launches, num = drive(
        f"main path poisson_3d({nx})", poisson_3d(nx),
        kind_cfg(Factorization.LLT), dev, ("K1", "K2"))
    lv, upd = busiest_level(s._fact_fn), upd_of(s)
    tail = [(s._fact_fn.tail, {}, s.factors.pool, "pool")]
    check_lists(check_k1, k1_lists(s, lv), "main path busiest level", errs,
                "K1", upd)
    check_lists(check_k1, tail, "main path tail", errs, "K1", upd)
    errs["K2"] = max(errs["K2"], check_k2(s, 1, seed=0))
    k1 = e2_timed("K1 main path busiest level", LL.gemm_scatter_ll,
                  LL.gemm_scatter_ll_ref, k1_lists(s, lv), s.layout.T,
                  k1_flops, upd)
    shape = lambda chunks: [
        (c.nseg, c.n_pairs, int((c.seg_ptr[1:] - c.seg_ptr[:-1]).max()))
        for c in chunks]
    log(f"  K1 chunks (segments, pairs, longest segment): busiest level "
        f"{shape(lv.ll)}; tail pre-pass {shape(s._fact_fn.tail)}")
    gather = k1_gather_timed(k1_lists(s, lv), s.layout.T)
    log(f"  K1 busiest level: wrapper {k1[0]:.3f} ms, its bf16 operand "
        f"gather alone {gather:.3f} ms ({gather / k1[0]:.1%}), kernel "
        f"{k1[0] - gather:.3f} ms")
    k1t = e2_timed("K1 main path tail pre-pass", LL.gemm_scatter_ll,
                   LL.gemm_scatter_ll_ref, tail, s.layout.T, k1_flops, upd)
    gather_t = k1_gather_timed(tail, s.layout.T)
    log(f"  K1 tail pre-pass: wrapper {k1t[0]:.3f} ms, gather alone "
        f"{gather_t:.3f} ms ({gather_t / k1t[0]:.1%}), kernel "
        f"{k1t[0] - gather_t:.3f} ms")
    k2 = k2_timed(s)
    k2_chain_timed(s.device)
    return launches, num, k1, k2


def lu_path(nx, dev, errs):
    """Phase 7: the LU path, then K1 cross-pool, K2's LU sweeps and K4 LU
    against their twins and timed at its busiest level."""
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.generators import convection_diffusion_3d
    from pastix_tpu_torch.numeric import leftlook as LL

    s, launches, num = drive(
        f"LU path convection_diffusion_3d({nx})", convection_diffusion_3d(nx),
        kind_cfg(Factorization.LU), dev, ("K1", "K2", "K4"))
    lv, upd = busiest_level(s._fact_fn), upd_of(s)
    check_lists(check_k1, k1_lists(s, lv), "LU path busiest level", errs,
                "K1x", upd)
    errs["K2lu"] = max(errs["K2lu"], check_k2(s, 1, seed=0))
    k1x = e2_timed("K1 src_pool LU path busiest level", LL.gemm_scatter_ll,
                   LL.gemm_scatter_ll_ref, k1_lists(s, lv), s.layout.T,
                   k1_flops, upd)
    k2lu = k2_timed(s)
    factor_kernels(s, num, launches)
    k4lu = k4_timed(s, lu=True)
    errs["K4lu"] = max(errs["K4lu"], k4lu[4])
    num["tri_inv_ms"] = k4lu[5]
    return launches, num, k1x, k2lu, k4lu


def ldlt_path(nx, dev, errs):
    """Phase 8: the LDLᵗ path (fp32 updates), the inertia, K1 scaled and
    K4 LDLᵗ against their twins and timed at its shapes and dtype; then
    what bf16 updates leave on this matrix (printed, not checked)."""
    from pastix_tpu_torch import Pastix
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.numeric import leftlook as LL

    LDLT = Factorization.LDLT
    A, sigma = shift_invert(nx)
    b = A.to_scipy() @ np.ones(A.n)
    log(f"LDLT matrix: poisson_3d({nx}) - {sigma:.6g} I")
    s, launches, num = drive(
        f"LDLT path poisson_3d({nx}) - sigma I fp32 updates", A,
        kind_cfg(LDLT, None), dev, ("K1", "K2", "K4"))
    nneg = int((s.factors.d < 0).sum())
    log(f"  negative pivots {nneg}, clamped {s.report.static_pivots}")
    if s.report.static_pivots == 0 and nneg != 1:
        raise AssertionError(f"{nneg} negative pivots; the matrix has one "
                             "negative eigenvalue")
    lv, upd = busiest_level(s._fact_fn), upd_of(s)
    check_lists(check_k1, k1_lists(s, lv), "LDLT path busiest level", errs,
                "K1d", upd)
    errs["K2"] = max(errs["K2"], check_k2(s, 1, seed=8))
    k1d = e2_timed("K1 d LDLT path busiest level", LL.gemm_scatter_ll,
                   LL.gemm_scatter_ll_ref, k1_lists(s, lv), s.layout.T,
                   k1_flops, upd)
    factor_kernels(s, num, launches)
    k4ldlt = k4_timed(s, lu=False)
    errs["K4ldlt"] = max(errs["K4ldlt"], k4ldlt[4])
    num["tri_inv_ms"] = k4ldlt[5]
    x0 = s.solve(b, refine=False)
    del s, lv
    # not a check: bf16 trailing updates on this nearly singular matrix
    # leave an error the Richardson refinement does not contract
    p = Pastix(A, kind_cfg(LDLT), device=dev)
    x1 = p.solve(b, refine=False)
    p.solve(b)
    log(f"  bf16 updates instead (informational): unrefined max|x-1| "
        f"{np.abs(x1 - 1).max():.3e} (fp32 updates {np.abs(x0 - 1).max():.3e}"
        f"), refined residual {p.report.residual:.3e} after "
        f"{p.report.refine_iters} iterations")
    return launches, num, k1d, k4ldlt


def schur_path(kind, A, nx, upd, key, dev, errs):
    """Phases 6, 9 and 10: a Schur path (the plane z = nx-1) under
    ``kind``, then K3 (its variant for LU and LDLᵗ) against its twin and
    timed at its busiest residue level, at the path's update dtype."""
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.numeric import pipelined as PL

    LLT, LU, LDLT = Factorization.LLT, Factorization.LU, Factorization.LDLT
    need = ("K1", "K2", "K3") + (() if kind == Factorization.LLT
                                 else ("K4",))
    s, launches, num = drive(f"{kind.name} Schur path (nx={nx})", A,
                             kind_cfg(kind, upd), dev, need,
                             schur=last_plane(nx))
    check_lists(check_k1, k1_lists(s, busiest_level(s._fact_fn)),
                f"{kind.name} Schur path busiest level", errs,
                {LLT: "K1", LU: "K1x", LDLT: "K1d"}[kind], upd_of(s))
    k2key = "K2lu" if kind == Factorization.LU else "K2"
    errs[k2key] = max(errs[k2key], check_k2(s, 1, seed=6))
    lv = max(s._fact_fn.levels,
             key=lambda lv: sum(c.n_pairs for c in lv.schur))
    check_lists(check_k3, k3_lists(s, lv),
                f"{kind.name} Schur path busiest level", errs, key, upd_of(s))
    timed = e2_timed(f"K3 {kind.name} busiest residue level",
                     PL.gemm_scatter_pipelined, PL.gemm_scatter_pipelined_ref,
                     k3_lists(s, lv), s.layout.T, k3_flops, upd_of(s))
    return launches, num, timed


def check_variants(dev, errs, sch24):
    """Phase 3 for slice 2: K1 scaled and cross-pool (with a forced
    "full" plan), K2's LU sweeps, K4 on a level's diagonal tiles of A
    and on planted zero pivots, K3 scaled and cross-pool on the Schur
    layouts (Schur = ``sch24``), and ``get_schur`` under LU against a
    sparse LU, all on size-24 layouts at T=128."""
    import scipy.sparse as sp
    import torch
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.generators import convection_diffusion_3d
    from pastix_tpu_torch.numeric import leftlook as LL

    bf16, fp32 = torch.bfloat16, torch.float32
    LU, LDLT = Factorization.LU, Factorization.LDLT
    A24s, _ = shift_invert(24)
    A24c = convection_diffusion_3d(24)
    for kind, A24, key in ((LDLT, A24s, "K1d"), (LU, A24c, "K1x")):
        ks, _ = analyzed(A24, kind_cfg(kind), dev)
        ks.factorize()
        lv = busiest_level(ks._fact_fn)
        for chunks, kw, pool, side in k1_lists(ks, lv):
            for upd, name in ((bf16, "bf16"), (fp32, "fp32")):
                errs[key] = max(errs[key], check_k1(
                    pool, chunks, upd,
                    f"{kind.name} {side} busiest level {name} "
                    f"modes={sorted({c.mode for c in chunks})}", **kw))
        if kind == LU:
            # a forced "full" plan: a from the destination pool, never
            # from the cache filled from src_pool
            lay = ks.layout
            _, incoming, _ = LL.regroup_left(lay.levels, lay.blk_col, None)
            li = int(np.argmax([i[0].size for i in incoming]))
            ga, gb, gd = incoming[li][:3]
            full = LL.ll_plan(LL.build_ll_schedule(
                ga, gb, gd, group=4, cap=1024, mode="full",
                rb=(lay.row_lo, lay.row_hi), T=lay.T), dev)
            for upd, name in ((bf16, "bf16"), (fp32, "fp32")):
                errs[key] = max(errs[key], check_k1(
                    ks.factors.pool, full, upd, f"LU pool forced full {name}",
                    src_pool=ks.factors.pool_u))
            for R in (1, 3):
                errs["K2lu"] = max(errs["K2lu"], check_k2(ks, R, seed=R))
        # K4 on the busiest level's diagonal tiles of A and planted pivots
        vals = torch.as_tensor(
            sp.coo_matrix(ks._A_perm).data.astype(np.float32), device=dev)
        pools = ks._coef_fn(vals)
        pool = pools[0] if kind == LU else pools
        lvd = max(ks._fact_fn.levels, key=lambda lv: lv.diag.numel())
        eps = 1e-14 * float(abs(ks._A_perm).max())
        k4 = "K4lu" if kind == LU else "K4ldlt"
        errs[k4] = max(errs[k4], check_k4(pool[lvd.diag], eps, kind == LU,
                                          "busiest level of A"))
        for T in (32, 64, 128):
            tiles, clamps = planted_tiles(T, kind == LU)
            errs[k4] = max(errs[k4], check_k4(
                tiles, 1e-6, kind == LU, f"planted zero pivots T={T}",
                clamps))
        del ks, pools, pool
    # K3 variants on the Schur layouts (plane z = 23), fp32 for get_schur
    for kind, A24, key in ((LDLT, A24s, "K3d"), (LU, A24c, "K3x")):
        ss, _ = analyzed(A24, kind_cfg(kind, None), dev, schur=sch24)
        ss.factorize()
        lv = max(ss._fact_fn.levels,
                 key=lambda lv: sum(c.n_pairs for c in lv.schur))
        for chunks, kw, pool, side in k3_lists(ss, lv):
            for upd, name in ((bf16, "bf16"), (fp32, "fp32")):
                errs[key] = max(errs[key], check_k3(
                    pool, chunks, upd,
                    f"{kind.name} Schur {side} busiest level {name}", **kw))
        if kind == LU:
            S = ss.get_schur()
            S_ref = schur_reference(A24, sch24)
            s_err = float(np.abs(S - S_ref).max() / np.abs(S_ref).max())
            log(f"get_schur LU convection_diffusion_3d(24) {S.shape} fp32 "
                f"updates: max|S - S_ref|/max|S_ref| = {s_err:.3e}")
            if not s_err <= TOL_S:
                raise AssertionError(f"LU get_schur off by {s_err:.3e}")
        del ss


def pair_arrays(c, T):
    """(a, b, dst, k, lo, hi) of every pair of one K3, K5, K6 or K9
    chunk as numpy arrays: a's tile (K3: its position in the chunk's
    operand form, see :func:`e2_work`), b's, the dst tile, the source
    column (or None) and the rows [lo, hi) of a the pair reads (K6: its
    window, the last two of its six ``pairs()``).  K5 and K9 chunks are
    K3's."""
    p = [None if x is None else x.cpu().numpy().astype(np.int64)
         for x in c.pairs()]
    if len(p) == 6:  # K6
        a, b, dst, k, rl, h = p
        return a, b, dst, k, rl, rl + h
    a, b, dst, k = p
    return a, b, dst, k, np.zeros(a.size, np.int64), np.full(a.size, T)


def e2_work(steps, T):
    """(flops, bytes) of right-looking E2 steps ``(dst, a_src, b_src,
    chunks, scaled)``, run as one: 2 (hi - lo) T^2 flops a pair; each
    distinct tile of each source read once over the rows its pairs read
    (``a_src``/``b_src`` name a pool, fp32, or ``("stream", side)``, the
    level's bf16 panel stream, where a K3 chunk's ``ext_a``/``ext_b``
    positions index it), each dst tile read and written once over the
    rows its pairs change, and the pivot rows of d once."""
    flops, rows, krows = 0.0, {}, set()

    def add(key, idx, lo, hi):
        rows.setdefault(key, []).append((idx, lo, hi))

    for dst, a_src, b_src, chunks, scaled in steps:
        for c in chunks:
            a, b, d, k, lo, hi = pair_arrays(c, T)
            if isinstance(a_src, tuple):
                a, b = c.ext_a.cpu().numpy(), c.ext_b.cpu().numpy()
            flops += float((2.0 * (hi - lo) * T ** 2).sum())
            add(a_src, a, lo, hi)
            add(b_src, b, np.zeros_like(lo), np.full_like(hi, T))
            add(("dst", dst), d, lo, hi)
            if scaled and k is not None:
                krows.update(k.tolist())
    nbytes = 0.0
    for key, parts in rows.items():
        idx = np.concatenate([p[0] for p in parts]).astype(np.int64)
        lo = np.concatenate([p[1] for p in parts])
        hi = np.concatenate([p[2] for p in parts])
        u, inv = np.unique(idx, return_inverse=True)
        tlo = np.full(u.size, T)
        thi = np.zeros(u.size, np.int64)
        np.minimum.at(tlo, inv, lo)
        np.maximum.at(thi, inv, hi)
        per_row = T * (2 if isinstance(key, tuple) and key[0] == "stream"
                       else 4)
        nbytes += (2 if key[0] == "dst" else 1) * float(
            ((thi - tlo) * per_row).sum())
    return flops, nbytes + len(krows) * T * 4


def rl_checked(name, run, run_ref, steps, pools, upd, T, errs, key,
               repeat=False):
    """Right-looking E2 steps ``(dst, a_src, b_src, chunks, kw)`` with
    ``pools`` naming their tensors: each step against its twin on copies
    of its pool (max|d| to ``errs[key]``; ``repeat``: and a second run
    bit-identical to the first), then all steps as one, kernel
    and twin timed, and bound by :func:`e2_work` at the bf16 peak
    (``upd`` bf16) or the fp32 one.  Returns (kernel ms, twin ms, bound,
    the kernel's launches in its timed runs, counted from 0)."""
    import torch

    for dst, _, _, chunks, kw in steps:
        errs[key] = max(errs[key], check_e2(
            name, run, run_ref, pools[dst], chunks, upd,
            f"{key} {dst} {str(upd)[6:]}", repeat=repeat, **kw))
    work = {k: pools[k].clone() for k in {st[0] for st in steps}}

    def step(fn):
        for dst, _, _, chunks, kw in steps:
            fn(work[dst], chunks, upd, **kw)

    reset_counts()
    ms = cuda_ms(lambda: step(run))
    launched = run.launches
    plain = cuda_ms(lambda: step(run_ref))
    flops, nbytes = e2_work(
        [(d, a, b, c, "d" in kw) for d, a, b, c, kw in steps], T)
    bd = bound(flops, PEAK_BF16 if upd == torch.bfloat16 else PEAK_FP32,
               nbytes)
    pairs = sum(c.n_pairs for st in steps for c in st[3])
    log(f"timing {name} {key} ({sum(len(st[3]) for st in steps)} chunks, "
        f"{pairs} pairs, {str(upd)[6:]}): kernel {ms:.3f} ms, twin "
        f"{plain:.3f} ms, bound {bd[0]:.4f} ms ({bd[1]})")
    del work
    return ms, plain, bd, launched


def rl_steps(f, lv, mode, form=None):
    """The E2 steps of one right-looking level as :func:`rl_checked` takes
    them, with the pools and streams they read: ``mode`` stream, block,
    slab or pair (``form``: K3's ``compact`` or ``ab_pack``).  Returns
    (steps, pools, run, run_ref)."""
    import torch
    from pastix_tpu_torch.numeric import block as BK
    from pastix_tpu_torch.numeric import pipelined as PL
    from pastix_tpu_torch.numeric import slab as SB

    lu = f.pool_u is not None
    pools = {"pool": f.pool}
    kw = {} if f.d is None else {"d": f.d}
    if mode == "block":
        return ([("pool", "pool", "pool", lv.blk, kw)], pools,
                BK.gemm_scatter_block, BK.gemm_scatter_block_ref)
    if mode == "slab":
        return ([("pool", "pool", "pool", lv.slab, kw)], pools,
                SB.gemm_scatter_slab, SB.gemm_scatter_slab_ref)
    run = (PL.gemm_scatter_pipelined, PL.gemm_scatter_pipelined_ref)
    if lu:
        pools["pool_u"] = f.pool_u
    if mode == "stream":
        xl = f.pool[lv.tp].to(torch.bfloat16)
        if not lu:
            return ([("pool", ("stream", "l"), ("stream", "l"), lv.full,
                      dict(kw, xab=xl))], pools) + run
        xu = f.pool_u[lv.tp].to(torch.bfloat16)
        steps = [("pool", ("stream", "l"), ("stream", "u"), lv.full,
                  {"xab": (xl, xu)})]
        if lv.nd:
            steps.append(("pool_u", ("stream", "u"), ("stream", "l"),
                          lv.nd, {"xab": (xu, xl)}))
        return (steps, pools) + run
    if form is not None:
        kw = dict(kw, **{form: True})
    if not lu:
        return ([("pool", "pool", "pool", lv.full, kw)], pools) + run
    steps = [("pool", "pool", "pool_u", lv.full, dict(kw, src_pool=f.pool_u))]
    if lv.nd:
        steps.append(("pool_u", "pool_u", "pool", lv.nd,
                      dict(kw, src_pool=f.pool)))
    return (steps, pools) + run


# the cost gate settings that keep every pair of a block or slab plan,
# for a matrix whose levels the reference's defaults (1.8 tiles a pair;
# the slab cost model) leave wholly to the pair kernel
RL_GATE_OPEN = {"block": ("PASTIX_BLOCK_GATE", "100"),
                "slab": ("PASTIX_SLAB_GATE", "0")}
# the kernel each right-looking schedule must launch
RL_KERNEL = {"stream": "K3", "pair": "K3", "pair+compact": "K3",
             "block": "K5", "slab": "K6"}
# K6's kernels in a profile: K1's windowed tensor-core body with fp32 a
# and b (``seg_mma_kernel<T, BN, true, true, SCALED, true>``)
K6_NAMES = r"seg_mma_kernel<\d+, \d+, true, true, (true|false), true>"


def rl_busiest(fact_fn, mode):
    """The level with the most pairs of ``mode``'s kernel."""
    attr = {"block": ("blk",), "slab": ("slab",)}.get(mode, ("full", "nd"))
    return max(fact_fn.levels, key=lambda lv: sum(
        c.n_pairs for a in attr for c in getattr(lv, a)))


def e2_variants(f, ga, gb, gd, gk, nd, dev):
    """The variants of the E2 A/B harness (the reference's ``exp_pipe.py``)
    on one pair list: K3 on the pools at G=1 and G=2, K3 ``ab_pack`` at
    G=1, 2 and 4 (the schedule's group; the port drops its pad pairs), K9
    (``gemm_scatter_fused`` over ``sort_triples``) and K10
    (``gemm_scatter_blockspec`` over a group-1 schedule).  ``f`` holds the
    pools (``pool``, ``pool_u`` for LU) and ``d`` (LDLᵗ, scaled by ``gk``);
    LU takes b from the other pool and adds the pool_u mirror of the pairs
    ``nd``.  Yields (label, errs key, run, run_ref, steps), the steps as
    :func:`rl_checked` takes them."""
    from pastix_tpu_torch.numeric import fused as FU
    from pastix_tpu_torch.numeric import pipelined as PL

    kw = {} if f.d is None else {"d": f.d}
    gk = gk if f.d is not None else None

    def sides(build, extra=None):
        extra = extra or {}
        if f.pool_u is None:
            return [("pool", "pool", "pool", build(ga, gb, gd, gk),
                     dict(kw, **extra))]
        out = [("pool", "pool", "pool_u", build(ga, gb, gd, None),
                dict(extra, src_pool=f.pool_u))]
        if nd.any():
            out.append(("pool_u", "pool_u", "pool",
                        build(ga[nd], gb[nd], gd[nd], None),
                        dict(extra, src_pool=f.pool)))
        return out

    def pipe(G):
        return lambda a, b, d, k: PL.pipeline_plan(
            PL.build_pipeline_schedule(a, b, d, gk=k, group=G), dev)

    k3 = (PL.gemm_scatter_pipelined, PL.gemm_scatter_pipelined_ref)
    for G in (1, 2):
        yield (f"K3 G={G}", "K3", *k3, sides(pipe(G)))
    for G in (1, 2, 4):
        yield (f"K3 ab_pack G={G}", "K3pack", *k3,
               sides(pipe(G), {"ab_pack": True}))
    yield ("K9", "K9", FU.gemm_scatter_fused, FU.gemm_scatter_fused_ref,
           sides(lambda a, b, d, k: FU.fused_plan(
               *FU.sort_triples(a, b, d, k), device=dev)))
    yield ("K10", "K10", FU.gemm_scatter_blockspec,
           FU.gemm_scatter_blockspec_ref,
           sides(lambda a, b, d, k: FU.blockspec_plan(
               PL.build_pipeline_schedule(a, b, d, gk=k), dev)))


def check_chol_inv_kernels(dev, errs):
    """Phase 3 for slice 4: K7 in place on the poisson_3d(24) T=128
    coefinit pool at the level with the most diagonal tiles and panels,
    garbage planted above their diagonals and a pad sentinel in the index
    (L and L⁻¹ against the twin, every other tile bit-identical); K8 on
    the same tiles symmetrized from their lower triangles."""
    import scipy.sparse as sp
    import torch
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.generators import poisson_3d
    from pastix_tpu_torch.numeric import chol_inv as CI

    s, _ = analyzed(poisson_3d(24), kind_cfg(Factorization.LLT), dev)
    lv = max((lv for lv in s._fact_fn.levels if lv.tp.numel()),
             key=lambda lv: lv.diag.numel())
    vals = torch.as_tensor(sp.coo_matrix(s._A_perm).data.astype(np.float32),
                           device=dev)
    pool = s._coef_fn(vals)
    B, T, npool = lv.diag.numel(), pool.shape[1], pool.shape[0]
    g = torch.Generator(device=dev).manual_seed(3)
    pool[lv.diag] += torch.triu(torch.randn(B, T, T, generator=g,
                                            device=dev), 1)
    idx = torch.cat([lv.diag, torch.tensor([npool + 3], device=dev)])
    got, ref = pool.clone(), pool.clone()
    dinv = CI.chol_inv_pool(got, idx)
    dref = CI.chol_inv_pool_ref(ref, idx)
    torch.cuda.synchronize()
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    err = max(rel(got[lv.diag], ref[lv.diag]), rel(dinv, dref))
    rest = torch.ones(npool, dtype=torch.bool, device=dev)
    rest[lv.diag] = False
    same = bool(torch.equal(got[rest], pool[rest])) and not dinv[-1].any()
    ok = err <= TOL_K7 and same
    log(f"K7 busiest fused level ({B} tiles + 1 sentinel, upper garbage): "
        f"max|d|/max|ref| {err:.3e}, other tiles untouched {same} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K7 disagrees with its twin")
    errs["K7"] = max(errs["K7"], err)
    tiles = torch.tril(pool[lv.diag])
    sym = (tiles + torch.tril(tiles, -1).transpose(1, 2)).contiguous()
    L, X = CI.chol_inv(sym)
    Lr, Xr = CI.chol_inv_ref(sym)
    torch.cuda.synchronize()
    err = max(rel(L, Lr), rel(X, Xr))
    log(f"K8 the same tiles symmetrized ({B}): max|d|/max|ref| {err:.3e} "
        f"-> {'ok' if err <= TOL_K7 else 'FAIL'}")
    if not err <= TOL_K7:
        raise AssertionError("K8 disagrees with its twin")
    errs["K8"] = max(errs["K8"], err)
    del s, pool, got, ref


def check_rightlook_kernels(dev, errs):
    """Phase 3 for slices 3 and 4: K3's operand arrays (the panel stream
    ``xab`` plain, ``d`` and LU's (L, Uᵗ) with its mirror; ``compact``
    plain, ``d`` and ``src_pool``), the E2 harness's variants
    (:func:`e2_variants`: K3 on the pools at G=1 and 2, ``ab_pack`` at
    G=1, 2 and 4, K9 and K10, plain, ``d`` and ``src_pool``), K5 and K6
    plain and ``d``, each against its twin in bf16 and fp32, on the
    busiest level's pairs of the poisson_3d(24) (LLᵗ and LDLᵗ) and
    convection_diffusion_3d(24) (LU) T=128 layouts.  K5 keeps every entry
    of the level (gate 100); K6 runs the default slab sizes, its cost gate
    off."""
    import torch
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d
    from pastix_tpu_torch.numeric import block as BK
    from pastix_tpu_torch.numeric import slab as SB
    from pastix_tpu_torch.numeric.factorize import _Level
    from pastix_tpu_torch.numeric.pipelined import (
        build_pipeline_schedule, pipeline_plan,
    )

    LLT, LDLT, LU = Factorization.LLT, Factorization.LDLT, Factorization.LU
    for kind, A in ((LLT, poisson_3d(24)), (LDLT, poisson_3d(24)),
                    (LU, convection_diffusion_3d(24))):
        s, _ = analyzed(A, kind_cfg(kind), dev)
        s.factorize()
        f, lay, T = s.factors, s.layout, s.layout.T
        src = max(lay.levels, key=lambda lv: lv.gemm_a.size)
        ga, gb, gd, gk = src.gemm_a, src.gemm_b, src.gemm_d, src.gemm_k
        nd = np.asarray(src.gemm_nondiag, bool)
        tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        pipe = lambda a, b, d, k=None, ext=None: pipeline_plan(
            build_pipeline_schedule(a, b, d, gk=k, group=2, ext_tiles=ext),
            dev)
        lv = _Level(cols=None, diag=None, tp=tens(src.trsm_panel), tc=None,
                    tcpos=None)
        for upd in (torch.bfloat16, torch.float32):
            lv.full = pipe(ga, gb, gd, gk, ext=src.trsm_panel)
            lv.nd = pipe(ga[nd], gb[nd], gd[nd], ext=src.trsm_panel) if (
                kind == LU and nd.any()) else []
            steps, pools, run, ref = rl_steps(f, lv, "stream")
            for dst, _, _, chunks, kw in steps:
                errs["K3xab"] = max(errs["K3xab"], check_e2(
                    "K3", run, ref, pools[dst], chunks, upd,
                    f"xab {kind.name} {dst} {str(upd)[6:]}", **kw))
            steps, pools, run, ref = rl_steps(f, lv, "pair", "compact")
            for dst, _, _, chunks, kw in steps:
                errs["K3compact"] = max(errs["K3compact"], check_e2(
                    "K3", run, ref, pools[dst], chunks, upd,
                    f"compact {kind.name} {dst} {str(upd)[6:]}", **kw))
            pools = {"pool": f.pool, "pool_u": f.pool_u}
            for label, key, run, ref, steps in e2_variants(
                    f, ga, gb, gd, gk, nd, dev):
                for dst, _, _, chunks, kw in steps:
                    errs[key] = max(errs[key], check_e2(
                        label, run, ref, pools[dst], chunks, upd,
                        f"{kind.name} {dst} {str(upd)[6:]}",
                        repeat=key in ("K9", "K10"), **kw))
            if kind == LU:
                continue
            bp = BK.build_block_plan(ga, gb, gd, gk, lay.blk_row,
                                     lay.blk_col, lay.keys, lay.nbc,
                                     lay.npool, gate=100.0)
            lv.blk = BK.block_plan(bp, lay.blk_row, dev)
            old = os.environ.get("PASTIX_SLAB_GATE")
            os.environ["PASTIX_SLAB_GATE"] = "0"
            try:
                doc = lay.lookup(np.arange(lay.nbc), np.arange(lay.nbc))
                sp_ = SB.build_slab_plan(
                    ga, gb, gd, gk, doc, lay.npool, C=0, H=0,
                    rbounds=(lay.row_lo, lay.row_hi), T=T)
            finally:
                if old is None:
                    del os.environ["PASTIX_SLAB_GATE"]
                else:
                    os.environ["PASTIX_SLAB_GATE"] = old
            lv.slab = SB.slab_plan(sp_, T, dev)
            for mode, key in (("block", "K5"), ("slab", "K6")):
                if not getattr(lv, "blk" if mode == "block" else "slab"):
                    raise AssertionError(f"{key}: no {mode} pairs at nx=24")
                steps, pools, run, ref = rl_steps(f, lv, mode)
                for dst, _, _, chunks, kw in steps:
                    errs[key] = max(errs[key], check_e2(
                        key, run, ref, pools[dst], chunks, upd,
                        f"{kind.name} {str(upd)[6:]}", repeat=True, **kw))
        del s, f, lv


def rightlook_path(label, A, kind, modes, dev, errs):
    """Phase 11, one matrix and kind: the host analysis once, the
    left-looking ``fact_ms`` (second call) for reference, then per
    right-looking schedule of ``modes`` its own factorize program
    (``build_factorize_fn(e2=mode)``) in the solver, the counts set to 0
    just before and read just after: factorize twice (the second timed)
    and a refined solve of b = A.1 to a fp64 residual <= 1e-10 (with the
    peak device memory of both, the panel stream included); the
    schedule's kernel (K3, K5 or K6) must launch, K1 not, and no twin
    may run.  Then the schedule's kernel against its twin at the path's
    busiest level, timed and bound.  Returns {mode: (launches, numbers,
    timed)}."""
    import torch
    from pastix_tpu_torch.numeric.factorize import build_factorize_fn

    s, t = analyzed(A, kind_cfg(kind), dev)
    lay = s.layout
    log(f"{label}: n={A.n} T={lay.T} npool={lay.npool} levels="
        f"{len(lay.levels)} dense_tail_m={s.report.dense_tail_m}; order "
        f"{t['order']:.3f} s symbfact {t['symbfact']:.3f} s analyze "
        f"{t['analyze']:.3f} s")
    for _ in range(2):
        s.factorize()
    left_ms = s.report.fact_time * 1e3
    log(f"  left-looking factorize {left_ms:.1f} ms (second call)")
    M = A.to_scipy()
    b = M @ np.ones(A.n)
    need = ("K2",) + (() if kind.name == "LLT" else ("K4",))
    out = {}
    for mode in modes:
        s._fact_fn = s.factors = None
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fn = build_factorize_fn(lay, s.device, kind,
                                update_dtype=torch.bfloat16,
                                dense_tail=s._dense_tail, e2=mode)
        plan_s = time.perf_counter() - t0
        kept = {"block": "n_block_pairs", "slab": "n_slab_pairs"}.get(mode)
        if kept and not getattr(fn, kept):
            # the reference's cost gate keeps no pair of this matrix: the
            # schedule runs with the gate opened, and says so
            var, val = RL_GATE_OPEN[mode]
            log(f"  {mode}: the default {var} keeps no pair; {var}={val}")
            os.environ[var] = val
            try:
                fn = build_factorize_fn(lay, s.device, kind,
                                        update_dtype=torch.bfloat16,
                                        dense_tail=s._dense_tail, e2=mode)
            finally:
                del os.environ[var]
            plan_s = time.perf_counter() - t0
        s._fact_fn = fn
        reset_counts()
        torch.cuda.reset_peak_memory_stats(s.device)
        fact = []
        for _ in range(2):
            s.factorize()
            fact.append(s.report.fact_time * 1e3)
        x = s.solve(b)
        peak = torch.cuda.max_memory_allocated(s.device) / 2 ** 30
        res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
        log(f"  {mode}: plans {plan_s:.2f} s (block pairs "
            f"{getattr(fn, 'n_block_pairs', 0)}, slab pairs "
            f"{getattr(fn, 'n_slab_pairs', 0)}); factorize {fact[0]:.1f} "
            f"ms (first), {fact[1]:.1f} ms (second; left-looking "
            f"{left_ms:.1f}); solve {s.report.solve_time * 1e3:.1f} ms, "
            f"refine_iters {s.report.refine_iters}, residual "
            f"{s.report.residual:.3e} (original order {res:.3e}); peak "
            f"device memory {peak:.3f} GiB")
        if not np.isfinite(x).all() or not max(res, s.report.residual) <= (
                TOL_RES):
            raise AssertionError(f"{label} {mode}: residual {res:.3e}")
        launches = read_counts(f"{label} {mode}", need + (RL_KERNEL[mode],),
                               forbid=("K1",))
        num = {"fact_ms": fact[1], "left_fact_ms": left_ms,
               "solve_ms": s.report.solve_time * 1e3,
               "iters": s.report.refine_iters,
               "residual": s.report.residual, "plan_s": plan_s,
               "tiles": lay.npool, "peak_gib": peak}
        if kind.name == "LDLT" and mode == "slab":
            factor_kernels(s, num, launches)
        lv = rl_busiest(fn, mode)
        kern = RL_KERNEL[mode]
        steps, pools, run, ref = rl_steps(
            s.factors, lv, "pair" if mode == "pair+compact" else mode,
            "compact" if mode == "pair+compact" else None)
        key = f"{kind.name} {mode}"
        errs.setdefault(key, 0.0)
        timed = rl_checked(kern, run, ref, steps, pools, torch.bfloat16,
                           lay.T, errs, key, repeat=True)
        out[mode] = (launches, num, timed)
        del steps, pools
    k2key = "K2lu" if kind.name == "LU" else "K2"
    errs[k2key] = max(errs[k2key], check_k2(s, 1, seed=11))
    del s
    return out


def chol_two_calls(t):
    """L⁻¹ of symmetric tiles by two library calls: ``cholesky_ex`` and
    ``solve_triangular`` (the yardstick of K7 and K8, used nowhere in
    the port)."""
    import torch

    eye = torch.eye(t.shape[1], device=t.device).expand_as(t)
    L, _ = torch.linalg.cholesky_ex(t)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def k8_tiles(dev, errs):
    """Phase 12: K8 on one tile at T = 32, 64 and 128 (symmetric positive
    definite, numpy seed T) against its twin (1e-5 max|ref|), then
    kernel, twin and :func:`chol_two_calls` timed; one tile of condition
    1e4 at each T (eigenvalues 1 down to 1e-4, evenly in log): L against
    the twin at 1e-5, and X against the fp64 inverse of the same fp32
    tile within the textbook bound T u cond(L) for triangular inversion
    (u = 2^-24; the twin's own X is off by 1.4e-5 to 4.9e-5 there, so
    two summation orders differ by more than 1e-5); and one tile with a
    negative pivot at row 70 % T: NaN exactly where the twin has it
    (lower triangles), the rest within 1e-5.  Kernel and library calls
    are also timed on the card alone (:func:`device_ms`): at small T the
    host's launch overhead outlasts them.  Returns {T: (ms, twin ms,
    bound, two-call ms, device ms, two-call device ms)}."""
    import torch
    from pastix_tpu_torch.numeric import chol_inv as CI

    out = {}
    for T in (32, 64, 128):
        rng = np.random.default_rng(T)
        R = rng.standard_normal((T, T))
        one = torch.tensor((R @ R.T / T + 3 * np.eye(T))[None],
                           dtype=torch.float32, device=dev)
        Q, _ = np.linalg.qr(rng.standard_normal((T, T)))
        M = (Q * np.logspace(0, -4, T)) @ Q.T
        ill = torch.tensor((M + M.T)[None] / 2, dtype=torch.float32,
                           device=dev)
        bad = one.clone()
        bad[0, 70 % T, 70 % T] = -5.0
        rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
        (L, X), (Lr, Xr) = CI.chol_inv(one), CI.chol_inv_ref(one)
        err = max(rel(L, Lr), rel(X, Xr))
        (L, X), (Lr, Xr) = CI.chol_inv(ill), CI.chol_inv_ref(ill)
        L64 = torch.linalg.cholesky(ill.double())
        X64 = torch.linalg.inv(L64)
        ill_l, ill_x, twin_x = rel(L, Lr), rel(X.double(), X64), rel(
            Xr.double(), X64)
        x_bound = T * 2.0 ** -24 * float(torch.linalg.cond(L64[0]))
        (L, X), (Lr, Xr) = CI.chol_inv(bad), CI.chol_inv_ref(bad)
        nan_ok, bad_err = True, 0.0
        for got, ref in ((L, Lr), (torch.tril(X), torch.tril(Xr))):
            nan = torch.isnan(ref)
            nan_ok &= bool(nan.any()) and torch.equal(torch.isnan(got), nan)
            bad_err = max(bad_err, rel(got[~nan], ref[~nan]))
        ms = cuda_ms(lambda: CI.chol_inv(one), reps=20)
        plain = cuda_ms(lambda: CI.chol_inv_ref(one), reps=2)
        lib = cuda_ms(lambda: chol_two_calls(one), reps=20)
        dev_ms = device_ms(lambda: CI.chol_inv(one))
        dev_lib = device_ms(lambda: chol_two_calls(one))
        bd = bound(2.0 / 3.0 * T ** 3, PEAK_FP32,
                   (T * (T + 1) // 2 + 2 * T * T) * 4)
        ok = (err <= TOL_K7 and ill_l <= TOL_K7
              and ill_x <= x_bound and nan_ok and bad_err <= TOL_K7)
        log(f"K8 one tile T={T}: max|d|/max|ref| {err:.3e}; condition 1e4: "
            f"L {ill_l:.3e} from the twin, X {ill_x:.3e} from fp64 (twin "
            f"{twin_x:.3e}, bound {x_bound:.3e}); negative pivot: NaN where "
            f"the twin's {'yes' if nan_ok else 'NO'}, rest {bad_err:.3e}; "
            f"kernel {ms:.4f} ms (on the card alone {dev_ms} ms), twin "
            f"{plain:.3f} ms, bound {bd[0]:.5f} ms ({bd[1]}), cholesky_ex + "
            f"solve_triangular {lib:.4f} ms (on the card {dev_lib} ms) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K8 at T={T} disagrees with its twin")
        errs["K8"] = max(errs["K8"], err, ill_l, bad_err)
        out[T] = (ms, plain, bd, lib, dev_ms, dev_lib)
    return out


def chol_timed(solver, errs):
    """K7 on the level with the most diagonal tiles of the fused path (of
    A's coefinit, fresh copies each call, the copy timed alone and taken
    off), against its twin and against ``cholesky_ex`` +
    ``solve_triangular`` on the same tiles (two library calls, not one);
    K8 on one tile symmetrized (the dense tail's call shape), the same
    three ways.  Bound: 2/3 T^3 flop a tile at the fp32 peak, or the
    tile's bytes at the memory rate: the lower triangle of M read
    (T (T + 1) / 2 floats, all the kernel reads), L and X written.  Returns
    (K7 numbers, K8 numbers), each (ms, twin ms, bound, two-call ms)."""
    import scipy.sparse as sp
    import torch
    from pastix_tpu_torch.numeric import chol_inv as CI

    fn = solver._fact_fn
    lv = max((lv for lv in fn.levels if lv.tp.numel()),
             key=lambda lv: lv.diag.numel())
    dev = lv.diag.device
    vals = torch.as_tensor(sp.coo_matrix(solver._A_perm).data.astype(
        np.float32), device=dev)
    tiles = solver._coef_fn(vals)[lv.diag].clone()
    B, T = tiles.shape[0], tiles.shape[1]
    idx = torch.arange(B, device=dev)
    work = tiles.clone()

    two_calls = chol_two_calls
    copy_ms = cuda_ms(lambda: work.copy_(tiles))
    ms = cuda_ms(lambda: (work.copy_(tiles),
                          CI.chol_inv_pool(work, idx))) - copy_ms
    plain = cuda_ms(lambda: (work.copy_(tiles),
                             CI.chol_inv_pool_ref(work, idx)),
                    reps=2) - copy_ms
    lib = cuda_ms(lambda: two_calls(tiles))
    tile_bytes = (T * (T + 1) // 2 + 2 * T * T) * 4
    bd = bound(B * 2.0 / 3.0 * T ** 3, PEAK_FP32, B * tile_bytes)
    got, ref = tiles.clone(), tiles.clone()
    d1, d2 = CI.chol_inv_pool(got, idx), CI.chol_inv_pool_ref(ref, idx)
    err = max(float((got - ref).abs().max() / ref.abs().max()),
              float((d1 - d2).abs().max() / d2.abs().max()))
    log(f"timing K7 busiest fused level ({B} tiles): kernel {ms:.3f} ms, "
        f"twin {plain:.3f} ms, bound {bd[0]:.4f} ms ({bd[1]}), "
        f"cholesky_ex + solve_triangular (two library calls) {lib:.3f} ms; "
        f"max|d|/max|ref| {err:.3e}")
    if not err <= TOL_K7:
        raise AssertionError("K7 disagrees with its twin at the path level")
    errs["K7"] = max(errs["K7"], err)
    lo = torch.tril(tiles[:1])
    one = (lo + torch.tril(lo, -1).transpose(1, 2)).contiguous()
    ms8 = cuda_ms(lambda: CI.chol_inv(one))
    plain8 = cuda_ms(lambda: CI.chol_inv_ref(one), reps=2)
    lib8 = cuda_ms(lambda: two_calls(one))
    bd8 = bound(2.0 / 3.0 * T ** 3, PEAK_FP32, tile_bytes)
    log(f"timing K8 one tile (the dense tail's call, {solver._dense_tail.q} "
        f"a factorization): kernel {ms8:.3f} ms, twin {plain8:.3f} ms, "
        f"bound {bd8[0]:.5f} ms ({bd8[1]}), cholesky_ex + solve_triangular "
        f"(two library calls) {lib8:.3f} ms")
    return (ms, plain, bd, lib), (ms8, plain8, bd8, lib8)


def fused_path(nx, dev, errs, left_ms, stream_ms):
    """Phase 12: the fused-diagonal LLᵗ path (``PASTIX_FUSED_DIAG=1``) on
    ``poisson_3d(nx)`` with the dense tail, bf16 updates, left-looking and
    right-looking stream (``PASTIX_E2_LL=0``), each through ``drive``: K7
    and K8 must launch (K1, or K3 and not K1), no twin, and
    ``cholesky_ex`` only at the levels without panels (twice each, one
    per factorization).  ``fact_ms`` is set beside the unfused path's of
    phases 4 and 11 (``left_ms``, ``stream_ms``).  Then K7 and K8 timed
    (:func:`chol_timed`).  Returns ({e2: (launches, numbers)}, the stream
    solver, K7 numbers, K8 numbers)."""
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.generators import poisson_3d
    from pastix_tpu_torch.numeric import factorize as F

    out, solver = {}, None
    for e2, base in (("left", left_ms), ("stream", stream_ms)):
        env = {"PASTIX_FUSED_DIAG": "1",
               "PASTIX_E2_LL": "0" if e2 == "stream" else "1"}
        old = {k: os.environ.get(k) for k in env}
        calls, potrf = [], F.potrf_batch
        F.potrf_batch = lambda t: calls.append(int(t.shape[0])) or potrf(t)
        os.environ.update(env)
        try:
            need = ("K2", "K7", "K8") + (("K1",) if e2 == "left" else ("K3",))
            s, launches, num = drive(
                f"fused-DIAG LLT {e2} poisson_3d({nx})", poisson_3d(nx),
                kind_cfg(Factorization.LLT), dev, need,
                forbid=() if e2 == "left" else ("K1",))
        finally:
            F.potrf_batch = potrf
            for k, v in old.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v
        fn = s._fact_fn
        bare = [lv for lv in fn.levels if not lv.tp.numel()]
        fused = len(fn.levels) - len(bare)
        log(f"  {e2}: {fused} fused levels, {len(bare)} without panels; "
            f"K7 {launches['K7']} K8 {launches['K8']} launches, cholesky_ex "
            f"{len(calls)} calls; fact_ms {num['fact_ms']:.1f} (unfused "
            f"{base:.1f}, {num['fact_ms'] / base - 1:+.1%})")
        if not (fn.fused_diag and fn.e2 == e2
                and launches["K7"] == 2 * fused
                and launches["K8"] == 2 * s._dense_tail.q
                and len(calls) == 2 * len(bare)):
            raise AssertionError(f"the fused {e2} path did not fuse every "
                                 "level with panels and the tail")
        num["unfused_fact_ms"] = base
        out[e2] = (launches, num)
        errs["K2"] = max(errs["K2"], check_k2(s, 1, seed=12))
        if e2 == "stream":
            solver = s
        else:
            check_lists(check_k1, k1_lists(s, busiest_level(fn)),
                        "fused-DIAG left busiest level", errs, "K1",
                        upd_of(s))
            k7, k8 = chol_timed(s, errs)
        del s
    return out, solver, k7, k8


def busiest_stream_level(solver):
    """The level with the most pairs of a right-looking solver (its dense
    tail's lower levels when it has one), as phases 13 and 14 take it."""
    levels = (solver._dense_tail.levels_lo if solver._dense_tail is not None
              else solver.layout.levels)
    return max(levels, key=lambda lv: lv.gemm_a.size)


def ab_harness(solver, dev, errs):
    """Phase 13: the reference's E2 A/B harness (``exp_pipe.py``) on two
    pair lists, bf16 and fp32 operands, every variant of
    :func:`e2_variants` against its twin, then kernel and twin timed (CUDA
    events, a warm-up, mean of 5) and bound (:func:`e2_work`): exp_pipe's
    default triples (ng=8192 on a pool of 12000 T=128 tiles, a and b from
    the first half, dst segments of about 3 pairs; numpy default_rng(0)
    drawn as there) and the busiest right-looking level of
    the phase-12 stream solver (``poisson_3d(--nx)`` LLᵗ, its factored
    pool).  The counts are each kernel's launches in its timed runs.
    Returns {(input, dtype, label): (ms, twin ms, bound, launches)}."""
    import types

    import torch

    ng, npool, T, seg = 8192, 12000, 128, 3
    rng = np.random.default_rng(0)
    nsrc = npool // 2
    ga = rng.integers(0, nsrc, ng).astype(np.int32)
    gb = rng.integers(0, nsrc, ng).astype(np.int32)
    ndst = max(1, ng // seg)
    gd = (nsrc + rng.integers(0, min(ndst, npool - nsrc), ng)).astype(
        np.int32)
    P = torch.from_numpy(rng.standard_normal((npool, T, T)).astype(
        np.float32)).to(dev)
    lv = busiest_stream_level(solver)
    inputs = (
        ("exp_pipe", types.SimpleNamespace(pool=P, pool_u=None, d=None),
         (ga, gb, gd)),
        ("poisson level", solver.factors,
         (lv.gemm_a, lv.gemm_b, lv.gemm_d)),
    )
    out = {}
    for name, f, (a, b, d) in inputs:
        log(f"E2 A/B harness, {name}: {a.size} pairs, "
            f"{np.unique(d).size} dst tiles")
        pools = {"pool": f.pool}
        for upd in (torch.bfloat16, torch.float32):
            for label, key, run, ref, steps in e2_variants(
                    f, a, b, d, None, None, dev):
                out[name, str(upd)[6:], label] = rl_checked(
                    f"{label} {name}", run, ref, steps, pools, upd, T, errs,
                    key, repeat=True)
    del P
    return out


def cache_harness(solver, dev, errs):
    """Phase 14: the reference's operand-cache harnesses (``exp_cache.py``,
    ``exp_mp.py``) on phase 13's poisson level, the busiest level of the
    phase-12 stream solver (its factored pool), with ``xab`` the level's
    panel tiles of the pool in bf16.  K11 on
    ``build_pipeline_schedule(chunk=1536, group=2, ext_tiles=panel)`` and
    K12 ``loop`` and ``dot2`` on ``build_mp_schedule(chunk=1536, G)`` at
    G = 4 and 8, each against its twin and against ``kernels.gemm_scatter``
    with bf16 operands (``TOL_E2`` of max|ref|), beside the reference's
    baselines: K3 on the pools at G=2 (exp_cache.py:232), K3 ``xab`` on
    the 1536-pair schedule (:235) and at chunk 6144 (exp_mp.py:329).
    K12 runs twice and must repeat bit for bit.  Every case's kernel and
    twin timed (CUDA events, a warm-up, mean of 5), the level's work
    bound by :func:`e2_work` (the cache counted as
    the bf16 stream, the pools as fp32); launches counted from 0 over the
    timed runs.  Returns {label: (ms, twin ms, bound, launches)}."""
    import torch
    from pastix_tpu_torch.numeric import cache as CA
    from pastix_tpu_torch.numeric import kernels as KN
    from pastix_tpu_torch.numeric import pipelined as PL

    f = solver.factors
    lv = busiest_stream_level(solver)
    ga, gb, gd = lv.gemm_a, lv.gemm_b, lv.gemm_d
    tp = np.asarray(lv.trsm_panel)
    T, ng = f.pool.shape[1], ga.size
    xab = f.pool[torch.as_tensor(tp, device=dev)].to(torch.bfloat16)
    bf16 = torch.bfloat16
    # what the reference checks against: its XLA gemm_scatter, bf16
    # operands (additive, so in batches of 4096 pairs)
    want = f.pool.clone()
    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    for lo in range(0, ng, 4096):
        sl = slice(lo, lo + 4096)
        KN.gemm_scatter(want, tens(ga[sl]), tens(gb[sl]), tens(gd[sl]), bf16)
    touched = tens(np.unique(gd))
    scale = float(want[touched].abs().max())

    sched = PL.build_pipeline_schedule(ga, gb, gd, chunk=1536, group=2,
                                       ext_tiles=tp)
    vplan = CA.vcache_plan(sched, dev)
    x1536 = PL.pipeline_plan(sched, dev)
    log(f"cache harness, poisson level: {ng} pairs, {np.unique(gd).size} "
        f"dst tiles, {tp.size} panel tiles; vcache: {len(vplan.chunks)} "
        f"chunks, CT {vplan.ct} (cache {vplan.ct * T * T * 2 / 2**20:.1f} "
        "MiB against the 50 MB L2)")
    seg_len = np.unique(gd, return_counts=True)[1]
    log(f"  segments={seg_len.size} len: mean={seg_len.mean():.1f} "
        f"med={int(np.median(seg_len))} max={seg_len.max()}")
    def level_bound(steps):
        flops, nbytes = e2_work(steps, T)
        return bound(flops, PEAK_BF16, nbytes)

    # every case runs the level's pairs: bound as K3 on the bf16 stream,
    # or on the fp32 pools for the pools baseline
    stream_bd = level_bound(
        [("pool", ("stream", "l"), ("stream", "l"), x1536, False)])
    cases = [("K11", CA.gemm_scatter_vcache, CA.gemm_scatter_vcache_ref,
              (xab, vplan), "K11", stream_bd)]
    for G in (4, 8):
        mplan = CA.mp_plan(CA.build_mp_schedule(ga, gb, gd, 1536, G, tp), dev)
        padded = int((np.ceil(seg_len / G) * G).sum())
        log(f"  G={G}: padded pairs {padded} (x{padded / ng:.2f}), steps "
            f"{padded // G} ({ng / (padded // G):.1f} real pairs/step), "
            f"{len(mplan.chunks)} chunks, CT {mplan.ct} (cache "
            f"{mplan.ct * T * T * 2 / 2**20:.1f} MiB)")
        for variant in CA.MP_VARIANTS:
            cases.append((f"K12 {variant} G={G}", CA.gemm_scatter_mp,
                          CA.gemm_scatter_mp_ref, (xab, mplan, variant),
                          "K12", stream_bd))
    k3, k3_ref = PL.gemm_scatter_pipelined, PL.gemm_scatter_pipelined_ref
    pools2 = PL.pipeline_plan(PL.build_pipeline_schedule(ga, gb, gd, group=2),
                              dev)
    x6144 = PL.pipeline_plan(PL.build_pipeline_schedule(
        ga, gb, gd, chunk=6144, group=2, ext_tiles=tp), dev)
    on_stream = (lambda p, plan: k3(p, plan, bf16, xab=xab),
                 lambda p, plan: k3_ref(p, plan, bf16, xab=xab))
    cases += [
        ("K3 G=2 pools", lambda p, plan: k3(p, plan, bf16),
         lambda p, plan: k3_ref(p, plan, bf16), (pools2,), "K3",
         level_bound([("pool", "pool", "pool", pools2, False)])),
        ("K3 xab chunk 1536", *on_stream, (x1536,), "K3", stream_bd),
        ("K3 xab chunk 6144", *on_stream, (x6144,), "K3", stream_bd),
    ]
    out = {}
    for label, run, run_ref, args, key, bd in cases:
        got = run(f.pool.clone(), *args)
        if key == "K12" and not torch.equal(got, run(f.pool.clone(), *args)):
            raise AssertionError(f"{label}: two runs differ")
        ref = run_ref(f.pool.clone(), *args)
        torch.cuda.synchronize()
        e_twin = float((got - ref).abs().max())
        e_xla = float((got - want).abs().max())
        ok = max(e_twin, e_xla) <= TOL_E2 * scale
        log(f"{label}: max|d| twin {e_twin:.3e}, gemm_scatter bf16 "
            f"{e_xla:.3e}, max|ref| {scale:.3e} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} disagrees with its twin or with "
                                 "gemm_scatter")
        if key in errs:
            errs[key] = max(errs[key], e_twin)
        del got, ref
        work = f.pool.clone()
        reset_counts()
        ms = cuda_ms(lambda: run(work, *args))
        launched = counters()[key].launches
        plain = cuda_ms(lambda: run_ref(work, *args))
        log(f"timing {label} ({ng} pairs, bf16): kernel {ms:.3f} ms "
            f"({ms * 1e6 / ng:.0f} ns/pair), twin {plain:.3f} ms, bound "
            f"{bd[0]:.4f} ms ({bd[1]}), launches {launched}")
        out[label] = (ms, plain, bd, launched)
        del work
    return out


# exp_dma.py's rows, in its order: (rows of a tile, S, D, steps, reps,
# CTAs (0: one per SM), bytes a bulk copy at most), then its first row on
# fewer CTAs (the card's bytes in flight cut down to one CTA's) and in
# larger pieces (the same count in flight, more bytes a copy)
PROBE_ROWS = (
    [(128, S, D, st, reps, 0, 4096) for S, D, st, reps in (
        (1, 2, 1024, 128), (1, 4, 1024, 64), (1, 8, 512, 64),
        (2, 2, 1024, 64), (4, 2, 1024, 32), (8, 2, 512, 32),
        (16, 2, 256, 32), (32, 2, 128, 32))]
    + [(rows, 1, D, 1024, 64, 0, 4096) for rows in (64, 32)
       for D in (2, 4, 8)]
    + [(rows, 1, D, 512, 64, 0, 4096) for rows in (64, 32)
       for D in (12, 16)]
    + [(128, 1, 2, 1024, 16, c, 4096) for c in (1, 4, 16, 66)]
    + [(128, 1, D, 1024, 4, 1, 4096) for D in (8, 16)]
    + [(128, 1, 2, 1024, 128, 0, pc) for pc in (8192, 16384, 32768)]
    + [(128, 1, 2, 1024, 16, 1, 32768)])


def probe_harness(dev, errs):
    """Phase 15: the reference's copy probe (``exp_dma.py``): a pool of
    12,000 fp32 T=128 tiles (786 MB) drawn as ``exp_dma.py:26-28``, viewed
    as (12000, 128, T), (24000, 64, T) and (48000, 32, T); every row of
    :data:`PROBE_ROWS` with its index table drawn in the reference's order
    (``integers(0, N - S, (steps, D))``).  K13 against ``probe_ref`` (both
    rows of every copy, ``TOL_K13`` of max|ref|), then K13 (its index
    table checked once, before), its twin and one library call timed:
    ``view.index_select`` of one repeat's S-tile runs, times reps (the
    same bytes).  The twin is the closed form, which reads two rows a
    copy, not the copies.  Bound: every copy's bytes over 3.35 TB/s.  The
    log gives the card's bytes in flight (CTAs x 2 D pieces) and, by
    Little's law, the latency they imply at the measured rate.  Launches
    counted from 0 over each row's timed runs.  Returns a list of (rows,
    S, D, steps, reps, ctas, ms, twin ms, bound, library ms, launches)."""
    import torch
    from pastix_tpu_torch.numeric import dma_probe as DP

    npool, T = 12000, 128
    rng = np.random.default_rng(0)
    pool = torch.from_numpy(rng.standard_normal((npool, T, T)).astype(
        np.float32)).to(dev)
    views = {128: pool, 64: pool.view(npool * 2, 64, T),
             32: pool.view(npool * 4, 32, T)}
    out = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for rows, S, D, steps, reps, ctas, pc in PROBE_ROWS:
        view = views[rows]
        idx = torch.as_tensor(rng.integers(0, view.shape[0] - S, (
            steps, D)).astype(np.int32), device=dev)
        got = DP.probe(view, idx, S, reps, ctas=ctas, piece=pc)
        ref = DP.probe_ref(view, idx, S, reps)
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        piece = DP.piece_bytes(S, rows, T, pc)
        label = (f"{rows * T * 4 // 1024} KB tiles, S={S} D={D}"
                 + (f" on {ctas} CTAs" if ctas else "")
                 + (f", {piece // 1024} KB pieces" if pc != DP.PIECE
                    else ""))
        if not err <= TOL_K13:
            raise AssertionError(f"K13 {label}: rel max|d| {err:.3e}")
        errs["K13"] = max(errs["K13"], float((got - ref).abs().max()))
        flat = (idx.long()[:, :, None] + torch.arange(S, device=dev)).reshape(
            -1)
        reset_counts()
        ms = cuda_ms(lambda: DP.probe(view, idx, S, reps, ctas=ctas,
                                      piece=pc, check_idx=False))
        launched = DP.probe.launches
        plain = cuda_ms(lambda: DP.probe_ref(view, idx, S, reps))
        lib = cuda_ms(lambda: view.index_select(0, flat)) * reps
        ncopy = reps * steps * D
        nbytes = ncopy * S * rows * T * 4.0
        bd = bound(0.0, PEAK_FP32, nbytes)
        distinct = np.unique(flat.cpu().numpy()).size * rows * T * 4
        grid = min(ctas or sms, reps * steps)
        flight = grid * 2 * D * piece
        per_piece = ms * 1e3 * grid / (nbytes / piece)  # us a CTA's piece
        log(f"probe {label} ({S * rows * T * 4 // 1024} KB a copy), "
            f"{steps} steps x {reps} reps: rel max|d| {err:.1e}; kernel "
            f"{ms:.3f} ms = {ms * 1e3 / ncopy:.4f} us/copy, "
            f"{nbytes / ms / 1e6:.1f} GB/s; twin (closed form) "
            f"{plain:.3f} ms; index_select x reps {lib:.3f} ms "
            f"({nbytes / lib / 1e6:.1f} GB/s); bound {bd[0]:.3f} ms; "
            f"in flight {flight / 1e6:.3f} MB ({piece} B pieces, "
            f"{per_piece:.3f} us a CTA's piece), Little's latency "
            f"{flight / (nbytes / ms * 1e3) * 1e6:.3f} us; one "
            f"repeat's distinct bytes {distinct / 1e6:.1f} MB (L2 50 MB); "
            f"launches {launched}")
        out.append((rows, S, D, steps, reps, ctas, piece, ms, plain, bd,
                    lib, launched))
    del pool, views
    return out


_SASS = {}  # cuobjdump -sass of each library, dumped once


def instrument(s):
    """Counters of the solver's next solves: the device loop's iterations
    and preconditioner applications, and the host's factored solves (the
    host loop's M⁻¹, one a call whatever the RHS width)."""
    rec = {"dev_iters": 0, "dev_applies": 0, "host_solves": 0}
    dev_fn, raw = s._refine_fn, s._raw_solve_ext
    if dev_fn is not None:
        def counted_dev(*args):
            x, it = dev_fn(*args)
            rec["dev_iters"] += it
            rec["dev_applies"] += dev_fn.applies
            return x, it

        s._refine_fn = counted_dev

    def counted_host(v):
        rec["host_solves"] += 1
        return raw(v)

    s._raw_solve_ext = counted_host
    return rec


def front_door_solver(label, A, cfg, dev, b, need, forbid=()):
    """One solver of phase 16: analyze, factorize twice, solve; its counts
    read (``need`` launched, ``forbid`` and the twins not); then a second
    solve, timed and counted alone: residual <= 1e-10, K2 at most twice a
    preconditioner application.  Returns (solver, x, figures)."""
    import torch

    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    s, t = analyzed(A, cfg, dev)
    fact = []
    for _ in range(2):
        s.factorize()
        fact.append(s.report.fact_time * 1e3)
    s.solve(b)
    read_counts(f"{label}: analysis, factorize, first solve", need, forbid)
    rec = instrument(s)
    reset_counts()
    x = s.solve(b)
    launches = read_counts(f"{label}: second solve",
                           [k for k in need if k == "K2"], forbid)
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
    M = A.to_scipy()
    res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
    applies = rec["dev_applies"] + rec["host_solves"]
    num = {
        "analysis_s": sum(t.values()), "fact_ms": fact,
        "solve_ms": s.report.solve_time * 1e3,
        "refine_ms": s.report.refine_time * 1e3,
        "iters": s.report.refine_iters,
        "host_steps": s.report.refine_iters - rec["dev_iters"],
        "applies": applies, "K2": launches["K2"],
        "residual": s.report.residual, "residual_original_order": res,
        "peak_gib": peak, "dinv": s.factors.dinv is not None,
    }
    log(f"front door {label}: " + json.dumps(num))
    if not max(res, s.report.residual) <= TOL_RES:
        raise AssertionError(f"{label}: residual {res:.3e} above {TOL_RES}")
    if launches["K2"] > 2 * applies:
        raise AssertionError(f"{label}: {launches['K2']} K2 launches for "
                             f"{applies} preconditioner applications")
    return s, x, num


def front_door_path(nx, lu_nx, dev, main_iters):
    """Phase 16: the front door and the refinement methods at full width
    (see the module docstring); each run's figures go to the log."""
    import gc
    import inspect
    import shutil
    import tempfile

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch
    from pastix_tpu_torch import cli
    from pastix_tpu_torch.config import (
        Factorization, IOStrategy, PastixConfig, RefinementMethod, Task,
    )
    from pastix_tpu_torch.distributed import CSCDPart, dspsolve
    from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d
    from pastix_tpu_torch.murge import MurgeSolver
    from pastix_tpu_torch.pastix import pastix
    from pastix_tpu_torch.sparse import SparseMatrix

    io_root = tempfile.mkdtemp(prefix="pastix_front_door_")
    saved = set()

    def cfg(kind, **kw):
        # the first solver of a matrix saves its order, symbol and layout;
        # every later one loads them (one host analysis a matrix)
        io = IOStrategy.LOAD if kind in saved else IOStrategy.SAVE
        saved.add(kind)
        return PastixConfig(
            tile_size=128, update_dtype="bfloat16",
            factorization=Factorization[kind], io_strategy=io,
            io_dir=os.path.join(io_root, kind), **kw)

    try:
        os.makedirs(os.path.join(io_root, "LLT"))
        os.makedirs(os.path.join(io_root, "LU"))
        CG = RefinementMethod.CG
        A = poisson_3d(nx)
        M = A.to_scipy()
        b = M @ np.ones(A.n)
        gc.collect()
        m0 = torch.cuda.memory_allocated(dev)
        need = ("K1", "K2")
        base, _, fast = front_door_solver(
            f"LLT CG poisson_3d({nx})", A, cfg("LLT", refinement=CG), dev, b,
            need)
        for name, kw, forbid in (
                ("GMRES", dict(refinement=RefinementMethod.GMRES), ()),
                ("BICGSTAB", dict(refinement=RefinementMethod.BICGSTAB), ()),
                ("CG device_refine=False", dict(refinement=CG,
                                                device_refine=False), ()),
                ("CG fast_solve=False", dict(refinement=CG, fast_solve=False),
                 ("K2",))):
            s, _, num = front_door_solver(
                f"LLT {name}", A, cfg("LLT", **kw), dev, b,
                [k for k in need if k not in forbid], forbid)
            if (s.factors.dinv is None) != bool(forbid):
                raise AssertionError(f"LLT {name}: dinv is "
                                     f"{'present' if forbid else 'missing'}")
            del s
            gc.collect()
        # num: the last run's, fast_solve=False
        log(f"  peak device memory above the run's start: fast_solve "
            f"{fast['peak_gib']:.3f} GiB, fast_solve=False "
            f"{num['peak_gib']:.3f} GiB")

        # new values on the cached analysis, against a fresh solver
        v = np.array(A.values, dtype=np.float64)
        v[A.rowind == np.repeat(np.arange(A.n), np.diff(A.colptr))] *= 1.1
        A2 = SparseMatrix(A.n, A.colptr, A.rowind, v, A.symmetric_storage)
        reset_counts()
        t0 = time.perf_counter()
        base.factorize(v)
        call_ms = (time.perf_counter() - t0) * 1e3
        x = base.solve(b)
        read_counts("LLT CG factorize(values)", need)
        fresh, xf, _ = front_door_solver(
            "LLT CG fresh solver on the new values", A2, cfg("LLT",
                                                             refinement=CG),
            dev, b, need)
        pool_d = float((base.factors.pool - fresh.factors.pool).abs().max())
        rel = float(np.linalg.norm(x - xf) / np.linalg.norm(xf))
        num = {
            "fact_ms_first": fast["fact_ms"][0],
            "fact_ms_second": fast["fact_ms"][1],
            "refactor_ms": base.report.fact_time * 1e3,
            "refactor_call_ms": call_ms, "iters": base.report.refine_iters,
            "fresh_iters": fresh.report.refine_iters,
            "x_rel_diff": rel, "max_pool_diff": pool_d,
            "residual": base.report.residual,
        }
        log("front door factorize(values): " + json.dumps(num))
        if (base.report.refine_iters != fresh.report.refine_iters
                or not rel <= TOL_REFAC
                or not base.report.residual <= TOL_RES):
            raise AssertionError("factorize(values) disagrees with a fresh "
                                 "solver on the new values")
        del fresh
        gc.collect()

        # the factored solve under scipy's CG
        M2 = A2.to_scipy()
        op = base.as_preconditioner()
        steps = [0]
        tol = ("rtol" if "rtol" in inspect.signature(spla.cg).parameters
               else "tol")
        t0 = time.perf_counter()
        xs, info = spla.cg(M2, b, M=op, atol=0.0, maxiter=main_iters + 2,
                           callback=lambda _: steps.__setitem__(
                               0, steps[0] + 1), **{tol: TOL_RES})
        cg_ms = (time.perf_counter() - t0) * 1e3
        res = float(np.linalg.norm(b - M2 @ xs) / np.linalg.norm(b))
        num = {
            "scipy_cg_steps": steps[0], "max_steps": main_iters + 2,
            "info": int(info), "residual": res, "ms": cg_ms,
            "dtype": str(op.dtype)}
        log("front door as_preconditioner under scipy cg: " + json.dumps(num))
        if info != 0 or not res <= TOL_RES:
            raise AssertionError("scipy cg with as_preconditioner did not "
                                 f"reach {TOL_RES} in {main_iters + 2} steps")

        # the array API and its phase window
        Mc = M.tocsc()
        reset_counts()
        x, rep = pastix(A.n, Mc.indptr, Mc.indices, Mc.data, b,
                        cfg("LLT", end_task=Task.ANALYSE), device=dev)
        if x is not None or rep.fact_time != 0 or rep.n_tiles == 0:
            raise AssertionError("pastix() ORDERING..ANALYSE factored or "
                                 "solved")
        x, rep = pastix(A.n, Mc.indptr, Mc.indices, Mc.data, b,
                        cfg("LLT", end_task=Task.CLEAN), device=dev)
        read_counts("pastix() ORDERING..CLEAN", need)
        res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
        num = {"residual": rep.residual, "residual_original_order": res,
               "iters": rep.refine_iters}
        log("front door pastix(): " + json.dumps(num))
        if not max(res, rep.residual) <= TOL_RES:
            raise AssertionError("pastix() did not reach the residual")

        # clean() gives the card's memory back
        del op
        gc.collect()
        held = torch.cuda.memory_allocated(dev)
        base.clean()
        left = torch.cuda.memory_allocated(dev)
        num = {"before_solver_mib": m0 / 2 ** 20, "held_mib": held / 2 ** 20,
               "after_clean_mib": left / 2 ** 20}
        log("front door clean(): " + json.dumps(num))
        if left > m0 + CLEAN_SLACK:
            raise AssertionError(f"clean() left {(left - m0) / 2 ** 20:.1f} "
                                 "MiB allocated")
        del base
        gc.collect()

        # LU with GMRES and BiCGStab
        C = convection_diffusion_3d(lu_nx)
        bc = C.to_scipy() @ np.ones(C.n)
        for name in ("GMRES", "BICGSTAB"):
            s, _, _ = front_door_solver(
                f"LU {name} convection_diffusion_3d({lu_nx})", C,
                cfg("LU", refinement=RefinementMethod[name]), dev, bc,
                ("K1", "K2", "K4"))
            del s
            gc.collect()

        # the host front ends, once each at poisson_3d(24)
        A24 = poisson_3d(24)
        M24 = A24.to_scipy()
        C24 = sp.coo_matrix(M24)
        b24 = M24 @ np.ones(A24.n)
        res = lambda M_, x_: float(np.linalg.norm(b24 - M_ @ x_)
                                   / np.linalg.norm(b24))
        small = PastixConfig(tile_size=128, update_dtype="bfloat16")
        reset_counts()
        m = MurgeSolver(A24.n, small, device=dev)
        m.graph_begin()
        m.graph_edge(C24.row, C24.col)
        m.graph_end()
        m.assembly_begin()
        m.assembly_set_value(C24.row, C24.col, C24.data)
        m.assembly_end()
        r1 = res(M24, m.solve(b24))
        layout = m._solver.layout
        m.assembly_begin(MurgeSolver.OVERWRITE)
        m.assembly_set_value(C24.row, C24.col, 2.0 * C24.data)
        m.assembly_end()
        r2 = res(2.0 * M24, m.solve(b24))
        reused = m._solver.layout is layout
        parts = []
        for ch in np.array_split(np.arange(C24.nnz), 4):
            rows, cols = C24.row[ch], C24.col[ch]
            gl = np.unique(np.concatenate([rows, cols]))
            parts.append(CSCDPart(rows=np.searchsorted(gl, rows),
                                  cols=np.searchsorted(gl, cols),
                                  vals=C24.data[ch], loc2glob=gl))
        owner = np.full(A24.n, -1)
        for i, p in enumerate(parts):
            owner[p.loc2glob[owner[p.loc2glob] < 0]] = i
        xs = dspsolve(A24.n, parts,
                      [np.where(owner[p.loc2glob] == i, b24[p.loc2glob], 0.0)
                       for i, p in enumerate(parts)], small, device=dev)
        xd = np.zeros(A24.n)
        for p, xp in zip(parts, xs):
            xd[p.loc2glob] = xp
        r3 = res(M24, xd)
        rc = cli.main(["-lap3", "24", "--refine", "gmres", "--steps"])
        read_counts("front ends poisson_3d(24)", need)
        num = {
            "murge_residual": r1, "murge_new_values_residual": r2,
            "murge_analysis_reused": reused, "dspsolve_residual": r3,
            "cli_rc": rc}
        log("front door front ends: " + json.dumps(num))
        if (not max(r1, r2, r3) <= TOL_RES or not reused or rc != 0):
            raise AssertionError("a front end failed at poisson_3d(24)")
    finally:
        shutil.rmtree(io_root, ignore_errors=True)


def sass_count(build, kernel, ops, also=None):
    """How many of each SASS opcode of ``ops`` the library's ``kernel``
    functions hold (``cuobjdump -sass``, run once a library; ``also``:
    only those whose name holds one of these strings too), and how many
    functions that is, or why it cannot say."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = os.path.join(build._OUT, f"libpastix_kernels_{build._digest()}.so")
    if not os.path.isfile(tool):
        return "cuobjdump not found"
    if lib not in _SASS:
        _SASS[lib] = subprocess.run([tool, "-sass", lib], capture_output=True,
                                    text=True, timeout=300).stdout
    sass = _SASS[lib]
    counts, inside = dict.fromkeys(ops + ("functions",), 0), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line and (
                also is None or any(s in line for s in also))
            counts["functions"] += inside
        elif inside:
            for op in ops:
                counts[op] += f" {op}." in line or f" {op} " in line
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=64,
                    help="main path: poisson_3d(nx) (default 64)")
    ap.add_argument("--schur-nx", type=int, default=64,
                    help="Schur paths: poisson_3d(nx) (LLT), "
                         "convection_diffusion_3d(nx) (LU) and "
                         "poisson_3d(nx) - sigma I (LDLT), Schur = the "
                         "plane z = nx-1 (default 64)")
    ap.add_argument("--lu-nx", type=int, default=70,
                    help="LU path: convection_diffusion_3d(nx) (default 70, "
                         "n = 343,000)")
    ap.add_argument("--ldlt-nx", type=int, default=64,
                    help="LDLT path: poisson_3d(nx) - sigma I (default 64)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from pastix_tpu_torch import _build, native
    from pastix_tpu_torch._device import card_name_power
    from pastix_tpu_torch.config import Factorization, PastixConfig
    from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d
    from pastix_tpu_torch.numeric import leftlook as LL
    from pastix_tpu_torch.numeric import pipelined as PL

    # 1. device
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # true fp32 for the whole process, as the port's phases pin it
    # (_device.pin_precision): the script also runs kernels and twins
    # outside those phases
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_power().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t_start = time.perf_counter()

    def elapsed(what):
        log(f"[{time.perf_counter() - t_start:.1f} s] {what} done")

    # 2. build
    t0 = time.perf_counter()
    _build.get_lib()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc, {len(_build._SOURCES)} sources in parallel + link: "
        f"{_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if ("registers" in line or "spill" in line or "entry function"
                in line or line.startswith("---")):
            log(f"  ptxas: {line.strip()}")
    # K5 and K9 run K3's kernel with fp32 operands (the pools): its
    # instantiations with A_F32 and B_F32 set (mangled, or demangled);
    # K10's scaled bf16 updates those with A_F32 set and B_F32 not (after
    # BN); K6 K1's windowed ones with A_F32 and B_F32 set (after BN)
    bns = (32, 64, 128)
    mixed = tuple(f"Li{bn}ELb1ELb0E" for bn in bns) + tuple(
        f"{bn}, true, false" for bn in bns)
    both = tuple(f"Li{bn}ELb1ELb1E" for bn in bns) + tuple(
        f"{bn}, true, true" for bn in bns)
    for kname, src, also in (
            ("K1", "ll_gemm_scatter", None),
            ("K3", "pipelined_gemm_scatter", None),
            ("K5, K9", "pipelined_gemm_scatter", ("Lb1ELb1E", "true, true")),
            ("K6", "ll_gemm_scatter", both),
            ("K10 d", "pipelined_gemm_scatter", mixed),
            ("K12", "cache_gemm_scatter", None)):
        counts = sass_count(_build, src, ("HMMA", "HGMMA"), also)
        log(f"{kname} SASS: {counts}")
        if isinstance(counts, dict) and not counts["HMMA"]:
            raise AssertionError(f"{kname}: no HMMA in its SASS")
    # the first designs of K6 and K9 are gone from the library
    for gone in ("slab_gemm_scatter", "segment_gemm_scatter"):
        counts = sass_count(_build, gone, ("HMMA",))
        if isinstance(counts, dict) and counts["functions"]:
            raise AssertionError(f"the library still holds {gone}")
    t0 = time.perf_counter()
    native.get_lib()
    log(f"native host library: {native.status} "
        f"({time.perf_counter() - t0:.2f} s)")

    bf16, fp32 = torch.bfloat16, torch.float32

    # 3. kernels against their twins on poisson_3d(24) layouts
    ks, _ = analyzed(poisson_3d(24),
                     PastixConfig(tile_size=128, update_dtype="bfloat16"), dev)
    ks.factorize()
    lv = busiest_level(ks._fact_fn)
    errs = {k: 0.0 for k in ("K1", "K1d", "K1x", "K2", "K2lu", "K3", "K3d",
                             "K3x", "K4lu", "K4ldlt", "K3xab", "K3compact",
                             "K3pack", "K5", "K6", "K7", "K8", "K9", "K10",
                             "K11", "K12", "K13")}
    for chunks, where in ((lv.ll, "busiest level"), (ks._fact_fn.tail, "tail")):
        if not chunks:
            raise AssertionError(f"K1: no {where} chunks at this size")
        modes = sorted({c.mode for c in chunks})
        hs = sorted({c.H for c in chunks})
        for upd, name in ((bf16, "bf16"), (fp32, "fp32")):
            errs["K1"] = max(errs["K1"], check_k1(
                ks.factors.pool, chunks, upd,
                f"{where} {name} modes={modes} H={hs}",
            ))
    for R in (1, 3):
        errs["K2"] = max(errs["K2"], check_k2(ks, R, seed=R))
    del ks

    A24 = poisson_3d(24)
    sch24 = last_plane(24)
    ss, _ = analyzed(A24, PastixConfig(tile_size=128, update_dtype=None), dev,
                     schur=sch24)
    ss.factorize()
    lay = ss.layout
    reduced, _, _ = LL.regroup_left(lay.levels, lay.blk_col, None)
    ga, gb, gd = (np.concatenate([getattr(r, f) for r in reduced])
                  for f in ("gemm_a", "gemm_b", "gemm_d"))
    chunk = max(7, ga.size // 5 + 1)  # about five chunks
    straddle = PL.pipeline_plan(
        PL.build_pipeline_schedule(ga, gb, gd, group=2, chunk=chunk), dev)
    split = sum(int(a.seg_dst[-1]) == int(b.seg_dst[0])
                for a, b in zip(straddle, straddle[1:]))
    if not split:
        raise AssertionError("K3: no dst segment straddles a chunk boundary")
    for chunks, where in ((busiest_residue(ss._fact_fn), "busiest level"),
                          (straddle, f"all residue, chunk={chunk}, "
                                     f"{split} split segments")):
        for upd, name in ((bf16, "bf16"), (fp32, "fp32")):
            errs["K3"] = max(errs["K3"], check_k3(
                ss.factors.pool, chunks, upd, f"Schur {where} {name}"))
    S = ss.get_schur()
    S_ref = schur_reference(A24, sch24)
    s_err = float(np.abs(S - S_ref).max() / np.abs(S_ref).max())
    log(f"get_schur poisson_3d(24) {S.shape} fp32 updates: "
        f"max|S - S_ref|/max|S_ref| = {s_err:.3e}")
    if not s_err <= TOL_S:
        raise AssertionError(f"get_schur off by {s_err:.3e}")
    del ss, straddle

    # 3, slice 2: the LDLᵗ and LU variants on T=128 layouts of size 24
    check_variants(dev, errs, sch24)
    # 3, slices 3 and 4: K3's operand arrays, the E2 harness's variants
    # (K9, K10), K5 and K6 on the same layouts; K7 and K8
    check_rightlook_kernels(dev, errs)
    check_chol_inv_kernels(dev, errs)

    elapsed("phases 1-3")
    # 4.-5. the main path, and its kernels at its shapes
    launches, main_num, k1, k2 = main_path(args.nx, dev, errs)

    elapsed("phases 4-5")
    # 6.-10. the LLᵗ Schur path, the LU and LDLᵗ paths and their Schur
    # paths
    LLT, LU, LDLT = Factorization.LLT, Factorization.LU, Factorization.LDLT
    nxs = args.schur_nx
    schur_runs = {"K3": schur_path(LLT, poisson_3d(nxs), nxs, "bfloat16",
                                   "K3", dev, errs)}
    lu_launches, lu_num, k1x, k2lu, k4lu = lu_path(args.lu_nx, dev, errs)
    ldlt_launches, ldlt_num, k1d, k4ldlt = ldlt_path(args.ldlt_nx, dev, errs)
    schur_runs["K3x"] = schur_path(LU, convection_diffusion_3d(nxs), nxs,
                                   "bfloat16", "K3x", dev, errs)
    schur_runs["K3d"] = schur_path(LDLT, shift_invert(nxs)[0], nxs, None,
                                   "K3d", dev, errs)

    elapsed("phases 6-10")
    # 11. the right-looking E2 schedules (PASTIX_E2_LL=0), bf16 updates:
    # LDLᵗ on the unshifted Laplacian (bf16 diverges on the shifted one)
    rl = {
        "LLT": rightlook_path(
            f"LLT right-looking poisson_3d({args.nx})", poisson_3d(args.nx),
            LLT, ("stream", "block", "slab", "pair", "pair+compact"), dev,
            errs),
        "LDLT": rightlook_path(
            f"LDLT right-looking poisson_3d({args.nx})",
            poisson_3d(args.nx), LDLT, ("stream", "block", "slab"), dev,
            errs),
        "LU": rightlook_path(
            f"LU right-looking convection_diffusion_3d({args.lu_nx})",
            convection_diffusion_3d(args.lu_nx), LU, ("stream",), dev, errs),
    }

    elapsed("phase 11")
    # 12. the fused-diagonal LLᵗ path (PASTIX_FUSED_DIAG=1)
    fused, fsolver, k7, k8 = fused_path(
        args.nx, dev, errs, main_num["fact_ms"],
        rl["LLT"]["stream"][1]["fact_ms"])
    k8_one = k8_tiles(dev, errs)

    elapsed("phase 12")
    # 13. the E2 A/B harness (exp_pipe.py); the counts are those of each
    # case's timed runs
    ab = ab_harness(fsolver, dev, errs)
    if min(v[3] for v in ab.values()) == 0:
        raise AssertionError("the E2 harness did not launch every variant")

    # 14. the operand-cache harness (exp_cache.py, exp_mp.py) on the same
    # level; 15. the copy probe (exp_dma.py).  The counts are those of
    # each case's timed runs
    cache = cache_harness(fsolver, dev, errs)
    del fsolver
    elapsed("phases 13-14")
    probes = probe_harness(dev, errs)
    elapsed("phase 15")
    if min(v[3] for v in cache.values()) == 0 or min(
            r[-1] for r in probes) == 0:
        raise AssertionError("phase 14 or 15 did not launch every kernel")

    # 16. the front door and the refinement methods
    front_door_path(args.nx, args.lu_nx, dev, main_num["iters"])
    elapsed("phase 16")

    # no single PyTorch call computes a gather-GEMM-scatter over a pair
    # list or a block-sparse triangular sweep: library_ms is null but for
    # K4 LU (lu_factor_ex without pivoting) and K13 (index_select of the
    # same copies)
    # seg: the row runs the tensor-core body seg_mma.cuh from another
    # kernel's source (K5, K6, K9 and K10's bf16 updates, K12)
    def entry(name, src, replaces, launches, err, timed, lib=None,
              seg=False):
        ms, plain, bd = timed[:3]
        body = {"body": "pastix_tpu_torch/csrc/seg_mma.cuh"} if seg else {}
        return {"name": name, "route": "cuda",
                "source": f"pastix_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bd[0], "bound_by": bd[1], "library_ms": lib,
                **body}

    k1_at = "pastix_tpu/numeric/leftlook.py:469"
    k2_at = "pastix_tpu/numeric/sweep_kernels.py:241"
    k3_at = "pastix_tpu/numeric/pallas_kernels.py:666"
    k3 = "pipelined_gemm_scatter"
    kernels = [
        entry("ll_gemm_scatter", "ll_gemm_scatter.cu", k1_at,
              launches["K1"], errs["K1"], k1),
        entry("sweep", "sweep.cu", k2_at, launches["K2"], errs["K2"], k2),
        entry(k3, f"{k3}.cu", k3_at, schur_runs["K3"][0]["K3"], errs["K3"],
              schur_runs["K3"][2]),
        entry("ll_gemm_scatter[d]", "ll_gemm_scatter.cu", k1_at,
              ldlt_launches["K1"], errs["K1d"], k1d),
        entry("ll_gemm_scatter[src_pool]", "ll_gemm_scatter.cu", k1_at,
              lu_launches["K1"], errs["K1x"], k1x),
        entry("sweep[lu]", "sweep.cu", k2_at, lu_launches["K2"],
              errs["K2lu"], k2lu),
        entry(f"{k3}[src_pool]", f"{k3}.cu", k3_at,
              schur_runs["K3x"][0]["K3"], errs["K3x"], schur_runs["K3x"][2]),
        entry(f"{k3}[d]", f"{k3}.cu", k3_at, schur_runs["K3d"][0]["K3"],
              errs["K3d"], schur_runs["K3d"][2]),
        entry("tile_factor[lu]", "tile_factor.cu",
              "pastix_tpu/numeric/kernels.py:258", lu_launches["K4"],
              errs["K4lu"], k4lu, k4lu[3]),
        entry("tile_factor[ldlt]", "tile_factor.cu",
              "pastix_tpu/numeric/kernels.py:186", ldlt_launches["K4"],
              errs["K4ldlt"], k4ldlt),
    ]
    # the right-looking rows: launches from the schedule's run, max|d|
    # the larger of phase 3's and the path level's
    # K5 runs K3's kernel (pipelined_gemm_scatter.cu) on its tensor-core
    # body seg_mma.cuh (bf16) with the pool as both operand arrays
    # K6 runs K1's kernel (ll_gemm_scatter.cu) on the same body, a window
    # height a pair
    k5_at = "pastix_tpu/numeric/block_kernels.py:689"
    k6_at = "pastix_tpu/numeric/slab_kernels.py:588"
    k1 = "ll_gemm_scatter"
    for name, src, at, kind, mode, k3key in (
        (f"{k3}[xab]", k3, k3_at, "LLT", "stream", "K3xab"),
        (f"{k3}[xab,d]", k3, k3_at, "LDLT", "stream", "K3xab"),
        (f"{k3}[xab,src_pool]", k3, k3_at, "LU", "stream", "K3xab"),
        (f"{k3}[compact]", k3, k3_at, "LLT", "pair+compact", "K3compact"),
        ("block_gemm_scatter", k3, k5_at, "LLT", "block", "K5"),
        ("block_gemm_scatter[d]", k3, k5_at, "LDLT", "block", "K5"),
        ("slab_gemm_scatter", k1, k6_at, "LLT", "slab", "K6"),
        ("slab_gemm_scatter[d]", k1, k6_at, "LDLT", "slab", "K6"),
    ):
        launches_m, _, timed = rl[kind][mode]
        kernels.append(entry(name, f"{src}.cu", at,
                             launches_m[RL_KERNEL[mode]],
                             max(errs[k3key], errs[f"{kind} {mode}"]), timed,
                             seg=mode in ("block", "slab")))
    # slice 4: K7 and K8 with launches from the fused left-looking path;
    # K9, K10 and ab_pack from the harness, each row the poisson level's
    # case in bf16, its launches too (the other cases in the log)
    at = "pastix_tpu/numeric/pallas_kernels.py"
    ab_row = lambda label: ab["poisson level", "bfloat16", label]
    kernels += [
        entry("chol_inv_pool", "chol_inv.cu", f"{at}:1021",
              fused["left"][0]["K7"], errs["K7"], k7),
        entry("chol_inv", "chol_inv.cu", f"{at}:902", fused["left"][0]["K8"],
              errs["K8"], k8),
        entry("gemm_scatter_fused", f"{k3}.cu", f"{at}:186",
              ab_row("K9")[3], errs["K9"], ab_row("K9"), seg=True),
        entry("gemm_scatter_blockspec", f"{k3}.cu", f"{at}:806",
              ab_row("K10")[3], errs["K10"], ab_row("K10"), seg=True),
        entry("gemm_scatter_blockspec[fp32]", f"{k3}.cu", f"{at}:806",
              ab["poisson level", "float32", "K10"][3], errs["K10"],
              ab["poisson level", "float32", "K10"]),
        entry(f"{k3}[ab_pack]", f"{k3}.cu", k3_at,
              ab_row("K3 ab_pack G=1")[3], errs["K3pack"],
              ab_row("K3 ab_pack G=1")),
    ]
    # the measurement scripts: K11 from phase 14, K12 at G=4 and 8, K13
    # at S=1, D=2 from phase 15 (the other cases in the log)
    rows, S, D, steps, reps, ctas, piece, ms, plain, bd, lib, n = probes[0]
    kernels.append(entry("vcache_gemm_scatter", f"{k3}.cu",
                         "exp_cache.py:181", cache["K11"][3], errs["K11"],
                         cache["K11"]))
    for G in (4, 8):
        for variant in ("loop", "dot2"):
            case = cache[f"K12 {variant} G={G}"]
            kernels.append(entry(
                f"mp_gemm_scatter[{variant}]" + ("" if G == 4 else f"[G={G}]"),
                "cache_gemm_scatter.cu", "exp_mp.py:267", case[3],
                errs["K12"], case, seg=True))
    kernels.append(entry("dma_probe", "dma_probe.cu", "exp_dma.py:76", n,
                         errs["K13"], (ms, plain, bd), lib))
    for label, (ms, plain, bd, n) in cache.items():
        log(f"cache harness {label}: " + json.dumps(
            {"ms": ms, "plain_ms": plain, "bound_ms": bd[0],
             "bound_by": bd[1], "launches": n}))
    # dma_probe's twin is the closed form (two rows a copy), not copies
    kernels[-1]["plain"] = "closed form: reads two rows a copy, no copies"
    for rows, S, D, steps, reps, ctas, piece, ms, plain, bd, lib, n in (
            probes):
        log(f"probe rows={rows} S={S} D={D} steps={steps} reps={reps} "
            f"ctas={ctas or 'one per SM'} piece={piece}: "
            + json.dumps({"ms": ms, "plain_ms": plain, "bound_ms": bd[0],
                          "bound_by": bd[1], "library_ms": lib,
                          "launches": n}))
    for (name, upd, label), (ms, plain, bd, n) in ab.items():
        log(f"harness {name} {upd} {label}: " + json.dumps(
            {"ms": ms, "plain_ms": plain, "bound_ms": bd[0],
             "bound_by": bd[1], "launches": n}))
    for name, num in (("LLT", main_num), ("LLT Schur", schur_runs["K3"][1]),
                      ("LU", lu_num), ("LDLT", ldlt_num),
                      ("LU Schur", schur_runs["K3x"][1]),
                      ("LDLT Schur", schur_runs["K3d"][1])):
        log(f"path {name}: " + json.dumps(num))
    for kind, runs in rl.items():
        for mode, (_, num, _) in runs.items():
            log(f"path {kind} right-looking {mode}: " + json.dumps(num))
    for e2, (_, num) in fused.items():
        log(f"path LLT fused-DIAG {e2}: " + json.dumps(num))
    for T, (ms, plain, bd, lib, dev_ms, dev_lib) in k8_one.items():
        log(f"K8 one tile T={T}: " + json.dumps(
            {"ms": ms, "plain_ms": plain, "bound_ms": bd[0],
             "bound_by": bd[1], "two_library_calls_ms": lib,
             "device_ms": dev_ms, "two_library_calls_device_ms": dev_lib}))
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
