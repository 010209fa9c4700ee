#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pastix_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--nx N] [--schur-nx N] [--lu-nx N] [--ldlt-nx N]

Phases; any failed check raises, so the script exits non-zero and never
prints the final ``ok`` line:

1. device: a CUDA device is required; prints the card's name and power
   limit (nvidia-smi);
2. build: compiles the hand-written CUDA kernels K1-K4 from ``csrc/``
   (one nvcc per source, in parallel) and the port's native host library
   (g++; prints whether it was built or the Python ordering runs);
3. kernels: each kernel against its plain PyTorch twin on the same inputs,
   max|d| <= 1e-4 max|ref| for K1 and K3, 1e-5 for K2 (summation order
   only) and K4 (plus equal clamp counts): on the poisson_3d(24) T=128
   layout, K1 (left-looking E2) on the busiest level's chunks and the
   dense-tail pre-pass, bf16 and fp32 updates, K2 (sweeps) forward +
   backward at R = 1 and R = 3; on the poisson_3d(24) T=128 Schur layout
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
   LU and LDLᵗ on the busiest level's diagonal tiles and on a batch with
   planted zero pivots; ``get_schur`` under LU against the sparse-LU S;
4. main path: ``Pastix(poisson_3d(--nx), T=128, bf16 updates)`` through
   order, symbfact, analyze, factorize (twice, the second timed) and a
   refined solve of b = A.1 to a fp64 residual <= 1e-10; the launch counts
   of K1 and K2 must rise and the twins' stay 0;
5. main-path shapes: K1 on the main path's busiest level and tail
   pre-pass and K2 on its sweeps, each against its twin as in 3, then
   each kernel and its twin timed (CUDA events);
6. Schur path: ``Pastix(poisson_3d(--schur-nx), T=128, bf16 updates)``
   with the plane z = nx-1 (its last nx^2 unknowns) as Schur unknowns:
   order, symbfact, analyze, factorize twice (the second timed),
   ``get_schur`` (shape, finite, symmetric), ``solve_with_schur(A.1)`` to
   a fp64 residual <= 1e-10; K1, K2 and K3 must launch and no twin may
   run; then K3 against its twin on the path's busiest residue level, and
   both timed;
7. LU path: ``Pastix(convection_diffusion_3d(--lu-nx), T=128, bf16
   updates, LU)`` (n = 343,000 at the default 70: the reference's
   convdiff rung) as in 4; K1, K2 and K4 must launch, no twin; then K1
   cross-pool, K2's LU sweeps and K4 LU against their twins and timed at
   the path's busiest level;
8. LDLᵗ path: ``Pastix(poisson_3d(--ldlt-nx) - σI, T=128, fp32 updates,
   LDLT)``, σ halfway between the two smallest eigenvalues of the
   Laplacian (a shift-and-invert matrix, one negative eigenvalue), as in
   7; with no clamped pivot exactly one pivot of d is negative
   (Sylvester); K1 scaled (against its twin, and timed, in fp32, the
   path's dtype) and K4 LDLᵗ; then, not checked, what bf16 updates leave
   on this matrix (their error is not contracted by the refinement at
   nx=64);
9. LU Schur path: ``convection_diffusion_3d(--schur-nx)`` with the plane
   z = nx-1 as Schur unknowns: ``get_schur`` (shape, finite),
   ``solve_with_schur(A.1)`` to <= 1e-10, K3 launched in its cross-pool
   variant; K3 ``src_pool`` against its twin and timed (bf16);
10. LDLᵗ Schur path: the shift-invert poisson_3d(--schur-nx) with its
   plane z = nx-1, fp32 updates: as 9 (S symmetric), K3 launched in its
   scaled variant; K3 ``d`` against its twin and timed in fp32;

then the card's nvidia-smi line, one JSON line of the kernels (each
variant on its own line of the list, ``launches`` from the path that runs
it), and last ``{"ok": true, "device": {...}}``.  --nx 64 is
n = 262,144; --nx 100 is the 1M-unknown flagship of bench.py.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

TOL_E2 = 1e-4  # max|kernel - twin| / max|twin| for K1 and K3
TOL_K2 = 1e-5  # the same for the sweeps
TOL_K4 = 1e-5  # the same for the static-pivot tile factorization
TOL_RES = 1e-10  # fp64 ||b - A x|| / ||b|| after refinement
TOL_S = 1e-4  # max|S - S_ref| / max|S_ref| with fp32 updates
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


def check_e2(name, run, run_ref, pool, chunks, update_dtype, label, **kw):
    """An E2 kernel (K1 or K3) against its twin on copies of ``pool``
    (``kw``: the ``d`` or ``src_pool`` variant); returns max|d|."""
    import torch

    got = run(pool.clone(), chunks, update_dtype, **kw)
    ref = run_ref(pool.clone(), chunks, update_dtype, **kw)
    torch.cuda.synchronize()
    touched = torch.cat([c.seg_dst for c in chunks]).unique()
    scale = float(ref[touched].abs().max())
    err = float((got - ref).abs().max())
    ok = err <= TOL_E2 * scale
    log(f"{name} {label}: {len(chunks)} chunks, "
        f"{sum(c.n_pairs for c in chunks)} pairs, max|d|={err:.3e} "
        f"max|ref|={scale:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label} disagrees with its twin")
    return err


def check_k1(pool, chunks, update_dtype, label, **kw):
    from pastix_tpu_torch.numeric import leftlook as LL

    return check_e2("K1", LL.gemm_scatter_ll, LL.gemm_scatter_ll_ref, pool,
                    chunks, update_dtype, label, **kw)


def check_k3(pool, chunks, update_dtype, label, **kw):
    from pastix_tpu_torch.numeric import pipelined as PL

    return check_e2("K3", PL.gemm_scatter_pipelined,
                    PL.gemm_scatter_pipelined_ref, pool, chunks,
                    update_dtype, label, **kw)


def sweep_pair(solver):
    """The (pool, dinv, lu) of the solver's forward and backward sweeps:
    LU sweeps backward over the Uᵗ pool with the upper inverses."""
    f = solver.factors
    if f.pool_u is not None:
        return (f.pool, f.dinv, False), (f.pool_u, f.dinv_u, True)
    return (f.pool, f.dinv, False), (f.pool, f.dinv, False)


def check_k2(solver, R, seed):
    """K2 forward + backward against its twin; returns max|d|."""
    import torch
    from pastix_tpu_torch.numeric import sweep_kernels as SW

    lay, f = solver.layout, solver.factors
    plan = solver._solve_fn.plan
    g = torch.Generator(device=f.pool.device).manual_seed(seed)
    y2 = torch.randn(lay.nbc * R, lay.T, generator=g, device=f.pool.device)
    got, ref = y2.clone(), y2.clone()
    for key, (pool, dinv, lu) in zip(("fwd", "bwd"), sweep_pair(solver)):
        SW.run_sweep(pool, dinv, got, plan, key, lu)
        SW.run_sweep_ref(pool, dinv, ref, plan, key, lu)
    torch.cuda.synchronize()
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
    log(f"timing K2 {'LU ' if npools == 2 else ''}fwd+bwd R=1 "
        f"({len(plan['fwd']) + len(plan['bwd'])} phases): kernel {ms:.3f} "
        f"ms, twin {plain:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})")
    return ms, plain, bd


# zero pivots planted by planted_tiles
PLANTED = 4


def planted_tiles(T, lu, n=6, seed=0):
    """``n`` random diagonally dominant tiles with PLANTED zero pivots
    planted by a zero row and column, which stay exactly zero through
    the updates: tile 0 at 0, tile 1 at 0 and 5, tile 2 at T - 1."""
    import torch

    rng = np.random.default_rng(seed)
    R = rng.standard_normal((n, T, T))
    M = R + (0 if lu else R.transpose(0, 2, 1)) + 2 * T * np.eye(T)
    for t, k in ((0, 0), (1, 0), (1, 5), (2, T - 1)):
        M[t, k, :] = M[t, :, k] = 0.0
    return torch.tensor(M, dtype=torch.float32, device="cuda")


def check_k4(tiles, eps, lu, label, expect=None):
    """K4 against its twin on copies of ``tiles`` (all factored): equal
    clamp counts (and ``expect`` when given), max|d| <= 1e-5 max|ref| on
    the tiles and, for LDLᵗ, on d; returns max|d|."""
    import torch
    from pastix_tpu_torch.numeric import tile_factor as TF

    idx = torch.arange(tiles.shape[0], device=tiles.device)
    got, ref = tiles.clone(), tiles.clone()
    n_got = torch.zeros((), dtype=torch.int32, device=tiles.device)
    n_ref = torch.zeros_like(n_got)
    d_got = TF.tile_factor(got, idx, eps, n_got, lu)
    d_ref = TF.tile_factor_ref(ref, idx, eps, n_ref, lu)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    ok = err <= TOL_K4 * scale and int(n_got) == int(n_ref)
    if expect is not None:
        ok = ok and int(n_got) == expect
    if d_got is not None:
        d_err = float((d_got - d_ref).abs().max())
        ok = ok and d_err <= TOL_K4 * float(d_ref.abs().max())
        err = max(err, d_err)
    log(f"K4 {'LU' if lu else 'LDLT'} {label}: {tiles.shape[0]} tiles, "
        f"clamps {int(n_got)} (twin {int(n_ref)}), max|d|={err:.3e} "
        f"max|ref|={scale:.3e} -> {'ok' if ok else 'FAIL'}")
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
    from pastix_tpu_torch.numeric import leftlook as LL
    from pastix_tpu_torch.numeric import pipelined as PL
    from pastix_tpu_torch.numeric import sweep_kernels as SW
    from pastix_tpu_torch.numeric import tile_factor as TF

    return {"K1": LL.gemm_scatter_ll, "K2": SW.run_sweep,
            "K3": PL.gemm_scatter_pipelined, "K4": TF.tile_factor}


def reset_counts():
    for fn in counters().values():
        fn.launches = fn.twin_launches = 0


def read_counts(path, need):
    launches = {k: fn.launches for k, fn in counters().items()}
    twins = {k: fn.twin_launches for k, fn in counters().items()}
    log(f"  {path}: launches {launches}, twin calls {twins}")
    if min(launches[k] for k in need) == 0 or max(twins.values()) != 0:
        raise AssertionError(
            f"the {path} did not run through all of {need}, or ran a twin")
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


def drive(path, A, cfg, dev, need, schur=None):
    """One path at full width, its counts set to 0 just before and read
    just after: order, symbfact, analyze, factorize twice (the second
    timed), then a refined solve of b = A.1 (``schur``: ``get_schur`` and
    ``solve_with_schur``) to a fp64 residual <= 1e-10.  Returns (solver,
    launches, numbers)."""
    import torch

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
    launches = read_counts(path, need)
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
    1/3 T^3 (LDLᵗ) flop per tile at the fp32 peak, or 2 x 64 KiB per tile
    at the memory rate."""
    import scipy.sparse as sp
    import torch
    from pastix_tpu_torch.numeric import tile_factor as TF

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
    bd = bound(B * (2.0 if lu else 1.0) / 3.0 * T ** 3, PEAK_FP32,
               B * 2 * T * T * 4)
    log(f"timing K4 {'LU' if lu else 'LDLT'} busiest level ({B} tiles): "
        f"kernel {ms:.3f} ms, twin {plain:.3f} ms, bound {bd[0]:.4f} ms "
        f"({bd[1]}), lu_factor_ex(pivot=False) "
        f"{'n/a' if lib is None else f'{lib:.3f} ms'}")
    err = check_k4(tiles, eps, lu, f"{'LU' if lu else 'LDLT'} path busiest "
                   "level")
    return ms, plain, bd, lib, err


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
    e2_timed("K1 main path tail pre-pass", LL.gemm_scatter_ll,
             LL.gemm_scatter_ll_ref, tail, s.layout.T, k1_flops, upd)
    k2 = k2_timed(s)
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
    k4lu = k4_timed(s, lu=True)
    errs["K4lu"] = max(errs["K4lu"], k4lu[4])
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
    k1d = e2_timed("K1 d LDLT path busiest level", LL.gemm_scatter_ll,
                   LL.gemm_scatter_ll_ref, k1_lists(s, lv), s.layout.T,
                   k1_flops, upd)
    k4ldlt = k4_timed(s, lu=False)
    errs["K4ldlt"] = max(errs["K4ldlt"], k4ldlt[4])
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

    need = ("K1", "K2", "K3") + (() if kind == Factorization.LLT
                                 else ("K4",))
    s, launches, num = drive(f"{kind.name} Schur path (nx={nx})", A,
                             kind_cfg(kind, upd), dev, need,
                             schur=last_plane(nx))
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
        errs[k4] = max(errs[k4], check_k4(
            planted_tiles(128, kind == LU), 1e-6, kind == LU,
            "planted zero pivots", PLANTED))
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
    from pastix_tpu_torch._device import card_name_power, pin_precision
    from pastix_tpu_torch.config import Factorization, PastixConfig
    from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d
    from pastix_tpu_torch.numeric import leftlook as LL
    from pastix_tpu_torch.numeric import pipelined as PL

    # 1. device
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pin_precision()
    card = card_name_power().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.get_lib()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc, {len(_build._SOURCES)} sources in parallel + link: "
        f"{_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            log(f"  ptxas: {line.strip()}")
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
                             "K3x", "K4lu", "K4ldlt")}
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

    # 4.-5. the main path, and its kernels at its shapes
    launches, main_num, k1, k2 = main_path(args.nx, dev, errs)

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

    # no single PyTorch call computes a gather-GEMM-scatter over a pair
    # list or a block-sparse triangular sweep: library_ms is null but for
    # K4 LU (lu_factor_ex without pivoting)
    def entry(name, src, replaces, launches, err, timed, lib=None):
        ms, plain, bd = timed[:3]
        return {"name": name, "route": "cuda",
                "source": f"pastix_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bd[0], "bound_by": bd[1], "library_ms": lib}

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
    for name, num in (("LLT", main_num), ("LLT Schur", schur_runs["K3"][1]),
                      ("LU", lu_num), ("LDLT", ldlt_num),
                      ("LU Schur", schur_runs["K3x"][1]),
                      ("LDLT Schur", schur_runs["K3d"][1])):
        log(f"path {name}: " + json.dumps(num))
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
