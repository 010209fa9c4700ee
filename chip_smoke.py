#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pastix_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--nx N] [--schur-nx N]

Phases; any failed check raises, so the script exits non-zero and never
prints the final ``ok`` line:

1. device: a CUDA device is required; prints the card's name and power
   limit (nvidia-smi);
2. build: compiles the hand-written CUDA kernels K1, K2 and K3 from
   ``csrc/`` (one nvcc per source, in parallel) and the port's native host
   library (g++; prints whether it was built or the Python ordering runs);
3. kernels: each kernel against its plain PyTorch twin on the same inputs,
   max|d| <= 1e-4 max|ref| for K1 and K3, 1e-5 for K2 (summation order
   only): on the poisson_3d(24) T=128 layout, K1 (left-looking E2) on the
   busiest level's chunks and the dense-tail pre-pass, bf16 and fp32
   updates, K2 (sweeps) forward + backward at R = 1 and R = 3; on the
   poisson_3d(24) T=128 Schur layout (Schur = its last 24^2 unknowns), K3
   (right-looking E2) on the busiest residue level and on every residue
   pair in one list cut into chunks that split dst segments, bf16 and
   fp32; that layout's ``get_schur`` against A22 - A21 A11^-1 A12 from a
   sparse LU (fp32 updates, 1e-4 max|S|);
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
   run;
   then K3 against its twin on the path's busiest residue level, and both
   timed;

then the card's nvidia-smi line, one JSON line of the kernels, and last
``{"ok": true, "device": {...}}``.  --nx 64 is n = 262,144; --nx 100 is
the 1M-unknown flagship of bench.py.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

TOL_E2 = 1e-4  # max|kernel - twin| / max|twin| for K1 and K3
TOL_K2 = 1e-5  # the same for the sweeps
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


def e2_bound(chunks, T, pair_flops, bf16):
    """Bound of one E2 list: every operand tile read once (fp32 pool),
    every dst tile read and written once."""
    import torch

    flops = sum(pair_flops(c) for c in chunks)
    ops = torch.cat([torch.cat([c.pair_a, c.pair_b]) for c in chunks])
    dst = torch.cat([c.seg_dst for c in chunks])
    tile = T * T * 4
    nbytes = ops.unique().numel() * tile + 2 * dst.unique().numel() * tile
    return bound(flops, PEAK_BF16 if bf16 else PEAK_FP32, nbytes)


def check_e2(name, run, run_ref, pool, chunks, update_dtype, label):
    """An E2 kernel (K1 or K3) against its twin on copies of ``pool``;
    returns max|d|."""
    import torch

    got = run(pool.clone(), chunks, update_dtype)
    ref = run_ref(pool.clone(), chunks, update_dtype)
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


def check_k1(pool, chunks, update_dtype, label):
    from pastix_tpu_torch.numeric import leftlook as LL

    return check_e2("K1", LL.gemm_scatter_ll, LL.gemm_scatter_ll_ref, pool,
                    chunks, update_dtype, label)


def check_k3(pool, chunks, update_dtype, label):
    from pastix_tpu_torch.numeric import pipelined as PL

    return check_e2("K3", PL.gemm_scatter_pipelined,
                    PL.gemm_scatter_pipelined_ref, pool, chunks,
                    update_dtype, label)


def check_k2(solver, R, seed):
    """K2 forward + backward against its twin; returns max|d|."""
    import torch
    from pastix_tpu_torch.numeric import sweep_kernels as SW

    lay, f = solver.layout, solver.factors
    plan = solver._solve_fn.plan
    g = torch.Generator(device=f.pool.device).manual_seed(seed)
    y2 = torch.randn(lay.nbc * R, lay.T, generator=g, device=f.pool.device)
    got, ref = y2.clone(), y2.clone()
    for key in ("fwd", "bwd"):
        SW.run_sweep(f.pool, f.dinv, got, plan, key)
        SW.run_sweep_ref(f.pool, f.dinv, ref, plan, key)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    ok = err <= TOL_K2 * scale
    log(f"K2 fwd+bwd R={R}: max|d|={err:.3e} max|ref|={scale:.3e} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K2 R={R} disagrees with its twin")
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

    return {"K1": LL.gemm_scatter_ll, "K2": SW.run_sweep,
            "K3": PL.gemm_scatter_pipelined}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=64,
                    help="main path: poisson_3d(nx) (default 64)")
    ap.add_argument("--schur-nx", type=int, default=64,
                    help="Schur path: poisson_3d(nx), Schur = its plane "
                         "z = nx-1 (default 64)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from pastix_tpu_torch import _build, native
    from pastix_tpu_torch._device import card_name_power, pin_precision
    from pastix_tpu_torch.config import PastixConfig
    from pastix_tpu_torch.generators import poisson_3d
    from pastix_tpu_torch.numeric import leftlook as LL
    from pastix_tpu_torch.numeric import pipelined as PL
    from pastix_tpu_torch.numeric import sweep_kernels as SW

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
        f"(nvcc, 3 sources in parallel + link: {_build.build_seconds:.2f} s)")
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
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
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

    # 4. main path
    A = poisson_3d(args.nx)
    cfg = PastixConfig(tile_size=128, update_dtype="bfloat16")
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    s, t = analyzed(A, cfg, dev)
    lay = s.layout
    log(f"main path: poisson_3d({args.nx}) n={A.n} T={lay.T} "
        f"nbc={lay.nbc} npool={lay.npool} "
        f"pool={lay.npool * lay.T ** 2 * 4 / 2**30:.3f} GiB "
        f"levels={s.report.n_levels} dense_tail_m={s.report.dense_tail_m}")
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
        f"{s.report.fact_flops_padded:.4e})")
    b = A.to_scipy() @ np.ones(A.n)
    x = s.solve(b)
    res = float(np.linalg.norm(b - A.to_scipy() @ x) / np.linalg.norm(b))
    log(f"  solve+refine {s.report.solve_time * 1e3:.1f} ms, "
        f"refine_iters {s.report.refine_iters}, residual "
        f"{s.report.residual:.3e} (original order {res:.3e}), "
        f"max|x-1| {np.abs(x - 1).max():.3e}")
    log(f"  peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    if x.shape != (A.n,) or not np.isfinite(x).all():
        raise AssertionError("solution has the wrong shape or is not finite")
    if not max(res, s.report.residual) <= TOL_RES:
        raise AssertionError(f"residual {res:.3e} above {TOL_RES}")
    launches = read_counts("main path", ("K1", "K2"))

    # 5. K1 and K2 against their twins, then timed, at the main path's
    # shapes (its busiest level, its tail pre-pass, its sweeps)
    f = s.factors
    lv = busiest_level(s._fact_fn)
    for chunks, where in ((lv.ll, "busiest level"), (s._fact_fn.tail, "tail")):
        errs["K1"] = max(errs["K1"], check_k1(
            f.pool, chunks, bf16, f"main path {where} bf16"))
    errs["K2"] = max(errs["K2"], check_k2(s, 1, seed=0))
    work = f.pool.clone()
    k1_ms = cuda_ms(lambda: LL.gemm_scatter_ll(work, lv.ll, bf16))
    k1_plain = cuda_ms(lambda: LL.gemm_scatter_ll_ref(work, lv.ll, bf16))
    k1_bound = e2_bound(lv.ll, lay.T, lambda c: c.n_pairs * 2.0 * c.H
                        * lay.T ** 2, bf16=True)
    k1_pairs = sum(c.n_pairs for c in lv.ll)
    log(f"timing K1 busiest level ({len(lv.ll)} chunks, {k1_pairs} pairs, "
        f"bf16): kernel {k1_ms:.3f} ms, twin {k1_plain:.3f} ms, bound "
        f"{k1_bound[0]:.3f} ms ({k1_bound[1]})")
    tail_ms = cuda_ms(lambda: LL.gemm_scatter_ll(work, s._fact_fn.tail, bf16),
                      reps=3)
    tail_plain = cuda_ms(
        lambda: LL.gemm_scatter_ll_ref(work, s._fact_fn.tail, bf16), reps=3)
    log(f"timing K1 tail pre-pass "
        f"({sum(c.n_pairs for c in s._fact_fn.tail)} pairs, bf16): "
        f"kernel {tail_ms:.3f} ms, twin {tail_plain:.3f} ms")
    del work
    plan = s._solve_fn.plan
    y2 = torch.randn(lay.nbc, lay.T, device=dev)

    def sweeps(run):
        for key in ("fwd", "bwd"):
            run(f.pool, f.dinv, y2, plan, key)

    k2_ms = cuda_ms(lambda: sweeps(SW.run_sweep))
    k2_plain = cuda_ms(lambda: sweeps(SW.run_sweep_ref))
    # fwd + bwd at R = 1: every op is one (T, T) x (T, 1) product; every
    # pool tile and inverse diagonal the plan names read once, y read and
    # written once
    nops = sum(ph.op_tile.numel() if ph.kind == "upd" else ph.cols.numel()
               for key in ("fwd", "bwd") for ph in plan[key])
    tiles = torch.cat([ph.op_tile for ph in plan["fwd"] if ph.kind == "upd"])
    ncols = sum(ph.cols.numel() for ph in plan["fwd"] if ph.kind == "diag")
    k2_bound = bound(nops * 2.0 * lay.T ** 2, PEAK_FP32,
                     (tiles.unique().numel() + ncols) * lay.T ** 2 * 4
                     + 2 * lay.nbc * lay.T * 4)
    log(f"timing K2 fwd+bwd R=1 ({len(plan['fwd']) + len(plan['bwd'])} "
        f"phases): kernel {k2_ms:.3f} ms, twin {k2_plain:.3f} ms, bound "
        f"{k2_bound[0]:.3f} ms ({k2_bound[1]})")
    del s, f, plan, y2

    # 6. the Schur path at full width
    nxs = args.schur_nx
    As = poisson_3d(nxs)
    schur = last_plane(nxs)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    s, t = analyzed(As, PastixConfig(tile_size=128, update_dtype="bfloat16"),
                    dev, schur=schur)
    lay = s.layout
    log(f"Schur path: poisson_3d({nxs}) n={As.n} schur={schur.size} "
        f"T={lay.T} nbc={lay.nbc} schur_first_bcol={s._schur_first_bcol} "
        f"npool={lay.npool} pool={lay.npool * lay.T ** 2 * 4 / 2**30:.3f} "
        f"GiB levels={s.report.n_levels}")
    log(f"  order {t['order']:.3f} s  symbfact {t['symbfact']:.3f} s  "
        f"analyze {t['analyze']:.3f} s")
    fact_s = []
    for _ in range(2):
        s.factorize()
        fact_s.append(s.report.fact_time)
    log(f"  factorize {fact_s[0] * 1e3:.1f} ms (first), "
        f"{fact_s[1] * 1e3:.1f} ms (second)")
    t0 = time.perf_counter()
    S = s.get_schur()
    get_ms = (time.perf_counter() - t0) * 1e3
    log(f"  get_schur {S.shape} in {get_ms:.1f} ms, finite "
        f"{bool(np.isfinite(S).all())}, max|S - S^T| {np.abs(S - S.T).max()}")
    if S.shape != (schur.size, schur.size) or not np.isfinite(S).all():
        raise AssertionError("Schur complement has the wrong shape or is "
                             "not finite")
    if np.abs(S - S.T).max() != 0:
        raise AssertionError("Schur complement is not symmetric")
    bs = As.to_scipy() @ np.ones(As.n)
    x = s.solve_with_schur(bs)
    res = float(np.linalg.norm(bs - As.to_scipy() @ x) / np.linalg.norm(bs))
    log(f"  solve_with_schur {s.report.solve_time * 1e3:.1f} ms, "
        f"refine_iters {s.report.refine_iters}, residual "
        f"{s.report.residual:.3e} (original order {res:.3e}), "
        f"max|x-1| {np.abs(x - 1).max():.3e}")
    log(f"  peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    if x.shape != (As.n,) or not np.isfinite(x).all():
        raise AssertionError("solution has the wrong shape or is not finite")
    if not max(res, s.report.residual) <= TOL_RES:
        raise AssertionError(f"residual {res:.3e} above {TOL_RES}")
    schur_launches = read_counts("Schur path", ("K1", "K2", "K3"))
    res_chunks = busiest_residue(s._fact_fn)
    errs["K3"] = max(errs["K3"], check_k3(
        s.factors.pool, res_chunks, bf16, "Schur path busiest level bf16"))
    work = s.factors.pool.clone()
    k3_ms = cuda_ms(lambda: PL.gemm_scatter_pipelined(work, res_chunks, bf16))
    k3_plain = cuda_ms(
        lambda: PL.gemm_scatter_pipelined_ref(work, res_chunks, bf16))
    k3_bound = e2_bound(res_chunks, lay.T,
                        lambda c: c.n_pairs * 2.0 * lay.T ** 3, bf16=True)
    log(f"timing K3 busiest residue level ({len(res_chunks)} chunks, "
        f"{sum(c.n_pairs for c in res_chunks)} pairs, bf16): kernel "
        f"{k3_ms:.3f} ms, twin {k3_plain:.3f} ms, bound {k3_bound[0]:.3f} ms "
        f"({k3_bound[1]})")
    del work

    # no single PyTorch call computes a gather-GEMM-scatter over a pair
    # list or a block-sparse triangular sweep: library_ms is null
    kernels = [
        {"name": "ll_gemm_scatter", "route": "cuda",
         "source": "pastix_tpu_torch/csrc/ll_gemm_scatter.cu",
         "replaces": "pastix_tpu/numeric/leftlook.py:469",
         "launches": launches["K1"], "max_abs_err": errs["K1"],
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "sweep", "route": "cuda",
         "source": "pastix_tpu_torch/csrc/sweep.cu",
         "replaces": "pastix_tpu/numeric/sweep_kernels.py:241",
         "launches": launches["K2"], "max_abs_err": errs["K2"],
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
        {"name": "pipelined_gemm_scatter", "route": "cuda",
         "source": "pastix_tpu_torch/csrc/pipelined_gemm_scatter.cu",
         "replaces": "pastix_tpu/numeric/pallas_kernels.py:666",
         "launches": schur_launches["K3"], "max_abs_err": errs["K3"],
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": None},
    ]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
