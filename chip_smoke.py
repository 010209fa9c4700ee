#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pastix_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--nx N]

Phases; any failed check raises, so the script exits non-zero and never
prints the final ``ok`` line:

1. device: a CUDA device is required; prints the card's name and power
   limit (nvidia-smi);
2. build: compiles the hand-written CUDA kernels from ``csrc/``;
3. kernels: on the poisson_3d(24) T=128 layout, each kernel
   against its plain PyTorch twin on the same inputs: K1 (left-looking E2)
   on the busiest level's chunks and on the dense-tail pre-pass, bf16 and
   fp32 updates, max|d| <= 1e-4 max|ref| (summation order only); K2
   (sweeps) forward + backward at R = 1 and R = 3, relative error <= 1e-5;
4. main path: ``Pastix(poisson_3d(--nx), T=128, bf16 updates)`` through
   order, symbfact, analyze, factorize (twice, the second timed) and a
   refined solve of b = A.1 to a fp64 residual <= 1e-10; the kernels'
   launch counts must rise and the twins' stay 0;
5. main-path shapes: K1 on the main path's busiest level and tail
   pre-pass and K2 on its sweeps, each against its twin as in 3, then
   each kernel and its twin timed (CUDA events); printed as one JSON line
   of kernels after the card's nvidia-smi line;

and last ``{"ok": true, "device": {...}}``.  --nx 64 is n = 262,144;
--nx 100 is the 1M-unknown flagship of bench.py.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

TOL_K1 = 1e-4  # max|kernel - twin| / max|twin|: summation order only
TOL_K2 = 1e-5  # the same for the sweeps
TOL_RES = 1e-10  # fp64 ||b - A x|| / ||b|| after refinement


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


def check_k1(pool, chunks, update_dtype, label):
    """K1 against its twin on copies of ``pool``; returns max|d|."""
    import torch
    from pastix_tpu_torch.numeric import leftlook as LL

    got = LL.gemm_scatter_ll(pool.clone(), chunks, update_dtype)
    ref = LL.gemm_scatter_ll_ref(pool.clone(), chunks, update_dtype)
    torch.cuda.synchronize()
    touched = torch.cat([c.seg_dst for c in chunks]).unique()
    scale = float(ref[touched].abs().max())
    err = float((got - ref).abs().max())
    ok = err <= TOL_K1 * scale
    log(f"K1 {label}: {len(chunks)} chunks, "
        f"{sum(c.n_pairs for c in chunks)} pairs, max|d|={err:.3e} "
        f"max|ref|={scale:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K1 {label} disagrees with its twin")
    return err


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


def analyzed(A, cfg, dev):
    from pastix_tpu_torch import Pastix

    s = Pastix(A, cfg, device=dev)
    t = {}
    for phase in ("order", "symbfact", "analyze"):
        t0 = time.perf_counter()
        getattr(s, phase)()
        t[phase] = time.perf_counter() - t0
    return s, t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=64,
                    help="main path: poisson_3d(nx) (default 64)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from pastix_tpu.config import PastixConfig
    from pastix_tpu.generators import poisson_3d
    from pastix_tpu_torch import _build
    from pastix_tpu_torch._device import card_name_power, pin_precision
    from pastix_tpu_torch.numeric import leftlook as LL
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
        f"(nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    bf16, fp32 = torch.bfloat16, torch.float32

    # 3. kernels against their twins on the poisson_3d(24) layout
    ks, _ = analyzed(poisson_3d(24),
                     PastixConfig(tile_size=128, update_dtype="bfloat16"), dev)
    ks.factorize()
    lv = busiest_level(ks._fact_fn)
    errs = {"K1": 0.0, "K2": 0.0}
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

    # 4. main path
    A = poisson_3d(args.nx)
    cfg = PastixConfig(tile_size=128, update_dtype="bfloat16")
    for fn in (LL.gemm_scatter_ll, SW.run_sweep):
        fn.launches = fn.twin_launches = 0
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
    launches = {"K1": LL.gemm_scatter_ll.launches,
                "K2": SW.run_sweep.launches}
    twins = {"K1": LL.gemm_scatter_ll.twin_launches,
             "K2": SW.run_sweep.twin_launches}
    log(f"  launches {launches}, twin calls {twins}")
    if min(launches.values()) == 0 or max(twins.values()) != 0:
        raise AssertionError("the main path did not run through both kernels")

    # 5. the kernels against their twins, then timed, at the main path's
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
    k1_pairs = sum(c.n_pairs for c in lv.ll)
    log(f"timing K1 busiest level ({len(lv.ll)} chunks, {k1_pairs} pairs, "
        f"bf16): kernel {k1_ms:.3f} ms, twin {k1_plain:.3f} ms")
    tail_ms = cuda_ms(lambda: LL.gemm_scatter_ll(work, s._fact_fn.tail, bf16))
    tail_plain = cuda_ms(
        lambda: LL.gemm_scatter_ll_ref(work, s._fact_fn.tail, bf16))
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
    log(f"timing K2 fwd+bwd R=1 ({len(plan['fwd']) + len(plan['bwd'])} "
        f"phases): kernel {k2_ms:.3f} ms, twin {k2_plain:.3f} ms")

    kernels = [
        {"name": "ll_gemm_scatter", "route": "cuda",
         "source": "pastix_tpu_torch/csrc/ll_gemm_scatter.cu",
         "replaces": "pastix_tpu/numeric/leftlook.py:469",
         "launches": launches["K1"], "max_abs_err": errs["K1"],
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "sweep", "route": "cuda",
         "source": "pastix_tpu_torch/csrc/sweep.cu",
         "replaces": "pastix_tpu/numeric/sweep_kernels.py:241",
         "launches": launches["K2"], "max_abs_err": errs["K2"],
         "ms": k2_ms, "plain_ms": k2_plain},
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
