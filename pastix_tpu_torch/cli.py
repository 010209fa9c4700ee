"""Command-line driver — the reference's example binaries as one CLI (a
copy of ``pastix_tpu/cli.py``: ``--cpu`` runs on the CPU, else the solver
runs on ``cuda`` and fails when there is none).

Mirrors ``src/example/src/simple.c`` / ``step-by-step.c`` and the shared
flag vocabulary of ``get_options.c`` (SURVEY.md section 2 row 21):

  python -m pastix_tpu_torch.cli -lap 100                 # 2D Laplacian smoke test
  python -m pastix_tpu_torch.cli -lap3 32 --fact ldlt     # 3D Poisson, LDL^T
  python -m pastix_tpu_torch.cli -mm matrix.mtx --rhs random
  python -m pastix_tpu_torch.cli -hb matrix.rsa --steps   # phase-by-phase + reuse

Prints the relative residual ||b-Ax||/||b|| at the end (the de-facto
acceptance check in every reference example).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pastix-tpu-torch",
        description="supernodal sparse direct solver (PyTorch/CUDA)",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("-mm", metavar="FILE", help="MatrixMarket file")
    src.add_argument("-hb", "-rsa", dest="hb", metavar="FILE",
                     help="Harwell-Boeing / RSA file")
    src.add_argument("-ijv", "-3files", dest="ijv", metavar="PREFIX",
                     help="IJV 3files prefix")
    src.add_argument("-petsc", metavar="FILE", help="PETSc binary file")
    src.add_argument("-lap", type=int, metavar="N",
                     help="generated 2D N x N Laplacian")
    src.add_argument("-lap3", type=int, metavar="N",
                     help="generated 3D N^3 Poisson")
    src.add_argument("-elas3", type=int, metavar="N",
                     help="generated 3D N^3 elasticity")
    p.add_argument("--fact", choices=["llt", "ldlt", "ldlh", "lu"],
                   default=None,
                   help="factorization kind (default: llt for symmetric, lu otherwise)")
    p.add_argument("--ord", choices=["nd", "amd", "rcm", "natural"],
                   default="nd", help="ordering method (IPARM_ORDERING)")
    p.add_argument("--tile", type=int, default=None,
                   help="tile size override (IPARM_MAX_BLOCKSIZE analog)")
    p.add_argument("--rhs", choices=["ones", "i", "random"], default="ones",
                   help="generated RHS: b = A x_true (IPARM_RHS_MAKING)")
    p.add_argument("--nrhs", type=int, default=1)
    p.add_argument("--refine", choices=["none", "simple", "cg", "gmres",
                                        "bicgstab"], default=None)
    p.add_argument("--eps-refine", type=float, default=None,
                   help="DPARM_EPSILON_REFINEMENT")
    p.add_argument("--dtype", choices=["f32", "f64", "c64", "c128"],
                   default="f32")
    p.add_argument("--steps", action="store_true",
                   help="step-by-step: phase API + refactorize new values "
                        "with cached analysis (reference step-by-step.c)")
    p.add_argument("--mesh", metavar="SHAPE", default=None,
                   help="device mesh, e.g. 8 or 2x4 (the reference's "
                        "process-count flag; axes dp x tp when 2D)")
    p.add_argument("--ooc", type=int, metavar="MB", default=None,
                   help="stream factorization under this HBM budget "
                        "(IPARM_OOC_LIMIT)")
    p.add_argument("-v", "--verbose", action="count", default=1,
                   help="repeat for more (IPARM_VERBOSE ladder)")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the CUDA card)")
    return p


def _load_matrix(args):
    from pastix_tpu_torch import drivers

    if args.lap is not None:
        return drivers.read_matrix(f"lap:{args.lap}")
    if args.lap3 is not None:
        return drivers.read_matrix(f"lap3:{args.lap3}")
    if args.elas3 is not None:
        return drivers.read_matrix(f"elas3:{args.elas3}")
    if args.mm:
        return drivers.read_matrix(args.mm, driver="mm")
    if args.hb:
        return drivers.read_matrix(args.hb, driver="hb")
    if args.ijv:
        return drivers.read_matrix(args.ijv, driver="ijv")
    if args.petsc:
        return drivers.read_matrix(args.petsc, driver="petsc")
    raise AssertionError


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from pastix_tpu_torch import Pastix, PastixConfig, drivers
    from pastix_tpu_torch.config import (
        Factorization,
        OrderingMethod,
        RefinementMethod,
        Symmetry,
    )

    A = _load_matrix(args)
    S = A.to_scipy()
    sym = (S - S.T).nnz == 0
    fact = args.fact or ("llt" if sym else "lu")
    kw = dict(
        factorization={"llt": Factorization.LLT, "ldlt": Factorization.LDLT,
                       "ldlh": Factorization.LDLH,
                       "lu": Factorization.LU}[fact],
        ordering={"nd": OrderingMethod.ND, "amd": OrderingMethod.AMD,
                  "rcm": OrderingMethod.RCM,
                  "natural": OrderingMethod.NATURAL}[args.ord],
        compute_dtype={"f32": "float32", "f64": "float64",
                       "c64": "complex64", "c128": "complex128"}[args.dtype],
        verbosity=0 if args.quiet else args.verbose,
    )
    if args.tile:
        kw["tile_size"] = args.tile
    if args.refine is not None:
        kw["refinement"] = {
            "none": RefinementMethod.NONE,
            "simple": RefinementMethod.SIMPLE,
            "cg": RefinementMethod.CG,
            "gmres": RefinementMethod.GMRES,
            "bicgstab": RefinementMethod.BICGSTAB,
        }[args.refine]
    if args.eps_refine is not None:
        kw["refinement_eps"] = args.eps_refine
    if args.mesh:
        shape = tuple(int(s) for s in args.mesh.lower().split("x"))
        kw["mesh_shape"] = shape
        if len(shape) == 2:
            kw["mesh_axis_names"] = ("dp", "tp")
    if args.ooc is not None:
        kw["ooc"] = True
        kw["ooc_limit_mb"] = args.ooc
    cfg = PastixConfig(**kw)

    x_true = {
        "ones": np.ones(A.n),
        "i": np.arange(1, A.n + 1, dtype=np.float64),
        "random": np.random.default_rng(0).standard_normal(A.n),
    }[args.rhs]
    if args.nrhs > 1:
        x_true = np.tile(x_true[:, None], (1, args.nrhs))
    b = S @ x_true

    solver = Pastix(A, cfg, device="cpu" if args.cpu else None)
    if args.steps:
        t0 = time.perf_counter()
        solver.order()
        solver.symbfact()
        solver.analyze()
        solver.factorize()
        x = solver.solve(b)
        print(f"[steps] first solve: {time.perf_counter() - t0:.2f}s")
        # pattern-reuse: new values, same pattern (reference step-by-step.c)
        S2 = S * 2.0
        t0 = time.perf_counter()
        solver.factorize(2.0 * solver.A.values)
        x2 = solver.solve(2.0 * b)
        print(f"[steps] refactorize+solve (cached analysis): "
              f"{time.perf_counter() - t0:.2f}s")
        r2 = np.linalg.norm(2 * b - S2 @ x2) / np.linalg.norm(2 * b)
        print(f"[steps] reuse residual = {r2:.3e}")
    else:
        x = solver.solve(b)

    r = np.linalg.norm(b - S @ x) / np.linalg.norm(b)
    ferr = np.abs(x - x_true).max() / max(np.abs(x_true).max(), 1.0)
    if not args.quiet:
        print(solver.report.summary())
    print(f"residual ||b-Ax||/||b|| = {r:.3e}   forward error = {ferr:.3e}")
    return 0 if r < 1e-6 else 1


if __name__ == "__main__":
    sys.exit(main())
