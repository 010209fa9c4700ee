#!/usr/bin/env python3
"""bf16 against fp32 trailing updates on the shift-and-invert LDLᵗ matrix,
the port (on the CPU, so through its plain twins) beside the JAX
reference (on the CPU), on the same matrix and tile size.

    python tests/ldlt_bf16_reading.py [--tile 128] [--nx 32 40]

The matrix is poisson_3d(nx) - σI, σ halfway between the two smallest
eigenvalues of the 7-point Laplacian (one negative eigenvalue; the gap
to σ shrinks as 1/nx²).  For each nx, side and update dtype it prints
the unrefined error max|x - 1| of b = A·1 and the refined fp64 residual
with its iteration count (the reference's refinement capped at 60
steps).  Not a test: it reads where the bf16 refinement stops
contracting, and takes a few minutes at nx = 40.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repo

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

import pastix_tpu as J  # noqa: E402
import pastix_tpu_torch as P  # noqa: E402
from pastix_tpu_torch.generators import poisson_3d  # noqa: E402
from pastix_tpu_torch.sparse import SparseMatrix  # noqa: E402


def shift_invert(nx):
    mu = lambda k: 2.0 - 2.0 * np.cos(k * np.pi / (nx + 1))
    sigma = (3 * mu(1) + 2 * mu(1) + mu(2)) / 2
    return (poisson_3d(nx).to_scipy() - sigma * sp.eye(nx ** 3)).tocsc()


def port(M, T, upd):
    A = SparseMatrix.from_scipy(M, symmetric_storage=True)
    return P.Pastix(A, P.PastixConfig(tile_size=T, update_dtype=upd,
                                      factorization=P.Factorization.LDLT),
                    device="cpu")


def reference(M, T, upd):
    cfg = J.PastixConfig(tile_size=T, update_dtype=upd,
                         factorization=J.Factorization.LDLT,
                         refinement_itermax=60)
    return J.Pastix(M, cfg)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--nx", type=int, nargs="+", default=[32, 40])
    args = ap.parse_args()
    for nx in args.nx:
        M = shift_invert(nx)
        b = M @ np.ones(M.shape[0])
        for side, make in (("port", port), ("reference", reference)):
            for upd in (None, "bfloat16"):
                t0 = time.perf_counter()
                s = make(M, args.tile, upd)
                x0 = s.solve(b, refine=False)
                x = s.solve(b)
                res = np.linalg.norm(b - M @ x) / np.linalg.norm(b)
                print(f"nx={nx} T={args.tile} {side:9s} "
                      f"{'bf16' if upd else 'fp32'} updates: unrefined "
                      f"max|x-1| {np.abs(x0 - 1).max():.3e}, refined "
                      f"residual {res:.3e} after {s.report.refine_iters} "
                      f"iterations, static pivots {s.report.static_pivots} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
