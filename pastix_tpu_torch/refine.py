"""Iterative refinement on the host (the Richardson block loop of
``pastix_tpu/refine.py``, numpy only).

``refine_block`` and ``RefineResult`` are verbatim copies; the Schur path
(``Pastix.solve_with_schur``) polishes its solution with them, as the
reference does.  Residuals are accumulated at ``dtype`` (fp64).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RefineResult:
    x: np.ndarray
    iterations: int
    residual: float
    converged: bool
    history: list


def refine_block(
    matvec,
    precond,
    b: np.ndarray,
    x0: np.ndarray,
    eps: float = 1e-10,
    itermax: int = 250,
    dtype=np.float64,
) -> RefineResult:
    """Richardson refinement on a whole RHS block (n, nrhs) at once.

    One factored solve per iteration refines every column together (the
    batched-update analog of pivot_smp for multiple RHS); stops when the
    worst column residual meets eps.
    """
    b = np.asarray(b, dtype=dtype)
    x = np.asarray(x0, dtype=dtype).copy()
    bnorm = np.linalg.norm(b, axis=0)
    bnorm = np.where(bnorm == 0, 1.0, bnorm)
    hist = []
    for it in range(itermax):
        r = b - matvec(x)
        res = float((np.linalg.norm(r, axis=0) / bnorm).max())
        hist.append(res)
        if res <= eps:
            return RefineResult(x, it, res, True, hist)
        x = x + np.asarray(precond(r), dtype=dtype)
    r = b - matvec(x)
    res = float((np.linalg.norm(r, axis=0) / bnorm).max())
    hist.append(res)
    return RefineResult(x, itermax, res, res <= eps, hist)
