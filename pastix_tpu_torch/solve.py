"""Triangular solve (PyTorch counterpart of ``pastix_tpu/solve.py``, the
LLᵗ branch of ``build_solve_fn_sweep``).

``rhs_to_blocks`` / ``blocks_to_rhs`` are verbatim copies of the host
helpers in ``pastix_tpu/solve.py`` (that module imports JAX).
"""

from __future__ import annotations

import numpy as np
import torch

from pastix_tpu.analyze.layout import SolverLayout
from pastix_tpu_torch.numeric.sweep_kernels import (
    _from_rowvec, _to_rowvec, sweep_bwd, sweep_fwd, sweep_plan,
)


def rhs_to_blocks(layout: SolverLayout, b_perm: np.ndarray, dtype=np.float32):
    """(n, R) permuted RHS -> (nbc, T, R) padded block layout."""
    n, T, nbc = layout.n, layout.T, layout.nbc
    b = np.asarray(b_perm, dtype=dtype)
    if b.ndim == 1:
        b = b[:, None]
    pad = np.zeros((nbc * T, b.shape[1]), dtype=dtype)
    pad[:n] = b
    return pad.reshape(nbc, T, -1)


def blocks_to_rhs(layout: SolverLayout, xb) -> np.ndarray:
    """(nbc, T, R) block layout -> (n, R)."""
    x = np.asarray(xb).reshape(layout.nbc * layout.T, -1)
    return x[: layout.n]


def build_solve_fn_sweep(layout: SolverLayout, device):
    """LLᵗ solve through the whole-sweep kernel K2:
    ``fn(pool, dinv, b) -> x`` with ``b`` a float32 (nbc, T, R) block RHS
    on ``device``.  The op stream covers every level including the
    dense-tail columns, whose factored tiles live in the pool.
    ``fn.plan`` holds the sweep tables."""
    plan = sweep_plan(layout, device)
    nbc, T = layout.nbc, layout.T

    def fn(pool: torch.Tensor, dinv: torch.Tensor, b: torch.Tensor):
        y2 = _to_rowvec(b.to(torch.float32))
        sweep_fwd(pool, dinv, y2, plan)
        sweep_bwd(pool, dinv, y2, plan)
        return _from_rowvec(y2, nbc, T)

    fn.plan = plan
    return fn
