"""Device iterative refinement (PyTorch counterpart of the Richardson
loop of ``pastix_tpu/krylov.py``).

The reference runs a fused fp32 loop plus host fp64 refinement below
``PASTIX_DEVREF_MAX_NBC`` and a two-float step loop above it: the TPU has
no fp64 unit and its remote compiler wedged on the fused program.  The
H100 has native fp64, so the port runs one loop: ``x`` and the residual
``b - A x`` in fp64 (an ELL gather-and-sum, as the reference's XLA code),
the correction ``M^{-1} r`` in fp32 through the two K2 sweeps.

``build_ell`` is a verbatim copy of the host helper in
``pastix_tpu/krylov.py`` (that module imports JAX).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def build_ell(Acoo, nflat, dtype):
    """COO/CSR -> ELLPACK (cols, vals) numpy arrays, rows padded to the
    max row count.

    The device COO scatter-add SpMV measured 365 ms at the 1M flagship
    (~65 ns/row scatter, the round-2 packed-E2 lesson all over again);
    ELL turns it into one dense gather + reduce (<1 ms): padding slots
    point at column 0 with value 0.
    """
    csr = Acoo.tocsr()
    counts = np.diff(csr.indptr)
    k = max(1, int(counts.max()) if counts.size else 1)
    cols = np.zeros((nflat, k), np.int32)
    vals = np.zeros((nflat, k), dtype)
    r = np.repeat(np.arange(csr.shape[0]), counts)
    offs = np.arange(r.size) - np.repeat(csr.indptr[:-1], counts)
    cols[r, offs] = csr.indices
    vals[r, offs] = csr.data
    return cols, vals


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor):
    """y = A x for ELL ``(cols, vals)`` (nflat, k) and ``x`` (nflat, R)."""
    return (vals[:, :, None] * x[cols]).sum(1)


def build_device_refine_fn(layout, solve_fn):
    """``fn(factors, cols, vals, b, eps, itermax) -> (x, iters)``.

    ``factors`` is the tuple of the kind's factor tensors that
    ``solve_fn`` takes (``Factors.solve_args``); ``b`` the (nflat, R) fp64
    padded permuted RHS, ``cols``/``vals`` the fp64 ELL matrix of the
    whole ``A_perm`` (unsymmetric for LU), all on one device.  Richardson
    refinement x += M^{-1}(b - A x) from x = M^{-1} b, stopping when
    ||r||^2 <= eps^2 ||b||^2, when a step fails to cut ||r||^2 by 4
    (the reference's stall check, ``krylov.py`` and ``pastix.py``), or at
    ``itermax`` steps.  One scalar per step goes to the host."""
    nbc, T = layout.nbc, layout.T

    def precond(factors, r):
        z = solve_fn(*factors, r.to(torch.float32).view(nbc, T, -1))
        return z.reshape(nbc * T, -1).to(torch.float64)

    def fn(factors, cols, vals, b, eps, itermax):
        eps2 = eps * eps * max(float((b * b).sum()), 1e-300)
        x = precond(factors, b)
        r = b - ell_spmv(cols, vals, x)
        it, prev = 0, math.inf
        while it < itermax:
            r2 = float((r * r).sum())
            if r2 <= eps2 or not r2 < 0.25 * prev:
                break
            prev = r2
            x += precond(factors, r)
            r = b - ell_spmv(cols, vals, x)
            it += 1
        return x, it

    return fn
