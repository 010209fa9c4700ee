"""Hand the reference's factors to the port.

``factors_from_jax`` takes a ``pastix_tpu`` ``Factors`` (its pool and
dinv arrays are read through ``numpy.asarray``, its ``kind`` by enum
name, so this module imports nothing of the JAX package) and returns the
port's :class:`~pastix_tpu_torch.numeric.factorize.Factors` on
``device``.  The ``SolverLayout`` is numpy already and is shared as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from pastix_tpu_torch._device import resolve_device
from pastix_tpu_torch.config import Factorization
from pastix_tpu_torch.numeric.factorize import (
    Factors, build_diag_inverse_fn, factored_cols,
)


def factors_from_jax(factors, device=None, hermitian=None) -> Factors:
    """LLᵗ (LLᴴ), LDLᵗ, LDLᴴ and LU in their own dtype (float32,
    float64, complex64, complex128), Schur mode included (the pool's Schur
    tiles hold S): the pool, the Uᵗ pool (LU) and the pivots (LDLᵗ, LDLᴴ)
    are carried across.  ``hermitian`` (default: the reference's, LLᵗ and
    LDLᴴ) marks a complex pool's factors as conjugated.  The inverse
    diagonal tiles are computed here when the reference did not keep
    them; the slots of unfactored (Schur) columns are zeroed, as the
    port's own ``build_diag_inverse_fn`` leaves them."""
    kind = Factorization[factors.kind.name]
    dev = resolve_device(device)
    lay = factors.layout
    dt = np.asarray(factors.pool).dtype
    if hermitian is None:
        hermitian = kind in (Factorization.LLT, Factorization.LDLH)
    tens = lambda a: torch.tensor(np.asarray(a, dt), device=dev)
    out = Factors(
        kind, lay, tens(factors.pool),
        pool_u=tens(factors.pool_u) if kind == Factorization.LU else None,
        d=(tens(factors.d) if kind in (Factorization.LDLT, Factorization.LDLH)
           else None),
        n_static_pivots=int(factors.n_static_pivots),
        hermitian=bool(hermitian) and np.iscomplexobj(factors.pool),
    )
    if factors.dinv is None:
        inv = build_diag_inverse_fn(lay, dev, kind)(out.pool)
        out.dinv, out.dinv_u = inv if kind == Factorization.LU else (inv, None)
        return out
    unfactored = np.setdiff1d(np.arange(lay.nbc), factored_cols(lay))

    def kept(dinv):
        dinv = np.array(dinv, dt)
        dinv[unfactored] = 0.0
        return torch.tensor(dinv, device=dev)

    out.dinv = kept(factors.dinv)
    if kind == Factorization.LU:
        out.dinv_u = kept(factors.dinv_u)
    return out
