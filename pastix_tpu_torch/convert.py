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


def factors_from_jax(factors, device=None) -> Factors:
    """LLᵗ only, Schur mode included (the pool's Schur tiles hold S).  The
    inverse diagonal tiles are computed here when the reference did not
    keep them; the slots of unfactored (Schur) columns are zeroed, as the
    port's own ``build_diag_inverse_fn`` leaves them."""
    kind = Factorization[factors.kind.name]
    if kind != Factorization.LLT:
        raise NotImplementedError(
            f"{kind} factors: only LLT is ported (ROADMAP.md slice 2)"
        )
    dev = resolve_device(device)
    lay = factors.layout
    pool = torch.tensor(np.asarray(factors.pool, np.float32), device=dev)
    if factors.dinv is None:
        dinv = build_diag_inverse_fn(lay, dev)(pool)
    else:
        dinv = np.array(factors.dinv, np.float32)
        unfactored = np.setdiff1d(np.arange(lay.nbc), factored_cols(lay))
        dinv[unfactored] = 0.0
        dinv = torch.tensor(dinv, device=dev)
    return Factors(kind, lay, pool, dinv, int(factors.n_static_pivots))
