"""Hand the reference's factors to the port.

``factors_from_jax`` takes a ``pastix_tpu`` ``Factors`` (its pool and
dinv arrays are read through ``numpy.asarray``, so this module imports no
JAX) and returns the port's :class:`~pastix_tpu_torch.numeric.factorize.
Factors` on ``device``.  The ``SolverLayout`` is numpy already and is
shared as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from pastix_tpu.config import Factorization
from pastix_tpu_torch._device import resolve_device
from pastix_tpu_torch.numeric.factorize import Factors, build_diag_inverse_fn


def factors_from_jax(factors, device=None) -> Factors:
    """LLᵗ only; the inverse diagonal tiles are computed here when the
    reference did not keep them."""
    if factors.kind != Factorization.LLT:
        raise NotImplementedError(
            f"{factors.kind} factors: only LLT is ported (ROADMAP.md slice 2)"
        )
    dev = resolve_device(device)
    pool = torch.tensor(np.asarray(factors.pool, np.float32), device=dev)
    if factors.dinv is not None:
        dinv = torch.tensor(np.asarray(factors.dinv, np.float32),
                            device=dev)
    else:
        dinv = build_diag_inverse_fn(factors.layout, dev)(pool)
    return Factors(Factorization.LLT, factors.layout, pool, dinv,
                   int(factors.n_static_pivots))
