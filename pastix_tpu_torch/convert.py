"""Hand the reference's factors to the port.

``factors_from_jax`` takes a ``pastix_tpu`` ``Factors`` (its pool and
dinv arrays are read through ``numpy.asarray``, its ``kind`` by enum
name, so this module imports nothing of the JAX package) and returns the
port's :class:`~pastix_tpu_torch.numeric.factorize.Factors` on
``device``.  The ``SolverLayout`` is numpy already and is shared as it is.
``pool_sharding_from_jax`` and ``sharded_factors_from_jax`` carry the
reference's mesh layout (its owner-computes ``PoolSharding`` and its
(ndev, nloc, T, T) factors) across the same way.
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


def pool_sharding_from_jax(sh):
    """The port's ``parallel.owner.PoolSharding`` of a ``pastix_tpu``
    one (read attribute by attribute: numpy arrays and ints)."""
    from pastix_tpu_torch.parallel.owner import PoolSharding

    tr = getattr(sh, "tail_rows", None)
    return PoolSharding(
        ndev=int(sh.ndev), nloc=int(sh.nloc),
        owner=np.array(sh.owner, np.int32), loc=np.array(sh.loc, np.int32),
        owner_col=np.array(sh.owner_col, np.int32),
        tail_rows=None if tr is None else np.array(tr, np.int64),
    )


def sharded_factors_from_jax(factors, sharding, rank=None, device=None):
    """The reference's owner-computes factors (pools of shape (ndev, nloc,
    T, T), ``sharding`` its ``PoolSharding``) as the port's
    :class:`Factors`: with ``rank``, that rank's (nloc, T, T) tiles, as
    the port's owner path holds them (``Factors`` of a mesh rank); with
    None, the global pools (``from_local``) with their inverse diagonal
    tiles, as :func:`factors_from_jax` gives one device's.  The pivots
    ``d`` (LDLᵗ) are replicated and carried as they are."""
    kind = Factorization[factors.kind.name]
    dev = resolve_device(device)
    sh = pool_sharding_from_jax(sharding)
    lay = factors.layout
    pick = ((lambda a: np.asarray(a)[rank]) if rank is not None
            else sh.from_local)
    dt = np.asarray(factors.pool).dtype
    tens = lambda a: torch.tensor(np.asarray(a, dt), device=dev)
    out = Factors(
        kind, lay, tens(pick(factors.pool)),
        pool_u=(tens(pick(factors.pool_u)) if kind == Factorization.LU
                else None),
        d=(tens(factors.d) if kind in (Factorization.LDLT, Factorization.LDLH)
           else None),
        n_static_pivots=int(factors.n_static_pivots),
    )
    if rank is None:
        inv = build_diag_inverse_fn(lay, dev, kind)(out.pool)
        out.dinv, out.dinv_u = inv if kind == Factorization.LU else (inv, None)
    return out
