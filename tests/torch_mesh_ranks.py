"""The rank side of ``tests/test_torch_mesh.py``: functions that
``pastix_tpu_torch.parallel.launch.run_ranks`` runs in each spawned rank
process.  This module imports numpy, torch and the port only, so a rank
loads neither JAX nor ``pastix_tpu`` (each job reports what it found in
``sys.modules``).  Every job solves at small sizes on the CPU and returns
what the test holds against the reference: gathered pools, solutions,
pivot counts and the mesh's geometry."""

import os
import sys

import numpy as np
import torch

LOADED = ("jax", "jaxlib", "pastix_tpu")


def rank_setup() -> None:
    """A rank's process: no cost-model calibration (the port's mesh
    ranks skip it; these jobs hold none of it), set in the rank only."""
    os.environ["PASTIX_MEASURED_PLAN"] = "0"


def loaded() -> list:
    """The modules of JAX or of the reference package in this process."""
    return sorted(m for m in sys.modules if m.split(".")[0] in LOADED)


def problem(name: str):
    """The matrices of the mesh tests, as scipy CSC matrices (both
    packages take them)."""
    from pastix_tpu_torch.generators import (
        convection_diffusion_3d, laplacian_2d, poisson_3d,
    )

    if name == "poisson10":
        return poisson_3d(10).to_scipy().tocsc()
    if name == "poisson8":
        return poisson_3d(8).to_scipy().tocsc()
    if name == "convdiff8":
        return convection_diffusion_3d(8).to_scipy().tocsc()
    if name == "zeros8":
        # poisson_3d(8) with five isolated unknowns of zero diagonal:
        # five exactly zero pivots, each clamped once, in columns the
        # ranks own apart
        A = poisson_3d(8).to_scipy().tolil()
        for i in (3, 100, 250, 400, 511):
            A[i, :] = 0
            A[:, i] = 0
        return A.tocsc()
    if name == "helmholtz":
        import scipy.sparse as sp

        A0 = laplacian_2d(12).to_scipy().astype(np.complex128)
        n = A0.shape[0]
        P = sp.random(n, n, 0.01, random_state=1)
        A = (A0 + ((P - P.T) * 0.1j).tocsc()).tocsc()
        return ((A + A.conj().T) * 0.5 + sp.eye(n) * 0.1).tocsc()
    raise ValueError(name)


def rhs(A, nrhs: int):
    """b = A x for a fixed random x (one column: a vector)."""
    S = A
    rng = np.random.default_rng(7)
    x = rng.standard_normal((S.shape[0], nrhs))
    if np.iscomplexobj(S.data):
        x = x + 1j * rng.standard_normal(x.shape)
    b = S @ x
    return b[:, 0] if nrhs == 1 else b


def _result(s, X) -> dict:
    """What a solve leaves for the test, the pool gathered to (npool, T,
    T) on the owner path (``owner.gather_pool``)."""
    from pastix_tpu_torch.parallel.owner import gather_pool

    f = s.factors
    out = {"X": X, "residual": s.report.residual,
           "iters": s.report.refine_iters, "npiv": s.report.static_pivots,
           "owner": s._pool_sharding is not None,
           "sharded_refine": s._sharded_refine_fn is not None,
           "dense_tail_m": s.report.dense_tail_m,
           "d": None if f.d is None else f.d.numpy()}
    if s._pool_sharding is not None:
        sh = s._pool_sharding
        out["nloc"], out["npool"] = sh.nloc, s.layout.npool
        out["local_shape"] = tuple(f.pool.shape)
        out["pool"] = gather_pool(sh, f.pool, s._tp)
        if f.pool_u is not None:
            out["pool_u"] = gather_pool(sh, f.pool_u, s._tp)
    else:
        out["pool"] = f.pool.numpy()
        if f.pool_u is not None:
            out["pool_u"] = f.pool_u.numpy()
    return out


def solve_job(rank: int, cases: list) -> list:
    """Each case (matrix name, config fields, RHS columns, Schur rows):
    a ``Pastix`` on the mesh of the config, solved, or with Schur rows its
    ``get_schur`` and ``solve_with_schur``."""
    from pastix_tpu_torch import Pastix, PastixConfig

    rank_setup()
    out = []
    for name, fields, nrhs, schur in cases:
        A = problem(name)
        s = Pastix(A, PastixConfig(**fields), device="cpu")
        b = rhs(A, nrhs)
        if schur:
            n = A.shape[0]
            s.set_schur_unknowns(np.arange(n - schur, n))
            s.factorize()
            r = _result(s, None)
            r["S"] = s.get_schur()
            r["X"] = s.solve_with_schur(b)
        else:
            r = _result(s, s.solve(b))
        out.append(r)
    return out + [loaded()]


def front_door_job(rank: int) -> dict:
    """``spsolve``, ``pastix()`` and ``factorize(values)`` on a mesh of
    every rank; a ``mesh_shape`` of another size must raise."""
    from pastix_tpu_torch import PastixConfig, spsolve
    from pastix_tpu_torch.generators import poisson_3d
    from pastix_tpu_torch.pastix import Pastix, pastix

    rank_setup()
    n = torch.distributed.get_world_size()
    A = poisson_3d(6)
    S = A.to_scipy()
    b = S @ np.ones(A.n)
    cfg = dict(tile_size=8, mesh_shape=(n,))
    out = {"spsolve": spsolve(S, b, config=PastixConfig(**cfg),
                              device="cpu")}
    x, rep = pastix(A.n, A.colptr, A.rowind, A.values, b,
                    config=PastixConfig(**cfg), device="cpu")
    out["pastix"], out["pastix_residual"] = x, rep.residual
    s = Pastix(A, PastixConfig(**cfg), device="cpu")
    out["x1"] = s.solve(b)
    s.factorize(values=A.values * 2.0)
    out["x2"] = s.solve(b)
    out["owner"] = s._pool_sharding is not None
    try:
        Pastix(A, PastixConfig(tile_size=8, mesh_shape=(n - 1,)),
               device="cpu")
        out["wrong_size"] = None
    except ValueError as e:
        out["wrong_size"] = str(e)
    out["loaded"] = loaded()
    return out
