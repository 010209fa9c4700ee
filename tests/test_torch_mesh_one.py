"""A mesh of one rank: ``mesh_shape=(1,)`` on a process group of one
(gloo, in this process), held against the port's one device.

A group of one runs every collective of the level bodies as a group of
several does (``mesh.Axis`` skips them only without a group), so a card
with one NCCL rank runs NCCL's collectives; here each factorization must
call them.  Tolerances: the owner path adds each level's updates through
a touched buffer, in another fp32 order than one device's scatter-add:
pools to 2e-5 of their largest entry, refined solutions to 1e-8 of
max|x|."""

from collections import Counter

import numpy as np
import pytest
import torch.distributed as dist

from pastix_tpu_torch import Factorization, Pastix, PastixConfig
from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d
from pastix_tpu_torch.parallel.owner import gather_pool
from torch_common import no_calibration  # noqa: F401

POOL_TOL = 2e-5  # of max|pool|: fp32 fan-in summation order
X_TOL = 1e-8  # refined solutions (relative to max|x|)


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", [Factorization.LLT, Factorization.LDLT,
                                  Factorization.LU], ids=lambda k: k.name)
def test_one_rank_mesh_runs_its_collectives(one_rank_group, monkeypatch,
                                            kind):
    A = convection_diffusion_3d(8) if kind == Factorization.LU else \
        poisson_3d(8)
    cfg = dict(tile_size=8, factorization=kind)
    one = Pastix(A, PastixConfig(**cfg), device="cpu")
    one.factorize()

    calls = Counter()
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor"):
        real = getattr(dist, name)

        def wrap(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(dist, name, wrap)
    s = Pastix(A, PastixConfig(mesh_shape=(1,), **cfg), device="cpu")
    s.analyze()
    assert s._pool_sharding is not None  # the owner-computes path
    calls.clear()
    s.factorize()
    nlev = len(s.layout.levels)
    # a fan-in a level at least, and the halo gathers (gloo: list form)
    assert calls["all_reduce"] >= nlev, calls
    assert calls["all_gather"] > 0, calls

    names = ("pool", "pool_u") if kind == Factorization.LU else ("pool",)
    for name in names:
        got = gather_pool(s._pool_sharding, getattr(s.factors, name), s._tp)
        ref = getattr(one.factors, name).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= POOL_TOL * np.abs(ref).max()
    if kind == Factorization.LDLT:
        np.testing.assert_allclose(s.factors.d.numpy(), one.factors.d.numpy(),
                                   rtol=POOL_TOL, atol=0)
    assert s.report.static_pivots == one.report.static_pivots

    M = A.to_scipy()
    b = M @ np.arange(1.0, A.n + 1)
    x, x1 = s.solve(b), one.solve(b)
    assert np.abs(x - x1).max() <= X_TOL * np.abs(x1).max()
    assert np.linalg.norm(b - M @ x) <= 1e-10 * np.linalg.norm(b)
