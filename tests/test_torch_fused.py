"""The E2 kernels K9 (``gemm_scatter_fused``) and K10
(``gemm_scatter_blockspec``) of ``numeric/fused.py`` against the JAX
reference's Pallas kernels in interpret mode, on the CPU.

- ``sort_triples`` emits the reference's arrays.
- The twins (what K9 and K10 run on CPU tensors) against
  ``gemm_scatter_fused`` and ``gemm_scatter_blockspec`` in interpret mode
  on the same triples (T=16, 33 triples, as tests/test_pallas.py draws
  them): plain, ``d`` and ``src_pool``, with bf16 and with no update
  dtype; rtol = atol = 1e-3, since the reference forms its fp32 products
  from three bf16 passes where the port multiplies in fp32.  K10 also on
  a schedule cut into three chunks (a segment split between two).
- What the kernels refuse: a dst tile that is also an a tile (or a b
  tile read from the same pool), a ``group > 1`` schedule for K10, and
  flags that do not mark the runs of equal dst.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pastix_tpu.numeric.pallas_kernels as JPK

from pastix_tpu_torch.numeric import fused as FU
from pastix_tpu_torch.numeric.pipelined import build_pipeline_schedule

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

NPOOL, NSRC, T, NG = 40, 20, 16, 33


@pytest.fixture(scope="module")
def data():
    """pool, a second pool (LU's), pivots d and the triples with gk."""
    rng = np.random.default_rng(7)
    pool = rng.standard_normal((NPOOL, T, T)).astype(np.float32)
    pool_u = rng.standard_normal((NPOOL, T, T)).astype(np.float32)
    d = rng.uniform(0.5, 2.0, (8, T)).astype(np.float32)
    ga = rng.integers(0, NSRC, NG).astype(np.int32)
    gb = rng.integers(0, NSRC, NG).astype(np.int32)
    gd = rng.integers(NSRC, NPOOL, NG).astype(np.int32)
    gk = rng.integers(0, 8, NG).astype(np.int32)
    return pool, pool_u, d, ga, gb, gd, gk


@pytest.mark.parametrize("with_gk", [False, True])
def test_sort_triples_equals_reference(data, with_gk):
    *_, ga, gb, gd, gk = data
    gk = gk if with_gk else None
    got = FU.sort_triples(ga, gb, gd, gk)
    want = JPK.sort_triples(ga, gb, gd, gk)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


VARIANTS = ["plain", "d", "src_pool"]
UPDATES = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp32": (None, None)}


def _kwargs(data, variant):
    """(reference kwargs, port kwargs, gk) of one variant."""
    pool, pool_u, d, *_, gk = data
    if variant == "d":
        return ({"d": jnp.asarray(d)}, {"d": torch.from_numpy(d)}, gk)
    if variant == "src_pool":
        return ({"src_pool": jnp.asarray(pool_u)},
                {"src_pool": torch.from_numpy(pool_u)}, None)
    return {}, {}, None


@pytest.mark.parametrize("upd", list(UPDATES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_fused_matches_reference(data, variant, upd):
    pool, _, _, ga, gb, gd, _ = data
    j_kw, t_kw, gk = _kwargs(data, variant)
    j_upd, t_upd = UPDATES[upd]
    st = JPK.sort_triples(ga, gb, gd, gk)
    want = np.asarray(JPK.gemm_scatter_fused(
        jnp.asarray(pool), *st[:5], gk=None if gk is None else st[5],
        update_dtype=j_upd, interpret=True, **j_kw))
    plan = FU.fused_plan(*FU.sort_triples(ga, gb, gd, gk), device="cpu")
    n0 = FU.gemm_scatter_fused.twin_launches
    got = FU.gemm_scatter_fused(torch.from_numpy(pool.copy()), plan, t_upd,
                                **t_kw).numpy()
    assert FU.gemm_scatter_fused.twin_launches == n0 + 1
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("upd", list(UPDATES))
@pytest.mark.parametrize("variant", VARIANTS + ["chunked"])
def test_blockspec_matches_reference(data, variant, upd):
    pool, _, _, ga, gb, gd, _ = data
    j_kw, t_kw, gk = _kwargs(data, "plain" if variant == "chunked" else
                             variant)
    j_upd, t_upd = UPDATES[upd]
    chunk = 12 if variant == "chunked" else 8192
    sched = build_pipeline_schedule(ga, gb, gd, gk=gk, chunk=chunk)
    if variant == "chunked":
        assert len(sched) == 3
        assert any(a["gd"][-1] == b["gd"][0] for a, b in zip(sched, sched[1:]))
    want = np.asarray(JPK.gemm_scatter_blockspec(
        jnp.asarray(pool), JPK.build_pipeline_schedule(ga, gb, gd, gk=gk,
                                                       chunk=chunk),
        update_dtype=j_upd, interpret=True, **j_kw))
    plan = FU.blockspec_plan(sched, "cpu")
    n0 = FU.gemm_scatter_blockspec.twin_launches
    got = FU.gemm_scatter_blockspec(torch.from_numpy(pool.copy()), plan,
                                    t_upd, **t_kw).numpy()
    assert FU.gemm_scatter_blockspec.twin_launches == n0 + 1
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("side", ["a", "b"])
def test_fused_refuses_dst_meeting_operands(data, side):
    pool, pool_u, _, ga, gb, gd, _ = data
    ga, gb = ga.copy(), gb.copy()
    (ga if side == "a" else gb)[5] = gd[9]
    plan = FU.fused_plan(*FU.sort_triples(ga, gb, gd), device="cpu")
    p = torch.from_numpy(pool.copy())
    for fn in (FU.gemm_scatter_fused, FU.gemm_scatter_fused_ref):
        with pytest.raises(ValueError, match="race"):
            fn(p, plan, None)
    # b read from the other pool: no tile is both read and written
    src = torch.from_numpy(pool_u)
    if side == "b":
        FU.gemm_scatter_fused(p, plan, None, src_pool=src)
    else:
        with pytest.raises(ValueError, match="race"):
            FU.gemm_scatter_fused(p, plan, None, src_pool=src)


def test_blockspec_refuses_group_above_one(data):
    *_, ga, gb, gd, _ = data
    for group in (2, 4):
        with pytest.raises(ValueError, match="group=1"):
            FU.blockspec_plan(build_pipeline_schedule(ga, gb, gd,
                                                      group=group), "cpu")
    ext = np.arange(NSRC)
    with pytest.raises(ValueError, match="ext_tiles"):
        FU.blockspec_plan(build_pipeline_schedule(ga, gb, gd,
                                                  ext_tiles=ext), "cpu")


def test_fused_plan_refuses_bad_flags(data):
    *_, ga, gb, gd, _ = data
    sga, sgb, sgd, first, last = FU.sort_triples(ga, gb, gd)
    bad = first.copy()
    bad[np.flatnonzero(first)[1]] = 0
    with pytest.raises(ValueError, match="first/last"):
        FU.fused_plan(sga, sgb, sgd, bad, last)
    # flags that mark the runs of an unsorted list: dst 30 in two runs
    z = np.zeros(4, np.int32)
    with pytest.raises(ValueError, match="one run"):
        FU.fused_plan(z, z, np.asarray([30, 30, 31, 30], np.int32),
                      np.asarray([1, 0, 1, 1]), np.asarray([0, 1, 1, 1]))
    assert FU.fused_plan(ga[:0], gb[:0], gd[:0], first[:0], last[:0]) == []
