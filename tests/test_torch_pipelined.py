"""K3's host schedule and plain twin against the reference's B3.

``build_pipeline_schedule`` tables are compared for exact equality with
``pastix_tpu/numeric/pallas_kernels.py``'s for chunk in {7, 4096} and group
in {1, 2}.  The twin ``gemm_scatter_pipelined_ref`` runs on the CPU
against the reference's ``gemm_scatter_pipelined`` in interpret mode (as
``tests/test_pallas.py`` runs it) and against the reference's XLA
``gemm_scatter``: T=16, 33 random pairs (numpy seed 0), bf16 and None
updates, rtol = atol = 1e-3 (the reference's fp32 products are three
bf16 passes, the twin's fp32).  The scaled (``d``, LDLᵗ) and cross-pool
(``src_pool``, LU) variants the same way, against the interpret-mode
kernel with the same variant and the XLA ``gemm_scatter(scale_cols=)`` /
``gemm_scatter_ab``; the operand arrays (``xab``, ``compact``,
``ab_pack``) against the interpret-mode kernel reading the same arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pastix_tpu.numeric.pallas_kernels as JPK
from pastix_tpu.numeric import kernels as JK

from pastix_tpu_torch.numeric import pipelined as PL

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

NPOOL, T, NG, NSRC = 40, 16, 33, 20
UPD = {"bf16": (jnp.bfloat16, torch.bfloat16), "none": (None, None)}


@pytest.fixture(autouse=True)
def _interpret():
    old = JPK._INTERPRET
    JPK._INTERPRET = True
    yield
    JPK._INTERPRET = old


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((NPOOL, T, T)).astype(np.float32)
    ga = rng.integers(0, NSRC, NG).astype(np.int32)
    gb = rng.integers(0, NSRC, NG).astype(np.int32)
    gd = rng.integers(NSRC, NPOOL, NG).astype(np.int32)
    return pool, ga, gb, gd


@pytest.fixture(scope="module")
def variant_data(data):
    """The second pool of LU, the pivots d (nbc, T) and each pair's
    source column gk."""
    rng = np.random.default_rng(1)
    pool_u = rng.standard_normal((NPOOL, T, T)).astype(np.float32)
    d = (rng.uniform(0.5, 2.0, (8, T)) * rng.choice([-1, 1], (8, T))).astype(
        np.float32)
    gk = rng.integers(0, 8, NG).astype(np.int32)
    return pool_u, d, gk


def _variant_args(variant, pool_u, d, lib):
    if variant == "d":
        return {"d": lib(d)}
    return {"src_pool": lib(pool_u)}


# one interpret-mode call costs seconds: the scaled variant (its gk
# tables are the part the XLA form lacks) once; the XLA comparison below
# covers both variants at both update dtypes
@pytest.mark.parametrize("variant,upd", [("d", "bf16")])
def test_variant_twin_matches_pallas_interpret(data, variant_data, variant,
                                               upd):
    pool, ga, gb, gd = data
    pool_u, d, gk = variant_data
    j_upd, t_upd = UPD[upd]
    gk_ = gk if variant == "d" else None
    sched = JPK.build_pipeline_schedule(ga, gb, gd, gk=gk_, chunk=32, group=2)
    want = np.asarray(JPK.gemm_scatter_pipelined(
        jnp.asarray(pool), sched, update_dtype=j_upd,
        **_variant_args(variant, pool_u, d, jnp.asarray)))
    plan = PL.pipeline_plan(PL.build_pipeline_schedule(
        ga, gb, gd, gk=gk_, chunk=32, group=2), "cpu")
    got = PL.gemm_scatter_pipelined(
        torch.from_numpy(pool.copy()), plan, t_upd,
        **_variant_args(variant, pool_u, d, torch.from_numpy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("upd", list(UPD))
@pytest.mark.parametrize("variant", ["d", "src_pool"])
def test_variant_twin_matches_xla(data, variant_data, variant, upd):
    pool, ga, gb, gd = data
    pool_u, d, gk = variant_data
    j_upd, t_upd = UPD[upd]
    if variant == "d":
        want = JK.gemm_scatter(jnp.asarray(pool), ga, gb, gd,
                               scale_cols=jnp.asarray(d)[gk],
                               update_dtype=j_upd)
    else:
        want = JK.gemm_scatter_ab(jnp.asarray(pool), jnp.asarray(pool),
                                  jnp.asarray(pool_u), ga, gb, gd,
                                  update_dtype=j_upd)
    plan = PL.pipeline_plan(PL.build_pipeline_schedule(
        ga, gb, gd, gk=gk if variant == "d" else None, group=2), "cpu")
    got = PL.gemm_scatter_pipelined(
        torch.from_numpy(pool.copy()), plan, t_upd,
        **_variant_args(variant, pool_u, d, torch.from_numpy)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-3)


def _twin(pool, sched, upd):
    plan = PL.pipeline_plan(sched, "cpu")
    return PL.gemm_scatter_pipelined(torch.from_numpy(pool.copy()), plan,
                                     upd).numpy()


@pytest.mark.parametrize("chunk", [7, 4096])
@pytest.mark.parametrize("group", [1, 2])
def test_schedule_tables_equal(data, chunk, group):
    _, ga, gb, gd = data
    got = PL.build_pipeline_schedule(ga, gb, gd, chunk=chunk, group=group)
    want = JPK.build_pipeline_schedule(ga, gb, gd, chunk=chunk, group=group)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


def test_schedule_rejects_overlapping_src_dst():
    with pytest.raises(AssertionError):
        PL.build_pipeline_schedule(np.array([0, 1]), np.array([2, 3]),
                                   np.array([1, 4]))


@pytest.mark.parametrize("chunk", [7, 4096])
def test_plan_keeps_every_valid_pair(data, chunk):
    """Pads dropped, one segment per dst within a chunk, and with chunk=7
    a dst segment cut across two chunks."""
    _, ga, gb, gd = data
    plan = PL.pipeline_plan(
        PL.build_pipeline_schedule(ga, gb, gd, chunk=chunk, group=2), "cpu")
    assert sum(c.n_pairs for c in plan) == NG
    for c in plan:
        assert c.seg_dst.unique().numel() == c.nseg
    pairs = sorted(zip(
        torch.cat([c.pair_a for c in plan]).tolist(),
        torch.cat([c.pair_b for c in plan]).tolist(),
        torch.cat([torch.repeat_interleave(c.seg_dst, c.seg_ptr.diff())
                   for c in plan]).tolist(),
    ))
    assert pairs == sorted(zip(ga.tolist(), gb.tolist(), gd.tolist()))
    split = sum(int(a.seg_dst[-1]) == int(b.seg_dst[0])
                for a, b in zip(plan, plan[1:]))
    assert split > 0 if chunk == 7 else len(plan) == 1


@pytest.mark.parametrize("upd", list(UPD))
def test_twin_matches_pallas_interpret(data, upd):
    pool, ga, gb, gd = data
    j_upd, t_upd = UPD[upd]
    # two chunks, a dst segment split between them (one interpret-mode
    # pallas_call per chunk costs seconds on a CPU)
    sched = JPK.build_pipeline_schedule(ga, gb, gd, chunk=32, group=2)
    want = np.asarray(JPK.gemm_scatter_pipelined(
        jnp.asarray(pool), sched, update_dtype=j_upd))
    plan = PL.pipeline_plan(
        PL.build_pipeline_schedule(ga, gb, gd, chunk=32, group=2), "cpu")
    assert int(plan[0].seg_dst[-1]) == int(plan[1].seg_dst[0])
    got = PL.gemm_scatter_pipelined(torch.from_numpy(pool.copy()), plan,
                                    t_upd).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("upd", list(UPD))
def test_twin_matches_xla_gemm_scatter(data, upd):
    pool, ga, gb, gd = data
    j_upd, t_upd = UPD[upd]
    want = np.asarray(JK.gemm_scatter(
        jnp.asarray(pool), jnp.asarray(ga), jnp.asarray(gb), jnp.asarray(gd),
        update_dtype=j_upd))
    got = _twin(pool, PL.build_pipeline_schedule(ga, gb, gd, group=2), t_upd)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_cpu_pool_runs_the_twin(data):
    pool, ga, gb, gd = data
    plan = PL.pipeline_plan(PL.build_pipeline_schedule(ga, gb, gd), "cpu")
    k0 = PL.gemm_scatter_pipelined.launches
    t0 = PL.gemm_scatter_pipelined.twin_launches
    PL.gemm_scatter_pipelined(torch.from_numpy(pool.copy()), plan)
    assert PL.gemm_scatter_pipelined.launches == k0
    assert PL.gemm_scatter_pipelined.twin_launches == t0 + 1


@pytest.mark.parametrize("variant", ["d", "src_pool", "xab", "compact",
                                     "ab_pack"])
def test_unported_variants_raise(data, variant_data, variant):
    """d and src_pool refuse a malformed operand (and ``d`` a plan built
    without gk).  The TPU operand streams, once refused, are ported:
    ``xab`` (a bf16 panel stream of the source tiles, with the scaled
    variant: round(round(a) d)), ``compact`` and ``ab_pack`` each match
    the reference's interpret-mode kernel with the same stream, bf16
    updates, one chunk, rtol = atol = 1e-3."""
    pool, ga, gb, gd = data
    if variant in ("d", "src_pool"):
        pool = torch.from_numpy(pool.copy())
        bad = {"d": torch.ones(3, T + 1), "src_pool": torch.ones(2, T, T)}
        with pytest.raises(ValueError, match=variant):
            PL.gemm_scatter_pipelined(pool, [], None, **{variant: bad[variant]})
        if variant == "d":
            plan = PL.pipeline_plan(PL.build_pipeline_schedule(ga, gb, gd),
                                    "cpu")
            with pytest.raises(ValueError, match="gk"):
                PL.gemm_scatter_pipelined(pool, plan, None,
                                          d=torch.ones(8, T))
        return
    _, d, gk = variant_data
    ext = np.arange(NSRC) if variant == "xab" else None
    gk_ = gk if variant == "xab" else None
    j_kw, t_kw = {}, {}
    if variant == "xab":
        X = pool[:NSRC]
        j_kw = {"xab": jnp.asarray(X).astype(jnp.bfloat16),
                "d": jnp.asarray(d)}
        t_kw = {"xab": torch.from_numpy(X.copy()).to(torch.bfloat16),
                "d": torch.from_numpy(d)}
    else:
        j_kw = t_kw = {variant: True}
    want = np.asarray(JPK.gemm_scatter_pipelined(
        jnp.asarray(pool),
        JPK.build_pipeline_schedule(ga, gb, gd, gk=gk_, group=2,
                                    ext_tiles=ext),
        update_dtype=jnp.bfloat16, **j_kw))
    plan = PL.pipeline_plan(PL.build_pipeline_schedule(
        ga, gb, gd, gk=gk_, group=2, ext_tiles=ext), "cpu")
    got = PL.gemm_scatter_pipelined(torch.from_numpy(pool.copy()), plan,
                                    torch.bfloat16, **t_kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
