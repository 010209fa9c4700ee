"""The host tables of the port's mesh paths (``pastix_tpu_torch/
parallel``), in this process: the copies of the reference's
(``pastix_tpu/parallel``) fed the reference's own layouts must give its
tables exactly; the ranks' views drop only the padding; K3's operand
plans apply the pairs they are given; and ``convert`` carries the
reference's sharded factors across."""

import numpy as np
import pytest
import torch

import pastix_tpu
from pastix_tpu.parallel import owner as ROwner
from pastix_tpu.parallel import sharded as RSharded
from pastix_tpu.parallel import subtree as RSubtree
from pastix_tpu_torch.config import Factorization
from pastix_tpu_torch.convert import (
    pool_sharding_from_jax, sharded_factors_from_jax,
)
from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d
from pastix_tpu_torch.numeric.pipelined import (
    gemm_scatter_pipelined, operand_plan,
)
from pastix_tpu_torch.parallel import owner as O
from pastix_tpu_torch.parallel import sharded as SH
from pastix_tpu_torch.parallel import subtree as ST
from pastix_tpu_torch.parallel.mesh import Axis
from pastix_tpu_torch.solve import run_host
from torch_common import no_calibration  # noqa: F401

torch.set_num_threads(1)


def _ref_analysis(A, **kw):
    s = pastix_tpu.Pastix(A.to_scipy(), pastix_tpu.PastixConfig(
        tile_size=8, **kw))
    s.analyze()
    return s


@pytest.fixture(scope="module")
def llt():
    """The reference's LLᵗ analysis of poisson_3d(10) at T=8, with its
    dense tail."""
    s = _ref_analysis(poisson_3d(10))
    assert s._dense_tail is not None
    return s


@pytest.fixture(scope="module")
def lu():
    return _ref_analysis(convection_diffusion_3d(8),
                         factorization=pastix_tpu.Factorization.LU)


def _same(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif a is None or np.isscalar(a):
        assert a == b, what
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b), what


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def test_owner_tables_match_reference(llt, lu):
    """``build_pool_sharding``, ``_owner_level_tables`` (LU's U side
    too), the tail tables of ``_owner_tail`` (read from the reference's
    closure) and ``distribution_report``, exactly, on 2, 4 and 8
    devices."""
    for ndev, (s, tail) in ((n, c) for n in (2, 4, 8)
                            for c in ((llt, llt._dense_tail), (lu, None))):
        lay = s.layout
        ref = ROwner.build_pool_sharding(lay, ndev, dense_tail=tail)
        got = O.build_pool_sharding(lay, ndev, dense_tail=tail)
        _same(vars(got), vars(ref), "PoolSharding")
        _same(vars(pool_sharding_from_jax(ref)), vars(got), "converted")
        levels = tail.levels_lo if tail is not None else lay.levels
        for i, lv in enumerate(levels):
            for for_lu in (False, True):
                _same(O._owner_level_tables(lv, lay, got, for_lu),
                      ROwner._owner_level_tables(lv, lay, ref, for_lu),
                      f"level {i} lu={for_lu}")
        _same(O.distribution_report(lay, got, tail),
              ROwner.distribution_report(lay, ref, tail), "report")
        if tail is not None:
            cells = _closure(ROwner._owner_tail(lay, tail, ref, "tp")[0])
            tt = O._owner_tail_tables(lay, tail, got)
            _same(tt["lo"], cells["lo_np"], "lo")
            _same(tt["hi"], cells["hi_np"], "hi")
            assert tt["L"] == cells["L"]
            for k in ("row_map", "tloc", "tqi", "tqj"):
                _same(tt[k], cells[k], k)


def test_shard_and_subtree_tables_match_reference(llt, lu):
    """``_shard_tables`` (with LU's U side), ``shard_coo``,
    ``proportional_mapping``, ``subtree_report``, ``_local_tables`` and
    ``_shared_split``, exactly, on 2, 4 and 8 devices."""
    import scipy.sparse as sp

    for ndev in (2, 4, 8):
        for s in (llt, lu):
            lay = s.layout
            _same(SH._shard_tables(lay, ndev),
                  RSharded._shard_tables(lay, ndev), "shard")
            _same(SH._shard_tables_with_nd(lay, ndev),
                  RSharded._shard_tables_with_nd(lay, ndev), "shard nd")
        coo = sp.coo_matrix(llt._A_perm)

        class _Mesh:  # the reference reads mesh.shape[tp_axis] only
            shape = {"tp": ndev}

        _same(SH.shard_coo(coo, ndev),
              RSharded.shard_coo(coo, _Mesh(), "tp"), "shard_coo")
        lay = llt.layout
        own = ST.proportional_mapping(lay, ndev)
        _same(own, RSubtree.proportional_mapping(lay, ndev), "mapping")
        _same(ST.subtree_report(lay, ndev),
              RSubtree.subtree_report(lay, ndev), "subtree report")
        _same(ST._local_tables(lay, own, ndev),
              RSubtree._local_tables(lay, own, ndev), "local tables")
        lv_got, tabs_got = ST._shared_split(lay, own, ndev)
        lv_ref, tabs_ref = RSubtree._shared_split(lay, own, ndev)
        _same([vars(v) for v in lv_got], [vars(v) for v in lv_ref],
              "shared levels")
        _same(tabs_got, tabs_ref, "shared tables")


def test_rank_views_drop_only_padding(llt):
    """Each rank's level view (``owner._rank_level``) keeps exactly its
    real entries: over the ranks, the diagonal tiles, panels and pairs of
    a level each once, the halo rows and touched rows each with their
    owner; the replicated path's dealt pairs likewise."""
    lay, tail = llt.layout, llt._dense_tail
    ndev = 4
    sh = O.build_pool_sharding(lay, ndev, dense_tail=tail)
    for lv in tail.levels_lo:
        t = O._owner_level_tables(lv, lay, sh)
        views = [O._rank_level(t, lv, me, sh, "cpu", fp32=False)
                 for me in range(ndev)]
        diag = np.concatenate([sh.mine(me)[v.diag.numpy()]
                               for me, v in enumerate(views)])
        assert sorted(diag) == sorted(lv.diag)
        tp = np.concatenate([sh.mine(me)[v.tp.numpy()]
                             for me, v in enumerate(views)])
        assert sorted(tp) == sorted(lv.trsm_panel)
        if not t["nx"]:
            continue
        pairs = np.concatenate([np.stack([p.numpy() for p in v.e2[:3]])
                                for v in views], axis=1)
        assert pairs.shape[1] == lv.gemm_a.size
        xg = np.unique(np.concatenate([lv.gemm_a, lv.gemm_b]))
        touched = np.unique(lv.gemm_d)
        got = sorted(zip(xg[pairs[0]], xg[pairs[1]], touched[pairs[2]]))
        assert got == sorted(zip(lv.gemm_a, lv.gemm_b, lv.gemm_d))
        for me, v in enumerate(views):
            assert (sh.owner[xg[t["xpos"][me][: v.xloc.numel()]]] == me).all()
            assert (sh.owner[touched[v.tpos.numpy()]] == me).all()
    for t, lv in zip(SH._shard_tables(lay, ndev), lay.levels):
        got = []
        for me in range(ndev):
            ga, gb, gp, _ = O.rank_pairs(t["ga"][me], t["gb"][me],
                                          t["gp"][me], t["ntouch"], None,
                                          "cpu", fp32=False)
            got += zip(ga.tolist(), gb.tolist(),
                       t["touched"][gp.numpy()].tolist())
        assert sorted(got) == sorted(zip(lv.gemm_a.tolist(),
                                         lv.gemm_b.tolist(),
                                         lv.gemm_d.tolist()))


def test_operand_plan_applies_its_pairs():
    """K3's operand plans (``pipelined.operand_plan``: operands from
    arrays apart from the destination, chunks cut mid-segment) through
    the plain twin: acc[gd] -= (X[ga] diag(d[gk])) X[gb]ᵗ, bf16-rounded,
    plain and scaled."""
    for scaled in (False, True):
        _operand_plan_case(scaled)


def _operand_plan_case(scaled):
    rng = np.random.default_rng(3)
    T, nx, nt, ng = 8, 20, 7, 50
    X = torch.as_tensor(rng.standard_normal((nx, T, T)), dtype=torch.float32)
    d = torch.as_tensor(rng.standard_normal((5, T)), dtype=torch.float32)
    ga, gb = rng.integers(0, nx, ng), rng.integers(0, nx, ng)
    gd, gk = rng.integers(0, nt, ng), rng.integers(0, 5, ng)
    plan = operand_plan(ga, gb, gd, gk if scaled else None, "cpu", chunk=16)
    assert sum(c.n_pairs for c in plan) == ng and len(plan) == 4
    acc = torch.zeros((nt + 1, T, T))
    gemm_scatter_pipelined(acc, plan, torch.bfloat16,
                           d=d if scaled else None, xab=(X, X))
    want = torch.zeros_like(acc, dtype=torch.float64)
    r = lambda x: x.to(torch.bfloat16).to(torch.float64)
    for a, b, t, k in zip(ga, gb, gd, gk):
        xa = X[a].double() * (d[k].double() if scaled else 1.0)
        want[t] -= r(xa.float()) @ r(X[b]).T
    assert torch.allclose(acc.double(), want, rtol=0, atol=1e-5)
    assert not acc[nt].any()


def test_convert_sharded_factors():
    """The reference's owner-computes factors on its 4-device mesh: the
    port's ``PoolSharding`` of its sharding, each rank's (nloc, T, T)
    tiles, and the global pools, whose one-device solve (K2's twin) gives
    the reference's mesh solution (LLᵗ and LU)."""
    for A, kind in ((poisson_3d(8), Factorization.LLT),
                    (convection_diffusion_3d(6), Factorization.LU)):
        S = A.to_scipy()
        s = pastix_tpu.Pastix(S, pastix_tpu.PastixConfig(
            tile_size=8, mesh_shape=(4,),
            factorization=pastix_tpu.Factorization[kind.name]))
        b = S @ np.ones(A.n)
        x_ref = s.solve(b, refine=False)
        sh = s._pool_sharding
        assert sh is not None
        for rank in range(4):
            f = sharded_factors_from_jax(s.factors, sh, rank, "cpu")
            np.testing.assert_array_equal(f.pool.numpy(),
                                          np.asarray(s.factors.pool)[rank])
            assert f.pool.shape[0] == sh.nloc
        f = sharded_factors_from_jax(s.factors, sh, None, "cpu")
        from pastix_tpu_torch.solve import build_solve_fn_sweep

        fn = build_solve_fn_sweep(f.layout, torch.device("cpu"), kind)
        x_ext = run_host(f, s._perm_rhs(b), fn)
        x = s._unperm_sol(x_ext)
        assert np.abs(x - x_ref).max() < 1e-4 * np.abs(x_ref).max()
        assert np.linalg.norm(S @ x - b) / np.linalg.norm(b) < 1e-5
    assert Axis().size == 1 and Axis().all_gather(torch.ones(2)).shape == (
        1, 2)
