"""K5's host schedule and plain twin against the reference's B9.

The copied ``build_block_plan`` is fed the port's level tables of
poisson_3d(7) at T=16 and laplacian_2d(10) at T=8 (the reference's small
problems; the port's layouts equal the reference's, tests/
test_torch_host.py) and its tables compared for exact equality with
``pastix_tpu/numeric/block_kernels.py``'s, at the default cost gate and
forced gates 0 and 100.  The pairs the decoded plan covers plus its
fallback are the level's pairs, as multisets.  The twin (block pairs,
then K3's twin on the fallback, as the factorization runs them) is held
against the reference's XLA ``gemm_scatter`` on the widest, a middle and
the last level, plain and scaled, bf16 and fp32 updates, random pools
(numpy seed 0): rtol = atol = 1e-3, as tests/test_block.py holds the
reference's kernel (the reference's fp32 products are three bf16
passes, the twin's fp32).  The reference's kernel itself is not run: its
interpret mode costs minutes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pastix_tpu.numeric.block_kernels as JBK
from pastix_tpu.numeric import kernels as JK

from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.generators import laplacian_2d, poisson_3d
from pastix_tpu_torch.numeric import block as BK
from pastix_tpu_torch.numeric import pipelined as PL
from pastix_tpu_torch.pastix import Pastix

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

PROBLEMS = {"poisson3d_7_T16": (lambda: poisson_3d(7), 16),
            "laplacian2d_10_T8": (lambda: laplacian_2d(10), 8)}
UPD = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp32": (None, None)}


@pytest.fixture(scope="module", params=list(PROBLEMS))
def layout(request):
    make, T = PROBLEMS[request.param]
    s = Pastix(make(), PastixConfig(tile_size=T, dense_tail=False),
               device="cpu")
    s.analyze()
    return s.layout


def _plan(mod, lay, lv, **kw):
    return mod.build_block_plan(lv.gemm_a, lv.gemm_b, lv.gemm_d, lv.gemm_k,
                                lay.blk_row, lay.blk_col, lay.keys, lay.nbc,
                                lay.npool, **kw)


def _eq(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("gate", [None, 0.0, 100.0])
def test_plan_tables_equal(layout, gate):
    n_blk = 0
    for lv in layout.levels:
        got, want = _plan(BK, layout, lv, gate=gate), _plan(JBK, layout, lv,
                                                             gate=gate)
        _eq(got.chunks, want.chunks)
        _eq(got.fallback, want.fallback)
        assert got.stats == want.stats
        assert (got.B_I, got.B_J) == (want.B_I, want.B_J)
        n_blk += got.n_block_pairs
    assert n_blk > 0 if gate == 100.0 else True


@pytest.mark.parametrize("chunk", [16, 2048])
@pytest.mark.parametrize("gate", [None, 0.0, 100.0])
def test_covered_pairs_plus_fallback_are_the_level(layout, gate, chunk):
    """Small chunks (16 entries) cut the plans into many launches."""
    for lv in layout.levels:
        bp = _plan(BK, layout, lv, gate=gate, chunk=chunk)
        got = []
        for c in BK.block_plan(bp, layout.blk_row, "cpu"):
            got += list(zip(*(x.tolist() for x in c.pairs())))
            # one dst segment per dst tile of the chunk
            assert c.seg_dst.unique().numel() == c.seg_dst.numel()
        assert len(got) == bp.n_block_pairs
        got += list(zip(*(np.asarray(x).tolist() for x in bp.fallback)))
        want = list(zip(*(np.asarray(x, np.int64).tolist() for x in (
            lv.gemm_a, lv.gemm_b, lv.gemm_d, lv.gemm_k))))
        assert sorted(got) == sorted(want)


@pytest.mark.parametrize("gate", [None, 100.0])
def test_segments_hold_the_decoded_products(layout, gate):
    """Each chunk's K3 tables (chunks of 16 entries) hold exactly the
    products that ``decode_block_chunk`` reads from the same chunk's
    packed words, each once: a segment per dst tile, its pairs in entry
    order, and pieces that cut each segment in order."""
    for lv in layout.levels:
        bp = _plan(BK, layout, lv, gate=gate, chunk=16)
        plan = BK.block_plan(bp, layout.blk_row, "cpu")
        assert len(plan) == len(bp.chunks)
        for t, c in zip(bp.chunks, plan):
            a, b, dst, k, e, _, _ = BK.decode_block_chunk(t)
            entry = {p: int(x) for p, x in zip(zip(a, b, dst, k), e)}
            assert len(entry) == a.size == c.n_pairs
            got = list(zip(*(x.tolist() for x in c.pairs())))
            assert sorted(got) == sorted(entry)
            seg_ptr = c.seg_ptr.tolist()
            assert seg_ptr[0] == 0 and seg_ptr[-1] == c.n_pairs
            assert c.seg_dst.unique().numel() == c.nseg
            for s in range(c.nseg):
                pairs = got[seg_ptr[s]:seg_ptr[s + 1]]
                assert pairs and {p[2] for p in pairs} == {
                    int(c.seg_dst[s])}
                ents = [entry[p] for p in pairs]
                assert ents == sorted(set(ents))
            # pieces: consecutive runs of each segment's pairs
            pp, ps = c.piece_ptr.tolist(), c.piece_seg.tolist()
            assert pp[0] == 0 and pp[-1] == c.n_pairs
            for p in range(c.npiece):
                assert seg_ptr[ps[p]] <= pp[p] < pp[p + 1] <= seg_ptr[
                    ps[p] + 1]


def _levels(lay):
    """The widest level, a middle one and the last with pairs."""
    lvs = sorted((lv for lv in lay.levels if lv.gemm_a.size > 4),
                 key=lambda lv: -lv.gemm_a.size)
    return {"widest": lvs[0], "middle": lvs[len(lvs) // 2], "last": lvs[-1]}


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "d"])
@pytest.mark.parametrize("upd", list(UPD))
@pytest.mark.parametrize("which", ["widest", "middle", "last"])
def test_twin_matches_xla(layout, which, upd, scaled):
    """The level's block pairs through the twin and its fallback through
    K3's twin, against the reference's gemm_scatter over all its pairs:
    gate 3 (some entries go to the fallback), or 100 where gate 3 keeps
    none of the level's entries."""
    lv = _levels(layout)[which]
    j_upd, t_upd = UPD[upd]
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((layout.npool, layout.T, layout.T)).astype(
        np.float32)
    d = rng.uniform(0.5, 2.0, (layout.nbc, layout.T)).astype(np.float32)
    bp = _plan(BK, layout, lv, gate=3.0)
    if not bp.n_block_pairs:
        bp = _plan(BK, layout, lv, gate=100.0)
    assert bp.n_block_pairs > 0
    want = JK.gemm_scatter(
        jnp.asarray(pool), jnp.asarray(lv.gemm_a), jnp.asarray(lv.gemm_b),
        jnp.asarray(lv.gemm_d), update_dtype=j_upd,
        scale_cols=jnp.asarray(d)[lv.gemm_k] if scaled else None)
    kw = {"d": torch.from_numpy(d)} if scaled else {}
    got = torch.from_numpy(pool.copy())
    BK.gemm_scatter_block(got, BK.block_plan(bp, layout.blk_row, "cpu"),
                          t_upd, **kw)
    fga, fgb, fgd, fgk = bp.fallback
    if fga.size:
        PL.gemm_scatter_pipelined(got, PL.pipeline_plan(
            PL.build_pipeline_schedule(fga, fgb, fgd, gk=fgk, group=2),
            "cpu"), t_upd, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


def test_cpu_pool_runs_the_twin(layout):
    lv = _levels(layout)["widest"]
    plan = BK.block_plan(_plan(BK, layout, lv, gate=100.0), layout.blk_row,
                         "cpu")
    k0 = BK.gemm_scatter_block.launches
    t0 = BK.gemm_scatter_block.twin_launches
    BK.gemm_scatter_block(
        torch.zeros(layout.npool, layout.T, layout.T), plan)
    assert BK.gemm_scatter_block.launches == k0
    assert BK.gemm_scatter_block.twin_launches == t0 + 1
