"""K6's host schedule and plain twin against the reference's B8.

The copied ``build_slab_plan`` is fed the port's level tables of
poisson_3d(7) at T=16 and laplacian_2d(10) at T=8 (the reference's small
problems) and poisson_3d(12) at T=32 (the smallest tile size with row
bounds: a height quantum of T/4), and its tables are compared for exact
equality with ``pastix_tpu/numeric/slab_kernels.py``'s: the per-level
automatic slab sizes and the reference's test configurations (C, H, G,
min_panel) = (4, 8, 2, 2) and (8, 16, 3, 4), at the default cost gate
and forced gates 0 (off) and 100 (``PASTIX_SLAB_GATE``).  The pairs the
decoded plan covers plus its fallback are the level's pairs, as
multisets, and every pair's row bound holds its a tile's row support.
The twin (slab pairs, then K3's twin on the fallback, as the
factorization runs them) is held against the reference's XLA
``gemm_scatter`` on the widest, a middle and the last level, plain and
scaled, bf16 and fp32 updates, with row bounds, on random pools (numpy
seed 0) zeroed outside the bounds (a factor is structurally zero there):
rtol = atol = 1e-3, as tests/test_slab.py holds the reference's kernel.
The reference's kernel itself is not run: its interpret mode costs
minutes.  K6's own tables (each pair's row window, K1's pieces) are held
to the decoded plan, and the update summed piece by piece, as the kernel
sums it, to the twin (1e-5 of max|ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pastix_tpu.numeric.slab_kernels as JSB
from pastix_tpu.numeric import kernels as JK

from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.generators import laplacian_2d, poisson_3d
from pastix_tpu_torch.numeric import pipelined as PL
from pastix_tpu_torch.numeric import slab as SB
from pastix_tpu_torch.pastix import Pastix

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

PROBLEMS = {"poisson3d_7_T16": (lambda: poisson_3d(7), 16),
            "laplacian2d_10_T8": (lambda: laplacian_2d(10), 8),
            "poisson3d_12_T32": (lambda: poisson_3d(12), 32)}
CONFIGS = {"auto": (0, 0, 4, 6), "c4h8": (4, 8, 2, 2), "c8h16": (8, 16, 3, 4)}
UPD = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp32": (None, None)}


@pytest.fixture(scope="module", params=list(PROBLEMS))
def layout(request):
    make, T = PROBLEMS[request.param]
    s = Pastix(make(), PastixConfig(tile_size=T, dense_tail=False),
               device="cpu")
    s.analyze()
    lay = s.layout
    return lay, np.asarray(lay.lookup(np.arange(lay.nbc), np.arange(lay.nbc)))


def _plan(mod, lay, doc, lv, cfg, **kw):
    C, H, G, min_panel = CONFIGS[cfg]
    return mod.build_slab_plan(
        lv.gemm_a, lv.gemm_b, lv.gemm_d, lv.gemm_k, doc, lay.npool, C=C, H=H,
        G=G, min_panel=min_panel, rbounds=(lay.row_lo, lay.row_hi), T=lay.T,
        **kw)


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


@pytest.mark.parametrize("gate", ["default", "0", "100"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_plan_tables_equal(layout, cfg, gate, monkeypatch):
    if gate != "default":
        monkeypatch.setenv("PASTIX_SLAB_GATE", gate)
    lay, doc = layout
    for lv in lay.levels:
        got, want = (_plan(m, lay, doc, lv, cfg) for m in (SB, JSB))
        _eq(got.chunks, want.chunks)
        _eq(got.fallback, want.fallback)
        assert got.stats == want.stats
        assert (got.C, got.H, got.G) == (want.C, want.H, want.G)


@pytest.mark.parametrize("chunk", [64, 4096])
@pytest.mark.parametrize("gate", ["default", "0"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_covered_pairs_plus_fallback_are_the_level(layout, cfg, gate, chunk,
                                                   monkeypatch):
    """Small chunks (64 pairs) cut dst windows across launches.  The
    reference's test configurations keep slab pairs on every problem."""
    if gate != "default":
        monkeypatch.setenv("PASTIX_SLAB_GATE", gate)
    lay, doc = layout
    n_slab = 0
    for lv in lay.levels:
        sp_ = _plan(SB, lay, doc, lv, cfg, chunk=chunk)
        got = []
        for c in SB.slab_plan(sp_, lay.T, "cpu"):
            a, b, dst, k, r0, ha = (x.numpy().astype(np.int64)
                                    for x in c.pairs())
            got += list(zip(a.tolist(), b.tolist(), dst.tolist(), k.tolist()))
            assert np.unique(c.seg_dst.numpy()).size == c.nseg
            assert (r0 <= lay.row_lo[a]).all()
            assert (r0 + ha > lay.row_hi[a]).all() and (r0 + ha <= lay.T).all()
        assert len(got) == sp_.n_slab_pairs
        n_slab += sp_.n_slab_pairs
        got += list(zip(*(np.asarray(x).tolist() for x in sp_.fallback)))
        want = list(zip(*(np.asarray(x, np.int64).tolist() for x in (
            lv.gemm_a, lv.gemm_b, lv.gemm_d, lv.gemm_k))))
        assert sorted(got) == sorted(want)
    assert n_slab > 0 or cfg == "auto"


def _levels(lay):
    """The widest level, a middle one and the last with pairs."""
    lvs = sorted((lv for lv in lay.levels if lv.gemm_a.size > 4),
                 key=lambda lv: -lv.gemm_a.size)
    return {"widest": lvs[0], "middle": lvs[len(lvs) // 2], "last": lvs[-1]}


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "d"])
@pytest.mark.parametrize("upd", list(UPD))
@pytest.mark.parametrize("which", ["widest", "middle", "last"])
def test_twin_matches_xla(layout, which, upd, scaled, monkeypatch):
    """The level's slab pairs through the twin (configuration (4, 8, 2,
    2), gate off) and its fallback through K3's twin, against the
    reference's gemm_scatter over all its pairs."""
    monkeypatch.setenv("PASTIX_SLAB_GATE", "0")
    lay, doc = layout
    lv = _levels(lay)[which]
    j_upd, t_upd = UPD[upd]
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((lay.npool, lay.T, lay.T)).astype(np.float32)
    rows = np.arange(lay.T)[None, :]
    pool *= ((rows >= lay.row_lo[:, None])
             & (rows <= lay.row_hi[:, None]))[:, :, None]
    d = rng.uniform(0.5, 2.0, (lay.nbc, lay.T)).astype(np.float32)
    sp_ = _plan(SB, lay, doc, lv, "c4h8")
    assert sp_.n_slab_pairs > 0
    want = JK.gemm_scatter(
        jnp.asarray(pool), jnp.asarray(lv.gemm_a), jnp.asarray(lv.gemm_b),
        jnp.asarray(lv.gemm_d), update_dtype=j_upd,
        scale_cols=jnp.asarray(d)[lv.gemm_k] if scaled else None)
    kw = {"d": torch.from_numpy(d)} if scaled else {}
    got = torch.from_numpy(pool.copy())
    SB.gemm_scatter_slab(got, SB.slab_plan(sp_, lay.T, "cpu"), t_upd, **kw)
    fga, fgb, fgd, fgk = sp_.fallback
    if fga.size:
        PL.gemm_scatter_pipelined(got, PL.pipeline_plan(
            PL.build_pipeline_schedule(fga, fgb, fgd, gk=fgk, group=2),
            "cpu"), t_upd, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


def test_row_bounds_bound_rows(layout):
    """At T=32 some pairs run fewer than T rows; at T <= 16 none do (the
    reference's quantum rule)."""
    lay, doc = layout
    ha = torch.cat([c.pair_h for lv in lay.levels if lv.gemm_a.size
                    for c in SB.slab_plan(_plan(SB, lay, doc, lv, "c4h8"),
                                          lay.T, "cpu")])
    assert bool((ha < lay.T).any()) == (lay.T >= 32)


def test_slab_plan_windows_and_pieces(layout, monkeypatch):
    """K6's kernel tables on the widest level (configuration (4, 8, 2, 2),
    gate off, chunks of 64 pairs): each pair's window (rl, h) is the
    decoded (r0, ha) in dst order; the pieces (cut at 8 pairs where no
    card is counted) cover each segment's pairs once, in order, and a
    segment is cut exactly where it is longer than 8 (laplacian_2d(10)
    at T=8 has none, the Poisson levels have some); and the
    update summed as the kernel sums it (each piece's products of
    round(a d) on its window and round(b), a cut segment's pieces added
    in piece order, then subtracted once) equals the twin's (1e-5 of
    max|ref|)."""
    monkeypatch.setenv("PASTIX_SLAB_GATE", "0")
    lay, doc = layout
    T = lay.T
    sp_ = _plan(SB, lay, doc, _levels(lay)["widest"], "c4h8", chunk=64)
    plan = SB.slab_plan(sp_, T, "cpu")
    rng = np.random.default_rng(3)
    P = torch.from_numpy(
        rng.standard_normal((lay.npool, T, T)).astype(np.float32))
    d = torch.from_numpy(
        rng.uniform(0.5, 2.0, (lay.nbc, T)).astype(np.float32))
    rows = torch.arange(T)[:, None]
    got, cuts, longest = P.clone(), 0, 0
    for t, c in zip((t for t in sp_.chunks if SB.decode_slab_chunk(
            t, T)[0].size), plan):
        dec = SB.decode_slab_chunk(t, T)
        order = np.argsort(dec[2], kind="stable")
        a, b, dst, k, rl, h = (x.numpy() for x in c.pairs())
        for want, have in zip(dec, (a, b, dst, k, rl, h)):
            np.testing.assert_array_equal(have, want[order])
        sp, pp, ps, spp, slot = (x.numpy() for x in (
            c.seg_ptr, c.piece_ptr, c.piece_seg, c.seg_piece_ptr,
            c.piece_slot))
        assert pp[0] == 0 and pp[-1] == c.n_pairs
        assert (np.diff(pp) > 0).all() and (np.diff(pp) <= 8).all()
        np.testing.assert_array_equal(pp[spp], sp)
        np.testing.assert_array_equal(
            np.repeat(np.arange(c.nseg), np.diff(spp)), ps)
        cut = np.diff(spp)[ps] > 1
        np.testing.assert_array_equal(slot[cut], np.arange(c.nslot))
        assert (slot[~cut] == -1).all()
        cuts += c.nslot
        longest = max(longest, int(np.diff(sp).max()))
        for g in range(c.nseg):
            total = torch.zeros(T, T)
            for p in range(spp[g], spp[g + 1]):
                part = torch.zeros(T, T)
                for i in range(pp[p], pp[p + 1]):
                    win = (rows >= rl[i]) & (rows < rl[i] + h[i])
                    ai = (P[a[i]] * d[k[i]]).bfloat16().float() * win
                    part += ai @ P[b[i]].bfloat16().float().T
                total += part
            got[c.seg_dst[g]] -= total
    assert (cuts > 0) == (longest > 8)
    ref = SB.gemm_scatter_slab_ref(P.clone(), plan, torch.bfloat16, d=d)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale


def test_cpu_pool_runs_the_twin(layout):
    lay, doc = layout
    lv = _levels(lay)["widest"]
    plan = SB.slab_plan(_plan(SB, lay, doc, lv, "c4h8"), lay.T, "cpu")
    k0 = SB.gemm_scatter_slab.launches
    t0 = SB.gemm_scatter_slab.twin_launches
    SB.gemm_scatter_slab(torch.zeros(lay.npool, lay.T, lay.T), plan)
    assert SB.gemm_scatter_slab.launches == k0
    assert SB.gemm_scatter_slab.twin_launches == t0 + 1
