"""K1's plain twin ``gemm_scatter_ll_ref`` against the reference: the
Pallas ``gemm_scatter_ll`` in interpret mode on one chunk of the busiest
level, and the XLA ``K.gemm_scatter`` on the whole list (as is the port's
plain ``kernels.gemm_scatter``).  The same pool,
made with numpy from a seed, goes through both.

Tolerances: fp32 updates rtol=2e-5, atol=1e-5 (those of
tests/test_leftlook.py: only the summation order differs); bf16 updates
atol=1e-2 * max|ref|, because bf16 rounds at different places in the two
frameworks.  On the CPU the wrapper ``gemm_scatter_ll`` takes the twin.

The scaled (``d``, LDLᵗ: a's columns times the pivots of the pair's
source column) and cross-pool (``src_pool``, LU: b from a second pool)
variants run the same way, against the interpret-mode kernel (scaled,
one ``bcache`` chunk) and against the XLA
``gemm_scatter(scale_cols=)`` / ``gemm_scatter_ab`` on the whole list, in
both cache modes.  Forced ``"full"`` plans are held to
``gemm_scatter_ab``, never to the reference's LL kernel: that kernel
reads a from a cache it fills from ``src_pool``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pastix_tpu.numeric.leftlook as JLL
from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.generators import poisson_3d
from pastix_tpu.numeric import kernels as JK

import pastix_tpu_torch.numeric.leftlook as LL
from pastix_tpu_torch.numeric import kernels as K
from pastix_tpu_torch.pastix import Pastix

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(JLL, "_INTERPRET", True)


@pytest.fixture(scope="module")
def case():
    s = Pastix(poisson_3d(12), PastixConfig(tile_size=32), device="cpu")
    s.order()
    s.symbfact()
    s.analyze()
    lay = s.layout
    _, incoming, _ = LL.regroup_left(lay.levels, lay.blk_col, None)
    li = int(np.argmax([i[0].size for i in incoming]))
    ga, gb, gd = incoming[li][:3]
    rng = np.random.default_rng(0)
    pool = rng.standard_normal(lay.pool_shape).astype(np.float32)
    # zero every tile outside its scalar row support, as in a factor: the
    # row-bounded classes then compute the full-tile product exactly
    rows = np.arange(lay.T)
    outside = (rows[None, :] < lay.row_lo[:, None]) | (
        rows[None, :] > lay.row_hi[:, None]
    )
    pool[outside] = 0.0
    return lay, (ga, gb, gd), pool


def _close(got, ref, dt):
    if dt == "fp32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-2 * np.abs(ref).max())


# interpret mode costs about 2 s a call: fp32 on a full-height chunk, bf16
# on a row-bounded one; the XLA comparison below covers all four
@pytest.mark.parametrize("dt,rowb", [("fp32", False), ("bf16", True)],
                         ids=["fp32-full_height", "bf16-rowb"])
def test_twin_matches_pallas_chunk(case, dt, rowb):
    lay, (ga, gb, gd), pool = case
    rb = (lay.row_lo, lay.row_hi) if rowb else None
    sched = LL.build_ll_schedule(ga, gb, gd, group=4, cap=12, rb=rb,
                                 T=lay.T, mode="bcache")
    # one chunk: the first row-bounded one for rowb
    chunk = next(c for c in sched if (c["H"] < lay.T) == rowb)
    jdt, tdt = DTYPES[dt]
    ref = np.asarray(JLL.gemm_scatter_ll(
        jnp.asarray(pool), [chunk], update_dtype=jdt, interpret=True
    ))
    got = LL.gemm_scatter_ll(
        torch.from_numpy(pool.copy()), LL.ll_plan([chunk], "cpu"), tdt
    ).numpy()
    assert np.abs(got - pool).max() > 0
    _close(got, ref, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["bcache", "full"])
@pytest.mark.parametrize("rowb", [False, True], ids=["full_height", "rowb"])
def test_twin_matches_xla_whole_list(case, dt, mode, rowb):
    lay, (ga, gb, gd), pool = case
    rb = (lay.row_lo, lay.row_hi) if rowb else None
    sched = LL.build_ll_schedule(ga, gb, gd, group=4, cap=64, mode=mode,
                                 rb=rb, T=lay.T)
    plan = LL.ll_plan(sched, "cpu")
    assert sum(c.n_pairs for c in plan) == ga.size
    if rowb:
        assert any(c.H < lay.T for c in plan)
    jdt, tdt = DTYPES[dt]
    ref = np.asarray(JK.gemm_scatter(
        jnp.asarray(pool), ga, gb, gd, update_dtype=jdt
    ))
    before = LL.gemm_scatter_ll.twin_launches
    got = LL.gemm_scatter_ll(torch.from_numpy(pool.copy()), plan, tdt).numpy()
    assert LL.gemm_scatter_ll.twin_launches == before + 1
    _close(got, ref, dt)
    # the port's unscheduled plain update (kernels.gemm_scatter) too
    idx = [torch.from_numpy(np.asarray(g, np.int64)) for g in (ga, gb, gd)]
    plain = K.gemm_scatter(torch.from_numpy(pool.copy()), *idx, tdt).numpy()
    _close(plain, ref, dt)


def test_update_dtype_none_is_fp32(case):
    lay, (ga, gb, gd), pool = case
    plan = LL.ll_plan(LL.build_ll_schedule(ga, gb, gd, T=lay.T), "cpu")
    a = LL.gemm_scatter_ll(torch.from_numpy(pool.copy()), plan, None)
    b = LL.gemm_scatter_ll(torch.from_numpy(pool.copy()), plan, torch.float32)
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def variants(case):
    """A second pool (the Uᵗ pool of LU), pivots d (nbc, T) and each
    pair's source column gk (the level's incoming gemm_k)."""
    lay, (ga, gb, gd), pool = case
    _, incoming, _ = LL.regroup_left(lay.levels, lay.blk_col, None)
    li = int(np.argmax([i[0].size for i in incoming]))
    gk = incoming[li][3]
    rng = np.random.default_rng(1)
    pool_u = rng.standard_normal(lay.pool_shape).astype(np.float32)
    d = (rng.uniform(0.5, 2.0, (lay.nbc, lay.T))
         * rng.choice([-1, 1], (lay.nbc, lay.T))).astype(np.float32)
    return pool_u, d, gk


def _variant_kw(variant, pool_u, d, lib):
    return {"d": lib(d)} if variant == "d" else {"src_pool": lib(pool_u)}


# interpret mode costs seconds a call: the scaled variant (its gk tables
# are the part the XLA form lacks) once; the XLA comparison below covers
# both variants in both modes and dtypes
@pytest.mark.parametrize("variant,dt,rowb", [("d", "bf16", True)])
def test_variant_twin_matches_pallas_chunk(case, variants, variant, dt, rowb):
    lay, (ga, gb, gd), pool = case
    pool_u, d, gk = variants
    rb = (lay.row_lo, lay.row_hi) if rowb else None
    sched = LL.build_ll_schedule(ga, gb, gd, gk=gk, group=4, cap=12, rb=rb,
                                 T=lay.T, mode="bcache")
    chunk = next(c for c in sched if (c["H"] < lay.T) == rowb)
    jdt, tdt = DTYPES[dt]
    ref = np.asarray(JLL.gemm_scatter_ll(
        jnp.asarray(pool), [chunk], update_dtype=jdt, interpret=True,
        **_variant_kw(variant, pool_u, d, jnp.asarray)))
    got = LL.gemm_scatter_ll(
        torch.from_numpy(pool.copy()), LL.ll_plan([chunk], "cpu"), tdt,
        **_variant_kw(variant, pool_u, d, torch.from_numpy)).numpy()
    _close(got, ref, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["bcache", "full"])
@pytest.mark.parametrize("variant", ["d", "src_pool"])
def test_variant_twin_matches_xla_whole_list(case, variants, variant, mode,
                                             dt):
    lay, (ga, gb, gd), pool = case
    pool_u, d, gk = variants
    sched = LL.build_ll_schedule(ga, gb, gd, gk=gk, group=4, cap=64,
                                 mode=mode, rb=(lay.row_lo, lay.row_hi),
                                 T=lay.T)
    plan = LL.ll_plan(sched, "cpu")
    assert all(c.mode == mode and c.pair_k is not None for c in plan)
    jdt, tdt = DTYPES[dt]
    if variant == "d":
        ref = JK.gemm_scatter(jnp.asarray(pool), ga, gb, gd,
                              scale_cols=jnp.asarray(d)[gk],
                              update_dtype=jdt)
    else:
        ref = JK.gemm_scatter_ab(jnp.asarray(pool), jnp.asarray(pool),
                                 jnp.asarray(pool_u), ga, gb, gd,
                                 update_dtype=jdt)
    got = LL.gemm_scatter_ll(
        torch.from_numpy(pool.copy()), plan, tdt,
        **_variant_kw(variant, pool_u, d, torch.from_numpy)).numpy()
    _close(got, np.asarray(ref), dt)
    # the port's unscheduled plain updates too
    idx = [torch.from_numpy(np.asarray(g, np.int64)) for g in (ga, gb, gd)]
    if variant == "d":
        scale = torch.from_numpy(d)[torch.from_numpy(gk.astype(np.int64))]
        plain = K.gemm_scatter(torch.from_numpy(pool.copy()), *idx, tdt,
                               scale_cols=scale)
    else:
        p = torch.from_numpy(pool.copy())
        plain = K.gemm_scatter_ab(p, p.clone(), torch.from_numpy(pool_u),
                                  *idx, tdt)
    _close(plain.numpy(), np.asarray(ref), dt)


def test_scaled_variant_needs_gk(case, variants):
    lay, (ga, gb, gd), pool = case
    _, d, _ = variants
    plan = LL.ll_plan(LL.build_ll_schedule(ga, gb, gd, T=lay.T), "cpu")
    with pytest.raises(ValueError, match="gk"):
        LL.gemm_scatter_ll(torch.from_numpy(pool.copy()), plan, None,
                           d=torch.from_numpy(d))


def _check_pieces(c):
    """A chunk's pieces tile its segments in order, none longer than the
    chunk's piece length, with a partial-sum slot for each piece of a cut
    segment and -1 for the others."""
    seg_ptr, pp = c.seg_ptr.numpy(), c.piece_ptr.numpy()
    ps, spp, slot = (c.piece_seg.numpy(), c.seg_piece_ptr.numpy(),
                     c.piece_slot.numpy())
    L = LL.piece_len(c.n_pairs, LL.piece_ctas(c.seg_ptr.device))
    assert pp[0] == 0 and pp[-1] == c.n_pairs
    assert np.all(np.diff(pp) >= 1) and np.all(np.diff(pp) <= L)
    assert np.array_equal(np.repeat(np.arange(c.nseg), np.diff(spp)), ps)
    assert np.array_equal(pp[spp], seg_ptr)
    cut = np.diff(spp)[ps] > 1
    assert np.array_equal(slot[cut], np.arange(c.nslot))
    assert np.all(slot[~cut] == -1)
    # no piece shorter than L but a segment's last
    last = np.r_[ps[1:] != ps[:-1], True]
    assert np.all(np.diff(pp)[~last] == L)


@pytest.mark.parametrize("mode", ["bcache", "full"])
@pytest.mark.parametrize("rowb", [False, True], ids=["full_height", "rowb"])
def test_ll_plan_pieces_tile_segments(case, mode, rowb):
    lay, (ga, gb, gd), _ = case
    rb = (lay.row_lo, lay.row_hi) if rowb else None
    plan = LL.ll_plan(LL.build_ll_schedule(ga, gb, gd, group=4, cap=64,
                                           mode=mode, rb=rb, T=lay.T), "cpu")
    for c in plan:
        _check_pieces(c)


@pytest.mark.parametrize("n_long", [298, 5000])
def test_ll_pieces_cut_a_long_segment(n_long):
    """Segments of 2 and 3 pairs around one of ``n_long``: only the long
    one is cut, into pieces of max(8, ceil(n / 264)) pairs (two CTAs on
    each of an H100's 132 SMs)."""
    seg_ptr = np.array([0, 2, 2 + n_long, 5 + n_long])
    n = int(seg_ptr[-1])
    piece_ptr, piece_seg, spp, slot, nslot = LL.ll_pieces(seg_ptr, n, 264)
    L = max(8, -(-n // 264))
    k = -(-n_long // L)
    assert nslot == k and list(np.diff(spp)) == [1, k, 1]
    assert list(slot) == [-1, *range(k), -1]
    assert list(piece_ptr[1:k + 1]) == [2 + j * L for j in range(k)]
    assert list(piece_seg) == [0] + [1] * k + [2]
