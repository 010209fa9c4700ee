"""Out-of-core (ROADMAP A8) of the port against the JAX reference's
``pastix_tpu/numeric/ooc.py``, on the CPU, T=16.

- Plans: the port's ``plan_ooc`` against the reference's on the same
  layout, every field of every segment and table bit for bit: LLᵗ, LU
  (``two_pools``), a budget that pre-splits levels and one that emits
  multi-pass segments.  Host only.
- Streamed factors and solutions: the smallest Poisson (LLᵗ, LDLᵗ) and
  convection-diffusion (LU) matrices whose plans have two segments, the
  first with export slots; both sides start from the reference's host
  coefinit with one pivot planted at zero (LDLᵗ, LU) and a clamp
  threshold of 1e-2 · max|A|.  The port's ``factorize_ooc*`` and
  ``solve_ooc`` against the reference's, one reference run a kind: pools
  rtol 1e-4, atol 1e-5 · max|ref| (those of
  ``tests/test_torch_factorize.py``: the same products, summed in another
  order), the pivots ``d`` rtol 1e-5, the clamp counts equal (one), the
  unrefined solution within 1e-4 · max|x_ref|.  The host coefinit bit for
  bit.  Multi-pass segments against the port's resident right-looking
  pair program on the same layout, fp64 pools (LLᵗ, LDLᵗ, LU) against its
  resident left-looking torch ops (rtol 1e-10, atol 1e-12 · max|ref|: the
  same products in another order).
- The whole solver: ``Pastix(ooc=True, ooc_limit_mb=1)`` streams LLᵗ,
  LDLᵗ and LU and refines to 1e-10, ``factorize(values)`` included; the
  same solver against the reference's ``solve`` shares that reference run
  with ``tests/test_torch_pastix.py``'s ``pair`` fixture (its test
  ``test_streamed_solver_matches_reference``).  Auto-streaming with
  ``Pastix._free_device_bytes`` patched small; a budget the pools fit
  (resident, the dense tail recovered); a pool that must stream but
  cannot; the factor offload round trip and a pool that fits the limit
  (the device refinement loop built only for factors that stay);
  one complex128 LDLᴴ streamed solve (pools as fp64's); ``e2=`` and
  ``fused_diag=True`` refused; the CLI with ``--ooc 1 --cpu``.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from pastix_tpu.numeric import ooc as JO
from pastix_tpu.numeric.factorize import coefinit as ref_coefinit
from pastix_tpu.solve import rhs_to_blocks as ref_rhs_to_blocks

from pastix_tpu_torch import cli
from pastix_tpu_torch.config import Factorization, PastixConfig
from pastix_tpu_torch.generators import (
    convection_diffusion_3d, helmholtz_2d, laplacian_2d, poisson_3d,
)
from pastix_tpu_torch.numeric import factorize as F
from pastix_tpu_torch.numeric import ooc as O
from pastix_tpu_torch.pastix import Pastix

from torch_common import no_calibration  # noqa: F401 (autouse)

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

T = 16
TILE = T * T * 4  # bytes of an fp32 tile
LLT, LDLT, LU = Factorization.LLT, Factorization.LDLT, Factorization.LU

# name -> (generator, nx, kind, budget in fp32 tiles)
PLANS = {
    "llt": (poisson_3d, 5, LLT, 40),
    "lu": (convection_diffusion_3d, 5, LU, 80),
    "presplit": (poisson_3d, 6, LLT, 48),
    "multipass": (poisson_3d, 6, LLT, 96),
}


@pytest.fixture(scope="module")
def layouts():
    """name -> the port's layout of :data:`PLANS` (no dense tail)."""
    out = {}
    for name, (gen, nx, kind, _) in PLANS.items():
        s = Pastix(gen(nx), PastixConfig(tile_size=T, dense_tail=False,
                                         factorization=kind), device="cpu")
        s.analyze()
        out[name] = s
    return out


def _segments_equal(got, ref):
    assert len(got.segments) == len(ref.segments)
    for g, r in zip(got.segments, ref.segments):
        assert (g.n_win, g.n_out) == (r.n_win, r.n_out)
        for a, b in ((g.win, r.win), (g.touched_out, r.touched_out)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert len(g.tables) == len(r.tables)
        for tg, tr in zip(g.tables, r.tables):
            assert tg.keys() == tr.keys()
            for k in tg:
                assert tg[k].dtype == tr[k].dtype, k
                np.testing.assert_array_equal(tg[k], tr[k], err_msg=k)


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_matches_reference(layouts, name):
    s = layouts[name]
    lay = s.layout
    lu = PLANS[name][2] == LU
    budget = PLANS[name][3] * TILE
    got = O.plan_ooc(lay, budget, two_pools=lu)
    ref = JO.plan_ooc(lay, budget, two_pools=lu)
    assert (got.budget_tiles, got.gemm_chunk, got.two_pools) == (
        ref.budget_tiles, ref.gemm_chunk, ref.two_pools)
    assert got.max_footprint_tiles() == ref.max_footprint_tiles()
    assert len(got.segments) >= 2
    _segments_equal(got, ref)
    n_tables = sum(len(g.tables) for g in got.segments)
    passes = sum(a.win is b.win for a, b in zip(got.segments,
                                                got.segments[1:]))
    if name == "presplit":
        assert n_tables > len(lay.levels) and not passes
    if name == "multipass":
        assert passes and n_tables > len(lay.levels)
    if lu:
        assert any(t["ga_nd"].size for g in got.segments for t in g.tables)


# kind -> (generator, nx, reference kind name, budget in fp32 tiles)
KINDS = {"llt": (poisson_3d, 4, LLT, 10), "ldlt": (poisson_3d, 4, LDLT, 10),
         "lu": (convection_diffusion_3d, 4, LU, 20)}


@pytest.fixture(scope="module", params=list(KINDS))
def streamed(request):
    """One streamed factorization and unrefined solve of a kind on both
    sides, from the same host pools."""
    gen, nx, kind, bt = KINDS[request.param]
    lu, ldlt = kind == LU, kind == LDLT
    s = Pastix(gen(nx), PastixConfig(tile_size=T, dense_tail=False,
                                     factorization=kind), device="cpu")
    s.analyze()
    lay, Ap = s.layout, s._A_perm
    pool, pool_u = ref_coefinit(lay, Ap, for_lu=lu)
    if kind != LLT:
        # a leaf column's first pivot is exactly zero: one clamp each
        d0 = lay.lookup(np.asarray(lay.levels[0].cols[:1]),
                        np.asarray(lay.levels[0].cols[:1]))[0]
        pool[d0, 0, 0] = 0.0
    eps = 1e-2 * float(abs(Ap).max())
    budget = bt * TILE
    jplan = JO.plan_ooc(lay, budget, two_pools=lu)
    plan = O.plan_ooc(lay, budget, two_pools=lu)
    b = np.random.default_rng(3).standard_normal(lay.n)
    bb = ref_rhs_to_blocks(lay, b)
    host = lambda p: torch.from_numpy(p.copy())
    out = {"kind": kind, "s": s, "plan": plan}
    if lu:
        rp, ru, rn = JO.factorize_ooc_lu(lay, jplan, pool.copy(),
                                         pool_u.copy(), eps)
        gp, gu, gn = O.factorize_ooc_lu(lay, plan, host(pool), host(pool_u),
                                        eps, "cpu")
        out.update(ref_u=ru, got_u=gu.numpy())
        rd = gd = None
    elif ldlt:
        rp, rd, rn = JO.factorize_ooc_ldlt(lay, jplan, pool.copy(), eps)
        gp, gd, gn = O.factorize_ooc_ldlt(lay, plan, host(pool), eps, "cpu")
        ru = gu = None
    else:
        rp = JO.factorize_ooc(lay, jplan, pool.copy())
        gp = O.factorize_ooc(lay, plan, host(pool), "cpu")
        rn = gn = 0
        rd = gd = ru = gu = None
    out.update(ref=rp, got=gp.numpy(), ref_d=rd,
               got_d=None if gd is None else gd.numpy(),
               ref_npiv=int(rn), got_npiv=int(gn))
    out["ref_x"] = np.asarray(JO.solve_ooc(
        lay, jplan, rp, bb, d=None if rd is None else np.asarray(rd),
        host_pool_u=ru))
    out["got_x"] = O.solve_ooc(
        lay, plan, gp, torch.from_numpy(bb), "cpu", kind, d=gd,
        host_pool_u=gu).numpy()
    return out


def _close(got, ref, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol * max(float(np.abs(ref).max()), 1.0))


def test_host_coefinit_matches_reference(streamed):
    s = streamed["s"]
    lu = streamed["kind"] == LU
    pool, pool_u = F.coefinit(s.layout, s._A_perm, for_lu=lu)
    rp, ru = ref_coefinit(s.layout, s._A_perm, for_lu=lu)
    assert pool.device.type == "cpu" and pool.dtype == torch.float32
    np.testing.assert_array_equal(pool.numpy(), rp)
    if lu:
        np.testing.assert_array_equal(pool_u.numpy(), ru)
    else:
        assert pool_u is None and ru is None


def test_streamed_pools_match_reference(streamed):
    plan = streamed["plan"]
    assert len(plan.segments) == 2 and plan.segments[0].n_out
    _close(streamed["got"], streamed["ref"])
    if streamed["kind"] == LU:
        _close(streamed["got_u"], streamed["ref_u"])


def test_streamed_pivots_match_reference(streamed):
    kind = streamed["kind"]
    assert streamed["got_npiv"] == streamed["ref_npiv"] == (kind != LLT)
    if kind == LDLT:
        np.testing.assert_allclose(streamed["got_d"],
                                   np.asarray(streamed["ref_d"]), rtol=1e-5)


def test_streamed_solve_matches_reference(streamed):
    ref = streamed["ref_x"]
    np.testing.assert_allclose(streamed["got_x"], ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def _resident_pools(s, kind, dtype=torch.float32):
    """The port's resident pools on ``s``'s layout (its coefinit from the
    host one): the right-looking pair program of an fp32 pool, the
    left-looking torch ops of another."""
    lay = s.layout
    pool, pool_u = F.coefinit(lay, s._A_perm, dtype, kind == LU)
    fn = F.build_factorize_fn(lay, "cpu", kind, dtype=dtype,
                              e2="pair" if dtype == torch.float32 else None)
    if kind == LU:
        return fn(pool, pool_u, 1e-8)[:2]
    return (fn(pool, 1e-8)[0] if kind == LDLT else fn(pool)), None


def test_multipass_segments_match_resident(layouts):
    """The later passes of a multi-pass segment (no diagonal tiles or
    panels, only their slice of the exports) give the resident pools."""
    s = layouts["multipass"]
    plan = O.plan_ooc(s.layout, PLANS["multipass"][3] * TILE)
    pool, _ = F.coefinit(s.layout, s._A_perm)
    got = O.factorize_ooc(s.layout, plan, pool, "cpu")
    ref, _ = _resident_pools(s, LLT)
    _close(got.numpy(), ref.numpy())


@pytest.mark.parametrize("kind", [LLT, LDLT, LU])
def test_fp64_streamed_pools_match_resident(kind):
    """fp64 pools stream through the torch ops (no kernel, no twin)."""
    gen, nx, _, bt = KINDS[kind.name.lower()]
    s = Pastix(gen(nx), PastixConfig(tile_size=T, dense_tail=False,
                                     factorization=kind,
                                     compute_dtype="float64"), device="cpu")
    s.analyze()
    lay, lu = s.layout, kind == LU
    plan = O.plan_ooc(lay, bt * TILE * 2, dtype_bytes=8, two_pools=lu)
    assert len(plan.segments) == 2
    pool, pool_u = F.coefinit(lay, s._A_perm, torch.float64, lu)
    before = O.gemm_scatter_pipelined.twin_launches
    if lu:
        got = O.factorize_ooc_lu(lay, plan, pool, pool_u, 1e-8, "cpu")[:2]
    elif kind == LDLT:
        got = O.factorize_ooc_ldlt(lay, plan, pool, 1e-8, "cpu")[:1]
    else:
        got = [O.factorize_ooc(lay, plan, pool, "cpu")]
    assert O.gemm_scatter_pipelined.twin_launches == before
    ref = _resident_pools(s, kind, torch.float64)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        _close(g.numpy(), r.numpy(), rtol=1e-10, atol=1e-12)


def _solver(kind, nx=None, **kw):
    A = (convection_diffusion_3d(nx or 10) if kind == LU
         else poisson_3d(nx or 11))
    cfg = PastixConfig(tile_size=T, factorization=kind, **kw)
    return A, Pastix(A, cfg, device="cpu")


@pytest.mark.parametrize("kind", [LLT, LDLT, LU])
def test_streamed_solver_refines(kind):
    """``Pastix(ooc=True, ooc_limit_mb=1)`` streams (the pools in host
    memory, several segments, no dense tail), refines on the host loop
    to 1e-10 and matches the resident solver; then ``factorize(values)``
    on the cached analysis and plan."""
    A, s = _solver(kind, ooc=True, ooc_limit_mb=1)
    b = A.to_scipy() @ np.ones(A.n)
    x = s.solve(b)
    plan = s._ooc_plan
    assert plan is not None and len(plan.segments) >= 2
    assert s.factors.streamed and s.factors.offloaded
    assert s._dense_tail is None and s._refine_fn is None
    assert s._fact_fn.e2 == "pair" and s.report.residual <= 1e-10
    assert plan.io["up_bytes"] > 0 and plan.io["down_bytes"] > 0
    _, r = _solver(kind)
    np.testing.assert_allclose(x, r.solve(b), rtol=0, atol=1e-8)
    s.factorize(values=A.values * 3.0)
    assert s._ooc_plan is plan and s.factors.streamed
    x3 = s.solve(b)
    assert np.abs(x3 - 1.0 / 3.0).max() < 1e-8


def test_auto_streaming(monkeypatch):
    """A pool larger than the card's free memory streams with no ``ooc``
    flag, under 0.8 of that memory as the budget (the dense tail
    dropped, no device refinement loop)."""
    monkeypatch.setattr(Pastix, "_free_device_bytes", lambda self: 1 << 20)
    A, s = _solver(LLT)
    b = A.to_scipy() @ np.ones(A.n)
    x = s.solve(b)
    assert not s.config.ooc and s._ooc_plan is not None
    assert s._ooc_plan.budget_tiles == int(int((1 << 20) * 0.8) // TILE
                                           * 0.75)
    assert s.factors.streamed and s._dense_tail is None
    assert s._refine_fn is None
    assert np.abs(x - 1).max() < 1e-8


def test_pools_that_fit_stay_resident(monkeypatch):
    """With ``ooc`` and a budget the pools fit, the analysis stays
    resident with its dense tail; a pool that must stream but cannot
    (Schur unknowns) raises."""
    A, s = _solver(LLT, ooc=True, ooc_limit_mb=4096)
    s.analyze()
    assert s._ooc_plan is None and s._dense_tail is not None
    monkeypatch.setattr(Pastix, "_free_device_bytes", lambda self: 1 << 18)
    _, s = _solver(LLT)
    s.set_schur_unknowns(np.arange(A.n - 121, A.n))
    with pytest.raises(MemoryError, match="cannot stream"):
        s.analyze()


def test_offload_round_trip():
    """Resident factors larger than the limit (0: always) leave the card
    after the factorization; a solve restores them, and the host loop
    refines.  Factors within the limit stay, with the device loop."""
    A = laplacian_2d(12)
    b = A.to_scipy() @ np.ones(A.n)
    s = Pastix(A, PastixConfig(ooc=True), device="cpu")
    s.factorize()
    f = s.factors
    assert f.offloaded and not f.streamed and f.dinv is not None
    assert s._ooc_plan is None and s._refine_fn is None
    live = s._restore_factors()
    assert live is not f and not live.offloaded
    assert torch.equal(live.pool, f.pool)
    x = s.solve(b)
    assert np.abs(x - 1).max() < 1e-8
    s = Pastix(laplacian_2d(8), PastixConfig(ooc=True, ooc_limit_mb=512),
               device="cpu")
    s.factorize()
    assert not s.factors.offloaded and s._restore_factors() is s.factors
    assert s._refine_fn is not None


def test_complex128_ldlh_streamed():
    H = helmholtz_2d(24).to_scipy()
    H = ((H + H.conj().T) / 2).tocsc()
    b = H @ np.ones(H.shape[0])
    kw = dict(tile_size=T, compute_dtype="complex128",
              factorization=Factorization.LDLH)
    s = Pastix(H, PastixConfig(ooc=True, ooc_limit_mb=1, **kw), device="cpu")
    x = s.solve(b)
    assert s.factors.streamed and len(s._ooc_plan.segments) >= 2
    assert s.factors.pool.dtype == torch.complex128
    r = Pastix(H, PastixConfig(dense_tail=False, **kw), device="cpu")
    r.factorize()
    _close(s.factors.pool.numpy(), r.factors.pool.numpy(), rtol=1e-10,
           atol=1e-12)
    assert np.abs(x - 1).max() < 1e-10


def test_streamed_program_refuses_other_schedules(layouts):
    s = layouts["llt"]
    plan = O.plan_ooc(s.layout, PLANS["llt"][3] * TILE)
    fn = F.build_factorize_fn(s.layout, "cpu", ooc_plan=plan, e2="pair")
    assert fn.e2 == "pair" and not fn.fused_diag
    for kw in (dict(e2="stream"), dict(e2="left"), dict(fused_diag=True)):
        with pytest.raises(ValueError, match="streamed"):
            F.build_factorize_fn(s.layout, "cpu", ooc_plan=plan, **kw)


def test_cli_ooc():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["-lap3", "11", "--tile", "16", "--ooc", "1", "--cpu"])
    assert rc == 0
    assert "numfact(ooc)" in out.getvalue()
