"""The packed E2 path (``packed_update=True``, ``PASTIX_PACKED``) of the
port against the JAX reference's, on the CPU, where the reference's auto
setting runs it by default.

- ``analyze.packed.build_packed_plan``: the port's copy emits the
  reference's tables bit for bit on the port's layouts (LLᵗ with and
  without the dense tail, LU).
- The pools: the port's ``Pastix(packed_update=True)`` against the
  reference's ``build_factorize_fn(..., packed_plan=)`` on the same
  layout, dense-tail plan and values (the reference scans its small
  levels, over padded tables; the port unrolls every level), for LLᵗ
  with fp32 updates and the dense tail, and without the tail (whose
  unrolled reference program takes most of a compile) with bf16
  updates, LDLᵗ, LU, fp64 LLᵗ and complex64 LLᴴ; and
  against the port's own left-looking pools.  Tolerances: fp32 and
  complex64 pools rtol 1e-4, atol 1e-5 · max|ref| (those of
  ``tests/test_torch_factorize.py``); fp64 rtol 1e-9, atol 1e-10 ·
  max|ref| (only the order of the updates differs).
- Out-of-range rows: a level with pad rows, its pad chunk and dropped
  scatter rows goes through the port's row functions and through a numpy
  reading of JAX's rules (a gather clamps, a scatter drops) on the same
  pool: equal, no index error, tile ``npool - 1`` unchanged.
- Schur unknowns: ``get_schur`` of the packed route against the
  reference's (1e-4 · max|S|, fp32 updates), with no residue pass.
- The other kinds and dtypes (LDLᴴ, complex-symmetric LDLᵗ, complex
  LU, complex LLᴴ, fp64 LDLᵗ and LU) against the port's left-looking
  pools with the same tolerances, and solved.
- ``e2=`` or ``fused_diag=True`` with a packed plan raises; the gate:
  ``packed_update=None`` is off, ``PASTIX_PACKED`` overrides.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pastix_tpu
from pastix_tpu.analyze import packed as JP
from pastix_tpu.config import Factorization as JF
from pastix_tpu.config import PastixConfig as JPastixConfig
from pastix_tpu.generators import poisson_3d as j_poisson_3d
from pastix_tpu.numeric.factorize import (
    build_factorize_fn as ref_factorize_fn, factorize as ref_factorize,
)

from pastix_tpu_torch.analyze import packed as P
from pastix_tpu_torch.config import Factorization, PastixConfig, Symmetry
from pastix_tpu_torch.generators import (
    convection_diffusion_3d, laplacian_2d, poisson_3d,
)
from pastix_tpu_torch.numeric import factorize as F
from pastix_tpu_torch.numeric import packed as NP
from pastix_tpu_torch.numeric import pipelined as PL
from pastix_tpu_torch.pastix import Pastix

from torch_common import no_calibration  # noqa: F401 (autouse)

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

T = 16
_FIELDS = ("nchunk", "gidx", "cpos", "ccol", "pa", "pgb", "dst", "dst_u")


def _hermitian_2d(n_side, seed=2):
    """laplacian_2d + S + Sᴴ, S = 0.2i N(0, 1) on the strict lower
    pattern (``tests/test_complex.py``'s Hermitian construction)."""
    rng = np.random.default_rng(seed)
    L = laplacian_2d(n_side).to_scipy().astype(np.complex128)
    C = sp.tril(L, -1).tocoo()
    S = sp.coo_matrix((0.2j * rng.standard_normal(C.nnz), (C.row, C.col)),
                      shape=L.shape).tocsc()
    return (L + S + S.conj().T).tocsc()


# name -> (matrix, port config fields, reference kind, update dtype)
CASES = {
    "llt": (lambda: poisson_3d(7), {}, JF.LLT, None),
    "llt-bf16": (lambda: poisson_3d(7),
                 dict(update_dtype="bfloat16", dense_tail=False), JF.LLT,
                 jnp.bfloat16),
    "ldlt": (lambda: poisson_3d(7),
             dict(factorization=Factorization.LDLT), JF.LDLT, None),
    "lu": (lambda: convection_diffusion_3d(6),
           dict(factorization=Factorization.LU), JF.LU, None),
    "llt-f64": (lambda: poisson_3d(6),
                dict(compute_dtype="float64", dense_tail=False), JF.LLT,
                None),
    "llh-c64": (lambda: _hermitian_2d(8),
                dict(compute_dtype="complex64", symmetry=Symmetry.HERMITIAN,
                     dense_tail=False), JF.LLT, None),
}


def _analyzed(M, **kw):
    s = Pastix(M, PastixConfig(tile_size=T, packed_update=True, **kw),
               device="cpu")
    s.analyze()
    return s


def _tol(dt):
    """(rtol, atol factor of max|ref|) of the pools' dtype."""
    return (1e-9, 1e-10) if dt == torch.float64 else (1e-4, 1e-5)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(name, port solver factored on the packed route, the reference's
    factors on the same layout and plan, the port's left-looking
    pools)."""
    build, kw, jkind, jupd = CASES[request.param]
    s = _analyzed(build(), **kw)
    s.factorize()
    lay, dt = s.layout, s._dense_tail
    plan = JP.build_packed_plan(
        lay, s._pat_perm_ext,
        levels=dt.levels_lo if dt is not None else None,
        for_lu=jkind == JF.LU)
    ref_fn = ref_factorize_fn(lay, jkind, update_dtype=jupd,
                              hermitian=s._hermitian, dense_tail=dt,
                              packed_plan=plan)
    ndt = np.dtype(s.config.compute_dtype).type
    ref = ref_factorize(lay, s._A_perm, jkind, dtype=ndt, fact_fn=ref_fn)
    left_fn = F.build_factorize_fn(
        lay, "cpu", s._kind, update_dtype=F_upd(s), dense_tail=dt,
        dtype=s._dtype, hermitian=s._hermitian)
    left = F.factorize(lay, s._A_perm, s._coef_fn, left_fn, s.device)
    return request.param, s, ref, left


def F_upd(s):
    return {None: None, "bfloat16": torch.bfloat16}[s.config.update_dtype]


def _close(got, ref, dt):
    rtol, atol = _tol(dt)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol * float(np.abs(ref).max()))


def test_packed_pools_match_reference(case):
    name, s, ref, _ = case
    f = s.factors
    assert s._fact_fn.e2 == "packed" and s._packed_plan is not None
    _close(f.pool.numpy(), ref.pool, f.dtype)
    if f.pool_u is not None:
        _close(f.pool_u.numpy(), ref.pool_u, f.dtype)
    if f.d is not None:
        _close(f.d.numpy()[:, :], np.asarray(ref.d), f.dtype)
    assert f.n_static_pivots == ref.n_static_pivots


def test_packed_pools_match_left_looking(case):
    _, s, _, left = case
    f = s.factors
    _close(f.pool.numpy(), left.pool.numpy(), f.dtype)
    if f.pool_u is not None:
        _close(f.pool_u.numpy(), left.pool_u.numpy(), f.dtype)


def test_packed_solves(case):
    """The packed factors solve through the kind's solve and refinement
    (K2's twin as M⁻¹ on fp32 pools)."""
    _, s, _, _ = case
    M = s.A.to_scipy()
    x = s.solve(M @ np.ones(s.A.n))
    assert s.report.residual <= 1e-10
    assert np.abs(x - 1).max() < 1e-8


@pytest.mark.parametrize("kind,dtype", [
    ("LDLH", "complex128"), ("LDLT", "complex64"), ("LU", "complex128"),
    ("LLT", "complex128"), ("LDLT", "float64"), ("LU", "float64"),
])
def test_packed_matches_left_looking_every_dtype(kind, dtype):
    """The kinds and dtypes the reference comparisons above leave out:
    the packed pools (and pivots) against the port's left-looking ones
    on the same layout (fp64 and complex128 rtol 1e-9, atol 1e-10 ·
    max|ref|; complex64 the fp32 tolerance), and a refined solve."""
    herm = kind in ("LDLH", "LLT") and dtype.startswith("complex")
    M = (_hermitian_2d(10) if herm else
         convection_diffusion_3d(5).to_scipy() if kind == "LU" else
         poisson_3d(5).to_scipy())
    if dtype.startswith("complex") and not herm:
        M = (M + 0.3j * abs(M)).tocsc() if kind == "LU" else (
            M - 0.5j * sp.eye(M.shape[0])).tocsc()
    kw = dict(compute_dtype=dtype, factorization=Factorization[kind],
              symmetry=Symmetry.HERMITIAN if herm else Symmetry.SYMMETRIC)
    if kind == "LU":
        kw.pop("symmetry")
    s = _analyzed(M, **kw)
    s.factorize()
    left_fn = F.build_factorize_fn(s.layout, "cpu", s._kind,
                                   dtype=s._dtype, hermitian=s._hermitian)
    left = F.factorize(s.layout, s._A_perm, s._coef_fn, left_fn, s.device)
    f = s.factors
    for got, ref in ((f.pool, left.pool), (f.pool_u, left.pool_u),
                     (f.d, left.d)):
        if ref is not None:
            _close(got.numpy(), ref.numpy(), f.dtype.to_real())
    x = s.solve(M @ np.ones(M.shape[0]))
    assert s.report.residual <= 1e-10 and np.abs(x - 1).max() < 1e-8


@pytest.mark.parametrize("kw,lu", [
    (dict(), False), (dict(dense_tail=False), False), (dict(), True),
], ids=["llt-tail", "llt-no-tail", "lu"])
def test_plan_tables_bit_equal(kw, lu):
    M = convection_diffusion_3d(6) if lu else poisson_3d(7)
    if lu:
        kw = dict(kw, factorization=Factorization.LU)
    s = _analyzed(M, **kw)
    dt = s._dense_tail
    assert (dt is not None) == (not lu and kw.get("dense_tail", True))
    levels = dt.levels_lo if dt is not None else None
    ref = JP.build_packed_plan(s.layout, s._pat_perm_ext, levels=levels,
                               for_lu=lu)
    got = s._packed_plan
    assert (got.T, got.npool) == (ref.T, ref.npool)
    assert len(got.levels) == len(ref.levels) == len(levels or
                                                     s.layout.levels)
    for g, r in zip(got.levels, ref.levels):
        for k in _FIELDS:
            a, b = getattr(g, k), getattr(r, k)
            if b is None:
                assert a is None
            else:
                assert np.asarray(a).dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(a, b)
    assert got.gemm_flops() == ref.gemm_flops()
    assert got.trsm_flops() == ref.trsm_flops()
    np.testing.assert_array_equal(
        np.concatenate(P.scalar_supports(s._pat_perm_ext, T, s.layout.nbc)),
        np.concatenate(JP.scalar_supports(s._pat_perm_ext, T,
                                          s.layout.nbc)))


def test_out_of_range_rows_drop():
    """Level 0's plan with its pad rows, its pad chunk and its dropped
    scatter rows (index npool * T), and its rows into tile npool - 1 (the
    last diagonal tile, where a clamped row would land) dropped too: the
    port's gather, set and scatter against a numpy reading of JAX's
    rules (a gather clamps, a scatter drops) on the same random pool; no
    index error, and tile npool - 1 unchanged, where clamping the dropped
    rows would have changed it."""
    s = _analyzed(poisson_3d(7), dense_tail=False)
    lay = s.layout
    npool = lay.npool
    oob = npool * T
    pl = s._packed_plan.levels[0]
    pl = dataclasses.replace(
        pl, dst=np.where(pl.dst // T == npool - 1, oob, pl.dst))
    assert (pl.gidx[-1] == oob).all()  # the pad chunk
    assert (pl.gidx[:pl.nchunk] == oob).any() and (pl.dst == oob).any()
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((npool, T, T))
    # numpy: the reference's rules
    p2 = pool.reshape(-1, T).copy()
    O = p2[np.minimum(pl.gidx, oob - 1)] * 0.5
    ok = pl.gidx < oob
    p2[pl.gidx[ok]] = O[ok]
    b = p2.reshape(npool, T, T)[pl.pgb]
    W = np.einsum("gij,gkj->gik", O[pl.pa], b)
    keep = pl.dst < oob
    clamped = p2.copy()
    np.add.at(p2, pl.dst[keep], -W[keep])
    np.add.at(clamped, np.minimum(pl.dst, oob - 1), -W)
    assert not np.array_equal(clamped[-T:], pool[npool - 1])
    # the port, pairs in chunks of 7 so that several chunks run
    lv = NP.upload_level(lay.levels[0], pl, npool, T, 7, "cpu", False)
    assert lv.set_pos is not None and len(lv.pairs) > 1
    assert all(c.keep is not None for c in lv.pairs)
    got = torch.from_numpy(pool.copy())
    g2 = got.view(-1, T)
    Og = NP.gather_rows(g2, lv) * 0.5
    NP.set_rows(g2, lv, Og)
    NP.scatter_pairs(g2, got, Og, lv)
    np.testing.assert_allclose(g2.numpy(), p2, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[npool - 1].numpy(), pool[npool - 1])


def test_packed_schur_matches_reference():
    """Schur unknowns on the packed route: the levels' scatter reaches the
    Schur tiles directly (no K3 residue), and ``get_schur`` agrees with
    the reference's (its CPU default is packed too)."""
    nx = 6
    A = poisson_3d(nx)
    schur = np.arange(A.n - nx * nx, A.n)
    ref = pastix_tpu.Pastix(j_poisson_3d(nx), JPastixConfig(tile_size=8))
    ref.set_schur_unknowns(schur)
    ref.factorize()
    S_ref = ref.get_schur()
    assert ref._packed_plan is not None
    s = Pastix(A, PastixConfig(tile_size=8, packed_update=True),
               device="cpu")
    s.set_schur_unknowns(schur)
    twins = PL.gemm_scatter_pipelined.twin_launches
    S = s.get_schur()
    assert PL.gemm_scatter_pipelined.twin_launches == twins
    assert s._fact_fn.e2 == "packed"
    np.testing.assert_allclose(S, S_ref, rtol=0,
                               atol=1e-4 * np.abs(S_ref).max())


@pytest.mark.parametrize("kw", [dict(e2="left"), dict(e2="stream"),
                                dict(fused_diag=True)],
                         ids=["e2-left", "e2-stream", "fused_diag"])
def test_packed_refuses_e2_and_fused_diag(kw):
    s = _analyzed(poisson_3d(5))
    with pytest.raises(ValueError, match="packed"):
        F.build_factorize_fn(s.layout, "cpu", update_dtype=torch.bfloat16,
                             dense_tail=s._dense_tail,
                             packed_plan=s._packed_plan, **kw)


@pytest.mark.parametrize("field,env,on", [
    (None, None, False), (False, None, False), (True, None, True),
    (None, "1", True), (True, "0", False), (None, "0", False),
], ids=["auto", "off", "on", "env-on", "env-off", "auto-env-off"])
def test_packed_gate(field, env, on, monkeypatch):
    """packed_update=None (auto) is off (the port's recorded deviation);
    PASTIX_PACKED overrides the field; an incomplete layout never runs
    packed."""
    if env is None:
        monkeypatch.delenv("PASTIX_PACKED", raising=False)
    else:
        monkeypatch.setenv("PASTIX_PACKED", env)
    A = poisson_3d(5)
    for inc in (False, True):
        s = Pastix(A, PastixConfig(tile_size=T, packed_update=field,
                                   incomplete=inc), device="cpu")
        s.analyze()
        assert (s._packed_plan is not None) == (on and not inc)
        assert (s._fact_fn.e2 == "packed") == (on and not inc)
