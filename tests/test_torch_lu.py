"""The port's real LU (slice 2) against the JAX reference, on the CPU.

convection_diffusion_3d(8) (n = 512, unsymmetric values on the 7-point
pattern), T=32, the same layout for both.  Held:

- coefinit: ``pool`` and ``pool_u`` bit-equal (no duplicate entries);
- the factors (``pool``, ``pool_u``, the static-pivot count) against the
  reference's ``build_factorize_fn(LU, update_dtype=float32,
  use_pallas=True)`` (Pallas in interpret mode): rtol 1e-4, atol 1e-5 ·
  max|ref| (the port is all left-looking, so only rounding agrees); the
  inverse diagonal tiles rtol 1e-4, atol 1e-4 · max|ref| (triangular
  solve against block doubling);
- K4's twin against the reference's ``getrf_batch`` on the tiles of the
  busiest level and on tiles with planted zero pivots: equal clamp
  counts, tiles within 1e-5 · max|ref|;
- the static-pivot count on the reference's own tiny-pivot matrix
  (``tests/test_factorize.py`` ``test_static_pivoting_counts``, at T=32);
- ``Pastix(device="cpu")`` solves and the Schur path to a fp64 residual
  <= 1e-10, S against the dense A22 - A21 A11⁻¹ A12 to 1e-5 · max|S|,
  and the reference's factors through the port's solve.  (A fresh
  interpreter that solves with LU loads neither jax nor pastix_tpu:
  ``tests/test_torch_host.py``.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pastix_tpu.numeric.leftlook as JLL
import pastix_tpu.numeric.pallas_kernels as JPK
from pastix_tpu.analyze import build_layout as j_build_layout
from pastix_tpu.config import Factorization as JF
from pastix_tpu.numeric import kernels as JK
from pastix_tpu.numeric.factorize import (
    Factors as JFactors,
    build_diag_inverse_fn as ref_diag_inverse_fn,
    build_factorize_fn as ref_factorize_fn,
    coefinit as ref_coefinit,
    factorize as ref_factorize,
)

from pastix_tpu_torch.config import Factorization, PastixConfig
from pastix_tpu_torch.convert import factors_from_jax
from pastix_tpu_torch.generators import convection_diffusion_3d
from pastix_tpu_torch.numeric import factorize as F
from pastix_tpu_torch.numeric import tile_factor as TF
from pastix_tpu_torch.pastix import Pastix

NX, T = 8, 32
LU = Factorization.LU


def _solver(**kw):
    return Pastix(convection_diffusion_3d(NX),
                  PastixConfig(tile_size=T, factorization=LU, **kw),
                  device="cpu")


@pytest.fixture(scope="module")
def case():
    s = _solver()
    s.analyze()
    eps = 1e-14 * float(abs(s._A_perm).max())
    return s, eps


@pytest.fixture(scope="module")
def factored(case):
    """(reference (pool, pool_u, npiv), port (pool, pool_u, npiv)) after
    an fp32-update factorization of the same coefinit pools."""
    s, eps = case
    lay = s.layout
    pool, pool_u = ref_coefinit(lay, s._A_perm, for_lu=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JLL, "_INTERPRET", True)
        mp.setattr(JPK, "_INTERPRET", True)
        ref_fn = ref_factorize_fn(lay, JF.LU, update_dtype=jnp.float32,
                                  use_pallas=True)
        ref = ref_fn(jnp.asarray(pool), jnp.asarray(pool_u),
                     jnp.asarray(eps, jnp.float32))
        ref = tuple(np.asarray(r) for r in ref)
    fn = F.build_factorize_fn(lay, "cpu", LU, update_dtype=torch.float32)
    got = fn(torch.from_numpy(pool.copy()), torch.from_numpy(pool_u.copy()),
             eps)
    return ref, tuple(g.numpy() for g in got)


def test_lu_coefinit_bit_equal(case):
    s, _ = case
    ref = ref_coefinit(s.layout, s._A_perm, for_lu=True)
    coef = F.build_coefinit_fn(s.layout, s._A_perm, "cpu", for_lu=True)
    vals = torch.from_numpy(sp.coo_matrix(s._A_perm).data.astype(np.float32))
    got = coef(vals)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), r)
    assert np.abs(ref[1]).max() > 0


@pytest.mark.parametrize("which", ["pool", "pool_u"])
def test_lu_factors_match_reference(factored, which):
    ref, got = factored
    i = ("pool", "pool_u").index(which)
    scale = float(np.abs(ref[i]).max())
    np.testing.assert_allclose(got[i], ref[i], rtol=1e-4, atol=1e-5 * scale)
    assert int(got[2]) == int(ref[2]) == 0


def test_lu_diag_inverses_match(case, factored):
    s, _ = case
    (pool, pool_u, _), _ = factored
    ref = ref_diag_inverse_fn(s.layout, JF.LU)(jnp.asarray(pool),
                                               jnp.asarray(pool_u))
    got = F.build_diag_inverse_fn(s.layout, "cpu", LU)(
        torch.from_numpy(pool.copy()))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())


def _tiles_with_zero_pivots(case):
    """The busiest level's diagonal tiles of A, and a batch of random
    tiles whose row and column 0, and in two of them row and column 5,
    are planted zero: those pivots stay exactly zero through the updates
    and are clamped, and the clamps cause no growth."""
    s, _ = case
    lay = s.layout
    pool, _ = ref_coefinit(lay, s._A_perm, for_lu=True)
    lv = max(lay.levels, key=lambda lv: len(lv.diag))
    rng = np.random.default_rng(3)
    M = (rng.standard_normal((4, T, T)) + 2 * T * np.eye(T)).astype(np.float32)
    M[:, 0, :] = M[:, :, 0] = 0.0
    M[:2, 5, :] = M[:2, :, 5] = 0.0
    return [pool[np.asarray(lv.diag)], M]


def test_k4_lu_twin_matches_getrf(case):
    _, eps = case
    for tiles in _tiles_with_zero_pivots(case):
        ref, rpiv = JK.getrf_batch(jnp.asarray(tiles), jnp.float32(eps))
        ref = np.asarray(ref)
        work = torch.from_numpy(tiles.copy())
        npiv = torch.zeros((), dtype=torch.int32)
        before = TF.tile_factor.twin_launches
        TF.tile_factor(work, torch.arange(len(tiles)), eps, npiv, lu=True)
        assert TF.tile_factor.twin_launches == before + 1
        assert int(npiv) == int(np.asarray(rpiv).sum())
        np.testing.assert_allclose(work.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    assert int(npiv) == 6  # 4 leading zeros, 2 planted rows


def test_static_pivot_count_on_tiny_pivot_matrix():
    """The reference's tiny-pivot matrix, in its own order: both clamp
    the same pivots, and the factors stay finite."""
    n = 64
    d = np.ones(n)
    d[10] = 1e-30
    Ap = sp.csc_matrix(sp.diags(d).tocsc() + sp.random(
        n, n, 0.05, random_state=7, format="csc") * 0.1)
    pat = ((abs(Ap) + abs(Ap).T).astype(bool)
           + sp.eye(n, dtype=bool, format="csc")).tocsc()
    lay = j_build_layout(pat, T, for_lu=True)
    ref = ref_factorize(lay, Ap, JF.LU, dtype=np.float32,
                        pivot_threshold=1e-10)
    coef = F.build_coefinit_fn(lay, Ap, "cpu", for_lu=True)
    fn = F.build_factorize_fn(lay, "cpu", LU, update_dtype=torch.float32)
    got = F.factorize(lay, Ap, coef, fn, "cpu", pivot_threshold=1e-10)
    assert got.n_static_pivots == ref.n_static_pivots >= 1
    assert torch.isfinite(got.pool).all() and torch.isfinite(got.pool_u).all()


@pytest.mark.parametrize("upd", [None, "bfloat16"])
def test_lu_solve_reaches_1e10(upd):
    A = convection_diffusion_3d(NX)
    s = _solver(update_dtype=upd)
    x = s.solve(A.to_scipy() @ np.ones(A.n))
    assert s.report.residual <= 1e-10
    assert np.abs(x - 1).max() <= 1e-8
    assert s.report.static_pivots == 0
    # the GETRF flop convention: twice the Cholesky count
    assert s.report.fact_flops == 2 * s._scalar_info["flops_exact"] > 0


def test_reference_factors_through_port_solve(case, factored):
    s, _ = case
    (pool, pool_u, npiv), _ = factored
    jf = JFactors(JF.LU, s.layout, pool, pool_u, None, int(npiv))
    s.factors = factors_from_jax(jf, "cpu")
    assert s.factors.pool_u is not None and s.factors.dinv_u is not None
    A = convection_diffusion_3d(NX)
    b = A.to_scipy() @ np.random.default_rng(4).standard_normal(A.n)
    x = s.solve(b)
    assert s.report.residual <= 1e-10
    assert np.linalg.norm(b - A.to_scipy() @ x) <= 1e-10 * np.linalg.norm(b)


def _dense_schur(A, schur):
    M = A.to_scipy().toarray()
    rest = np.setdiff1d(np.arange(A.n), schur)
    return M[np.ix_(schur, schur)] - M[np.ix_(schur, rest)] @ np.linalg.solve(
        M[np.ix_(rest, rest)], M[np.ix_(rest, schur)])


def test_lu_schur_path():
    """Schur = the plane z = NX-1; S is unsymmetric, its upper blocks
    come from the Uᵗ pool."""
    A = convection_diffusion_3d(NX)
    schur = np.arange(A.n - NX * NX, A.n)
    s = _solver()
    s.set_schur_unknowns(schur)
    b = A.to_scipy() @ np.ones(A.n)
    x = s.solve_with_schur(b)
    assert s.report.residual <= 1e-10
    assert np.abs(x - 1).max() <= 1e-8
    S, S_ref = s.get_schur(), _dense_schur(A, schur)
    assert np.abs(S - S.T).max() > 1e-3 * np.abs(S).max()
    assert np.abs(S - S_ref).max() <= 1e-5 * np.abs(S_ref).max()
    assert any(lv.schur_nd for lv in s._fact_fn.levels)


def test_k4_needs_a_built_tile_size():
    """K4 is built for T in {32, 64, 128}; the wrapper refuses others on
    the card (on the CPU the twin takes any T)."""
    assert TF._KERNEL_T == (32, 64, 128)
    pool = torch.eye(16).repeat(3, 1, 1)
    npiv = torch.zeros((), dtype=torch.int32)
    TF.tile_factor(pool, torch.arange(3), 1e-6, npiv, lu=True)
    assert torch.equal(pool, torch.eye(16).repeat(3, 1, 1))
    with pytest.raises(ValueError, match="npiv"):
        TF.tile_factor(pool, torch.arange(3), 1e-6, torch.zeros(1), lu=True)
