"""The port's real LDLᵗ (slice 2) against the JAX reference, on the CPU.

Matrices: poisson_3d(8) - σI with σ halfway between the two smallest
eigenvalues of the 7-point Laplacian (a shift-and-invert matrix with
exactly one negative eigenvalue), and the reference's own shifted
Laplacian, laplacian_2d(16) - 1.37 I (``tests/test_factorize.py``
``test_ldlt_spd_and_indefinite``); T=32.  Held:

- coefinit bit-equal (lower triangle, no duplicate entries);
- the factors (``pool``, ``d``, the static-pivot count) against the
  reference's ``build_factorize_fn(LDLT, update_dtype=float32,
  use_pallas=True)`` (Pallas in interpret mode): rtol 1e-4, atol 1e-5 ·
  max|ref| (only rounding agrees: the port is all left-looking); the
  unit-lower inverse diagonal tiles rtol 1e-4, atol 1e-4 · max|ref|;
- K4's twin against the reference's ``ldlt_batch`` on the busiest level's
  tiles and on tiles with planted zero pivots: equal clamp counts, L and
  d within 1e-5 · max|ref|;
- the static-pivot count on a symmetric matrix with one tiny, isolated
  pivot;
- ``Pastix(device="cpu")`` solves and the Schur path to a fp64 residual
  <= 1e-10, with fp32 updates, and the shift-invert matrix with bf16
  updates too (on a larger, more nearly singular one bf16 updates leave
  an error the refinement does not contract, in the reference as well:
  ``tests/ldlt_bf16_reading.py``); the pivots carry the inertia (one
  negative); S against the dense A22 - A21 A11⁻¹ A12 to 1e-5 · max|S|;
  the reference's factors through the port's solve.
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
from pastix_tpu_torch.generators import laplacian_2d, poisson_3d
from pastix_tpu_torch.numeric import factorize as F
from pastix_tpu_torch.numeric import tile_factor as TF
from pastix_tpu_torch.pastix import Pastix
from pastix_tpu_torch.sparse import SparseMatrix

NX, T = 8, 32
LDLT = Factorization.LDLT


def shift_invert_sigma(nx: int) -> float:
    """Halfway between the two smallest eigenvalues of the 7-point
    Laplacian on an nx³ grid, λ = Σ 2 - 2 cos(k π / (nx + 1))."""
    mu = lambda k: 2.0 - 2.0 * np.cos(k * np.pi / (nx + 1))
    return (3 * mu(1) + (2 * mu(1) + mu(2))) / 2


def _shifted(A, sigma):
    return SparseMatrix.from_scipy(
        (A.to_scipy() - sigma * sp.eye(A.n)).tocsc(), symmetric_storage=True)


def _poisson_shifted():
    return _shifted(poisson_3d(NX), shift_invert_sigma(NX))


def _solver(A, **kw):
    return Pastix(A, PastixConfig(tile_size=T, factorization=LDLT, **kw),
                  device="cpu")


@pytest.fixture(scope="module")
def case():
    s = _solver(_poisson_shifted())
    s.analyze()
    eps = 1e-14 * float(abs(s._A_perm).max())
    return s, eps


@pytest.fixture(scope="module")
def factored(case):
    """(reference (pool, d, npiv), port (pool, d, npiv)) after an
    fp32-update factorization of the same coefinit pool."""
    s, eps = case
    lay = s.layout
    pool, _ = ref_coefinit(lay, s._A_perm)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JLL, "_INTERPRET", True)
        mp.setattr(JPK, "_INTERPRET", True)
        ref_fn = ref_factorize_fn(lay, JF.LDLT, update_dtype=jnp.float32,
                                  use_pallas=True)
        ref = ref_fn(jnp.asarray(pool), jnp.asarray(eps, jnp.float32))
        ref = tuple(np.asarray(r) for r in ref)
    fn = F.build_factorize_fn(lay, "cpu", LDLT, update_dtype=torch.float32)
    got = fn(torch.from_numpy(pool.copy()), eps)
    return ref, tuple(g.numpy() for g in got)


def test_ldlt_coefinit_bit_equal(case):
    s, _ = case
    ref, _ = ref_coefinit(s.layout, s._A_perm)
    coef = F.build_coefinit_fn(s.layout, s._A_perm, "cpu")
    vals = torch.from_numpy(sp.coo_matrix(s._A_perm).data.astype(np.float32))
    np.testing.assert_array_equal(coef(vals).numpy(), ref)


@pytest.mark.parametrize("which", ["pool", "d"])
def test_ldlt_factors_match_reference(factored, which):
    ref, got = factored
    i = ("pool", "d").index(which)
    scale = float(np.abs(ref[i]).max())
    np.testing.assert_allclose(got[i], ref[i], rtol=1e-4, atol=1e-5 * scale)
    assert int(got[2]) == int(ref[2]) == 0
    # Sylvester: exactly one negative pivot (padded identity columns are 1)
    assert int((got[1] < 0).sum()) == 1


def test_ldlt_diag_inverse_matches(case, factored):
    s, _ = case
    (pool, _, _), _ = factored
    ref = np.asarray(ref_diag_inverse_fn(s.layout, JF.LDLT)(
        jnp.asarray(pool)))
    got = F.build_diag_inverse_fn(s.layout, "cpu", LDLT)(
        torch.from_numpy(pool.copy())).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_k4_ldlt_twin_matches_ldlt_batch(case):
    """The busiest level's diagonal tiles of A (their upper triangles
    hold garbage the kernel must not read), and symmetric random tiles
    with row and column 0, and in two of them 5, planted zero."""
    s, eps = case
    lay = s.layout
    pool, _ = ref_coefinit(lay, s._A_perm)
    lv = max(lay.levels, key=lambda lv: len(lv.diag))
    rng = np.random.default_rng(5)
    R = rng.standard_normal((4, T, T))
    M = (R + R.transpose(0, 2, 1) + 2 * T * np.eye(T)).astype(np.float32)
    M[:, 0, :] = M[:, :, 0] = 0.0
    M[:2, 5, :] = M[:2, :, 5] = 0.0
    A_tiles = pool[np.asarray(lv.diag)]
    A_tiles = A_tiles + np.triu(rng.standard_normal(A_tiles.shape), 1).astype(
        np.float32)
    for tiles in (A_tiles, M):
        full = np.tril(tiles) + np.swapaxes(np.tril(tiles, -1), 1, 2)
        L_ref, d_ref, rpiv = (np.asarray(x) for x in JK.ldlt_batch(
            jnp.asarray(full), jnp.float32(eps)))
        work = torch.from_numpy(tiles.copy())
        npiv = torch.zeros((), dtype=torch.int32)
        before = TF.tile_factor.twin_launches
        d = TF.tile_factor(work, torch.arange(len(tiles)), eps, npiv,
                           lu=False)
        assert TF.tile_factor.twin_launches == before + 1
        assert int(npiv) == int(rpiv.sum())
        np.testing.assert_allclose(work.numpy(), L_ref, rtol=0,
                                   atol=1e-5 * np.abs(L_ref).max())
        np.testing.assert_allclose(d.numpy(), d_ref, rtol=0,
                                   atol=1e-5 * np.abs(d_ref).max())
    assert int(npiv) == 6


def test_static_pivot_count_on_tiny_pivot_matrix():
    """A symmetric matrix whose unknown 10 has a pivot of 1e-30 and no
    neighbours: both clamp exactly that pivot."""
    n = 64
    d = np.ones(n)
    d[10] = 1e-30
    R = sp.random(n, n, 0.05, random_state=7, format="csc") * 0.05
    keep = sp.diags((np.arange(n) != 10).astype(float))
    Ap = sp.csc_matrix(sp.diags(d) + keep @ (R + R.T) @ keep)
    pat = (Ap.astype(bool) + sp.eye(n, dtype=bool, format="csc")).tocsc()
    lay = j_build_layout(pat, T)
    ref = ref_factorize(lay, Ap, JF.LDLT, dtype=np.float32,
                        pivot_threshold=1e-10)
    coef = F.build_coefinit_fn(lay, Ap, "cpu")
    fn = F.build_factorize_fn(lay, "cpu", LDLT, update_dtype=torch.float32)
    got = F.factorize(lay, Ap, coef, fn, "cpu", pivot_threshold=1e-10)
    assert got.n_static_pivots == ref.n_static_pivots == 1
    assert torch.isfinite(got.pool).all() and torch.isfinite(got.d).all()


@pytest.mark.parametrize("name,upd", [
    ("poisson_3d(8) shift-invert", None),
    ("poisson_3d(8) shift-invert", "bfloat16"),
    ("laplacian_2d(16) - 1.37 I", None),
])
def test_ldlt_solve_reaches_1e10(name, upd):
    A = (_poisson_shifted() if name.startswith("poisson")
         else _shifted(laplacian_2d(16), 1.37))
    s = _solver(A, update_dtype=upd)
    x = s.solve(A.to_scipy() @ np.ones(A.n))
    assert s.report.residual <= 1e-10
    assert np.abs(x - 1).max() <= 1e-6
    assert s.report.static_pivots == 0
    assert s.factors.d.shape == (s.layout.nbc, T)


def test_reference_factors_through_port_solve(case, factored):
    s, _ = case
    (pool, d, npiv), _ = factored
    s.factors = factors_from_jax(JFactors(JF.LDLT, s.layout, pool, None, d,
                                          int(npiv)), "cpu")
    A = _poisson_shifted()
    b = A.to_scipy() @ np.random.default_rng(4).standard_normal(A.n)
    x = s.solve(b)
    assert s.report.residual <= 1e-10
    assert np.linalg.norm(b - A.to_scipy() @ x) <= 1e-10 * np.linalg.norm(b)


def test_ldlt_schur_path():
    """Schur = the plane z = NX-1 of the shift-invert matrix: the residue
    goes through K3's scaled variant; S is symmetric."""
    A = _poisson_shifted()
    schur = np.arange(A.n - NX * NX, A.n)
    s = _solver(A)
    s.set_schur_unknowns(schur)
    b = A.to_scipy() @ np.ones(A.n)
    x = s.solve_with_schur(b)
    assert s.report.residual <= 1e-10
    assert np.abs(x - 1).max() <= 1e-6
    M = A.to_scipy().toarray()
    rest = np.setdiff1d(np.arange(A.n), schur)
    S_ref = M[np.ix_(schur, schur)] - M[np.ix_(schur, rest)] @ np.linalg.solve(
        M[np.ix_(rest, rest)], M[np.ix_(rest, schur)])
    S = s.get_schur()
    np.testing.assert_array_equal(S, S.T)
    assert np.abs(S - S_ref).max() <= 1e-5 * np.abs(S_ref).max()
    assert any(c.pair_k is not None for lv in s._fact_fn.levels
               for c in lv.schur)
