"""The fused Cholesky + inverse (kernels K7, K8 and their twin) and the
fused-diagonal LLᵗ path (``PASTIX_FUSED_DIAG``) against the JAX
reference, on the CPU.

- The twin ``kernels.chol_inv_batch`` against the reference's
  ``chol_inv_batch``, and ``chol_inv`` / ``chol_inv_pool`` (the twins of
  K8 and K7 on CPU tensors) against ``chol_inv_pallas`` /
  ``chol_inv_pool_pallas`` in interpret mode, as tests/test_pallas.py runs
  them: T in {16, 32}, SPD tiles from a seed, max|d| <= 1e-5 max|ref| (a
  left-looking loop against a right-looking one: rounding only).  The
  pool case plants garbage above the diagonal of the tiles it factors and
  pads the index with a sentinel; the tiles it does not name must stay
  bit-identical.
- The gate: the reference's values of ``PASTIX_FUSED_DIAG`` and the
  ``fused_diag=`` override; LDLᵗ and LU stay unfused.
- The factors: poisson_3d(7) at T=16, bf16 updates, the same layout for
  both packages, the port's left-looking schedule with the dense tail and
  its right-looking stream schedule, both with ``fused_diag=True``,
  against the reference's ``build_factorize_fn`` under
  ``PASTIX_FUSED_DIAG=1``: rtol 1e-4, atol 1e-5 max|ref|, as
  tests/test_torch_rightlook.py holds the unfused ones.  Each case proves
  that the fused DIAG ran: the twins of K7 and K8 launched and
  ``cholesky_ex`` ran only at levels without panels.
- ``Pastix`` under ``PASTIX_FUSED_DIAG=1`` on poisson_3d(6), T=16: the
  refined solve against the reference's under the same variable (fp64
  residual <= 1e-10, x within 1e-8), and with the last 36 unknowns as
  Schur unknowns ``get_schur`` (1e-4 max|S|, tests/test_torch_schur.py's
  tolerance) and ``solve_with_schur``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pastix_tpu.config import Factorization as JF
from pastix_tpu.config import PastixConfig as JPastixConfig
from pastix_tpu.generators import poisson_3d as j_poisson_3d
from pastix_tpu.numeric import kernels as JK
from pastix_tpu.numeric.factorize import (
    build_factorize_fn as ref_factorize_fn,
    coefinit as ref_coefinit,
)
from pastix_tpu.numeric.pallas_kernels import (
    chol_inv_pallas, chol_inv_pool_pallas,
)
from pastix_tpu.pastix import Pastix as JPastix

from pastix_tpu_torch.config import Factorization, PastixConfig
from pastix_tpu_torch.generators import poisson_3d
from pastix_tpu_torch.numeric import chol_inv as CI
from pastix_tpu_torch.numeric import factorize as F
from pastix_tpu_torch.numeric import kernels as K
from pastix_tpu_torch.pastix import Pastix

from torch_common import no_calibration  # noqa: F401 (autouse)

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

TOL = 1e-5
BF16 = torch.bfloat16


def _spd(rng, B, T):
    R = rng.standard_normal((B, T, T))
    S = R @ R.transpose(0, 2, 1) / T + 3 * np.eye(T)
    return S.astype(np.float32)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("T", [16, 32])
def test_chol_inv_batch_matches_reference(T):
    rng = np.random.default_rng(T)
    S = _spd(rng, 5, T)
    # garbage above the diagonal: both read the lower triangle only
    G = S + np.triu(rng.standard_normal(S.shape), 1).astype(np.float32)
    L, X = K.chol_inv_batch(torch.from_numpy(G))
    Lr, Xr = JK.chol_inv_batch(jnp.tril(jnp.asarray(G)))
    _close(L, Lr)
    _close(X, Xr)
    assert not np.triu(L.numpy(), 1).any() and not np.triu(X.numpy(), 1).any()


@pytest.mark.parametrize("T", [16, 32])
def test_chol_inv_matches_pallas(T):
    S = _spd(np.random.default_rng(T + 1), 5, T)
    n0 = CI.chol_inv.twin_launches
    L, X = CI.chol_inv(torch.from_numpy(S))
    assert CI.chol_inv.twin_launches == n0 + 1
    Lr, Xr = chol_inv_pallas(jnp.asarray(S), interpret=True, block=2)
    _close(L, Lr)
    _close(X, Xr)


@pytest.mark.parametrize("T", [16, 32])
def test_chol_inv_pool_matches_pallas(T):
    rng = np.random.default_rng(T + 2)
    npool, tiles = 10, [2, 6, 9]
    pool = rng.standard_normal((npool, T, T)).astype(np.float32)
    S = _spd(rng, len(tiles), T)
    for k, i in enumerate(tiles):
        pool[i] = np.tril(S[k]) + np.triu(
            rng.standard_normal((T, T)).astype(np.float32), 1)
    idx = np.asarray(tiles + [npool + 7], np.int32)  # one pad sentinel
    p2, dinv = chol_inv_pool_pallas(jnp.asarray(pool), idx, interpret=True,
                                    block=4)
    p2, dinv = np.asarray(p2), np.asarray(dinv)
    got = torch.from_numpy(pool.copy())
    n0 = CI.chol_inv_pool.twin_launches
    gdinv = CI.chol_inv_pool(got, idx).numpy()
    assert CI.chol_inv_pool.twin_launches == n0 + 1
    got = got.numpy()
    assert gdinv.shape == (len(idx), T, T)
    for k, i in enumerate(tiles):
        _close(got[i], p2[i])
        _close(got[i], np.linalg.cholesky(S[k].astype(np.float64)))
        _close(gdinv[k], dinv[k])
    assert not gdinv[-1].any()  # the sentinel: no tile, zero inverse
    for i in sorted(set(range(npool)) - set(tiles)):
        np.testing.assert_array_equal(got[i], pool[i])


LLT, LDLT, LU = Factorization.LLT, Factorization.LDLT, Factorization.LU


@pytest.mark.parametrize("value,want", [
    (None, False), ("0", False), ("1", True), ("unroll", True),
    ("scan", True)])
def test_gate_follows_the_reference(value, want, monkeypatch):
    if value is None:
        monkeypatch.delenv("PASTIX_FUSED_DIAG", raising=False)
    else:
        monkeypatch.setenv("PASTIX_FUSED_DIAG", value)
    assert F.fused_diag_gate(LLT) is want
    assert F.fused_diag_gate(LDLT) is False
    assert F.fused_diag_gate(LU) is False
    assert F.fused_diag_gate(LLT, fused_diag=not want) is (not want)


def test_gate_is_llt_only():
    for kind in (LDLT, LU):
        with pytest.raises(ValueError, match="LLᵗ only"):
            F.fused_diag_gate(kind, fused_diag=True)
        assert F.fused_diag_gate(kind, fused_diag=False) is False


@pytest.fixture(scope="module")
def reference():
    """The port's solver on poisson_3d(7), T=16, dense tail on, its
    coefinit pool, and the reference's factors under
    PASTIX_FUSED_DIAG=1."""
    s = Pastix(poisson_3d(7), PastixConfig(tile_size=16, dense_tail=True),
               device="cpu")
    s.analyze()
    assert s._dense_tail is not None
    pool, _ = ref_coefinit(s.layout, s._A_perm)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PASTIX_FUSED_DIAG", "1")
        rf = ref_factorize_fn(s.layout, JF.LLT, update_dtype=jnp.bfloat16,
                              use_pallas=False, dense_tail=s._dense_tail)
        ref = np.asarray(rf(jnp.asarray(pool)))
    return s, pool, ref


@pytest.mark.parametrize("e2", ["left", "stream"])
def test_factors_match_reference(reference, e2, monkeypatch):
    s, pool, ref = reference
    calls = []
    potrf = F.potrf_batch
    monkeypatch.setattr(F, "potrf_batch",
                        lambda t: calls.append(t.shape[0]) or potrf(t))
    n7, n8 = CI.chol_inv_pool.twin_launches, CI.chol_inv.twin_launches
    fn = F.build_factorize_fn(s.layout, "cpu", LLT, BF16,
                              dense_tail=s._dense_tail, e2=e2,
                              fused_diag=True)
    got = fn(torch.from_numpy(pool.copy())).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    assert fn.fused_diag and fn.e2 == e2
    with_panels = sum(lv.tp.numel() > 0 for lv in fn.levels)
    without = [lv.diag.numel() for lv in fn.levels if not lv.tp.numel()]
    assert CI.chol_inv_pool.twin_launches - n7 == with_panels > 0
    assert CI.chol_inv.twin_launches - n8 == s._dense_tail.q
    assert calls == without  # cholesky_ex only where no panel needs dinv


def test_pastix_solve_matches_reference(monkeypatch):
    monkeypatch.setenv("PASTIX_FUSED_DIAG", "1")
    A = poisson_3d(6)
    b = A.to_scipy() @ np.random.default_rng(3).standard_normal(A.n)
    s = Pastix(A, PastixConfig(tile_size=16, update_dtype="bfloat16"),
               device="cpu")
    n7 = CI.chol_inv_pool.twin_launches
    x = s.solve(b)
    assert s._fact_fn.fused_diag and CI.chol_inv_pool.twin_launches > n7
    ref = JPastix(j_poisson_3d(6), JPastixConfig(tile_size=16,
                                                 update_dtype="bfloat16"))
    x_ref = ref.solve(b)
    assert s.report.residual <= 1e-10
    assert np.linalg.norm(b - A.to_scipy() @ x) <= 1e-10 * np.linalg.norm(b)
    assert np.abs(x - x_ref).max() <= 1e-8 * np.abs(x_ref).max()


def test_schur_matches_reference(monkeypatch):
    monkeypatch.setenv("PASTIX_FUSED_DIAG", "1")
    A = poisson_3d(6)
    schur = np.arange(A.n - 36, A.n)
    b = A.to_scipy() @ np.random.default_rng(4).standard_normal(A.n)
    s = Pastix(A, PastixConfig(tile_size=16), device="cpu")
    s.set_schur_unknowns(schur)
    n7 = CI.chol_inv_pool.twin_launches
    S = s.get_schur()
    assert s._fact_fn.fused_diag and CI.chol_inv_pool.twin_launches > n7
    ref = JPastix(j_poisson_3d(6), JPastixConfig(tile_size=16))
    ref.set_schur_unknowns(schur)
    x_ref = ref.solve_with_schur(b)
    S_ref = ref.get_schur()
    assert np.abs(S - S_ref).max() <= 1e-4 * np.abs(S_ref).max()
    x = s.solve_with_schur(b)
    assert np.linalg.norm(b - A.to_scipy() @ x) <= 1e-10 * np.linalg.norm(b)
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-8 * np.abs(x).max())
