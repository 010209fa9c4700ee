"""The port's complex and fp64 factorizations against the JAX reference,
on the CPU: Hermitian LLᴴ (complex128 and complex64) and LDLᴴ,
complex-symmetric LLᵗ and LDLᵗ (and ``helmholtz_2d(16)``), complex LU,
and real fp64 LLᵗ, LDLᵗ and LU.

The matrices are built as ``tests/test_complex.py`` builds them
(``laplacian_2d(6-10)`` plus a skew part of 0.2, ``random_unsym(150)``
plus 0.3i |B|), and ``poisson_3d(6)`` for fp64; ``pastix_tpu.Pastix`` and
``pastix_tpu_torch.Pastix(device="cpu")`` run the same configuration at
T = 16.  Held, a configuration a case:

- the pools (the Uᵗ pool for LU), the pivots d and the static-pivot
  counts, the reference's carried across by ``convert.factors_from_jax``:
  within 1e-10 · max|ref| for complex128 and fp64, 1e-4 for complex64
  (both factor the same layout; only the order of the updates differs);
- both solutions within the reference test's 1e-8 relative error;
- refinement steps within one of the reference's;
- no hand kernel's wrapper and no twin ran (the route of a non-fp32 pool
  is torch ops, chosen in ``analyze``).

Then the tile functions against the reference's ``kernels.*`` on seeded
random tiles (complex-symmetric Cholesky, LDLᴴ, complex LU, the complex
clamp, the conjugated update in byte-capped chunks, the TRSMs), and the
other entry points (``spsolve``, ``pastix()``, ``factorize(values)``,
``as_preconditioner``, Murge, the CLI) on complex and fp64 systems.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pastix_tpu
from pastix_tpu.config import Factorization as JF
from pastix_tpu.config import PastixConfig as JPastixConfig
from pastix_tpu.config import Symmetry as JSym
from pastix_tpu.generators import (
    helmholtz_2d, laplacian_2d, poisson_3d, random_unsym,
)
from pastix_tpu.numeric import kernels as JK

import pastix_tpu_torch
from pastix_tpu_torch.cli import main as cli_main
from pastix_tpu_torch.config import Factorization, PastixConfig, Symmetry
from pastix_tpu_torch.convert import factors_from_jax
from pastix_tpu_torch.murge import MurgeSolver
from pastix_tpu_torch.numeric import kernels as K
from pastix_tpu_torch.pastix import Pastix, pastix

from torch_common import no_calibration  # noqa: F401 (autouse)

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

T = 16


def _skew(n_side, seed, conj):
    """laplacian_2d(n_side) + S + op(S), S = 0.2i N(0, 1) on the strict
    lower pattern (``tests/test_complex.py``): Hermitian with ``conj``,
    complex-symmetric without."""
    rng = np.random.default_rng(seed)
    L = laplacian_2d(n_side).to_scipy().astype(np.complex128)
    n = L.shape[0]
    C = sp.tril(L, -1).tocoo()
    S = sp.coo_matrix((0.2j * rng.standard_normal(C.nnz), (C.row, C.col)),
                      shape=(n, n)).tocsc()
    return (L + S + (S.conj().T if conj else S.T)).tocsc()


def _complex_lu():
    B = random_unsym(150, density=0.05, seed=4).to_scipy()
    return (B + 1j * 0.3 * abs(B)).tocsc()


# name -> (matrix, config fields shared by both packages)
CASES = {
    "llh-c128": (lambda: _skew(10, 0, True),
                 dict(compute_dtype="complex128", symmetry="HERMITIAN")),
    "llh-c64": (lambda: _skew(8, 2, True),
                dict(compute_dtype="complex64", symmetry="HERMITIAN")),
    "ldlh-c128": (lambda: _skew(8, 5, True),
                  dict(compute_dtype="complex128", factorization="LDLH",
                       symmetry="HERMITIAN")),
    "ldlt-csym": (lambda: _skew(8, 1, False),
                  dict(compute_dtype="complex128", factorization="LDLT")),
    "llt-csym": (lambda: _skew(6, 9, False),
                 dict(compute_dtype="complex128")),
    "ldlt-helmholtz": (lambda: helmholtz_2d(16, k=8.0).to_scipy(),
                       dict(compute_dtype="complex128",
                            factorization="LDLT")),
    "lu-c128": (_complex_lu,
                dict(compute_dtype="complex128", factorization="LU")),
    "llt-f64": (lambda: poisson_3d(6).to_scipy(),
                dict(compute_dtype="float64")),
    "ldlt-f64": (lambda: poisson_3d(6).to_scipy(),
                 dict(compute_dtype="float64", factorization="LDLT")),
    "lu-f64": (lambda: poisson_3d(6).to_scipy(),
               dict(compute_dtype="float64", factorization="LU")),
}


def _cfg(cls, fact_cls, sym_cls, fields):
    kw = dict(fields)
    if "factorization" in kw:
        kw["factorization"] = fact_cls[kw["factorization"]]
    if "symmetry" in kw:
        kw["symmetry"] = sym_cls[kw["symmetry"]]
    return cls(tile_size=T, **kw)


def counts():
    """Every hand kernel wrapper's launches and twin calls (K1-K13)."""
    from pastix_tpu_torch.numeric import (
        block, cache, chol_inv, dma_probe, fused, leftlook, pipelined, slab,
        sweep_kernels, tile_factor,
    )

    fns = (leftlook.gemm_scatter_ll, sweep_kernels.run_sweep,
           pipelined.gemm_scatter_pipelined, tile_factor.tile_factor,
           block.gemm_scatter_block, slab.gemm_scatter_slab,
           chol_inv.chol_inv_pool, chol_inv.chol_inv,
           fused.gemm_scatter_fused, fused.gemm_scatter_blockspec,
           cache.gemm_scatter_vcache, cache.gemm_scatter_mp, dma_probe.probe)
    return [(fn.launches, fn.twin_launches) for fn in fns]


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    build, fields = CASES[request.param]
    A = build()
    n = A.shape[0]
    rng = np.random.default_rng(3)
    xt = rng.standard_normal(n)
    if np.iscomplexobj(A.data):
        xt = xt + 1j * rng.standard_normal(n)
    b = A @ xt
    ref = pastix_tpu.Pastix(A, _cfg(JPastixConfig, JF, JSym, fields))
    x_ref = ref.solve(b)
    before = counts()
    port = Pastix(A, _cfg(PastixConfig, Factorization, Symmetry, fields),
                  device="cpu")
    x = port.solve(b)
    return dict(name=request.param, ref=ref, port=port, x_ref=x_ref, x=x,
                xt=xt, kernels=(before, counts()))


def _tol(port):
    return 1e-4 if port.factors.pool.dtype == torch.complex64 else 1e-10


def _close(got, want, tol):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_factors_agree(pair):
    ref, port = pair["ref"], pair["port"]
    tol = _tol(port)
    carried = factors_from_jax(ref.factors, "cpu", hermitian=ref._hermitian)
    got = port.factors
    assert got.kind == carried.kind and got.dtype == carried.dtype
    assert got.hermitian == carried.hermitian == (
        got.dtype.is_complex and port._hermitian)
    _close(got.pool, carried.pool, tol)
    for f in ("pool_u", "d"):
        assert (getattr(got, f) is None) == (getattr(carried, f) is None), f
        if getattr(got, f) is not None:
            _close(getattr(got, f), getattr(carried, f), tol)
    if got.d is not None and got.hermitian:
        assert float(got.d.imag.abs().max()) == 0.0  # LDLᴴ: real pivots
    assert got.n_static_pivots == carried.n_static_pivots
    assert port.report.static_pivots == ref.report.static_pivots
    for f in ("n_tiles", "n_levels", "dense_tail_m", "memory_bytes"):
        assert getattr(port.report, f) == getattr(ref.report, f), f


def test_solutions_meet_1e8(pair):
    xt = pair["xt"]
    for x in (pair["x"], pair["x_ref"]):
        assert np.abs(x - xt).max() / np.abs(xt).max() < 1e-8
    assert pair["port"].report.residual <= 1e-10


def test_steps_within_one(pair):
    assert abs(pair["port"].report.refine_iters
               - pair["ref"].report.refine_iters) <= 1


def test_no_hand_kernel_ran(pair):
    before, after = pair["kernels"]
    assert before == after


def test_reference_factors_through_port_solve(pair):
    """The reference's factors, carried across, through the port's
    solve: the same solution."""
    port = pair["port"]
    saved = port.factors
    try:
        port.factors = factors_from_jax(pair["ref"].factors, "cpu",
                                        hermitian=port._hermitian)
        x = port.solve(pair["ref"].A.to_scipy() @ pair["xt"])
    finally:
        port.factors = saved
    assert np.abs(x - pair["xt"]).max() / np.abs(pair["xt"]).max() < 1e-8


# ----------------------------------------------------------------------
# tile functions against the reference's
# ----------------------------------------------------------------------

B_, TT = 3, 16


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _tiles(seed, dtype, kind):
    """(B, T, T) diagonally dominant tiles: ``herm`` Hermitian positive
    definite, ``sym`` complex-symmetric, ``gen`` unsymmetric."""
    rng = np.random.default_rng(seed)
    X = _rand(rng, (B_, TT, TT), dtype)
    eye = 2 * TT * np.eye(TT)
    if kind == "herm":
        return (X @ np.conj(np.swapaxes(X, 1, 2)) + eye).astype(dtype)
    if kind == "sym":
        return (X + np.swapaxes(X, 1, 2) + eye).astype(dtype)
    return (X + eye).astype(dtype)


def _tol_dt(dtype):
    return 1e-4 if np.dtype(dtype) in (np.complex64, np.float32) else 1e-10


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_potrf_sym_batch_matches_reference(dtype):
    A = _tiles(0, dtype, "sym")
    want = np.asarray(JK.potrf_batch(jnp.tril(jnp.asarray(A)),
                                     hermitian=False))
    got = K.potrf_sym_batch(torch.from_numpy(A)).numpy()
    _close(got, want, _tol_dt(dtype))
    via = K.potrf_batch(torch.from_numpy(A), hermitian=False).numpy()
    np.testing.assert_array_equal(via, got)


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_potrf_batch_hermitian_matches_reference(dtype):
    A = _tiles(1, dtype, "herm")
    want = np.asarray(JK.potrf_batch(jnp.tril(jnp.asarray(A))))
    _close(K.potrf_batch(torch.from_numpy(np.tril(A))).numpy(), want, 1e-10)


def _planted(A, k):
    """Zero row and column ``k`` of every tile but a tiny diagonal."""
    A = A.copy()
    A[:, k, :] = 0
    A[:, :, k] = 0
    A[:, k, k] = 1e-20
    return A


@pytest.mark.parametrize("herm", [True, False], ids=["ldlh", "ldlt"])
@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_ldlt_batch_matches_reference(herm, dtype):
    """Hermitian (LDLᴴ: real pivots) or complex-symmetric tiles, with a
    planted zero pivot: the clamp counts agree."""
    A = _planted(_tiles(2, dtype, "herm" if herm else "sym"), 5)
    eps = 1e-8
    L_ref, d_ref, n_ref = (np.asarray(x) for x in JK.ldlt_batch(
        jnp.asarray(A), jnp.asarray(eps, dtype), herm))
    L, d, n = K.ldlt_batch(torch.from_numpy(np.tril(A)), eps, herm)
    _close(L.numpy(), L_ref, _tol_dt(dtype))
    _close(d.numpy(), d_ref, _tol_dt(dtype))
    assert int(n) == int(n_ref.sum()) == B_
    if herm:
        assert float(d.imag.abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64, np.float64])
def test_getrf_batch_matches_reference(dtype):
    A = _planted(_tiles(3, dtype, "gen"), 7)
    eps = 1e-8
    M_ref, n_ref = (np.asarray(x) for x in JK.getrf_batch(
        jnp.asarray(A), jnp.asarray(eps, dtype)))
    M, n = K.getrf_batch(torch.from_numpy(A), eps)
    _close(M.numpy(), M_ref, _tol_dt(dtype))
    assert int(n) == int(n_ref.sum()) == B_


def test_clamp_pivot_matches_reference():
    """Complex pivots clamp along their phase (0 to +eps), real ones by
    sign."""
    eps = 2.0 ** -10  # exact in every precision
    piv = np.array([0, 1e-5 + 1e-5j, -2e-4j, 0.5 - 0.5j, -1e-6, 3.0],
                   np.complex128)
    want, wsmall = (np.asarray(x) for x in JK._clamp_pivot(
        jnp.asarray(piv), jnp.asarray(eps)))
    got, small = K.clamp_pivot(torch.from_numpy(piv), eps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)
    np.testing.assert_array_equal(small.numpy(), wsmall)
    real = piv.real.copy()
    want, _ = JK._clamp_pivot(jnp.asarray(real), jnp.asarray(eps))
    np.testing.assert_array_equal(
        K.clamp_pivot(torch.from_numpy(real), eps)[0].numpy(),
        np.asarray(want))


@pytest.mark.parametrize("case", ["herm", "sym-scaled", "f64-bf16", "ab"])
def test_gemm_scatter_matches_reference(case, monkeypatch):
    """The update of a complex128 (fp64) pool with duplicate targets,
    against the reference's ``gemm_scatter`` (``gemm_scatter_ab``); the
    chunks cut to 7 triples by a small ``GATHER_BYTES``."""
    rng = np.random.default_rng(4)
    dt = np.float64 if case == "f64-bf16" else np.complex128
    npool, ng = 12, 40
    pool = _rand(rng, (npool, TT, TT), dt)
    pool_u = _rand(rng, (npool, TT, TT), dt)
    # sources and targets apart, as a level's are
    ga, gb = rng.integers(4, npool, ng), rng.integers(4, npool, ng)
    gd = rng.integers(0, 4, ng)
    sc = _rand(rng, (ng, TT), dt) if case == "sym-scaled" else None
    upd = case == "f64-bf16"
    monkeypatch.setattr(K, "GATHER_BYTES", 7 * 2 * TT * TT * 16)
    if case == "ab":
        want = JK.gemm_scatter_ab(jnp.asarray(pool), jnp.asarray(pool),
                                  jnp.asarray(pool_u), ga, gb, gd)
        got = K.gemm_scatter_ab(torch.from_numpy(pool.copy()),
                                torch.from_numpy(pool),
                                torch.from_numpy(pool_u), *map(
                                    torch.from_numpy, (ga, gb, gd)))
    else:
        want = JK.gemm_scatter(
            jnp.asarray(pool), ga, gb, gd,
            scale_cols=None if sc is None else jnp.asarray(sc),
            update_dtype=jnp.bfloat16 if upd else None,
            hermitian=case == "herm")
        got = K.gemm_scatter(
            torch.from_numpy(pool.copy()), *map(torch.from_numpy, (ga, gb, gd)),
            torch.bfloat16 if upd else None,
            None if sc is None else torch.from_numpy(sc),
            hermitian=case == "herm")
    _close(got.numpy(), np.asarray(want), 1e-12)


def test_gemm_scatter_complex_refuses_update_dtype():
    pool = torch.zeros((2, TT, TT), dtype=torch.complex64)
    idx = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="imaginary part"):
        K.gemm_scatter(pool, idx, idx, idx, torch.bfloat16)


@pytest.mark.parametrize("which", ["llt-herm", "llt-sym", "ldlh", "lu_l",
                                   "lu_u"])
def test_trsm_matches_reference(which):
    rng = np.random.default_rng(5)
    P = _rand(rng, (B_, TT, TT), np.complex128)
    herm = which in ("llt-herm", "ldlh")
    if which.startswith("llt"):
        D = np.array(JK.potrf_batch(jnp.tril(jnp.asarray(
            _tiles(6, np.complex128, "herm"))), hermitian=True))
        want = JK.trsm_llt(jnp.asarray(P), jnp.asarray(D), hermitian=herm)
        got = K.trsm_llt(torch.from_numpy(P), torch.from_numpy(D), herm)
    elif which == "ldlh":
        L, d, _ = JK.ldlt_batch(jnp.asarray(_tiles(6, np.complex128, "herm")),
                                jnp.asarray(1e-8, np.complex128), True)
        want = JK.trsm_ldlt(jnp.asarray(P), L, d, hermitian=True)
        got = K.trsm_ldlt(torch.from_numpy(P), torch.from_numpy(np.array(L)),
                          torch.from_numpy(np.array(d)), True)
    else:
        M, _ = JK.getrf_batch(jnp.asarray(_tiles(6, np.complex128, "gen")),
                              jnp.asarray(1e-8, np.complex128))
        f, g = ((JK.trsm_lu_l, K.trsm_lu_l) if which == "lu_l"
                else (JK.trsm_lu_u, K.trsm_lu_u))
        want = f(jnp.asarray(P), M)
        got = g(torch.from_numpy(P), torch.from_numpy(np.array(M)))
    _close(got.numpy(), np.asarray(want), 1e-12)


# ----------------------------------------------------------------------
# the other entry points
# ----------------------------------------------------------------------


def test_spsolve_and_pastix_complex():
    """``spsolve`` (Hermitian LLᴴ) and the array API ``pastix()`` (LDLᴴ
    in full storage, complex-symmetric LDLᵗ in the lower triangle)."""
    A = _skew(7, 8, True)
    xt = np.full(A.shape[0], 1.0 - 2.0j)
    x = pastix_tpu_torch.spsolve(
        A, A @ xt, device="cpu", tile_size=T, compute_dtype="complex128",
        symmetry=Symmetry.HERMITIAN)
    assert np.abs(x - xt).max() < 1e-10
    for kind, M in ((Factorization.LDLH, A),
                    (Factorization.LDLT, _skew(7, 8, False))):
        S = sp.csc_matrix(M)
        x, rep = pastix(S.shape[0], S.indptr, S.indices, S.data, S @ xt,
                        PastixConfig(tile_size=T, factorization=kind,
                                     compute_dtype="complex64"),
                        device="cpu")
        assert np.abs(x - xt).max() < 1e-8 and rep.residual <= 1e-10


def test_factorize_values_and_preconditioner_complex():
    """New complex values on the cached analysis (the diagonal raised by
    10 %, so A stays Hermitian), and M⁻¹ as a scipy operator of the
    compute dtype under scipy's GMRES."""
    from scipy.sparse.linalg import gmres

    A = _skew(7, 10, True)
    s = Pastix(A, PastixConfig(tile_size=T, compute_dtype="complex64",
                               symmetry=Symmetry.HERMITIAN), device="cpu")
    xt = np.full(A.shape[0], 0.5 + 1.0j)
    s.solve(A @ xt)
    v = s.A.values * (1.0 + 0.1 * (s.A.rowind == np.repeat(
        np.arange(s.A.n), np.diff(s.A.colptr))))
    s.factorize(v)
    A2 = s.A.to_scipy()
    x = s.solve(A2 @ xt)
    assert np.abs(x - xt).max() < 1e-9 and s.report.residual <= 1e-10
    M = s.as_preconditioner()
    assert M.dtype == np.complex64
    y, info = gmres(A2, A2 @ xt, M=M, rtol=1e-12, atol=0.0)
    assert info == 0 and np.abs(y - xt).max() < 1e-8


def test_murge_and_cli_fp64_complex(capsys):
    """Murge assembles an fp64 LDLᵗ system; the CLI solves in complex128
    (complex-symmetric LLᵗ of the real Laplacian) and in fp64 LU."""
    A = poisson_3d(5).to_scipy().tocoo()
    m = MurgeSolver(A.shape[0], PastixConfig(
        tile_size=T, factorization=Factorization.LDLT,
        compute_dtype="float64"), device="cpu")
    m.graph_begin()
    m.graph_edge(A.row, A.col)
    m.graph_end()
    m.assembly_begin()
    m.assembly_set_value(A.row, A.col, A.data)
    m.assembly_end()
    x = m.solve(A @ np.ones(A.shape[0]))
    assert np.abs(x - 1).max() < 1e-10
    for args in (["--dtype", "c128"], ["--dtype", "f64", "--fact", "lu"]):
        assert cli_main(["-lap3", "6", "--tile", "16", "--cpu", "-q",
                         "--steps", *args]) == 0
    out = capsys.readouterr().out
    assert out.count("residual ||b-Ax||/||b||") == 2


def test_refusals_name_why():
    """What still raises: a complex pool with an update dtype, complex
    and fp64 Schur, a complex RHS or matrix on a real pool, and a
    non-fp32 pool with a right-looking or fused-diagonal schedule."""
    from pastix_tpu_torch.numeric.factorize import build_factorize_fn

    A = poisson_3d(4).to_scipy()
    with pytest.raises(ValueError, match="imaginary part"):
        Pastix(A, PastixConfig(compute_dtype="complex64",
                               update_dtype="bfloat16"), device="cpu")
    with pytest.raises(ValueError, match="complex values"):
        Pastix(_skew(4, 0, True), PastixConfig(), device="cpu")
    s = Pastix(A, PastixConfig(tile_size=T), device="cpu")
    with pytest.raises(ValueError, match="complex right-hand side"):
        s.solve(np.ones(A.shape[0]) * 1j)
    s.analyze()
    for kw, match in ((dict(e2="stream"), "right-looking"),
                      (dict(fused_diag=True), "K7 and K8")):
        with pytest.raises(NotImplementedError, match=match):
            build_factorize_fn(s.layout, "cpu", Factorization.LLT,
                               dtype=torch.float64, **kw)
