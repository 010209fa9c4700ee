"""ILU(k) preconditioning in the port against the JAX reference, on the
CPU: block ILU (the incomplete tile layout, factored on the route of its
dtype) and scalar ILU (host factors, no device program).

- The copied host modules: ``scalar_ilu_pattern`` and the incomplete
  layout's tables (``build_layout(incomplete=True)``) equal the
  reference's bit for bit; ``scalar_ilu_factor``'s L and U agree with
  the reference's within 1e-12 (both fp64 on the host), with equal pivot
  counts.
- Block ILU(0) and ILU(1) pools of ``Pastix(incomplete=True,
  level_of_fill=k, device="cpu")`` against the reference's
  ``build_factorize_fn`` on the same layout and values, for LLᵗ, LU and
  complex64 LLᴴ: rtol 1e-4, atol 1e-5 · max|ref| (fp32 and complex64
  pools; ``tests/test_torch_factorize.py``'s).  The report's
  ``memory_bytes``, ``nnz_l``, ``padding_waste`` and tile count equal the
  reference's analysis of the same matrix.
- Block ILU(1) under the options the reference also runs on an
  incomplete layout: every right-looking ``e2`` schedule of LLᵗ and LU
  (stream, block, slab, pair, pair+compact; bf16 updates) and the fused
  DIAG, each pool against the left-looking pools of the same layout
  (rtol 1e-4, atol 1e-5 · max|left|), each schedule shown to have run;
  Schur unknowns (``get_schur`` against the reference's, 1e-4 · max|S|,
  fp32 updates); ``fast_solve=False`` and ``device_refine=False`` solve
  to 1e-8.
- GMRES (the auto-upgrade) on the ILU(0) factors reaches 1e-8 with
  refinement steps > 0; ``as_preconditioner`` works under scipy's ``cg``
  for block and scalar ILU; an incomplete LLᵗ builds no dense tail; the
  scalar grain solves through ``solve``, ``as_preconditioner`` and
  ``factorize(values)`` with no tile layout and no device program, and
  keeps the reference's report.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pastix_tpu
from pastix_tpu.analyze import scalar_ilu as JS
from pastix_tpu.analyze.layout import build_layout as ref_build_layout
from pastix_tpu.config import Factorization as JF
from pastix_tpu.config import PastixConfig as JPastixConfig
from pastix_tpu.config import Symmetry as JSym
from pastix_tpu.numeric.factorize import (
    build_factorize_fn as ref_factorize_fn, factorize as ref_factorize,
)

from pastix_tpu_torch.analyze import scalar_ilu as S
from pastix_tpu_torch.analyze.layout import build_layout
from pastix_tpu_torch.config import (
    Factorization, PastixConfig, RefinementMethod, Symmetry,
)
from pastix_tpu_torch.generators import (
    convection_diffusion_3d, laplacian_2d, poisson_3d,
)
from pastix_tpu_torch.numeric import chol_inv as CI
from pastix_tpu_torch.numeric import factorize as F
from pastix_tpu_torch.pastix import Pastix

from torch_common import no_calibration  # noqa: F401 (autouse)

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

T = 8
_LEVEL_FIELDS = ("cols", "diag", "trsm_panel", "trsm_diag", "trsm_row",
                 "trsm_col", "gemm_a", "gemm_b", "gemm_d", "gemm_k",
                 "gemm_nondiag")


def _hermitian_2d(n_side, seed=2):
    """laplacian_2d + S + Sᴴ, S = 0.2i N(0, 1) on the strict lower
    pattern (``tests/test_complex.py``'s Hermitian construction)."""
    rng = np.random.default_rng(seed)
    L = laplacian_2d(n_side).to_scipy().astype(np.complex128)
    C = sp.tril(L, -1).tocoo()
    Z = sp.coo_matrix((0.2j * rng.standard_normal(C.nnz), (C.row, C.col)),
                      shape=L.shape).tocsc()
    return (L + Z + Z.conj().T).tocsc()


def _sci(M):
    """The scipy matrix both packages take."""
    return M if sp.issparse(M) else M.to_scipy()


def _port(M, k, grain="block", **kw):
    return Pastix(M, PastixConfig(tile_size=T, incomplete=True,
                                  level_of_fill=k, ilu_grain=grain, **kw),
                  device="cpu")


def _ref_cfg(k, grain="block", **kw):
    return JPastixConfig(tile_size=T, incomplete=True, level_of_fill=k,
                         ilu_grain=grain, **kw)


# name -> (matrix, level of fill, port config fields, reference kind,
# reference config fields)
CASES = {
    "llt-ilu0": (lambda: poisson_3d(6), 0, {}, JF.LLT, {}),
    "llt-ilu1": (lambda: poisson_3d(6), 1, {}, JF.LLT, {}),
    "lu-ilu0": (lambda: convection_diffusion_3d(6), 0,
                dict(factorization=Factorization.LU), JF.LU,
                dict(factorization=JF.LU)),
    "lu-ilu1": (lambda: convection_diffusion_3d(6), 1,
                dict(factorization=Factorization.LU), JF.LU,
                dict(factorization=JF.LU)),
    "llh-c64-ilu0": (lambda: _hermitian_2d(10), 0,
                     dict(compute_dtype="complex64",
                          symmetry=Symmetry.HERMITIAN), JF.LLT,
                     dict(compute_dtype="complex64",
                          symmetry=JSym.HERMITIAN)),
}


@pytest.fixture(scope="module", params=list(CASES))
def block(request):
    """(name, port solver factored on its incomplete layout, the
    reference's factors on that layout and values, the reference solver
    analyzed on the same matrix)."""
    build, k, kw, jkind, jkw = CASES[request.param]
    M = _sci(build())
    s = _port(M, k, **kw)
    s.factorize()
    ndt = np.dtype(s.config.compute_dtype).type
    ref_fn = ref_factorize_fn(s.layout, jkind, hermitian=s._hermitian)
    ref = ref_factorize(s.layout, s._A_perm, jkind, dtype=ndt,
                        fact_fn=ref_fn)
    js = pastix_tpu.Pastix(_sci(M), _ref_cfg(k, **jkw))
    js.analyze()
    return request.param, s, ref, js


def test_block_ilu_pools_match_reference(block):
    _, s, ref, _ = block
    f = s.factors
    for got, r in ((f.pool, ref.pool), (f.pool_u, ref.pool_u)):
        if got is None:
            continue
        r = np.asarray(r)
        np.testing.assert_allclose(got.numpy(), r, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(r).max()))
    assert f.n_static_pivots == ref.n_static_pivots


def test_block_ilu_layout_and_report_match_reference(block):
    """The incomplete layout drops tiles (fewer than the complete one's),
    builds no dense tail, and reports as the reference does."""
    _, s, _, js = block
    lay = s.layout
    assert s._dense_tail is None and s._packed_plan is None
    assert lay.row_lo is None
    full = build_layout(s._pat_perm_ext, T,
                        for_lu=s._kind == Factorization.LU)
    assert lay.npool < full.npool
    np.testing.assert_array_equal(lay.keys, js.layout.keys)
    for f in ("memory_bytes", "nnz_l", "padding_waste", "n_tiles",
              "n_levels", "dense_tail_m", "fact_flops_padded"):
        assert getattr(s.report, f) == getattr(js.report, f), f


@pytest.mark.parametrize("k,lu", [(0, False), (1, False), (1, True)],
                         ids=["ilu0", "ilu1", "ilu1-lu"])
def test_incomplete_layout_tables_bit_equal(k, lu):
    s = _port(convection_diffusion_3d(6) if lu else poisson_3d(6), k,
              factorization=Factorization.LU if lu else Factorization.LLT)
    s.symbfact()
    pat = s._pat_perm_ext
    got = build_layout(pat, T, for_lu=lu, incomplete=True, level_of_fill=k)
    ref = ref_build_layout(pat, T, for_lu=lu, incomplete=True,
                           level_of_fill=k)
    for f in ("n", "T", "nbc", "npool", "nnz_l_tiles"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("keys", "blk_row", "blk_col", "level_of_col",
              "scat_pool_flat", "scat_vals_order", "scat_pool_flat_u",
              "scat_vals_order_u", "diag_pad_flat"):
        a, b = getattr(got, f), getattr(ref, f)
        if b is None:
            assert a is None, f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.row_lo is None and ref.row_lo is None
    assert len(got.levels) == len(ref.levels)
    for g, r in zip(got.levels, ref.levels):
        for f in _LEVEL_FIELDS:
            a, b = getattr(g, f), getattr(r, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module", params=["llt", "lu"])
def scalar(request):
    """(port solver, reference solver) factored by scalar ILU(1)."""
    lu = request.param == "lu"
    M = _sci(convection_diffusion_3d(6) if lu else laplacian_2d(16))
    kw = dict(factorization=Factorization.LU) if lu else {}
    jkw = dict(factorization=JF.LU) if lu else {}
    s = _port(M, 1, "scalar", **kw)
    s.factorize()
    js = pastix_tpu.Pastix(_sci(M), _ref_cfg(1, "scalar", **jkw))
    js.factorize()
    return s, js


def test_scalar_pattern_bit_equal(scalar):
    s, js = scalar
    for k in (0, 1, 2):
        got = S.scalar_ilu_pattern(s._pat_perm_ext, k)
        ref = JS.scalar_ilu_pattern(js._pat_perm_ext, k)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_scalar_factors_match_reference(scalar):
    s, js = scalar
    f, r = s.factors, js.factors
    assert isinstance(f, S.ScalarILUFactors)
    for a, b in ((f.L, r.L), (f.U, r.U)):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_allclose(a.data, b.data, rtol=0,
                                   atol=1e-12 * np.abs(b.data).max())
    assert f.static_pivots == r.static_pivots
    for fld in ("static_pivots", "memory_terms", "nnz_l", "nnz_l_exact",
                "fact_flops"):
        assert getattr(s.report, fld) == getattr(js.report, fld), fld


def test_scalar_ilu_runs_on_the_host(scalar):
    """Scalar ILU builds no tile layout and no device program; it solves
    through solve (GMRES on the host), as_preconditioner (scipy's cg or
    gmres) and new values on the cached pattern; clean drops it all."""
    from scipy.sparse.linalg import cg, gmres

    s, _ = scalar
    lu = s._kind == Factorization.LU
    assert s.layout is None and s.analyze() is None
    assert not hasattr(s, "_fact_fn") and s._refine_fn is None
    assert s.config.refinement == RefinementMethod.GMRES
    M = s.A.to_scipy()
    b = M @ np.ones(s.A.n)
    x = s.solve(b)
    assert s.report.residual <= 1e-10 and s.report.refine_iters > 0
    assert np.abs(x - 1).max() < 1e-8
    Mop = s.as_preconditioner()
    krylov = gmres if lu else cg
    y, info = krylov(M, b, M=Mop, rtol=1e-10, maxiter=200)
    assert info == 0
    assert np.linalg.norm(b - M @ y) / np.linalg.norm(b) < 1e-9
    pat = s._scalar_ilu_pat
    s.factorize(2.0 * s.A.values)
    assert s._scalar_ilu_pat is pat
    x = s.solve(b)
    assert np.abs(x - 0.5).max() < 1e-8
    s.clean()
    assert s.factors is None and s._scalar_ilu_pat is None


def test_block_ilu_gmres_and_preconditioner():
    """Block ILU(0): GMRES (the auto-upgrade) in the device loop, with
    K2's twin as M⁻¹, reaches 1e-8 in more than one step, and the factors
    precondition scipy's cg; an incomplete LLᵗ has no dense tail even
    with ``dense_tail=True``."""
    from scipy.sparse.linalg import cg

    A = laplacian_2d(16)
    M = A.to_scipy()
    b = M @ np.ones(A.n)
    s = _port(A, 0, dense_tail=True, refinement_itermax=400)
    assert s.config.refinement == RefinementMethod.GMRES
    x = s.solve(b)
    assert s._refine_fn is not None and s._dense_tail is None
    assert s.report.dense_tail_m == 0
    assert np.linalg.norm(b - M @ x) / np.linalg.norm(b) <= 1e-8
    assert s.report.refine_iters > 0
    y, info = cg(M, b, M=s.as_preconditioner(), rtol=1e-10, maxiter=200)
    assert info == 0
    assert np.linalg.norm(b - M @ y) / np.linalg.norm(b) < 1e-9


def test_scalar_ilu_refuses_schur():
    with pytest.raises(ValueError, match="ilu_grain='block'"):
        _port(poisson_3d(4), 1, "scalar").set_schur_unknowns([0, 1])


# block ILU(1) under the other E2 schedules and the fused DIAG:
# name -> (kind, build_factorize_fn fields)
SCHEDULES = {
    "llt-stream": (Factorization.LLT, dict(e2="stream")),
    "llt-block": (Factorization.LLT, dict(e2="block")),
    "llt-slab": (Factorization.LLT, dict(e2="slab")),
    "llt-pair": (Factorization.LLT, dict(e2="pair")),
    "llt-pair+compact": (Factorization.LLT, dict(e2="pair+compact")),
    "llt-fused_diag": (Factorization.LLT, dict(e2="left", fused_diag=True)),
    "lu-stream": (Factorization.LU, dict(e2="stream")),
    "lu-pair": (Factorization.LU, dict(e2="pair")),
}


@pytest.fixture(scope="module")
def ilu1():
    """Per kind, a block ILU(1) solver factored left-looking with bf16
    updates (poisson_3d(6) LLᵗ, convection_diffusion_3d(6) LU)."""
    out = {}
    for kind, A in ((Factorization.LLT, poisson_3d(6)),
                    (Factorization.LU, convection_diffusion_3d(6))):
        s = _port(A, 1, factorization=kind, update_dtype="bfloat16")
        s.factorize()
        assert s._fact_fn.e2 == "left"
        out[kind] = s
    return out


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_block_ilu_schedules_match_left_looking(ilu1, name, monkeypatch):
    """Every schedule the reference runs on an incomplete layout runs on
    the port's, from the same tables, to the left-looking pools.  Block
    mode forces ``PASTIX_BLOCK_GATE=3`` and slab ``PASTIX_SLAB_GATE=0``:
    at the default gates no pair of these small levels pays for its
    block or slab."""
    kind, kw = SCHEDULES[name]
    s = ilu1[kind]
    monkeypatch.setenv("PASTIX_BLOCK_GATE", "3")
    monkeypatch.setenv("PASTIX_SLAB_GATE", "0")
    k7 = CI.chol_inv_pool.twin_launches
    fn = F.build_factorize_fn(s.layout, "cpu", kind, torch.bfloat16, **kw)
    f = F.factorize(s.layout, s._A_perm, s._coef_fn, fn, "cpu",
                    pivot_threshold=s.config.static_pivoting_threshold)
    assert (fn.e2, fn.compact) == F.e2_schedule(kind, torch.bfloat16,
                                                kw["e2"])
    if kw["e2"] == "block":
        assert fn.n_block_pairs > 0
    if kw["e2"] == "slab":
        assert fn.n_slab_pairs > 0
    if kw.get("fused_diag"):
        assert fn.fused_diag and CI.chol_inv_pool.twin_launches > k7
    left = s.factors
    for got, ref in ((f.pool, left.pool), (f.pool_u, left.pool_u)):
        if ref is None:
            continue
        r = ref.numpy()
        np.testing.assert_allclose(got.numpy(), r, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(r).max()))
    assert f.n_static_pivots == left.n_static_pivots


def test_block_ilu_schur_matches_reference():
    """Schur unknowns on an incomplete layout (the plane z = 5): the
    incomplete S of ``get_schur`` agrees with the reference's, on the
    same tile grid (``align_supernodes=False``: in Schur mode the port
    keeps the supernode alignment that the reference drops, and another
    grid drops other tiles)."""
    nx = 6
    A = poisson_3d(nx)
    schur = np.arange(A.n - nx * nx, A.n)
    js = pastix_tpu.Pastix(_sci(A), _ref_cfg(1, align_supernodes=False))
    js.set_schur_unknowns(schur)
    js.factorize()
    S_ref = js.get_schur()
    s = _port(A, 1, align_supernodes=False)
    s.set_schur_unknowns(schur)
    S = s.get_schur()
    np.testing.assert_array_equal(s.layout.keys, js.layout.keys)
    assert s.layout.npool < build_layout(
        s._pat_perm_ext, T, schur_first_bcol=s._schur_first_bcol).npool
    np.testing.assert_allclose(S, S_ref, rtol=0,
                               atol=1e-4 * np.abs(S_ref).max())


@pytest.mark.parametrize("kw", [dict(fast_solve=False),
                                dict(device_refine=False)],
                         ids=["fast_solve-off", "device_refine-off"])
def test_block_ilu_other_solves(kw):
    """Block ILU(1) through the per-level solve (``fast_solve=False``) and
    through the host loop (``device_refine=False``)."""
    A = poisson_3d(6)
    M = A.to_scipy()
    b = M @ np.ones(A.n)
    s = _port(A, 1, refinement_itermax=200, **kw)
    x = s.solve(b)
    assert s._refine_fn is None
    assert s.report.refine_iters > 0
    assert np.linalg.norm(b - M @ x) / np.linalg.norm(b) <= 1e-8
