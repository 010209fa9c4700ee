"""The CUDA kernels against their plain twins on the card (marker ``gpu``).

These need a CUDA device and skip without one.  On a GPU machine without
JAX, run them without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: K1 and K3 max|kernel - twin| <= 1e-4 max|twin| over the
touched tiles, K2 <= 1e-5 max|twin| (summation order only), K4 <= 1e-5
max|twin| with equal clamp counts; the end-to-end solves to a residual
of 1e-10.
"""

import numpy as np
import pytest
import torch

import scipy.sparse as sp

from pastix_tpu_torch.config import Factorization, PastixConfig
from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d
from pastix_tpu_torch.sparse import SparseMatrix

import pastix_tpu_torch.numeric.leftlook as LL
import pastix_tpu_torch.numeric.pipelined as PL
import pastix_tpu_torch.numeric.sweep_kernels as SW
import pastix_tpu_torch.numeric.tile_factor as TF
from pastix_tpu_torch.pastix import Pastix

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _factored(T, dev, nx=10):
    s = Pastix(poisson_3d(nx), PastixConfig(tile_size=T), device=dev)
    s.factorize()
    return s


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("mode", ["bcache", "full"])
@pytest.mark.parametrize("upd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_k1_matches_twin(cuda, T, mode, upd):
    s = _factored(T, cuda, nx=12)
    lay = s.layout
    _, incoming, _ = LL.regroup_left(lay.levels, lay.blk_col, None)
    li = int(np.argmax([i[0].size for i in incoming]))
    ga, gb, gd = incoming[li][:3]
    sched = LL.build_ll_schedule(ga, gb, gd, cap=64, mode=mode,
                                 rb=(lay.row_lo, lay.row_hi), T=T)
    plan = LL.ll_plan(sched, cuda)
    pool = s.factors.pool
    before = LL.gemm_scatter_ll.launches
    got = LL.gemm_scatter_ll(pool.clone(), plan, upd)
    assert LL.gemm_scatter_ll.launches == before + len(plan)
    ref = LL.gemm_scatter_ll_ref(pool.clone(), plan, upd)
    touched = torch.cat([c.seg_dst for c in plan]).unique()
    scale = float(ref[touched].abs().max())
    assert float((got - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("R", [1, 3, 6])
def test_k2_matches_twin(cuda, T, R):
    s = _factored(T, cuda)
    lay, f = s.layout, s.factors
    y2 = torch.randn(lay.nbc * R, lay.T, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(R))
    got, ref = y2.clone(), y2.clone()
    for key in ("fwd", "bwd"):
        SW.run_sweep(f.pool, f.dinv, got, s._solve_fn.plan, key)
        SW.run_sweep_ref(f.pool, f.dinv, ref, s._solve_fn.plan, key)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("upd", [None, "bfloat16"])
def test_pastix_on_cuda_matches_cpu(cuda, upd):
    A = poisson_3d(12)
    b = A.to_scipy() @ np.random.default_rng(0).standard_normal(A.n)
    cfg = lambda: PastixConfig(tile_size=32, update_dtype=upd)
    gpu = Pastix(A, cfg(), device=cuda)
    x = gpu.solve(b)
    cpu = Pastix(A, cfg(), device="cpu")
    xc = cpu.solve(b)
    assert gpu.report.residual <= 1e-10
    assert np.linalg.norm(x - xc) <= 1e-8 * np.linalg.norm(xc)


def _schur_solver(T, dev, nx=10, upd="bfloat16"):
    """poisson_3d(nx) with its last plane (nx^2 dofs) as Schur unknowns."""
    A = poisson_3d(nx)
    s = Pastix(A, PastixConfig(tile_size=T, update_dtype=upd), device=dev)
    s.set_schur_unknowns(np.arange(A.n - nx * nx, A.n))
    return A, s


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("upd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_k3_matches_twin(cuda, T, upd):
    """Every Schur-residue update of the factored pool in one list (each
    Schur tile then has many pairs), cut into chunks of 7 pairs so that
    dst segments straddle chunk boundaries."""
    _, s = _schur_solver(T, cuda)
    s.factorize()
    lay = s.layout
    reduced, _, _ = LL.regroup_left(lay.levels, lay.blk_col, None)
    ga, gb, gd = (np.concatenate([getattr(r, f) for r in reduced])
                  for f in ("gemm_a", "gemm_b", "gemm_d"))
    sched = PL.build_pipeline_schedule(ga, gb, gd, group=2, chunk=7)
    plan = PL.pipeline_plan(sched, cuda)
    firsts = [int(c.seg_dst[0]) for c in plan[1:]]
    lasts = [int(c.seg_dst[-1]) for c in plan[:-1]]
    assert any(a == b for a, b in zip(firsts, lasts)), "no straddling dst"
    pool = s.factors.pool
    before = PL.gemm_scatter_pipelined.launches
    got = PL.gemm_scatter_pipelined(pool.clone(), plan, upd)
    assert PL.gemm_scatter_pipelined.launches == before + len(plan)
    ref = PL.gemm_scatter_pipelined_ref(pool.clone(), plan, upd)
    touched = torch.cat([c.seg_dst for c in plan]).unique()
    scale = float(ref[touched].abs().max())
    assert float((got - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("upd", [None, "bfloat16"])
def test_schur_on_cuda_matches_cpu(cuda, upd):
    A, gpu = _schur_solver(32, cuda, nx=12, upd=upd)
    b = A.to_scipy() @ np.random.default_rng(1).standard_normal(A.n)
    before = PL.gemm_scatter_pipelined.launches
    x = gpu.solve_with_schur(b)
    assert PL.gemm_scatter_pipelined.launches > before
    S = gpu.get_schur()
    _, cpu = _schur_solver(32, "cpu", nx=12, upd=upd)
    xc = cpu.solve_with_schur(b)
    Sc = cpu.get_schur()
    assert gpu.report.residual <= 1e-10
    assert np.linalg.norm(x - xc) <= 1e-8 * np.linalg.norm(xc)
    assert np.abs(S - Sc).max() <= 1e-4 * np.abs(Sc).max()


def _kind_solver(kind, T, dev, nx=10, upd="bfloat16", schur=False):
    """LU: convection_diffusion_3d(nx); LDLᵗ: poisson_3d(nx) - σI with σ
    halfway between its two smallest eigenvalues (one negative
    eigenvalue).  ``schur``: the last plane as Schur unknowns."""
    if kind == Factorization.LU:
        A = convection_diffusion_3d(nx)
    else:
        mu = lambda k: 2.0 - 2.0 * np.cos(k * np.pi / (nx + 1))
        sigma = (5 * mu(1) + mu(2)) / 2
        A = SparseMatrix.from_scipy(
            (poisson_3d(nx).to_scipy() - sigma * sp.eye(nx ** 3)).tocsc(),
            symmetric_storage=True)
    s = Pastix(A, PastixConfig(tile_size=T, factorization=kind,
                               update_dtype=upd), device=dev)
    if schur:
        s.set_schur_unknowns(np.arange(A.n - nx * nx, A.n))
    return A, s


def _close_e2(got, ref, plan):
    touched = torch.cat([c.seg_dst for c in plan]).unique()
    scale = float(ref[touched].abs().max())
    assert float((got - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("T", [32, 128])
@pytest.mark.parametrize("mode", ["bcache", "full"])
@pytest.mark.parametrize("upd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("kind", [Factorization.LDLT, Factorization.LU],
                         ids=["d", "src_pool"])
def test_k1_variants_match_twin(cuda, T, mode, upd, kind):
    """K1 scaled (LDLᵗ: d of the factorization, gk) and cross-pool (LU:
    b from pool_u, and the pool_u mirror with b from pool), on the
    busiest level's incoming list of a factored solver."""
    _, s = _kind_solver(kind, T, cuda, nx=12)
    s.factorize()
    lay, f = s.layout, s.factors
    _, incoming, _ = LL.regroup_left(lay.levels, lay.blk_col, None)
    li = int(np.argmax([i[0].size for i in incoming]))
    ga, gb, gd, gk, nd = incoming[li]
    rb = (lay.row_lo, lay.row_hi)
    if kind == Factorization.LDLT:
        runs = [(f.pool, LL.ll_plan(LL.build_ll_schedule(
            ga, gb, gd, gk=gk, cap=64, mode=mode, rb=rb, T=T), cuda),
            {"d": f.d})]
    else:
        runs = [(f.pool, LL.ll_plan(LL.build_ll_schedule(
            ga, gb, gd, cap=64, mode=mode, rb=rb, T=T), cuda),
            {"src_pool": f.pool_u}),
            (f.pool_u, LL.ll_plan(LL.build_ll_schedule(
                ga[nd], gb[nd], gd[nd], cap=64, mode=mode, rb=rb, T=T), cuda),
             {"src_pool": f.pool})]
    for pool, plan, kw in runs:
        if not plan:  # no off-diagonal target at this size
            continue
        before = LL.gemm_scatter_ll.launches
        got = LL.gemm_scatter_ll(pool.clone(), plan, upd, **kw)
        assert LL.gemm_scatter_ll.launches == before + len(plan)
        _close_e2(got, LL.gemm_scatter_ll_ref(pool.clone(), plan, upd, **kw),
                  plan)


@pytest.mark.parametrize("T", [32, 128])
@pytest.mark.parametrize("upd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("kind", [Factorization.LDLT, Factorization.LU],
                         ids=["d", "src_pool"])
def test_k3_variants_match_twin(cuda, T, upd, kind):
    """K3 scaled and cross-pool on every Schur-residue update of a
    factored Schur solver, in chunks of 7 pairs."""
    _, s = _kind_solver(kind, T, cuda, schur=True)
    s.factorize()
    lay, f = s.layout, s.factors
    reduced, _, _ = LL.regroup_left(lay.levels, lay.blk_col, None)
    ga, gb, gd, gk, nd = (np.concatenate([getattr(r, x) for r in reduced])
                          for x in ("gemm_a", "gemm_b", "gemm_d", "gemm_k",
                                    "gemm_nondiag"))
    if kind == Factorization.LDLT:
        runs = [(f.pool, ga, gb, gd, gk, {"d": f.d})]
    else:
        runs = [(f.pool, ga, gb, gd, None, {"src_pool": f.pool_u}),
                (f.pool_u, ga[nd], gb[nd], gd[nd], None, {"src_pool": f.pool})]
    for pool, a, b, dd, k, kw in runs:
        if not a.size:  # no off-diagonal Schur target at this size
            continue
        plan = PL.pipeline_plan(PL.build_pipeline_schedule(
            a, b, dd, gk=k, group=2, chunk=7), cuda)
        before = PL.gemm_scatter_pipelined.launches
        got = PL.gemm_scatter_pipelined(pool.clone(), plan, upd, **kw)
        assert PL.gemm_scatter_pipelined.launches == before + len(plan)
        _close_e2(got, PL.gemm_scatter_pipelined_ref(pool.clone(), plan, upd,
                                                     **kw), plan)


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("lu", [True, False], ids=["lu", "ldlt"])
def test_k4_matches_twin(cuda, T, lu):
    """K4 on random diagonally dominant tiles, two with planted zero
    pivots (zero row and column), gathered by pool index."""
    rng = np.random.default_rng(T)
    R = rng.standard_normal((40, T, T))
    M = R + (0 if lu else R.transpose(0, 2, 1)) + 2 * T * np.eye(T)
    M[3, 0, :] = M[3, :, 0] = M[7, 9, :] = M[7, :, 9] = 0.0
    pool = torch.tensor(M, dtype=torch.float32, device=cuda)
    diag = torch.tensor(rng.permutation(40)[:33], device=cuda)
    eps = 1e-6
    got, ref = pool.clone(), pool.clone()
    n_got = torch.zeros((), dtype=torch.int32, device=cuda)
    n_ref = torch.zeros((), dtype=torch.int32, device=cuda)
    before = TF.tile_factor.launches
    d_got = TF.tile_factor(got, diag, eps, n_got, lu)
    assert TF.tile_factor.launches == before + 1
    d_ref = TF.tile_factor_ref(ref, diag, eps, n_ref, lu)
    assert int(n_got) == int(n_ref) == int(3 in diag.tolist()) + int(
        7 in diag.tolist())
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    if not lu:
        assert float((d_got - d_ref).abs().max()) <= 1e-5 * float(
            d_ref.abs().max())


def test_k4_refuses_other_tile_sizes(cuda):
    pool = torch.eye(16, device=cuda).repeat(2, 1, 1)
    npiv = torch.zeros((), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="T in"):
        TF.tile_factor(pool, torch.arange(2, device=cuda), 1e-6, npiv, True)


@pytest.mark.parametrize("T", [32, 128])
@pytest.mark.parametrize("R", [1, 3])
def test_k2_lu_backward_matches_twin(cuda, T, R):
    _, s = _kind_solver(Factorization.LU, T, cuda)
    s.factorize()
    lay, f = s.layout, s.factors
    y2 = torch.randn(lay.nbc * R, lay.T, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(R))
    got, ref = y2.clone(), y2.clone()
    plan = s._solve_fn.plan
    SW.run_sweep(f.pool, f.dinv, got, plan, "fwd")
    SW.run_sweep(f.pool_u, f.dinv_u, got, plan, "bwd", lu=True)
    SW.run_sweep_ref(f.pool, f.dinv, ref, plan, "fwd")
    SW.run_sweep_ref(f.pool_u, f.dinv_u, ref, plan, "bwd", lu=True)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("kind", [Factorization.LDLT, Factorization.LU])
@pytest.mark.parametrize("schur", [False, True], ids=["solve", "schur"])
def test_kinds_on_cuda_match_cpu(cuda, kind, schur):
    """bf16 updates for LU; fp32 for the nearly singular LDLᵗ matrix, on
    which bf16 updates at T=32 stall the refinement (the reference's
    too)."""
    upd = "bfloat16" if kind == Factorization.LU else None
    A, gpu = _kind_solver(kind, 32, cuda, nx=12, upd=upd, schur=schur)
    b = A.to_scipy() @ np.random.default_rng(2).standard_normal(A.n)
    k0 = TF.tile_factor.launches
    x = gpu.solve_with_schur(b) if schur else gpu.solve(b)
    assert TF.tile_factor.launches > k0
    _, cpu = _kind_solver(kind, 32, "cpu", nx=12, upd=upd, schur=schur)
    xc = cpu.solve_with_schur(b) if schur else cpu.solve(b)
    assert gpu.report.residual <= 1e-10
    assert gpu.report.static_pivots == cpu.report.static_pivots
    assert np.linalg.norm(x - xc) <= 1e-8 * np.linalg.norm(xc)
