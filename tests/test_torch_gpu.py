"""The CUDA kernels against their plain twins on the card (marker ``gpu``).

These need a CUDA device and skip without one.  On a GPU machine without
JAX, run them without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: K1, K3, K5, K6, K9, K10, K11 and K12 max|kernel - twin| <=
1e-4 max|twin| over the touched tiles, K2 <= 1e-5 max|twin| (summation order
only), K4 <= 1e-5 max|twin| with equal clamp counts, K7 and K8 <= 1e-5
max|twin| (a right-looking loop against a left-looking one), K13 <=
1e-5 max|twin| (exact copies, summed in another order); the end-to-end
solves to a residual of 1e-10.
"""

import numpy as np
import pytest
import torch

import scipy.sparse as sp

from pastix_tpu_torch.config import Factorization, PastixConfig
from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d
from pastix_tpu_torch.sparse import SparseMatrix

import pastix_tpu_torch.numeric.block as BK
import pastix_tpu_torch.numeric.cache as CA
import pastix_tpu_torch.numeric.chol_inv as CI
import pastix_tpu_torch.numeric.dma_probe as DP
import pastix_tpu_torch.numeric.fused as FU
import pastix_tpu_torch.numeric.leftlook as LL
import pastix_tpu_torch.numeric.pipelined as PL
import pastix_tpu_torch.numeric.slab as SB
import pastix_tpu_torch.numeric.sweep_kernels as SW
import pastix_tpu_torch.numeric.tile_factor as TF
from pastix_tpu_torch.pastix import Pastix

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

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


def _rl_level(T, dev, kind=Factorization.LLT, nx=10):
    """A factored solver (LDLᵗ: its d) and its level with the most
    right-looking pairs."""
    if kind == Factorization.LLT:
        s = Pastix(poisson_3d(nx), PastixConfig(tile_size=T), device=dev)
    else:
        _, s = _kind_solver(kind, T, dev, nx=nx)
    s.factorize()
    lv = max(s.layout.levels, key=lambda lv: lv.gemm_a.size)
    return s, lv


def _close_dst(got, ref, dst):
    scale = float(ref[dst.unique()].abs().max())
    assert float((got - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("upd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("form", ["xab", "compact", "ab_pack"])
@pytest.mark.parametrize("kind", [Factorization.LLT, Factorization.LDLT,
                                  Factorization.LU],
                         ids=["plain", "d", "src_pool"])
def test_k3_operand_arrays_match_twin(cuda, T, upd, form, kind):
    """K3 reading its operands from arrays: the panel stream of the
    busiest level (xab; LU the (L, Uᵗ) pair), per-chunk gathers
    (compact) or stacked pairs (ab_pack), in chunks of 7 pairs."""
    s, lv = _rl_level(T, cuda, kind)
    f = s.factors
    gk = lv.gemm_k if kind == Factorization.LDLT else None
    plan = PL.pipeline_plan(PL.build_pipeline_schedule(
        lv.gemm_a, lv.gemm_b, lv.gemm_d, gk=gk, group=2, chunk=7,
        ext_tiles=lv.trsm_panel if form == "xab" else None), cuda)
    kw = {"d": f.d} if kind == Factorization.LDLT else {}
    if kind == Factorization.LU:
        kw["src_pool"] = f.pool_u
    if form == "xab":
        tp = torch.as_tensor(lv.trsm_panel, device=cuda).long()
        xl = f.pool[tp].to(upd).contiguous()
        kw["xab"] = ((xl, f.pool_u[tp].to(upd).contiguous())
                     if kind == Factorization.LU else xl)
    else:
        kw[form] = True
    before = PL.gemm_scatter_pipelined.launches
    got = PL.gemm_scatter_pipelined(f.pool.clone(), plan, upd, **kw)
    assert PL.gemm_scatter_pipelined.launches == before + len(plan)
    ref = PL.gemm_scatter_pipelined_ref(f.pool.clone(), plan, upd, **kw)
    _close_e2(got, ref, plan)


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("upd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("kind", [Factorization.LLT, Factorization.LDLT],
                         ids=["plain", "d"])
def test_k5_matches_twin(cuda, T, upd, kind):
    """K5 on the busiest level's block plan with every entry kept (gate
    100) and chunks of 16 entries."""
    s, lv = _rl_level(T, cuda, kind, nx=12)
    lay, f = s.layout, s.factors
    bp = BK.build_block_plan(lv.gemm_a, lv.gemm_b, lv.gemm_d, lv.gemm_k,
                             lay.blk_row, lay.blk_col, lay.keys, lay.nbc,
                             lay.npool, chunk=16, gate=100.0)
    plan = BK.block_plan(bp, lay.blk_row, cuda)
    assert plan and bp.n_block_pairs == lv.gemm_a.size
    kw = {"d": f.d} if kind == Factorization.LDLT else {}
    before = BK.gemm_scatter_block.launches
    got = BK.gemm_scatter_block(f.pool.clone(), plan, upd, **kw)
    assert BK.gemm_scatter_block.launches == before + len(plan)
    ref = BK.gemm_scatter_block_ref(f.pool.clone(), plan, upd, **kw)
    _close_dst(got, ref, torch.cat([c.pairs()[2] for c in plan]))


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("upd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("kind", [Factorization.LLT, Factorization.LDLT],
                         ids=["plain", "d"])
def test_k6_matches_twin(cuda, T, upd, kind, monkeypatch):
    """K6 on the busiest level's slab plan (C=4, H=8, row bounds, the cost
    gate off, chunks of 64 pairs)."""
    monkeypatch.setenv("PASTIX_SLAB_GATE", "0")
    s, lv = _rl_level(T, cuda, kind, nx=12)
    lay, f = s.layout, s.factors
    doc = lay.lookup(np.arange(lay.nbc), np.arange(lay.nbc))
    sp_ = SB.build_slab_plan(lv.gemm_a, lv.gemm_b, lv.gemm_d, lv.gemm_k, doc,
                             lay.npool, C=4, H=8, G=2, min_panel=2,
                             chunk=64, rbounds=(lay.row_lo, lay.row_hi), T=T)
    plan = SB.slab_plan(sp_, T, cuda)
    assert plan and sp_.n_slab_pairs > 0
    kw = {"d": f.d} if kind == Factorization.LDLT else {}
    before = SB.gemm_scatter_slab.launches
    got = SB.gemm_scatter_slab(f.pool.clone(), plan, upd, **kw)
    assert SB.gemm_scatter_slab.launches == before + len(plan)
    ref = SB.gemm_scatter_slab_ref(f.pool.clone(), plan, upd, **kw)
    _close_dst(got, ref, torch.cat([c.seg_dst for c in plan]))


def _spd_tiles(B, T, dev, seed=0):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((B, T, T))
    S = R @ R.transpose(0, 2, 1) / T + 3 * np.eye(T)
    return torch.tensor(S, dtype=torch.float32, device=dev)


def _close(got, ref, tol):
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.parametrize("T", [32, 64, 128])
def test_k7_matches_twin(cuda, T):
    """K7 in place on a pool: garbage planted above the diagonal of the
    tiles it factors, a pad sentinel in the index, the other tiles left
    bit-identical."""
    npool, tiles = 40, [3, 17, 8, 29, 11]
    pool = torch.randn(npool, T, T, device=cuda)
    pool[tiles] = _spd_tiles(len(tiles), T, cuda) + torch.triu(
        torch.randn(len(tiles), T, T, device=cuda), 1)
    idx = torch.tensor(tiles + [npool + 5], device=cuda)
    got, ref = pool.clone(), pool.clone()
    before = CI.chol_inv_pool.launches
    dinv = CI.chol_inv_pool(got, idx)
    assert CI.chol_inv_pool.launches == before + 1
    dref = CI.chol_inv_pool_ref(ref, idx)
    _close(got[tiles], ref[tiles], 1e-5)
    _close(dinv, dref, 1e-5)
    assert not dinv[-1].any()
    rest = sorted(set(range(npool)) - set(tiles))
    assert torch.equal(got[rest], pool[rest])


@pytest.mark.parametrize("T", [32, 64, 128])
def test_k8_matches_twin(cuda, T):
    S = _spd_tiles(7, T, cuda, seed=1)
    before = CI.chol_inv.launches
    L, X = CI.chol_inv(S)
    assert CI.chol_inv.launches == before + 1
    Lr, Xr = CI.chol_inv_ref(S)
    _close(L, Lr, 1e-5)
    _close(X, Xr, 1e-5)


def test_k7_k8_refuse_other_tile_sizes(cuda):
    with pytest.raises(ValueError, match="T in"):
        CI.chol_inv_pool(torch.zeros(4, 16, 16, device=cuda),
                         torch.arange(2, device=cuda))
    with pytest.raises(ValueError, match="T in"):
        CI.chol_inv(torch.zeros(2, 16, 16, device=cuda))


def _pairs_kw(kind, f, lv):
    gk = lv.gemm_k if kind == Factorization.LDLT else None
    kw = {"d": f.d} if kind == Factorization.LDLT else {}
    if kind == Factorization.LU:
        kw["src_pool"] = f.pool_u
    return gk, kw


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("upd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("kind", [Factorization.LLT, Factorization.LDLT,
                                  Factorization.LU],
                         ids=["plain", "d", "src_pool"])
def test_k9_matches_twin(cuda, T, upd, kind):
    """K9 on the busiest right-looking level's sorted triples."""
    s, lv = _rl_level(T, cuda, kind)
    gk, kw = _pairs_kw(kind, s.factors, lv)
    plan = FU.fused_plan(*FU.sort_triples(lv.gemm_a, lv.gemm_b, lv.gemm_d,
                                          gk), device=cuda)
    pool = s.factors.pool
    before = FU.gemm_scatter_fused.launches
    got = FU.gemm_scatter_fused(pool.clone(), plan, upd, **kw)
    assert FU.gemm_scatter_fused.launches == before + len(plan)
    ref = FU.gemm_scatter_fused_ref(pool.clone(), plan, upd, **kw)
    _close_e2(got, ref, plan)


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("upd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("kind", [Factorization.LLT, Factorization.LDLT,
                                  Factorization.LU],
                         ids=["plain", "d", "src_pool"])
def test_k10_matches_twin(cuda, T, upd, kind):
    """K10 on the busiest right-looking level's group-1 schedule, in
    chunks of 7 pairs."""
    s, lv = _rl_level(T, cuda, kind)
    gk, kw = _pairs_kw(kind, s.factors, lv)
    plan = FU.blockspec_plan(PL.build_pipeline_schedule(
        lv.gemm_a, lv.gemm_b, lv.gemm_d, gk=gk, chunk=7), cuda)
    pool = s.factors.pool
    before = FU.gemm_scatter_blockspec.launches
    got = FU.gemm_scatter_blockspec(pool.clone(), plan, upd, **kw)
    assert FU.gemm_scatter_blockspec.launches == before + len(plan)
    ref = FU.gemm_scatter_blockspec_ref(pool.clone(), plan, upd, **kw)
    _close_e2(got, ref, plan)


@pytest.mark.parametrize("e2", ["left", "stream"])
def test_fused_diag_solve_on_cuda_matches_cpu(cuda, e2, monkeypatch):
    """PASTIX_FUSED_DIAG=1 on poisson_3d(12), T=32, dense tail on: K7 and
    K8 launch, no twin runs, and the solution matches the CPU's."""
    monkeypatch.setenv("PASTIX_FUSED_DIAG", "1")
    monkeypatch.setenv("PASTIX_E2_LL", "0" if e2 == "stream" else "1")
    A = poisson_3d(12)
    b = A.to_scipy() @ np.random.default_rng(4).standard_normal(A.n)
    cfg = PastixConfig(tile_size=32, update_dtype="bfloat16", dense_tail=True)
    k7, k8 = CI.chol_inv_pool.launches, CI.chol_inv.launches
    t7, t8 = CI.chol_inv_pool.twin_launches, CI.chol_inv.twin_launches
    gpu = Pastix(A, cfg, device=cuda)
    x = gpu.solve(b)
    assert gpu._fact_fn.fused_diag and gpu._fact_fn.e2 == e2
    assert CI.chol_inv_pool.launches > k7 and CI.chol_inv.launches > k8
    assert (CI.chol_inv_pool.twin_launches, CI.chol_inv.twin_launches) == (
        t7, t8)
    xc = Pastix(A, cfg, device="cpu").solve(b)
    assert gpu.report.residual <= 1e-10
    assert np.linalg.norm(x - xc) <= 1e-8 * np.linalg.norm(xc)


def _cache_level(T, dev):
    """The busiest right-looking level's pairs, its bf16 panel stream and
    the factored pool."""
    s, lv = _rl_level(T, dev)
    tp = np.asarray(lv.trsm_panel)
    xab = s.factors.pool[torch.as_tensor(tp, device=dev)].to(torch.bfloat16)
    return s.factors.pool, xab, lv, tp


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("chunk", [7, 1536])
def test_k11_matches_twin(cuda, T, chunk):
    """K11 on the level's stream schedule, group 2, in chunks that cut
    dst segments and in one."""
    pool, xab, lv, tp = _cache_level(T, cuda)
    plan = CA.vcache_plan(PL.build_pipeline_schedule(
        lv.gemm_a, lv.gemm_b, lv.gemm_d, chunk=chunk, group=2,
        ext_tiles=tp), cuda)
    before = CA.gemm_scatter_vcache.launches
    got = CA.gemm_scatter_vcache(pool.clone(), xab, plan)
    assert CA.gemm_scatter_vcache.launches == before + len(plan.chunks)
    ref = CA.gemm_scatter_vcache_ref(pool.clone(), xab, plan)
    _close_e2(got, ref, plan.chunks)


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("G", [2, 4, 8])
@pytest.mark.parametrize("variant", ["loop", "dot2"])
@pytest.mark.parametrize("chunk", [7, 1536])
def test_k12_matches_twin(cuda, T, G, variant, chunk):
    """K12 on the level's mp schedule."""
    pool, xab, lv, tp = _cache_level(T, cuda)
    plan = CA.mp_plan(CA.build_mp_schedule(
        lv.gemm_a, lv.gemm_b, lv.gemm_d, chunk, G, tp), cuda)
    before = CA.gemm_scatter_mp.launches
    got = CA.gemm_scatter_mp(pool.clone(), xab, plan, variant)
    assert CA.gemm_scatter_mp.launches == before + len(plan.chunks)
    ref = CA.gemm_scatter_mp_ref(pool.clone(), xab, plan, variant)
    _close_e2(got, ref, plan.chunks)


@pytest.mark.parametrize("rows", [128, 64, 32])
@pytest.mark.parametrize("S,D,ctas,piece", [
    (1, 1, 0, 4096), (1, 2, 0, 4096), (2, 3, 5, 4096), (4, 8, 0, 4096),
    (32, 2, 0, 4096), (1, 24, 1, 4096), (1, 2, 0, 32768), (3, 2, 7, 16384)])
def test_k13_matches_twin(cuda, rows, S, D, ctas, piece):
    """K13 on 300 tiles of (rows, 128), 37 steps, 3 repeats, one CTA per
    SM or ``ctas``, bulk copies of at most ``piece`` bytes: every row of
    the (2, D, T) accumulator."""
    rng = np.random.default_rng(rows + S)
    view = torch.as_tensor(rng.standard_normal((300, rows, 128)).astype(
        np.float32), device=cuda)
    idx = torch.as_tensor(rng.integers(0, 300 - S, (37, D)).astype(
        np.int32), device=cuda)
    before = DP.probe.launches
    got = DP.probe(view, idx, S, 3, ctas=ctas, piece=piece)
    assert DP.probe.launches == before + 1
    ref = DP.probe_ref(view, idx, S, 3)
    assert got.shape == (2, D, 128)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
