"""The CUDA kernels against their plain twins on the card (marker ``gpu``).

These need a CUDA device and skip without one.  On a GPU machine without
JAX, run them without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: K1, K3, K5, K6, K9, K10, K11 and K12 max|kernel - twin| <=
1e-4 max|twin| over the touched tiles, K2 <= 1e-5 max|twin| (summation order
only; K1 and K2 also repeat bit for bit), K4 <= 1e-5 max|twin| with equal clamp counts, K7 and K8 <= 1e-5
max|twin| (a right-looking loop against a left-looking one), K13 <=
1e-5 max|twin| (exact copies, summed in another order); the end-to-end
solves to a residual of 1e-10.
"""

import dataclasses

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
    assert torch.equal(got, LL.gemm_scatter_ll(pool.clone(), plan, upd))
    ref = LL.gemm_scatter_ll_ref(pool.clone(), plan, upd)
    touched = torch.cat([c.seg_dst for c in plan]).unique()
    scale = float(ref[touched].abs().max())
    assert float((got - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("mode", ["bcache", "full"])
@pytest.mark.parametrize("variant", ["plain", "d", "src_pool"])
def test_k1_segments_and_row_windows(cuda, T, mode, variant):
    """K1's bf16 kernel on random tiles: 299 dst tiles of 2 pairs (whole
    tiles a CTA at T = 128) and one of 250 pairs (cut into 32 pieces
    whose sums the last one adds; alone, on 128 x 64 halves at T = 128),
    with row windows whose rl and H are off the 16-row grid (H = T, T-3,
    17, 5, 1); two runs bit-identical."""
    rng = np.random.default_rng(T)
    nsrc, ndst = 96, 300
    tiles = lambda n: torch.tensor(rng.standard_normal((n, T, T)),
                                   dtype=torch.float32, device=cuda)
    pool = tiles(nsrc + ndst)
    gd = np.r_[np.repeat(np.arange(nsrc, nsrc + ndst - 1), 2),
               np.full(250, nsrc + ndst - 1)]
    ga, gb = (rng.integers(0, nsrc, gd.size) for _ in range(2))
    gk = rng.integers(0, 40, gd.size) if variant == "d" else None
    kw = {"d": torch.tensor(rng.uniform(0.5, 2.0, (40, T)),
                            dtype=torch.float32, device=cuda)
          } if variant == "d" else {}
    if variant == "src_pool":
        kw["src_pool"] = tiles(nsrc + ndst)
    plans = [LL.ll_plan(LL.build_ll_schedule(
        ga[sl], gb[sl], gd[sl], gk=None if gk is None else gk[sl],
        cap=1024, mode=mode, T=T), cuda)
        for sl in (slice(None), slice(-250, None))]
    assert [sum(c.nseg for c in p) for p in plans] == [ndst, 1]
    assert [sum(c.nslot for c in p) for p in plans] == [32, 32]
    halves = LL.gemm_scatter_ll.half_launches
    for plan in plans:
        for H in (T, T - 3, 17, 5, 1):
            p = [dataclasses.replace(c, H=H, rl=torch.as_tensor(
                rng.integers(0, T - H + 1, c.n_pairs), device=cuda))
                for c in plan]
            got = LL.gemm_scatter_ll(pool.clone(), p, torch.bfloat16, **kw)
            assert torch.equal(got, LL.gemm_scatter_ll(
                pool.clone(), p, torch.bfloat16, **kw))
            _close_e2(got, LL.gemm_scatter_ll_ref(
                pool.clone(), p, torch.bfloat16, **kw), p)
    # the lone segment runs on halves at T = 128, the 300 on whole tiles
    assert LL.gemm_scatter_ll.half_launches - halves == (
        10 if T == 128 else 0)


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("R", [1, 3, 6])
def test_k2_matches_twin(cuda, T, R):
    """One launch a direction, bit-identical runs, against the twin."""
    s = _factored(T, cuda)
    lay, f = s.layout, s.factors
    y2 = torch.randn(lay.nbc * R, lay.T, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(R))
    got, again, ref = y2.clone(), y2.clone(), y2.clone()
    for key in ("fwd", "bwd"):
        before = SW.run_sweep.launches
        SW.run_sweep(f.pool, f.dinv, got, s._solve_fn.plan, key)
        assert SW.run_sweep.launches == before + 1
        SW.run_sweep(f.pool, f.dinv, again, s._solve_fn.plan, key)
        SW.run_sweep_ref(f.pool, f.dinv, ref, s._solve_fn.plan, key)
    assert torch.equal(got, again)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("T", [32, 128])
@pytest.mark.parametrize("R", [1, 3])
def test_k2_one_dst_of_hundreds_of_ops(cuda, T, R):
    """A synthetic sweep: 300 columns, then 600 ops into column 300 in
    one phase (150 sub-segments), then its diagonal; both directions'
    transposes, one launch each, bit-identical runs, against the twin."""
    rng = np.random.default_rng(T + R)
    m, nbc = 300, 301
    ops = 2 * m
    phases = [("diag", np.arange(m)),
              ("upd", rng.integers(0, 50, ops), np.repeat(np.arange(m), 2),
               np.full(ops, m)),
              ("diag", np.array([m]))]
    tabs = SW.sweep_direction(phases, nbc, cuda)
    plan = {"nbc": nbc, "T": T, "fwd": tabs[0], "bwd": tabs[0],
            "items": {"fwd": tabs[1], "bwd": tabs[1]}}
    assert int(tabs[1].item[-1, 3] - tabs[1].item[-1, 2]) == ops // 4
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    pool = f32(rng.standard_normal((50, T, T)) / (T * ops) ** 0.5)
    dinv = f32(np.eye(T) + 0.1 * rng.standard_normal((nbc, T, T)) / T)
    y2 = f32(rng.standard_normal((nbc * R, T)))
    for key in ("fwd", "bwd"):
        got, again, ref = y2.clone(), y2.clone(), y2.clone()
        before = SW.run_sweep.launches
        SW.run_sweep(pool, dinv, got, plan, key)
        assert SW.run_sweep.launches == before + 1
        SW.run_sweep(pool, dinv, again, plan, key)
        SW.run_sweep_ref(pool, dinv, ref, plan, key)
        assert torch.equal(got, again)
        assert float((got - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())


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


def _planted_k3(T, dev, variant, seed=0):
    """A K3 pool and plan on random tiles: 100 dst tiles of 3 pairs
    beside one of 200, in one chunk, so the long segment is cut into
    pieces (the last adds their sums).  ``variant``: ``"plain"``, ``"d"``
    (pivots d and each pair's column gk) or ``"src_pool"`` (a second
    pool).  Returns (pool, plan, kw)."""
    rng = np.random.default_rng(seed)
    nsrc, ndst = 64, 101
    tiles = lambda n: torch.tensor(rng.standard_normal((n, T, T)),
                                   dtype=torch.float32, device=dev)
    pool = tiles(nsrc + ndst)
    gd = np.r_[np.repeat(np.arange(nsrc, nsrc + ndst - 1), 3),
               np.full(200, nsrc + ndst - 1)]
    ga, gb = (rng.integers(0, nsrc, gd.size) for _ in range(2))
    gk = rng.integers(0, 40, gd.size) if variant == "d" else None
    kw = {}
    if variant == "d":
        kw["d"] = torch.tensor(rng.uniform(0.5, 2.0, (40, T)),
                               dtype=torch.float32, device=dev)
    elif variant == "src_pool":
        kw["src_pool"] = tiles(nsrc + ndst)
    plan = PL.pipeline_plan(PL.build_pipeline_schedule(
        ga, gb, gd, gk=gk, chunk=gd.size), dev)
    assert len(plan) == 1 and plan[0].nseg == ndst and plan[0].nslot > 1
    return pool, plan, kw


def _k3_twice(pool, plan, upd, **kw):
    """K3 on a copy of ``pool``, its launches counted, and again on
    another copy: the two runs must be bit-identical.  Returns the
    first."""
    before = PL.gemm_scatter_pipelined.launches
    got = PL.gemm_scatter_pipelined(pool.clone(), plan, upd, **kw)
    assert PL.gemm_scatter_pipelined.launches == before + len(plan)
    assert torch.equal(got, PL.gemm_scatter_pipelined(pool.clone(), plan,
                                                      upd, **kw))
    return got


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("upd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", ["schur", "planted"])
def test_k3_matches_twin(cuda, T, upd, case):
    """``schur``: every Schur-residue update of the factored pool in one
    list (each Schur tile then has many pairs), cut into chunks of 7
    pairs so that dst segments straddle chunk boundaries; ``planted``: a
    segment of 200 pairs beside segments of 3 (:func:`_planted_k3`).
    Two runs bit-identical."""
    if case == "planted":
        pool, plan, _ = _planted_k3(T, cuda, "plain")
    else:
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
    got = _k3_twice(pool, plan, upd)
    _close_e2(got, PL.gemm_scatter_pipelined_ref(pool.clone(), plan, upd),
              plan)


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


@pytest.mark.parametrize("T", [32, 64, 128])
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
        assert torch.equal(got, LL.gemm_scatter_ll(pool.clone(), plan, upd,
                                                   **kw))
        _close_e2(got, LL.gemm_scatter_ll_ref(pool.clone(), plan, upd, **kw),
                  plan)


@pytest.mark.parametrize("T", [32, 128])
@pytest.mark.parametrize("upd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("kind", [Factorization.LDLT, Factorization.LU],
                         ids=["d", "src_pool"])
def test_k3_variants_match_twin(cuda, T, upd, kind):
    """K3 scaled and cross-pool on every Schur-residue update of a
    factored Schur solver, in chunks of 7 pairs, and on a planted
    200-pair segment beside segments of 3 (:func:`_planted_k3`); two
    runs bit-identical."""
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
    plans = [(pool, PL.pipeline_plan(PL.build_pipeline_schedule(
        a, b, dd, gk=k, group=2, chunk=7), cuda), kw)
        for pool, a, b, dd, k, kw in runs
        if a.size]  # none when no off-diagonal Schur target at this size
    plans.append(_planted_k3(T, cuda, "d" if kind == Factorization.LDLT
                             else "src_pool"))
    for pool, plan, kw in plans:
        got = _k3_twice(pool, plan, upd, **kw)
        _close_e2(got, PL.gemm_scatter_pipelined_ref(pool.clone(), plan, upd,
                                                     **kw), plan)


def _k4_tiles(T, lu, case, dev):
    """(pool, diag, expected clamps) for K4: random diagonally dominant
    tiles with zero pivots planted by a zero row and column, which stay
    exactly zero through the updates, so each clamps once.  ``gather``:
    40 tiles, planted in tile 3 at 0 and tile 7 at 9, 33 of them
    gathered by pool index; ``planted``: 6 tiles as chip_smoke.py's
    planted_tiles, tile 0 at 0, tile 1 at 0 and 5, tile 2 at T - 1, and
    either side of the first block step, tile 3 at 31 and tile 4 at 32
    (T > 32), all factored."""
    rng = np.random.default_rng(T)
    n = 40 if case == "gather" else 6
    R = rng.standard_normal((n, T, T))
    M = R + (0 if lu else R.transpose(0, 2, 1)) + 2 * T * np.eye(T)
    if case == "gather":
        planted = ((3, 0), (7, 9))
        diag = rng.permutation(n)[:33]
    else:
        planted = ((0, 0), (1, 0), (1, 5), (2, T - 1), (3, 31)) + (
            ((4, 32),) if T > 32 else ())
        diag = np.arange(n)
    for t, k in planted:
        M[t, k, :] = M[t, :, k] = 0.0
    expect = sum(t in diag.tolist() for t, _ in planted)
    return (torch.tensor(M, dtype=torch.float32, device=dev),
            torch.tensor(diag, device=dev), expect)


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("lu", [True, False], ids=["lu", "ldlt"])
@pytest.mark.parametrize("case", ["gather", "planted"])
def test_k4_matches_twin(cuda, T, lu, case):
    """K4 against its twin with planted zero pivots (:func:`_k4_tiles`):
    the expected clamp counts, max|d| <= 1e-5 max|ref| on the tiles and
    on d, and a second run bit-identical to the first."""
    pool, diag, expect = _k4_tiles(T, lu, case, cuda)
    eps = 1e-6

    def run(fn):
        out, npiv = pool.clone(), torch.zeros((), dtype=torch.int32,
                                              device=cuda)
        d = fn(out, diag, eps, npiv, lu)
        return out, d, int(npiv)

    before = TF.tile_factor.launches
    got, d_got, n_got = run(TF.tile_factor)
    assert TF.tile_factor.launches == before + 1
    again, d_again, n_again = run(TF.tile_factor)
    assert torch.equal(got, again) and n_again == n_got
    assert lu or torch.equal(d_got, d_again)
    ref, d_ref, n_ref = run(TF.tile_factor_ref)
    assert n_got == n_ref == expect
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
    got, again, ref = y2.clone(), y2.clone(), y2.clone()
    plan = s._solve_fn.plan
    before = SW.run_sweep.launches
    SW.run_sweep(f.pool, f.dinv, got, plan, "fwd")
    SW.run_sweep(f.pool_u, f.dinv_u, got, plan, "bwd", lu=True)
    assert SW.run_sweep.launches == before + 2
    SW.run_sweep(f.pool, f.dinv, again, plan, "fwd")
    SW.run_sweep(f.pool_u, f.dinv_u, again, plan, "bwd", lu=True)
    assert torch.equal(got, again)
    SW.run_sweep_ref(f.pool, f.dinv, ref, plan, "fwd")
    SW.run_sweep_ref(f.pool_u, f.dinv_u, ref, plan, "bwd", lu=True)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("kind", [Factorization.LLT, Factorization.LU])
def test_k2_many_rhs_match_twin(cuda, kind):
    """R = 512 at T = 128 (128 passes of 4 right-hand sides; K2's shared
    memory does not grow with R): forward, then backward (LU: Uᵗ pool,
    untransposed diagonal), one launch a direction, bit-identical runs,
    against the twin."""
    R = 512
    lu = kind == Factorization.LU
    if lu:
        _, s = _kind_solver(kind, 128, cuda)
        s.factorize()
    else:
        s = _factored(128, cuda)
    lay, f, plan = s.layout, s.factors, s._solve_fn.plan
    sides = ((f.pool, f.dinv, False),
             (f.pool_u, f.dinv_u, True) if lu else (f.pool, f.dinv, False))
    y2 = torch.randn(lay.nbc * R, lay.T, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(R))
    got, again, ref = y2.clone(), y2.clone(), y2.clone()
    for key, (pool, dinv, lu_side) in zip(("fwd", "bwd"), sides):
        before = SW.run_sweep.launches
        SW.run_sweep(pool, dinv, got, plan, key, lu_side)
        assert SW.run_sweep.launches == before + 1
        SW.run_sweep(pool, dinv, again, plan, key, lu_side)
        SW.run_sweep_ref(pool, dinv, ref, plan, key, lu_side)
        assert torch.equal(got, again)
        assert float((got - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())


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
    (compact) or stacked pairs (ab_pack), in chunks of 7 pairs; with
    ``d`` and bf16 arrays a is round(round(a) d).  Two runs
    bit-identical."""
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
    got = _k3_twice(f.pool, plan, upd, **kw)
    ref = PL.gemm_scatter_pipelined_ref(f.pool.clone(), plan, upd, **kw)
    _close_e2(got, ref, plan)


def _planted_block(T, dev, seed=0):
    """A K5 pool and plan on random tiles: one 8 x 4 dst block (its 26
    lower tiles) below 200 source panels K, each holding the 8 tiles (I,
    K) of the block's rows; panels 0..191 reach only the block row I =
    207, the last 8 every row.  That row's four dst segments hold 200
    pairs each and are cut into pieces; the others hold 8.  Returns
    (pool, plan, d)."""
    N, nbc = 200, 208
    keys = np.array(sorted([K * nbc + I for K in range(N)
                            for I in range(N, N + 8)]
                           + [J * nbc + I for J in range(N, N + 4)
                              for I in range(J, N + 8)]))
    tile = lambda I, J: int(np.searchsorted(keys, J * nbc + I))
    ga, gb, gd, gk = [], [], [], []
    for K in range(N):
        for I in range(N, N + 8) if K >= N - 8 else (N + 7,):
            for J in range(N, min(I, N + 3) + 1):
                ga.append(tile(I, K))
                gb.append(tile(J, K))
                gd.append(tile(I, J))
                gk.append(K)
    bp = BK.build_block_plan(np.array(ga), np.array(gb), np.array(gd),
                             np.array(gk), keys % nbc, keys // nbc, keys,
                             nbc, keys.size, gate=100.0)
    assert bp.n_block_pairs == len(ga)
    plan = BK.block_plan(bp, keys % nbc, dev)
    assert len(plan) == 1 and plan[0].nslot > 0
    rng = np.random.default_rng(seed)
    pool = torch.tensor(rng.standard_normal((keys.size, T, T)),
                        dtype=torch.float32, device=dev)
    d = torch.tensor(rng.uniform(0.5, 2.0, (nbc, T)), dtype=torch.float32,
                     device=dev)
    return pool, plan, d


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("upd", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("kind", [Factorization.LLT, Factorization.LDLT],
                         ids=["plain", "d"])
@pytest.mark.parametrize("case", ["level", "planted"])
def test_k5_matches_twin(cuda, T, upd, kind, case):
    """``level``: K5 on the busiest level's block plan with every entry
    kept (gate 100) and chunks of 16 entries; ``planted``: a block row
    whose dst segments are cut into pieces (:func:`_planted_block`).
    Two runs bit-identical."""
    if case == "planted":
        pool, plan, d = _planted_block(T, cuda)
        kw = {"d": d} if kind == Factorization.LDLT else {}
    else:
        s, lv = _rl_level(T, cuda, kind, nx=12)
        lay, f = s.layout, s.factors
        bp = BK.build_block_plan(lv.gemm_a, lv.gemm_b, lv.gemm_d, lv.gemm_k,
                                 lay.blk_row, lay.blk_col, lay.keys, lay.nbc,
                                 lay.npool, chunk=16, gate=100.0)
        plan = BK.block_plan(bp, lay.blk_row, cuda)
        assert plan and bp.n_block_pairs == lv.gemm_a.size
        pool = f.pool
        kw = {"d": f.d} if kind == Factorization.LDLT else {}
    before = BK.gemm_scatter_block.launches
    got = BK.gemm_scatter_block(pool.clone(), plan, upd, **kw)
    assert BK.gemm_scatter_block.launches == before + len(plan)
    assert torch.equal(got, BK.gemm_scatter_block(pool.clone(), plan, upd,
                                                  **kw))
    ref = BK.gemm_scatter_block_ref(pool.clone(), plan, upd, **kw)
    _close_dst(got, ref, torch.cat([c.seg_dst for c in plan]))


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


def _ill_tile(T, dev, cond=1e4, seed=2):
    """One symmetric positive definite tile of condition ``cond``: a
    random orthogonal basis with eigenvalues from 1 down to 1/cond,
    evenly in log."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((T, T)))
    M = (Q * np.logspace(0, -np.log10(cond), T)) @ Q.T
    return torch.tensor((M + M.T)[None] / 2, dtype=torch.float32, device=dev)


def _inverse_error(X, tiles):
    """(max|X - X64| / max|X64|, T u cond(L64)): X's error against the
    fp64 inverse X64 of the fp64 Cholesky factor L64 of the same fp32
    tile, and the textbook bound on it for triangular inversion in fp32
    (u = 2^-24; Higham, Accuracy and Stability of Numerical Algorithms,
    ch. 14)."""
    M = tiles[0].double().cpu()
    L64 = torch.linalg.cholesky(M)
    X64 = torch.linalg.inv(L64)
    err = float((X[0].double().cpu() - X64).abs().max() / X64.abs().max())
    return err, M.shape[0] * 2.0 ** -24 * float(torch.linalg.cond(L64))


@pytest.mark.parametrize("T", [32, 64, 128])
@pytest.mark.parametrize("case", ["batch", "one", "ill", "not_spd"])
def test_k8_matches_twin(cuda, T, case):
    """``batch``: 7 SPD tiles; ``one``: one tile (the dense tail's call);
    ``ill``: one tile of condition 1e4: L against the twin at 1e-5, and
    X against the fp64 inverse within the textbook bound T u cond(L)
    (the twin's own X is 1.4e-5 to 4.9e-5 off it there: fp32 holds such
    an inverse no closer, so two summation orders differ by more than
    1e-5); ``not_spd``: a negative pivot at row 70 % T: NaN exactly where
    the twin has it (L's columns and X's rows from the pivot on, lower
    triangles), the rest within 1e-5, zeros above the diagonals."""
    if case == "ill":
        S = _ill_tile(T, cuda)
    else:
        S = _spd_tiles(7 if case == "batch" else 1, T, cuda, seed=1)
    if case == "not_spd":
        S[0, 70 % T, 70 % T] = -5.0
    before = CI.chol_inv.launches
    L, X = CI.chol_inv(S)
    assert CI.chol_inv.launches == before + 1
    Lr, Xr = CI.chol_inv_ref(S)
    if case == "ill":
        _close(L, Lr, 1e-5)
        err, bound = _inverse_error(X, S)
        assert err <= bound
    elif case == "not_spd":
        for got, ref in ((L, Lr), (torch.tril(X), torch.tril(Xr))):
            nan = torch.isnan(ref)
            assert nan.any() and torch.equal(torch.isnan(got), nan)
            _close(got[~nan], ref[~nan], 1e-5)
        assert not torch.triu(L, 1).any() and not torch.triu(X, 1).any()
    else:
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
