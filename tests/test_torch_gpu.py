"""The CUDA kernels against their plain twins on the card (marker ``gpu``).

These need a CUDA device and skip without one.  On a GPU machine without
JAX, run them without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: K1 and K3 max|kernel - twin| <= 1e-4 max|twin| over the
touched tiles, K2 <= 1e-5 max|twin| (summation order only); the
end-to-end solves to a residual of 1e-10.
"""

import numpy as np
import pytest
import torch

from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.generators import poisson_3d

import pastix_tpu_torch.numeric.leftlook as LL
import pastix_tpu_torch.numeric.pipelined as PL
import pastix_tpu_torch.numeric.sweep_kernels as SW
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
