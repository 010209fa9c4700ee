"""The CUDA kernels against their plain twins on the card (marker ``gpu``).

These need a CUDA device and skip without one.  On a GPU machine without
JAX, run them without the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: K1 max|kernel - twin| <= 1e-4 max|twin| over the touched
tiles, K2 <= 1e-5 max|twin| (summation order only); the end-to-end solve
to a residual of 1e-10.
"""

import numpy as np
import pytest
import torch

from pastix_tpu.config import PastixConfig
from pastix_tpu.generators import poisson_3d

import pastix_tpu_torch.numeric.leftlook as LL
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
