"""K2's plain twin (``sweep_fwd`` + ``sweep_bwd`` on the CPU) against the
reference's Pallas ``run_sweep`` in interpret mode, on the same factored
pool, inverse diagonals and RHS (numpy, from a seed), R in {1, 3}.
poisson_3d(8), T=32: interpret mode costs about 10 ms per op on a CPU.

Tolerance: rtol=1e-5 against max|ref|; both run fp32 arithmetic and
differ in summation order only.  The LU sweeps (forward on the L pool
with the unit-lower inverses, backward on the Uᵗ pool with the upper
inverses: updates transposed, the diagonal untransposed) the same way,
on convection_diffusion_3d(5)'s LU factors at R = 2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pastix_tpu.numeric.sweep_kernels as JSW
from pastix_tpu_torch.config import Factorization, PastixConfig
from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d

import pastix_tpu_torch.numeric.sweep_kernels as SW
from pastix_tpu_torch.pastix import Pastix


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(JSW, "_INTERPRET", True)


@pytest.fixture(scope="module")
def factored():
    s = Pastix(poisson_3d(8), PastixConfig(tile_size=32), device="cpu")
    s.factorize()
    return s


@pytest.mark.parametrize("nrhs", [1, 3])
def test_twin_matches_pallas_sweeps(factored, nrhs):
    lay, f = factored.layout, factored.factors
    rng = np.random.default_rng(nrhs)
    y2 = rng.standard_normal((lay.nbc * nrhs, lay.T)).astype(np.float32)
    pool, dinv = f.pool.numpy(), f.dinv.numpy()
    # interpret mode costs per padded op: one chunk that just fits
    nops = sum(len(lv.cols) + len(lv.trsm_panel) for lv in lay.levels)
    sched = JSW.build_sweep_schedule(lay, chunk_max=-(-nops // 4) * 4)
    ref = JSW.sweep_fwd(jnp.asarray(pool), jnp.asarray(dinv),
                        jnp.asarray(y2), sched, interpret=True)
    ref = np.asarray(JSW.sweep_bwd(jnp.asarray(pool), jnp.asarray(dinv),
                                   ref, sched, interpret=True))
    plan = SW.sweep_plan(lay, "cpu")
    got = torch.from_numpy(y2.copy())
    before = SW.run_sweep.twin_launches
    SW.sweep_fwd(f.pool, f.dinv, got, plan)
    SW.sweep_bwd(f.pool, f.dinv, got, plan)
    assert SW.run_sweep.twin_launches == before + 2
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_rowvec_layout_round_trips(factored):
    lay = factored.layout
    b = torch.randn(lay.nbc, lay.T, 3, generator=torch.Generator().manual_seed(0))
    y2 = SW._to_rowvec(b)
    assert y2.shape == (lay.nbc * 3, lay.T)
    np.testing.assert_array_equal(
        y2.numpy(), np.transpose(b.numpy(), (0, 2, 1)).reshape(-1, lay.T)
    )
    assert torch.equal(SW._from_rowvec(y2, lay.nbc, lay.T), b)


def test_update_phase_sub_segments(factored):
    """Ops sorted by dst; sub-segments hold 1.._OPS_PER_CTA ops of one dst
    each and tile every dst's run in order."""
    plan = factored._solve_fn.plan
    n_upd = 0
    for key in ("fwd", "bwd"):
        for ph in plan[key]:
            if ph.kind != "upd":
                continue
            n_upd += 1
            d, sub, seg = ph.op_dst, ph.sub_ptr, ph.seg_sub_ptr
            assert bool((d[1:] >= d[:-1]).all())
            lens = sub[1:] - sub[:-1]
            assert int(lens.min()) >= 1 and int(lens.max()) <= SW._OPS_PER_CTA
            assert int(sub[0]) == 0 and int(sub[-1]) == d.numel()
            sub_dst = torch.repeat_interleave(ph.seg_dst, seg[1:] - seg[:-1])
            assert torch.equal(torch.repeat_interleave(sub_dst, lens), d)
            assert ph.seg_dst.unique().numel() == ph.seg_dst.numel()
    assert n_upd > 0


@pytest.fixture(scope="module")
def factored_lu():
    s = Pastix(convection_diffusion_3d(5),
               PastixConfig(tile_size=32, factorization=Factorization.LU),
               device="cpu")
    s.factorize()
    return s


def test_lu_twin_matches_pallas_sweeps(factored_lu, nrhs=2):
    lay, f = factored_lu.layout, factored_lu.factors
    rng = np.random.default_rng(10 + nrhs)
    y2 = rng.standard_normal((lay.nbc * nrhs, lay.T)).astype(np.float32)
    nops = sum(len(lv.cols) + len(lv.trsm_panel) for lv in lay.levels)
    sched = JSW.build_sweep_schedule(lay, chunk_max=-(-nops // 4) * 4)
    j = lambda t: jnp.asarray(t.numpy())
    ref = JSW.sweep_fwd(j(f.pool), j(f.dinv), jnp.asarray(y2), sched,
                        interpret=True)
    ref = np.asarray(JSW.sweep_bwd(j(f.pool_u), j(f.dinv_u), ref, sched,
                                   lu=True, interpret=True))
    plan = SW.sweep_plan(lay, "cpu")
    got = torch.from_numpy(y2.copy())
    SW.sweep_fwd(f.pool, f.dinv, got, plan)
    SW.sweep_bwd(f.pool_u, f.dinv_u, got, plan, lu=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    # the LU backward sweep is not the symmetric one
    sym = torch.from_numpy(y2.copy())
    SW.sweep_fwd(f.pool, f.dinv, sym, plan)
    SW.sweep_bwd(f.pool_u, f.dinv_u, sym, plan)
    assert np.abs(sym.numpy() - ref).max() > 1e-3 * np.abs(ref).max()
