"""The port's coefinit, LLᵗ factorization and diagonal inverses against
the reference, poisson_3d(10), T=32, same layout and dense-tail plan.

Tolerances: coefinit bit-equal (no duplicate entries, so the scatter
order cannot matter); factorization rtol=1e-4, atol=1e-5 * max|ref|, those
of tests/test_leftlook.py (the port is all left-looking, the reference
right-looking on its scanned levels, so only rounding agrees); inverse
diagonal tiles rtol=1e-4, with atol=1e-4 * max|ref| for the entries
near zero (triangular solve against block doubling).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import pastix_tpu.numeric.leftlook as JLL
from pastix_tpu.analyze.layout import plan_dense_tail
from pastix_tpu.config import Factorization
from pastix_tpu.numeric.factorize import (
    build_diag_inverse_fn as ref_diag_inverse_fn,
    build_factorize_fn as ref_factorize_fn,
    coefinit as ref_coefinit,
)

from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.generators import poisson_3d
from pastix_tpu_torch.numeric import factorize as F
from pastix_tpu_torch.pastix import Pastix


@pytest.fixture(scope="module")
def case():
    s = Pastix(poisson_3d(10), PastixConfig(tile_size=32), device="cpu")
    s.order()
    s.symbfact()
    s.analyze()
    dt = plan_dense_tail(s.layout)
    assert dt is not None
    return s, dt


@pytest.fixture(scope="module")
def factored(case):
    """(reference pool, port pool) after an fp32-update factorization."""
    s, dt = case
    lay = s.layout
    pool_np, _ = ref_coefinit(lay, s._A_perm)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JLL, "_INTERPRET", True)
        ref_fn = ref_factorize_fn(
            lay, Factorization.LLT, update_dtype=jnp.float32,
            use_pallas=True, dense_tail=dt,
        )
        ref = np.asarray(ref_fn(jnp.asarray(pool_np)))
    fn = F.build_factorize_fn(lay, "cpu", update_dtype=torch.float32,
                              dense_tail=dt)
    got = fn(torch.from_numpy(pool_np.copy())).numpy()
    return ref, got


def test_coefinit_bit_equal(case):
    s, _ = case
    ref, _ = ref_coefinit(s.layout, s._A_perm)
    coef = F.build_coefinit_fn(s.layout, s._A_perm, "cpu")
    vals = torch.from_numpy(sp.coo_matrix(s._A_perm).data.astype(np.float32))
    got = coef(vals).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_factorization_matches_pallas_reference(factored):
    ref, got = factored
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * max(scale, 1.0))


def test_diag_inverse_matches(case, factored):
    s, _ = case
    ref_pool, _ = factored
    ref = np.asarray(ref_diag_inverse_fn(s.layout, Factorization.LLT)(
        jnp.asarray(ref_pool)
    ))
    got = F.build_diag_inverse_fn(s.layout, "cpu")(
        torch.from_numpy(ref_pool.copy())
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_every_level_left_looking(case):
    s, dt = case
    fn = s._fact_fn
    n_ll = sum(c.n_pairs for lv in fn.levels for c in lv.ll)
    n_tail = sum(c.n_pairs for c in fn.tail)
    total = sum(lv.gemm_a.size for lv in dt.levels_lo)
    assert n_ll + n_tail == total and n_tail > 0
