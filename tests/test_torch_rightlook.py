"""The port's right-looking E2 schedules (``PASTIX_E2_LL=0`` / ``e2=``)
against the JAX reference, on the CPU.

- The gate: the reference's environment variables pick the reference's
  schedule (``pastix_tpu/numeric/factorize.py:527-555``), an explicit
  ``e2=`` overrides them, and block and slab refuse LU.
- The factors: poisson_3d(7) at T=16 (LLᵗ with the dense tail on and
  off, LDLᵗ) and convection_diffusion_3d(7) at T=16 (LU), bf16 updates,
  the same layout for both packages, through ``build_factorize_fn(e2=)``
  in every schedule the kind allows, against the reference's
  ``build_factorize_fn(use_pallas=False)`` (XLA ``gemm_scatter``) and
  against the port's left-looking factors: rtol 1e-4, atol 1e-5 ·
  max|ref|, as tests/test_torch_lu.py holds the left-looking ones.
  LDLᵗ under stream and compact rounds a twice, round(round(L) d), as
  the reference's stream kernel does (``pallas_kernels.py:480-487``)
  where its XLA path rounds once: atol 1e-3 · max|ref| there.  Each case
  proves that its schedule ran: the kernel wrappers it calls, with
  their operand forms, and the block and slab twins' counts and pair
  counts.  Block mode forces ``PASTIX_BLOCK_GATE=3``: at the default
  gate no entry of these small levels pays for its slabs.
- ``Pastix`` under ``PASTIX_E2_LL=0`` (the stream schedule) solves each
  kind to a fp64 residual <= 1e-10, and ``get_schur`` under it equals the
  left-looking S to 1e-5 · max|S|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pastix_tpu.config import Factorization as JF
from pastix_tpu.numeric.factorize import (
    build_factorize_fn as ref_factorize_fn,
    coefinit as ref_coefinit,
)

from pastix_tpu_torch.config import Factorization, PastixConfig
from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d
from pastix_tpu_torch.numeric import block as BK
from pastix_tpu_torch.numeric import factorize as F
from pastix_tpu_torch.numeric import slab as SB
from pastix_tpu_torch.pastix import Pastix

from torch_common import no_calibration  # noqa: F401 (autouse)

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

LLT, LDLT, LU = Factorization.LLT, Factorization.LDLT, Factorization.LU
BF16 = torch.bfloat16

# (environment, kind, update dtype) -> (mode, compact), by the reference's
# gate: PASTIX_E2_LL on (default) -> left-looking; off -> STREAM (default
# on), else BLOCK (default on), else SLAB (default on), else per pair; LU
# without the stream per pair (slab_ctx is None, :538-548); COMPACT=1 the
# opt-in of pallas_kernels.py:562-570.  No update dtype: the port's
# deviation keeps left-looking, and the stream reads the pool (:926-931).
GATE = [
    ({}, LLT, BF16, ("left", False)),
    ({}, LU, BF16, ("left", False)),
    ({}, LLT, None, ("left", False)),
    ({"PASTIX_E2_LL": "0"}, LLT, BF16, ("stream", False)),
    ({"PASTIX_E2_LL": "0"}, LDLT, BF16, ("stream", False)),
    ({"PASTIX_E2_LL": "0"}, LU, BF16, ("stream", False)),
    ({"PASTIX_E2_LL": "0"}, LLT, None, ("pair", False)),
    ({"PASTIX_E2_LL": "0", "PASTIX_E2_STREAM": "0"}, LLT, BF16,
     ("block", False)),
    ({"PASTIX_E2_LL": "0", "PASTIX_E2_STREAM": "0"}, LDLT, BF16,
     ("block", False)),
    ({"PASTIX_E2_LL": "0", "PASTIX_E2_STREAM": "0"}, LU, BF16,
     ("pair", False)),
    ({"PASTIX_E2_LL": "0", "PASTIX_E2_STREAM": "0", "PASTIX_E2_BLOCK": "0"},
     LLT, BF16, ("slab", False)),
    ({"PASTIX_E2_LL": "0", "PASTIX_E2_STREAM": "0", "PASTIX_E2_BLOCK": "0",
      "PASTIX_E2_SLAB": "0"}, LDLT, BF16, ("pair", False)),
    ({"PASTIX_E2_LL": "0", "PASTIX_E2_STREAM": "0", "PASTIX_E2_BLOCK": "0",
      "PASTIX_E2_SLAB": "0", "PASTIX_E2_COMPACT": "1"}, LLT, BF16,
     ("pair", True)),
]
_E2_VARS = ("PASTIX_E2_LL", "PASTIX_E2_STREAM", "PASTIX_E2_BLOCK",
            "PASTIX_E2_SLAB", "PASTIX_E2_COMPACT")


@pytest.mark.parametrize("env,kind,upd,want", GATE,
                         ids=[f"case{i}" for i in range(len(GATE))])
def test_gate_follows_the_reference(env, kind, upd, want, monkeypatch):
    for k in _E2_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert F.e2_schedule(kind, upd) == want


def test_e2_argument_overrides_the_environment(monkeypatch):
    monkeypatch.setenv("PASTIX_E2_LL", "1")
    assert F.e2_schedule(LLT, BF16, "slab") == ("slab", False)
    assert F.e2_schedule(LU, BF16, "pair+compact") == ("pair", True)
    monkeypatch.setenv("PASTIX_E2_LL", "0")
    assert F.e2_schedule(LDLT, BF16, "left") == ("left", False)
    for bad in ("blocks", "pair+stream"):
        with pytest.raises(ValueError, match="e2="):
            F.e2_schedule(LLT, BF16, bad)
    for mode in ("block", "slab"):
        with pytest.raises(ValueError, match="LU"):
            F.e2_schedule(LU, BF16, mode)


CASES = {  # kind, matrix, dense tail
    "llt_tail": (LLT, lambda: poisson_3d(7), True),
    "llt": (LLT, lambda: poisson_3d(7), False),
    "ldlt": (LDLT, lambda: poisson_3d(7), False),
    "lu": (LU, lambda: convection_diffusion_3d(7), False),
}
MODES = {LLT: ("stream", "block", "slab", "pair", "pair+compact"),
         LDLT: ("stream", "block", "slab", "pair"),
         LU: ("stream", "pair", "pair+compact")}


def _run(fn, kind, pool, pool_u, eps):
    """The factors of ``fn`` as numpy arrays: (pool,), (pool, d) or
    (pool, pool_u)."""
    if kind == LLT:
        return [np.asarray(fn(pool))]
    out = fn(pool, eps) if kind == LDLT else fn(pool, pool_u, eps)
    return [np.asarray(x) for x in out[:2]]


@pytest.fixture(scope="module")
def reference():
    """Per case: the port's solver, the coefinit pools, eps, and the
    reference's and the port's left-looking factors."""
    out = {}
    for name, (kind, make, tail) in CASES.items():
        s = Pastix(make(), PastixConfig(tile_size=16, factorization=kind,
                                        dense_tail=tail), device="cpu")
        s.analyze()
        assert (s._dense_tail is not None) == tail
        pool, pool_u = ref_coefinit(s.layout, s._A_perm, for_lu=kind == LU)
        eps = 1e-14 * float(abs(s._A_perm).max())
        rf = ref_factorize_fn(s.layout, JF[kind.name],
                              update_dtype=jnp.bfloat16, use_pallas=False,
                              dense_tail=s._dense_tail)
        ref = _run(rf, kind, jnp.asarray(pool),
                   None if pool_u is None else jnp.asarray(pool_u), eps)
        left = F.build_factorize_fn(s.layout, "cpu", kind, BF16,
                                    dense_tail=s._dense_tail, e2="left")
        out[name] = (s, pool, pool_u, eps, ref,
                     _run(left, kind, *_torch(pool, pool_u), eps))
    return out


def _torch(pool, pool_u):
    return (torch.from_numpy(pool.copy()),
            None if pool_u is None else torch.from_numpy(pool_u.copy()))


class _Spy:
    """Records each call of the factorization's E2 wrappers with the
    operand forms it was given."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("gemm_scatter_pipelined", "gemm_scatter_block",
                     "gemm_scatter_slab"):
            monkeypatch.setattr(F, name, self._wrap(name, getattr(F, name)))

    def _wrap(self, name, fn):
        def spy(pool, plan, upd=None, **kw):
            self.calls.append((name, tuple(sorted(
                k for k, v in kw.items()
                if v is not None and v is not False))))
            return fn(pool, plan, upd, **kw)
        return spy

    def forms(self, name):
        return {kw for n, kw in self.calls if n == name}


@pytest.mark.parametrize("case,mode", [
    (c, m) for c, (k, _, _) in CASES.items() for m in MODES[k]])
def test_factors_match_reference(reference, case, mode, monkeypatch):
    kind = CASES[case][0]
    s, pool, pool_u, eps, ref, left = reference[case]
    monkeypatch.setenv("PASTIX_BLOCK_GATE", "3")
    spy = _Spy(monkeypatch)
    blk0, slab0 = (BK.gemm_scatter_block.twin_launches,
                   SB.gemm_scatter_slab.twin_launches)
    fn = F.build_factorize_fn(s.layout, "cpu", kind, BF16,
                              dense_tail=s._dense_tail, e2=mode)
    got = _run(fn, kind, *_torch(pool, pool_u), eps)
    twice = kind == LDLT and mode in ("stream", "pair+compact")
    for g, r, lft in zip(got, ref, left):
        scale = float(np.abs(r).max())
        atol = (1e-3 if twice else 1e-5) * scale
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=atol)
        np.testing.assert_allclose(g, lft, rtol=1e-4, atol=atol)
    # the schedule ran
    assert (fn.e2, fn.compact) == F.e2_schedule(kind, BF16, mode)
    k3 = spy.forms("gemm_scatter_pipelined")
    side = {LLT: (), LDLT: ("d",), LU: ("src_pool",)}[kind]
    if mode == "stream":
        assert k3 == {("d", "xab") if kind == LDLT else ("xab",)}
    elif mode == "block":
        assert fn.n_block_pairs > 0 and spy.forms("gemm_scatter_block")
        assert BK.gemm_scatter_block.twin_launches > blk0
        assert k3 <= {side}
    elif mode == "slab":
        assert fn.n_slab_pairs > 0 and spy.forms("gemm_scatter_slab")
        assert SB.gemm_scatter_slab.twin_launches > slab0
        assert k3 <= {side}
    else:
        want = tuple(sorted(side + (("compact",) if fn.compact else ())))
        assert k3 == {want}
    if mode not in ("block", "slab"):
        assert not spy.forms("gemm_scatter_block")
        assert not spy.forms("gemm_scatter_slab")


def _solver(kind, schur=False):
    A = convection_diffusion_3d(7) if kind == LU else poisson_3d(7)
    s = Pastix(A, PastixConfig(tile_size=16, factorization=kind,
                               update_dtype="bfloat16"), device="cpu")
    if schur:
        s.set_schur_unknowns(np.arange(A.n - 49, A.n))
    return A, s


@pytest.mark.parametrize("kind", [LLT, LDLT, LU], ids=["llt", "ldlt", "lu"])
def test_pastix_solve_under_the_stream_schedule(kind, monkeypatch):
    monkeypatch.setenv("PASTIX_E2_LL", "0")
    A, s = _solver(kind)
    b = A.to_scipy() @ np.ones(A.n)
    x = s.solve(b)
    assert s._fact_fn.e2 == "stream"
    assert s.report.residual <= 1e-10
    assert np.abs(x - 1).max() <= 1e-8


def test_schur_under_the_stream_schedule_equals_left(monkeypatch):
    _, left = _solver(LLT, schur=True)
    S_left = left.get_schur()
    monkeypatch.setenv("PASTIX_E2_LL", "0")
    _, right = _solver(LLT, schur=True)
    S = right.get_schur()
    assert right._fact_fn.e2 == "stream"
    np.testing.assert_allclose(S, S_left, rtol=0,
                               atol=1e-5 * np.abs(S_left).max())
