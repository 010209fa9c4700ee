"""The refinement of the port against the reference's, on the CPU.

(a) ``pastix_tpu_torch.refine.refine`` is a copy of
``pastix_tpu.refine.refine``: on the same numpy ``matvec`` and ``precond``
(an fp32 sparse LU of the matrix) every method gives the reference's
result bit for bit, on a 1-D RHS, a block and a block whose first column
starts converged.

(b) The device loops (``krylov.build_device_refine_fn``: CG, GMRES and
BiCGStab, fp64 vectors, on the CPU tensors here) against the reference's
host ``refine`` with the same M⁻¹: the port's K2 twin on the reference's
factors carried across by ``convert.factors_from_jax``.  Iterations
within 1, both residuals <= 1e-10, solutions within 1e-9 relative, and
one preconditioner application a step (two for BiCGStab) plus the start.

(c) The per-level solve of ``fast_solve=False`` on the reference's factors
against the reference's own ``solve.build_solve_fn``: 1e-5 relative
(both fp32).

(d) The host finish: a device loop cut after one step is finished on the
host to ``refinement_eps``, as the reference's ``solve`` finishes its
device loop.

The whole front door per refinement family, against one reference
``Pastix`` a family (its host loop on its per-level solve:
``device_refine=False``, ``fast_solve=False``, so that its iterations
count the same steps as the port's): LLᵗ with CG on poisson_3d(8) and LU
with GMRES on convection_diffusion_3d(8), T=16, bf16 updates.  The
factored solve is a strong preconditioner, so the loops refine to
``refinement_eps`` = 1e-13 (3 to 4 steps; 2 at 1e-10) and the residuals
are held to 1e-10.  Every method of the family with both
``device_refine`` and both ``fast_solve`` values: residual <= 1e-10,
solution within 1e-8 of the reference's, and the family's own method
within 1 iteration of it.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import pastix_tpu.solve as j_solve
from pastix_tpu.config import Factorization as JFactorization
from pastix_tpu.config import PastixConfig as JPastixConfig
from pastix_tpu.config import RefinementMethod as JRefinementMethod
from pastix_tpu.generators import convection_diffusion_3d as j_convdiff
from pastix_tpu.generators import poisson_3d as j_poisson_3d
from pastix_tpu.pastix import Pastix as JPastix
from pastix_tpu.refine import refine as j_refine

from pastix_tpu_torch.config import Factorization, PastixConfig, RefinementMethod
from pastix_tpu_torch.convert import factors_from_jax
from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d
from pastix_tpu_torch.krylov import build_device_refine_fn, build_ell
from pastix_tpu_torch.pastix import Pastix
from pastix_tpu_torch.refine import refine
from pastix_tpu_torch.solve import (
    build_solve_fn, build_solve_fn_sweep, rhs_to_blocks, blocks_to_rhs,
    run_host,
)

from torch_common import no_calibration  # noqa: F401 (autouse)

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

NX = 8
EPS = 1e-13  # the loops' target: a few more steps than at 1e-10
TOL = 1e-10  # the residual every solution is held to
METHODS = ("NONE", "SIMPLE", "CG", "GMRES", "BICGSTAB")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ----------------------------------------------------------------------
# (a) the host loop, a copy: bit for bit
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def systems():
    """(A, fp32 LU solve) for an SPD and an unsymmetric matrix."""
    out = {}
    for name, M in (("spd", poisson_3d(5).to_scipy()),
                    ("unsym", convection_diffusion_3d(5).to_scipy())):
        M = sp.csc_matrix(M)
        lu = spla.splu(M.astype(np.float32).tocsc())
        out[name] = (M, lambda r, lu=lu: lu.solve(
            np.asarray(r, np.float32)))
    return out


@pytest.mark.parametrize("shape", ["1d", "block", "mixed"])
@pytest.mark.parametrize("method", METHODS)
def test_host_refine_is_the_reference_bit_for_bit(systems, method, shape):
    M, precond = systems["spd" if method == "CG" else "unsym"]
    rng = np.random.default_rng(METHODS.index(method))
    X = rng.standard_normal((M.shape[0], 3))
    B = M @ X
    b = B[:, 0] if shape == "1d" else B
    x0 = np.asarray(precond(b), np.float64)
    if shape == "mixed":
        x0[:, 0] = spla.spsolve(M, B[:, 0])  # converged from the start
    kw = dict(eps=1e-12, itermax=40, gmres_restart=5, dtype=np.float64)
    got = refine(lambda v: M @ v, precond, b, x0,
                 method=RefinementMethod[method], **kw)
    want = j_refine(lambda v: M @ v, precond, b, x0,
                    method=JRefinementMethod[method], **kw)
    np.testing.assert_array_equal(got.x, want.x)
    assert (got.iterations, got.residual, got.converged, got.history) == (
        want.iterations, want.residual, want.converged, want.history)
    if method != "NONE":
        assert got.converged and got.iterations > 0


# ----------------------------------------------------------------------
# the reference, one Pastix a refinement family
# ----------------------------------------------------------------------

FAMILIES = {
    "llt-cg": (j_poisson_3d, poisson_3d, "LLT", "CG"),
    "lu-gmres": (j_convdiff, convection_diffusion_3d, "LU", "GMRES"),
}


def _cfg(cls, kind, method, **kw):
    fact = JFactorization if cls is JPastixConfig else Factorization
    meth = JRefinementMethod if cls is JPastixConfig else RefinementMethod
    return cls(tile_size=16, update_dtype="bfloat16",
               factorization=fact[kind], refinement=meth[method],
               refinement_eps=EPS, **kw)


# (family, method): CG only where the kind is symmetric
DEVICE_CASES = [("llt-cg", "CG"), ("llt-cg", "GMRES"), ("llt-cg", "BICGSTAB"),
                ("lu-gmres", "GMRES"), ("lu-gmres", "BICGSTAB")]
FRONT_DOOR_CASES = [("llt-cg", "SIMPLE"), *DEVICE_CASES[:3],
                    ("lu-gmres", "SIMPLE"), *DEVICE_CASES[3:]]


@functools.cache
def _family(name):
    """The reference solved once on its host loop and per-level solve;
    its factors on the port's CPU tensors.  Cached by name: the tests
    that share a family share its one reference compile."""
    jgen, gen, kind, method = FAMILIES[name]
    A = gen(NX)
    b = A.to_scipy() @ np.random.default_rng(5).standard_normal(A.n)
    ref = JPastix(jgen(NX), _cfg(JPastixConfig, kind, method,
                                 device_refine=False, fast_solve=False))
    x_ref = ref.solve(b)
    f = factors_from_jax(ref.factors, "cpu")
    return dict(kind=kind, method=method, A=A, b=b, ref=ref, x_ref=x_ref,
                f=f)


@pytest.fixture
def family(request):
    return _family(request.param)


@pytest.mark.parametrize("family,method", DEVICE_CASES,
                         indirect=["family"])
def test_device_methods_match_host_refine(family, method):
    """(b): the same M⁻¹ (the port's K2 twin on the reference's factors),
    the port's device loop against the reference's host loop."""
    ref, f = family["ref"], family["f"]
    lay = f.layout
    solve_fn = build_solve_fn_sweep(lay, "cpu", Factorization[family["kind"]])
    Ap = ref._A_perm64
    b_ext = ref._perm_rhs(family["b"])
    cols, vals = build_ell(sp.coo_matrix(Ap), lay.nbc * lay.T, np.float64)
    fn = build_device_refine_fn(lay, solve_fn, RefinementMethod[method])
    bb = torch.as_tensor(rhs_to_blocks(lay, b_ext, np.float64)).reshape(
        lay.nbc * lay.T, 1)
    x, it = fn(f.solve_args(), torch.as_tensor(cols.astype(np.int64)),
               torch.as_tensor(vals), bb, EPS, 60)
    x_dev = blocks_to_rhs(lay, x.reshape(lay.nbc, lay.T, 1).numpy())[:, 0]
    precond = lambda r: run_host(f, r, solve_fn)
    host = j_refine(lambda v: Ap @ v, precond, b_ext, precond(b_ext),
                    method=JRefinementMethod[method], eps=EPS, itermax=60,
                    gmres_restart=30, dtype=np.float64)
    res_dev = _rel(Ap @ x_dev, b_ext)
    assert res_dev <= TOL and host.residual <= TOL
    assert abs(it - host.iterations) <= 1, (it, host.iterations)
    assert it >= 1
    assert _rel(x_dev, host.x) <= 1e-9
    # preconditioner applications: x0 = M⁻¹ b, then CG's z0 and one a
    # step, BiCGStab's two a step, GMRES's one a step and one a cycle
    if method == "CG":
        assert fn.applies == it + 2
    elif method == "BICGSTAB":
        assert fn.applies == 2 * it + 1
    else:
        assert it + 2 <= fn.applies <= 2 * it + 1


@pytest.mark.parametrize("family", list(FAMILIES), indirect=True)
def test_level_solve_matches_reference(family):
    """(c): the per-level solve on the reference's factors against the
    reference's own per-level solve (its ``solve.build_solve_fn``)."""
    ref, f = family["ref"], family["f"]
    lay = f.layout
    B = np.random.default_rng(9).standard_normal((lay.n, 2))
    want = j_solve.solve(ref.factors, B, solve_fn=ref._solve_fn)
    fn = build_solve_fn(lay, "cpu", Factorization[family["kind"]])
    got = run_host(f, B, fn)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("family", list(FAMILIES), indirect=True)
def test_host_finish_after_device_loop(family):
    """(d): the device loop cut after one step; the host loop finishes at
    the configured method to refinement_eps."""
    kind, method = family["kind"], family["method"]
    s = Pastix(family["A"], _cfg(PastixConfig, kind, method), device="cpu")
    s.analyze()
    full = s._refine_fn
    dev_iters = []

    def one_step(*args):
        x, it = full(*args[:-1], 1)
        dev_iters.append(it)
        return x, it

    s._refine_fn = one_step
    x = s.solve(family["b"])
    assert dev_iters == [1]
    assert s.report.refine_iters > 1  # the host loop took over
    assert s.report.residual <= TOL
    assert _rel(x, family["x_ref"]) <= 1e-8


@pytest.mark.parametrize("fast_solve", [True, False])
@pytest.mark.parametrize("device_refine", [True, False])
@pytest.mark.parametrize("family,method", FRONT_DOOR_CASES,
                         indirect=["family"])
def test_front_door_refinement_matches_reference(family, method,
                                                 device_refine, fast_solve):
    """Every method of the family, both device_refine and both fast_solve
    values, against the reference's solution; the family's method also
    against its iterations.  fast_solve=False makes no inverse diagonal
    tiles."""
    kind = family["kind"]
    s = Pastix(family["A"], _cfg(PastixConfig, kind, method,
                                 device_refine=device_refine,
                                 fast_solve=fast_solve), device="cpu")
    x = s.solve(family["b"])
    assert s.report.residual <= TOL
    assert _rel(x, family["x_ref"]) <= 1e-8
    assert (s.factors.dinv is None) == (not fast_solve)
    assert (s._refine_fn is not None) == (device_refine and fast_solve)
    if method == family["method"]:
        assert abs(s.report.refine_iters
                   - family["ref"].report.refine_iters) <= 1
