"""The slice as a whole: the port's ``Pastix`` against the reference's on
poisson_3d(12), T=32, with fp32 and bf16 trailing updates, on the CPU.

Held: both refined residuals <= 1e-10; solutions agree to 1e-8 relative
(both are refined to 1e-10 on a matrix of condition about 60);
``refine_iters`` differ by at most 2 (the reference refines in fp32 and
then on the host in fp64, the port in one fp64-residual loop); the
reference's factors handed to the port's solve reproduce the reference's
solution to 1e-8.  Plus the front door's refusals.
"""

import numpy as np
import pytest
import torch

from pastix_tpu.config import PastixConfig as JPastixConfig
from pastix_tpu.generators import poisson_3d as j_poisson_3d
from pastix_tpu.pastix import Pastix as JPastix

import pastix_tpu_torch
from pastix_tpu_torch.config import Factorization, PastixConfig, RefinementMethod
from pastix_tpu_torch.convert import factors_from_jax
from pastix_tpu_torch.generators import poisson_3d
from pastix_tpu_torch.pastix import Pastix

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

NX = 12


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    A = poisson_3d(NX)
    b = A.to_scipy() @ np.random.default_rng(7).standard_normal(A.n)
    cfg = lambda cls: cls(tile_size=32, update_dtype=request.param)
    ref = JPastix(j_poisson_3d(NX), cfg(JPastixConfig))
    x_ref = ref.solve(b)
    port = Pastix(A, cfg(PastixConfig), device="cpu")
    port.order()
    port.symbfact()
    port.analyze()
    port.factorize()
    x = port.solve(b)
    return ref, x_ref, port, x, b


def test_residuals_reach_1e10(pair):
    ref, _, port, _, _ = pair
    assert ref.report.residual <= 1e-10
    assert port.report.residual <= 1e-10
    assert port.report.fallbacks == []


def test_solutions_agree(pair):
    _, x_ref, _, x, _ = pair
    assert _rel(x, x_ref) <= 1e-8


def test_refine_iters_close(pair):
    ref, _, port, _, _ = pair
    assert abs(ref.report.refine_iters - port.report.refine_iters) <= 2


def test_report_fields_match(pair):
    ref, _, port, _, _ = pair
    for f in ("n", "nnz_a", "nnz_l", "nnz_l_exact", "fact_flops", "tile_size",
              "n_tiles", "n_levels", "dense_tail_m", "memory_bytes"):
        assert getattr(port.report, f) == getattr(ref.report, f), f
    assert port.report.fact_time > 0 and port.report.fact_gflops > 0


def test_reference_factors_through_port_solve(pair):
    ref, x_ref, port, _, b = pair
    port.factors = factors_from_jax(ref.factors, "cpu")
    x = port.solve(b)
    assert port.report.residual <= 1e-10
    assert _rel(x, x_ref) <= 1e-8


def test_spsolve_block_rhs():
    A = poisson_3d(6)
    X = np.random.default_rng(3).standard_normal((A.n, 3))
    B = A.to_scipy() @ X
    got = pastix_tpu_torch.spsolve(A, B, device="cpu", tile_size=16)
    assert got.shape == X.shape
    assert _rel(got, X) <= 1e-9


@pytest.mark.parametrize("kind", [
    dict(factorization=Factorization.LDLH),
    dict(factorization=Factorization.LU, compute_dtype="complex64"),
])
def test_unported_kinds_raise(kind):
    """Real LDLᵗ and LU are ported (slice 2); LDLᴴ and complex LU are
    slice 3."""
    with pytest.raises(NotImplementedError, match="slice 3"):
        Pastix(poisson_3d(4), PastixConfig(**kind), device="cpu")


@pytest.mark.parametrize("cfg", [
    dict(compute_dtype="complex64"), dict(mesh_shape=(2,)), dict(ooc=True),
    dict(incomplete=True), dict(refinement=RefinementMethod.GMRES),
    dict(schur=True, factorization=Factorization.LDLH),
], ids=["complex", "mesh", "ooc", "ilu", "gmres", "schur"])
def test_unported_options_raise(cfg):
    """The schur case: Schur under LDLᴴ is slice 3 (LLᵗ, LDLᵗ and LU
    Schur are ported)."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md slice"):
        Pastix(poisson_3d(4), PastixConfig(**cfg), device="cpu")


@pytest.mark.parametrize("field,value,item", [
    ("packed_update", True, "A7"), ("packed_update", None, None),
    ("packed_update", False, None), ("trace", True, "A10"),
    ("fast_solve", False, "A2"), ("device_refine", False, "A2"),
    ("residual_dtype", "float32", "A2"),
])
def test_config_fields_raise_or_are_taken(field, value, item):
    """Every config field the port does not act on raises naming its
    ROADMAP item; packed_update=None (auto) is off, as False."""
    cfg = PastixConfig(**{field: value})
    if item is None:
        assert Pastix(poisson_3d(4), cfg, device="cpu").config is cfg
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}\\)"):
        Pastix(poisson_3d(4), cfg, device="cpu")


@pytest.mark.parametrize("member,item", [
    ("factorize", "A2"), ("as_preconditioner", "A2"), ("clean", "A2"),
    ("dump_trace", "A10"), ("pastix", "A2"),
])
def test_unported_members_raise(member, item):
    """The reference's members the port lacks raise naming their ROADMAP
    item, with the reference's signatures; ``factorize()`` without
    values still factors."""
    A = poisson_3d(4)
    s = Pastix(A, PastixConfig(tile_size=8), device="cpu")
    M = A.to_scipy().tocsc()
    calls = {
        "factorize": lambda: s.factorize(M.data),
        "as_preconditioner": s.as_preconditioner,
        "clean": s.clean,
        "dump_trace": lambda: s.dump_trace("trace.json"),
        "pastix": lambda: pastix_tpu_torch.pastix.pastix(
            A.n, M.indptr, M.indices, M.data, np.ones(A.n), PastixConfig(),
            base=0),
    }
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}\\)"):
        calls[member]()
    if member == "factorize":
        f = s.factorize()
        assert f is s.factors and np.isfinite(f.pool.numpy()).all()


def _layout_arrays(lay):
    """Every array of a layout, by name, as SolverLayout.save writes
    them."""
    out = {k: getattr(lay, k) for k in ("keys", "blk_row", "blk_col",
                                         "level_of_col", "scat_pool_flat")}
    for i, lv in enumerate(lay.levels):
        for k, v in vars(lv).items():
            out[f"lv{i}_{k}"] = v
    return out


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_layout_round_trips_with_reference(tmp_path, monkeypatch, saver):
    """IOStrategy.SAVE writes layoutname.npz beside the order and the
    symbol; IOStrategy.LOAD in the other package reads it, and builds
    no layout of its own."""
    import pastix_tpu.pastix as JP
    import pastix_tpu_torch.pastix as TP
    from pastix_tpu.config import IOStrategy as JIO
    from pastix_tpu_torch.config import IOStrategy

    def cfg(cls, io):
        return cls(tile_size=16, io_strategy=io, io_dir=str(tmp_path))

    A = poisson_3d(6)
    port = lambda io: Pastix(A, cfg(PastixConfig, io), device="cpu")
    ref = lambda io: JPastix(j_poisson_3d(6), cfg(JPastixConfig, io))
    save, load = ((port(IOStrategy.SAVE), ref(JIO.LOAD)) if saver == "port"
                  else (ref(JIO.SAVE), port(IOStrategy.LOAD)))
    for s in (save, load):
        if s is load:
            monkeypatch.setattr(JP if saver == "port" else TP,
                                "build_layout", None)
        s.order()
        s.symbfact()
        s.analyze()
    assert (tmp_path / "layoutname.npz").exists()
    got, want = _layout_arrays(load.layout), _layout_arrays(save.layout)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_solve_after_layout_load_gives_same_pool(tmp_path, monkeypatch):
    import pastix_tpu_torch.pastix as TP
    from pastix_tpu_torch.config import IOStrategy

    A = poisson_3d(6)
    b = A.to_scipy() @ np.ones(A.n)
    runs = []
    for io in (IOStrategy.SAVE, IOStrategy.LOAD):
        if io == IOStrategy.LOAD:
            monkeypatch.setattr(TP, "build_layout", None)
        s = Pastix(A, PastixConfig(tile_size=16, io_strategy=io,
                                   io_dir=str(tmp_path)), device="cpu")
        x = s.solve(b)
        runs.append((s.factors.pool.clone(), x))
    assert torch.equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_solve_leaves_callers_tf32_switches():
    """The port pins true fp32 around its own phases only
    (_device.pin_precision) and restores the caller's switches."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    seen = []
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        from pastix_tpu_torch import _device

        with _device.pin_precision():
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
        A = poisson_3d(4)
        x = pastix_tpu_torch.spsolve(A, A.to_scipy() @ np.ones(A.n),
                                     device="cpu", tile_size=16)
        assert np.abs(x - 1).max() < 1e-9
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    assert seen == [(False, False)]


def test_schur_unknowns_raise():
    """Schur unknowns under LDLᴴ name slice 3; under LLᵗ, LDLᵗ and LU
    they are taken."""
    with pytest.raises(NotImplementedError, match="LDLH.*slice 3"):
        Pastix(poisson_3d(4), PastixConfig(factorization=Factorization.LDLH,
                                           schur=True),
               device="cpu").set_schur_unknowns([0, 1])
    for kind in (Factorization.LLT, Factorization.LDLT, Factorization.LU):
        s = Pastix(poisson_3d(4), PastixConfig(factorization=kind),
                   device="cpu")
        assert s.set_schur_unknowns([1, 0, 1]) is s and s.config.schur
        np.testing.assert_array_equal(s._schur_unknowns, [0, 1])


def test_foreign_config_raises():
    """A pastix_tpu config would compare its enums unequal to the port's
    and pass LDLᵗ through as LLᵗ: it is refused."""
    with pytest.raises(TypeError, match="pastix_tpu_torch.config"):
        Pastix(poisson_3d(4), JPastixConfig(), device="cpu")


def test_not_spd_raises():
    A = -poisson_3d(6).to_scipy()
    s = Pastix(A, PastixConfig(tile_size=16), device="cpu")
    with pytest.raises(FloatingPointError, match="not positive definite"):
        s.factorize()


def test_wrong_rhs_length_names_both_sizes():
    s = Pastix(poisson_3d(4), PastixConfig(tile_size=16), device="cpu")
    with pytest.raises(ValueError, match="rhs has 5 rows but the matrix is 64x64"):
        s.solve(np.ones(5))


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    A = poisson_3d(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pastix(A, PastixConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pastix_tpu_torch.spsolve(A, np.ones(A.n))  # the default is cuda
    for kind in (Factorization.LDLT, Factorization.LU):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Pastix(A, PastixConfig(factorization=kind))


def test_unsymmetric_matrix_refused_unless_lu():
    """The symmetric kinds check the matrix (pastix_checkMatrix); LU
    keeps full storage."""
    from pastix_tpu_torch.generators import convection_diffusion_3d

    M = convection_diffusion_3d(4).to_scipy()
    for kind in (Factorization.LLT, Factorization.LDLT):
        with pytest.raises(ValueError, match="not symmetric"):
            Pastix(M, PastixConfig(factorization=kind), device="cpu")
    s = Pastix(M, PastixConfig(factorization=Factorization.LU), device="cpu")
    assert not s.A.symmetric_storage and s.A.nnz == M.nnz
