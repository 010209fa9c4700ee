"""The port's own copies of the host side (ordering, symbolic
factorization, tile layout, native library) give the reference's results,
and the port runs without loading JAX or any module of ``pastix_tpu``.

poisson_3d(6) and laplacian_2d(12), T=16, with and without Schur unknowns
(the last 36 dofs of the first, 17 non-tile-aligned dofs of the second).
Orders, symbols and every ``SolverLayout`` field are compared for exact
equality.  In Schur mode the reference drops the supernode alignment and
the port keeps it (``Pastix._build_extended_matrix``): the parity cases
run the port with ``align_supernodes=False``, and one test checks the
aligned Schur extension on its own.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from pastix_tpu.analyze import build_layout as j_build_layout
from pastix_tpu.config import PastixConfig as JPastixConfig
from pastix_tpu.generators import laplacian_2d as j_laplacian_2d
from pastix_tpu.generators import poisson_3d as j_poisson_3d
from pastix_tpu.pastix import Pastix as JPastix

from pastix_tpu_torch import native
from pastix_tpu_torch.analyze import build_layout
from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.generators import laplacian_2d, poisson_3d
from pastix_tpu_torch.pastix import Pastix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 16
CASES = {
    "poisson_3d(6)": (poisson_3d, j_poisson_3d, 6, 36),
    "laplacian_2d(12)": (laplacian_2d, j_laplacian_2d, 12, 17),
}


def _eq(a, b, path="") -> None:
    """Exact equality of nested dataclass / dict / list / array values."""
    if dataclasses.is_dataclass(a):
        _eq(dataclasses.asdict(a), dataclasses.asdict(b), path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _eq(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.fixture(scope="module", params=[
    (name, schur) for name in CASES for schur in (False, True)
], ids=lambda p: f"{p[0]}-{'schur' if p[1] else 'plain'}")
def symbolic(request):
    """(reference, port) solvers after order and symbfact."""
    name, schur = request.param
    gen, j_gen, size, ns = CASES[name]
    ref = JPastix(j_gen(size), JPastixConfig(tile_size=T))
    port = Pastix(gen(size),
                  PastixConfig(tile_size=T, align_supernodes=not schur),
                  device="cpu")
    if schur:
        n = port.A.n
        for s in (ref, port):
            s.set_schur_unknowns(np.arange(n - ns, n))
    for s in (ref, port):
        s.order()
        s.symbfact()
    return ref, port, schur


def test_order_matches(symbolic):
    ref, port, _ = symbolic
    for f in ("permtab", "peritab", "rangtab"):
        np.testing.assert_array_equal(getattr(port.order_, f),
                                      getattr(ref.order_, f), err_msg=f)


def test_symbol_matches(symbolic):
    ref, port, schur = symbolic
    _eq(port.symbol_, ref.symbol_, "symbol")
    for k in ("nnz_l_exact", "flops_exact"):
        assert port._scalar_info[k] == ref._scalar_info[k], k
    np.testing.assert_array_equal(port._ext_map, ref._ext_map)
    assert (port._pat_perm_ext != ref._pat_perm_ext).nnz == 0
    assert (abs(port._A_perm - ref._A_perm) > 0).nnz == 0
    assert port._schur_first_bcol == ref._schur_first_bcol
    assert (port._schur_first_bcol is not None) == schur


def test_layout_matches(symbolic):
    """Every SolverLayout field, built by each package's build_layout on
    the same pattern: with schur_first_bcol in Schur mode, with the
    densified dense tail otherwise."""
    ref, port, schur = symbolic
    kw = dict(schur_first_bcol=port._schur_first_bcol,
              densify_tail_frac=0.0 if schur else port.config.dense_tail_fill)
    got = build_layout(port._pat_perm_ext, T, **kw)
    want = j_build_layout(ref._pat_perm_ext, T, **kw)
    _eq(got, want, "layout")
    if schur:
        factored = np.concatenate([lv.cols for lv in got.levels])
        assert factored.max() < port._schur_first_bcol


@pytest.mark.parametrize("name", list(CASES))
def test_aligned_schur_extension(name):
    """With supernode alignment (the default) the interior dofs keep
    their order and padding, and the Schur dofs, ordered last, fill the
    block columns from ``schur_first_bcol`` on."""
    gen, _, size, ns = CASES[name]
    A = gen(size)
    s = Pastix(A, PastixConfig(tile_size=T), device="cpu")
    s.set_schur_unknowns(np.arange(A.n - ns, A.n))
    s.symbfact()
    n0, sb = A.n - ns, s._schur_first_bcol
    ext = s._ext_map
    assert np.all(np.diff(ext[:n0]) > 0) and ext[n0 - 1] < sb * T
    np.testing.assert_array_equal(ext[n0:], sb * T + np.arange(ns))
    assert s._ext_n == sb * T + ns


def test_native_library_builds_in_port_build_dir():
    """Ordering used the port's own native library (or says why not),
    built under pastix_tpu_torch/_build, never beside the sources."""
    native.get_lib()
    assert native.status != "not tried"
    if native.status.startswith("unavailable"):
        pytest.skip(f"no native toolchain here: {native.status}")
    built = native.lib_path(native.host_key())
    assert os.path.isfile(built)
    assert os.path.dirname(built) == os.path.join(ROOT, "pastix_tpu_torch",
                                                  "_build")
    assert not any(f.endswith(".so") for f in os.listdir(
        os.path.join(ROOT, "pastix_tpu_torch", "native")))


def test_native_library_named_by_host_cpu():
    """The -march=native library is cached under a key of the host CPU:
    two hosts give two paths, one host always the same."""
    key = native.host_key()
    assert key == native.host_key() and len(key) == 12
    assert native.lib_path(key) != native.lib_path("0" * 12)
    assert os.path.basename(native.lib_path(key)) == f"_pastix_native_{key}.so"


def test_port_runs_without_jax_or_pastix_tpu():
    """A fresh interpreter imports the port, runs spsolve, a Schur solve
    and an LU solve on the CPU, and never loads jax or a pastix_tpu
    module."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import pastix_tpu_torch as P\n"
        "from pastix_tpu_torch.generators import poisson_3d\n"
        "A = poisson_3d(5)\n"
        "b = A.to_scipy() @ np.ones(A.n)\n"
        "x = P.spsolve(A, b, device='cpu', tile_size=16)\n"
        "assert np.abs(x - 1).max() < 1e-9\n"
        "s = P.Pastix(A, P.PastixConfig(tile_size=16), device='cpu')\n"
        "s.set_schur_unknowns(np.arange(A.n - 25, A.n))\n"
        "x = s.solve_with_schur(b)\n"
        "assert s.get_schur().shape == (25, 25)\n"
        "assert np.abs(x - 1).max() < 1e-9\n"
        "from pastix_tpu_torch.generators import convection_diffusion_3d\n"
        "C = convection_diffusion_3d(5)\n"
        "x = P.spsolve(C, C.to_scipy() @ np.ones(C.n), device='cpu',\n"
        "              tile_size=32, factorization=P.Factorization.LU)\n"
        "assert np.abs(x - 1).max() < 1e-9\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'pastix_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'pastix_tpu.')))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
