"""The port's host front ends against the reference's, on the CPU.

``drivers``, ``murge`` and ``distributed`` are copies of the reference's
modules; their host code is held to the reference's on the same inputs
with exact equality: each writer's file read by both packages' readers,
the generator drivers and ``gen_rhs``; MurgeSolver's graph and assembled
matrix; CSCD ``assemble_distributed``, ``redispatch`` and ``cscd_addlocal``
(no JAX compile: the reference's Murge builds its ``Pastix`` but never
runs it).  Then end to end on the port, poisson_3d(6), T=16, each to a
residual <= 1e-10: ``dspsolve`` over 4 CSCD parts, Murge's solve and its
value reuse (``factorize(values)`` on the cached analysis), and the CLI
(``--cpu``) in one call and step by step, plus the flags that name an
unported slice.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pastix_tpu.distributed as JD
import pastix_tpu.drivers as JDR
import pastix_tpu.murge as JM

import pastix_tpu_torch.distributed as D
import pastix_tpu_torch.drivers as DR
import pastix_tpu_torch.murge as M
from pastix_tpu_torch.cli import main as cli_main
from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.generators import (
    laplacian_2d, poisson_3d, random_unsym,
)

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

TOL = 1e-10


def _same(a, b):
    """Exact equality of two SparseMatrix objects (either package's)."""
    assert (a.n, a.symmetric_storage) == (b.n, b.symmetric_storage)
    for f in ("colptr", "rowind", "values"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _res(A, x, b):
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


# ----------------------------------------------------------------------
# drivers
# ----------------------------------------------------------------------

FILES = {
    "mm": ("m.mtx", None, lambda: laplacian_2d(8)),
    "hb": ("m.rua", None, lambda: random_unsym(30, density=0.1, seed=3)),
    "ijv": ("m_", "ijv", lambda: laplacian_2d(6)),
    "petsc": ("m.petsc", None, lambda: random_unsym(25, density=0.15,
                                                    seed=5)),
}


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("fmt", list(FILES))
def test_drivers_round_trip_with_reference(tmp_path, fmt, writer):
    """Either package writes the file; both read it to equal arrays, and
    the round trip gives the written matrix back."""
    name, driver, make = FILES[fmt]
    A = make()
    path = str(tmp_path / name)
    getattr(DR if writer == "port" else JDR, f"write_{fmt}")(path, A)
    got = DR.read_matrix(path, driver=driver)
    _same(got, JDR.read_matrix(path, driver=driver))
    d = (got.to_scipy() - A.to_scipy()).tocoo()
    assert d.nnz == 0 or abs(d.data).max() < 1e-12


@pytest.mark.parametrize("spec", ["lap:5", "lap1:7", "lap2:4", "lap3:4",
                                  "elas3:3"])
def test_generator_drivers_and_rhs_match_reference(spec):
    A = DR.read_matrix(spec)
    _same(A, JDR.read_matrix(spec))
    for kind in ("ones", "i", "random"):
        np.testing.assert_array_equal(DR.gen_rhs(A, kind, seed=4),
                                      JDR.gen_rhs(A, kind, seed=4))


def test_driver_refusals_match_reference():
    for mod in (DR, JDR):
        with pytest.raises(ValueError, match="cannot sniff"):
            mod.read_matrix("nope.xyz")
        with pytest.raises(ValueError, match="needs a size"):
            mod.read_matrix("x", driver="lap3")


# ----------------------------------------------------------------------
# Murge
# ----------------------------------------------------------------------


def _assemble(m, A, mode, scale=1.0):
    """The graph of A (once), then its values entry by entry in ``mode``:
    ADD splits each value in two halves."""
    C = sp.coo_matrix(A)
    if m._pattern is None:
        m.graph_begin()
        m.graph_edge(C.row, C.col)
        m.graph_end()
    m.assembly_begin(mode)
    if mode == m.ADD:
        for half in (0.25, 0.75):
            m.assembly_set_value(C.row, C.col, half * scale * C.data)
    else:
        m.assembly_set_value(C.row, C.col, 9.0 * C.data)  # overwritten
        m.assembly_set_value(C.row, C.col, scale * C.data)
    m.assembly_end()


@pytest.mark.parametrize("mode", ["add", "overwrite"])
def test_murge_graph_and_assembly_match_reference(mode):
    A = poisson_3d(4).to_scipy()
    port = M.MurgeSolver(A.shape[0], PastixConfig(tile_size=16),
                         device="cpu")
    ref = JM.MurgeSolver(A.shape[0])
    for m in (port, ref):
        _assemble(m, A, mode)
    for f in ("indptr", "indices"):
        np.testing.assert_array_equal(getattr(port._pattern, f),
                                      getattr(ref._pattern, f))
    _same(port.matrix, ref.matrix)
    assert port._solver.device.type == "cpu"


def test_murge_solve_and_value_reuse():
    """Murge's second assembly on the same graph refactors through
    ``factorize(values)``: the analysis is not rerun."""
    A = poisson_3d(6).to_scipy()
    n = A.shape[0]
    m = M.MurgeSolver(n, PastixConfig(tile_size=16, verbosity=0),
                      device="cpu")
    _assemble(m, A, m.ADD)
    b = A @ np.random.default_rng(0).standard_normal(n)
    assert _res(A, m.solve(b), b) <= TOL
    solver, layout = m._solver, m._solver.layout
    m.set_global_rhs(b)
    _assemble(m, A, m.OVERWRITE, scale=3.0)
    assert m._solver is solver and solver.layout is layout
    x = m.get_global_solution()
    assert _res(3.0 * A, x, b) <= TOL
    assert m.get_info("DPARM_FACT_TIME") > 0
    m.clean()
    assert m.report is None and solver.factors is None


# ----------------------------------------------------------------------
# CSCD (distributed input)
# ----------------------------------------------------------------------


def _parts(mod, A, nparts, local):
    """A's entries in ``nparts`` COO chunks of ``mod``'s CSCDPart, local
    indices through loc2glob when ``local``."""
    C = sp.coo_matrix(A)
    out = []
    for ch in np.array_split(np.arange(C.nnz), nparts):
        r, c, v = C.row[ch], C.col[ch], C.data[ch]
        if local:
            gl = np.unique(np.concatenate([r, c]))
            out.append(mod.CSCDPart(rows=np.searchsorted(gl, r),
                                    cols=np.searchsorted(gl, c),
                                    vals=v.copy(), loc2glob=gl))
        else:
            out.append(mod.CSCDPart(rows=r, cols=c, vals=v.copy()))
    return out


def _same_parts(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f))
        assert (p.loc2glob is None) == (q.loc2glob is None)


@pytest.mark.parametrize("local", [True, False])
def test_cscd_host_code_matches_reference(local):
    A = laplacian_2d(7).to_scipy()
    n = A.shape[0]
    port, ref = _parts(D, A, 3, local), _parts(JD, A, 3, local)
    _same(D.assemble_distributed(n, port), JD.assemble_distributed(n, ref))
    owners = np.array_split(np.random.default_rng(1).permutation(n)[:n - 5], 3)
    for keep in (False, True):
        _same_parts(D.redispatch(n, port, owners, keep_remote=keep),
                    JD.redispatch(n, ref, owners, keep_remote=keep))
    for mode in ("add", "keep", "ovw"):
        _same_parts([D.cscd_addlocal(port[0], port[1], mode)],
                    [JD.cscd_addlocal(ref[0], ref[1], mode)])
    b_parts = [np.arange(p.loc2glob.size if local else n, dtype=float)
               for p in port]
    np.testing.assert_array_equal(D.gather_rhs(n, port, b_parts),
                                  JD.gather_rhs(n, ref, b_parts))


def test_dspsolve_over_four_parts():
    A = poisson_3d(6).to_scipy()
    n = A.shape[0]
    parts = _parts(D, A, 4, local=True)
    x_true = np.random.default_rng(2).standard_normal(n)
    b = A @ x_true
    owner = np.full(n, -1)
    for i, p in enumerate(parts):  # each dof's b counted once
        owner[p.loc2glob[owner[p.loc2glob] < 0]] = i
    b_parts = [np.where(owner[p.loc2glob] == i, b[p.loc2glob], 0.0)
               for i, p in enumerate(parts)]
    xs = D.dspsolve(n, parts, b_parts, PastixConfig(tile_size=16,
                                                     verbosity=0),
                    device="cpu")
    x = np.zeros(n)
    for p, xp in zip(parts, xs):
        x[p.loc2glob] = xp
    assert _res(A, x, b) <= TOL


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------


@pytest.mark.parametrize("args", [
    ["--refine", "gmres", "--steps"],
    ["--refine", "bicgstab", "--nrhs", "2"],
], ids=["gmres-steps", "bicgstab-nrhs2"])
def test_cli_end_to_end(capsys, args):
    assert cli_main(["-lap3", "6", "--tile", "16", "--cpu", "-q",
                     "--eps-refine", "1e-11", *args]) == 0
    out = capsys.readouterr().out
    r = float(out.split("residual ||b-Ax||/||b|| = ")[1].split()[0])
    assert r <= TOL
    if "--steps" in args:
        assert float(out.split("reuse residual = ")[1].split()[0]) <= TOL


@pytest.mark.parametrize("flag,slice_", [
    (["--mesh", "2"], "slice 5"), (["--ooc", "1"], "slice 4"),
    (["--fact", "ldlh"], "slice 3"), (["--dtype", "f64"], "slice 3"),
    (["--dtype", "c64"], "slice 3"),
], ids=["mesh", "ooc", "ldlh", "f64", "c64"])
def test_cli_unported_flags_name_their_slice(flag, slice_):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {slice_}"):
        cli_main(["-lap3", "4", "--cpu", "-q", *flag])


def test_cli_without_cpu_wants_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["-lap3", "4", "-q"])
