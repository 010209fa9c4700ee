"""The port imports no JAX, nothing of the JAX package ``pastix_tpu``, and
uses no Pallas, torch.compile or fused attention.  The import check runs
in a subprocess: conftest.py has already imported JAX into this one.
That subprocess then runs tests/test_torch_host.py's solves (one fresh
interpreter serves both)."""

import ast
import functools
import json
import os
import subprocess
import sys

import pytest

import torch

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pastix_tpu_torch")
SLICE_MODULES = [
    "pastix_tpu_torch",
    "pastix_tpu_torch._build",
    "pastix_tpu_torch._device",
    "pastix_tpu_torch.analyze",
    "pastix_tpu_torch.cli",
    "pastix_tpu_torch.config",
    "pastix_tpu_torch.convert",
    "pastix_tpu_torch.distributed",
    "pastix_tpu_torch.drivers",
    "pastix_tpu_torch.generators",
    "pastix_tpu_torch.krylov",
    "pastix_tpu_torch.murge",
    "pastix_tpu_torch.native",
    "pastix_tpu_torch.numeric.block",
    "pastix_tpu_torch.numeric.cache",
    "pastix_tpu_torch.numeric.chol_inv",
    "pastix_tpu_torch.numeric.dma_probe",
    "pastix_tpu_torch.numeric.factorize",
    "pastix_tpu_torch.numeric.fused",
    "pastix_tpu_torch.numeric.kernels",
    "pastix_tpu_torch.numeric.leftlook",
    "pastix_tpu_torch.numeric.pipelined",
    "pastix_tpu_torch.numeric.slab",
    "pastix_tpu_torch.numeric.sweep_kernels",
    "pastix_tpu_torch.numeric.tile_factor",
    "pastix_tpu_torch.order",
    "pastix_tpu_torch.pastix",
    "pastix_tpu_torch.refine",
    "pastix_tpu_torch.solve",
    "pastix_tpu_torch.sparse",
    "pastix_tpu_torch.symbolic",
]


# the port's front doors on the CPU, run after the imports (held by
# tests/test_torch_host.py::test_port_runs_without_jax_or_pastix_tpu)
SOLVES = (
    "import numpy as np\n"
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
    "from pastix_tpu_torch.distributed import CSCDPart, dspsolve\n"
    "M = A.to_scipy().tocoo()\n"
    "xs = dspsolve(A.n, [CSCDPart(M.row, M.col, M.data)], [b],\n"
    "              P.PastixConfig(tile_size=16), device='cpu')\n"
    "assert np.abs(xs[0] - 1).max() < 1e-9\n"
    "from pastix_tpu_torch.pastix import pastix\n"
    "M = M.tocsc()\n"
    "x, rep = pastix(A.n, M.indptr, M.indices, M.data, b,\n"
    "                P.PastixConfig(tile_size=16), device='cpu')\n"
    "assert np.abs(x - 1).max() < 1e-9 and rep.residual <= 1e-10\n"
)


@functools.cache
def fresh_interpreter():
    """One fresh interpreter for both checks that need one: it imports
    every module of the slice, prints the jax and pastix_tpu modules then
    loaded (one JSON line), runs :data:`SOLVES` and prints them again.
    Returns (exit code, stdout lines, stderr)."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import pastix_tpu_torch as P\n"
        "P.Pastix, P.spsolve\n"
        "bad = lambda: sorted(m for m in sys.modules if m in ('jax', "
        "'pastix_tpu') or m.startswith(('jax.', 'jaxlib', 'pastix_tpu.')))\n"
        "print(json.dumps(bad()), flush=True)\n"
        + SOLVES +
        "print(json.dumps(bad()))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    return r.returncode, r.stdout.splitlines(), r.stderr


def test_import_leaves_jax_out():
    _, lines, err = fresh_interpreter()
    assert lines, err
    assert json.loads(lines[0]) == []


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_source_uses_no_jax_pallas_or_compile(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            names = []
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib"), f"imports {n}"
            assert "pallas" not in n, f"imports {n}"
            # nothing of the reference package, JAX-free modules included
            assert root != "pastix_tpu", f"imports {n}"
        if isinstance(node, ast.Attribute):
            assert node.attr not in (
                "compile", "scaled_dot_product_attention"
            ), f"uses .{node.attr}"
