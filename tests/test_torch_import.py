"""The port imports no JAX, nothing of the JAX package ``pastix_tpu``, and
uses no Pallas, torch.compile or fused attention.  The import check runs
in a subprocess: conftest.py has already imported JAX into this one."""

import ast
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
    "pastix_tpu_torch.config",
    "pastix_tpu_torch.convert",
    "pastix_tpu_torch.generators",
    "pastix_tpu_torch.krylov",
    "pastix_tpu_torch.native",
    "pastix_tpu_torch.numeric.block",
    "pastix_tpu_torch.numeric.chol_inv",
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


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import pastix_tpu_torch as P\n"
        "P.Pastix, P.spsolve\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'pastix_tpu') "
        "or m.startswith(('jax.', 'jaxlib', 'pastix_tpu.')))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


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
