"""The port's examples (``pastix_tpu_torch/examples``) run in this
process on the CPU (``--device cpu``) at the arguments of the
reference's ``tests/test_examples.py``, each printing the lines that test
asserts (``examples.CHECKS``) and returning 0 (each checks its own residual or error against
1e-8, as the reference's scripts do).  ``multi_device`` starts rank
processes: ``tests/test_torch_mesh.py`` runs it (``examples.MESH_CHECKS``)."""

import pkgutil
import runpy
import sys

import pytest
import torch

from pastix_tpu_torch import examples
from pastix_tpu_torch.examples import CHECKS, MESH_CHECKS, NAMES

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)


def test_every_example_is_checked():
    """Every module of the examples package is in its tables."""
    mods = {m.name for m in pkgutil.iter_modules(examples.__path__)}
    assert mods == set(NAMES) | set(MESH_CHECKS)


@pytest.mark.parametrize("name", NAMES)
def test_example(name, monkeypatch, capsys):
    args, lines = CHECKS[name]
    monkeypatch.setattr(sys, "argv", [name, *args, "--device", "cpu"])
    with pytest.raises(SystemExit) as done:
        runpy.run_module(f"pastix_tpu_torch.examples.{name}",
                         run_name="__main__")
    out = capsys.readouterr().out
    assert done.value.code == 0, out
    for line in lines:
        assert line in out
