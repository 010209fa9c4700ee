"""pastix_tpu_torch — the PyTorch/CUDA port of ``pastix_tpu``.

The same sparse direct solver on an NVIDIA H100.  The host analysis
(ordering, symbolic factorization, tile layout, the native C++ library)
is the package's own copy of ``pastix_tpu``'s; the device side runs in
PyTorch with hand-written CUDA kernels in place of the Pallas kernels.
Real LLᵗ, LDLᵗ and LU run end to end, their Schur complements included,
with every refinement method, and behind the reference's front ends
(``pastix()``, ``MurgeSolver``, the CSCD ``distributed`` module, the
matrix ``drivers`` and ``python -m pastix_tpu_torch.cli``); see
ROADMAP.md for what follows.

The package imports neither JAX nor anything of ``pastix_tpu``.
"""

from pastix_tpu_torch.config import (
    PastixConfig,
    SolveReport,
    Factorization,
    Symmetry,
    OrderingMethod,
    RefinementMethod,
    IOStrategy,
    Verbosity,
    Task,
)
from pastix_tpu_torch.sparse import SparseMatrix, check_matrix
from pastix_tpu_torch import generators

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: pastix.py pulls in torch and the whole numeric stack
    # (importlib, not `from ... import`: the submodule shares the name of
    # the pastix() function, which would recurse through this hook)
    import importlib

    if name in ("Pastix", "spsolve", "pastix"):
        return getattr(importlib.import_module("pastix_tpu_torch.pastix"), name)
    if name == "MurgeSolver":
        return importlib.import_module("pastix_tpu_torch.murge").MurgeSolver
    if name == "drivers":
        return importlib.import_module("pastix_tpu_torch.drivers")
    raise AttributeError(name)


__all__ = [
    "PastixConfig",
    "SolveReport",
    "Factorization",
    "Symmetry",
    "OrderingMethod",
    "RefinementMethod",
    "IOStrategy",
    "Verbosity",
    "Task",
    "SparseMatrix",
    "check_matrix",
    "generators",
    "Pastix",
    "spsolve",
    "pastix",
    "MurgeSolver",
    "drivers",
]
