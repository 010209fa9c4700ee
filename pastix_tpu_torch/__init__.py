"""pastix_tpu_torch — the PyTorch/CUDA port of ``pastix_tpu``.

The same sparse direct solver on an NVIDIA H100: the host analysis of
``pastix_tpu`` (ordering, symbolic factorization, tile layout; none of it
imports JAX) is shared, and the device side runs in PyTorch with
hand-written CUDA kernels in place of the Pallas kernels.  This first
slice covers real LLᵗ end to end; see ROADMAP.md for what follows.

The package never imports JAX.
"""

from pastix_tpu.config import Factorization, PastixConfig, RefinementMethod, SolveReport

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: pastix.py pulls in torch and the whole numeric stack
    if name in ("Pastix", "spsolve"):
        import importlib

        return getattr(importlib.import_module("pastix_tpu_torch.pastix"), name)
    raise AttributeError(name)


__all__ = ["Factorization", "PastixConfig", "RefinementMethod", "SolveReport",
           "Pastix", "spsolve"]
