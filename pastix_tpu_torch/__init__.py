"""pastix_tpu_torch — the PyTorch/CUDA port of ``pastix_tpu``.

The same sparse direct solver on an NVIDIA H100.  The host analysis
(ordering, symbolic factorization, tile layout, the native C++ library)
is the package's own copy of ``pastix_tpu``'s; the device side runs in
PyTorch with hand-written CUDA kernels in place of the Pallas kernels.
Real LLᵗ, LDLᵗ and LU run end to end, their Schur complements included;
see ROADMAP.md for what follows.

The package imports neither JAX nor anything of ``pastix_tpu``.
"""

from pastix_tpu_torch.config import Factorization, PastixConfig, RefinementMethod, SolveReport

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: pastix.py pulls in torch and the whole numeric stack
    if name in ("Pastix", "spsolve"):
        import importlib

        return getattr(importlib.import_module("pastix_tpu_torch.pastix"), name)
    raise AttributeError(name)


__all__ = ["Factorization", "PastixConfig", "RefinementMethod", "SolveReport",
           "Pastix", "spsolve"]
