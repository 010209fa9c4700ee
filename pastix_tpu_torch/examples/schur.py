"""Schur complement extraction (reference src/example/src/schur.c).

Mark a set of unknowns; they are ordered last and left unfactored; the
dense Schur complement block comes back for the caller to handle (domain
decomposition / coupling workflows), then the full system is solved via
the Schur path.  ``python -m pastix_tpu_torch.examples.schur [--device cpu]``
"""

import sys

import numpy as np

from pastix_tpu_torch import PastixConfig
from pastix_tpu_torch.examples import split_device
from pastix_tpu_torch.generators import laplacian_2d
from pastix_tpu_torch.pastix import Pastix


def main(argv=None):
    device, _ = split_device(sys.argv[1:] if argv is None else argv)
    A = laplacian_2d(20)
    S = A.to_scipy()
    n = A.n
    schur_dofs = np.arange(n - 12, n)  # last 12 dofs

    solver = Pastix(A, PastixConfig(), device=device)
    solver.set_schur_unknowns(schur_dofs)
    solver.factorize()

    Sc = solver.get_schur()
    print(f"Schur block: {Sc.shape}, symmetric err "
          f"{np.abs(Sc - Sc.T).max():.2e}")

    b = S @ np.ones(n)
    x = solver.solve_with_schur(b)
    r = np.linalg.norm(b - S @ x) / np.linalg.norm(b)
    print(f"solve-with-schur residual = {r:.3e}")
    return 0 if r < 1e-8 else 1


if __name__ == "__main__":
    sys.exit(main())
