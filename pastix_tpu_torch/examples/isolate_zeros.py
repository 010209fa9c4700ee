"""Zero-diagonal isolation (reference src/example/src/isolate_zeros.c).

Saddle-point style systems carry unknowns with zero diagonal entries
(constraints / Lagrange multipliers) that break unpivoted symmetric
panels.  The workflow: detect them (``isolate_zero_diagonals``), mark
them as Schur unknowns so they are ordered last and left unfactored,
then solve through the dense Schur path.
``python -m pastix_tpu_torch.examples.isolate_zeros [--device cpu]``
"""

import sys

import numpy as np
import scipy.sparse as sp

from pastix_tpu_torch import Factorization, PastixConfig
from pastix_tpu_torch.examples import split_device
from pastix_tpu_torch.generators import laplacian_2d
from pastix_tpu_torch.pastix import Pastix
from pastix_tpu_torch.sparse import SparseMatrix, isolate_zero_diagonals


def main(argv=None):
    device, _ = split_device(sys.argv[1:] if argv is None else argv)
    # 2D Laplacian augmented with equality constraints (zero diagonal):
    # [K  C^T; C  0] — a small contact/multiplier-style saddle point
    K = laplacian_2d(16).to_scipy()
    n0 = K.shape[0]
    nc = 6
    rng = np.random.default_rng(0)
    C = sp.csr_matrix(
        (np.ones(nc), (np.arange(nc), rng.choice(n0, nc, replace=False))),
        shape=(nc, n0),
    )
    A = sp.bmat([[K, C.T], [C, None]], format="csc")
    n = A.shape[0]

    zeros = isolate_zero_diagonals(A)
    print(f"zero-diagonal unknowns: {zeros.size} (expected {nc})")
    if zeros.size != nc:
        return 1

    cfg = PastixConfig(factorization=Factorization.LDLT)
    solver = Pastix(SparseMatrix.from_scipy(A), cfg, device=device)
    solver.set_schur_unknowns(zeros)
    solver.factorize()

    b = A @ np.ones(n)
    x = solver.solve_with_schur(b)
    r = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    print(f"isolate-zeros residual = {r:.3e}")
    return 0 if r < 1e-8 else 1


if __name__ == "__main__":
    sys.exit(main())
