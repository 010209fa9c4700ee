"""Incremental assembly via the Murge-style API (reference src/murge/).

Build a 1D stiffness matrix element by element (graph phase then assembly
phase), solve, then re-assemble scaled values reusing the analysis.
``python -m pastix_tpu_torch.examples.murge_assembly [--device cpu]``
"""

import sys

import numpy as np

from pastix_tpu_torch.examples import split_device
from pastix_tpu_torch.murge import MurgeSolver


def main(argv=None):
    device, _ = split_device(sys.argv[1:] if argv is None else argv)
    n = 200
    m = MurgeSolver(n, device=device)

    m.graph_begin()
    for e in range(n - 1):  # 1D P1 elements
        m.graph_edge([e, e, e + 1, e + 1], [e, e + 1, e, e + 1])
    m.graph_end()

    m.assembly_begin(MurgeSolver.ADD)
    for e in range(n - 1):
        m.assembly_set_value([e, e, e + 1, e + 1], [e, e + 1, e, e + 1],
                             [1.0, -1.0, -1.0, 1.0])
    # pin the first dof (Dirichlet) by a diagonal shift — same phase:
    # each assembly phase builds a fresh matrix (MURGE semantics)
    m.assembly_set_value(0, 0, 1e6)
    m.assembly_end()

    A = m.matrix.to_scipy()
    b = A @ np.ones(n)
    x = m.solve(b)
    r = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    print(f"assembled n={n} residual {r:.3e}")
    return 0 if r < 1e-8 else 1


if __name__ == "__main__":
    sys.exit(main())
