"""One-call solve (reference src/example/src/simple.c).

Read or generate a matrix, build b = A @ 1, solve, print the relative
residual — the de-facto smoke test:
``python -m pastix_tpu_torch.examples.simple -lap 100 [--device cpu]``.
"""

import sys

import numpy as np

from pastix_tpu_torch import drivers
from pastix_tpu_torch.examples import split_device
from pastix_tpu_torch.pastix import spsolve


def main(argv=None):
    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    src = "lap:100"
    if argv and argv[0] == "-lap":
        src = f"lap:{argv[1]}"
    elif argv and argv[0] == "-lap3":
        src = f"lap3:{argv[1]}"
    elif argv:
        src = argv[0]
    A = drivers.read_matrix(src)
    S = A.to_scipy()
    b = S @ np.ones(A.n)
    x = spsolve(S, b, device=device)
    r = np.linalg.norm(b - S @ x) / np.linalg.norm(b)
    print(f"n={A.n} residual ||b-Ax||/||b|| = {r:.3e}")
    return 0 if r < 1e-8 else 1


if __name__ == "__main__":
    sys.exit(main())
