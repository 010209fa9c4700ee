"""Phase-by-phase solve with pattern reuse (reference step-by-step.c).

Runs each task explicitly (order -> symbfact -> analyze -> factorize ->
solve), then re-factorizes NEW values on the SAME pattern without redoing
the analysis — the production workflow for time-stepping / Newton loops.
``python -m pastix_tpu_torch.examples.step_by_step [--device cpu]``
"""

import sys
import time

import numpy as np

from pastix_tpu_torch import PastixConfig, drivers
from pastix_tpu_torch.examples import split_device
from pastix_tpu_torch.pastix import Pastix


def main(argv=None):
    device, _ = split_device(sys.argv[1:] if argv is None else argv)
    A = drivers.read_matrix("lap3:16")
    S = A.to_scipy()
    b = S @ np.ones(A.n)

    solver = Pastix(A, PastixConfig(verbosity=1), device=device)
    solver.order()
    solver.symbfact()
    solver.analyze()

    t0 = time.perf_counter()
    solver.factorize()
    x = solver.solve(b)
    print(f"first factorize+solve: {time.perf_counter() - t0:.2f}s  "
          f"residual {np.linalg.norm(b - S @ x) / np.linalg.norm(b):.2e}")

    for step in range(3):  # new values, same pattern: analysis is cached
        scale = 2.0 + step
        t0 = time.perf_counter()
        solver.factorize(scale * A.values)
        x = solver.solve(scale * b)
        r = np.linalg.norm(scale * b - scale * S @ x) / np.linalg.norm(scale * b)
        print(f"reuse step {step}: {time.perf_counter() - t0:.3f}s residual {r:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
