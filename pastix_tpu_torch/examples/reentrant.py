"""Multiple independent solver instances (reference reentrant.c).

Two Pastix instances with different matrices/configs coexist; each keeps
its own cached analysis and factors (pastix_data_t instances don't share
state), including use from worker threads.
``python -m pastix_tpu_torch.examples.reentrant [--device cpu]``
"""

import sys
import threading

import numpy as np

from pastix_tpu_torch import Factorization, PastixConfig
from pastix_tpu_torch.examples import split_device
from pastix_tpu_torch.generators import laplacian_2d, poisson_3d
from pastix_tpu_torch.pastix import Pastix


def run(A, cfg, device, out, key):
    S = A.to_scipy()
    b = S @ np.ones(A.n)
    x = Pastix(A, cfg, device=device).solve(b)
    out[key] = np.linalg.norm(b - S @ x) / np.linalg.norm(b)


def main(argv=None):
    device, _ = split_device(sys.argv[1:] if argv is None else argv)
    jobs = {
        "llt-2d": (laplacian_2d(24), PastixConfig()),
        "ldlt-3d": (poisson_3d(8), PastixConfig(factorization=Factorization.LDLT)),
    }
    out = {}
    threads = [
        threading.Thread(target=run, args=(A, cfg, device, out, k))
        for k, (A, cfg) in jobs.items()
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ok = len(out) == len(jobs)
    for k, r in out.items():
        print(f"{k}: residual {r:.3e}")
        ok &= r < 1e-8
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
