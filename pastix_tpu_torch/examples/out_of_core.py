"""Out-of-core factorization under a device memory budget (reference
src/example + IPARM_OOC_LIMIT; src/sopalin/src/ooc.c pages coeftab
blocks DURING factorization).

The host pool is the backing store; the device holds one segment
window (plus chunked GEMM transients) at a time, so the max problem
size is bounded by host RAM instead of device memory.  Tiles of 32 (the
reference's example takes 16, which the card's kernels do not).

Run: ``python -m pastix_tpu_torch.examples.out_of_core [--device cpu]``
"""

import sys

import numpy as np

from pastix_tpu_torch import PastixConfig
from pastix_tpu_torch.examples import split_device
from pastix_tpu_torch.generators import poisson_3d
from pastix_tpu_torch.pastix import Pastix


def main(argv=None):
    device, _ = split_device(sys.argv[1:] if argv is None else argv)
    A = poisson_3d(14)
    S = A.to_scipy()
    b = S @ np.ones(A.n)
    solver = Pastix(
        A, PastixConfig(tile_size=32, ooc=True, ooc_limit_mb=1, verbosity=1),
        device=device,
    )
    x = solver.solve(b)
    plan = solver._ooc_plan
    pool_mb = solver.layout.npool * solver.layout.T**2 * 4 / 2**20
    print(
        f"n={A.n} pool={pool_mb:.1f} MB streamed in "
        f"{len(plan.segments)} segments under a 1 MB window budget "
        f"(chunked transients: {plan.gemm_chunk} tiles)"
    )
    res = np.linalg.norm(S @ x - b) / np.linalg.norm(b)
    print(f"residual ||b-Ax||/||b|| = {res:.3e}")
    return 0 if res < 1e-9 else 1


if __name__ == "__main__":
    sys.exit(main())
