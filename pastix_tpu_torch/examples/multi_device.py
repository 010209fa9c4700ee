"""Multi-device solve over a mesh of ranks (reference
``examples/multi_device.py``; the reference's pastix() under mpirun,
SURVEY.md §2 parallelism table).

The same ``PastixConfig`` runs on 1 or N ranks: ``mesh_shape`` routes
the phases through the owner-computes sharded-pool path (each rank holds
about npool/ranks tiles of the factor, the reference's local
SolverMatrix a rank), with a halo all_gather and a fan-in all_reduce a
level over the tp axis and the RHS columns split over dp.  The ranks are
started by ``parallel.launch.run_ranks``: one a card under NCCL when
there are enough cards, else gloo ranks sharing them; ``--device cpu``
runs gloo processes on the host.

    python -m pastix_tpu_torch.examples.multi_device [--ranks N] [--device cpu]
"""

import sys

import numpy as np

from pastix_tpu_torch.examples import split_device


def _rank(rank, ranks, device):
    from pastix_tpu_torch import Pastix, PastixConfig
    from pastix_tpu_torch.generators import poisson_3d

    A = poisson_3d(12)
    S = A.to_scipy()
    rng = np.random.default_rng(0)
    B = S @ rng.standard_normal((A.n, 4))
    dp = 2 if ranks % 2 == 0 and ranks >= 4 else 1
    tp = ranks // dp
    solver = Pastix(
        A,
        PastixConfig(
            tile_size=16 if device == "cpu" else 32,
            mesh_shape=(dp, tp) if dp > 1 else (tp,),
            mesh_axis_names=("dp", "tp") if dp > 1 else ("tp",),
        ),
        device="cpu" if device == "cpu" else None,
    )
    X = solver.solve(B)
    res = np.linalg.norm(S @ X - B) / np.linalg.norm(B)
    sh = solver._pool_sharding
    return [
        f"mesh=({dp}x{tp}) n={A.n} pool sharded {sh.ndev} x {sh.nloc} "
        f"tiles (global {solver.layout.npool})",
        f"residual ||b-Ax||/||b|| = {res:.3e}",
    ], res


def main(argv=None):
    import torch

    from pastix_tpu_torch.parallel.launch import run_ranks

    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    cards = torch.cuda.device_count() if device != "cpu" else 0
    ranks = 4 if device == "cpu" else max(cards, 1)
    if "--ranks" in argv:
        ranks = int(argv[argv.index("--ranks") + 1])
    devices = None if device == "cpu" else [r % max(cards, 1)
                                           for r in range(ranks)]
    backend = "nccl" if device != "cpu" and cards >= ranks else "gloo"
    out = run_ranks(_rank, ranks, backend, devices,
                    args=(ranks, device), threads=1 if device == "cpu" else 0)
    lines, res = out[0]
    for line in lines:
        print(line)
    return 0 if res < 1e-9 else 1


if __name__ == "__main__":
    sys.exit(main())
