"""The multi-device dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``): ``dryrun_multichip(n)`` starts ``n`` ranks
(``launch.run_ranks``: gloo processes on the CPU by default, NCCL on
cards with ``device="cuda"``), solves a 3D Poisson system through the
public ``mesh_shape`` path (owner-computes, a dp axis of 2 when ``n`` is
even and at least 4), then prints the owner plan's balance and the
static scaling sweep of both distribution strategies, with the
reference's checks.  ``python -m pastix_tpu_torch.parallel.dryrun 4``;
``PASTIX_DRYRUN_NX`` (default 37, the reference's 50,653 unknowns) or
``nx=`` sizes it.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def _rank(rank: int, n_devices: int, nx: int, device: str) -> list:
    from pastix_tpu_torch.config import PastixConfig
    from pastix_tpu_torch.generators import poisson_3d
    from pastix_tpu_torch.parallel.owner import (
        build_pool_sharding, distribution_report,
    )
    from pastix_tpu_torch.parallel.subtree import subtree_report
    from pastix_tpu_torch.pastix import Pastix

    dp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    tp = n_devices // dp
    A = poisson_3d(nx)
    # T=16 as the reference; the card's kernels take 32, 64 or 128
    solver = Pastix(
        A,
        PastixConfig(
            tile_size=16 if device == "cpu" else 32,
            mesh_shape=(dp, tp) if dp > 1 else (tp,),
            mesh_axis_names=("dp", "tp") if dp > 1 else ("tp",),
        ),
        device=None if device != "cpu" else "cpu",
    )
    rng = np.random.default_rng(0)
    nrhs = 2 * dp
    X = rng.standard_normal((A.n, nrhs))
    B = A.to_scipy() @ X
    Xs = solver.solve(B)
    res = np.linalg.norm(B - A.to_scipy() @ Xs) / np.linalg.norm(B)
    assert solver._mesh is not None, "mesh path not taken"
    assert solver._pool_sharding is not None, "owner-computes path not taken"
    assert res < 1e-6, f"multichip dryrun residual too high: {res}"
    layout, tail = solver.layout, solver._dense_tail
    lines = [
        f"dryrun_multichip OK: mesh=(dp={dp},tp={tp}) n={A.n} "
        f"tiles={layout.npool} levels={len(layout.levels)} residual={res:.2e}"
        f" dense_tail_m={solver.report.dense_tail_m}"
    ]
    # static balance/comm accounting of the owner plan
    rep = distribution_report(layout, solver._pool_sharding, dense_tail=tail)
    gf = rep["flops"] / 1e9
    lines.append(
        f"owner plan balance: tiles/dev {rep['tiles'].tolist()} "
        f"flops/dev [{', '.join(f'{g:.2f}' for g in gf)}] GF "
        f"(imbalance {100*rep['flop_imbalance']:.1f}%) "
        f"halo {rep['halo_bytes'].sum()/2**20:.1f} MiB total"
    )
    # static scaling sweep for both strategies, host-side on the same
    # layout (no mesh needed)
    prev_halo_dev = None
    for nd in (4, 8, 16):
        sh = build_pool_sharding(layout, nd, dense_tail=tail)
        rep = distribution_report(layout, sh, dense_tail=tail)
        halo_dev = rep["halo_bytes"].sum() / nd / 2**20
        lines.append(
            f"scale owner nd={nd}: flop imbalance "
            f"{100*rep['flop_imbalance']:.1f}% halo/dev {halo_dev:.1f} MiB "
            f"(total {rep['halo_bytes'].sum()/2**20:.1f})"
        )
        assert rep["flop_imbalance"] < 0.30, "owner plan imbalance >30%"
        if prev_halo_dev is not None:
            # per-device halo must shrink as devices are added
            assert halo_dev < prev_halo_dev * 1.05, "halo/dev not shrinking"
        prev_halo_dev = halo_dev
    for nd in (4, 8, 16):
        rep = subtree_report(layout, nd)
        lines.append(
            f"scale subtree nd={nd}: local imbalance "
            f"{100*rep['local_imbalance']:.1f}% shared "
            f"{100*rep['shared_frac']:.1f}% boundary "
            f"{rep['boundary_bytes']/2**20:.1f} MiB"
        )
        assert rep["shared_frac"] < 0.75, "shared top dominates"
    return lines


def dryrun_multichip(n_devices: int, nx=None, device: str = "cpu",
                     threads: int = 1) -> list:
    """Run the multi-device step on ``n_devices`` ranks and print rank
    0's report (returned as lines).  ``device="cpu"``: gloo processes
    (``threads`` each); ``"cuda"``: NCCL with a card a rank when there
    are enough, else gloo ranks sharing the cards."""
    import torch

    from pastix_tpu_torch.parallel.launch import run_ranks

    nx = int(nx or os.environ.get("PASTIX_DRYRUN_NX", "37"))
    devices, backend = None, "gloo"
    if device != "cpu":
        cards = torch.cuda.device_count()
        devices = [r % max(cards, 1) for r in range(n_devices)]
        backend = "nccl" if cards >= n_devices else "gloo"
    out = run_ranks(_rank, n_devices, backend, devices,
                    args=(n_devices, nx, device), threads=threads)
    for line in out[0]:
        print(line)
    return out[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
