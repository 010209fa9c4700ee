"""Phase-by-phase memory report (reference src/example/src/plot_memory_usage.c).

The reference example tracks memAlloc() usage through the phases and plots
it; here each phase reports its dominant allocations from the analysis
metadata (pastix_getMemoryUsage analog: SolveReport.memory_bytes plus the
host-side artifact sizes), printed as a table, and on a card the device
memory PyTorch's allocator held at its peak::

    python -m pastix_tpu_torch.examples.memory_usage -lap3 24 [--device cpu]
"""

import sys

import numpy as np
import torch

from pastix_tpu_torch import PastixConfig, drivers
from pastix_tpu_torch.examples import split_device
from pastix_tpu_torch.pastix import Pastix


def _mb(x):
    return f"{x / 1e6:9.2f} MB"


def main(argv=None):
    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    src = "lap3:16"
    if argv and argv[0] == "-lap":
        src = f"lap:{argv[1]}"
    elif argv and argv[0] == "-lap3":
        src = f"lap3:{argv[1]}"
    elif argv:
        src = argv[0]
    A = drivers.read_matrix(src)
    S = A.to_scipy()

    solver = Pastix(A, PastixConfig(), device=device)
    cuda = solver.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(solver.device)
    rows = []
    rows.append(("input CSC", S.data.nbytes + S.indices.nbytes + S.indptr.nbytes))

    solver.order()
    o = solver.order_
    rows.append(
        ("ordering (perm/iperm/rangtab)",
         o.permtab.nbytes + o.peritab.nbytes + o.rangtab.nbytes)
    )

    solver.symbfact()
    sym = solver.symbol_
    sym_bytes = sum(
        np.asarray(getattr(sym, f)).nbytes
        for f in ("rangtab", "blok_ptr", "blok_frownum", "blok_lrownum",
                  "blok_target")
        if hasattr(sym, f)
    )
    rows.append(("symbol structure", sym_bytes))

    solver.analyze()
    rows.append(("device factor pool (peak)", solver.report.memory_bytes))

    solver.factorize()
    f = solver.factors
    pool_live = sum(p.numel() * p.element_size()
                    for p in (f.pool, f.pool_u) if p is not None)
    rows.append(("device factor pool (resident)", pool_live))

    b = S @ np.ones(A.n)
    x = solver.solve(b)
    r = np.linalg.norm(b - S @ x) / np.linalg.norm(b)
    if cuda:
        rows.append(("device allocator peak",
                     torch.cuda.max_memory_allocated(solver.device)))

    print(f"n={A.n} nnz={A.nnz} nnz(L)={solver.report.nnz_l_exact} "
          f"fill={solver.report.fill_ratio:.2f}x")
    for name, size in rows:
        print(f"  {name:32s} {_mb(size)}")
    print(f"residual = {r:.3e}")
    return 0 if r < 1e-8 else 1


if __name__ == "__main__":
    sys.exit(main())
