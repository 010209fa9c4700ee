"""Distributed-input solve (reference src/example/src/simple_dist.c).

Each "rank" owns a strip of rows of a 2D Laplacian as a CSCD part in
LOCAL numbering with a ``loc2glob`` dof map (owned rows + ghost columns
— the FEM subdomain layout of ``dpastix``'s distributed CSC), plus the
RHS entries of its owned rows; ``dspsolve`` assembles (summing overlap),
solves once, and scatters the solution back into each part's dofs.
``python -m pastix_tpu_torch.examples.simple_dist [--device cpu]``
"""

import sys

import numpy as np

from pastix_tpu_torch.distributed import CSCDPart, dspsolve
from pastix_tpu_torch.examples import split_device
from pastix_tpu_torch.generators import laplacian_2d


def main(argv=None):
    device, _ = split_device(sys.argv[1:] if argv is None else argv)
    nx = 20
    A = laplacian_2d(nx).to_scipy().tocoo()
    n = A.shape[0]
    nparts = 4
    owner = np.minimum(A.row * nparts // n, nparts - 1)

    x_true = np.ones(n)
    b = A.tocsr() @ x_true

    parts, b_parts = [], []
    for p in range(nparts):
        m = owner == p
        gr, gc, gv = A.row[m], A.col[m], A.data[m]
        loc2glob = np.unique(np.concatenate([gr, gc]))  # owned + ghosts
        g2l = {g: l for l, g in enumerate(loc2glob)}
        lr = np.array([g2l[g] for g in gr])
        lc = np.array([g2l[g] for g in gc])
        parts.append(CSCDPart(rows=lr, cols=lc, vals=gv, loc2glob=loc2glob))
        bl = np.zeros(loc2glob.size)
        owned = (loc2glob * nparts // n == p) | (
            (p == nparts - 1) & (loc2glob * nparts // n >= p)
        )
        bl[owned] = b[loc2glob[owned]]
        b_parts.append(bl)

    x_parts = dspsolve(n, parts, b_parts, rhs_mode="add", device=device)
    err = max(
        np.abs(xp - x_true[pt.loc2glob]).max()
        for xp, pt in zip(x_parts, parts)
    )
    print(f"distributed solve: {nparts} parts, n={n}, max error = {err:.3e}")
    return 0 if err < 1e-8 else 1


if __name__ == "__main__":
    sys.exit(main())
