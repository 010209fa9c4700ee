"""Block symbolic factorization — the fax equivalent.

Computes the supernodal block pattern of L from (permuted pattern, supernode
partition): for each supernode, the set of off-diagonal rows it touches,
split into dense blocks at contiguity and supernode boundaries.

Reference anchor: ``symbolFaxGraph`` (``src/fax/src/symbol_fax_graph.c``
wrapping ``symbol_fax.c``) — quotient-graph supernodal symbolic
factorization, near-linear time (SURVEY.md section 2 row 4).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from pastix_tpu_torch.symbolic.symbol import SymbolMatrix


def symbolic_factorization(
    pattern: sp.csc_matrix, rangtab: np.ndarray
) -> SymbolMatrix:
    """Supernodal symbolic factorization.

    ``pattern``: full symmetric boolean pattern of the *permuted* matrix.
    ``rangtab``: supernode column ranges (int64[cblknbr+1]).
    """
    n = pattern.shape[0]
    nsup = rangtab.shape[0] - 1

    from pastix_tpu_torch.native import native_symbolic

    res = native_symbolic(pattern, rangtab)
    if res is not None:
        blok_ptr, frow, lrow, targ = res
        return SymbolMatrix(
            rangtab=np.asarray(rangtab, dtype=np.int64),
            blok_ptr=blok_ptr,
            blok_frownum=frow,
            blok_lrownum=lrow,
            blok_target=targ,
        )

    A = sp.csc_matrix(pattern)

    snode = np.zeros(n, dtype=np.int64)
    for k in range(nsup):
        snode[rangtab[k] : rangtab[k + 1]] = k

    # initial rows per supernode: union of A's sub-diagonal rows over its cols
    # (restricted to rows strictly below the supernode's last column)
    indptr, indices = A.indptr, A.indices
    pending: list[list[np.ndarray]] = [[] for _ in range(nsup)]
    struct: list[np.ndarray] = [None] * nsup  # type: ignore

    blok_ptr = np.zeros(nsup + 1, dtype=np.int64)
    frows: list[np.ndarray] = []
    lrows: list[np.ndarray] = []
    targs: list[np.ndarray] = []

    for k in range(nsup):
        c0, c1 = rangtab[k], rangtab[k + 1]
        arows = indices[indptr[c0] : indptr[c1]]
        arows = arows[arows >= c1]
        parts = pending[k]
        parts.append(arows)
        rows = np.unique(np.concatenate(parts)) if len(parts) > 1 else np.unique(arows)
        struct[k] = rows
        pending[k] = []  # free
        if rows.size:
            parent = int(snode[rows[0]])
            # pass struct(k) minus the parent's own columns up the tree
            inherit = rows[rows >= rangtab[parent + 1]]
            if inherit.size:
                pending[parent].append(inherit)
            # split rows into blocks: break at gaps or supernode boundaries
            rs = snode[rows]
            brk = np.flatnonzero((np.diff(rows) > 1) | (np.diff(rs) != 0)) + 1
            starts = np.concatenate(([0], brk))
            ends = np.concatenate((brk, [rows.size]))
            frows.append(rows[starts])
            lrows.append(rows[ends - 1])
            targs.append(rs[starts])
            blok_ptr[k + 1] = blok_ptr[k] + starts.size
        else:
            frows.append(np.empty(0, dtype=np.int64))
            lrows.append(np.empty(0, dtype=np.int64))
            targs.append(np.empty(0, dtype=np.int64))
            blok_ptr[k + 1] = blok_ptr[k]

    return SymbolMatrix(
        rangtab=np.asarray(rangtab, dtype=np.int64),
        blok_ptr=blok_ptr,
        blok_frownum=np.concatenate(frows) if frows else np.empty(0, np.int64),
        blok_lrownum=np.concatenate(lrows) if lrows else np.empty(0, np.int64),
        blok_target=np.concatenate(targs) if targs else np.empty(0, np.int64),
    )


def supernodal_etree(symbol: SymbolMatrix) -> np.ndarray:
    """Parent supernode of each supernode (-1 for roots)."""
    nsup = symbol.cblknbr
    parent = np.full(nsup, -1, dtype=np.int64)
    for k in range(nsup):
        lo, hi = symbol.blok_ptr[k], symbol.blok_ptr[k + 1]
        if hi > lo:
            parent[k] = symbol.blok_target[lo]
    return parent
