"""Nested-dissection ordering.

The reference delegates fill-reducing ordering to the external Scotch /
METIS libraries (called from ``pastix_task_scotch`` in
``src/sopalin/src/pastix.c`` with strategy knobs IPARM_ORDERING_* —
SURVEY.md section 2 row 3).  This module is our own replacement: recursive
graph bisection by BFS level structures from a pseudo-peripheral vertex
(choosing the narrowest level set near the median as the vertex separator),
with small leaf subgraphs ordered by reverse Cuthill-McKee.

The separator-last recursion is exactly what makes the later TPU schedule
wide: all leaf subtrees are independent and factor as one big batched level.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph

from pastix_tpu_torch.order.structs import Order


def _bfs_levels(adj: sp.csr_matrix, start: int) -> np.ndarray:
    """Level (hop distance) of every vertex from start; -1 if unreachable."""
    n = adj.shape[0]
    level = np.full(n, -1, dtype=np.int64)
    level[start] = 0
    frontier = np.array([start], dtype=np.int64)
    d = 0
    indptr, indices = adj.indptr, adj.indices
    while frontier.size:
        d += 1
        # gather all neighbors of the frontier
        nbr = indices[
            np.concatenate(
                [np.arange(indptr[v], indptr[v + 1]) for v in frontier]
            )
        ] if frontier.size < 1024 else None
        if nbr is None:
            # vectorized gather for big frontiers
            starts = indptr[frontier]
            ends = indptr[frontier + 1]
            counts = ends - starts
            idx = np.repeat(starts, counts) + (
                np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
            )
            nbr = indices[idx]
        nbr = np.unique(nbr)
        nbr = nbr[level[nbr] == -1]
        level[nbr] = d
        frontier = nbr
    return level


def _pseudo_peripheral(adj: sp.csr_matrix) -> tuple[int, np.ndarray]:
    """Double-BFS pseudo-peripheral vertex + its level structure."""
    # start from min-degree vertex
    deg = np.diff(adj.indptr)
    start = int(np.argmin(deg))
    lev = _bfs_levels(adj, start)
    for _ in range(2):
        far = int(np.argmax(np.where(lev >= 0, lev, -1)))
        lev2 = _bfs_levels(adj, far)
        if lev2.max() <= lev.max():
            return far, lev2
        start, lev = far, lev2
    return start, lev


def _order_leaf(adj: sp.csr_matrix, verts: np.ndarray) -> np.ndarray:
    """Order a small leaf subgraph with RCM (returns verts in order)."""
    if verts.size <= 2:
        return verts
    sub = adj[verts][:, verts]
    p = csgraph.reverse_cuthill_mckee(sp.csr_matrix(sub), symmetric_mode=True)
    return verts[p]


def nested_dissection(
    pattern: sp.csc_matrix,
    leaf_size: int = 64,
    max_levels: int = 64,
    balance: float = 0.28,
) -> Order:
    """Compute a nested-dissection Order for a symmetric pattern.

    Returns peritab segments leaf..leaf..separator recursively; rangtab
    boundaries are recorded at every leaf and separator so downstream
    supernode detection starts from the ND structure.
    """
    n = pattern.shape[0]
    adj = sp.csr_matrix(pattern.astype(bool))
    adj.setdiag(False)
    adj.eliminate_zeros()

    peritab = np.empty(n, dtype=np.int64)
    bounds = [0]
    pos = 0

    def emit(verts_in_order: np.ndarray):
        nonlocal pos
        k = verts_in_order.size
        if k == 0:
            return
        peritab[pos : pos + k] = verts_in_order
        pos += k
        bounds.append(pos)

    # explicit stack of (vertex set, depth, phase) to avoid recursion limits;
    # we emit A's ordering, then B's, then the separator S — so process with
    # a small recursive structure via python recursion on reduced depth
    import sys

    sys.setrecursionlimit(10000)

    def rec(verts: np.ndarray, depth: int):
        if verts.size == 0:
            return
        if verts.size <= leaf_size or depth >= max_levels:
            emit(_order_leaf(adj, verts))
            return
        sub = sp.csr_matrix(adj[verts][:, verts])
        ncomp, labels = csgraph.connected_components(sub, directed=False)
        if ncomp > 1:
            for c in range(ncomp):
                rec(verts[labels == c], depth)
            return
        _, lev = _pseudo_peripheral(sub)
        nlev = int(lev.max()) + 1
        if nlev < 3:
            # graph is too dense/shallow to bisect; order as a leaf
            emit(_order_leaf(adj, verts))
            return
        # cumulative sizes per level; pick separator level near the median
        sizes = np.bincount(lev, minlength=nlev)
        cum = np.cumsum(sizes)
        total = verts.size
        lo = np.searchsorted(cum, balance * total)
        hi = np.searchsorted(cum, (1.0 - balance) * total)
        lo = max(1, min(lo, nlev - 2))
        hi = max(lo, min(hi, nlev - 2))
        cand = np.arange(lo, hi + 1)
        s = int(cand[np.argmin(sizes[cand])])
        maskA = lev < s
        maskS = lev == s
        maskB = lev > s
        # shrink the separator: keep only level-s vertices adjacent to B
        sverts = np.where(maskS)[0]
        if maskB.any():
            subS = sub[sverts]
            touchesB = (subS[:, np.where(maskB)[0]].sum(axis=1).A.ravel()) > 0
            moveA = sverts[~touchesB]
            maskA[moveA] = True
            maskS[moveA] = False
        A = verts[maskA]
        B = verts[maskB]
        S = verts[maskS]
        # hybrid dispatch (mirrors native/ordering.cpp): a separator this
        # wide means the subgraph doesn't bisect — order it with minimum
        # degree instead of recursing (expander-like irregular graphs)
        if S.size > 0.12 * verts.size and verts.size > leaf_size:
            from pastix_tpu_torch.native import native_amd

            pat_sub = sp.csc_matrix(sub + sp.eye(sub.shape[0], dtype=bool))
            peri = native_amd(pat_sub)
            if peri is None and verts.size <= 4000:
                from pastix_tpu_torch.order.mmd import minimum_degree

                peri = minimum_degree(pat_sub)
            if peri is not None:
                emit(verts[peri])
                return
        if A.size == 0 or B.size == 0:
            emit(_order_leaf(adj, verts))
            return
        rec(A, depth + 1)
        rec(B, depth + 1)
        if S.size:
            emit(_order_leaf(adj, S))

    rec(np.arange(n, dtype=np.int64), 0)
    assert pos == n, f"ND emitted {pos} of {n} vertices"
    permtab = np.empty(n, dtype=np.int64)
    permtab[peritab] = np.arange(n, dtype=np.int64)
    return Order(
        permtab=permtab,
        peritab=peritab,
        rangtab=np.asarray(bounds, dtype=np.int64),
    )
