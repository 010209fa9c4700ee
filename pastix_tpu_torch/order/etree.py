"""Elimination-tree machinery: etree, postorder, column counts, levels.

The reference gets the etree implicitly through Scotch/fax and explicitly in
``src/kass/src/find_supernodes.c`` / ``src/blend/src/elimin.c`` (SURVEY.md
section 2 rows 5 and 7).  We implement the classic algorithms (Liu's etree
with path compression; Gilbert–Ng–Peyton column counts) on numpy arrays —
these run once per sparsity pattern on the host.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def etree(pattern: sp.csc_matrix) -> np.ndarray:
    """Elimination tree of a symmetric pattern (full pattern expected).

    Returns parent[j] (or -1 for roots). Liu's algorithm with path
    compression, O(nnz * alpha).
    """
    from pastix_tpu_torch.native import native_etree

    res = native_etree(pattern)
    if res is not None:
        return res
    n = pattern.shape[0]
    indptr, indices = pattern.indptr, pattern.indices
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        for p in range(indptr[j], indptr[j + 1]):
            i = indices[p]
            if i >= j:
                continue
            # climb from i to the root of its current tree, compressing
            while i != -1 and i < j:
                inext = ancestor[i]
                ancestor[i] = j
                if inext == -1:
                    parent[i] = j
                i = inext
    return parent


def postorder(parent: np.ndarray) -> np.ndarray:
    """Postorder of the forest given by parent[] (iterative DFS)."""
    from pastix_tpu_torch.native import native_postorder

    res = native_postorder(parent)
    if res is not None:
        return res
    n = parent.shape[0]
    # build child lists (head/next representation)
    head = np.full(n, -1, dtype=np.int64)
    nxt = np.full(n, -1, dtype=np.int64)
    for j in range(n - 1, -1, -1):
        p = parent[j]
        if p != -1:
            nxt[j] = head[p]
            head[p] = j
    post = np.empty(n, dtype=np.int64)
    k = 0
    stack = []
    for root in range(n):
        if parent[root] != -1:
            continue
        stack.append(root)
        while stack:
            node = stack[-1]
            child = head[node]
            if child == -1:
                post[k] = node
                k += 1
                stack.pop()
            else:
                head[node] = nxt[child]
                stack.append(child)
    if k != n:
        raise ValueError("parent[] is not a forest")
    return post


def _leaf(i, j, first, maxfirst, prevleaf, ancestor):
    """Gilbert-Ng-Peyton leaf test (returns (lca_or_-1, jleaf))."""
    if i <= j or first[j] <= maxfirst[i]:
        return -1, 0
    maxfirst[i] = first[j]
    jprev = prevleaf[i]
    prevleaf[i] = j
    if jprev == -1:
        return i, 1
    # LCA of jprev and j via path compression on ancestor[]
    q = jprev
    while q != ancestor[q]:
        q = ancestor[q]
    s = jprev
    while s != q:
        sparent = ancestor[s]
        ancestor[s] = q
        s = sparent
    return q, 2


def col_counts(pattern: sp.csc_matrix, parent: np.ndarray, post: np.ndarray) -> np.ndarray:
    """Exact per-column counts of nnz(L(:, j)) including the diagonal.

    Gilbert–Ng–Peyton algorithm, O(nnz * alpha).  ``pattern`` is the full
    symmetric pattern. Feeds the symbolic cost model (DPARM_FILL_IN /
    IPARM_NNZEROS analogs) and fundamental-supernode detection.
    """
    from pastix_tpu_torch.native import native_colcounts

    res = native_colcounts(pattern, parent, post)
    if res is not None:
        return res
    n = pattern.shape[0]
    # per-column lists of the strict lower part: {i > j : A(i,j) != 0}
    L = sp.tril(pattern, k=-1, format="csc")
    indptr, indices = L.indptr, L.indices

    delta = np.zeros(n, dtype=np.int64)
    first = np.full(n, -1, dtype=np.int64)
    # first[j] = first postorder descendant position
    for k in range(n):
        j = post[k]
        delta[j] = 1 if first[j] == -1 else 0
        while j != -1 and first[j] == -1:
            first[j] = k
            j = parent[j]

    maxfirst = np.full(n, -1, dtype=np.int64)
    prevleaf = np.full(n, -1, dtype=np.int64)
    ancestor = np.arange(n, dtype=np.int64)
    for k in range(n):
        j = post[k]
        if parent[j] != -1:
            delta[parent[j]] -= 1
        for p in range(indptr[j], indptr[j + 1]):
            i = indices[p]  # i > j with A(i, j) != 0
            q, jleaf = _leaf(i, j, first, maxfirst, prevleaf, ancestor)
            if jleaf >= 1:
                delta[j] += 1
            if jleaf == 2:
                delta[q] -= 1
        if parent[j] != -1:
            ancestor[j] = parent[j]
    counts = delta.copy()
    for j in post:
        if parent[j] != -1:
            counts[parent[j]] += counts[j]
    return counts


def tree_levels(parent: np.ndarray) -> np.ndarray:
    """Depth of each node from its root (root depth 0)."""
    n = parent.shape[0]
    depth = np.full(n, -1, dtype=np.int64)
    for j in range(n - 1, -1, -1):
        if depth[j] != -1:
            continue
        path = []
        i = j
        while i != -1 and depth[i] == -1:
            path.append(i)
            i = parent[i]
        base = 0 if i == -1 else depth[i] + 1
        for off, node in enumerate(reversed(path)):
            depth[node] = base + off
    return depth


def fundamental_supernodes(
    parent: np.ndarray, counts: np.ndarray
) -> np.ndarray:
    """Fundamental supernode ranges (rangtab) from etree + column counts.

    Column j extends the supernode of j-1 iff parent[j-1]==j, j-1 is j's
    only child, and count[j] == count[j-1] - 1 (identical row pattern below
    the diagonal).  Reference anchor: kass/find_supernodes.c.
    """
    n = parent.shape[0]
    nchild = np.zeros(n + 1, dtype=np.int64)
    for j in range(n):
        nchild[parent[j]] += 1  # parent==-1 accumulates at [-1] == [n]
    boundaries = [0]
    for j in range(1, n):
        merge = (
            parent[j - 1] == j
            and nchild[j] == 1
            and counts[j] == counts[j - 1] - 1
        )
        if not merge:
            boundaries.append(j)
    boundaries.append(n)
    return np.asarray(boundaries, dtype=np.int64)


def amalgamate(
    rangtab: np.ndarray,
    parent: np.ndarray,
    counts: np.ndarray,
    max_extra_fill_pct: float = 10.0,
    min_width: int = 8,
) -> np.ndarray:
    """Relaxed supernode amalgamation (kass/amalgamate.c equivalent).

    Merges a child supernode into its etree-parent supernode when either it
    is narrower than ``min_width`` or the zeros introduced stay below
    ``max_extra_fill_pct`` percent of the merged supernode — on TPU this
    doubles as tile-shape shaping: wider panels feed the MXU better
    (IPARM_AMALGAMATION_LEVEL analog).
    """
    nsup = rangtab.shape[0] - 1
    if nsup <= 1:
        return rangtab
    widths = np.diff(rangtab).astype(np.int64)
    # supernode of each column
    snode = np.repeat(np.arange(nsup, dtype=np.int64), widths)
    # supernodal etree: parent supernode of s = snode[parent[last col of s]]
    keep = np.ones(nsup, dtype=bool)
    heights = counts[rangtab[:-1]].astype(np.int64)  # rows below+diag at first col
    last_parent = parent[rangtab[1:] - 1]
    sparent = np.where(last_parent != -1, snode[last_parent], -1)
    # merged supernodes alias to their representative (union-find with path
    # halving) — replaces the O(nsup^2) child-redirect rewrite
    alias = np.arange(nsup + 1, dtype=np.int64)  # slot nsup = root (-1)

    def find(x):
        while alias[x] != x:
            alias[x] = alias[alias[x]]
            x = alias[x]
        return x

    # merge bottom-up when child's parent supernode is the next supernode
    # (contiguity is required to keep rangtab an interval partition)
    for s in range(nsup - 1, -1, -1):
        sp0 = sparent[s]
        p = find(sp0) if sp0 != -1 else -1
        if p != s + 1:
            continue
        w_c, w_p = widths[s], widths[p]
        h_c, h_p = heights[s], heights[p]
        merged_w = w_c + w_p
        merged_h = w_c + h_p  # child columns now span down to parent's rows
        useful = w_c * h_c + w_p * h_p
        padded = merged_w * merged_h
        extra = 100.0 * max(0, padded - useful) / max(1, useful)
        if w_c < min_width or extra <= max_extra_fill_pct:
            # merge: drop boundary between s and s+1
            widths[p] = merged_w
            heights[p] = merged_h
            keep[s] = False
            alias[s] = p  # children pointing at s now resolve to p
    new_bounds = [0]
    start = 0
    for s in range(nsup):
        if keep[s]:
            # supernode s ends a merged run starting at rangtab[start]
            new_bounds.append(int(rangtab[s + 1]))
            start = s + 1
    if new_bounds[-1] != rangtab[-1]:
        new_bounds.append(int(rangtab[-1]))
    return np.asarray(new_bounds, dtype=np.int64)
