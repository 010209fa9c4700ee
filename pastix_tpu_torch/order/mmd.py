"""Approximate minimum-degree ordering on the quotient graph.

Fill-reducing alternative to nested dissection — the reference exposes this
family through Scotch's internal orderings / METIS; selected here via
``OrderingMethod.AMD`` (IPARM_ORDERING analog, SURVEY.md section 2 row 3).

Quotient-graph elimination with lazily-updated approximate external degrees
(Amestoy–Davis–Duff style upper bound), no supervariable detection — kept
simple because ND is the default for large problems and this path serves
leaves / moderate n.
"""

from __future__ import annotations

import heapq

import numpy as np
import scipy.sparse as sp


def minimum_degree(pattern: sp.csc_matrix) -> np.ndarray:
    """Return peritab (elimination order: position -> vertex)."""
    n = pattern.shape[0]
    A = sp.csr_matrix(pattern.astype(bool))
    A.setdiag(False)
    A.eliminate_zeros()

    var_adj = [set(A.indices[A.indptr[i] : A.indptr[i + 1]].tolist()) for i in range(n)]
    var_elems: list[set] = [set() for _ in range(n)]
    elem_vars: dict[int, set] = {}
    alive = np.ones(n, dtype=bool)
    degree = np.array([len(s) for s in var_adj], dtype=np.int64)

    heap = [(int(degree[v]), v) for v in range(n)]
    heapq.heapify(heap)
    order = np.empty(n, dtype=np.int64)
    next_elem = 0

    for k in range(n):
        # pop a live vertex whose recorded degree is current
        while True:
            d, p = heapq.heappop(heap)
            if alive[p] and d == degree[p]:
                break
        alive[p] = False
        order[k] = p

        # new element's variable set Lp = reach(p)
        Lp = set(v for v in var_adj[p] if alive[v])
        for e in var_elems[p]:
            Lp.update(v for v in elem_vars[e] if alive[v])
        Lp.discard(p)

        e_new = next_elem
        next_elem += 1
        elem_vars[e_new] = Lp

        absorbed = var_elems[p]
        for v in Lp:
            var_adj[v].difference_update(var_adj[p])
            var_adj[v].discard(p)
            var_elems[v].difference_update(absorbed)
            var_elems[v].add(e_new)
            # approximate external degree (upper bound)
            d = len(var_adj[v]) + len(Lp) - 1
            for e in var_elems[v]:
                if e != e_new:
                    d += len(elem_vars[e])
            degree[v] = d
            heapq.heappush(heap, (int(d), v))
        for e in absorbed:
            elem_vars.pop(e, None)
        var_adj[p] = set()
        var_elems[p] = set()

    return order
