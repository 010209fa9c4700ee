"""Ordering phase (reference phase 1: pastix_task_scotch — SURVEY.md §1/§2).

Dispatch over OrderingMethod; all methods return an :class:`Order` whose
rangtab is a first-cut supernode partition (refined by the symbolic phase).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph

from pastix_tpu_torch.config import OrderingMethod, PastixConfig
from pastix_tpu_torch.order.structs import Order
from pastix_tpu_torch.order.etree import (
    etree,
    postorder,
    col_counts,
    tree_levels,
    fundamental_supernodes,
    amalgamate,
)
from pastix_tpu_torch.order.nd import nested_dissection
from pastix_tpu_torch.order.mmd import minimum_degree

__all__ = [
    "Order",
    "compute_ordering",
    "etree",
    "postorder",
    "col_counts",
    "tree_levels",
    "fundamental_supernodes",
    "amalgamate",
    "nested_dissection",
    "minimum_degree",
]


def compute_ordering(
    pattern: sp.csc_matrix,
    config: PastixConfig | None = None,
    method: OrderingMethod | None = None,
    user_perm: np.ndarray | None = None,
    card: bool = False,
) -> Order:
    """Compute a fill-reducing ordering of a full symmetric pattern.

    ``pattern`` must be the symmetrized boolean pattern with diagonal
    (SparseMatrix.pattern_sym_scipy()).  ``card``: the factorization runs
    on the card, whose tile sizes start at 32 (``resolve_tile_size``).
    """
    config = config or PastixConfig()
    method = method or config.ordering
    n = pattern.shape[0]
    # ND leaves sized to the tile grid: a leaf that fits one tile column
    # neither splits into level chains nor pads (see config.nd_leaf_size)
    leaf_size = config.nd_leaf_size or config.resolve_tile_size(n, card)

    if method == OrderingMethod.PERSONAL:
        if user_perm is None:
            raise ValueError("PERSONAL ordering requires user_perm")
        permtab = np.asarray(user_perm, dtype=np.int64)
        peritab = np.empty(n, dtype=np.int64)
        peritab[permtab] = np.arange(n, dtype=np.int64)
        return Order(permtab, peritab, np.array([0, n], dtype=np.int64))

    if method == OrderingMethod.NATURAL:
        return Order.identity(n)

    if method == OrderingMethod.ND:
        # native (C++) nested dissection when the toolchain is available;
        # same algorithm in Python otherwise
        from pastix_tpu_torch.native import native_nested_dissection

        res = native_nested_dissection(
            pattern, leaf_size=leaf_size,
            max_levels=config.nd_max_levels,
        )
        if res is not None:
            peritab, rangtab = res
            permtab = np.empty(n, dtype=np.int64)
            permtab[peritab] = np.arange(n, dtype=np.int64)
            order = Order(permtab, peritab, rangtab)
        else:
            order = nested_dissection(
                pattern, leaf_size=leaf_size,
                max_levels=config.nd_max_levels,
            )
        if config.cluster_supernode_rows:
            order = cluster_supernode_rows(pattern, order)
        return order

    if method == OrderingMethod.AMD:
        # native approximate minimum degree (quotient graph, supervariables,
        # element absorption — native/amd.cpp); Python MMD fallback
        from pastix_tpu_torch.native import native_amd

        peritab = native_amd(pattern)
        if peritab is None:
            peritab = minimum_degree(pattern)
        permtab = np.empty(n, dtype=np.int64)
        permtab[peritab] = np.arange(n, dtype=np.int64)
        return Order(permtab, peritab, np.array([0, n], dtype=np.int64))

    if method == OrderingMethod.RCM:
        peritab = csgraph.reverse_cuthill_mckee(
            sp.csr_matrix(pattern), symmetric_mode=True
        ).astype(np.int64)
        permtab = np.empty(n, dtype=np.int64)
        permtab[peritab] = np.arange(n, dtype=np.int64)
        return Order(permtab, peritab, np.array([0, n], dtype=np.int64))

    raise ValueError(f"unsupported ordering method: {method}")


def cluster_supernode_rows(pattern: sp.spmatrix, order: Order) -> Order:
    """Permute dofs *within* each supernode so that rows referenced by the
    same descendants land in the same row tiles.

    A separator dof's off-diagonal rows appear in every ancestor panel that
    updates it; on the tile grid a T-row band costs full T rows as soon as
    one of its rows is touched.  Sorting each supernode's dofs by the
    earliest permuted descendant that neighbors them clusters rows with
    identical reachers, cutting stored tiles and padded flops (~9% on the
    48^3 Poisson bench at T=128) at zero fill cost — the supernode
    partition, and hence the elimination structure, is unchanged.  This
    has no reference analog: PaStiX's SymbolBlok row *intervals* are
    scalar-exact (src/symbol/src/symbol.h), so only the tile grid benefits.
    """
    n = order.permtab.size
    rang = order.rangtab
    if rang.size <= 2:
        return order
    C = sp.coo_matrix(pattern)
    pr = order.permtab[C.row]
    pc = order.permtab[C.col]
    widths = np.diff(rang)
    snode = np.repeat(np.arange(widths.size, dtype=np.int64), widths)
    start = rang[snode]
    # key(c) = min permuted neighbor index strictly below c's supernode
    keys = np.full(n, np.inf)
    mask = pr < start[pc]
    np.minimum.at(keys, pc[mask], pr[mask])
    # stable sort by (supernode, key): ties keep the current relative order
    within = np.lexsort((keys, snode))
    new_peri = order.peritab[within]
    new_perm = np.empty(n, dtype=np.int64)
    new_perm[new_peri] = np.arange(n, dtype=np.int64)
    return Order(new_perm, new_peri, rang.copy())
