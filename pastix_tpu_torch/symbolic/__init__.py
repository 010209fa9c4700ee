"""Symbolic factorization phase (reference phase 2: pastix_task_fax).

Pipeline: etree → column counts → fundamental supernodes → amalgamation →
block symbolic factorization → SymbolMatrix (+ cost model).
Reference anchors: src/fax, src/kass, src/symbol (SURVEY.md §2 rows 4-6).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.order import (
    Order,
    etree,
    postorder,
    col_counts,
    fundamental_supernodes,
    amalgamate,
)
from pastix_tpu_torch.symbolic.symbol import SymbolMatrix
from pastix_tpu_torch.symbolic.fax import symbolic_factorization, supernodal_etree

__all__ = [
    "SymbolMatrix",
    "symbolic_factorization",
    "supernodal_etree",
    "compute_symbolic",
]


def compute_symbolic(
    pattern_perm: sp.csc_matrix,
    order: Order,
    config: PastixConfig | None = None,
):
    """Full symbolic phase on the *permuted* pattern.

    Returns (symbol, scalar_info) where scalar_info carries the exact
    scalar cost model numbers (nnz(L), flops) and the etree.
    """
    config = config or PastixConfig()
    parent = etree(pattern_perm)
    post = postorder(parent)
    counts = col_counts(pattern_perm, parent, post)
    rangtab = fundamental_supernodes(parent, counts)
    rangtab = amalgamate(
        rangtab,
        parent,
        counts,
        max_extra_fill_pct=float(config.amalgamation_level),
        min_width=config.min_tile_size // 2,
    )
    symbol = symbolic_factorization(pattern_perm, rangtab)
    h = counts.astype(np.float64) - 1.0
    scalar_info = {
        "parent": parent,
        "post": post,
        "col_counts": counts,
        "nnz_l_exact": int(counts.sum()),
        "flops_exact": float((1.0 + h + h * (h + 1.0)).sum()),
    }
    return symbol, scalar_info
