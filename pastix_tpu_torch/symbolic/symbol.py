"""SymbolMatrix: the supernodal block structure of L.

Equivalent of the reference's ``SymbolMatrix`` container
(``src/symbol/src/symbol.h``: ``SymbolCblk{fcolnum,lcolnum,bloknum}``,
``SymbolBlok{frownum,lrownum,cblknum}``) with ``symbolCheck``
(symbol_check.c), ``symbolCost`` (symbol_cost.c — exact nnz(L) and flop
predictions feeding IPARM_NNZEROS / DPARM_FILL_IN / DPARM_FACT_FLOPS),
``symbolSave/Load`` (symbol_io.c) and ``symbolDraw`` (symbol_draw.c) —
SURVEY.md section 2 row 6.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class SymbolMatrix:
    """Block-column (supernode) structure of the factor.

    Column blocks (cblk) k spans new-index columns
    ``rangtab[k]:rangtab[k+1]``.  Off-diagonal blocks are stored in a flat
    CSC-like layout: block b belongs to column block ``blok_cblk_owner`` and
    covers rows ``blok_frownum[b]:blok_lrownum[b]+1`` inside target column
    block ``blok_target[b]``.  The diagonal block of every cblk is implicit
    (block 0 of the cblk in the reference; here excluded from bloktab).
    """

    rangtab: np.ndarray  # int64[cblknbr+1], column ranges
    blok_ptr: np.ndarray  # int64[cblknbr+1] — off-diag blocks of cblk k
    blok_frownum: np.ndarray  # int64[bloknbr]
    blok_lrownum: np.ndarray  # int64[bloknbr] (inclusive)
    blok_target: np.ndarray  # int64[bloknbr] — target cblk index

    @property
    def n(self) -> int:
        return int(self.rangtab[-1])

    @property
    def cblknbr(self) -> int:
        return self.rangtab.shape[0] - 1

    @property
    def bloknbr(self) -> int:
        return self.blok_frownum.shape[0]

    def cblk_width(self, k: int) -> int:
        return int(self.rangtab[k + 1] - self.rangtab[k])

    def check(self) -> None:
        """symbolCheck equivalent: structural invariants."""
        r = self.rangtab
        if r[0] != 0 or np.any(np.diff(r) <= 0):
            raise ValueError("rangtab invalid")
        if self.blok_ptr[0] != 0 or np.any(np.diff(self.blok_ptr) < 0):
            raise ValueError("blok_ptr invalid")
        if self.blok_ptr[-1] != self.bloknbr:
            raise ValueError("blok_ptr[-1] != bloknbr")
        for k in range(self.cblknbr):
            lo, hi = self.blok_ptr[k], self.blok_ptr[k + 1]
            prev_end = r[k + 1] - 1
            for b in range(lo, hi):
                f, l, t = self.blok_frownum[b], self.blok_lrownum[b], self.blok_target[b]
                if f > l:
                    raise ValueError(f"block {b}: empty row range")
                if f <= prev_end:
                    raise ValueError(f"block {b}: rows not increasing within cblk {k}")
                if not (r[t] <= f and l < r[t + 1]):
                    raise ValueError(f"block {b}: rows outside target cblk {t}")
                if t <= k:
                    raise ValueError(f"block {b}: target not strictly below cblk {k}")
                prev_end = l

    # --- cost model (symbolCost equivalent) ---------------------------

    def nnz_l(self) -> int:
        """Exact nnz(L) of the supernodal structure (incl. diagonal blocks,
        lower triangle of the diagonal block counted in full panel width)."""
        w = np.diff(self.rangtab)
        diag = (w * (w + 1)) // 2
        bh = self.blok_lrownum - self.blok_frownum + 1
        off = np.zeros(self.cblknbr, dtype=np.int64)
        np.add.at(off, np.repeat(np.arange(self.cblknbr), np.diff(self.blok_ptr)), bh)
        return int(diag.sum() + (off * w).sum())

    def fact_flops(self, kind: str = "llt") -> float:
        """Predicted factorization flops (DPARM_FACT_FLOPS analog).

        Supernodal formula: per cblk of width w with h off-diagonal rows,
        potrf(w) + trsm(w, h) + update h^2 w (symmetric half counted).
        """
        w = np.diff(self.rangtab).astype(np.float64)
        bh = (self.blok_lrownum - self.blok_frownum + 1).astype(np.float64)
        h = np.zeros(self.cblknbr, dtype=np.float64)
        np.add.at(h, np.repeat(np.arange(self.cblknbr), np.diff(self.blok_ptr)), bh)
        potrf = w**3 / 3.0
        trsm = w * w * h
        update = w * h * (h + 1.0)
        total = float((potrf + trsm + update).sum())
        if kind == "lu":
            total *= 2.0
        return total

    # --- io ------------------------------------------------------------

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            rangtab=self.rangtab,
            blok_ptr=self.blok_ptr,
            blok_frownum=self.blok_frownum,
            blok_lrownum=self.blok_lrownum,
            blok_target=self.blok_target,
        )

    @classmethod
    def load(cls, path: str) -> "SymbolMatrix":
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        z = np.load(path)
        return cls(**{k: z[k].astype(np.int64) for k in z.files})

    def draw(self, path: str) -> None:
        """symbolDraw equivalent — writes a PNG of the block structure."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.patches import Rectangle

        fig, ax = plt.subplots(figsize=(8, 8))
        n = self.n
        for k in range(self.cblknbr):
            c0, c1 = self.rangtab[k], self.rangtab[k + 1]
            ax.add_patch(
                Rectangle((c0, c0), c1 - c0, c1 - c0, fill=True, color="0.55", lw=0.2)
            )
            for b in range(self.blok_ptr[k], self.blok_ptr[k + 1]):
                f, l = self.blok_frownum[b], self.blok_lrownum[b]
                ax.add_patch(
                    Rectangle((c0, f), c1 - c0, l - f + 1, fill=True, color="0.2", lw=0.1)
                )
        ax.set_xlim(0, n)
        ax.set_ylim(n, 0)
        ax.set_aspect("equal")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
