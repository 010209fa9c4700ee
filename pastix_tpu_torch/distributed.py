"""Distributed-input assembly — the dpastix / CSCD analog (a copy of
``pastix_tpu/distributed.py`` with its import paths changed and a
``device`` for ``dspsolve``'s solver).

The reference's ``dpastix()`` accepts a per-rank CSCD (local columns +
``loc2glob``), redistributes it to the solver's distribution
(``cscd_redispatch`` in cscd_utils — SURVEY.md section 2 row 1 and call
stack 3.2), and optionally returns the solution in the caller's
distribution.  Under JAX's single-controller model there is no MPI rank
boundary (nor in the port, which solves on one device): the same
workflow is "parts in, global solve, parts out":

    parts = [CSCDPart(loc2glob=..., rows=..., cols=..., vals=...), ...]
    x_parts = dspsolve(n, parts, b_parts)     # per-part local RHS/solution

Each part's (rows, cols) may be local (indexed into loc2glob) or already
global (loc2glob=None); duplicate entries across parts are summed, exactly
like ``cscd_redispatch`` + assembly with CSCD_ADD.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp

from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.sparse import SparseMatrix


@dataclasses.dataclass
class CSCDPart:
    """One caller-side chunk of the matrix (a reference CSCD per rank).

    ``loc2glob``: global dof of each local index (None = already global).
    ``rows``/``cols``: COO indices, local when loc2glob is given.
    ``vals``: entries; duplicates (within and across parts) are summed.
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    loc2glob: Optional[np.ndarray] = None

    def global_coo(self):
        r = np.asarray(self.rows, dtype=np.int64)
        c = np.asarray(self.cols, dtype=np.int64)
        v = np.asarray(self.vals)
        if self.loc2glob is not None:
            l2g = np.asarray(self.loc2glob, dtype=np.int64)
            r = l2g[r]
            c = l2g[c]
        return r, c, v


def assemble_distributed(n: int, parts: Sequence[CSCDPart]) -> SparseMatrix:
    """Merge CSCD parts into one global matrix (duplicates summed)."""
    rs, cs, vs = [], [], []
    for p in parts:
        r, c, v = p.global_coo()
        if r.size and (r.max() >= n or c.max() >= n):
            raise ValueError(
                f"part index out of range: max ({int(r.max())}, {int(c.max())}) "
                f"for n={n}"
            )
        rs.append(r)
        cs.append(c)
        vs.append(v)
    r = np.concatenate(rs) if rs else np.empty(0, np.int64)
    c = np.concatenate(cs) if cs else np.empty(0, np.int64)
    v = np.concatenate(vs) if vs else np.empty(0)
    return SparseMatrix.from_coo(n, r, c, v)


def redispatch(
    n: int,
    parts: Sequence[CSCDPart],
    loc2globs: Sequence[np.ndarray],
    keep_remote: bool = False,
) -> list[CSCDPart]:
    """Re-map a CSCD distribution onto a new column ownership —
    the ``cscd_redispatch`` analog (cscd_utils, SURVEY.md §2 row 1).

    ``loc2globs``: for each target part, the global dofs it owns (column
    ownership, as in the reference's internal solver distribution).  Every
    input entry is routed to the target part owning its *column*, with
    duplicates pre-summed per part (reference redispatch + CSCD_ADD
    semantics).  Entries whose column no target owns are dropped unless
    ``keep_remote`` (then a trailing extra part collects them).  Output
    parts carry global indices (loc2glob=None) so they compose with
    :func:`assemble_distributed`/:func:`dspsolve` unchanged.
    """
    owner = np.full(n, -1, np.int64)
    for k, l2g in enumerate(loc2globs):
        l2g = np.asarray(l2g, dtype=np.int64)
        if (owner[l2g] != -1).any():
            raise ValueError("loc2globs overlap: a column has two owners")
        owner[l2g] = k
    rs, cs, vs = [], [], []
    for p in parts:
        r, c, v = p.global_coo()
        rs.append(r)
        cs.append(c)
        vs.append(v)
    r = np.concatenate(rs) if rs else np.empty(0, np.int64)
    c = np.concatenate(cs) if cs else np.empty(0, np.int64)
    v = np.concatenate(vs) if vs else np.empty(0)
    out = []
    targets = list(range(len(loc2globs))) + ([-1] if keep_remote else [])
    for k in targets:
        sel = owner[c] == k
        rk, ck, vk = r[sel], c[sel], v[sel]
        key = rk * n + ck
        uk, inv = np.unique(key, return_inverse=True)
        vsum = np.zeros(uk.size, dtype=v.dtype if v.size else np.float64)
        np.add.at(vsum, inv, vk)
        out.append(CSCDPart(rows=uk // n, cols=uk % n, vals=vsum))
    return out


def cscd_addlocal(
    a: CSCDPart, b: CSCDPart, mode: str = "add"
) -> CSCDPart:
    """Merge CSCD ``b`` into ``a`` — the ``cscd_addlocal`` analog
    (cscd_utils, SURVEY.md §2 row 1).

    ``mode`` mirrors the reference's CSCD_ADD / CSCD_KEEP / CSCD_OVW:
      "add"  — duplicate entries are summed;
      "keep" — ``a``'s value wins on duplicates (b only fills new slots);
      "ovw"  — ``b``'s value wins on duplicates.
    Matching the reference, the merge is restricted to ``a``'s (local)
    column set: ``b`` entries in columns absent from ``a`` are dropped
    (the reference adds B into A's CSCD structure, which only has A's
    columns).  The result carries global indices (loc2glob=None).
    """
    if mode not in ("add", "keep", "ovw"):
        raise ValueError(f"unknown addlocal mode {mode!r} (add/keep/ovw)")
    ra, ca, va = a.global_coo()
    rb, cb, vb = b.global_coo()
    in_a_cols = np.isin(cb, np.unique(ca))
    rb, cb, vb = rb[in_a_cols], cb[in_a_cols], vb[in_a_cols]
    hi = max(
        int(max(ra.max(), ca.max())) if ra.size else -1,
        int(max(rb.max(), cb.max())) if rb.size else -1,
    ) + 1
    key_a = ra * hi + ca
    key_b = rb * hi + cb
    # pre-sum duplicates within each operand (the reference requires sorted
    # deduplicated CSCDs; we normalize instead of failing)
    def dedupe(key, v):
        uk, inv = np.unique(key, return_inverse=True)
        vs = np.zeros(uk.size, dtype=np.result_type(v.dtype, np.float64))
        np.add.at(vs, inv, v)
        return uk, vs

    key_a, va = dedupe(key_a, va)
    key_b, vb = dedupe(key_b, vb)
    if mode == "add":
        key = np.concatenate([key_a, key_b])
        val = np.concatenate([va, vb])
        uk, inv = np.unique(key, return_inverse=True)
        vs = np.zeros(uk.size, dtype=val.dtype)
        np.add.at(vs, inv, val)
    else:
        win_key, win_val = (key_a, va) if mode == "keep" else (key_b, vb)
        lose_key, lose_val = (key_b, vb) if mode == "keep" else (key_a, va)
        only = ~np.isin(lose_key, win_key)
        uk = np.concatenate([win_key, lose_key[only]])
        vs = np.concatenate([win_val, lose_val[only]])
        o = np.argsort(uk)
        uk, vs = uk[o], vs[o]
    return CSCDPart(rows=uk // hi, cols=uk % hi, vals=vs)


def gather_rhs(
    n: int, parts: Sequence[CSCDPart], b_parts: Sequence[np.ndarray],
    mode: str = "add",
) -> np.ndarray:
    """Per-part local RHS -> global RHS (overlap summed, FEM-style)."""
    nrhs_shape = np.asarray(b_parts[0]).shape[1:] if b_parts else ()
    b = np.zeros((n, *nrhs_shape))
    for p, bp in zip(parts, b_parts):
        bp = np.asarray(bp)
        idx = (
            np.asarray(p.loc2glob, dtype=np.int64)
            if p.loc2glob is not None
            else np.arange(bp.shape[0], dtype=np.int64)
        )
        if mode == "add":
            np.add.at(b, idx, bp)
        else:
            b[idx] = bp
    return b


def scatter_solution(
    x: np.ndarray, parts: Sequence[CSCDPart]
) -> list[np.ndarray]:
    """Global solution -> per-part local pieces (the caller's distribution)."""
    out = []
    for p in parts:
        if p.loc2glob is None:
            out.append(x.copy())
        else:
            out.append(x[np.asarray(p.loc2glob, dtype=np.int64)])
    return out


def dspsolve(
    n: int,
    parts: Sequence[CSCDPart],
    b_parts: Sequence[np.ndarray],
    config: Optional[PastixConfig] = None,
    rhs_mode: str = "add",
    device=None,
) -> list[np.ndarray]:
    """One-call distributed-input solve (the ``dpastix()`` analog);
    ``device`` as :class:`~pastix_tpu_torch.pastix.Pastix`'s."""
    from pastix_tpu_torch.pastix import Pastix

    A = assemble_distributed(n, parts)
    b = gather_rhs(n, parts, b_parts, mode=rhs_mode)
    x = Pastix(A, config, device=device).solve(b)
    return scatter_solution(x, parts)
