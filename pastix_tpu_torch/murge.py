"""Murge-style incremental assembly API (a copy of ``pastix_tpu/murge.py``
with its import paths changed and a ``device`` for the solver).

The reference ships a solver-independent distributed assembly interface
(``src/murge/`` spec + sopalin implementation: ``MURGE_Initialize``,
``GraphBegin/GraphEdge/GraphEnd``, ``AssemblyBegin/AssemblySetValue/
AssemblyEnd``, ``SetGlobalRHS``, ``GetGlobalSolution`` — SURVEY.md
section 2 row 19).  Here the same workflow is a small host-side builder
feeding the Pastix pipeline; the graph phase fixes the pattern once and
repeated assembly phases reuse the cached analysis (the solver's
pattern-reuse hot path).

Example::

    m = MurgeSolver(n)
    m.graph_begin()
    for (i, j) in edges: m.graph_edge(i, j)
    m.graph_end()
    m.assembly_begin()
    for (i, j, v) in entries: m.assembly_set_value(i, j, v)
    m.assembly_end()
    x = m.solve(b)          # analysis runs once
    m.assembly_begin()      # new values, same pattern
    ...
    x2 = m.solve(b2)        # factorization only
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.sparse import SparseMatrix


class MurgeSolver:
    """Incremental graph/value assembly in front of the Pastix pipeline."""

    # assembly duplicate-entry modes (MURGE_ASSEMBLY_ADD / _OVW)
    ADD = "add"
    OVERWRITE = "overwrite"

    def __init__(self, n: int, config: Optional[PastixConfig] = None,
                 device=None):
        self.n = int(n)
        self.config = config or PastixConfig()
        self.device = device  # the Pastix device (None: cuda)
        self._graph_open = False
        self._asm_open = False
        self._rows: list[np.ndarray] = []
        self._cols: list[np.ndarray] = []
        self._pattern: Optional[sp.csc_matrix] = None
        self._vals_ij: Optional[np.ndarray] = None  # value slot per pattern nnz
        self._asm_mode = self.ADD
        self._solver = None
        self._entry_pos: Optional[dict] = None

    # --- graph phase ---------------------------------------------------

    def graph_begin(self) -> None:
        if self._graph_open:
            raise RuntimeError("graph phase already open")
        self._graph_open = True
        self._rows, self._cols = [], []

    def graph_edge(self, i, j) -> None:
        """Register entries (vectorized: i, j may be arrays)."""
        if not self._graph_open:
            raise RuntimeError("call graph_begin() first")
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        j = np.atleast_1d(np.asarray(j, dtype=np.int64))
        if i.shape != j.shape:
            raise ValueError("i and j must have the same shape")
        if (i < 0).any() or (i >= self.n).any() or (j < 0).any() or (j >= self.n).any():
            raise ValueError("graph edge index out of range")
        self._rows.append(i)
        self._cols.append(j)

    def graph_end(self) -> None:
        if not self._graph_open:
            raise RuntimeError("graph phase not open")
        self._graph_open = False
        r = np.concatenate(self._rows) if self._rows else np.empty(0, np.int64)
        c = np.concatenate(self._cols) if self._cols else np.empty(0, np.int64)
        # always include the diagonal (factorization needs it)
        d = np.arange(self.n, dtype=np.int64)
        r = np.concatenate([r, d])
        c = np.concatenate([c, d])
        P = sp.coo_matrix(
            (np.ones(r.size), (r, c)), shape=(self.n, self.n)
        ).tocsc()
        P.sum_duplicates()
        P.sort_indices()
        self._pattern = P
        # map (i,j) -> position in CSC data for fast assembly
        keys = P.indices.astype(np.int64) + np.repeat(
            np.arange(self.n, dtype=np.int64) * self.n, np.diff(P.indptr)
        )
        order = np.argsort(keys)
        self._keys_sorted = keys[order]
        self._pos_sorted = order.astype(np.int64)
        self._solver = None  # pattern changed: analysis must rerun

    # --- assembly phase ------------------------------------------------

    def assembly_begin(self, mode: str = ADD) -> None:
        if self._pattern is None:
            raise RuntimeError("finish the graph phase before assembling")
        if self._asm_open:
            raise RuntimeError("assembly phase already open")
        self._asm_open = True
        self._asm_mode = mode
        self._vals = np.zeros(self._pattern.nnz)
        self._touched = np.zeros(self._pattern.nnz, dtype=bool)

    def assembly_set_value(self, i, j, v) -> None:
        if not self._asm_open:
            raise RuntimeError("call assembly_begin() first")
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        j = np.atleast_1d(np.asarray(j, dtype=np.int64))
        v = np.broadcast_to(np.asarray(v, dtype=np.float64), i.shape)
        key = j * self.n + i
        pos = np.searchsorted(self._keys_sorted, key)
        ok = (pos < self._keys_sorted.size) & (
            self._keys_sorted[np.minimum(pos, self._keys_sorted.size - 1)] == key
        )
        if not ok.all():
            bad = np.flatnonzero(~ok)[0]
            raise ValueError(
                f"entry ({int(i[bad])}, {int(j[bad])}) is not in the graph"
            )
        slot = self._pos_sorted[pos]
        if self._asm_mode == self.ADD:
            np.add.at(self._vals, slot, v)
        else:
            self._vals[slot] = v
        self._touched[slot] = True

    # legacy-style aliases matching the reference verb set
    assembly_set_node_values = assembly_set_value

    def assembly_end(self) -> None:
        if not self._asm_open:
            raise RuntimeError("assembly phase not open")
        self._asm_open = False
        A = sp.csc_matrix(
            (self._vals, self._pattern.indices, self._pattern.indptr),
            shape=(self.n, self.n),
        )
        self._A = SparseMatrix.from_scipy(A)
        from pastix_tpu_torch.pastix import Pastix

        if self._solver is None:
            self._solver = Pastix(self._A, self.config, device=self.device)
        else:
            # same pattern: swap values, keep cached analysis
            self._solver.factorize(self._A.values)

    # --- options (MURGE_SetOptionINT / MURGE_SetOptionREAL) -------------

    def set_option(self, name, value) -> None:
        """Set a solver option by reference slot name or config field.

        Accepts IPARM_*/DPARM_* slot names (the MURGE_SetOption verb set)
        or PastixConfig field names::

            m.set_option("IPARM_FACTORIZATION", "API_FACT_LDLT")
            m.set_option("refinement_eps", 1e-12)

        Options must be set before the first solve (they rebuild the
        config; the cached analysis is invalidated on change).
        """
        if str(name).startswith(("IPARM_", "DPARM_")):
            ip = {name: value} if str(name).startswith("IPARM_") else None
            dp = {name: value} if str(name).startswith("DPARM_") else None
            import dataclasses

            # overlay the slot directly onto the current fields: from_iparm
            # starts from **kw and applies only the given slots, so setting
            # a value equal to the field default still takes effect
            base = dataclasses.asdict(self.config)
            self.config = PastixConfig.from_iparm(ip, dp, **base)
        else:
            import dataclasses

            if name not in {f.name for f in dataclasses.fields(PastixConfig)}:
                raise ValueError(f"unknown option: {name}")
            self.config = dataclasses.replace(self.config, **{name: value})
        self._solver = None  # config changed: rebuild pipeline

    # --- RHS / solution (MURGE_SetGlobalRHS / MURGE_GetGlobalSolution) --

    def set_global_rhs(self, b) -> None:
        b = np.asarray(b, dtype=np.float64)
        if b.shape[0] != self.n:
            raise ValueError(f"rhs has {b.shape[0]} rows, expected {self.n}")
        self._rhs = b

    def get_global_solution(self) -> np.ndarray:
        if getattr(self, "_rhs", None) is None:
            raise RuntimeError("set_global_rhs first")
        return self.solve(self._rhs)

    def get_info(self, name: str):
        """MURGE_GetInfoINT analog: query run metrics by slot name."""
        r = self.report
        m = {
            "IPARM_NNZEROS": r.nnz_l_exact if r else 0,
            "IPARM_STATIC_PIVOTING": r.static_pivots if r else 0,
            "DPARM_FILL_IN": r.fill_ratio if r else 0.0,
            "DPARM_FACT_FLOPS": r.fact_flops if r else 0.0,
            "DPARM_FACT_TIME": r.fact_time if r else 0.0,
            "DPARM_SOLV_TIME": r.solve_time if r else 0.0,
            "nnz_pattern": self._pattern.nnz if self._pattern is not None else 0,
        }
        if name not in m:
            raise ValueError(f"unknown info slot: {name}")
        return m[name]

    def clean(self) -> None:
        """MURGE_Clean: drop matrix, values and cached analysis."""
        if self._solver is not None:
            self._solver.clean()
        self._solver = None
        self._A = None
        self._pattern = None
        self._rhs = None

    # --- solve ---------------------------------------------------------

    def solve(self, b: np.ndarray) -> np.ndarray:
        if getattr(self, "_A", None) is None:
            raise RuntimeError("no assembled matrix; run an assembly phase")
        if self._solver is None:  # options changed since last assembly
            from pastix_tpu_torch.pastix import Pastix

            self._solver = Pastix(self._A, self.config, device=self.device)
        return self._solver.solve(np.asarray(b, dtype=np.float64))

    @property
    def matrix(self) -> SparseMatrix:
        return self._A

    @property
    def report(self):
        return self._solver.report if self._solver else None
