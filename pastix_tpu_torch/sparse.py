"""Sparse matrix container and input checking.

Equivalent of the reference's user-facing CSC handling:
``pastix_checkMatrix`` and the ``csc_utils.c`` helpers (symmetrize the
pattern, remove duplicates, sort columns, base-0/1 conversion) — reference
anchors ``src/matrix_drivers/src/csc_utils.c`` and
``src/sopalin/src/pastix.c:pastix_checkMatrix`` (SURVEY.md section 2 rows
17-18).

We standardise on CSC internally (like the reference); CSR of a symmetric
pattern is its transpose so conversion is cheap via scipy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class SparseMatrix:
    """Compressed sparse column matrix (0-based).

    ``colptr`` has n+1 entries; ``rowind[colptr[j]:colptr[j+1]]`` are the
    row indices of column j, sorted ascending, no duplicates once
    :func:`check_matrix` has run.  For symmetric storage only the lower
    triangle (including the diagonal) is kept — matching the reference's
    API_SYM_YES convention.
    """

    n: int
    colptr: np.ndarray  # int64[n+1]
    rowind: np.ndarray  # int64[nnz]
    values: np.ndarray  # dtype[nnz]
    symmetric_storage: bool = False  # lower triangle only

    @property
    def nnz(self) -> int:
        return int(self.colptr[-1])

    # ---- constructors -------------------------------------------------

    @classmethod
    def from_scipy(cls, A, symmetric_storage: bool = False) -> "SparseMatrix":
        A = sp.csc_matrix(A)
        A.sort_indices()
        if symmetric_storage:
            A = sp.tril(A, format="csc")
            A.sort_indices()
        return cls(
            n=A.shape[0],
            colptr=A.indptr.astype(np.int64),
            rowind=A.indices.astype(np.int64),
            values=np.asarray(A.data),
            symmetric_storage=symmetric_storage,
        )

    @classmethod
    def from_coo(
        cls,
        n: int,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        symmetric_storage: bool = False,
        sum_duplicates: bool = True,
    ) -> "SparseMatrix":
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
        if sum_duplicates:
            A.sum_duplicates()
        return cls.from_scipy(A.tocsc(), symmetric_storage=symmetric_storage)

    # ---- conversions ---------------------------------------------------

    def to_scipy(self) -> sp.csc_matrix:
        """Full (expanded) scipy CSC — mirrors the symmetric half if needed."""
        A = sp.csc_matrix(
            (self.values, self.rowind, self.colptr), shape=(self.n, self.n)
        )
        if self.symmetric_storage:
            D = sp.diags(A.diagonal())
            A = A + A.T - D
        return sp.csc_matrix(A)

    def lower_scipy(self) -> sp.csc_matrix:
        """The stored half as scipy (lower triangle when symmetric)."""
        return sp.csc_matrix(
            (self.values, self.rowind, self.colptr), shape=(self.n, self.n)
        )

    def pattern_sym_scipy(self) -> sp.csc_matrix:
        """Boolean symmetrized pattern A|A^T with a full diagonal.

        This is the graph handed to ordering/symbolic — the reference
        symmetrizes the pattern the same way in pastix_task_scotch.
        """
        A = self.to_scipy()
        P = (abs(A) + abs(A).T).astype(bool).tocsc()
        P = (P + sp.eye(self.n, dtype=bool, format="csc")).astype(bool).tocsc()
        P.sort_indices()
        return P

    def permuted(self, perm: np.ndarray) -> "SparseMatrix":
        """Return P A P^T where ``perm`` maps old index -> new index."""
        A = self.to_scipy().tocoo()
        return SparseMatrix.from_coo(
            self.n,
            perm[A.row],
            perm[A.col],
            A.data,
            symmetric_storage=self.symmetric_storage,
            sum_duplicates=False,
        )


def isolate_zero_diagonals(A) -> np.ndarray:
    """Indices of unknowns with a zero (or structurally absent) diagonal.

    The reference's ``isolate_zeros`` workflow (src/example/src/
    isolate_zeros.c): such unknowns break unpivoted LL^T/LDL^T panels, so
    the caller marks them as Schur unknowns — they are ordered last, left
    unfactored, and handled by the dense Schur solve.
    """
    As = A.to_scipy() if isinstance(A, SparseMatrix) else sp.csc_matrix(A)
    d = As.diagonal()
    return np.flatnonzero(d == 0).astype(np.int64)


def check_matrix(
    n: int,
    colptr: np.ndarray,
    rowind: np.ndarray,
    values: Optional[np.ndarray] = None,
    base: int = 0,
    symmetric_storage: bool = False,
    symmetrize_pattern: bool = False,
) -> SparseMatrix:
    """Validate and canonicalise user CSC input.

    Mirrors ``pastix_checkMatrix``: rebase to 0, sort row indices within
    each column, merge duplicates (summing values), optionally drop the
    upper triangle for symmetric storage, and optionally symmetrize the
    pattern (adding explicit zeros) for LU on structurally unsymmetric
    input — reference anchor csc_utils.c (CSC_sort, CSC_symmetrize).
    """
    colptr = np.asarray(colptr, dtype=np.int64)
    rowind = np.asarray(rowind, dtype=np.int64)
    if colptr.shape[0] != n + 1:
        raise ValueError(f"colptr must have n+1={n + 1} entries, got {colptr.shape[0]}")
    if base not in (0, 1):
        raise ValueError("base must be 0 or 1")
    colptr = colptr - base
    rowind = rowind - base
    nnz = int(colptr[-1])
    if colptr[0] != 0 or np.any(np.diff(colptr) < 0):
        raise ValueError("colptr must be nondecreasing starting at base")
    if rowind.shape[0] != nnz:
        raise ValueError(f"rowind must have colptr[n]={nnz} entries")
    if nnz and (rowind.min() < 0 or rowind.max() >= n):
        raise ValueError("row indices out of range")
    if values is None:
        values = np.ones(nnz, dtype=np.float64)
    values = np.asarray(values)
    if values.shape[0] != nnz:
        raise ValueError("values must have nnz entries")

    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(colptr))
    A = sp.coo_matrix((values, (rowind, cols)), shape=(n, n))
    A.sum_duplicates()
    A = A.tocsc()
    A.sort_indices()

    if symmetrize_pattern:
        # add explicit zeros where A^T has an entry but A does not
        # (scipy's sparse add prunes zeros, so build by COO concatenation)
        pat = sp.coo_matrix((abs(A) + abs(A).T).astype(bool))
        Ac = A.tocoo()
        rows2 = np.concatenate([Ac.row, pat.row])
        cols2 = np.concatenate([Ac.col, pat.col])
        data2 = np.concatenate([Ac.data, np.zeros(pat.nnz, dtype=Ac.data.dtype)])
        A = sp.coo_matrix((data2, (rows2, cols2)), shape=(n, n))
        A.sum_duplicates()
        A = A.tocsc()
        A.sort_indices()

    return SparseMatrix.from_scipy(A, symmetric_storage=symmetric_storage)
