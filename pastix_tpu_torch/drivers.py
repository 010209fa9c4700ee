"""Matrix file drivers and the ``read_matrix`` umbrella (a copy of
``pastix_tpu/drivers.py`` with its import paths changed).

The reference ships per-format readers under ``src/matrix_drivers/src/``
(``read_matrix()`` umbrella; RSA/Harwell-Boeing via ``rsaread``/``iohb.c``,
MatrixMarket via ``mmio.c``, IJV "3files", PETSc binary, plus the
``-lap N`` Laplacian generator — SURVEY.md section 2 row 17).  Here:

  * MatrixMarket / Harwell-Boeing (incl. RSA) via scipy.io;
  * IJV "3files": plain text ia/ja/ra triplet files (1-based);
  * PETSc binary sparse format (big-endian AIJ);
  * ``driver`` strings ``lap:<n>`` / ``lap2:<n>`` / ``lap3:<n>`` /
    ``elas3:<n>`` dispatch to the generators (no data files needed —
    the de-facto smoke-test path, reference ``simple -lap 100``).

All readers return a :class:`pastix_tpu_torch.sparse.SparseMatrix`.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import scipy.sparse as sp

from pastix_tpu_torch.sparse import SparseMatrix
from pastix_tpu_torch import generators

_PETSC_MAT_CLASSID = 1211216


def read_mm(path: str) -> SparseMatrix:
    """MatrixMarket (.mtx / .mtx.gz). Symmetric files are expanded."""
    from scipy.io import mmread

    A = sp.csc_matrix(mmread(path))
    return SparseMatrix.from_scipy(A)


def write_mm(path: str, A: SparseMatrix) -> None:
    from scipy.io import mmwrite

    mmwrite(path, A.to_scipy())


def read_hb(path: str) -> SparseMatrix:
    """Harwell-Boeing / RSA (RUA, RSA, ... assembled formats)."""
    from scipy.io import hb_read

    A = sp.csc_matrix(hb_read(path))
    # scipy returns the stored triangle for symmetric (RSA) files
    # with no expansion flag; expand if structurally triangular
    lo = sp.tril(A, -1).nnz
    up = sp.triu(A, 1).nnz
    if lo == 0 and up > 0:
        A = A + sp.triu(A, 1).T
    elif up == 0 and lo > 0:
        A = A + sp.tril(A, -1).T
    return SparseMatrix.from_scipy(sp.csc_matrix(A))


def write_hb(path: str, A: SparseMatrix) -> None:
    from scipy.io import hb_write

    hb_write(path, A.to_scipy())


def read_ijv(prefix: str) -> SparseMatrix:
    """IJV "3files" driver: ``<prefix>ia``, ``<prefix>ja``, ``<prefix>ra``.

    Text files, one entry per line, 1-based indices (the reference's
    ThreeFiles driver layout); a ``<prefix>header`` with ``n nnz`` is
    honored if present.
    """
    ia = np.loadtxt(prefix + "ia", dtype=np.int64, ndmin=1)
    ja = np.loadtxt(prefix + "ja", dtype=np.int64, ndmin=1)
    ra = np.loadtxt(prefix + "ra", dtype=np.float64, ndmin=1)
    if ia.size != ja.size or ia.size != ra.size:
        raise ValueError(
            f"3files length mismatch: ia={ia.size} ja={ja.size} ra={ra.size}"
        )
    hdr = prefix + "header"
    if os.path.exists(hdr):
        n = int(np.loadtxt(hdr, dtype=np.int64, ndmin=1).flat[0])
    else:
        n = int(max(ia.max(), ja.max()))
    A = sp.coo_matrix((ra, (ia - 1, ja - 1)), shape=(n, n))
    return SparseMatrix.from_scipy(sp.csc_matrix(A))


def write_ijv(prefix: str, A: SparseMatrix) -> None:
    C = sp.coo_matrix(A.to_scipy())
    np.savetxt(prefix + "ia", C.row + 1, fmt="%d")
    np.savetxt(prefix + "ja", C.col + 1, fmt="%d")
    np.savetxt(prefix + "ra", C.data)
    np.savetxt(prefix + "header", [[A.n, C.nnz]], fmt="%d")


def read_petsc(path: str) -> SparseMatrix:
    """PETSc binary AIJ matrix (big-endian int32 header + float64 values)."""
    with open(path, "rb") as f:
        classid, m, n, nnz = struct.unpack(">4i", f.read(16))
        if classid != _PETSC_MAT_CLASSID:
            raise ValueError(f"not a PETSc binary matrix: classid={classid}")
        rownnz = np.frombuffer(f.read(4 * m), dtype=">i4").astype(np.int64)
        cols = np.frombuffer(f.read(4 * nnz), dtype=">i4").astype(np.int64)
        vals = np.frombuffer(f.read(8 * nnz), dtype=">f8").astype(np.float64)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(rownnz, out=indptr[1:])
    A = sp.csr_matrix((vals, cols, indptr), shape=(m, n))
    return SparseMatrix.from_scipy(sp.csc_matrix(A))


def write_petsc(path: str, A: SparseMatrix) -> None:
    C = sp.csr_matrix(A.to_scipy())
    C.sort_indices()
    m, n = C.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">4i", _PETSC_MAT_CLASSID, m, n, C.nnz))
        f.write(np.diff(C.indptr).astype(">i4").tobytes())
        f.write(C.indices.astype(">i4").tobytes())
        f.write(C.data.astype(">f8").tobytes())


_GEN = {
    "lap": lambda n: generators.laplacian_2d(int(n)),
    "lap1": lambda n: generators.laplacian_1d(int(n)),
    "lap2": lambda n: generators.laplacian_2d(int(n)),
    "lap3": lambda n: generators.poisson_3d(int(n)),
    "elas3": lambda n: generators.elasticity_3d(int(n)),
}


def read_matrix(path: str, driver: str | None = None) -> SparseMatrix:
    """Umbrella reader (reference ``read_matrix()``).

    ``driver``: 'mm' | 'hb' | 'rsa' | 'ijv' | 'petsc' | 'lap[1|2|3]:<n>' |
    'elas3:<n>'; None = sniff from the file extension.
    """
    if driver is None and ":" in path and not os.path.exists(path):
        driver = path  # allow read_matrix("lap3:32")
    if driver is not None and ":" in driver:
        name, _, arg = driver.partition(":")
        if name in _GEN:
            return _GEN[name](arg)
    if driver in _GEN:
        raise ValueError(f"generator driver needs a size: '{driver}:<n>'")
    if driver is None:
        ext = os.path.splitext(path)[1].lower()
        if ext == ".gz":
            ext = os.path.splitext(path[:-3])[1].lower()
        driver = {
            ".mtx": "mm",
            ".mm": "mm",
            ".rb": "hb",
            ".rsa": "hb",
            ".rua": "hb",
            ".hb": "hb",
            ".petsc": "petsc",
            ".bin": "petsc",
        }.get(ext)
        if driver is None:
            raise ValueError(
                f"cannot sniff matrix format from '{path}'; pass driver="
            )
    if driver == "mm":
        return read_mm(path)
    if driver in ("hb", "rsa"):
        return read_hb(path)
    if driver == "ijv":
        return read_ijv(path)
    if driver == "petsc":
        return read_petsc(path)
    raise ValueError(f"unknown matrix driver '{driver}'")


def gen_rhs(A: SparseMatrix, kind: str = "ones", seed: int = 0) -> np.ndarray:
    """Test RHS generation (reference IPARM_RHS_MAKING): b = A @ x_true."""
    if kind == "ones":
        x = np.ones(A.n)
    elif kind == "i":
        x = np.arange(1, A.n + 1, dtype=np.float64)
    elif kind == "random":
        x = np.random.default_rng(seed).standard_normal(A.n)
    else:
        raise ValueError(f"unknown rhs kind '{kind}'")
    return A.to_scipy() @ x
