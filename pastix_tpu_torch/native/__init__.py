"""Native (C++) host components, loaded via ctypes.

The reference's host-side runtime is C (ordering via external Scotch,
symbolic/blend in-tree — SURVEY.md sections 1-2); our equivalents compile
on first use with the system g++ (no pybind11 in this environment) and
fall back to the pure-Python implementations if no toolchain is present.
The library is built into ``pastix_tpu_torch/_build/``, never next to
the sources, with ``-march=native`` under a name keyed by the host CPU
(:func:`host_key`), so a tree copied to another machine builds its own
library instead of loading one made for another CPU; :data:`status` says
which path ran.

Set ``PASTIX_TPU_NO_NATIVE=1`` to force the Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import tempfile

import numpy as np

_LIB = None
_TRIED = False
# "not tried", "loaded (built earlier)", "built", or "unavailable: <why>"
# (ordering and symbolic factorization then run in Python)
status = "not tried"

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_OUT_DIR = os.path.join(os.path.dirname(_SRC_DIR), "_build")
_SOURCES = ["ordering.cpp", "symbolic.cpp", "etree.cpp", "amd.cpp"]


def host_key() -> str:
    """A short hash of what ``-march=native`` compiles for: the machine
    architecture and the first CPU's model name and feature flags
    (``/proc/cpuinfo``; the machine name alone where that is missing)."""
    info = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features"):
                    info += "\n" + line.strip()
                elif not line.strip() and info.count("\n"):
                    break  # end of the first CPU's block
    except OSError:
        pass
    return hashlib.sha256(info.encode()).hexdigest()[:12]


def lib_path(key: str) -> str:
    """Where the library built for host ``key`` lives."""
    return os.path.join(_OUT_DIR, f"_pastix_native_{key}.so")


def _build(so_path: str) -> str:
    """Compile into a temporary file and rename it into place, so that
    processes building at once never load a half-written library.
    Returns "" on success, else why the build failed."""
    os.makedirs(_OUT_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_OUT_DIR)
    os.close(fd)
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-o", tmp, *srcs,
    ]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            # retry without -march=native (portability)
            cmd.remove("-march=native")
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        return f"g++ did not run ({e})"
    if r.returncode != 0:
        os.unlink(tmp)
        print(f"[pastix-tpu-torch] native build failed:\n{r.stderr}",
              file=sys.stderr)
        return f"g++ failed ({r.returncode})"
    os.replace(tmp, so_path)
    return ""


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _TRIED, status
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("PASTIX_TPU_NO_NATIVE"):
        status = "unavailable: PASTIX_TPU_NO_NATIVE is set"
        return None
    so_path = lib_path(host_key())
    src_mtime = max(
        os.path.getmtime(os.path.join(_SRC_DIR, s)) for s in _SOURCES
    )
    status = "loaded (built earlier)"
    if not os.path.exists(so_path) or os.path.getmtime(so_path) < src_mtime:
        why = _build(so_path)
        if why:
            status = f"unavailable: {why}"
            return None
        status = "built"
    try:
        lib = ctypes.CDLL(so_path)
    except OSError as e:
        status = f"unavailable: {e}"
        return None
    lib.pastix_nd.restype = ctypes.c_int64
    lib.pastix_nd.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),  # indptr
        ctypes.POINTER(ctypes.c_int64),  # indices
        ctypes.c_int64,  # leaf_size
        ctypes.c_int64,  # max_levels
        ctypes.c_double,  # balance
        ctypes.POINTER(ctypes.c_int64),  # peritab out
        ctypes.POINTER(ctypes.c_int64),  # rangtab out
        ctypes.POINTER(ctypes.c_int64),  # nrang out
    ]
    lib.pastix_symbfact.restype = ctypes.c_void_p
    lib.pastix_symbfact.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pastix_symb_copy.restype = None
    lib.pastix_symb_copy.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_int64)
    ] * 4
    lib.pastix_symb_free.restype = None
    lib.pastix_symb_free.argtypes = [ctypes.c_void_p]
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.pastix_etree.restype = None
    lib.pastix_etree.argtypes = [ctypes.c_int64, p64, p64, p64]
    lib.pastix_postorder.restype = ctypes.c_int64
    lib.pastix_postorder.argtypes = [ctypes.c_int64, p64, p64]
    lib.pastix_colcounts.restype = None
    lib.pastix_colcounts.argtypes = [ctypes.c_int64, p64, p64, p64, p64, p64]
    lib.pastix_amd.restype = ctypes.c_int64
    lib.pastix_amd.argtypes = [ctypes.c_int64, p64, p64, p64]
    if lib.pastix_native_abi() != 1:
        status = "unavailable: ABI mismatch"
        return None
    _LIB = lib
    return _LIB


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def native_nested_dissection(pattern, leaf_size=64, max_levels=64,
                             balance=0.28):
    """C++ ND on a scipy symmetric pattern; returns (peritab, rangtab) or
    None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    import scipy.sparse as sp

    adj = sp.csr_matrix(pattern.astype(bool))
    adj.setdiag(False)
    adj.eliminate_zeros()
    n = adj.shape[0]
    indptr = np.ascontiguousarray(adj.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(adj.indices, dtype=np.int64)
    peritab = np.empty(n, dtype=np.int64)
    rangtab = np.empty(n + 1, dtype=np.int64)
    nrang = np.zeros(1, dtype=np.int64)
    rc = lib.pastix_nd(
        n, _i64p(indptr), _i64p(indices),
        int(leaf_size), int(max_levels), float(balance),
        _i64p(peritab), _i64p(rangtab), _i64p(nrang),
    )
    if rc != 0:
        return None
    return peritab, rangtab[: int(nrang[0])].copy()


def native_symbolic(pattern, rangtab):
    """C++ supernodal symbolic factorization; returns
    (blok_ptr, frownum, lrownum, target) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    import scipy.sparse as sp

    A = sp.csc_matrix(pattern)
    n = A.shape[0]
    rang = np.ascontiguousarray(rangtab, dtype=np.int64)
    nsup = rang.size - 1
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int64)
    nblok = np.zeros(1, dtype=np.int64)
    h = lib.pastix_symbfact(
        n, _i64p(indptr), _i64p(indices), nsup, _i64p(rang), _i64p(nblok)
    )
    if not h:
        return None
    nb = int(nblok[0])
    blok_ptr = np.empty(nsup + 1, dtype=np.int64)
    frow = np.empty(nb, dtype=np.int64)
    lrow = np.empty(nb, dtype=np.int64)
    targ = np.empty(nb, dtype=np.int64)
    lib.pastix_symb_copy(h, _i64p(blok_ptr), _i64p(frow), _i64p(lrow), _i64p(targ))
    lib.pastix_symb_free(h)
    return blok_ptr, frow, lrow, targ


def native_etree(pattern):
    """C++ elimination tree; returns parent[] or None."""
    lib = get_lib()
    if lib is None:
        return None
    import scipy.sparse as sp

    A = sp.csc_matrix(pattern)
    n = A.shape[0]
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int64)
    parent = np.empty(n, dtype=np.int64)
    lib.pastix_etree(n, _i64p(indptr), _i64p(indices), _i64p(parent))
    return parent


def native_postorder(parent):
    lib = get_lib()
    if lib is None:
        return None
    parent = np.ascontiguousarray(parent, dtype=np.int64)
    post = np.empty(parent.size, dtype=np.int64)
    rc = lib.pastix_postorder(parent.size, _i64p(parent), _i64p(post))
    return post if rc == 0 else None


def native_colcounts(pattern, parent, post):
    lib = get_lib()
    if lib is None:
        return None
    import scipy.sparse as sp

    A = sp.csc_matrix(pattern)
    n = A.shape[0]
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int64)
    parent = np.ascontiguousarray(parent, dtype=np.int64)
    post = np.ascontiguousarray(post, dtype=np.int64)
    counts = np.empty(n, dtype=np.int64)
    lib.pastix_colcounts(
        n, _i64p(indptr), _i64p(indices), _i64p(parent), _i64p(post),
        _i64p(counts),
    )
    return counts


def native_amd(pattern):
    """C++ approximate minimum degree on a scipy symmetric pattern;
    returns peritab (elimination order) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    import scipy.sparse as sp

    adj = sp.csr_matrix(pattern.astype(bool))
    adj.setdiag(False)
    adj.eliminate_zeros()
    n = adj.shape[0]
    indptr = np.ascontiguousarray(adj.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(adj.indices, dtype=np.int64)
    peritab = np.empty(max(n, 1), dtype=np.int64)
    rc = lib.pastix_amd(n, _i64p(indptr), _i64p(indices), _i64p(peritab))
    if rc != 0:
        return None
    return peritab[:n]
