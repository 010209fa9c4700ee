"""Top-level solver API of the port (counterpart of ``pastix_tpu/pastix.py``:
LLᵗ, LLᴴ, LDLᵗ, LDLᴴ and LU in float32, float64, complex64 and
complex128).

:class:`Pastix` keeps the reference's step-by-step phases
(``order → symbfact → analyze → factorize → solve``), new values on the
cached analysis (``factorize(values)``), ``as_preconditioner``, ``clean``,
its Schur-complement calls (``set_schur_unknowns``, ``get_schur``,
``solve_with_schur``); :func:`spsolve` is its one-call form and
:func:`pastix` the reference's array API with its phase window.  The
host phases (ordering, symbolic factorization, the supernode-aligned or
Schur extension) are copies of the reference's methods; the numeric
phases run on one device through the port's kernels, or with
``mesh_shape`` on each rank of a ``torch.distributed`` process group
(``parallel/``: owner-computes over a sharded pool, the replicated pool
or the subtree schedule, the reference's routing).  With ``trace``
each phase is a span of ``self.tracer`` (``trace.Tracer``), ended after
the device has finished, and ``dump_trace`` writes them; ``factorize``
sets ``report.predicted_fact_time`` from the cost model (``perf``).
What is not ported raises ``NotImplementedError`` naming its
``ROADMAP.md`` slice; there are no silent fallbacks, and an error on the
device propagates.

The route is chosen in ``analyze`` from ``compute_dtype`` and the kind:
an fp32 real pool runs the hand kernels (K1, K4, K2); fp64 and complex
pools run ``numeric.factorize._build_plain`` and the per-level solve in
their own dtype, a complex one refining on the host in complex128 (the
reference's rule, ``pastix_tpu/pastix.py:1741-1744``).  Two options of the
analysis change what is built: ``packed_update`` (the packed E2 path,
``numeric/packed.py``, any dtype) and ``incomplete`` (ILU(k): block ILU
factors an incomplete tile layout on the same routes; ``ilu_grain=
"scalar"`` factors on the host, ``analyze/scalar_ilu.py``, and builds no
device program).  Out-of-core (``ooc``, ``ooc_limit_mb``; pools larger
than the card's free memory without being asked) streams the
factorization and the solve segment by segment through the card, the
pools in host memory (``numeric/ooc.py``), on the route of the dtype;
with ``ooc``, resident factors larger than the limit leave the card
after the factorization.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Optional

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from pastix_tpu_torch.analyze import SolverLayout, build_layout
from pastix_tpu_torch.analyze.layout import plan_dense_tail
from pastix_tpu_torch.analyze.packed import build_packed_plan
from pastix_tpu_torch.analyze.scalar_ilu import (
    ScalarILUFactors, scalar_ilu_factor, scalar_ilu_pattern,
)
from pastix_tpu_torch.config import (
    CARD_TILES,
    Factorization,
    IOStrategy,
    PastixConfig,
    RefinementMethod,
    SolveReport,
    Symmetry,
    Task,
    Verbosity,
)
from pastix_tpu_torch.order import Order, compute_ordering
from pastix_tpu_torch.perf import predict_fact_time
from pastix_tpu_torch.sparse import SparseMatrix, check_matrix
from pastix_tpu_torch.symbolic import compute_symbolic
from pastix_tpu_torch.trace import Tracer
from pastix_tpu_torch._device import pin_precision, resolve_device, synchronize
from pastix_tpu_torch.krylov import build_device_refine_fn, build_ell
from pastix_tpu_torch.numeric.kernels import np_dtype
from pastix_tpu_torch.numeric.factorize import (
    Factors,
    build_coefinit_fn,
    build_diag_inverse_fn,
    build_factorize_fn,
    factorize as numeric_factorize,
)
from pastix_tpu_torch.numeric.ooc import (
    build_streamed_solve_fn, plan_ooc, reset_io,
)
from pastix_tpu_torch.parallel.mesh import (
    Axis, check_world, make_mesh, rank_device, world,
)
from pastix_tpu_torch.refine import refine as refine_fn, refine_block
from pastix_tpu_torch.solve import (
    blocks_to_rhs,
    build_fwd_bwd_fns,
    build_level_fwd_bwd_fns,
    build_solve_fn,
    build_solve_fn_sweep,
    rhs_to_blocks,
    run_host,
)

_UPDATE_DTYPES = {None: None, "float32": torch.float32,
                  "bfloat16": torch.bfloat16}
# the share of the card's free memory an auto-streamed plan takes: the
# rest is left to the solve's right-hand sides, the pivots and the
# allocator's rounding (the reference plans 13 GiB of a 16 GiB card)
_AUTO_OOC_SHARE = 0.8
_COMPUTE_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                   "complex64": torch.complex64,
                   "complex128": torch.complex128}


def compute_dtype(cfg: PastixConfig) -> torch.dtype:
    """The pools' torch dtype of ``cfg.compute_dtype``."""
    name = np.dtype(cfg.compute_dtype).name
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"unsupported compute_dtype {cfg.compute_dtype!r}: "
                         f"expected one of {tuple(_COMPUTE_DTYPES)}")
    return _COMPUTE_DTYPES[name]


def _scalar_ilu(cfg: PastixConfig) -> bool:
    """Whether ILU(k) factors at scalar grain on the host."""
    return cfg.incomplete and cfg.ilu_grain == "scalar"


def _check_schur(cfg: PastixConfig) -> None:
    """The Schur complement is real: fp32 pools apply its residue
    through K3, fp64 ones by torch ops (``_build_plain``); a complex pool
    raises, as the reference has no complex Schur.  Scalar ILU has no
    tile layout to hold it (the reference's analyze returns None there,
    and its get_schur would fail)."""
    if _scalar_ilu(cfg):
        raise ValueError(
            "Schur unknowns with ilu_grain='scalar': the host factors hold "
            "no Schur block; use ilu_grain='block'")
    dt = compute_dtype(cfg)
    if dt.is_complex:
        raise NotImplementedError(
            "pastix_tpu_torch: a Schur complement with a complex "
            "compute_dtype; the reference has none either (its get_schur "
            "builds S in float64)")


def _not_ported(what: str, slice_: str):
    return NotImplementedError(
        f"pastix_tpu_torch: {what} is not ported yet (ROADMAP.md {slice_})"
    )


def _pinned(method):
    """Run a phase that does fp32 matmuls under :func:`pin_precision`."""

    @functools.wraps(method)
    def run(self, *args, **kw):
        with pin_precision():
            return method(self, *args, **kw)

    return run


def _check_config(cfg: PastixConfig) -> None:
    if not isinstance(cfg, PastixConfig):
        raise TypeError(
            "config must be a pastix_tpu_torch.config.PastixConfig, got "
            f"{type(cfg).__module__}.{type(cfg).__name__}"
        )
    dt = compute_dtype(cfg)
    if cfg.update_dtype not in _UPDATE_DTYPES:
        raise ValueError(f"unsupported update_dtype {cfg.update_dtype!r}")
    if cfg.update_dtype is not None and dt.is_complex:
        raise ValueError(
            f"update_dtype={cfg.update_dtype!r} with compute_dtype="
            f"{cfg.compute_dtype}: rounding drops the imaginary part (the "
            "reference's astype does); a complex pool takes no update dtype")
    if cfg.schur:
        _check_schur(cfg)
    if cfg.mesh_shape is not None:
        check_world(cfg.mesh_shape)


class Pastix:
    """Sparse direct solver instance on one device (``cuda`` by default;
    ``device="cpu"`` runs the plain PyTorch twins of the kernels), or on
    each rank of a process group with ``mesh_shape`` (``device=None``
    then means the rank's card, ``parallel.mesh.rank_device``)."""

    def __init__(self, A=None, config: Optional[PastixConfig] = None,
                 device=None):
        self.config = config or PastixConfig()
        _check_config(self.config)
        if self.config.mesh_shape is not None:
            device = rank_device(device)
        self.device = resolve_device(device)
        self._mesh = None  # the DeviceMesh of mesh_shape, from analyze
        self._tp = self._dp = None  # its tp and dp axes (mesh.Axis)
        self._pool_sharding = None  # owner.PoolSharding (owner path)
        self._sharded_refine_fn = None  # the mesh's device refinement
        self._a_coo_dev = None  # its share of A's COO entries
        self.report = SolveReport()
        self.A: Optional[SparseMatrix] = None
        self.order_: Optional[Order] = None
        self.symbol_ = None
        self.layout: Optional[SolverLayout] = None
        self.factors: Optional[Factors] = None
        self._A_perm = None  # permuted extended scipy csc, fp64, full
        self._ext_map: Optional[np.ndarray] = None  # permuted idx -> extended idx
        self._ext_n: int = 0
        self._dense_tail = None
        self._packed_plan = None  # analyze.packed.PackedPlan, if packed
        self._scalar_ilu_pat = None  # (rows, cols) of scalar ILU(k)
        self._schur_unknowns: Optional[np.ndarray] = None
        self._schur_first_bcol: Optional[int] = None
        self._refine_fn = None  # the device refinement loop, if it runs
        self._ell = None  # its fp64 ELL matrix of A_perm
        self._ooc_plan = None  # numeric.ooc.OOCPlan, if streamed
        self.tracer = Tracer() if self.config.trace else None
        if A is not None:
            self.set_matrix(A)

    def dump_trace(self, path: str) -> None:
        """Write the collected phase spans as perfetto/chrome trace JSON."""
        if self.tracer is None:
            raise ValueError("tracing not enabled (PastixConfig.trace)")
        self.tracer.dump(path)

    def _trace_phase(self, name: str, t0: float) -> None:
        """Record a completed phase [t0, now] (t0 from
        ``time.perf_counter()``) on the ``phases`` track."""
        if self.tracer is not None:
            e = self.tracer.epoch
            self.tracer.record(name, t0 - e, time.perf_counter() - e,
                               track="phases")

    @property
    def _dtype(self) -> torch.dtype:
        return compute_dtype(self.config)

    @property
    def _kind(self) -> Factorization:
        """The factorization that runs: LDLᴴ of a real pool is LDLᵗ."""
        kind = self.config.factorization
        if kind == Factorization.LDLH and not self._dtype.is_complex:
            return Factorization.LDLT
        return kind

    # ------------------------------------------------------------------
    # input
    # ------------------------------------------------------------------

    def _check_values(self, values) -> None:
        if np.iscomplexobj(values) and not self._dtype.is_complex:
            raise ValueError(
                f"complex values with compute_dtype="
                f"{self.config.compute_dtype}: set compute_dtype to "
                "complex64 or complex128")

    def set_matrix(self, A) -> "Pastix":
        """Accepts SparseMatrix, scipy sparse, or dense ndarray."""
        cfg = self.config
        if isinstance(A, SparseMatrix):
            self.A = A
        else:
            S = sp.csc_matrix(A)
            sym = cfg.factorization != Factorization.LU
            herm = self._hermitian_data(S)
            if sym and cfg.check_matrix:
                # pastix_checkMatrix: symmetric factorizations demand a
                # numerically symmetric (or Hermitian) matrix — fail
                # loudly, not garbage
                D = abs(S - S.conj().T) if herm else abs(S - S.T)
                if D.nnz and D.max() > 1e-12 * abs(S).max():
                    raise ValueError(
                        f"matrix is not {'Hermitian' if herm else 'symmetric'} "
                        f"(max deviation = {D.max():.2e}) "
                        f"but {cfg.factorization} requires it; "
                        "use Factorization.LU for unsymmetric systems"
                    )
            # Hermitian data keeps full storage (the lower-triangle
            # reconstruction in SparseMatrix transposes without conj)
            self.A = SparseMatrix.from_scipy(S, symmetric_storage=sym and not herm)
        self._check_values(self.A.values)
        self.report.n = self.A.n
        self.report.nnz_a = self.A.nnz
        return self

    def _hermitian_data(self, S) -> bool:
        """Complex input under a symmetric factorization kind: Hermitian
        (API_SYM_HER) if A == A^H, else complex-symmetric (API_SYM_YES)
        (reference ``_hermitian_data``)."""
        cfg = self.config
        data = getattr(S, "data", None)
        if data is None or not np.iscomplexobj(data):
            return False
        if cfg.symmetry == Symmetry.HERMITIAN:
            return True
        if cfg.factorization == Factorization.LDLH:
            return True
        if cfg.symmetry == Symmetry.SYMMETRIC:
            # auto-detect: prefer Hermitian when both hold (real diag)
            D = abs(S - S.conj().T)
            Dt = abs(S - S.T)
            return (D.max() if D.nnz else 0) <= (Dt.max() if Dt.nnz else 0)
        return False

    @property
    def _hermitian(self) -> bool:
        """Whether the factorization conjugates (reference ``_hermitian``):
        always for real dtypes, where it changes nothing; for complex ones
        under LDLᴴ or ``Symmetry.HERMITIAN``, else complex-symmetric."""
        if not self._dtype.is_complex:
            return True
        if self.config.factorization == Factorization.LDLH:
            return True
        return self.config.symmetry == Symmetry.HERMITIAN

    def set_schur_unknowns(self, unknowns) -> "Pastix":
        """pastix_setSchurUnknownList equivalent: these dofs are ordered
        last and left unfactored; get_schur() returns their complement.
        A complex ``compute_dtype`` raises (``_check_schur``)."""
        _check_schur(self.config)
        self._schur_unknowns = np.unique(np.asarray(unknowns, dtype=np.int64))
        self.config.schur = True
        return self

    # ------------------------------------------------------------------
    # phase 1: ordering
    # ------------------------------------------------------------------

    def order(self, user_perm=None) -> Order:
        cfg = self.config
        t0 = time.perf_counter()
        if cfg.io_strategy == IOStrategy.LOAD:
            self.order_ = Order.load(os.path.join(cfg.io_dir, "ordername"))
            self.order_.check()
            self.report.order_time = time.perf_counter() - t0
            self._trace_phase("order", t0)
            return self.order_
        pat = self.A.pattern_sym_scipy()
        if self._schur_unknowns is not None:
            if cfg.dof_nbr > 1:
                raise ValueError(
                    "schur unknowns with dof_nbr > 1 is unsupported: the "
                    "Schur ordering is per-dof and would break node "
                    "alignment; expand the unknown list to dofs and use "
                    "dof_nbr=1"
                )
            self.order_ = self._order_with_schur(pat)
        elif cfg.dof_nbr > 1:
            self.order_ = self._order_with_dof(pat, user_perm)
        else:
            self.order_ = compute_ordering(pat, cfg, user_perm=user_perm,
                                         card=self._card)
        self.order_.check()
        if cfg.io_strategy == IOStrategy.SAVE:
            self.order_.save(os.path.join(cfg.io_dir, "ordername"))
        self.report.order_time = time.perf_counter() - t0
        self._trace_phase("order", t0)
        if cfg.verbosity >= Verbosity.NO:
            print(f"[pastix-tpu-torch] ordering: {self.report.order_time:.3f}s")
        return self.order_

    def _order_with_dof(self, pat: sp.csc_matrix, user_perm=None) -> Order:
        """IPARM_DOF_NBR > 1: order the node-compressed graph, expand.

        Rows {i*d .. i*d+d-1} belong to node i (the reference's multi-dof
        input, e.g. elasticity with d=3).  The fill-reducing ordering runs
        on the d-times-smaller node graph; the permutation and supernode
        ranges are expanded so each node's dofs stay adjacent.  A user
        permutation (PERSONAL) is interpreted over nodes, as in the
        reference."""
        d = self.config.dof_nbr
        n = self.A.n
        if n % d:
            raise ValueError(
                f"matrix size {n} is not a multiple of dof_nbr={d}"
            )
        nn = n // d
        C = sp.coo_matrix(pat)
        node_pat = sp.coo_matrix(
            (np.ones(C.nnz, dtype=bool), (C.row // d, C.col // d)),
            shape=(nn, nn),
        ).tocsc()
        node_pat.sum_duplicates()
        no = compute_ordering(node_pat, self.config, user_perm=user_perm,
                              card=self._card)
        ar = np.arange(d, dtype=np.int64)
        peritab = (no.peritab[:, None] * d + ar).ravel()
        permtab = np.empty(n, dtype=np.int64)
        permtab[peritab] = np.arange(n, dtype=np.int64)
        return Order(permtab, peritab, no.rangtab * d)

    def _order_with_schur(self, pat: sp.csc_matrix) -> Order:
        """Order non-Schur dofs with ND, append Schur dofs last."""
        n = self.A.n
        schur = self._schur_unknowns
        mask = np.zeros(n, dtype=bool)
        mask[schur] = True
        rest = np.flatnonzero(~mask)
        sub = sp.csc_matrix(pat[rest][:, rest])
        sub_order = compute_ordering(sub, self.config, card=self._card)
        peritab = np.concatenate([rest[sub_order.peritab], schur])
        permtab = np.empty(n, dtype=np.int64)
        permtab[peritab] = np.arange(n, dtype=np.int64)
        rt = sub_order.rangtab.tolist()
        if rt[-1] != n:
            rt.append(n)
        return Order(permtab, peritab, np.asarray(rt, dtype=np.int64))

    # ------------------------------------------------------------------
    # phase 2: symbolic
    # ------------------------------------------------------------------

    def symbfact(self):
        cfg = self.config
        if self.order_ is None:
            self.order()
        t0 = time.perf_counter()
        self._build_extended_matrix()
        pat_perm = self._pat_perm_ext
        if cfg.io_strategy == IOStrategy.LOAD:
            from pastix_tpu_torch.symbolic import SymbolMatrix

            self.symbol_ = SymbolMatrix.load(os.path.join(cfg.io_dir, "symbname"))
            self._scalar_info = {
                "nnz_l_exact": self.symbol_.nnz_l(),
                "flops_exact": self.symbol_.fact_flops(
                    "lu" if cfg.factorization == Factorization.LU else "llt"
                ),
            }
        else:
            self.symbol_, self._scalar_info = compute_symbolic(pat_perm, self.order_, cfg)
            if cfg.io_strategy == IOStrategy.SAVE:
                self.symbol_.save(os.path.join(cfg.io_dir, "symbname"))
        self.report.symbfact_time = time.perf_counter() - t0
        self._trace_phase("symbfact", t0)
        self.report.nnz_l_exact = int(self._scalar_info["nnz_l_exact"])
        self.report.fact_flops = float(self._scalar_info["flops_exact"])
        if (
            cfg.factorization == Factorization.LU
            and "parent" in self._scalar_info
        ):
            # DPARM_FACT_FLOPS convention: GETRF computes both triangles,
            # twice the Cholesky count of the scalar cost model
            # (SymbolMatrix.fact_flops("lu") already doubles)
            self.report.fact_flops *= 2.0
        self.report.fill_ratio = self.report.nnz_l_exact / max(1, self.A.nnz)
        if cfg.verbosity >= Verbosity.YES:
            print(
                f"[pastix-tpu-torch] symbfact: nnz(L)={self.report.nnz_l_exact} "
                f"fill={self.report.fill_ratio:.2f}x flops={self.report.fact_flops:.3e}"
            )
        return self.symbol_

    def _aligned_ext_map(self, T: int, n: Optional[int] = None):
        """Supernode-aligned extension of the first ``n`` dofs (default:
        all): amalgamate the ordering's supernodes toward the tile width,
        then pad each to a multiple of T so no tile straddles a supernode
        boundary.

        This is the blend/splitpart analog for the tile layout (reference
        ``src/blend/src/splitpart.c`` + kass amalgamation — SURVEY.md §2
        rows 5 and 7): tiles become genuinely dense block columns, cutting
        padded flops ~6x and elimination levels ~10x on 3D problems at the
        cost of identity-padded extra rows (~30%).
        """
        n = self.A.n if n is None else n
        rang = self.order_.rangtab
        rang = np.array([0], np.int64) if rang is None else rang[rang <= n]
        if rang[-1] != n:
            rang = np.append(rang, n)
        widths = np.diff(rang)
        # greedy chain-merge consecutive supernodes toward the configured
        # fraction of the tile width (default T/2; see config field note)
        target = max(1, int(self.config.amalg_target_frac * T))
        bounds = [0]
        acc = 0
        for w in widths:
            acc += int(w)
            if acc >= target:
                bounds.append(bounds[-1] + acc)
                acc = 0
        if acc:
            bounds.append(bounds[-1] + acc)
        rang2 = np.asarray(bounds, dtype=np.int64)
        w2 = np.diff(rang2)
        pad_w = ((w2 + T - 1) // T) * T
        offsets = np.concatenate([[0], np.cumsum(pad_w)])
        # ext[i] = i - rang2[k(i)] + offsets[k(i)], vectorized over columns
        k_of = np.repeat(np.arange(w2.size, dtype=np.int64), w2)
        ext = np.arange(n, dtype=np.int64) - rang2[k_of] + offsets[k_of]
        return ext, int(offsets[-1])

    def _build_extended_matrix(self):
        """Permute A and embed into the tile grid: supernode-aligned padding
        (and, in Schur mode, the Schur dofs start at a tile boundary)."""
        if self._A_perm is not None:
            return
        cfg = self.config
        n = self.A.n
        T = self._resolve_tile_size(n)
        if self._schur_unknowns is not None:
            # the Schur dofs (ordered last) start at a tile boundary; the
            # others keep the supernode alignment, which the reference
            # drops in Schur mode (at poisson_3d(64) that unaligned grid
            # held 4.5x the tiles and 40x the levels)
            ns = self._schur_unknowns.size
            n0 = n - ns
            if cfg.align_supernodes:
                ext0, n0p = self._aligned_ext_map(T, n0)
            else:
                ext0, n0p = np.arange(n0, dtype=np.int64), -(-n0 // T) * T
            ext = np.concatenate([ext0, n0p + np.arange(ns, dtype=np.int64)])
            n_ext = n0p + ns
            self._schur_first_bcol = n0p // T
        elif cfg.align_supernodes:
            ext, n_ext = self._aligned_ext_map(T)
            self._schur_first_bcol = None
        else:
            ext = np.arange(n, dtype=np.int64)
            n_ext = n
            self._schur_first_bcol = None
        self._ext_map = ext
        self._ext_n = n_ext
        self._tile_size = T
        Ap = self._A_perm = self._permuted_extended()
        pat = (abs(Ap) + abs(Ap).T).astype(bool).tocsc()
        pat = (pat + sp.eye(n_ext, dtype=bool, format="csc")).astype(bool).tocsc()
        self._pat_perm_ext = pat

    @property
    def _card(self) -> bool:
        return self.device.type == "cuda"

    def _resolve_tile_size(self, n: int) -> int:
        """The config's tile size for ``n`` dofs on this device
        (``PastixConfig.resolve_tile_size``); on the card an fp32 pool
        takes only the sizes its kernels are built for (``CARD_TILES``)."""
        T = self.config.resolve_tile_size(n, self._card)
        if self._card and self._dtype == torch.float32 \
                and T not in CARD_TILES:
            raise ValueError(
                f"tile_size={T} on {self.device}: the card's kernels take "
                f"T in {CARD_TILES}")
        return T

    def _permuted_extended(self) -> sp.csc_matrix:
        """A's values permuted and embedded into the cached extension
        (fp64 CSC, sorted indices), identity on the padding rows: the
        analysis's matrix and, on new values, the reference's
        ``_build_extended_matrix_values_only``."""
        A_full = self.A.to_scipy().tocoo()
        perm = self.order_.permtab
        ext, n_ext = self._ext_map, self._ext_n
        ri = ext[perm[A_full.row]]
        ci = ext[perm[A_full.col]]
        pad_rows = np.setdiff1d(np.arange(n_ext), ext)  # the identity gap
        ri = np.concatenate([ri, pad_rows])
        ci = np.concatenate([ci, pad_rows])
        vdt = np.result_type(A_full.data.dtype, np.float64)
        data = np.concatenate([A_full.data.astype(vdt), np.ones(pad_rows.size, vdt)])
        Ap = sp.coo_matrix((data, (ri, ci)), shape=(n_ext, n_ext)).tocsc()
        Ap.sum_duplicates()
        Ap.sort_indices()
        return Ap

    # ------------------------------------------------------------------
    # phase 3: analysis
    # ------------------------------------------------------------------

    def _free_device_bytes(self) -> Optional[int]:
        """The bytes a device allocation could take (the card's free
        memory and what PyTorch's allocator holds unused); None on the
        CPU."""
        if self.device.type != "cuda":
            return None
        return int(torch.cuda.mem_get_info(self.device)[0]
                   + torch.cuda.memory_reserved(self.device)
                   - torch.cuda.memory_allocated(self.device))

    def _build_layout(self, tail: bool) -> SolverLayout:
        """The tile layout of the analysis (with the dense tail's fill
        when ``tail``), saved under ``IOStrategy.SAVE``."""
        cfg = self.config
        lay = build_layout(
            self._pat_perm_ext,
            self._tile_size,
            for_lu=self._kind == Factorization.LU,
            schur_first_bcol=self._schur_first_bcol,
            incomplete=cfg.incomplete,
            level_of_fill=cfg.level_of_fill,
            densify_tail_frac=cfg.dense_tail_fill if tail else 0.0,
        )
        if cfg.io_strategy == IOStrategy.SAVE:
            lay.save(os.path.join(cfg.io_dir, "layoutname"))
        return lay

    def _can_stream(self) -> bool:
        """Whether the factorization can stream (the reference's rule):
        Hermitian (or real) LLᵗ, LDLᵗ, LDLᴴ and LU, no Schur unknowns, not
        incomplete."""
        kind = self._kind
        return (((kind == Factorization.LLT and self._hermitian)
                 or kind in (Factorization.LDLT, Factorization.LDLH,
                             Factorization.LU))
                and self._schur_first_bcol is None
                and not self.config.incomplete)

    def analyze(self) -> SolverLayout:
        """Tile layout, dense-tail plan, and every device table: coefinit
        indices, the left-looking K1 plans, the K3 plans of the Schur
        residue, the solve's tables and the refinement's ELL matrix.
        Schur mode leaves the Schur columns unfactored; the dense tail is
        LLᵗ only and off in Schur mode (the reference's rules).

        The solve and the refinement are chosen here, by the user's flags
        (reference ``pastix.py:855-990``, without its TPU gates):
        ``fast_solve`` takes the K2 sweeps over the inverse diagonal
        tiles, else the per-level solve (``solve.build_solve_fn``), which
        needs no inverses; with ``device_refine`` and ``fast_solve`` and a
        refinement method, the device loop of ``krylov`` refines, else the
        host loop of ``refine`` with the device solve as M⁻¹.

        The pools' dtype (``compute_dtype``) picks the route: fp32 real
        runs the hand kernels as above; fp64, complex64 and complex128
        run ``numeric.factorize._build_plain`` and the per-level solve in
        their dtype, with or without ``fast_solve`` (the reference's
        inverse-tile solve is not ported).  A real fp64 pool refines in
        the device loop under the same flags, the per-level solve as M⁻¹;
        a complex pool refines on the host, in complex128.  The dense tail
        is LLᵗ or LLᴴ (not complex-symmetric LLᵗ).

        ``incomplete`` (ILU(k), the reference's ``:392-452``): block grain
        builds the incomplete tile layout (``level_of_fill``; no dense
        tail, no packed plan) and factors it on the route of its dtype;
        scalar grain (``ilu_grain="scalar"``) analyzes nothing here and
        returns None: ``factorize`` computes the scalar pattern once and
        factors on the host.  ``packed_update=True`` or ``PASTIX_PACKED``
        (not ``0``) builds the packed plan (``analyze.packed``) over the
        levels that run, and the factorization takes the packed E2 path
        (the reference's gate ``:624-646``).

        Out-of-core (the reference's ``:398-560``): with ``ooc`` and an
        ``ooc_limit_mb`` the pools exceed, the factorization streams
        (``numeric/ooc``: ``plan_ooc`` under that budget; the pools in
        host memory, one segment's window and export slots on the card at
        a time) and so does the solve; without ``ooc``, pools larger than
        the card's free memory stream under ``_AUTO_OOC_SHARE`` of it
        (auto-streaming).
        Both need a kind that streams (:meth:`_can_stream`); a pool that
        must stream but cannot raises ``MemoryError``.  A streamed
        analysis has no dense tail (recovered, with ``ooc``, when the
        pools fit the budget after all), no packed plan, no inverse
        diagonal tiles and no device refinement loop: refinement runs the
        host loop.  With ``ooc`` and resident pools the factors leave the
        card after each factorization when they exceed ``ooc_limit_mb``
        (always with a limit of 0) and a solve brings them back
        (:meth:`_offload_factors`); the host loop refines there too.  The
        device loop is built only for factors that stay on the card.

        With ``mesh_shape`` the tables are the mesh's
        (:meth:`_analyze_mesh`): no streaming, packed plan or
        auto-streaming, and ``dist_strategy="subtree"`` has no dense tail
        (its shared top phase covers those columns)."""
        cfg = self.config
        if self.symbol_ is None:
            self.symbfact()
        if _scalar_ilu(cfg):
            return None
        t0 = time.perf_counter()
        dev = self.device
        kind, dt, herm = self._kind, self._dtype, self._hermitian
        plain = dt != torch.float32
        itemsize = dt.itemsize
        is_lu = kind == Factorization.LU
        mesh = cfg.mesh_shape is not None
        # the subtree schedule's shared top phase covers the tail
        use_subtree = (mesh and cfg.dist_strategy == "subtree"
                       and cfg.factorization in (Factorization.LLT,
                                                 Factorization.LDLT)
                       and not dt.is_complex)
        want_tail = (cfg.dense_tail and self._schur_first_bcol is None
                     and kind == Factorization.LLT and herm
                     and not cfg.incomplete and not use_subtree)
        if mesh and cfg.ooc:
            raise _not_ported("out-of-core (ooc) with mesh_shape", "A9")
        # streaming is decided before the layout: its windows cannot hold
        # the dense tail's (m, m) block
        stream = cfg.ooc and cfg.ooc_limit_mb > 0 and self._can_stream()
        use_tail = want_tail and not stream
        layout_path = os.path.join(cfg.io_dir, "layoutname")
        if cfg.io_strategy == IOStrategy.LOAD and os.path.exists(
            layout_path + ".npz"
        ):
            # the third analysis artifact, as the reference keeps it
            self.layout = SolverLayout.load(layout_path)
            self.layout.check()
        else:
            self.layout = self._build_layout(use_tail)
        T = self.layout.T
        tile_bytes = T * T * itemsize
        npools = 2 if is_lu else 1
        pool_bytes = self.layout.npool * tile_bytes * npools
        free = self._free_device_bytes()
        self._ooc_plan = None
        if stream:
            budget = cfg.ooc_limit_mb << 20
            if pool_bytes > budget:
                self._ooc_plan = plan_ooc(self.layout, budget, itemsize,
                                          two_pools=is_lu)
            elif want_tail:
                # resident after all: recover the dense tail if its
                # densified pool fits the budget too
                tail_lay = self._build_layout(True)
                if tail_lay.npool * tile_bytes <= budget:
                    self.layout, use_tail = tail_lay, True
        elif free is not None and pool_bytes > free and not mesh:
            if not self._can_stream():
                raise MemoryError(
                    f"{'two tile pools' if is_lu else 'a tile pool'} of "
                    f"{pool_bytes / 2**30:.2f} GiB on {dev} with "
                    f"{free / 2**30:.2f} GiB free, and this factorization "
                    "cannot stream (Schur unknowns, incomplete, or "
                    "complex-symmetric LLᵗ)")
            # auto-streaming under a share of the card's free memory
            budget = int(free * _AUTO_OOC_SHARE)
            if use_tail:
                self.layout, use_tail = self._build_layout(False), False
            self._ooc_plan = plan_ooc(self.layout, budget, itemsize,
                                      two_pools=is_lu)
            if cfg.verbosity >= Verbosity.NO:
                print(f"[pastix-tpu-torch] pool ({pool_bytes / 2**30:.1f} "
                      f"GiB) exceeds the card's free memory "
                      f"({free / 2**30:.1f} GiB): auto-streaming in "
                      f"{len(self._ooc_plan.segments)} OOC segments")
        plan = self._ooc_plan
        if plan is not None and cfg.verbosity >= Verbosity.YES:
            mf = plan.max_footprint_tiles()
            print(f"[pastix-tpu-torch] ooc: {len(plan.segments)} segments, "
                  f"max window {mf} tiles ({mf * tile_bytes / 2**20:.0f} "
                  f"MB) under {budget >> 20} MB budget")
        lay = self.layout
        self._dense_tail = None
        if use_tail:
            # the dense tail holds the (m, m) block plus about two
            # same-sized temps next to the pool: cap m by the free device
            # memory (the reference assumed a 13 GB budget)
            m_cap = 1 << 15
            if free is not None:
                room = max(free - pool_bytes, (4 * T) ** 2 * 3 * itemsize)
                m_cap = min(m_cap, int(np.sqrt(room / (3 * itemsize))))
            self._dense_tail = plan_dense_tail(lay, max_m=m_cap)
        # the packed gate: packed_update=None (auto) stays off, a recorded
        # deviation (the reference's auto turns it on for every backend
        # but the TPU; whether the card wants it is for the benchmark's
        # cells); PASTIX_PACKED overrides; never on an incomplete layout
        packed_on = bool(cfg.packed_update)
        env_packed = os.environ.get("PASTIX_PACKED")
        if env_packed is not None:
            packed_on = env_packed != "0"
        self._packed_plan = None
        if packed_on and not cfg.incomplete and plan is None and not mesh:
            self._packed_plan = build_packed_plan(
                lay, self._pat_perm_ext,
                levels=(self._dense_tail.levels_lo
                        if self._dense_tail is not None else None),
                for_lu=is_lu,
            )
        upd = _UPDATE_DTYPES[cfg.update_dtype]
        if mesh:
            self._analyze_mesh(use_subtree)
        else:
            # a streamed pool is assembled in host memory, pinned for the card
            self._coef_fn = build_coefinit_fn(
                lay, self._A_perm,
                dev if plan is None else torch.device("cpu"),
                for_lu=is_lu, dtype=dt,
                pin_memory=plan is not None and dev.type == "cuda")
            self._fact_fn = build_factorize_fn(
                lay, dev, kind, update_dtype=upd, dense_tail=self._dense_tail,
                dtype=dt, hermitian=herm, packed_plan=self._packed_plan,
                ooc_plan=plan,
            )
            if plan is not None:
                self._fact_fn.verbose = cfg.verbosity >= Verbosity.YES
                self._dinv_fn = self._fwd_fn = self._bwd_fn = None
                self._solve_fn = build_streamed_solve_fn(lay, plan, dev, kind,
                                                         dt, herm)
            elif cfg.fast_solve and not plain:
                self._dinv_fn = build_diag_inverse_fn(lay, dev, kind)
                self._fwd_fn, self._bwd_fn = build_fwd_bwd_fns(lay, dev, kind)
                self._solve_fn = build_solve_fn_sweep(lay, dev, kind,
                                                      self._fwd_fn.plan)
            else:
                # the per-level solve: no inverse diagonal tiles (nbc T² of
                # device memory saved, twice on LU), no K2
                self._dinv_fn = None
                self._fwd_fn, self._bwd_fn = build_level_fwd_bwd_fns(
                    lay, dev, kind, dt, herm)
                self._solve_fn = build_solve_fn(lay, dev, kind, dt, herm)
            self._refine_fn = self._ell = None
            resident = plan is None and not self._offloads(
                lay.npool * tile_bytes * npools)
            if (cfg.device_refine and cfg.fast_solve and not dt.is_complex
                    and cfg.refinement != RefinementMethod.NONE and resident):
                self._refine_fn = build_device_refine_fn(
                    lay, self._solve_fn, method=cfg.refinement,
                    restart=cfg.gmres_restart, dtype=dt,
                )
                self._ell = self._device_ell()
        synchronize(dev)
        self.report.analyze_time = time.perf_counter() - t0
        self._trace_phase("analyze", t0)
        self.report.tile_size = T
        self.report.n_tiles = lay.npool
        self.report.n_levels = (
            len(self._dense_tail.levels_lo) + 1
            if self._dense_tail is not None
            else len(lay.levels)
        )
        self.report.dense_tail_m = (
            self._dense_tail.m if self._dense_tail is not None else 0
        )
        self.report.nnz_l = lay.npool * T * T
        self.report.fact_flops_padded = (
            lay.padded_flops("lu" if is_lu else "llt")
            - self._fact_fn.e2_saved_flops
        )
        if self.report.fact_flops > 0:
            self.report.padding_waste = (
                self.report.fact_flops_padded / self.report.fact_flops - 1.0
            )
        self.report.memory_bytes = lay.memory_bytes(dtype_bytes=itemsize,
                                                    lu=is_lu)
        self.report.memory_terms = self.report.memory_bytes // itemsize
        if cfg.verbosity >= Verbosity.YES:
            print(
                f"[pastix-tpu-torch] analyze: T={T} tiles={lay.npool} "
                f"levels={self.report.n_levels} "
                f"padded flops={self.report.fact_flops_padded:.3e} "
                f"(waste {100 * self.report.padding_waste:.0f}%)"
            )
        return lay

    def _analyze_mesh(self, use_subtree: bool) -> None:
        """The mesh's device tables (reference ``pastix.py:560-592`` and
        ``:655-790``): the ``DeviceMesh`` of ``mesh_shape`` with the
        reference's axis names (tp the last axis, dp the first), the
        ranks' layouts checked equal, then the schedule the reference
        picks.  Subtree mapping for ``dist_strategy="subtree"`` (real LLᵗ
        and LDLᵗ); owner-computes over a sharded pool for real LLᵗ, LDLᵗ
        and LU unless ``shard_pool=False`` or Schur unknowns are set
        (``parallel/owner``: each rank's coefinit fills its own tiles;
        the owner solve; the host refinement loop); else the replicated
        pool (``parallel/sharded``; ``parallel/subtree`` too) with the
        one-device solve of the pool's dtype over the rank's dp share of
        the columns, and with ``device_refine`` the device loop whose
        residual's SpMV is split over tp (real pools)."""
        from pastix_tpu_torch.parallel.owner import (
            build_local_coefinit_fn, build_owner_factorize_ldlt,
            build_owner_factorize_llt, build_owner_factorize_lu,
            build_owner_solve_llt, build_owner_solve_lu, build_pool_sharding,
        )
        from pastix_tpu_torch.parallel.sharded import (
            build_sharded_factorize, build_sharded_refine,
            build_sharded_solve,
        )
        from pastix_tpu_torch.parallel.subtree import build_subtree_factorize

        cfg, lay, dev = self.config, self.layout, self.device
        kind, dt, herm = self._kind, self._dtype, self._hermitian
        upd = _UPDATE_DTYPES[cfg.update_dtype]
        is_lu = kind == Factorization.LU
        shape = tuple(int(s) for s in cfg.mesh_shape)
        names = tuple(cfg.mesh_axis_names)
        if len(names) != len(shape):
            names = ("dp", "tp")[2 - len(shape):] if len(shape) <= 2 else (
                tuple(f"ax{i}" for i in range(len(shape) - 1)) + ("tp",))
        self._mesh = make_mesh(shape, names)
        self._tp = Axis(self._mesh, names[-1])
        self._dp = Axis(self._mesh, names[0]) if len(names) > 1 else None
        self._check_layout_digest()
        fz = cfg.factorization
        owner_ok = (not dt.is_complex and cfg.shard_pool is not False
                    and self._schur_first_bcol is None and not use_subtree)
        self._pool_sharding = None
        self._refine_fn = self._ell = None
        self._sharded_refine_fn = self._a_coo_dev = None
        self._dinv_fn = self._fwd_fn = self._bwd_fn = None
        tp, dp = self._tp, self._dp
        if owner_ok and ((fz == Factorization.LLT and herm)
                         or fz in (Factorization.LDLT, Factorization.LU)):
            # owner-computes over a sharded pool: per-rank memory ~
            # pool/ranks + halo (the local SolverMatrix of the
            # reference's solverMatrixGen)
            tail = self._dense_tail if kind == Factorization.LLT else None
            sh = self._pool_sharding = build_pool_sharding(lay, tp.size,
                                                           dense_tail=tail)
            self._coef_fn = build_local_coefinit_fn(
                lay, self._A_perm, sh, tp.me, dev, for_lu=is_lu, dtype=dt)
            if kind == Factorization.LLT:
                self._fact_fn = build_owner_factorize_llt(
                    lay, sh, tp, dev, dense_tail=tail, update_dtype=upd,
                    dtype=dt)
                self._solve_fn = build_owner_solve_llt(
                    lay, sh, tp, dev, dense_tail=tail, dp=dp, dtype=dt)
            elif is_lu:
                self._fact_fn = build_owner_factorize_lu(
                    lay, sh, tp, dev, update_dtype=upd, dtype=dt)
                self._solve_fn = build_owner_solve_lu(lay, sh, tp, dev,
                                                      dp=dp, dtype=dt)
            else:
                self._fact_fn = build_owner_factorize_ldlt(
                    lay, sh, tp, dev, update_dtype=upd, dtype=dt)
                self._solve_fn = build_owner_solve_llt(
                    lay, sh, tp, dev, unit=True, with_d=True, dp=dp,
                    dtype=dt)
            self._fact_fn.e2_saved_flops = 0.0
            return
        # the replicated pool: every rank holds it whole
        self._coef_fn = build_coefinit_fn(lay, self._A_perm, dev,
                                          for_lu=is_lu, dtype=dt)
        if use_subtree:
            self._fact_fn = build_subtree_factorize(lay, tp, dev, kind, dt)
        else:
            self._fact_fn = build_sharded_factorize(
                lay, tp, dev, kind, dense_tail=self._dense_tail,
                update_dtype=upd, dtype=dt, hermitian=herm)
        if cfg.fast_solve and dt == torch.float32:
            self._dinv_fn = build_diag_inverse_fn(lay, dev, kind)
            self._fwd_fn, self._bwd_fn = build_fwd_bwd_fns(lay, dev, kind)
            inner = build_solve_fn_sweep(lay, dev, kind, self._fwd_fn.plan)
        else:
            self._fwd_fn, self._bwd_fn = build_level_fwd_bwd_fns(
                lay, dev, kind, dt, herm)
            inner = build_solve_fn(lay, dev, kind, dt, herm)
        self._solve_fn = build_sharded_solve(lay, dp, inner)
        if (cfg.device_refine and cfg.refinement != RefinementMethod.NONE
                and not dt.is_complex):
            # the fused solve + Richardson with a tp-split SpMV (one
            # all_reduce a residual); the host loop finishes if needed
            self._sharded_refine_fn = build_sharded_refine(lay, tp, inner)

    def _check_layout_digest(self) -> None:
        """Every rank analyzes the whole matrix (the reference's
        centralized interface under MPI): their orderings and tile tables
        must agree, or the collectives would pair the wrong tiles.  One
        all_gather of a digest of them over the process group; a
        difference raises on every rank."""
        import hashlib

        lay = self.layout
        h = hashlib.sha256()
        for a in (self.order_.permtab, self._ext_map, lay.keys,
                  *[x for lv in lay.levels for x in (
                      lv.cols, lv.gemm_a, lv.gemm_b, lv.gemm_d)]):
            h.update(np.ascontiguousarray(a, np.int64).tobytes())
        dig = torch.as_tensor(np.frombuffer(h.digest(), np.int64).copy(),
                              device=self.device)
        alld = world().all_gather(dig)
        if not bool((alld == alld[0]).all()):
            raise RuntimeError(
                "the ranks' analyses differ (ordering or tile tables): every "
                "rank must analyze the same matrix with the same config "
                "(seed included)")

    def _device_ell(self):
        """The device loop's fp64 ELL matrix of the current ``A_perm``."""
        cols, vals = build_ell(
            sp.coo_matrix(self._A_perm), self.layout.nbc * self.layout.T,
            np.float64,
        )
        return (torch.as_tensor(cols.astype(np.int64), device=self.device),
                torch.as_tensor(vals, device=self.device))

    def _set_values(self, values) -> None:
        """New values on the cached analysis (reference ``factorize``
        ``:1023-1041`` and ``_build_extended_matrix_values_only``): ``A``,
        ``A_perm`` and the device loop's ELL matrix are rebuilt on the
        cached order and extension.  The coefinit's scatter indices select
        entries by their position in ``A_perm``, so its CSC pattern must
        be the analysis's."""
        values = np.asarray(values)
        if values.shape[0] != self.A.nnz:
            raise ValueError("values length must match nnz of the pattern")
        self._check_values(values)
        old = self._A_perm
        self.A = SparseMatrix(
            self.A.n, self.A.colptr, self.A.rowind, values,
            self.A.symmetric_storage,
        )
        Ap = self._permuted_extended()
        if not (np.array_equal(Ap.indptr, old.indptr)
                and np.array_equal(Ap.indices, old.indices)):
            raise ValueError(
                "the new values change the pattern of the permuted matrix "
                "(an explicit zero dropped?): run a new analysis"
            )
        self._A_perm = Ap
        if self._refine_fn is not None:
            self._ell = self._device_ell()

    # ------------------------------------------------------------------
    # phase 4: numeric factorization
    # ------------------------------------------------------------------

    @_pinned
    def factorize(self, values: Optional[np.ndarray] = None) -> Factors:
        """Coefinit, the factorization of the configured kind and, with
        ``fast_solve``, the inverse diagonal tiles, on the device; returns
        when the device has finished.  LDLᵗ and LU clamp pivots below
        ``static_pivoting_threshold · max|A|`` and report their number in
        ``report.static_pivots``.  ``values`` (same pattern, new numbers:
        ``A.values`` order) refactors on the cached analysis, with no host
        analysis again.  Scalar ILU (``ilu_grain="scalar"``) factors on the
        host instead (:meth:`_factorize_scalar_ilu`).  A streamed analysis
        assembles the pools in host memory and streams them through the
        card (:meth:`_factorize_streamed`); with ``ooc``, resident factors
        larger than ``ooc_limit_mb`` then leave the card
        (:meth:`_offload_factors`).  ``report.predicted_fact_time`` is the
        cost model's (``perf.predict_fact_time``) unless
        ``PASTIX_MEASURED_PLAN=0``; with ``trace`` the phase is the span
        ``numfact`` (scalar ILU: ``factorize``)."""
        cfg = self.config
        scalar = _scalar_ilu(cfg)
        if scalar:
            if self.symbol_ is None:
                self.symbfact()
        elif self.layout is None:
            self.analyze()
        if values is not None:
            self._set_values(values)
        t0 = time.perf_counter()
        if scalar:
            return self._factorize_scalar_ilu(t0)
        if self._ooc_plan is not None:
            return self._factorize_streamed(t0)
        if self._pool_sharding is not None:
            return self._factorize_owner(t0)
        f = self.factors = numeric_factorize(
            self.layout, self._A_perm, self._coef_fn, self._fact_fn,
            self.device, pivot_threshold=cfg.static_pivoting_threshold,
        )
        if self._dinv_fn is not None:
            inv = self._dinv_fn(f.pool)
            lu = f.kind == Factorization.LU
            f.dinv, f.dinv_u = inv if lu else (inv, None)
        self._offload_factors()
        if self._sharded_refine_fn is not None:
            # the rank's contiguous share of A's COO entries, padded to a
            # tp multiple, for the device loop's split residual
            from pastix_tpu_torch.parallel.sharded import shard_coo

            share = [torch.as_tensor(a.reshape(self._tp.size, -1)[
                self._tp.me].astype(np.int64 if a.dtype.kind == "i"
                                    else a.dtype), device=self.device)
                     for a in shard_coo(sp.coo_matrix(self._A_perm),
                                        self._tp.size,
                                        np_dtype(self._dtype))]
            self._a_coo_dev = tuple(share)
        synchronize(self.device)
        self.report.fact_time = time.perf_counter() - t0
        self._trace_phase("numfact", t0)
        self.report.static_pivots = self.factors.n_static_pivots
        self.report.fact_gflops = self.report.fact_flops / max(
            self.report.fact_time, 1e-12
        ) / 1e9
        # the cost model's prediction, called as the reference calls it
        # (the layout, fp32 bodies) on this solver's device (the first
        # call at a tile size calibrates, disk-cached); an error
        # propagates, where the reference swallows it.  A mesh's ranks
        # skip it (it models one device)
        if (os.environ.get("PASTIX_MEASURED_PLAN", "1") != "0"
                and self._mesh is None):
            self.report.predicted_fact_time = predict_fact_time(
                self.layout, device=self.device)
        if cfg.verbosity >= Verbosity.NO:
            pred = (
                f", predicted {self.report.predicted_fact_time:.3f}s"
                if self.report.predicted_fact_time
                else ""
            )
            print(
                f"[pastix-tpu-torch] numfact: {self.report.fact_time:.3f}s "
                f"({self.report.fact_gflops:.2f} GFLOP/s useful, "
                f"pivots clamped: {self.report.static_pivots}{pred})"
            )
        return self.factors

    def _factorize_owner(self, t0: float) -> Factors:
        """The owner-computes numeric phase (reference
        ``_factorize_owner``): each rank's coefinit fills only its own
        (nloc, T, T) tiles, which stay sharded through the factorization
        and the solve (``parallel/owner``).  ``report.memory_bytes`` is
        the rank's pool bytes; ``static_pivots`` counts every rank's.  An
        LLᵗ breakdown on any rank raises on every rank."""
        cfg, lay, sh, tp = self.config, self.layout, self._pool_sharding, \
            self._tp
        kind = self._kind
        vals = torch.as_tensor(
            sp.coo_matrix(self._A_perm).data.astype(np_dtype(self._dtype)),
            device=self.device)
        anorm = float(abs(self._A_perm).max()) if self._A_perm.nnz else 1.0
        eps = cfg.static_pivoting_threshold * anorm
        if kind == Factorization.LU:
            p, pu, npiv = self._fact_fn(*self._coef_fn(vals), eps)
            f = Factors(kind, lay, p, pool_u=pu, n_static_pivots=int(npiv))
        elif kind == Factorization.LDLT:
            p, d, npiv = self._fact_fn(self._coef_fn(vals), eps)
            f = Factors(kind, lay, p, d=d, n_static_pivots=int(npiv))
        else:
            p = self._fact_fn(self._coef_fn(vals))
            cols = np.arange(lay.nbc)
            dt_ = lay.lookup(cols, cols)
            mine = torch.as_tensor(sh.loc[dt_[sh.owner[dt_] == tp.me]],
                                   dtype=torch.int64, device=self.device)
            bad = (~torch.isfinite(torch.diagonal(
                p[mine], dim1=-2, dim2=-1))).any().to(torch.int32)
            if int(tp.all_reduce(bad)):
                raise FloatingPointError(
                    "LL^T factorization broke down (NaN/Inf pivot): the "
                    "matrix is not positive definite. Use Factorization.LDLT "
                    "(static pivoting) or LU for indefinite or unsymmetric "
                    "systems.")
            f = Factors(kind, lay, p)
        self.factors = f
        synchronize(self.device)
        self.report.fact_time = time.perf_counter() - t0
        self._trace_phase("numfact", t0)
        self.report.static_pivots = f.n_static_pivots
        self.report.fact_gflops = self.report.fact_flops / max(
            self.report.fact_time, 1e-12) / 1e9
        npools = 2 if kind == Factorization.LU else 1
        self.report.memory_bytes = (sh.nloc * lay.T ** 2 * npools
                                    * self._dtype.itemsize)
        if cfg.verbosity >= Verbosity.NO:
            print(
                f"[pastix-tpu-torch] numfact(owner): "
                f"{self.report.fact_time:.3f}s "
                f"({self.report.fact_gflops:.2f} GFLOP/s useful, pool"
                f"{'s' if npools == 2 else ''} sharded {sh.ndev} x "
                f"{sh.nloc} tiles{' x2' if npools == 2 else ''})"
            )
        return f

    def _factorize_streamed(self, t0: float) -> Factors:
        """The streamed numeric phase (the reference's
        ``_factorize_streamed``): the pools assembled in host memory, then
        factored segment by segment on the card (``numeric/ooc``), the
        host pools the backing store; LLᵗ's breakdown check reads the
        factored diagonal on the host.  ``plan.io`` counts the bytes and
        seconds moved from here on (``numeric.ooc.reset_io``)."""
        cfg, plan = self.config, self._ooc_plan
        reset_io(plan)
        # the previous factors' pinned pools go back to PyTorch's host
        # allocator, which hands them to the new ones (pinning costs
        # about 0.3 s a GiB)
        self.factors = None
        f = self.factors = numeric_factorize(
            self.layout, self._A_perm, self._coef_fn, self._fact_fn,
            torch.device("cpu"), pivot_threshold=cfg.static_pivoting_threshold,
        )
        f.offloaded = f.streamed = True
        synchronize(self.device)
        self.report.fact_time = time.perf_counter() - t0
        self._trace_phase("numfact", t0)
        self.report.static_pivots = f.n_static_pivots
        self.report.fact_gflops = self.report.fact_flops / max(
            self.report.fact_time, 1e-12
        ) / 1e9
        if cfg.verbosity >= Verbosity.NO:
            print(
                f"[pastix-tpu-torch] numfact(ooc): "
                f"{self.report.fact_time:.3f}s "
                f"({self.report.fact_gflops:.2f} GFLOP/s useful, "
                f"{len(plan.segments)} segments)"
            )
        return f

    # the reference's out-of-core analog for resident factors: host-RAM
    # offload after the factorization, a restore per solve

    def _offload_factors(self) -> None:
        """Move the factored pools to host memory unless they fit
        ``ooc_limit_mb`` (a limit of 0 always moves them; reference
        ``_offload_factors``).  The inverse diagonal tiles and the pivots
        stay on the card."""
        f = self.factors
        if f is None or f.offloaded:
            return
        pools = [p for p in (f.pool, f.pool_u) if p is not None]
        if not self._offloads(sum(p.numel() * p.element_size()
                                  for p in pools)):
            return
        pin = self.device.type == "cuda"
        host = lambda p: torch.empty(p.shape, dtype=p.dtype,
                                     pin_memory=pin).copy_(p)
        f.pool = host(f.pool)
        f.pool_u = None if f.pool_u is None else host(f.pool_u)
        f.offloaded = True

    def _offloads(self, nbytes: int) -> bool:
        """Whether resident factors of ``nbytes`` leave the card after the
        factorization: with ``ooc``, above ``ooc_limit_mb`` (any, with a
        limit of 0)."""
        limit = self.config.ooc_limit_mb << 20
        return self.config.ooc and (not limit or nbytes > limit)

    def _restore_factors(self) -> Factors:
        """The factors with their pools on the card: a copy for offloaded
        ones (dropped after the solve that uses it), else themselves."""
        f = self.factors
        if not f.offloaded or f.streamed:
            return f
        dev = lambda p: None if p is None else p.to(self.device)
        return dataclasses.replace(f, pool=dev(f.pool), pool_u=dev(f.pool_u),
                                   offloaded=False)

    def _factorize_scalar_ilu(self, t0: float) -> ScalarILUFactors:
        """Scalar-grain ILU(k) on the host (the reference's
        ``_factorize_scalar_ilu``, ``pastix.py:1167-1211``): the exact
        scalar level-of-fill pattern, computed on the first call and kept
        for new values (its seconds are ``report.analyze_time``), then the
        host IKJ factorization restricted to it.  No tile layout and no
        device program: ``solve`` and ``as_preconditioner`` apply the
        factors on the host (``ScalarILUFactors.solve``) inside the host
        refinement loop.  As the reference's, ``report.nnz_l_exact`` and
        ``fact_flops`` keep describing the complete fill."""
        cfg = self.config
        if self._scalar_ilu_pat is None:
            self._scalar_ilu_pat = scalar_ilu_pattern(
                self._pat_perm_ext, cfg.level_of_fill)
            self.report.analyze_time = time.perf_counter() - t0
            t0 = time.perf_counter()
        lr, lc = self._scalar_ilu_pat
        anorm = float(abs(self._A_perm).max())
        self.factors = scalar_ilu_factor(
            self._A_perm.tocsc(), lr, lc,
            cfg.static_pivoting_threshold * anorm,
        )
        self.report.fact_time = time.perf_counter() - t0
        self.report.static_pivots = self.factors.static_pivots
        self.report.memory_terms = self.factors.nnz_terms
        self.report.nnz_l = int(self.factors.L.nnz)
        self._trace_phase("factorize", t0)
        if cfg.verbosity >= Verbosity.NO:
            print(
                f"[pastix-tpu-torch] scalar ILU({cfg.level_of_fill}): "
                f"{self.factors.nnz_terms} terms, "
                f"{self.report.fact_time:.3f}s "
                f"(pivots clamped: {self.report.static_pivots})"
            )
        return self.factors

    # ------------------------------------------------------------------
    # phases 5-6: solve + refinement
    # ------------------------------------------------------------------

    def _perm_rhs(self, b: np.ndarray) -> np.ndarray:
        """Original-order RHS -> extended permuted order."""
        b = np.asarray(b)
        if b.shape[0] != self.A.n:
            raise ValueError(
                f"rhs has {b.shape[0]} rows but the matrix is {self.A.n}x{self.A.n}"
            )
        one_d = b.ndim == 1
        bb = b[:, None] if one_d else b
        rdt = np.result_type(b.dtype, np.float64)
        out = np.zeros((self._ext_n, bb.shape[1]), dtype=rdt)
        out[self._ext_map] = bb[self.order_.peritab]
        return out[:, 0] if one_d else out

    def _unperm_sol(self, x_ext: np.ndarray) -> np.ndarray:
        x_ext = np.asarray(x_ext)
        one_d = x_ext.ndim == 1
        xx = x_ext[:, None] if one_d else x_ext
        xp = xx[self._ext_map]  # back to permuted (unpadded) order
        out = np.empty_like(xp)
        out[self.order_.peritab] = xp
        return out[:, 0] if one_d else out

    def _raw_solve_ext(self, b_ext: np.ndarray) -> np.ndarray:
        """The factored solve, no refinement, of a host vector or block in
        the extended permuted order, through the device (in the pools'
        dtype there, fp64 or complex128 back): the host loop's M⁻¹.  Scalar
        ILU factors apply on the host."""
        if isinstance(self.factors, ScalarILUFactors):
            return self.factors.solve(b_ext)
        return run_host(self._restore_factors(), b_ext, self._solve_fn,
                        self.device)

    def _sharded_solve_refined(self, b_ext: np.ndarray):
        """The mesh's device loop (``parallel.sharded.build_sharded_refine``,
        reference ``_sharded_solve_refined``) on a host RHS in the
        extended permuted order: (x_ext, device iterations)."""
        cfg, lay = self.config, self.layout
        bb = torch.as_tensor(rhs_to_blocks(lay, b_ext,
                                           dtype=np_dtype(self._dtype)),
                             device=self.device)
        x, it, _ = self._sharded_refine_fn(
            self.factors.solve_args(), *self._a_coo_dev, bb,
            max(cfg.refinement_eps, 5e-7), min(cfg.refinement_itermax, 50))
        out = blocks_to_rhs(lay, x.to(torch.float64).cpu().numpy())
        return (out[:, 0] if np.asarray(b_ext).ndim == 1 else out), it

    def _device_solve_refined(self, b_ext: np.ndarray):
        """The device loop (``krylov.build_device_refine_fn``) on a host
        RHS in the extended permuted order: (x_ext, device iterations)."""
        cfg, lay = self.config, self.layout
        bb = torch.as_tensor(
            rhs_to_blocks(lay, b_ext, dtype=np.float64), device=self.device
        ).reshape(lay.nbc * lay.T, -1)
        x, iters = self._refine_fn(
            self.factors.solve_args(), *self._ell, bb,
            float(cfg.refinement_eps), min(cfg.refinement_itermax, 60),
        )
        xb = x.reshape(lay.nbc, lay.T, -1).cpu().numpy()
        x_ext = blocks_to_rhs(lay, xb)
        return (x_ext[:, 0] if np.asarray(b_ext).ndim == 1 else x_ext), iters

    @_pinned
    def solve(self, b: np.ndarray, refine: Optional[bool] = None) -> np.ndarray:
        """Solve A x = b (original ordering); refinement per config.

        The device loop (``device_refine`` and ``fast_solve``) refines to
        ``refinement_eps``; if the host fp64 residual is still above it,
        the host loop finishes at the configured method, up to
        ``refinement_itermax`` more steps, as the reference's ``solve``
        does (``pastix.py:1711-1771``).  Otherwise the host loop refines
        the factored solve's result.  ``report.refine_iters`` counts the
        device and the host steps; ``report.residual`` is the host fp64
        ``||b - Ax|| / ||b||`` in the permuted order; a complex pool's
        residuals are complex128.  A complex ``b`` needs a complex
        ``compute_dtype``."""
        cfg = self.config
        if np.iscomplexobj(np.asarray(b)) and not self._dtype.is_complex:
            raise ValueError(
                "a complex right-hand side with compute_dtype="
                f"{cfg.compute_dtype}: set compute_dtype to complex64 or "
                "complex128")
        if self._schur_unknowns is not None:
            raise ValueError(
                "Schur unknowns are set: their columns are not factored; "
                "use solve_with_schur(b)"
            )
        if self.factors is None:
            self.factorize()
        do_refine = cfg.refinement != RefinementMethod.NONE if refine is None else refine
        t0 = time.perf_counter()
        b_ext = self._perm_rhs(b)
        Ap = self._A_perm
        dev_iters = 0
        self.report.refine_time = 0.0
        refined = (self._device_solve_refined if self._refine_fn is not None
                   else self._sharded_solve_refined
                   if self._sharded_refine_fn is not None else None)
        if do_refine and refined is not None:
            x_ext, dev_iters = refined(b_ext)
            r = b_ext - Ap @ x_ext
            res = float(np.linalg.norm(r) / max(np.linalg.norm(b_ext), 1e-300))
            self.report.refine_iters, self.report.residual = dev_iters, res
            host_loop = not res <= cfg.refinement_eps  # the host finish
        else:
            x_ext = self._raw_solve_ext(b_ext)
            host_loop = do_refine
        synchronize(self.device)
        self.report.solve_time = time.perf_counter() - t0
        self._trace_phase("solve", t0)
        if host_loop:
            t0 = time.perf_counter()
            rdt = np.result_type(
                np.dtype(cfg.residual_dtype), Ap.dtype, b_ext.dtype,
                np.dtype(cfg.compute_dtype),
            ).type
            res = refine_fn(
                lambda v: Ap @ v, self._raw_solve_ext, b_ext, x_ext,
                method=cfg.refinement, eps=cfg.refinement_eps,
                itermax=cfg.refinement_itermax,
                gmres_restart=cfg.gmres_restart, dtype=rdt,
            )
            x_ext = res.x
            self.report.refine_iters = dev_iters + res.iterations
            self.report.residual = res.residual
            synchronize(self.device)
            self.report.refine_time = time.perf_counter() - t0
            self._trace_phase("refine", t0)
        elif not do_refine:
            r = b_ext - Ap @ x_ext
            self.report.residual = float(
                np.linalg.norm(r) / max(np.linalg.norm(b_ext), 1e-300)
            )
            self.report.refine_iters = 0
        if cfg.verbosity >= Verbosity.NO:
            print(
                f"[pastix-tpu-torch] solve: {self.report.solve_time:.3f}s  "
                f"refine: {dev_iters} device + "
                f"{self.report.refine_iters - dev_iters} host iters -> "
                f"residual {self.report.residual:.3e}"
            )
        return self._unperm_sol(x_ext)

    def as_preconditioner(self):
        """scipy ``LinearOperator`` (n, n) of dtype ``compute_dtype``
        applying the factored solve M⁻¹ with no refinement, in the
        original order: a direct-solve preconditioner for the caller's
        own Krylov loop (``scipy.sparse.linalg.cg``/``gmres`` ``M=``).
        Each application pins true fp32 itself: it runs after
        ``factorize`` has returned."""
        from scipy.sparse.linalg import LinearOperator

        if self.factors is None:
            self.factorize()
        n = self.A.n
        dt = np.dtype(self.config.compute_dtype)

        def mv(r):
            rr = np.asarray(r)
            one_d = rr.ndim == 1
            with pin_precision():
                x = self._unperm_sol(self._raw_solve_ext(self._perm_rhs(rr)))
            return x if not one_d or x.ndim == 1 else x[:, 0]

        return LinearOperator((n, n), matvec=mv, matmat=mv, dtype=dt)

    # ------------------------------------------------------------------
    # Schur complement
    # ------------------------------------------------------------------

    def get_schur(self) -> np.ndarray:
        """Dense Schur complement of the marked unknowns (pastix_getSchur),
        fp64 on the host.  Only the Schur tiles leave the device.  As the
        reference does: under LU a diagonal tile holds the full block and
        the upper blocks of S come from the Uᵗ pool; under LLᵗ and LDLᵗ
        the upper part of S is mirrored from the lower triangle."""
        if self._schur_unknowns is None:
            raise ValueError("no Schur unknowns set")
        if self.factors is None:
            self.factorize()
        lay = self.layout
        T = lay.T
        ns = self._schur_unknowns.size
        sb = self._schur_first_bcol
        nsb = lay.nbc - sb
        S = np.zeros((nsb * T, nsb * T), dtype=np.float64)
        idx = np.flatnonzero(lay.blk_col >= sb)
        idx_t = torch.as_tensor(idx, device=self.factors.pool.device)
        tiles = self.factors.pool[idx_t].cpu().numpy()
        pool_u = self.factors.pool_u
        tiles_u = pool_u[idx_t].cpu().numpy() if pool_u is not None else tiles
        for p, tile, tile_u in zip(idx, tiles, tiles_u):
            I, J = lay.blk_row[p] - sb, lay.blk_col[p] - sb
            S[I * T:(I + 1) * T, J * T:(J + 1) * T] = tile
            if I != J:
                S[J * T:(J + 1) * T, I * T:(I + 1) * T] = tile_u.T
            elif pool_u is None:
                blk = S[I * T:(I + 1) * T, J * T:(J + 1) * T]
                S[I * T:(I + 1) * T, J * T:(J + 1) * T] = (
                    np.tril(blk) + np.tril(blk, -1).T
                )
        return S[:ns, :ns]

    @_pinned
    def solve_with_schur(self, b: np.ndarray, schur_solve=None) -> np.ndarray:
        """Full solve when Schur mode is on: the forward sweep on the
        device, the dense Schur system on the host, the backward sweep on
        the device, then Richardson refinement with that whole solve as
        the preconditioner (at most 50 steps, the reference's cap).

        ``schur_solve(S, y) -> x`` solves the dense Schur system on the
        host; by default S is LU-factored once per call and the factors
        are reused (the reference calls ``np.linalg.solve`` each time: the
        same system)."""
        if self.factors is None:
            self.factorize()
        t0 = time.perf_counter()
        S = self.get_schur()
        if schur_solve is None:
            lu = sla.lu_factor(S)
            solve_s = lambda y: sla.lu_solve(lu, y)
        else:
            solve_s = lambda y: schur_solve(S, y)
        ns = self._schur_unknowns.size
        sb = self._schur_first_bcol * self.layout.T
        f = self._restore_factors()

        def schur_precond(r):
            y = run_host(f, r, self._fwd_fn)
            zs = solve_s(y[sb:sb + ns])
            y[sb:sb + ns] = zs
            z = run_host(f, y, self._bwd_fn)
            z[sb:sb + ns] = zs  # backward must not touch schur rows
            return z

        b_ext = self._perm_rhs(b)
        x_ext = schur_precond(b_ext)
        if self.config.refinement != RefinementMethod.NONE:
            Ap = self._A_perm
            one_d = b_ext.ndim == 1
            res = refine_block(
                lambda v: Ap @ v,
                schur_precond,
                b_ext[:, None] if one_d else b_ext,
                x_ext[:, None] if one_d else x_ext,
                eps=self.config.refinement_eps,
                itermax=min(self.config.refinement_itermax, 50),
                dtype=np.result_type(Ap.dtype, np.float64).type,
            )
            x_ext = res.x[:, 0] if one_d else res.x
            self.report.refine_iters = res.iterations
            self.report.residual = res.residual
        self.report.solve_time = time.perf_counter() - t0
        return self._unperm_sol(x_ext)

    # ------------------------------------------------------------------
    # cleanup (pastix_task_clean)
    # ------------------------------------------------------------------

    def clean(self):
        """The reference's resets, and every device tensor the solver
        holds dropped with them (the factors, the ELL matrix, the
        coefinit, factorization, inverse, solve and refinement tables),
        so the card's allocated bytes return to their level before the
        solver.  A later phase call reruns the pipeline from ``order``."""
        self.factors = None
        self.layout = None
        self.symbol_ = None
        self.order_ = None
        self._A_perm = None
        self._ell = None
        self._coef_fn = self._fact_fn = self._dinv_fn = None
        self._fwd_fn = self._bwd_fn = self._solve_fn = None
        self._refine_fn = None
        self._sharded_refine_fn = self._a_coo_dev = None
        self._pool_sharding = None
        self._dense_tail = None
        self._packed_plan = None
        self._ooc_plan = None
        self._scalar_ilu_pat = None


def spsolve(A, b, config: Optional[PastixConfig] = None, device=None,
            **kw) -> np.ndarray:
    """One-call solve — the reference's single pastix() invocation."""
    if config is None:
        config = PastixConfig(**kw)
    return Pastix(A, config, device=device).solve(b)


def pastix(n: int, colptr: np.ndarray, rowind: np.ndarray, values: np.ndarray,
           b: np.ndarray, config: Optional[PastixConfig] = None,
           base: int = 0, device=None):
    """Array-style API mirroring the reference's pastix() signature
    (src/sopalin/src/pastix.c).  Returns (x, report); ``x`` is None unless
    the phase window (``start_task`` .. ``end_task``) holds SOLVE.
    ``device`` as :class:`Pastix`'s.  Complex values under
    ``Symmetry.HERMITIAN`` or LDLᴴ are taken in full storage (the
    reference keeps the lower triangle and mirrors it unconjugated)."""
    config = config or PastixConfig()
    sym = config.factorization != Factorization.LU
    herm = np.iscomplexobj(values) and (
        config.symmetry == Symmetry.HERMITIAN
        or config.factorization == Factorization.LDLH)
    A = check_matrix(
        n, colptr, rowind, values, base=base,
        symmetric_storage=sym and not herm,
        symmetrize_pattern=not sym,
    )
    solver = Pastix(A, config, device=device)
    # honor the phase window (IPARM_START_TASK .. IPARM_END_TASK)
    st, et = Task(config.start_task), Task(config.end_task)
    x = None
    if st <= Task.ORDERING <= et:
        solver.order()
    if st <= Task.SYMBFACT <= et:
        solver.symbfact()
    if st <= Task.ANALYSE <= et:
        solver.analyze()
    if st <= Task.NUMFACT <= et:
        solver.factorize()
    if st <= Task.SOLVE <= et:
        x = solver.solve(b, refine=et >= Task.REFINE)
    if et >= Task.CLEAN:
        solver.clean()
    return x, solver.report
