"""Top-level solver API of the port (counterpart of ``pastix_tpu/pastix.py``,
real LLᵗ, LDLᵗ and LU).

:class:`Pastix` keeps the reference's step-by-step phases
(``order → symbfact → analyze → factorize → solve``), its Schur-complement
calls (``set_schur_unknowns``, ``get_schur``, ``solve_with_schur``) and
:func:`spsolve` its one-call form.  The host phases (ordering, symbolic
factorization, the supernode-aligned or Schur extension) are copies of the
reference's methods, with the tracing branches left out; the numeric
phases run on one device through the port's kernels.  What is not ported
raises ``NotImplementedError`` naming its ``ROADMAP.md`` slice; there are
no silent fallbacks, and an error on the device propagates.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from pastix_tpu_torch.analyze import SolverLayout, build_layout
from pastix_tpu_torch.analyze.layout import plan_dense_tail
from pastix_tpu_torch.config import (
    Factorization,
    IOStrategy,
    PastixConfig,
    RefinementMethod,
    SolveReport,
    Symmetry,
    Verbosity,
)
from pastix_tpu_torch.order import Order, compute_ordering
from pastix_tpu_torch.sparse import SparseMatrix
from pastix_tpu_torch.symbolic import compute_symbolic
from pastix_tpu_torch._device import pin_precision, resolve_device, synchronize
from pastix_tpu_torch.krylov import build_device_refine_fn, build_ell
from pastix_tpu_torch.numeric.factorize import (
    Factors,
    build_coefinit_fn,
    build_diag_inverse_fn,
    build_factorize_fn,
    factorize as numeric_factorize,
)
from pastix_tpu_torch.refine import refine_block
from pastix_tpu_torch.solve import (
    blocks_to_rhs,
    build_fwd_bwd_fns,
    build_solve_fn_sweep,
    rhs_to_blocks,
    run_host,
)

_UPDATE_DTYPES = {None: None, "float32": torch.float32,
                  "bfloat16": torch.bfloat16}


def _not_ported(what: str, slice_: str):
    return NotImplementedError(
        f"pastix_tpu_torch: {what} is not ported yet (ROADMAP.md {slice_})"
    )


def _check_config(cfg: PastixConfig) -> None:
    if not isinstance(cfg, PastixConfig):
        raise TypeError(
            "config must be a pastix_tpu_torch.config.PastixConfig, got "
            f"{type(cfg).__module__}.{type(cfg).__name__}"
        )
    if cfg.factorization == Factorization.LDLH:
        raise _not_ported("LDLH (Hermitian)", "slice 3")
    if np.issubdtype(np.dtype(cfg.compute_dtype), np.complexfloating) or (
        cfg.symmetry == Symmetry.HERMITIAN
    ):
        raise _not_ported("complex dtypes", "slice 3")
    if np.dtype(cfg.compute_dtype) != np.float32:
        raise _not_ported(f"compute_dtype={cfg.compute_dtype}", "slice 3")
    if cfg.update_dtype not in _UPDATE_DTYPES:
        raise ValueError(f"unsupported update_dtype {cfg.update_dtype!r}")
    if cfg.incomplete:
        raise _not_ported("incomplete (ILU) factorization", "slice 3")
    if cfg.ooc:
        raise _not_ported("out-of-core", "slice 4")
    if cfg.mesh_shape is not None:
        raise _not_ported("mesh_shape (multi-device)", "slice 5")
    if cfg.refinement not in (RefinementMethod.SIMPLE, RefinementMethod.NONE):
        raise _not_ported(f"{cfg.refinement.name} refinement", "slice 3")


class Pastix:
    """Sparse direct solver instance on one device (``cuda`` by default;
    ``device="cpu"`` runs the plain PyTorch twins of the kernels)."""

    def __init__(self, A=None, config: Optional[PastixConfig] = None,
                 device=None):
        self.config = config or PastixConfig()
        _check_config(self.config)
        self.device = resolve_device(device)
        pin_precision()
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
        self._schur_unknowns: Optional[np.ndarray] = None
        self._schur_first_bcol: Optional[int] = None
        if A is not None:
            self.set_matrix(A)

    # ------------------------------------------------------------------
    # input
    # ------------------------------------------------------------------

    def set_matrix(self, A) -> "Pastix":
        """Accepts SparseMatrix, scipy sparse, or dense ndarray."""
        cfg = self.config
        if isinstance(A, SparseMatrix):
            self.A = A
        else:
            S = sp.csc_matrix(A)
            if np.iscomplexobj(S.data):
                raise _not_ported("complex matrices", "slice 3")
            sym = cfg.factorization != Factorization.LU
            if sym and cfg.check_matrix:
                # pastix_checkMatrix: symmetric factorizations demand a
                # numerically symmetric matrix — fail loudly, not garbage
                D = abs(S - S.T)
                if D.nnz and D.max() > 1e-12 * abs(S).max():
                    raise ValueError(
                        f"matrix is not symmetric "
                        f"(max deviation = {D.max():.2e}) "
                        f"but {cfg.factorization} requires it; "
                        "use Factorization.LU for unsymmetric systems"
                    )
            self.A = SparseMatrix.from_scipy(S, symmetric_storage=sym)
        if np.iscomplexobj(self.A.values):
            raise _not_ported("complex matrices", "slice 3")
        self.report.n = self.A.n
        self.report.nnz_a = self.A.nnz
        return self

    def set_schur_unknowns(self, unknowns) -> "Pastix":
        """pastix_setSchurUnknownList equivalent: these dofs are ordered
        last and left unfactored; get_schur() returns their complement."""
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
            self.order_ = compute_ordering(pat, cfg, user_perm=user_perm)
        self.order_.check()
        if cfg.io_strategy == IOStrategy.SAVE:
            self.order_.save(os.path.join(cfg.io_dir, "ordername"))
        self.report.order_time = time.perf_counter() - t0
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
        no = compute_ordering(node_pat, self.config, user_perm=user_perm)
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
        sub_order = compute_ordering(sub, self.config)
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
        T = cfg.resolve_tile_size(n)
        A_full = self.A.to_scipy().tocoo()
        perm = self.order_.permtab
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
        self._A_perm = Ap
        pat = (abs(Ap) + abs(Ap).T).astype(bool).tocsc()
        pat = (pat + sp.eye(n_ext, dtype=bool, format="csc")).astype(bool).tocsc()
        self._pat_perm_ext = pat

    # ------------------------------------------------------------------
    # phase 3: analysis
    # ------------------------------------------------------------------

    def _free_device_bytes(self) -> Optional[int]:
        if self.device.type != "cuda":
            return None
        return int(torch.cuda.mem_get_info(self.device)[0])

    def analyze(self) -> SolverLayout:
        """Tile layout, dense-tail plan, and every device table: coefinit
        indices, the left-looking K1 plans, the K3 plans of the Schur
        residue, the K2 sweep plan and the ELL matrix of the refinement.
        Schur mode leaves the Schur columns unfactored; the dense tail is
        LLᵗ only and off in Schur mode (the reference's rules)."""
        cfg = self.config
        if self.symbol_ is None:
            self.symbfact()
        t0 = time.perf_counter()
        dev = self.device
        kind = cfg.factorization
        is_lu = kind == Factorization.LU
        use_tail = (cfg.dense_tail and self._schur_first_bcol is None
                    and kind == Factorization.LLT)
        self.layout = build_layout(
            self._pat_perm_ext,
            self._tile_size,
            for_lu=is_lu,
            schur_first_bcol=self._schur_first_bcol,
            densify_tail_frac=cfg.dense_tail_fill if use_tail else 0.0,
        )
        lay = self.layout
        T = lay.T
        pool_bytes = lay.npool * T * T * 4 * (2 if is_lu else 1)
        free = self._free_device_bytes()
        if free is not None and pool_bytes > free:
            raise _not_ported(
                f"{'two tile pools' if is_lu else 'a tile pool'} of "
                f"{pool_bytes / 2**30:.2f} GiB on {dev} with "
                f"{free / 2**30:.2f} GiB free (out-of-core)", "slice 4",
            )
        self._dense_tail = None
        if use_tail:
            # the dense tail holds the (m, m) block plus about two
            # same-sized temps next to the pool: cap m by the free device
            # memory (the reference assumed a 13 GB budget)
            m_cap = 1 << 15
            if free is not None:
                room = max(free - pool_bytes, (4 * T) ** 2 * 3 * 4)
                m_cap = min(m_cap, int(np.sqrt(room / (3 * 4))))
            self._dense_tail = plan_dense_tail(lay, max_m=m_cap)
        upd = _UPDATE_DTYPES[cfg.update_dtype]
        self._coef_fn = build_coefinit_fn(lay, self._A_perm, dev, for_lu=is_lu)
        self._fact_fn = build_factorize_fn(
            lay, dev, kind, update_dtype=upd, dense_tail=self._dense_tail
        )
        self._dinv_fn = build_diag_inverse_fn(lay, dev, kind)
        self._fwd_fn, self._bwd_fn = build_fwd_bwd_fns(lay, dev, kind)
        self._solve_fn = build_solve_fn_sweep(lay, dev, kind,
                                              self._fwd_fn.plan)
        self._refine_fn = build_device_refine_fn(lay, self._solve_fn)
        cols, vals = build_ell(
            sp.coo_matrix(self._A_perm), lay.nbc * T, np.float64
        )
        self._ell = (torch.as_tensor(cols.astype(np.int64), device=dev),
                     torch.as_tensor(vals, device=dev))
        self.report.analyze_time = time.perf_counter() - t0
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
        self.report.memory_bytes = lay.memory_bytes(dtype_bytes=4, lu=is_lu)
        self.report.memory_terms = self.report.memory_bytes // 4
        if cfg.verbosity >= Verbosity.YES:
            print(
                f"[pastix-tpu-torch] analyze: T={T} tiles={lay.npool} "
                f"levels={self.report.n_levels} "
                f"padded flops={self.report.fact_flops_padded:.3e} "
                f"(waste {100 * self.report.padding_waste:.0f}%)"
            )
        return lay

    # ------------------------------------------------------------------
    # phase 4: numeric factorization
    # ------------------------------------------------------------------

    def factorize(self) -> Factors:
        """Coefinit, the factorization of the configured kind and the
        inverse diagonal tiles, on the device; returns when the device has
        finished.  LDLᵗ and LU clamp pivots below
        ``static_pivoting_threshold · max|A|`` and report their number in
        ``report.static_pivots``."""
        cfg = self.config
        if self.layout is None:
            self.analyze()
        t0 = time.perf_counter()
        f = self.factors = numeric_factorize(
            self.layout, self._A_perm, self._coef_fn, self._fact_fn,
            self.device, pivot_threshold=cfg.static_pivoting_threshold,
        )
        if f.kind == Factorization.LU:
            f.dinv, f.dinv_u = self._dinv_fn(f.pool)
        else:
            f.dinv = self._dinv_fn(f.pool)
        synchronize(self.device)
        self.report.fact_time = time.perf_counter() - t0
        self.report.static_pivots = self.factors.n_static_pivots
        self.report.fact_gflops = self.report.fact_flops / max(
            self.report.fact_time, 1e-12
        ) / 1e9
        if cfg.verbosity >= Verbosity.NO:
            print(
                f"[pastix-tpu-torch] numfact: {self.report.fact_time:.3f}s "
                f"({self.report.fact_gflops:.2f} GFLOP/s useful)"
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

    def solve(self, b: np.ndarray, refine: Optional[bool] = None) -> np.ndarray:
        """Solve A x = b (original ordering).  With refinement (the
        default) the device Richardson loop runs to ``refinement_eps``;
        the reported residual is the host fp64 ``||b - Ax|| / ||b||``."""
        cfg = self.config
        if np.iscomplexobj(np.asarray(b)):
            raise _not_ported("complex right-hand sides", "slice 3")
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
        lay, f = self.layout, self.factors
        nflat = lay.nbc * lay.T
        bb = torch.as_tensor(
            rhs_to_blocks(lay, b_ext, dtype=np.float64), device=self.device
        ).reshape(nflat, -1)
        if do_refine:
            x, iters = self._refine_fn(
                f.solve_args(), *self._ell, bb, float(cfg.refinement_eps),
                min(cfg.refinement_itermax, 60),
            )
        else:
            x, iters = self._solve_fn(
                *f.solve_args(), bb.view(lay.nbc, lay.T, -1)
            ), 0
        xb = x.reshape(lay.nbc, lay.T, -1).to(torch.float64).cpu().numpy()
        x_ext = blocks_to_rhs(lay, xb)
        if np.asarray(b_ext).ndim == 1:
            x_ext = x_ext[:, 0]
        r = b_ext - self._A_perm @ x_ext
        self.report.residual = float(
            np.linalg.norm(r) / max(np.linalg.norm(b_ext), 1e-300)
        )
        self.report.refine_iters = iters
        self.report.solve_time = time.perf_counter() - t0
        self.report.refine_time = 0.0  # the device loop is in solve_time
        if cfg.verbosity >= Verbosity.NO:
            print(
                f"[pastix-tpu-torch] solve: {self.report.solve_time:.3f}s  "
                f"refine: {iters} device iters -> residual "
                f"{self.report.residual:.3e}"
            )
        return self._unperm_sol(x_ext)

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
        idx_t = torch.as_tensor(idx, device=self.device)
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
        f = self.factors

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


def spsolve(A, b, config: Optional[PastixConfig] = None, device=None,
            **kw) -> np.ndarray:
    """One-call solve — the reference's single pastix() invocation."""
    if config is None:
        config = PastixConfig(**kw)
    return Pastix(A, config, device=device).solve(b)
