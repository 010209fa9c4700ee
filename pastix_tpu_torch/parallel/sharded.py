"""The replicated-pool mesh path (counterpart of
``pastix_tpu/parallel/sharded.py``): every rank holds the whole pool.

Each level's trailing-update pairs are dealt over the tp axis; a rank
runs its share into a compact buffer of the level's touched tiles
(kernel K3 with the pool as its operand arrays on an fp32 pool, the torch
ops of ``numeric/kernels`` on the others) and one all_reduce a level sums
the buffers, the exact algebraic equivalent of the reference's fan-in
(``src/sopalin/src/sopalin3d.c`` Isend/Irecv of FanInTarget buffers).
The diagonal tiles and the panel TRSM run replicated, through the
one-device bodies (``numeric.factorize.diag_trsm``: K4 for LDLᵗ and LU on
fp32; ``plain_diag_trsm`` on the others).  The dense terminal block is
factored 2D by row slabs (``owner.tail_steps``).

It serves ``shard_pool=False``, Schur unknowns and complex pools, as the
reference's routing does (``pastix_tpu/pastix.py:663-790``).  The solve
is the one-device solve of the pool's dtype on every rank (K2 sweeps on
an fp32 pool with ``fast_solve``) over its dp share of the columns
(:func:`build_sharded_solve`); :func:`build_sharded_refine` refines on
the devices with the residual's SpMV split over the tp axis.

``_shard_tables``, ``_shard_tables_with_nd`` and :func:`shard_coo` are
copies of the reference's host code (``tests/test_torch_mesh_host.py``).
The reference's ``_stack_shard_tables``/``_shard_plan`` (its scanned
levels) have no counterpart: every level is unrolled.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from pastix_tpu_torch.analyze.layout import SolverLayout
from pastix_tpu_torch.config import Factorization
from pastix_tpu_torch.numeric.factorize import diag_trsm, plain_diag_trsm
from pastix_tpu_torch.parallel.owner import (
    _owner_gk, _plain_eps, _wrap_dp_pad, fan_in, rank_pairs, run_pairs,
    tail_steps,
)


def _shard_tables(layout: SolverLayout, ndev: int, levels=None):
    """Per-level: device-partitioned gemm triples + touched-tile lists."""
    tabs = []
    for lv in layout.levels if levels is None else levels:
        ng = lv.gemm_a.size
        touched, pos = (
            np.unique(lv.gemm_d, return_inverse=True)
            if ng
            else (np.empty(0, np.int64), np.empty(0, np.int64))
        )
        per = -(-max(ng, 1) // ndev)
        pad = per * ndev - ng
        # padded triples write to a sacrificial slot (len(touched))
        ga = np.concatenate([lv.gemm_a, np.zeros(pad, np.int32)])
        gb = np.concatenate([lv.gemm_b, np.zeros(pad, np.int32)])
        gp = np.concatenate(
            [pos.astype(np.int32), np.full(pad, len(touched), np.int32)]
        )
        tabs.append(
            {
                "diag": np.asarray(lv.diag),
                "tp": np.asarray(lv.trsm_panel),
                "td": np.asarray(lv.trsm_diag),
                # panel's column position within the level's diag batch
                # (for the TRSM-as-matmul against the fused tile inverses)
                "tcpos": np.searchsorted(lv.cols, lv.trsm_col).astype(
                    np.int32
                ),
                "ga": np.asarray(ga.reshape(ndev, per)),
                "gb": np.asarray(gb.reshape(ndev, per)),
                "gp": np.asarray(gp.reshape(ndev, per)),
                "touched": np.asarray(touched.astype(np.int32)),
                "ntouch": int(len(touched)),
            }
        )
    return tabs


def _shard_tables_with_nd(layout: SolverLayout, ndev: int, levels=None):
    """Shard tables plus the off-diagonal-target partition (LU U-side)."""
    levels = layout.levels if levels is None else levels
    tabs = _shard_tables(layout, ndev, levels)
    out = []
    for lv, t in zip(levels, tabs):
        ng = lv.gemm_a.size
        nd_mask = lv.gemm_nondiag
        tn, posn = (
            np.unique(lv.gemm_d[nd_mask], return_inverse=True)
            if nd_mask.any()
            else (np.empty(0, np.int64), np.empty(0, np.int64))
        )
        # same (ndev, per) partition as the main triples; diagonal-target
        # slots route to the sacrificial accumulator row
        per = t["ga"].shape[1]
        pad = per * ndev - ng
        gpn = np.full(ng, len(tn), np.int64)
        if nd_mask.any():
            gpn[nd_mask] = posn
        gpn = np.concatenate([gpn, np.full(pad, len(tn), np.int64)])
        t = dict(t)
        t["gp_u"] = np.asarray(gpn.reshape(ndev, per).astype(np.int32))
        t["touched_u"] = np.asarray(tn.astype(np.int32))
        t["ntouch_u"] = int(len(tn))
        out.append(t)
    return out


def level_view(cols, diag, tp, tc, device) -> types.SimpleNamespace:
    """The tables ``numeric.factorize.diag_trsm`` reads for one level (or
    a rank's part of one): ``tcpos`` is each panel's column position
    among ``cols``."""
    pos = {int(c): k for k, c in enumerate(np.asarray(cols))}
    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return types.SimpleNamespace(
        cols=tens(cols), diag=tens(diag), tp=tens(tp), tc=tens(tc),
        tcpos=tens([pos[int(c)] for c in np.asarray(tc)]))


class _ShardLevel:
    """One level of the replicated path for the rank ``me``."""

    def __init__(self, lv, t, me, ndev, nbc, device, fp32, scaled):
        self.lv = level_view(lv.cols, lv.diag, lv.trsm_panel, lv.trsm_col,
                             device)
        self.ntouch = t["ntouch"]
        tens = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                         device=device)
        self.touched = tens(t["touched"])
        self.tpos = torch.arange(self.ntouch, device=device)
        gk = _owner_gk(lv, ndev, nbc)[me] if scaled else None
        self.pairs = rank_pairs(t["ga"][me], t["gb"][me], t["gp"][me],
                                t["ntouch"], gk, device, fp32)
        self.ntouch_u = t.get("ntouch_u", 0)
        if self.ntouch_u:
            self.touched_u = tens(t["touched_u"])
            self.tpos_u = torch.arange(self.ntouch_u, device=device)
            self.pairs_u = rank_pairs(t["ga"][me], t["gb"][me],
                                      t["gp_u"][me], self.ntouch_u, None,
                                      device, fp32)


def _sharded_tail(layout, dense_tail, axis, device, update_dtype,
                  hermitian):
    """2D-sharded dense-tail Cholesky on a replicated pool (the
    reference's ``_tail_factor_sharded``): uniform row slabs of
    ceil(q / ranks) tile rows, the steps of ``owner.tail_steps``, then one
    all_gather of the slabs back into every rank's pool."""
    T, tq, ndev, me = layout.T, dense_tail.q, axis.size, axis.me
    L = -(-tq // ndev)  # row tiles per device
    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    t_p = np.asarray(dense_tail.p_idx)
    t_qi = np.asarray(dense_tail.qi)
    t_qj = np.asarray(dense_tail.qj)
    sel = (t_qi >= me * L) & (t_qi < (me + 1) * L)
    p_me, qi_me, qj_me = tens(t_p[sel]), tens(t_qi[sel] - me * L), tens(
        t_qj[sel])
    all_p, all_qi, all_qj = tens(t_p), tens(t_qi), tens(t_qj)
    row_map = torch.arange(tq, device=device)

    def tail_factor(pool):
        slab = torch.zeros((L, T, tq, T), dtype=pool.dtype,
                           device=pool.device)
        slab[qi_me, :, qj_me, :] = pool[p_me]
        tail_steps(slab.view(L * T, -1), me * L, (me + 1) * L, L, tq, T,
                   row_map, axis, update_dtype, hermitian)
        full = axis.all_gather(slab).view(-1, T, tq, T)[:tq]
        pool[all_p] = full[all_qi, :, all_qj, :]

    return tail_factor


def build_sharded_factorize(layout: SolverLayout, axis, device, kind,
                            dense_tail=None, update_dtype=None,
                            dtype=torch.float32, hermitian=True):
    """The replicated-pool program of ``kind`` with the signatures of
    ``numeric.factorize.build_factorize_fn`` (LLᵗ ``fn(pool)``, LDLᵗ and
    LDLᴴ ``fn(pool, eps) -> (pool, d, npiv)``, LU ``fn(pool, pool_u, eps)
    -> (pool, pool_u, npiv)``), the pools replicated on every rank of the
    tp ``axis`` and identical on each at the end (the reference's
    ``build_sharded_factorize_{llt,ldlt,lu}``).  Per level: the diagonal
    tiles and panels, replicated, then the rank's dealt pairs into the
    touched buffer and one all_reduce (LU: two, the U side without the
    diagonal targets).  ``dense_tail``: LLᵗ's 2D-sharded tail."""
    kind = Factorization(kind)
    is_lu = kind == Factorization.LU
    scaled = kind in (Factorization.LDLT, Factorization.LDLH)
    fp32 = dtype == torch.float32
    herm = hermitian and dtype.is_complex
    T, nbc, me = layout.T, layout.nbc, axis.me
    levels = dense_tail.levels_lo if dense_tail is not None else layout.levels
    tabs = (_shard_tables_with_nd(layout, axis.size, levels) if is_lu
            else _shard_tables(layout, axis.size, levels))
    plan = [_ShardLevel(lv, t, me, axis.size, nbc, device, fp32, scaled)
            for lv, t in zip(levels, tabs)]
    tail = (_sharded_tail(layout, dense_tail, axis, device, update_dtype,
                          herm) if dense_tail is not None else None)

    def diag(r, pool, pool_u=None, d=None, npiv=None, eps=0.0):
        if fp32:
            diag_trsm(kind, r.lv, pool, pool_u, d, npiv, eps)
        else:
            plain_diag_trsm(kind, r.lv, pool, pool_u, d, npiv, eps,
                            hermitian=herm)

    def buf(pool, n):
        return torch.zeros((n + 1, T, T), dtype=pool.dtype,
                           device=pool.device)

    def fact_llt(pool):
        for r in plan:
            diag(r, pool)
            if r.ntouch:
                acc = buf(pool, r.ntouch)
                run_pairs(acc, r.pairs, pool, pool, update_dtype,
                          hermitian=herm)
                fan_in(axis, acc, pool, r.tpos, r.touched)
        if tail is not None:
            tail(pool)
        return pool

    def fact_ldlt(pool, eps):
        eps = eps if fp32 else _plain_eps(eps, dtype)
        d = torch.ones((nbc, T), dtype=pool.dtype, device=pool.device)
        npiv = torch.zeros((), dtype=torch.int32, device=pool.device)
        for r in plan:
            diag(r, pool, d=d, npiv=npiv, eps=eps)
            if r.ntouch:
                acc = buf(pool, r.ntouch)
                run_pairs(acc, r.pairs, pool, pool, update_dtype, d=d,
                          hermitian=herm)
                fan_in(axis, acc, pool, r.tpos, r.touched)
        return pool, d, npiv

    def fact_lu(pool, pool_u, eps):
        eps = eps if fp32 else _plain_eps(eps, dtype)
        npiv = torch.zeros((), dtype=torch.int32, device=pool.device)
        for r in plan:
            diag(r, pool, pool_u, npiv=npiv, eps=eps)
            if r.ntouch:
                # L side: A(I,K) -= L(I,J) @ U(J,K) = Lp[ga] @ Ut[gb]^T
                acc = buf(pool, r.ntouch)
                run_pairs(acc, r.pairs, pool, pool_u, update_dtype)
                fan_in(axis, acc, pool, r.tpos, r.touched)
                if r.ntouch_u:
                    accu = buf(pool, r.ntouch_u)
                    run_pairs(accu, r.pairs_u, pool_u, pool, update_dtype)
                    fan_in(axis, accu, pool_u, r.tpos_u, r.touched_u)
        return pool, pool_u, npiv

    fn = fact_lu if is_lu else fact_ldlt if scaled else fact_llt
    fn.kind = Factorization.LDLT if kind == Factorization.LDLH and not (
        dtype.is_complex) else kind
    fn.levels = plan
    fn.hermitian = herm
    fn.e2_saved_flops = 0.0
    return fn


def build_sharded_solve(layout: SolverLayout, dp, inner):
    """The replicated solve: ``inner`` (the one-device solve of the pool's
    dtype, ``fn(*factors, b)``) on every rank over its share of the RHS
    columns on the ``dp`` axis (None: every rank solves them all), the
    column count padded to a dp multiple per call; X comes back whole on
    every rank."""
    return _wrap_dp_pad(inner, dp, layout.nbc, layout.T)


def shard_coo(A_coo, ndev: int, dtype=np.float32):
    """Pad a scipy COO matrix's arrays to a tp multiple for P(tp) sharding.

    Pad entries carry value 0 at (row 0, col 0) — a scatter-add of zero."""
    nnz = A_coo.nnz
    pad = (-nnz) % ndev
    arow = np.concatenate([A_coo.row.astype(np.int32), np.zeros(pad, np.int32)])
    acol = np.concatenate([A_coo.col.astype(np.int32), np.zeros(pad, np.int32)])
    avals = np.concatenate([A_coo.data.astype(dtype), np.zeros(pad, dtype)])
    return arow, acol, avals


def build_sharded_refine(layout: SolverLayout, axis, inner):
    """Device solve + Richardson refinement with the residual's SpMV split
    over the tp ``axis`` (the reference's ``build_sharded_refine``: the
    distributed CscbMAx of its raff loop, SURVEY.md §3.5): each rank
    multiplies its share of A's COO entries (:func:`shard_coo`, the
    rank's contiguous ``P(tp)`` block) and one all_reduce sums the
    partial products; ``inner`` (the one-device solve) runs on every rank.

    ``fn(factor_args, arow, acol, avals, b, eps, itermax) -> (x, iters,
    rel_res)`` with ``b`` of shape (nbc, T, R) in the pool's dtype; the
    loop stops, as the reference's ``while_loop``, when the residual
    reaches ``eps``, stops falling by 4x a step, or after ``itermax``
    steps (its test reads one host number a step)."""
    nbc, T = layout.nbc, layout.T
    _TINY = 1e-30

    def fn(fa, arow, acol, avals, b, eps, itermax):
        R = b.shape[-1]
        bf = b.reshape(nbc * T, R)

        def spmv(x):
            yf = torch.zeros_like(bf)
            yf.index_add_(0, arow, avals[:, None] * x.reshape(nbc * T, R)[acol])
            return axis.all_reduce(yf).reshape(nbc, T, R)

        res2 = lambda rr: float((rr.reshape(nbc * T, R) ** 2).sum())
        bnorm2 = max(float((bf * bf).sum()), _TINY)
        x = inner(*fa, b)
        r = b - spmv(x)
        prev, it = float("inf"), 0
        while True:
            r2 = res2(r)
            # stop grinding at the fp32 floor
            if not (r2 > eps * eps * bnorm2 and r2 < 0.25 * prev
                    and it < itermax):
                break
            x = x + inner(*fa, r)
            prev, r, it = r2, b - spmv(x), it + 1
        return x, it, (res2(r) / bnorm2) ** 0.5

    return fn
