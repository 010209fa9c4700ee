"""Proportional subtree mapping (counterpart of
``pastix_tpu/parallel/subtree.py``; the blend distribPart/cand analog).

The reference assigns elimination-tree subtrees to processor sets by
proportional mapping of subtree costs (``src/blend/src/distribPart.c``,
``cand.c`` — SURVEY.md §2 row 7): independent subtrees factor with no
communication; only the shared top of the tree is cooperative.  Here the
same structure maps onto the ranks of the tp axis:

  * the tile-column elimination tree is costed and subtrees are
    proportionally assigned to ranks (:func:`proportional_mapping`);
  * the local phase runs each rank's own subtree columns with no
    collective: the diagonal tiles and panels through the one-device
    bodies (``numeric.factorize.diag_trsm``: K4 for LDLᵗ), the updates
    through kernel K3 on the rank's pool extended by a boundary buffer,
    where updates aimed at shared (ancestor) columns land;
  * one all_reduce merges the boundary contributions, then the shared
    phase factors the top columns with the replicated path's level body
    (``sharded``: the pairs dealt over the ranks, one all_reduce a
    level);
  * a masked all_reduce reconciles the replicated pool (each tile has
    exactly one writer), and for LDLᵗ the pivots and their count.

The host functions (:func:`proportional_mapping`, :func:`subtree_report`,
``_local_tables``, ``_shared_split``) are copies of the reference's
(``tests/test_torch_mesh_host.py``).  The updates are fp32, as the
reference's subtree programs take no update dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from pastix_tpu_torch.analyze.layout import SolverLayout
from pastix_tpu_torch.config import Factorization
from pastix_tpu_torch.numeric.factorize import (
    _PIPE_CHUNK, _PIPE_GROUP, diag_trsm, plain_diag_trsm,
)
from pastix_tpu_torch.numeric.kernels import gemm_scatter
from pastix_tpu_torch.numeric.pipelined import (
    build_pipeline_schedule, gemm_scatter_pipelined, pipeline_plan,
)
from pastix_tpu_torch.parallel.owner import _plain_eps, fan_in, run_pairs
from pastix_tpu_torch.parallel.sharded import (
    _ShardLevel, _shard_tables, level_view,
)


def _column_tree_and_costs(layout: SolverLayout):
    """Tile-column etree (parent = first off-diag tile's column) + flop cost
    per block column."""
    nbc, T = layout.nbc, layout.T
    parent = np.full(nbc, -1, dtype=np.int64)
    cost = np.full(nbc, float(T) ** 3 / 3.0)  # potrf
    # per-column tile lists from the sorted (col,row) keys
    col_ptr = np.searchsorted(layout.blk_col, np.arange(nbc + 1))
    for j in range(nbc):
        lo, hi = col_ptr[j], col_ptr[j + 1]
        rows = layout.blk_row[lo + 1 : hi]
        m = rows.size
        if m:
            parent[j] = rows[0]
            cost[j] += m * float(T) ** 3  # trsm
            cost[j] += (m * (m + 1) / 2) * 2.0 * float(T) ** 3  # gemm
    return parent, cost


def proportional_mapping(layout: SolverLayout, ndev: int):
    """Assign block columns to devices; returns (owner[nbc], shared mask).

    owner[j] = device for subtree-local columns, -1 for shared columns
    (columns whose candidate device set has more than one device).
    """
    nbc = layout.nbc
    parent, cost = _column_tree_and_costs(layout)
    subtree = cost.copy()
    # accumulate subtree costs bottom-up (columns are topologically ordered:
    # parent > child by construction of the ND ordering)
    for j in range(nbc):
        if parent[j] != -1:
            subtree[parent[j]] += subtree[j]
    children: list[list[int]] = [[] for _ in range(nbc)]
    roots = []
    for j in range(nbc):
        if parent[j] == -1:
            roots.append(j)
        else:
            children[parent[j]].append(j)

    owner = np.full(nbc, -1, dtype=np.int64)

    def assign(nodes, devs):
        """Proportionally split device list among the subtrees in nodes."""
        stack = [(nodes, devs)]
        while stack:
            nodes, devs = stack.pop()
            if len(devs) == 1:
                d = devs[0]
                # entire subtrees become local to d
                st = list(nodes)
                while st:
                    u = st.pop()
                    owner[u] = d
                    st.extend(children[u])
                continue
            # multi-device: the nodes themselves stay shared; split their
            # children proportionally
            kids = []
            for u in nodes:
                owner[u] = -1
                kids.extend(children[u])
            if not kids:
                continue
            kids.sort(key=lambda u: -subtree[u])
            total = sum(subtree[u] for u in kids) or 1.0
            # greedy proportional split of devices over child subtrees
            share = [0.0] * len(devs)
            buckets: list[list[int]] = [[] for _ in devs]
            for u in kids:
                i = int(np.argmin(share))
                buckets[i].append(u)
                share[i] += subtree[u]
            for i, b in enumerate(buckets):
                if b:
                    stack.append((b, [devs[i]]))
            # note: each bucket gets exactly one device here (top-level
            # separators above the cut were already marked shared); deeper
            # multi-device splits happen when ndev > number of top subtrees
        return

    # walk down from the roots until the frontier subtrees are both
    # numerous enough AND fine-grained enough for balanced greedy
    # binning: any subtree above total/(2*ndev) keeps splitting (its own
    # columns become shared).  Stopping at len(frontier) >= ndev alone
    # measured 250-1300% local imbalance on the 50k dryrun — the top two
    # separes' subtrees dominate everything.
    frontier = list(roots)
    total = sum(subtree[u] for u in frontier) or 1.0
    grain = total / (2.0 * ndev)
    while frontier:
        split = [
            u for u in frontier if children[u] and subtree[u] > grain
        ]
        if len(frontier) >= ndev and not split:
            break
        if not split:
            break
        split_set = set(split)
        nxt = []
        for u in frontier:
            if u in split_set:
                owner[u] = -1
                nxt.extend(children[u])
            else:
                nxt.append(u)
        frontier = nxt
    assign(frontier, list(range(ndev)))
    return owner


def subtree_report(layout: SolverLayout, ndev: int) -> dict:
    """Static balance/comm accounting for the proportional subtree plan
    (the distribPart strategy's analog of owner.distribution_report —
    VERDICT r4 item: scaling evidence for >=2 dist strategies).

    Per-device local-phase flops (each device's own subtrees), the
    cooperative shared-top flop fraction, and the boundary psum volume
    (tiles in shared columns that local updates contribute into — the
    single fan-in exchange's per-device bytes)."""
    parent, cost = _column_tree_and_costs(layout)
    owner = proportional_mapping(layout, ndev)
    local = np.zeros(ndev, np.float64)
    for d in range(ndev):
        local[d] = cost[owner == d].sum()
    shared_cost = float(cost[owner == -1].sum())
    shared_cols = np.flatnonzero(owner == -1)
    is_shared = np.isin(layout.blk_col, shared_cols)
    # boundary = shared-column tiles targeted by local-phase updates
    bt = []
    for lv in layout.levels:
        if lv.gemm_d.size and (owner[np.asarray(lv.cols)] >= 0).any():
            g = np.asarray(lv.gemm_d)
            bt.append(np.unique(g[is_shared[g]]))
    nb = np.unique(np.concatenate(bt)).size if bt else 0
    tot = local.sum() + shared_cost
    return {
        "ndev": ndev,
        "local_flops": local,
        "shared_flops": shared_cost,
        "shared_frac": shared_cost / max(tot, 1.0),
        "local_imbalance": float(
            local.max() / max(local.mean(), 1.0) - 1.0
        ),
        "boundary_tiles": nb,
        "boundary_bytes": nb * layout.T * layout.T * 4,
    }


def _local_tables(layout: SolverLayout, owner: np.ndarray, ndev: int):
    """Per-level stacked (device-major) tables for the local phase, plus the
    boundary-tile fan-in plan and the pool ownership mask."""
    nbc, npool = layout.nbc, layout.npool
    shared_cols = np.flatnonzero(owner == -1)
    is_shared_col = owner == -1

    # boundary tiles: tiles in shared columns hit by local-phase updates
    btiles = []
    per_level = []
    for lv in layout.levels:
        loc_mask = ~is_shared_col[lv.cols]
        if not loc_mask.any():
            per_level.append(None)
            continue
        g_shared = (
            is_shared_col[layout.blk_col[lv.gemm_d]]
            if lv.gemm_d.size
            else np.empty(0, bool)
        )
        btiles.append(np.unique(lv.gemm_d[g_shared]))
        per_level.append((loc_mask, g_shared))
    boundary = (
        np.unique(np.concatenate(btiles)) if btiles else np.empty(0, np.int64)
    )
    bpos = {int(t): i for i, t in enumerate(boundary)}
    nb = boundary.size

    # per device, per level: local tables
    def pad_stack(rows, fill):
        m = max((r.size for r in rows), default=0)
        m = max(m, 1)
        out = np.full((ndev, m), fill, dtype=np.int32)
        for d, r in enumerate(rows):
            out[d, : r.size] = r
        return out

    oob = npool + nb + 1  # beyond pool+acc+junk: gathers clamp, scatters drop
    levels_out = []
    for lv, pl in zip(layout.levels, per_level):
        if pl is None:
            continue
        loc_mask, g_shared = pl
        dcols, ddiag, dtp, dtd = [], [], [], []
        dga, dgb, dgd, dbp = [], [], [], []
        col_owner_lv = owner[lv.cols]
        tp_owner = owner[lv.trsm_col] if lv.trsm_col.size else np.empty(0)
        g_owner = (
            owner[layout.blk_col[lv.gemm_b]] if lv.gemm_b.size else np.empty(0)
        )
        # gemm triple belongs to the device owning its source column (J);
        # source col of a triple is gemm_k
        g_src_owner = owner[lv.gemm_k] if lv.gemm_k.size else np.empty(0)
        dtc, dgk = [], []
        for d in range(ndev):
            cm = col_owner_lv == d
            dcols.append(lv.cols[cm])
            ddiag.append(lv.diag[cm])
            tm = tp_owner == d if tp_owner.size else np.empty(0, bool)
            dtp.append(lv.trsm_panel[tm])
            dtd.append(lv.trsm_diag[tm])
            dtc.append(lv.trsm_col[tm])
            gm = g_src_owner == d if lv.gemm_k.size else np.empty(0, bool)
            gml = gm & ~g_shared
            gms = gm & g_shared
            dga.append(np.concatenate([lv.gemm_a[gml], lv.gemm_a[gms]]))
            dgb.append(np.concatenate([lv.gemm_b[gml], lv.gemm_b[gms]]))
            dgk.append(np.concatenate([lv.gemm_k[gml], lv.gemm_k[gms]]))
            # local targets scatter into the pool; shared ones into the
            # boundary acc (encoded as npool + position)
            dgd.append(
                np.concatenate(
                    [
                        lv.gemm_d[gml],
                        np.array(
                            [npool + bpos[int(t)] for t in lv.gemm_d[gms]],
                            dtype=np.int64,
                        ),
                    ]
                )
            )
        levels_out.append(
            {
                "diag": pad_stack(ddiag, oob),
                "cols": pad_stack(dcols, nbc),
                "tp": pad_stack(dtp, oob),
                "td": pad_stack(dtd, oob),
                "tc": pad_stack(dtc, nbc),
                "ga": pad_stack(dga, 0),
                "gb": pad_stack(dgb, 0),
                "gk": pad_stack(dgk, nbc),
                # junk contributions land in the sacrificial acc slot
                "gd": pad_stack(dgd, npool + nb),
            }
        )

    # ownership mask for the final pool reconciliation: the writer of each
    # tile is the owner of its column; shared columns go to device 0 (their
    # tiles are identical everywhere after the shared phase)
    tile_owner = owner[layout.blk_col]
    mask = np.zeros((ndev, npool), dtype=np.float32)
    for d in range(ndev):
        mask[d] = (tile_owner == d) | ((tile_owner == -1) & (d == 0))
    return levels_out, boundary, mask


def _shared_split(layout: SolverLayout, owner: np.ndarray, ndev: int):
    """Shared-column sublayout + flat shard tables for the top phase."""

    is_shared_col = owner == -1
    import dataclasses as _dc

    shared_levels = []
    for lv in layout.levels:
        cm = is_shared_col[lv.cols]
        if not cm.any():
            continue
        tm = (
            is_shared_col[lv.trsm_col] if lv.trsm_col.size
            else np.empty(0, bool)
        )
        gm = is_shared_col[lv.gemm_k] if lv.gemm_k.size else np.empty(0, bool)
        shared_levels.append(
            _dc.replace(
                lv,
                cols=lv.cols[cm], diag=lv.diag[cm],
                trsm_panel=lv.trsm_panel[tm], trsm_diag=lv.trsm_diag[tm],
                trsm_row=lv.trsm_row[tm], trsm_col=lv.trsm_col[tm],
                gemm_a=lv.gemm_a[gm], gemm_b=lv.gemm_b[gm],
                gemm_d=lv.gemm_d[gm], gemm_k=lv.gemm_k[gm],
                gemm_nondiag=lv.gemm_nondiag[gm],
            )
        )
    shared_layout = _dc.replace(layout, levels=shared_levels)
    return shared_levels, _shard_tables(shared_layout, ndev)




def _rank_local(t: dict, me: int, npool: int, nb: int, nbc: int, device,
                fp32: bool, scaled: bool):
    """Row ``me`` of one local-phase level of ``_local_tables``, pads
    dropped: the diagonal/TRSM view and the rank's pairs into its
    extended pool (a K3 plan on fp32, else index tensors)."""
    oob = npool + nb + 1
    nd = int((t["diag"][me] != oob).sum())
    ntp = int((t["tp"][me] != oob).sum())
    lv = level_view(t["cols"][me][:nd], t["diag"][me][:nd],
                    t["tp"][me][:ntp], t["tc"][me][:ntp], device)
    keep = t["gd"][me] != npool + nb
    ga, gb, gd = t["ga"][me][keep], t["gb"][me][keep], t["gd"][me][keep]
    gk = t["gk"][me][keep] if scaled else None
    if fp32:
        pairs = (pipeline_plan(build_pipeline_schedule(
            ga, gb, gd, gk=gk, group=_PIPE_GROUP, chunk=_PIPE_CHUNK),
            device) if ga.size else [])
    else:
        tens = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                         device=device)
        pairs = (tens(ga), tens(gb), tens(gd),
                 None if gk is None else tens(gk))
    return lv, pairs


def _local_update(buf, pairs, d=None):
    """buf[gd] -= (buf[ga] diag(d[gk])) @ buf[gb]ᵗ over the rank's local
    pairs (fp32 products): K3 on the extended pool, else torch ops."""
    if isinstance(pairs, list):
        if pairs:
            gemm_scatter_pipelined(buf, pairs, None, d=d)
    elif pairs[0].numel():
        ga, gb, gd, gk = pairs
        gemm_scatter(buf, ga, gb, gd, None,
                     None if d is None else d[gk])


def build_subtree_factorize(layout: SolverLayout, axis, device, kind,
                            dtype=torch.float32):
    """LLᵗ (``fn(pool) -> pool``) or LDLᵗ (``fn(pool, eps) -> (pool, d,
    npiv)``) with proportional subtree mapping on a replicated pool (the
    reference's ``build_subtree_factorize_llt``/``_ldlt``): the local
    phase (no collective), one boundary all_reduce, the shared top phase,
    then the masked merge of the pool (and of ``d`` and the pivot count),
    identical on every rank of the tp ``axis`` at the end."""
    kind = Factorization(kind)
    scaled = kind == Factorization.LDLT
    fp32 = dtype == torch.float32
    ndev, me = axis.size, axis.me
    owner = proportional_mapping(layout, ndev)
    loc_levels, boundary, mask = _local_tables(layout, owner, ndev)
    T, npool, nb, nbc = layout.T, layout.npool, boundary.size, layout.nbc
    shared_levels, shared_tabs = _shared_split(layout, owner, ndev)
    local = [_rank_local(t, me, npool, nb, nbc, device, fp32, scaled)
             for t in loc_levels]
    shared = [_ShardLevel(lv, t, me, ndev, nbc, device, fp32, scaled)
              for lv, t in zip(shared_levels, shared_tabs)]
    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    bnd = tens(boundary)
    # d merge mask: local columns belong to their owner; shared columns
    # are computed identically everywhere -> attributed to rank 0
    dmask = ((owner == me) | ((owner == -1) & (me == 0))).astype(np.float32)

    def diag(lv, pool, d=None, npiv=None, eps=0.0):
        if lv.diag.numel():
            (diag_trsm if fp32 else plain_diag_trsm)(
                kind, lv, pool, d=d, npiv=npiv, eps=eps)

    def fact_local(pool, eps=0.0):
        eps = eps if fp32 else _plain_eps(eps, dtype)
        d = (torch.ones((nbc, T), dtype=pool.dtype, device=pool.device)
             if scaled else None)
        npiv = torch.zeros((), dtype=torch.int32, device=pool.device)
        # pool extended with the boundary accumulator (+1 junk slot)
        buf = torch.cat([pool, pool.new_zeros((nb + 1, T, T))])
        # ---- local phase: zero collectives ----
        for lv, pairs in local:
            diag(lv, buf, d, npiv, eps)
            _local_update(buf, pairs, d)
        # ---- single boundary fan-in ----
        pool = buf[:npool]
        if nb:
            # the boundary holds minus the contributions; the pool rows at
            # the boundary tiles still hold A's values on every rank
            pool.index_add_(0, bnd, axis.all_reduce(
                buf[npool:npool + nb].clone()))
        # ---- shared top phase (the replicated path's level body) ----
        npiv_s = torch.zeros_like(npiv)
        for r in shared:
            diag(r.lv, pool, d, npiv_s, eps)
            if r.ntouch:
                acc = pool.new_zeros((r.ntouch + 1, T, T))
                run_pairs(acc, r.pairs, pool, pool, None, d=d)
                fan_in(axis, acc, pool, r.tpos, r.touched)
        # shared pivots are computed identically on every rank: counted
        # on rank 0 only (the d merge does the same)
        if me == 0:
            npiv += npiv_s
        # ---- reconcile the replicated pool (one writer per tile) ----
        pool = pool.contiguous()
        pool.mul_(torch.as_tensor(mask[me], device=pool.device)[:, None,
                                                                 None])
        axis.all_reduce(pool)
        if not scaled:
            return pool
        d.mul_(torch.as_tensor(dmask, device=d.device)[:, None])
        axis.all_reduce(d)
        axis.all_reduce(npiv)
        return pool, d, npiv

    if scaled:
        fn = fact_local
    else:
        fn = lambda pool: fact_local(pool)
    fn.kind = kind
    fn.levels = shared
    fn.local = local
    fn.e2_saved_flops = 0.0
    return fn
