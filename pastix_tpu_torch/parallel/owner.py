"""Owner-computes factorization over a sharded tile pool (counterpart of
``pastix_tpu/parallel/owner.py``).

Each rank holds only its tiles: the global pool (npool, T, T) becomes a
(nloc, T, T) pool a rank, nloc ~ npool / ranks, as the reference's blend
emits a local SolverMatrix a rank (``src/blend/src/solverMatrixGen.c``):

  * block columns are assigned to ranks by best-fit-decreasing on their
    attributed flops (:func:`build_pool_sharding`); the dense terminal
    block is owned by row slabs, the 2D tail factor's layout;
  * per level, owners factor their diagonal tiles and solve their panels;
  * the level's post-TRSM panels are exchanged once into a compact halo
    buffer X (one all_gather of each owner's slab), the E2 pairs are
    dealt round-robin over the ranks, each rank's pairs run through
    kernel K3 from X into a touched-tile buffer, and one all_reduce of
    that buffer brings the contributions to their owners (the fan-in);
  * the dense tail builds each rank's row slab from its own tiles, runs
    the per-tile-column 2D elimination with an all_reduce and an
    all_gather a column, and writes the slab back to its tiles.

The host tables (:class:`PoolSharding`, :func:`build_pool_sharding`,
:func:`distribution_report`, :func:`_pad2`, :func:`_owner_level_tables`,
:func:`_owner_tail_tables`) are copies of the reference's;
``tests/test_torch_mesh_host.py`` holds them equal.  The level bodies are
the reference's ``shard_map`` bodies run once a rank (``me`` the rank's
index on the tp axis, ``lax.psum`` an all_reduce), every level unrolled
(``numeric/grouping.group_plan`` is not ported: the reference's scans
bound XLA program size, which eager PyTorch does not have).  A rank's
tables drop the reference's padding (its gathers clamp and its scatters
drop out-of-range pads; here each rank indexes only its real entries),
but for the halo slab, which every rank gathers at one size: its pad
rows are zeros and land in X[nx], which stays zero.

An fp32 pool runs the one-device fp32 bodies: ``numeric.factorize.
diag_trsm`` (LLᵗ ``cholesky_ex``, LDLᵗ and LU kernel K4) and K3 for the
E2 (bf16 or fp32 updates); an fp64 pool the torch ops of
``numeric/kernels``.  K3 subtracts, so the touched buffer holds minus
the contributions and the owners add it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pastix_tpu_torch.analyze.layout import SolverLayout
from pastix_tpu_torch.config import Factorization
from pastix_tpu_torch.numeric.factorize import diag_trsm, plain_diag_trsm
from pastix_tpu_torch.numeric.kernels import (
    gemm_scatter_ab, potrf_batch, round_to,
)
from pastix_tpu_torch.numeric.pipelined import (
    gemm_scatter_pipelined, operand_plan,
)


@dataclasses.dataclass
class PoolSharding:
    """Tile-ownership map: tile t lives at local slot loc[t] on device
    owner[t].  nloc includes the padding to the max per-device count."""

    ndev: int
    nloc: int
    owner: np.ndarray  # (npool,) int32
    loc: np.ndarray  # (npool,) int32
    owner_col: np.ndarray  # (nbc,) int32 block-column owner
    # dense-tail row-slab boundaries (ndev+1): device d owns tail tile
    # rows [tail_rows[d], tail_rows[d+1]).  Equal-AREA by default (the
    # tail is lower-triangular); None -> uniform ceil(q/ndev) slabs
    tail_rows: "np.ndarray | None" = None

    def to_local(self, pool: np.ndarray) -> np.ndarray:
        """(npool, T, T) host pool -> (ndev, nloc, T, T) sharded layout."""
        out = np.zeros((self.ndev, self.nloc) + pool.shape[1:], pool.dtype)
        out[self.owner, self.loc] = pool
        return out

    def from_local(self, psh: np.ndarray) -> np.ndarray:
        """(ndev, nloc, T, T) -> (npool, T, T)."""
        return np.asarray(psh)[self.owner, self.loc]

    def mine(self, me: int) -> np.ndarray:
        """The pool indices of rank ``me``'s tiles, in slot order."""
        return np.flatnonzero(self.owner == me)


def build_pool_sharding(
    layout: SolverLayout, ndev: int, dense_tail=None
) -> PoolSharding:
    """Assign ownership: per-level greedy tile-count balancing of block
    columns; tail tiles by row slab (see module docstring)."""
    levels = dense_tail.levels_lo if dense_tail is not None else layout.levels
    nbc, npool = layout.nbc, layout.npool
    blk_col = np.asarray(layout.blk_col)
    tiles_per_col = np.bincount(blk_col, minlength=nbc)
    # per-column attributed device flops: potrf + its panels' TRSMs +
    # the E2 pairs LANDING in its tiles (owner-computes applies updates at
    # the dst owner) — balancing on tile counts alone left E2, ~95% of
    # the flops, ~90% imbalanced (distribution_report, round 4)
    col_cost = np.full(nbc, 1.0 / 3.0)
    col_cost += tiles_per_col - 1  # TRSM panels (diag tile excluded)
    # E2 into dense-tail tiles is row-slab-distributed below, not owned by
    # the target column — excluding it from col_cost stops the balancer
    # from over-compensating the tail columns' owners
    in_tail = np.zeros(npool, bool)
    if dense_tail is not None:
        in_tail[np.asarray(dense_tail.p_idx)] = True
    for lv in levels:
        if lv.gemm_d.size:
            gdv = np.asarray(lv.gemm_d)
            gdv = gdv[~in_tail[gdv]]
            if gdv.size:
                col_cost += 2.0 * np.bincount(
                    blk_col[gdv], minlength=nbc
                )
    owner_col = np.zeros(nbc, np.int32)
    # global best-fit-decreasing on attributed cost: heaviest columns
    # (top separators, ~1 GF each) are placed first on the least-loaded
    # device.  A per-level greedy with a fresh load array handed every
    # level's heaviest column to device 0 (~2x flop imbalance,
    # distribution_report round 4); level-major with a carried load still
    # left 26% — decreasing order is the standard bin-packing fix.
    load = np.zeros(ndev, np.float64)
    all_cols = np.concatenate([np.asarray(lv.cols) for lv in levels]) if (
        levels
    ) else np.empty(0, np.int64)
    for c in all_cols[np.argsort(-col_cost[all_cols], kind="stable")]:
        d = int(np.argmin(load))
        owner_col[c] = d
        load[d] += col_cost[c]
    owner = owner_col[blk_col].astype(np.int32)
    if dense_tail is not None:
        # tail tiles by row slab — with EQUAL-AREA boundaries: the tail is
        # lower-triangular, so equal row counts give slab d ~2d+1 tiles
        # per row pair (26% flop imbalance measured); r_d ~ q*sqrt(d/n)
        # equalizes both the tile counts and the E2 landing in them
        tq = dense_tail.q
        bounds = np.ceil(
            tq * np.sqrt(np.arange(1, ndev + 1) / ndev)
        ).astype(np.int64)
        t_p = np.asarray(dense_tail.p_idx)
        owner[t_p] = np.searchsorted(
            bounds, np.asarray(dense_tail.qi), side="right"
        ).astype(np.int32)
        tail_rows = np.concatenate([[0], bounds])
    loc = np.zeros(npool, np.int32)
    nloc = 0
    for d in range(ndev):
        mine = np.flatnonzero(owner == d)
        loc[mine] = np.arange(mine.size, dtype=np.int32)
        nloc = max(nloc, mine.size)
    return PoolSharding(
        ndev=ndev, nloc=max(nloc, 1), owner=owner, loc=loc,
        owner_col=owner_col,
        tail_rows=tail_rows if dense_tail is not None else None,
    )


def distribution_report(
    layout: SolverLayout, sh: PoolSharding, dense_tail=None
) -> dict:
    """Static load-balance / comm-volume accounting for an owner plan.

    The reference's blend REPORTS what its cost-model-driven proportional
    mapping balanced (src/blend/src/distribPart.c, cost.c); this is the
    analog for the owner-computes plan: per-device owned tiles and padded
    device flops (DIAG+TRSM by column owner, E2 by dst-tile owner), plus
    the halo traffic (per level, operand tiles a device must gather that
    it does not own — the compact-slab all_gather volume).

    Returns a dict with per-device arrays and summary ratios; printed by
    ``dryrun_multichip`` (``parallel/dryrun.py``)."""
    levels = dense_tail.levels_lo if dense_tail is not None else layout.levels
    ndev = sh.ndev
    T = layout.T
    tiles = np.bincount(sh.owner, minlength=ndev).astype(np.int64)
    flops = np.zeros(ndev, np.float64)
    halo_tiles = np.zeros(ndev, np.int64)
    t3 = float(T) ** 3
    for lv in levels:
        own_c = sh.owner_col[np.asarray(lv.cols)]
        np.add.at(flops, own_c, t3 / 3.0)
        if lv.trsm_panel.size:
            np.add.at(
                flops, sh.owner_col[np.asarray(lv.trsm_col)], t3
            )
        if lv.gemm_a.size:
            own_d = sh.owner[np.asarray(lv.gemm_d)]
            np.add.at(flops, own_d, 2.0 * t3)
            # halo: distinct operand tiles needed by d but owned elsewhere
            for arr in (lv.gemm_a, lv.gemm_b):
                key = own_d.astype(np.int64) * layout.npool + np.asarray(
                    arr, np.int64
                )
                uk = np.unique(key)
                dd = (uk // layout.npool).astype(np.int32)
                tt = uk % layout.npool
                foreign = sh.owner[tt] != dd
                np.add.at(halo_tiles, dd[foreign], 1)
    tot = flops.sum()
    imbalance = (
        float(flops.max() / max(flops.mean(), 1.0) - 1.0) if tot else 0.0
    )
    return {
        "ndev": ndev,
        "tiles": tiles,
        "flops": flops,
        "halo_tiles": halo_tiles,
        "halo_bytes": halo_tiles * T * T * 4,
        "flop_imbalance": imbalance,
        "tile_imbalance": float(
            tiles.max() / max(tiles.mean(), 1.0) - 1.0
        ),
    }


def _pad2(rows: list, m: int, fill) -> np.ndarray:
    out = np.full((len(rows), m), fill, np.int32)
    for d, r in enumerate(rows):
        out[d, : len(r)] = r
    return out


def _owner_level_tables(lv, layout: SolverLayout, sh: PoolSharding,
                        for_lu: bool = False):
    """Per-device tables for one level (all numpy, padded to per-level
    maxima; pads follow the OOB conventions in the module docstring).

    ``for_lu`` adds the U-side fan-in tables: per-pair positions into the
    off-diagonal touched set (gp_u) and each owner's apply lists
    (tpos_u/tloc_u)."""
    ndev, nloc, nbc = sh.ndev, sh.nloc, layout.nbc
    diag = np.asarray(lv.diag)
    cols = np.asarray(lv.cols)
    own_d = sh.owner[diag]

    d_rows, c_rows, colpos = [], [], {}
    for d in range(ndev):
        sel = np.flatnonzero(own_d == d)
        d_rows.append(sh.loc[diag[sel]])
        c_rows.append(cols[sel])
        for k, c in enumerate(cols[sel]):
            colpos[int(c)] = k
    md = max(max(len(r) for r in d_rows), 1)

    tp = np.asarray(lv.trsm_panel)
    tc = np.asarray(lv.trsm_col)
    tr = np.asarray(lv.trsm_row)
    own_p = sh.owner_col[tc] if tp.size else np.empty(0, np.int32)
    p_rows, pc_rows, pr_rows, pk_rows = [], [], [], []
    for d in range(ndev):
        sel = np.flatnonzero(own_p == d)
        p_rows.append(sh.loc[tp[sel]])
        pc_rows.append(tc[sel])
        pr_rows.append(tr[sel])
        pk_rows.append(np.array([colpos[int(c)] for c in tc[sel]], np.int64))
    mt = max(max(len(r) for r in p_rows), 1)

    ga, gb, gd = np.asarray(lv.gemm_a), np.asarray(lv.gemm_b), np.asarray(lv.gemm_d)
    ng = ga.size
    if ng:
        xg = np.unique(np.concatenate([ga, gb]))
        touched, tpos_all = np.unique(gd, return_inverse=True)
    else:
        xg = np.empty(0, np.int64)
        touched, tpos_all = np.empty(0, np.int64), np.empty(0, np.int64)
    nx, ntouch = xg.size, touched.size

    xp_rows, xl_rows, ap_rows, al_rows = [], [], [], []
    for d in range(ndev):
        sel = np.flatnonzero(sh.owner[xg] == d) if nx else np.empty(0, int)
        xp_rows.append(sel)
        xl_rows.append(sh.loc[xg[sel]] if nx else np.empty(0, int))
        selt = (
            np.flatnonzero(sh.owner[touched] == d)
            if ntouch else np.empty(0, int)
        )
        ap_rows.append(selt)
        al_rows.append(sh.loc[touched[selt]] if ntouch else np.empty(0, int))
    mx = max(max(len(r) for r in xp_rows), 1)
    mtt = max(max(len(r) for r in ap_rows), 1)

    per = -(-max(ng, 1) // ndev)
    pad = per * ndev - ng
    ga_x = np.concatenate(
        [np.searchsorted(xg, ga), np.full(pad, nx, np.int64)]
    ) if ng else np.full(per * ndev, nx, np.int64)
    gb_x = np.concatenate(
        [np.searchsorted(xg, gb), np.full(pad, nx, np.int64)]
    ) if ng else np.full(per * ndev, nx, np.int64)
    gp = np.concatenate(
        [tpos_all, np.full(pad, ntouch, np.int64)]
    ) if ng else np.full(per * ndev, ntouch, np.int64)

    out = {
        "diag": _pad2(d_rows, md, nloc),
        "cols": _pad2(c_rows, md, nbc),
        "tp": _pad2(p_rows, mt, nloc),
        "tcpos": _pad2(pk_rows, mt, md),  # pad md: clamp junk / OOB row
        "tc": _pad2(pc_rows, mt, nbc),
        "tr": _pad2(pr_rows, mt, nbc),
        "xpos": _pad2(xp_rows, mx, nx),  # pad -> sacrificial X row
        "xloc": _pad2(xl_rows, mx, nloc),
        "ga": np.asarray(ga_x.reshape(ndev, per), np.int32),
        "gb": np.asarray(gb_x.reshape(ndev, per), np.int32),
        "gp": np.asarray(gp.reshape(ndev, per), np.int32),
        "tpos": _pad2(ap_rows, mtt, ntouch),
        "tloc": _pad2(al_rows, mtt, nloc),
        "nx": nx,
        "ntouch": ntouch,
    }
    if for_lu:
        nd_mask = np.asarray(lv.gemm_nondiag)
        if ng and nd_mask.any():
            tu, posu = np.unique(gd[nd_mask], return_inverse=True)
        else:
            tu, posu = np.empty(0, np.int64), np.empty(0, np.int64)
        ntu = tu.size
        gpu = np.full(ng, ntu, np.int64)
        if ntu:
            gpu[nd_mask] = posu
        gpu = np.concatenate([gpu, np.full(per * ndev - ng, ntu, np.int64)])
        up_rows, ul_rows = [], []
        for dd in range(ndev):
            selu = (
                np.flatnonzero(sh.owner[tu] == dd)
                if ntu else np.empty(0, int)
            )
            up_rows.append(selu)
            ul_rows.append(sh.loc[tu[selu]] if ntu else np.empty(0, int))
        mtu = max(max(len(r) for r in up_rows), 1)
        out["gp_u"] = np.asarray(gpu.reshape(ndev, per), np.int32)
        out["tpos_u"] = _pad2(up_rows, mtu, ntu)
        out["tloc_u"] = _pad2(ul_rows, mtu, nloc)
        out["ntouch_u"] = ntu
    return out


def _owner_gk(lv, ndev: int, nbc: int) -> np.ndarray:
    """Per-pair source block column (LDLᵗ's D scaling), dealt round-robin
    like ``ga`` (the reference's ``gks`` of ``build_owner_factorize_ldlt``)."""
    ng = lv.gemm_a.size
    per = -(-max(ng, 1) // ndev)
    pad = per * ndev - ng
    gk = np.concatenate(
        [np.asarray(lv.gemm_k), np.full(pad, nbc, np.int64)]
    ) if ng else np.full(per * ndev, nbc, np.int64)
    return np.asarray(gk.reshape(ndev, per), np.int32)


def _owner_tail_tables(layout: SolverLayout, dense_tail, sh: PoolSharding):
    """The host tables of the reference's ``_owner_tail``: the per-device
    tail row ranges ``lo``/``hi`` (equal-area by default), the slab
    height ``L``, the gather map ``row_map`` of the (ndev*L) padded slab
    stack and each device's tail tiles (``tloc`` slots, ``tqi`` slab rows,
    ``tqj`` columns; pads ``nloc``, ``L``, 0)."""
    tq = dense_tail.q
    ndev = sh.ndev
    # per-device tail row ranges [lo_d, hi_d) — equal-area by default
    # (build_pool_sharding); the slab buffer height L is the max range
    if sh.tail_rows is not None:
        tail_rows = np.asarray(sh.tail_rows, np.int64)
    else:
        Lu = -(-tq // ndev)
        tail_rows = np.minimum(np.arange(ndev + 1) * Lu, tq)
    lo_np = tail_rows[:-1]
    hi_np = tail_rows[1:]
    L = max(int((hi_np - lo_np).max()), 1)
    # row r of the all_gather'd (ndev*L) padded slab stack lives at
    # d(r)*L + (r - lo_d(r)) — host-precomputed gather map
    r_dev = np.searchsorted(tail_rows, np.arange(tq), side="right") - 1
    row_map = (r_dev * L + (np.arange(tq) - lo_np[r_dev])).astype(np.int32)
    t_p = np.asarray(dense_tail.p_idx)
    t_qi = np.asarray(dense_tail.qi)
    t_qj = np.asarray(dense_tail.qj)
    loc_rows, qi_rows, qj_rows = [], [], []
    for d in range(ndev):
        sel = np.flatnonzero(sh.owner[t_p] == d)
        loc_rows.append(sh.loc[t_p[sel]])
        qi_rows.append(t_qi[sel] - lo_np[d])
        qj_rows.append(t_qj[sel])
    mw = max(max(len(r) for r in loc_rows), 1)
    return {
        "lo": lo_np, "hi": hi_np, "L": L, "row_map": row_map,
        "tloc": _pad2(loc_rows, mw, sh.nloc),
        "tqi": _pad2(qi_rows, mw, L),  # pad L: slab scatter drops
        "tqj": _pad2(qj_rows, mw, 0),
    }


# ----------------------------------------------------------------------
# the rank's side
# ----------------------------------------------------------------------


@dataclasses.dataclass
class _Rank:
    """One level's tables for the rank ``me``, pads dropped, as int64
    tensors on its device (``cols``, ``diag``, ``tp``, ``tcpos``, ``tc``
    are what ``numeric.factorize.diag_trsm`` reads)."""

    cols: torch.Tensor
    diag: torch.Tensor
    tp: torch.Tensor
    tcpos: torch.Tensor
    tc: torch.Tensor
    tr: torch.Tensor
    lcols: torch.Tensor  # every column of the level (LDLᵗ's d merge)
    nx: int = 0
    ntouch: int = 0
    ntouch_u: int = 0
    xloc: torch.Tensor = None  # the rank's halo slab (its real rows)
    mx: int = 0  # the slab's rows on every rank (the gather's size)
    xpos: torch.Tensor = None  # (ndev*mx,) X row of each gathered row
    tpos: torch.Tensor = None  # the rank's touched rows it applies
    tloc: torch.Tensor = None  # their local slots
    tpos_u: torch.Tensor = None
    tloc_u: torch.Tensor = None
    e2: object = None  # the rank's pairs: a K3 plan, or index tensors
    e2_u: object = None  # LU's U-side pairs


def _real(row: np.ndarray, fill) -> np.ndarray:
    """The real entries of one device's ``_pad2`` row (its pads, all
    ``fill``, follow them)."""
    return row[: int((row != fill).sum())]


def _rank_level(t: dict, lv, me: int, sh: PoolSharding, device, fp32: bool,
                gk=None) -> _Rank:
    """``_owner_level_tables``' row ``me`` as the rank runs it: the pads
    dropped, the pairs (those whose ``gp`` is not the sacrificial
    ``ntouch``) as a K3 plan (``fp32``) or as index tensors."""
    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    nd = int((t["diag"][me] != sh.nloc).sum())
    ntp = int((t["tp"][me] != sh.nloc).sum())
    r = _Rank(
        cols=tens(t["cols"][me][:nd]), diag=tens(t["diag"][me][:nd]),
        tp=tens(t["tp"][me][:ntp]), tcpos=tens(t["tcpos"][me][:ntp]),
        tc=tens(t["tc"][me][:ntp]), tr=tens(t["tr"][me][:ntp]),
        lcols=tens(lv.cols), nx=t["nx"], ntouch=t["ntouch"],
    )
    if not r.nx:
        return r
    r.xloc = tens(_real(t["xloc"][me], sh.nloc))
    r.mx = t["xloc"].shape[1]
    r.xpos = tens(t["xpos"].reshape(-1))
    ntt = int((t["tloc"][me] != sh.nloc).sum())
    r.tpos, r.tloc = tens(t["tpos"][me][:ntt]), tens(t["tloc"][me][:ntt])

    k = None if gk is None else gk[me]
    r.e2 = rank_pairs(t["ga"][me], t["gb"][me], t["gp"][me], r.ntouch, k,
                      device, fp32)
    if "gp_u" in t:
        r.ntouch_u = t["ntouch_u"]
        ntu = int((t["tloc_u"][me] != sh.nloc).sum())
        r.tpos_u = tens(t["tpos_u"][me][:ntu])
        r.tloc_u = tens(t["tloc_u"][me][:ntu])
        r.e2_u = rank_pairs(t["ga"][me], t["gb"][me], t["gp_u"][me],
                            r.ntouch_u, None, device, fp32)
    return r


def rank_pairs(ga, gb, gp, nt, gk, device, fp32):
    """One rank's dealt pairs (its row of the ``ga``/``gb``/``gp`` tables,
    ``gk`` the source columns or None), the pads (``gp == nt``, the
    sacrificial slot) dropped: a K3 plan (``pipelined.operand_plan``:
    ``ga``/``gb`` index the operand arrays, ``gp`` the touched buffer) on
    an fp32 pool, else index tensors."""
    keep = gp != nt
    ga, gb, gp = ga[keep], gb[keep], gp[keep]
    gk = None if gk is None else gk[keep]
    if fp32:
        return operand_plan(ga, gb, gp, gk, device) if ga.size else []
    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return (tens(ga), tens(gb), tens(gp), None if gk is None else tens(gk))


def run_pairs(acc, pairs, Xa, Xb, update_dtype, d=None, hermitian=False):
    """acc[gp] -= op(Xa[ga] diag(d[gk])) @ op(Xb[gb])ᵗ (ᴴ with
    ``hermitian``) over a rank's pairs (:func:`rank_pairs`): kernel K3
    with ``Xa``/``Xb`` as its operand arrays (``xab``) on an fp32
    buffer, else the torch ops of ``numeric/kernels``."""
    if isinstance(pairs, list):
        if pairs:
            gemm_scatter_pipelined(acc, pairs, update_dtype, d=d,
                                   xab=(Xa, Xb))
    elif pairs[0].numel():
        ga, gb, gp, gk = pairs
        gemm_scatter_ab(acc, Xa, Xb, ga, gb, gp, update_dtype,
                        None if d is None else d[gk], hermitian)


def _halo(axis, r: _Rank, *pools):
    """The level's halo: each owner's slab of post-TRSM panels (every
    pool's, stacked), all_gathered at one size, scattered into X
    (npools, nx + 1, T, T); the pad rows are zeros and land in X[nx]."""
    p0 = pools[0]
    T = p0.shape[-1]
    send = torch.zeros((len(pools), r.mx, T, T), dtype=p0.dtype,
                       device=p0.device)
    for i, p in enumerate(pools):
        torch.index_select(p, 0, r.xloc, out=send[i, : r.xloc.numel()])
    Xg = axis.all_gather(send)  # (ndev, npools, mx, T, T)
    X = torch.zeros((len(pools), r.nx + 1, T, T), dtype=p0.dtype,
                    device=p0.device)
    for i in range(len(pools)):
        X[i].index_copy_(0, r.xpos, Xg[:, i].reshape(-1, T, T))
    return X


def fan_in(axis, acc, p, tpos, tloc):
    """The touched buffer summed over the axis (``lax.psum``), then its
    rows ``tpos`` added to the tiles ``tloc`` of ``p``: ``acc`` holds
    minus the contributions (K3 subtracts)."""
    axis.all_reduce(acc)
    if tloc.numel():
        p.index_add_(0, tloc, acc[tpos])


def tail_steps(S, lo: int, hi: int, L: int, tq: int, T: int, row_map,
               axis, update_dtype, hermitian: bool = False) -> None:
    """The 2D right-looking Cholesky of the dense tail on one rank's row
    slab ``S`` (L*T, tq*T) of the tail rows [lo, hi), in place (the step
    loop of the reference's ``_owner_tail`` and ``_tail_factor_sharded``):
    per tile column j the owner's diagonal tile summed over ``axis``,
    factored (a broken one turns NaN, as ``lax.linalg.cholesky``), the
    slab's rows below j times its inverse (the panel, kept in place), the
    panel all_gathered (row ``row_map[r]`` of the padded stack holds tail
    row r), then the slab's columns past j updated by the panel's rows
    (the reference's einsum over every column adds zeros at or before j).
    ``hermitian``: L Lᴴ of a complex tail."""
    dev, dt = S.device, S.dtype
    eye = torch.eye(T, dtype=dt, device=dev)
    conj = (lambda x: x.conj()) if hermitian and dt.is_complex else (
        lambda x: x)
    for j in range(tq):
        own = lo <= j < hi
        jl = j - lo
        cs = slice(j * T, (j + 1) * T)
        diag = (S[jl * T:(jl + 1) * T, cs].clone() if own
                else torch.zeros((T, T), dtype=dt, device=dev))
        axis.all_reduce(diag)
        Lj = potrf_batch(diag[None])[0]
        Li = torch.linalg.solve_triangular(Lj, eye, upper=False)
        if own:
            S[jl * T:(jl + 1) * T, cs] = Lj
        r0 = min(max(j + 1 - lo, 0), L)  # the slab's first row below j
        Pn = torch.zeros((L * T, T), dtype=dt, device=dev)
        if r0 * T < S.shape[0]:
            Pn[r0 * T:] = S[r0 * T:, cs] @ conj(Li).T
            S[r0 * T:, cs] = Pn[r0 * T:]
        if j + 1 == tq:
            break
        Pfull = axis.all_gather(Pn.view(L, T, T)).view(-1, T, T)[row_map]
        Pb = round_to(conj(Pfull[j + 1:]), update_dtype).reshape(-1, T)
        if r0 * T < S.shape[0]:
            Pa = round_to(Pn[r0 * T:], update_dtype)
            S[r0 * T:, (j + 1) * T:].addmm_(Pa, Pb.T, alpha=-1.0)


def _rank_plan(layout, sh, axis, device, levels, fp32, for_lu=False,
               scaled=False) -> list:
    """The rank's tables (:class:`_Rank`) of every level, in order."""
    return [
        _rank_level(_owner_level_tables(lv, layout, sh, for_lu=for_lu), lv,
                    axis.me, sh, device, fp32,
                    _owner_gk(lv, sh.ndev, layout.nbc) if scaled else None)
        for lv in levels
    ]


def _tail_tensors(layout, dense_tail, sh, me, device):
    """The rank's tail tables (``_owner_tail_tables``' row ``me``, pads
    dropped) as tensors, with the slab geometry."""
    tt = _owner_tail_tables(layout, dense_tail, sh)
    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    nw = int((tt["tloc"][me] != sh.nloc).sum())
    return {
        "lo": int(tt["lo"][me]), "hi": int(tt["hi"][me]), "L": tt["L"],
        "tq": dense_tail.q, "row_map": tens(tt["row_map"]),
        "loc": tens(tt["tloc"][me][:nw]), "qi": tens(tt["tqi"][me][:nw]),
        "qj": tens(tt["tqj"][me][:nw]),
    }


def _plain_eps(eps, dtype) -> float:
    """The clamp threshold in the pool's precision (as ``_build_plain``)."""
    return float(torch.tensor(eps, dtype=dtype.to_real()))


def build_owner_factorize_llt(layout: SolverLayout, sh: PoolSharding, axis,
                              device, dense_tail=None, update_dtype=None,
                              dtype=torch.float32):
    """Owner-computes LLᵗ over the rank's pool: ``fn(p) -> p`` with ``p``
    the rank's (nloc, T, T) tiles (``build_local_coefinit_fn``), in place.
    ``axis`` (``mesh.Axis``) is the tp axis; ``dense_tail`` (LLᵗ's
    ``plan_dense_tail``) factors the terminal block by row slabs.
    ``fn.levels`` holds the rank's level tables (``e2``: its K3 plans)."""
    levels = dense_tail.levels_lo if dense_tail is not None else layout.levels
    T = layout.T
    fp32 = dtype == torch.float32
    plan = _rank_plan(layout, sh, axis, device, levels, fp32)
    tail = (_tail_tensors(layout, dense_tail, sh, axis.me, device)
            if dense_tail is not None else None)

    def level(p, r):
        if r.diag.numel():
            (diag_trsm if fp32 else plain_diag_trsm)(Factorization.LLT, r, p)
        if r.nx:
            # halo exchange: the level's post-TRSM panels, once; the
            # rank's pairs from X into the touched buffer, then the fan-in
            X = _halo(axis, r, p)[0]
            acc = torch.zeros((r.ntouch + 1, T, T), dtype=p.dtype,
                              device=p.device)
            run_pairs(acc, r.e2, X, X, update_dtype)
            fan_in(axis, acc, p, r.tpos, r.tloc)

    def fact_local(p):
        for r in plan:
            level(p, r)
        if tail is not None:
            slab = torch.zeros((tail["L"], T, tail["tq"], T), dtype=p.dtype,
                               device=p.device)
            slab[tail["qi"], :, tail["qj"], :] = p[tail["loc"]]
            tail_steps(slab.view(tail["L"] * T, -1), tail["lo"], tail["hi"],
                       tail["L"], tail["tq"], T, tail["row_map"], axis,
                       update_dtype)
            p[tail["loc"]] = slab[tail["qi"], :, tail["qj"], :]
        return p

    fact_local.kind = Factorization.LLT
    fact_local.levels = plan
    return fact_local


def build_owner_factorize_ldlt(layout: SolverLayout, sh: PoolSharding, axis,
                               device, update_dtype=None,
                               dtype=torch.float32):
    """Owner-computes LDLᵗ: ``fn(p, eps) -> (p, d, npiv)``; per level the
    owners' pivots are merged into the replicated (nbc, T) ``d`` with one
    small all_reduce before the E2 needs them, and ``npiv`` (the clamped
    pivots, a 0-d int32 tensor) is summed over the axis at the end.  The
    merge carries each owner's pivots (zeros elsewhere), where the
    reference adds ``d - 1`` to the ones of ``d``: the same values,
    without rounding small pivots against 1."""
    T, nbc = layout.T, layout.nbc
    fp32 = dtype == torch.float32
    plan = _rank_plan(layout, sh, axis, device, layout.levels, fp32,
                      scaled=True)

    def fact_local(p, eps):
        d = torch.ones((nbc, T), dtype=p.dtype, device=p.device)
        npiv = torch.zeros((), dtype=torch.int32, device=p.device)
        e = eps if fp32 else _plain_eps(eps, dtype)
        for r in plan:
            if r.diag.numel():
                (diag_trsm if fp32 else plain_diag_trsm)(
                    Factorization.LDLT, r, p, d=d, npiv=npiv, eps=e)
            # merge the level's pivots into the replicated d (owners)
            dbuf = torch.zeros_like(d)
            dbuf[r.cols] = d[r.cols]
            axis.all_reduce(dbuf)
            d[r.lcols] = dbuf[r.lcols]
            if r.nx:
                X = _halo(axis, r, p)[0]
                acc = torch.zeros((r.ntouch + 1, T, T), dtype=p.dtype,
                                  device=p.device)
                run_pairs(acc, r.e2, X, X, update_dtype, d=d)
                fan_in(axis, acc, p, r.tpos, r.tloc)
        axis.all_reduce(npiv)
        return p, d, npiv

    fact_local.kind = Factorization.LDLT
    fact_local.levels = plan
    return fact_local


def build_owner_factorize_lu(layout: SolverLayout, sh: PoolSharding, axis,
                             device, update_dtype=None, dtype=torch.float32):
    """Owner-computes LU over the rank's two pools (L and Uᵗ):
    ``fn(p, pu, eps) -> (p, pu, npiv)``.  Per level both pools' post-TRSM
    panels ride one stacked halo all_gather; the L- and U-side
    contributions come back through two fan-ins (the U side drops
    diagonal targets)."""
    T = layout.T
    fp32 = dtype == torch.float32
    plan = _rank_plan(layout, sh, axis, device, layout.levels, fp32,
                      for_lu=True)

    def fact_local(p, pu, eps):
        npiv = torch.zeros((), dtype=torch.int32, device=p.device)
        e = eps if fp32 else _plain_eps(eps, dtype)
        for r in plan:
            if r.diag.numel():
                (diag_trsm if fp32 else plain_diag_trsm)(
                    Factorization.LU, r, p, pu, npiv=npiv, eps=e)
            if r.nx:
                # one stacked halo carries both pools' level panels
                X = _halo(axis, r, p, pu)
                # L side: A(I,K) -= L(I,J) U(J,K) = Lp[ga] @ Ut[gb]^T
                acc = torch.zeros((r.ntouch + 1, T, T), dtype=p.dtype,
                                  device=p.device)
                run_pairs(acc, r.e2, X[0], X[1], update_dtype)
                fan_in(axis, acc, p, r.tpos, r.tloc)
                if r.ntouch_u:
                    accu = torch.zeros((r.ntouch_u + 1, T, T),
                                       dtype=p.dtype, device=p.device)
                    run_pairs(accu, r.e2_u, X[1], X[0], update_dtype)
                    fan_in(axis, accu, pu, r.tpos_u, r.tloc_u)
        axis.all_reduce(npiv)
        return p, pu, npiv

    fact_local.kind = Factorization.LU
    fact_local.levels = plan
    return fact_local


def _wrap_dp_pad(fn, dp, nbc: int, T: int):
    """The RHS columns over the dp axis (the reference's ``P(None, None,
    dp)`` with its per-call padding to a dp multiple): each dp rank solves
    its contiguous share, and one all_gather over dp returns the whole X
    to every rank."""
    if dp is None or dp.size == 1:
        return fn

    def wrap(*args):
        b = args[-1]
        R = b.shape[-1]
        pad = (-R) % dp.size
        if pad:
            b = torch.cat([b, b.new_zeros(b.shape[:-1] + (pad,))], dim=-1)
        per = (R + pad) // dp.size
        x = fn(*args[:-1], b[..., dp.me * per:(dp.me + 1) * per].contiguous())
        X = dp.all_gather(x).permute(1, 2, 0, 3).reshape(nbc, T, -1)
        return X[..., :R]

    return wrap


class _TailCache:
    """The replicated dense tail factor (m, m), gathered once per factored
    pool (the reference's ``tail_gather`` runs in every solve)."""

    def __init__(self):
        self.key, self.dense = None, None

    def get(self, p, make):
        key = (p.data_ptr(), p._version, tuple(p.shape))
        if self.key != key:
            self.key, self.dense = key, make(p)
        return self.dense


def build_owner_solve_llt(layout: SolverLayout, sh: PoolSharding, axis,
                          device, dense_tail=None, unit: bool = False,
                          with_d: bool = False, dp=None, dtype=torch.float32):
    """Owner-computes solve over the rank's pool: per level, owners solve
    their diagonal blocks and compute their panels' contributions; one
    all_reduce of the (nbc, T, R) delta merges the level (forward and
    backward sweeps alike).  ``fn(*factors, b) -> x`` with ``factors``
    the kind's ``Factors.solve_args`` (the inverse tiles unused): LLᵗ
    (pool, dinv); with ``unit``/``with_d`` the LDLᵗ factor (pool, dinv,
    d), unit sweeps with the D scaling between them.  ``b`` (nbc, T, R)
    replicated; ``dp`` (``mesh.Axis``) splits its columns
    (:func:`_wrap_dp_pad`).  The dense tail is gathered once per factored
    pool and solved densely on every rank."""
    levels = dense_tail.levels_lo if dense_tail is not None else layout.levels
    T, nbc = layout.T, layout.nbc
    plan = _rank_plan(layout, sh, axis, device, levels, fp32=False)
    tail = (_tail_tensors(layout, dense_tail, sh, axis.me, device)
            if dense_tail is not None else None)
    cache = _TailCache()

    def tail_gather(p):
        """The replicated dense tail (q*T, q*T) via one all_reduce."""
        tq = tail["tq"]
        dense = torch.zeros((tq, T, tq, T), dtype=p.dtype, device=p.device)
        dense[tail["qi"] + tail["lo"], :, tail["qj"], :] = p[tail["loc"]]
        return axis.all_reduce(dense).view(tq * T, tq * T)

    def fwd_level(p, y, r):
        buf = torch.zeros_like(y)
        if r.diag.numel():
            yc = y[r.cols]
            sol = torch.linalg.solve_triangular(p[r.diag], yc, upper=False,
                                                unitriangular=unit)
            buf[r.cols] = sol - yc
            if r.tp.numel():
                buf.index_add_(0, r.tr, torch.bmm(p[r.tp], sol[r.tcpos]),
                               alpha=-1.0)
        return y + axis.all_reduce(buf)

    def bwd_level(p, x, r):
        buf = torch.zeros_like(x)
        if r.diag.numel():
            xc = x[r.cols]
            if r.tp.numel():
                xc = xc.index_add(
                    0, r.tcpos, torch.bmm(p[r.tp].transpose(1, 2), x[r.tr]),
                    alpha=-1.0)
            sol = torch.linalg.solve_triangular(
                p[r.diag].transpose(1, 2), xc, upper=True,
                unitriangular=unit)
            buf[r.cols] = sol - x[r.cols]
        return x + axis.all_reduce(buf)

    def solve_local(*args):
        *factors, b = args
        p = factors[0]
        y = b.to(p.dtype)
        for r in plan:
            y = fwd_level(p, y, r)
        if with_d:
            y = y / factors[2][..., None]
        if tail is not None:
            s0, tq = dense_tail.s, tail["tq"]
            Ld = cache.get(p, tail_gather)
            yt = y[s0:].reshape(tq * T, -1)
            yt = torch.linalg.solve_triangular(Ld, yt, upper=False)
            yt = torch.linalg.solve_triangular(Ld.T, yt, upper=True)
            y = y.clone()
            y[s0:] = yt.reshape(tq, T, -1)
        for r in reversed(plan):
            y = bwd_level(p, y, r)
        return y

    return _wrap_dp_pad(solve_local, dp, nbc, T)


def build_owner_solve_lu(layout: SolverLayout, sh: PoolSharding, axis,
                         device, dp=None, dtype=torch.float32):
    """Owner-computes LU solve: unit-lower forward on the L tiles, upper
    backward with off-diagonal contributions from the Uᵗ tiles and the
    combined diagonal tiles from the L tiles.  ``fn(p, pu, dinv, dinv_u,
    b) -> x`` (the inverse tiles unused)."""
    T, nbc = layout.T, layout.nbc
    plan = _rank_plan(layout, sh, axis, device, layout.levels, fp32=False)

    def fwd_level(p, y, r):
        buf = torch.zeros_like(y)
        if r.diag.numel():
            yc = y[r.cols]
            sol = torch.linalg.solve_triangular(p[r.diag], yc, upper=False,
                                                unitriangular=True)
            buf[r.cols] = sol - yc
            if r.tp.numel():
                buf.index_add_(0, r.tr, torch.bmm(p[r.tp], sol[r.tcpos]),
                               alpha=-1.0)
        return y + axis.all_reduce(buf)

    def bwd_level(pu, p, x, r):
        buf = torch.zeros_like(x)
        if r.diag.numel():
            xc = x[r.cols]
            if r.tp.numel():
                xc = xc.index_add(
                    0, r.tcpos, torch.bmm(pu[r.tp].transpose(1, 2), x[r.tr]),
                    alpha=-1.0)
            sol = torch.linalg.solve_triangular(p[r.diag], xc, upper=True)
            buf[r.cols] = sol - x[r.cols]
        return x + axis.all_reduce(buf)

    def solve_local(p, pu, dinv, dinv_u, b):
        y = b.to(p.dtype)
        for r in plan:
            y = fwd_level(p, y, r)
        for r in reversed(plan):
            y = bwd_level(pu, p, y, r)
        return y

    return _wrap_dp_pad(solve_local, dp, nbc, T)


def build_local_coefinit_fn(layout: SolverLayout, A_pattern, sh: PoolSharding,
                            me: int, device, for_lu: bool = False,
                            dtype=torch.float32):
    """The rank's coefinit (the reference's ``shard_pool_device`` for one
    device, without its full host pool): ``fn(vals) -> p`` (``(p, pu)``
    with ``for_lu``), the rank's (nloc, T, T) tiles with A's entries that
    land in them (``vals`` the COO data of ``A_pattern``, as
    ``numeric.factorize.build_coefinit_fn`` takes them) and the padded
    diagonal's ones; no other tile is ever built."""
    import scipy.sparse as sp

    T = layout.T
    A = sp.coo_matrix(A_pattern)
    i, j = A.row.astype(np.int64), A.col.astype(np.int64)
    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    loc = sh.loc.astype(np.int64)

    def flat(sel, rows, cols):
        p = layout.lookup(rows[sel] // T, cols[sel] // T)
        mine = sh.owner[p] == me
        return (tens(np.flatnonzero(sel)[mine]),
                tens(loc[p[mine]] * (T * T) + (rows[sel][mine] % T) * T
                     + (cols[sel][mine] % T)))

    lo = (i // T) >= (j // T) if for_lu else i >= j
    sel_l, flat_l = flat(lo, i, j)
    sel_u, flat_u = flat(~lo, j, i) if for_lu else (None, None)
    pad = np.asarray(layout.diag_pad_flat, np.int64)
    pp = pad // (T * T)
    mine = sh.owner[pp] == me
    pad_t = tens(loc[pp[mine]] * (T * T) + pad[mine] % (T * T))
    numel = sh.nloc * T * T
    shape = (sh.nloc, T, T)

    def scatter(vals, sel, idx):
        p = torch.zeros(numel, dtype=dtype, device=device)
        p.index_put_((idx,), vals[sel].to(dtype), accumulate=True)
        return p

    def fn(vals: torch.Tensor):
        p = scatter(vals, sel_l, flat_l)
        p[pad_t] = 1.0
        if not for_lu:
            return p.view(shape)
        return p.view(shape), scatter(vals, sel_u, flat_u).view(shape)

    fn.dtype = dtype
    return fn


def gather_pool(sh: PoolSharding, p: torch.Tensor, axis) -> np.ndarray:
    """The global (npool, T, T) pool on every rank from the ranks' tiles:
    one all_gather over the axis, then ``from_local`` on the host."""
    return sh.from_local(axis.all_gather(p).cpu().numpy())
