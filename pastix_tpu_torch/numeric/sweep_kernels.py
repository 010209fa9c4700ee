"""Whole-sweep triangular solve: host schedule and kernel K2.

``build_sweep_schedule`` is a verbatim copy of the host builder in
``pastix_tpu/numeric/sweep_kernels.py`` (that module imports JAX).  Its
chunking drops the level boundaries, which the TPU never needed because
its grid ran in order; :func:`sweep_phase_offsets` recovers them from
``layout.levels`` and :func:`sweep_plan` turns each level's diag and
update phases into the twin's tables and the CUDA kernel's work items.

``run_sweep`` launches the hand-written CUDA kernel (``csrc/sweep.cu``),
once per sweep direction over the work items of :func:`sweep_items`, for
tensors on a CUDA device, and its plain twin ``run_sweep_ref`` (level
phase by level phase) for tensors on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pastix_tpu_torch import _build


def build_sweep_schedule(layout, chunk_max: int = 16384, group: int = 4):
    """Host-built flat op streams for both sweeps.

    Returns {"fwd": chunks, "bwd": chunks, "nsteps": per-chunk steps}.
    Each chunk: dict(tidx, src, dst, kd) int32 arrays of length
    nsteps*group (uniformly padded so every chunk shares one kernel
    compile).  Null pad ops write the dummy RHS row (index nbc).
    """
    G = int(group)
    fwd_parts = []
    bwd_parts = []
    for lv in layout.levels:
        cols = np.asarray(lv.cols, np.int32)
        tp = np.asarray(lv.trsm_panel, np.int32)
        tr = np.asarray(lv.trsm_row, np.int32)
        tc = np.asarray(lv.trsm_col, np.int32)
        one = np.ones(cols.size, np.int32)
        zero = np.zeros(tp.size, np.int32)
        # fwd: diag ops then updates
        fwd_parts.append((cols, cols, cols, one))
        if tp.size:
            fwd_parts.append((tp, tc, tr, zero))
        # bwd (built in forward order; reversed below): updates then diag
        bwd_parts.append(((tp, tr, tc, zero), (cols, cols, cols, one)))

    def _cat(parts):
        return tuple(
            np.concatenate([p[f] for p in parts]) if parts
            else np.empty(0, np.int32)
            for f in range(4)
        )

    fwd = _cat(fwd_parts)
    bwd = _cat(
        [p for upd_diag in reversed(bwd_parts) for p in upd_diag]
    )

    nsteps = max(1, chunk_max // G)
    csz = nsteps * G
    dummy = layout.nbc  # null ops write the extra RHS row

    def _chunks(ops):
        tidx, src, dst, kd = ops
        n = tidx.size
        out = []
        for lo in range(0, max(n, 1), csz):
            hi = min(lo + csz, n)
            m = hi - lo
            c = {
                "tidx": np.zeros(csz, np.int32),
                "src": np.zeros(csz, np.int32),
                "dst": np.full(csz, dummy, np.int32),
                "kd": np.zeros(csz, np.int32),
            }
            c["tidx"][:m] = tidx[lo:hi]
            c["src"][:m] = src[lo:hi]
            c["dst"][:m] = dst[lo:hi]
            c["kd"][:m] = kd[lo:hi]
            out.append(c)
        return out

    return {
        "fwd": _chunks(fwd),
        "bwd": _chunks(bwd),
        "nsteps": nsteps,
        "group": G,
        "nbc": layout.nbc,
        "T": layout.T,
    }


def sweep_phase_offsets(layout):
    """[(kind, lo, hi)] per direction: the slice of the flat (unpadded)
    op stream of :func:`build_sweep_schedule` that each level's "diag" or
    "upd" phase occupies, in execution order."""
    fwd, bwd = [], []
    pos = 0
    for lv in layout.levels:
        nc, nt = len(lv.cols), len(lv.trsm_panel)
        fwd.append(("diag", pos, pos + nc))
        pos += nc
        if nt:
            fwd.append(("upd", pos, pos + nt))
            pos += nt
    pos = 0
    for lv in reversed(layout.levels):
        nc, nt = len(lv.cols), len(lv.trsm_panel)
        if nt:
            bwd.append(("upd", pos, pos + nt))
            pos += nt
        bwd.append(("diag", pos, pos + nc))
        pos += nc
    return {"fwd": fwd, "bwd": bwd}


# update ops per work item of K2, per direction: a dst's run of ops in one
# phase is cut into sub-segments of at most this many, so a dst with many
# ops spreads over many SMs; its diag item adds the partial sums in a
# fixed order.  The backward sweep's longest chain runs through columns
# whose ops (their panel tiles) all land in one phase: one op an item
# loads those tiles on as many SMs at once; the forward sweep's chain
# items hold one op anyway, and 4 keep its item count down
_OPS_PER_ITEM = {"fwd": 4, "bwd": 1}
# ops per batched product of the plain twin (bounds its transients)
_REF_BATCH = 8192
# work item kinds of K2 (csrc/sweep.cu)
DIAG, UPD, FLUSH = 0, 1, 2


@dataclasses.dataclass
class SweepPhase:
    """One level phase, as the twin runs it.  diag: ``cols``.  upd: the
    phase's ops sorted by dst (stable)."""

    kind: str
    cols: torch.Tensor = None  # diag: [nc] columns
    op_tile: torch.Tensor = None  # upd: [nop] pool index of the tile
    op_src: torch.Tensor = None  # upd: [nop] src block-row
    op_dst: torch.Tensor = None  # upd: [nop] dst block-row


@dataclasses.dataclass
class SweepItems:
    """K2's work list for one direction, in ticket order (the phases'
    order, flush items last).  ``item`` rows are (kind, col, lo, hi,
    slot): a DIAG or FLUSH item of column ``col`` sums the partial slots
    ``slot_list[lo:hi]`` (every sub-segment that feeds ``col``, in ticket
    order), then DIAG applies the diagonal; an UPD item runs the ops
    ``lo:hi`` into ``col`` and writes partial slot ``slot`` (its rank
    among the UPD items).  ``op_wait``: the op's src has a DIAG item in
    this sweep (else y[src] is final from the start: the Schur rows of
    the backward sweep)."""

    item: torch.Tensor  # [nitems, 5]
    slot_list: torch.Tensor  # [nslot]
    op_tile: torch.Tensor  # [nop]
    op_src: torch.Tensor  # [nop]
    op_wait: torch.Tensor  # [nop]
    nslot: int
    ops_max: int  # the most ops of an UPD item

    @property
    def nitems(self) -> int:
        return self.item.shape[0]


def sweep_items(phases, nbc):
    """Numpy tables of :class:`SweepItems` from one direction's phases,
    each ``("diag", cols)`` or ``("upd", sub_ptr, tile, src, dst)``: the
    phase's ops sorted by dst and cut at ``sub_ptr`` into sub-segments of
    one dst each.  Raises unless every item waits only on items with
    smaller tickets, which is what keeps the persistent kernel free of
    deadlock."""
    kinds, cols, los, his, tiles, srcs = [], [], [], [], [], []
    nop = 0
    for ph in phases:
        if ph[0] == "diag":
            n = ph[1].size
            kinds.append(np.full(n, DIAG))
            cols.append(ph[1])
            los.append(np.zeros(n, np.int64))
            his.append(np.zeros(n, np.int64))
            continue
        _, sub_ptr, tile, src, dst = ph
        nsub = sub_ptr.size - 1
        kinds.append(np.full(nsub, UPD))
        cols.append(dst[sub_ptr[:-1]])
        los.append(nop + sub_ptr[:-1])
        his.append(nop + sub_ptr[1:])
        tiles.append(tile)
        srcs.append(src)
        nop += tile.size
    cat = lambda parts: (np.concatenate(parts).astype(np.int64) if parts
                         else np.empty(0, np.int64))
    kind, col, lo, hi = cat(kinds), cat(cols), cat(los), cat(his)
    op_tile, op_src = cat(tiles), cat(srcs)
    upd = kind == UPD
    has_diag = np.zeros(nbc, bool)
    has_diag[col[kind == DIAG]] = True
    flush = np.unique(col[upd & ~has_diag[col]])
    nf = flush.size
    kind = np.r_[kind, np.full(nf, FLUSH)]
    col = np.r_[col, flush]
    lo = np.r_[lo, np.zeros(nf, np.int64)]
    hi = np.r_[hi, np.zeros(nf, np.int64)]
    slot = np.full(kind.size, -1, np.int64)
    slot[np.flatnonzero(kind == UPD)] = np.arange(int(upd.sum()))
    # the slots feeding each column, in ticket order
    upd_dst = col[kind == UPD]
    slot_list = np.argsort(upd_dst, kind="stable").astype(np.int64)
    ptr = np.r_[0, np.cumsum(np.bincount(upd_dst, minlength=nbc))]
    red = kind != UPD
    lo[red], hi[red] = ptr[col[red]], ptr[col[red] + 1]
    op_wait = has_diag[op_src]
    # every wait points at a smaller ticket
    ticket = np.arange(kind.size)
    owner = np.full(nbc, -1, np.int64)
    owner[col[red]] = ticket[red]
    op_item = np.repeat(ticket[kind == UPD], (hi - lo)[kind == UPD])
    if (np.unique(col[red]).size != red.sum()
            or (owner[upd_dst] <= ticket[kind == UPD]).any()
            or (owner[op_src[op_wait]] >= op_item[op_wait]).any()):
        raise RuntimeError("K2's work items are not in a topological order")
    nops = (hi - lo)[kind == UPD]
    return {"item": np.stack([kind, col, lo, hi, slot], axis=1),
            "slot_list": slot_list, "op_tile": op_tile, "op_src": op_src,
            "op_wait": op_wait.astype(np.int64), "nslot": int(upd.sum()),
            "ops_max": int(nops.max()) if nops.size else 0}


def sweep_direction(phases, nbc, device, ops=4):
    """One direction's tables on ``device`` from its phases in execution
    order, each ``("diag", cols)`` or ``("upd", tile, src, dst)`` (numpy
    int64): the twin's :class:`SweepPhase` list (an update phase's ops
    sorted by dst, stable) and K2's :class:`SweepItems` (a dst's ops in a
    phase cut into sub-segments of at most ``ops``), from one upload."""
    parts, meta, item_phases = [], [], []
    for ph in phases:
        if ph[0] == "diag":
            meta.append(("diag", len(parts)))
            parts.append(ph[1])
            item_phases.append(ph)
            continue
        tile, src, dst = ph[1:]
        o = np.argsort(dst, kind="stable")
        d = dst[o]
        starts = np.flatnonzero(np.r_[True, d[1:] != d[:-1]])
        lens = np.diff(np.r_[starts, d.size])
        nsub = -(-lens // ops)
        # sub-segment j of dst s starts at op starts[s] + j * ops
        first_sub = np.repeat(np.cumsum(nsub) - nsub, nsub)
        sub_starts = (np.repeat(starts, nsub)
                      + (np.arange(nsub.sum()) - first_sub) * ops)
        meta.append(("upd", len(parts)))
        parts += [tile[o], src[o], d]
        item_phases.append(("upd", np.r_[sub_starts, d.size], *parts[-3:]))
    items = sweep_items(item_phases, nbc)
    names = ("item", "slot_list", "op_tile", "op_src", "op_wait")
    parts += [items[f].ravel() for f in names]
    flat = torch.as_tensor(
        np.concatenate(parts) if parts else np.empty(0, np.int64),
        device=device,
    )
    views = list(torch.split(flat, [p.size for p in parts]))
    out = []
    for kind, i in meta:
        if kind == "diag":
            out.append(SweepPhase(kind, cols=views[i]))
        else:
            out.append(SweepPhase(kind, None, *views[i:i + 3]))
    tabs = dict(zip(names, views[len(views) - len(names):]))
    tabs["item"] = tabs["item"].view(-1, 5)
    return out, SweepItems(**tabs, nslot=items["nslot"],
                           ops_max=items["ops_max"])


def sweep_plan(layout, device):
    """Per-direction lists of :class:`SweepPhase` (the twin's tables) and
    :class:`SweepItems` (K2's, under ``plan["items"]``) on ``device``.

    The ops come from :func:`build_sweep_schedule` with its pads (dst ==
    nbc) dropped; int64 tables throughout; an update item holds at most
    ``_OPS_PER_ITEM`` ops of its direction."""
    sched = build_sweep_schedule(layout)
    nbc = sched["nbc"]
    offs = sweep_phase_offsets(layout)
    plan = {"nbc": nbc, "T": sched["T"], "items": {}}
    for key in ("fwd", "bwd"):
        flat = {
            f: np.concatenate([c[f] for c in sched[key]]).astype(np.int64)
            for f in ("tidx", "src", "dst")
        }
        real = flat["dst"] != nbc
        tidx, src, dst = (flat[f][real] for f in ("tidx", "src", "dst"))
        phases = [("diag", dst[lo:hi]) if kind == "diag"
                  else ("upd", tidx[lo:hi], src[lo:hi], dst[lo:hi])
                  for kind, lo, hi in offs[key]]
        plan[key], plan["items"][key] = sweep_direction(
            phases, nbc, device, _OPS_PER_ITEM[key])
    return plan


def _to_rowvec(y: torch.Tensor) -> torch.Tensor:
    """(nbc, T, R) block RHS -> (nbc*R, T) row-vector layout."""
    nbc, T, R = y.shape
    return y.permute(0, 2, 1).reshape(nbc * R, T).contiguous()


def _from_rowvec(y2: torch.Tensor, nbc: int, T: int) -> torch.Tensor:
    R = y2.shape[0] // nbc
    return y2.reshape(nbc, R, T).permute(0, 2, 1)


def _check(pool, dinv, y2, plan):
    nbc, T = plan["nbc"], plan["T"]
    for name, x in (("pool", pool), ("dinv", dinv), ("y2", y2)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if x.device != y2.device:
            raise ValueError(f"{name} is on {x.device}, y2 on {y2.device}")
    if y2.dim() != 2 or y2.shape[1] != T or y2.shape[0] % nbc:
        raise ValueError(
            f"y2 must be (nbc*R, T) = ({nbc}*R, {T}), got {tuple(y2.shape)}"
        )
    if pool.shape[1:] != (T, T) or dinv.shape != (nbc, T, T):
        raise ValueError("pool/dinv tiles do not match the plan")
    return y2.shape[0] // nbc


def _trans(key, lu):
    """(update, diag) phases transposed?  The forward sweep reads tiles
    as stored, the backward sweep transposed; the LU backward sweep
    (U pool, ``dinv_u`` = U⁻¹ of the diagonal) keeps its diagonal
    untransposed (the reference's ``cu=0, cd=1``)."""
    bwd = key == "bwd"
    return int(bwd), int(bwd and not lu)


def run_sweep(pool, dinv, y2, plan, key, lu=False):
    """One sweep of ``y2`` (nbc*R, T) in place; ``key`` "fwd" applies
    L^{-1}, "bwd" applies L^{-T}, or U^{-1} with ``lu`` (``pool`` the Uᵗ
    tiles, ``dinv`` the inverse upper diagonal tiles).  On a CUDA device:
    kernel K2, one persistent launch over the direction's work items
    (``plan["items"][key]``) on the current stream.  On the CPU: the twin
    :func:`run_sweep_ref`."""
    R = _check(pool, dinv, y2, plan)
    if y2.device.type == "cpu":
        return run_sweep_ref(pool, dinv, y2, plan, key, lu)
    if y2.device.type != "cuda":
        raise ValueError(f"unsupported device {y2.device}")
    lib = _build.get_lib()
    stream = _build.stream_ptr(y2.device)
    nbc, T = plan["nbc"], plan["T"]
    it = plan["items"][key]
    trans_upd, trans_diag = _trans(key, lu)
    state = torch.empty(nbc + 1, dtype=torch.int32, device=y2.device)
    partial = torch.empty(max(it.nslot, 1) * R * T, dtype=torch.float32,
                          device=y2.device)
    err = lib.pastix_sweep_run(
        y2.data_ptr(), pool.data_ptr(), dinv.data_ptr(), partial.data_ptr(),
        state.data_ptr(), it.item.data_ptr(), it.slot_list.data_ptr(),
        it.op_tile.data_ptr(), it.op_src.data_ptr(), it.op_wait.data_ptr(),
        it.nitems, nbc, T, R, it.ops_max, trans_upd, trans_diag, stream,
    )
    _build.check(err, f"sweep {key}")
    run_sweep.launches += 1
    return y2


run_sweep.launches = 0  # K2 launches (one per sweep direction)
run_sweep.twin_launches = 0  # calls of the plain twin


def run_sweep_ref(pool, dinv, y2, plan, key, lu=False):
    """Plain PyTorch twin of :func:`run_sweep`, on any device; fp32
    arithmetic, summation order aside the same as the kernel."""
    R = _check(pool, dinv, y2, plan)
    run_sweep.twin_launches += 1
    nbc, T = plan["nbc"], plan["T"]
    Y = y2.view(nbc, R, T)
    # M(i, k) = tile[i, k], or the transpose
    eqs = ("nik,nrk->nri", "nki,nrk->nri")
    trans_upd, trans_diag = _trans(key, lu)
    eq = eqs[trans_upd]
    for ph in plan[key]:
        if ph.kind == "diag":
            Y[ph.cols] = torch.einsum(eqs[trans_diag], dinv[ph.cols],
                                      Y[ph.cols])
            continue
        for lo in range(0, ph.op_tile.numel(), _REF_BATCH):
            sl = slice(lo, lo + _REF_BATCH)
            contrib = torch.einsum(
                eq, pool[ph.op_tile[sl]], Y[ph.op_src[sl]]
            )
            Y.index_add_(0, ph.op_dst[sl], contrib, alpha=-1.0)
    return y2


def sweep_fwd(pool, dinv, y2, plan):
    """y2 <- L^{-1} y2 (row-vector layout), in place."""
    return run_sweep(pool, dinv, y2, plan, "fwd")


def sweep_bwd(pool, dinv, y2, plan, lu=False):
    """Symmetric kinds: y2 <- L^{-T} y2 (row-vector layout), in place.
    LU: y2 <- U^{-1} y2 with ``pool``/``dinv`` the Uᵗ tiles and the
    inverse upper diagonal tiles (updates transposed as stored, the
    diagonal untransposed)."""
    return run_sweep(pool, dinv, y2, plan, "bwd", lu)
