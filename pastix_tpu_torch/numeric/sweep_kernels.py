"""Whole-sweep triangular solve: host schedule and kernel K2.

``build_sweep_schedule`` is a verbatim copy of the host builder in
``pastix_tpu/numeric/sweep_kernels.py`` (that module imports JAX).  Its
chunking drops the level boundaries, which the TPU never needed because
its grid ran in order; :func:`sweep_phase_offsets` recovers them from
``layout.levels`` and :func:`sweep_plan` turns each level's diag and
update phases into the tables the CUDA kernel reads.

``run_sweep`` launches the hand-written CUDA kernel (``csrc/sweep.cu``),
once per level and phase, for tensors on a CUDA device, and its plain twin
``run_sweep_ref`` for tensors on the CPU.
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


# update ops per CTA of K2's first pass: a dst's run of ops is cut into
# sub-segments of at most this many, so a dst with many ops spreads over
# many SMs; the second pass adds the partial sums in a fixed order
_OPS_PER_CTA = 4
# ops per batched product of the plain twin (bounds its transients)
_REF_BATCH = 8192


@dataclasses.dataclass
class SweepPhase:
    """One level phase.  diag: ``cols``.  upd: the phase's ops sorted by
    dst (stable), cut into sub-segments of at most ``_OPS_PER_CTA`` ops
    that never cross a dst."""

    kind: str
    cols: torch.Tensor = None  # diag: [nc] columns
    sub_ptr: torch.Tensor = None  # upd: [nsub + 1] op offsets
    seg_sub_ptr: torch.Tensor = None  # upd: [nseg + 1] sub offsets per dst
    seg_dst: torch.Tensor = None  # upd: [nseg] dst block-row
    op_tile: torch.Tensor = None  # upd: [nop] pool index of the tile
    op_src: torch.Tensor = None  # upd: [nop] src block-row
    op_dst: torch.Tensor = None  # upd: [nop] dst block-row (twin)


def sweep_plan(layout, device):
    """Per-direction lists of :class:`SweepPhase` on ``device``.

    The ops come from :func:`build_sweep_schedule` with its pads (dst ==
    nbc) dropped; int64 tables throughout."""
    sched = build_sweep_schedule(layout)
    nbc = sched["nbc"]
    offs = sweep_phase_offsets(layout)
    plan = {"nbc": nbc, "T": sched["T"]}
    for key in ("fwd", "bwd"):
        ops = {
            f: np.concatenate([c[f] for c in sched[key]]).astype(np.int64)
            for f in ("tidx", "src", "dst")
        }
        real = ops["dst"] != nbc
        tidx, src, dst = (ops[f][real] for f in ("tidx", "src", "dst"))
        # one upload per direction; each phase holds views into it
        parts, meta = [], []
        for kind, lo, hi in offs[key]:
            if kind == "diag":
                meta.append((kind, len(parts)))
                parts.append(dst[lo:hi])
                continue
            o = np.argsort(dst[lo:hi], kind="stable") + lo
            d = dst[o]
            starts = np.flatnonzero(np.r_[True, d[1:] != d[:-1]])
            lens = np.diff(np.r_[starts, d.size])
            nsub = -(-lens // _OPS_PER_CTA)
            # sub-segment j of dst s starts at op starts[s] + j * _OPS_PER_CTA
            first_sub = np.repeat(np.cumsum(nsub) - nsub, nsub)
            sub_starts = (np.repeat(starts, nsub)
                          + (np.arange(nsub.sum()) - first_sub) * _OPS_PER_CTA)
            meta.append((kind, len(parts)))
            parts += [np.r_[sub_starts, d.size], np.r_[0, np.cumsum(nsub)],
                      d[starts], tidx[o], src[o], d]
        sizes = [p.size for p in parts]
        flat = torch.as_tensor(
            np.concatenate(parts) if parts else np.empty(0, np.int64),
            device=device,
        )
        views = list(torch.split(flat, sizes))
        phases = []
        for kind, i in meta:
            if kind == "diag":
                phases.append(SweepPhase(kind, cols=views[i]))
            else:
                phases.append(SweepPhase(kind, None, *views[i:i + 6]))
        plan[key] = phases
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
    kernel K2, one call per level phase (an update phase is two launches:
    partial sums, then their fixed-order reduction into y), in order on
    the current stream.  On the CPU: the twin :func:`run_sweep_ref`."""
    R = _check(pool, dinv, y2, plan)
    if y2.device.type == "cpu":
        return run_sweep_ref(pool, dinv, y2, plan, key, lu)
    if y2.device.type != "cuda":
        raise ValueError(f"unsupported device {y2.device}")
    lib = _build.get_lib()
    stream = _build.stream_ptr(y2.device)
    T = plan["T"]
    trans_upd, trans_diag = _trans(key, lu)
    nsub_max = max((ph.sub_ptr.numel() - 1 for ph in plan[key]
                    if ph.kind == "upd"), default=0)
    partial = torch.empty(nsub_max * R * T, dtype=torch.float32,
                          device=y2.device)
    for ph in plan[key]:
        if ph.kind == "diag":
            err = lib.pastix_sweep_diag(
                y2.data_ptr(), dinv.data_ptr(), ph.cols.data_ptr(),
                ph.cols.numel(), T, R, trans_diag, stream,
            )
        else:
            err = lib.pastix_sweep_update(
                y2.data_ptr(), pool.data_ptr(), partial.data_ptr(),
                ph.sub_ptr.data_ptr(), ph.seg_sub_ptr.data_ptr(),
                ph.seg_dst.data_ptr(), ph.op_tile.data_ptr(),
                ph.op_src.data_ptr(), ph.sub_ptr.numel() - 1,
                ph.seg_dst.numel(), T, R, trans_upd, stream,
            )
        _build.check(err, f"sweep {key} {ph.kind}")
        run_sweep.launches += 1
    return y2


run_sweep.launches = 0  # K2 launches (one per level phase)
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
