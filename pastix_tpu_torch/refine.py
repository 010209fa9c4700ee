"""Iterative refinement on the host (reference phase 6: pastix_task_raff),
a copy of ``pastix_tpu/refine.py`` (numpy only) with its import path
changed.

Richardson ("simple"/API_RAF_PIVOT), preconditioned CG (API_RAF_GRAD),
GMRES(m) (API_RAF_GMRES) and BiCGStab (API_RAF_BICGSTAB) with the factored
solve as the preconditioner — reference ``src/sopalin/src/raff.c`` +
``gmres_smp``/``grad_smp``/``pivot_smp`` (SURVEY.md section 2 row 14, call
stack 3.5).

``Pastix.solve`` runs this loop when ``device_refine`` or ``fast_solve`` is
off, and to finish a device loop that stopped above ``refinement_eps``;
``solve_with_schur`` polishes with ``refine_block``.  The factored solve
is fp32 on the device while residuals are accumulated at ``dtype``
(``residual_dtype`` and the matrix's, fp64 by default).  Stopping:
``eps`` = DPARM_EPSILON_REFINEMENT, ``itermax`` = IPARM_ITERMAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from pastix_tpu_torch.config import RefinementMethod


@dataclasses.dataclass
class RefineResult:
    x: np.ndarray
    iterations: int
    residual: float
    converged: bool
    history: list


def refine(
    matvec: Callable[[np.ndarray], np.ndarray],
    precond: Callable[[np.ndarray], np.ndarray],
    b: np.ndarray,
    x0: np.ndarray,
    method: RefinementMethod = RefinementMethod.SIMPLE,
    eps: float = 1e-10,
    itermax: int = 250,
    gmres_restart: int = 30,
    dtype=np.float64,
) -> RefineResult:
    """Refine x0 so that ||b - A x|| / ||b|| <= eps.

    ``matvec`` applies A at ``dtype`` precision; ``precond`` applies the
    factored solve (any precision).  All vectors are in the permuted order.
    """
    b = np.asarray(b, dtype=dtype)
    x = np.asarray(x0, dtype=dtype).copy()
    if b.ndim == 2:
        # whole-RHS-block refinement: every method shares one factored
        # solve per iteration across all columns (reference raff.c refines
        # the block; per-column scalar recurrences are vectorized over R)
        bnorm = np.linalg.norm(b, axis=0)
        if not bnorm.any():
            return RefineResult(np.zeros_like(b), 0, 0.0, True, [])
        bnorm = np.where(bnorm == 0, 1.0, bnorm)
        if method == RefinementMethod.NONE:
            r = b - matvec(x)
            res = float((np.linalg.norm(r, axis=0) / bnorm).max())
            return RefineResult(x, 0, res, res <= eps, [res])
        if method == RefinementMethod.SIMPLE:
            return refine_block(matvec, precond, b, x, eps, itermax, dtype)
        if method == RefinementMethod.CG:
            return _pcg_block(matvec, precond, b, x, bnorm, eps, itermax,
                              dtype)
        if method == RefinementMethod.GMRES:
            return _gmres_block(matvec, precond, b, x, bnorm, eps, itermax,
                                gmres_restart, dtype)
        if method == RefinementMethod.BICGSTAB:
            return _bicgstab_block(matvec, precond, b, x, bnorm, eps,
                                   itermax, dtype)
        raise ValueError(f"unknown refinement method {method}")
    bnorm = float(np.linalg.norm(b))
    if bnorm == 0.0:
        return RefineResult(np.zeros_like(b), 0, 0.0, True, [])

    if method == RefinementMethod.NONE:
        r = b - matvec(x)
        res = float(np.linalg.norm(r)) / bnorm
        return RefineResult(x, 0, res, res <= eps, [res])

    if method == RefinementMethod.SIMPLE:
        return _richardson(matvec, precond, b, x, bnorm, eps, itermax, dtype)
    if method == RefinementMethod.CG:
        return _pcg(matvec, precond, b, x, bnorm, eps, itermax, dtype)
    if method == RefinementMethod.GMRES:
        return _gmres(matvec, precond, b, x, bnorm, eps, itermax, gmres_restart, dtype)
    if method == RefinementMethod.BICGSTAB:
        return _bicgstab(matvec, precond, b, x, bnorm, eps, itermax, dtype)
    raise ValueError(f"unknown refinement method {method}")


def refine_block(
    matvec,
    precond,
    b: np.ndarray,
    x0: np.ndarray,
    eps: float = 1e-10,
    itermax: int = 250,
    dtype=np.float64,
) -> RefineResult:
    """Richardson refinement on a whole RHS block (n, nrhs) at once.

    One factored solve per iteration refines every column together (the
    batched-update analog of pivot_smp for multiple RHS); stops when the
    worst column residual meets eps.
    """
    b = np.asarray(b, dtype=dtype)
    x = np.asarray(x0, dtype=dtype).copy()
    bnorm = np.linalg.norm(b, axis=0)
    bnorm = np.where(bnorm == 0, 1.0, bnorm)
    hist = []
    for it in range(itermax):
        r = b - matvec(x)
        res = float((np.linalg.norm(r, axis=0) / bnorm).max())
        hist.append(res)
        if res <= eps:
            return RefineResult(x, it, res, True, hist)
        x = x + np.asarray(precond(r), dtype=dtype)
    r = b - matvec(x)
    res = float((np.linalg.norm(r, axis=0) / bnorm).max())
    hist.append(res)
    return RefineResult(x, itermax, res, res <= eps, hist)


def _col_dots(a, b):
    """Per-column inner products: (n, R) x (n, R) -> (R,), conj on a."""
    return np.sum(np.conj(a) * b, axis=0)


def _safe_div(num, den):
    return np.where(np.abs(den) > 0, num / np.where(den == 0, 1, den), 0.0)


def _pcg_block(matvec, precond, b, x, bnorm, eps, itermax, dtype):
    """Preconditioned CG over the whole (n, R) block: one matvec + one
    factored solve per iteration regardless of nrhs; the scalar CG
    recurrences run per column (vectorized over R)."""
    hist = []
    r = b - matvec(x)
    z = np.asarray(precond(r), dtype=dtype)
    p = z.copy()
    rz = _col_dots(r, z)
    for it in range(itermax):
        res = float((np.linalg.norm(r, axis=0) / bnorm).max())
        hist.append(res)
        if res <= eps:
            return RefineResult(x, it, res, True, hist)
        Ap = matvec(p)
        alpha = _safe_div(rz, _col_dots(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = np.asarray(precond(r), dtype=dtype)
        rz_new = _col_dots(r, z)
        p = z + _safe_div(rz_new, rz) * p
        rz = rz_new
    res = float((np.linalg.norm(r, axis=0) / bnorm).max())
    hist.append(res)
    return RefineResult(x, itermax, res, res <= eps, hist)


def _gmres_block(matvec, precond, b, x, bnorm, eps, itermax, m, dtype):
    """Right-preconditioned restarted GMRES(m) over the whole (n, R)
    block: one Arnoldi basis per column, built with SHARED matvec +
    factored-solve calls per inner step; Hessenberg updates and Givens
    rotations run per column (vectorized over R)."""
    n, R = b.shape
    tiny = 1e-300
    hist = []
    it = 0
    while it < itermax:
        r = b - matvec(x)
        beta = np.linalg.norm(r, axis=0)
        res = float((beta / bnorm).max())
        hist.append(res)
        if res <= eps:
            return RefineResult(x, it, res, True, hist)
        V = np.zeros((m + 1, n, R), dtype=dtype)
        H = np.zeros((m + 1, m, R), dtype=dtype)
        cs = np.zeros((m, R), dtype=dtype)
        sn = np.zeros((m, R), dtype=dtype)
        g = np.zeros((m + 1, R), dtype=dtype)
        V[0] = r / np.where(beta < tiny, 1.0, beta)
        g[0] = beta
        k = 0
        for k in range(m):
            w = matvec(np.asarray(precond(V[k]), dtype=dtype))
            for i in range(k + 1):  # modified Gram-Schmidt per column
                hik = _col_dots(V[i], w)
                H[i, k] = hik
                w = w - hik * V[i]
            hk1 = np.linalg.norm(w, axis=0)
            H[k + 1, k] = hk1
            V[k + 1] = w / np.where(hk1 < tiny, 1.0, hk1)
            for i in range(k):
                t = cs[i] * H[i, k] + sn[i] * H[i + 1, k]
                H[i + 1, k] = -np.conj(sn[i]) * H[i, k] + cs[i] * H[i + 1, k]
                H[i, k] = t
            ha, hb = H[k, k].copy(), H[k + 1, k].copy()
            absha, abshb = np.abs(ha), np.abs(hb)
            denom = np.sqrt(absha**2 + abshb**2)
            d_ok, ha_ok = denom >= tiny, absha >= tiny
            sden = np.where(d_ok, denom, 1.0)
            sha = np.where(ha_ok, absha, 1.0)
            shb = np.where(abshb >= tiny, abshb, 1.0)
            cs[k] = np.where(d_ok, np.where(ha_ok, absha / sden, 0.0), 1.0)
            sn[k] = np.where(
                d_ok,
                np.where(
                    ha_ok,
                    (ha / sha) * np.conj(hb) / sden,
                    np.conj(hb) / shb,
                ),
                0.0,
            )
            H[k, k] = cs[k] * ha + sn[k] * hb
            H[k + 1, k] = 0.0
            g[k + 1] = -np.conj(sn[k]) * g[k]
            g[k] = cs[k] * g[k]
            it += 1
            res = float((np.abs(g[k + 1]) / bnorm).max())
            hist.append(res)
            if res <= eps or it >= itermax:
                break
        kk = k + 1
        dx = np.zeros((n, R), dtype=dtype)
        for c in range(R):
            Hc, gc = H[:kk, :kk, c], g[:kk, c]
            try:
                y = np.linalg.solve(Hc, gc)
            except np.linalg.LinAlgError:  # converged/zero column
                y = np.linalg.lstsq(Hc, gc, rcond=None)[0]
            dx[:, c] = V[:kk, :, c].T @ y
        x = x + np.asarray(precond(dx), dtype=dtype)
        if res <= eps:
            # the Arnoldi estimate can lag the true residual when the
            # preconditioner runs in lower precision; only stop on the
            # true residual
            r = b - matvec(x)
            res = float((np.linalg.norm(r, axis=0) / bnorm).max())
            if res <= eps:
                return RefineResult(x, it, res, True, hist)
    r = b - matvec(x)
    res = float((np.linalg.norm(r, axis=0) / bnorm).max())
    return RefineResult(x, it, res, res <= eps, hist)


def _bicgstab_block(matvec, precond, b, x, bnorm, eps, itermax, dtype):
    """BiCGStab over the whole (n, R) block: shared matvec/solve calls,
    per-column scalar recurrences (vectorized over R)."""
    hist = []
    r = b - matvec(x)
    rhat = r.copy()
    R = b.shape[1]
    rho = np.ones(R, dtype=dtype)
    alpha = np.ones(R, dtype=dtype)
    omega = np.ones(R, dtype=dtype)
    v = np.zeros_like(b)
    p = np.zeros_like(b)
    for it in range(itermax):
        res = float((np.linalg.norm(r, axis=0) / bnorm).max())
        hist.append(res)
        if res <= eps:
            return RefineResult(x, it, res, True, hist)
        rho_new = _col_dots(rhat, r)
        if not np.abs(rho_new).any():
            break
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega) \
            if it else np.zeros(R, dtype=dtype)
        p = r + beta * (p - omega * v) if it else r.copy()
        rho = rho_new
        ph = np.asarray(precond(p), dtype=dtype)
        v = matvec(ph)
        alpha = _safe_div(rho, _col_dots(rhat, v))
        s = r - alpha * v
        sh = np.asarray(precond(s), dtype=dtype)
        t = matvec(sh)
        tt = np.real(_col_dots(t, t))
        omega = _safe_div(_col_dots(t, s), tt.astype(dtype))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
    res = float((np.linalg.norm(r, axis=0) / bnorm).max())
    hist.append(res)
    return RefineResult(x, itermax, res, res <= eps, hist)


def _richardson(matvec, precond, b, x, bnorm, eps, itermax, dtype):
    hist = []
    for it in range(itermax):
        r = b - matvec(x)
        res = float(np.linalg.norm(r)) / bnorm
        hist.append(res)
        if res <= eps:
            return RefineResult(x, it, res, True, hist)
        x = x + np.asarray(precond(r), dtype=dtype)
    r = b - matvec(x)
    res = float(np.linalg.norm(r)) / bnorm
    hist.append(res)
    return RefineResult(x, itermax, res, res <= eps, hist)


def _pcg(matvec, precond, b, x, bnorm, eps, itermax, dtype):
    hist = []
    r = b - matvec(x)
    z = np.asarray(precond(r), dtype=dtype)
    p = z.copy()
    rz = np.vdot(r, z)
    for it in range(itermax):
        res = float(np.linalg.norm(r)) / bnorm
        hist.append(res)
        if res <= eps:
            return RefineResult(x, it, res, True, hist)
        Ap = matvec(p)
        alpha = rz / np.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = np.asarray(precond(r), dtype=dtype)
        rz_new = np.vdot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    res = float(np.linalg.norm(r)) / bnorm
    hist.append(res)
    return RefineResult(x, itermax, res, res <= eps, hist)


def _gmres(matvec, precond, b, x, bnorm, eps, itermax, m, dtype):
    """Right-preconditioned restarted GMRES(m)."""
    hist = []
    it = 0
    while it < itermax:
        r = b - matvec(x)
        beta = float(np.linalg.norm(r))
        res = beta / bnorm
        hist.append(res)
        if res <= eps:
            return RefineResult(x, it, res, True, hist)
        V = np.zeros((m + 1, b.shape[0]), dtype=dtype)
        H = np.zeros((m + 1, m), dtype=dtype)
        cs = np.zeros(m, dtype=dtype)
        sn = np.zeros(m, dtype=dtype)
        g = np.zeros(m + 1, dtype=dtype)
        V[0] = r / beta
        g[0] = beta
        k = 0
        for k in range(m):
            w = matvec(np.asarray(precond(V[k]), dtype=dtype))
            for i in range(k + 1):  # modified Gram-Schmidt (conj for complex)
                H[i, k] = np.vdot(V[i], w)
                w = w - H[i, k] * V[i]
            H[k + 1, k] = float(np.linalg.norm(w))
            if abs(H[k + 1, k]) > 1e-300:
                V[k + 1] = w / H[k + 1, k]
            # apply previous Givens rotations (cs real, sn conj'd on the
            # lower row — reduces to the usual real rotations for real data)
            for i in range(k):
                t = cs[i] * H[i, k] + sn[i] * H[i + 1, k]
                H[i + 1, k] = -np.conj(sn[i]) * H[i, k] + cs[i] * H[i + 1, k]
                H[i, k] = t
            ha, hb = H[k, k], H[k + 1, k]
            denom = np.sqrt(abs(ha) ** 2 + abs(hb) ** 2)
            if denom < 1e-300:
                cs[k], sn[k] = 1.0, 0.0
            elif abs(ha) < 1e-300:
                cs[k], sn[k] = 0.0, np.conj(hb) / abs(hb)
            else:
                cs[k] = abs(ha) / denom
                sn[k] = (ha / abs(ha)) * np.conj(hb) / denom
            H[k, k] = cs[k] * ha + sn[k] * hb
            H[k + 1, k] = 0.0
            g[k + 1] = -np.conj(sn[k]) * g[k]
            g[k] = cs[k] * g[k]
            it += 1
            res = abs(g[k + 1]) / bnorm  # |.| of a complex estimate too
            hist.append(res)
            if res <= eps or it >= itermax:
                break
        kk = k + 1
        y = np.linalg.solve(H[:kk, :kk], g[:kk]) if kk else np.zeros(0, dtype)
        dx = V[:kk].T @ y
        x = x + np.asarray(precond(dx), dtype=dtype)
        if res <= eps:
            # the Arnoldi estimate can lag the true residual when the
            # preconditioner runs in lower precision; only stop (and
            # otherwise keep restarting) on the true residual
            r = b - matvec(x)
            res = float(np.linalg.norm(r)) / bnorm
            if res <= eps:
                return RefineResult(x, it, res, True, hist)
    r = b - matvec(x)
    res = float(np.linalg.norm(r)) / bnorm
    return RefineResult(x, it, res, res <= eps, hist)


def _bicgstab(matvec, precond, b, x, bnorm, eps, itermax, dtype):
    hist = []
    r = b - matvec(x)
    rhat = r.copy()
    rho = alpha = omega = 1.0
    v = np.zeros_like(b)
    p = np.zeros_like(b)
    for it in range(itermax):
        res = float(np.linalg.norm(r)) / bnorm
        hist.append(res)
        if res <= eps:
            return RefineResult(x, it, res, True, hist)
        rho_new = np.vdot(rhat, r)
        if abs(rho_new) == 0.0:
            break
        beta = (rho_new / rho) * (alpha / omega) if it else 0.0
        p = r + beta * (p - omega * v) if it else r.copy()
        rho = rho_new
        ph = np.asarray(precond(p), dtype=dtype)
        v = matvec(ph)
        alpha = rho / np.vdot(rhat, v)
        s = r - alpha * v
        sh = np.asarray(precond(s), dtype=dtype)
        t = matvec(sh)
        tt = float(np.real(np.vdot(t, t)))
        omega = np.vdot(t, s) / tt if tt else 0.0
        x = x + alpha * ph + omega * sh
        r = s - omega * t
    res = float(np.linalg.norm(r)) / bnorm
    hist.append(res)
    return RefineResult(x, itermax, res, res <= eps, hist)
