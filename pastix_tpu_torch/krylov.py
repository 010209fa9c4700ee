"""Device iterative refinement (PyTorch counterpart of
``pastix_tpu/krylov.py``'s ``build_device_refine_fn``): Richardson, CG,
BiCGStab and GMRES(m), the factored solve as the preconditioner.

The reference runs a fused fp32 loop plus host fp64 refinement below
``PASTIX_DEVREF_MAX_NBC`` and a two-float step loop above it: the TPU has
no fp64 unit and its remote compiler wedged on the fused program.  The
H100 has native fp64, so the port runs one loop a method: the vectors and
their scalars in fp64 on the device, the residual ``b - A x`` an ELL
gather-and-sum (as the reference's XLA code), the preconditioner
``M^{-1} r`` in fp32 through the two K2 sweeps.  The loop is driven from
the host and reads one flag a step (GMRES: one a step and one a
restart); every scalar stays on the device.

Method map (IPARM_REFINEMENT):
  API_RAF_PIVOT    -> richardson   (simple iterative refinement)
  API_RAF_GRAD     -> cg           (preconditioned conjugate gradient)
  API_RAF_GMRES    -> gmres        (right-preconditioned GMRES(m))
  API_RAF_BICGSTAB -> bicgstab

``build_ell`` is a verbatim copy of the host helper in
``pastix_tpu/krylov.py`` (that module imports JAX).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pastix_tpu_torch.config import RefinementMethod

_TINY = 1e-30  # the reference's guard on divisions (krylov.py)


def build_ell(Acoo, nflat, dtype):
    """COO/CSR -> ELLPACK (cols, vals) numpy arrays, rows padded to the
    max row count.

    The device COO scatter-add SpMV measured 365 ms at the 1M flagship
    (~65 ns/row scatter, the round-2 packed-E2 lesson all over again);
    ELL turns it into one dense gather + reduce (<1 ms): padding slots
    point at column 0 with value 0.
    """
    csr = Acoo.tocsr()
    counts = np.diff(csr.indptr)
    k = max(1, int(counts.max()) if counts.size else 1)
    cols = np.zeros((nflat, k), np.int32)
    vals = np.zeros((nflat, k), dtype)
    r = np.repeat(np.arange(csr.shape[0]), counts)
    offs = np.arange(r.size) - np.repeat(csr.indptr[:-1], counts)
    cols[r, offs] = csr.indices
    vals[r, offs] = csr.data
    return cols, vals


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor):
    """y = A x for ELL ``(cols, vals)`` (nflat, k) and ``x`` (nflat, R)."""
    return (vals[:, :, None] * x[cols]).sum(1)


def _col_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-column inner products: (nflat, R) x (nflat, R) -> (R,)."""
    return (a * b).sum(0)


def _safe_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where |den| > _TINY, else 0 (the reference's guard)."""
    ok = den.abs() > _TINY
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def _healthy(r2: torch.Tensor, bn2: torch.Tensor) -> torch.Tensor:
    """The reference's break in ``cond``: every column finite and below
    1e8 ||b||^2."""
    return torch.isfinite(r2).all() & (r2 < 1e8 * bn2).all()


def build_device_refine_fn(layout, solve_fn, method=RefinementMethod.SIMPLE,
                           restart: int = 30):
    """``fn(factors, cols, vals, b, eps, itermax) -> (x, iters)``.

    ``factors`` is the tuple of the kind's factor tensors that
    ``solve_fn`` takes (``Factors.solve_args``); ``b`` the (nflat, R) fp64
    padded permuted RHS, ``cols``/``vals`` the fp64 ELL matrix of the
    whole ``A_perm`` (unsymmetric for LU), all on one device.  Every
    method starts from x = M^{-1} b and stops when every column has
    ||r||^2 <= eps^2 ||b||^2, or at ``itermax`` steps:

    - Richardson x += M^{-1}(b - A x), also stopping when a step fails to
      cut ||r||^2 by 4 (the reference's stall check, ``krylov.py`` and
      ``pastix.py``);
    - CG and BiCGStab with per-column step lengths (reference ``cg``
      ``krylov.py:268``, ``bicgstab`` ``:307``), also stopping when a
      column is not finite or above 1e8 ||b||^2 (and BiCGStab when every
      rho is below ``_TINY``);
    - right-preconditioned GMRES(``restart``) with one Arnoldi basis and
      one set of Givens rotations a column (``gmres`` ``:360``); a step
      stops the cycle when every column's rotated estimate meets eps, and
      a restart stops the loop when the true residual meets eps, is not
      finite or above 1e8 ||b||^2, or is not half the last restart's.  Unlike the reference's
      fixed cycles of ``restart`` steps, a cycle ends at the step that
      converges and ``iters`` counts Arnoldi steps, as the host loop
      (``refine.py``) counts them.

    ``iters`` counts the method's steps; ``fn.applies`` the
    preconditioner applications (``solve_fn`` calls) of the last call."""
    nbc, T = layout.nbc, layout.T
    method = RefinementMethod(method)
    m = int(restart)

    def fn(factors, cols, vals, b, eps, itermax):
        fn.applies = 0

        def M(r):
            fn.applies += 1
            z = solve_fn(*factors, r.to(torch.float32).view(nbc, T, -1))
            return z.reshape(nbc * T, -1).to(torch.float64)

        A = lambda v: ell_spmv(cols, vals, v)
        return run(M, A, b, float(eps), int(itermax))

    if method == RefinementMethod.SIMPLE:
        def run(M, A, b, eps, itermax):
            eps2 = eps * eps * max(float((b * b).sum()), 1e-300)
            x = M(b)
            r = b - A(x)
            it, prev = 0, math.inf
            while it < itermax:
                r2 = float((r * r).sum())
                if r2 <= eps2 or not r2 < 0.25 * prev:
                    break
                prev = r2
                x += M(r)
                r = b - A(x)
                it += 1
            return x, it
    elif method == RefinementMethod.CG:
        def run(M, A, b, eps, itermax):
            bn2 = _col_dots(b, b).clamp_min(_TINY)
            x = M(b)
            r = b - A(x)
            z = M(r)
            p = z
            rz = _col_dots(r, z)
            it = 0
            while it < itermax:
                r2 = _col_dots(r, r)
                if not bool(((r2 > eps * eps * bn2).any()
                             & _healthy(r2, bn2))):
                    break
                Ap = A(p)
                alpha = _safe_ratio(rz, _col_dots(p, Ap))
                x = x + alpha * p
                r = r - alpha * Ap
                z = M(r)
                rz_new = _col_dots(r, z)
                p = z + _safe_ratio(rz_new, rz) * p
                rz = rz_new
                it += 1
            return x, it
    elif method == RefinementMethod.BICGSTAB:
        def run(M, A, b, eps, itermax):
            bn2 = _col_dots(b, b).clamp_min(_TINY)
            x = M(b)
            r = b - A(x)
            rhat = r
            p = r
            rho = _col_dots(rhat, r)
            it = 0
            while it < itermax:
                r2 = _col_dots(r, r)
                if not bool(((r2 > eps * eps * bn2).any() & _healthy(r2, bn2)
                             & (rho.abs() > _TINY).any())):
                    break
                ph = M(p)
                v = A(ph)
                alpha = _safe_ratio(rho, _col_dots(rhat, v))
                s = r - alpha * v
                sh = M(s)
                t = A(sh)
                omega = _safe_ratio(_col_dots(t, s), _col_dots(t, t))
                x = x + alpha * ph + omega * sh
                r = s - omega * t
                rho_new = _col_dots(rhat, r)
                beta = _safe_ratio(rho_new, rho) * _safe_ratio(alpha, omega)
                p = r + beta * (p - omega * v)
                rho = rho_new
                it += 1
            return x, it
    elif method == RefinementMethod.GMRES:
        def run(M, A, b, eps, itermax):
            R = b.shape[1]
            bnorm = _col_dots(b, b).clamp_min(_TINY).sqrt()
            eps_b = eps * bnorm
            x = M(b)
            it, prev = 0, torch.full_like(bnorm, math.inf)
            while it < itermax:
                r = b - A(x)
                beta = _col_dots(r, r).sqrt()
                if not bool(((beta > eps_b).any()
                             & _healthy(beta * beta, bnorm * bnorm)
                             & (beta / bnorm).amax().lt(
                                 0.5 * (prev / bnorm).amax()))):
                    break
                prev = beta
                V = [r / torch.where(beta > _TINY, beta, 1.0)]
                H = torch.zeros((m, m, R), dtype=b.dtype, device=b.device)
                cs = torch.zeros((m, R), dtype=b.dtype, device=b.device)
                sn = torch.zeros_like(cs)
                g = torch.zeros((m + 1, R), dtype=b.dtype, device=b.device)
                g[0] = beta
                k = 0
                while k < m and it < itermax:
                    w = A(M(V[k]))
                    h = []
                    for vi in V:  # modified Gram-Schmidt, a column each
                        hik = _col_dots(vi, w)
                        w = w - hik * vi
                        h.append(hik)
                    hk1 = _col_dots(w, w).sqrt()
                    V.append(w / torch.where(hk1 > _TINY, hk1, 1.0))
                    for i in range(k):  # the previous rotations
                        h[i], h[i + 1] = (cs[i] * h[i] + sn[i] * h[i + 1],
                                          -sn[i] * h[i] + cs[i] * h[i + 1])
                    den = (h[k] * h[k] + hk1 * hk1).sqrt()
                    cs[k] = torch.where(den > _TINY, _safe_ratio(h[k], den),
                                        1.0)
                    sn[k] = _safe_ratio(hk1, den)
                    h[k] = cs[k] * h[k] + sn[k] * hk1
                    H[:k + 1, k] = torch.stack(h)
                    g[k + 1] = -sn[k] * g[k]
                    g[k] = cs[k] * g[k]
                    k += 1
                    it += 1
                    if bool((g[k].abs() <= eps_b).all()):
                        break
                # R y = g a column; a breakdown column gets a unit pivot
                Rm = H[:k, :k].permute(2, 0, 1)
                diag = Rm.diagonal(dim1=-2, dim2=-1)
                fix = torch.where(diag.abs() > _TINY, 0.0, 1.0)
                Rm = Rm + torch.diag_embed(fix)
                y = torch.linalg.solve_triangular(
                    Rm, g[:k].T.unsqueeze(-1), upper=True)[..., 0]  # (R, k)
                u = torch.einsum("rk,knr->nr", y, torch.stack(V[:k]))
                x = x + M(u)
            return x, it
    else:
        raise ValueError(f"unknown refinement method {method}")

    return fn
