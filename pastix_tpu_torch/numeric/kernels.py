"""Batched dense tile operations (PyTorch counterpart of
``pastix_tpu/numeric/kernels.py``).

Every function takes and returns tensors on the caller's device, in the
tiles' own dtype: float32, float64, complex64 or complex128 (the
reference's s/d/c/z arithmetics are one code path, as there).
``hermitian`` picks conjugated transposes (LLᴴ, LDLᴴ) over the plain
transposes of real and complex-symmetric factorizations; on real tiles it
changes nothing.  fp32 and complex64 matmuls run in true fp32 inside the
``Pastix`` phases (``_device.pin_precision`` turns TF32 off around them).
``ldlt_batch`` and ``getrf_batch`` are the plain twins of kernel K4
(``numeric/tile_factor.py``) on fp32 tiles and the DIAG of every other
pool; ``chol_inv_batch`` is that of K7 and K8 (``numeric/chol_inv.py``):
T-step loops of batched tensor operations, as the reference's
``lax.fori_loop``s are.
"""

from __future__ import annotations

import numpy as np
import torch

# gathered E2 operands a chunk of gemm_scatter may hold (a and b tiles):
# bounds the (chunk, T, T) transients, as the reference's _GEMM_CHUNK
# does by count
GATHER_BYTES = 256 << 20


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def chunk_len(pool: torch.Tensor) -> int:
    """Triples per chunk of :func:`gemm_scatter_ab` on ``pool``: their a
    and b tiles hold at most ``GATHER_BYTES``."""
    T = pool.shape[-1]
    return max(1, GATHER_BYTES // (2 * T * T * pool.element_size()))


def conj_if(x: torch.Tensor, hermitian: bool) -> torch.Tensor:
    """``x`` conjugated when ``hermitian`` and complex (the reference's
    ``_conj``)."""
    return x.conj() if hermitian and x.is_complex() else x


def op_t(x: torch.Tensor, hermitian: bool) -> torch.Tensor:
    """The batched transpose of the kind: ``xᴴ`` (``hermitian``) or
    ``xᵗ``."""
    return conj_if(x, hermitian).transpose(-1, -2)


def potrf_batch(tiles: torch.Tensor, hermitian: bool = True) -> torch.Tensor:
    """Batched lower Cholesky of (B, T, T) tiles; only the lower triangle
    of each tile is read (reference ``potrf_batch``).

    ``hermitian`` (or real tiles): A = L Lᴴ through ``cholesky_ex``, which
    reports a breakdown through ``info`` without a host sync; a broken
    tile becomes NaN, as ``lax.linalg.cholesky`` returns it in the
    reference, so one NaN check after the whole factorization finds it
    (``pastix_tpu/numeric/factorize.py`` ``factorize``).  Complex tiles
    without ``hermitian``: the unconjugated A = L Lᵗ of
    :func:`potrf_sym_batch`."""
    if not hermitian and tiles.is_complex():
        return potrf_sym_batch(tiles)
    L, info = torch.linalg.cholesky_ex(tiles)
    return torch.where((info != 0)[:, None, None], torch.nan, L)


def potrf_sym_batch(tiles: torch.Tensor) -> torch.Tensor:
    """Unconjugated Cholesky A = L Lᵗ of complex-symmetric (B, T, T)
    tiles, reading the lower triangle: a T-step loop with the complex
    square root (reference ``_potrf_sym_single``; ``cholesky_ex`` is
    Hermitian only).  Returns L, zeros above the diagonal.  In place on
    a copy, three launches a step (the loops of this module run on the
    card too, where each launch costs the host more than the card)."""
    M = torch.tril(tiles)
    for j in range(M.shape[1]):
        piv = M[:, j, j]
        piv.sqrt_()
        col = M[:, j + 1:, j]
        col.div_(piv[:, None])
        M[:, j + 1:, j + 1:].addcmul_(col[:, :, None], col[:, None, :],
                                      value=-1)
    return M.tril()


def tri_inv_batch(L: torch.Tensor, upper: bool = False,
                  unit: bool = False) -> torch.Tensor:
    """Batched inverse of triangular (B, T, T) tiles: the lower triangle
    (default) or the upper one; ``unit`` takes the diagonal as ones and
    reads only the strict triangle (the unit L of a combined LU tile)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(
        L, eye.expand_as(L), upper=upper, unitriangular=unit
    )


def chol_inv_batch(tiles: torch.Tensor):
    """Batched lower Cholesky and its inverse of (B, T, T) tiles in one
    T-step loop, reading only the lower triangle of each tile: step j
    forms column j of L (left-looking) and row j of X = L⁻¹.  Returns (L,
    X), both lower triangular with zeros above.  A tile that is not
    positive definite turns NaN, as ``potrf_batch`` makes it.

    The reference's ``chol_inv_batch`` (``pastix_tpu/numeric/kernels.py``,
    real dtypes), and the plain twin of kernels K7 and K8
    (``numeric/chol_inv.py``)."""
    B, T, _ = tiles.shape
    L = torch.zeros_like(tiles)
    X = torch.zeros_like(tiles)
    for j in range(T):
        Lrow = L[:, j, :j]
        col = tiles[:, j:, j] - torch.einsum("bik,bk->bi", L[:, j:, :j], Lrow)
        piv = torch.sqrt(col[:, 0])
        L[:, j, j] = piv
        L[:, j + 1:, j] = col[:, 1:] / piv[:, None]
        s2 = torch.einsum("bk,bkt->bt", Lrow, X[:, :j, :])
        s2[:, j] -= 1.0
        X[:, j, :] = -s2 / piv[:, None]
    return L, X


def clamp_pivot(piv: torch.Tensor, eps, small=None):
    """Static pivoting: ``|piv| < eps`` is clamped to magnitude ``eps``,
    by the sign of a real ``piv`` (``+eps`` for 0) or along the phase of
    a complex one (``+eps`` for 0).  ``eps`` is a float or a 0-d tensor
    of ``piv``'s real dtype; ``small``, if given, a bool tensor that
    receives the mask.  Returns (clamped, small); the reference's
    ``_clamp_pivot``."""
    if not torch.is_tensor(eps):
        eps = piv.new_full((), eps, dtype=piv.dtype.to_real())
    mag = piv.abs()
    small = torch.lt(mag, eps, out=small)
    if piv.is_complex():
        unit = torch.where(mag > 0, torch.sgn(piv), 1.0)  # piv / |piv|
        return torch.where(small, eps * unit, piv), small
    return torch.where(small, torch.where(piv >= 0, eps, -eps), piv), small


def sym_lower(tiles: torch.Tensor, hermitian: bool = False) -> torch.Tensor:
    """The full symmetric (or Hermitian) tiles of lower-stored ones (the
    reference's ``_sym_lower``)."""
    return torch.tril(tiles) + op_t(torch.tril(tiles, -1), hermitian)


def ldlt_batch(tiles: torch.Tensor, eps: float, hermitian: bool = False):
    """Unpivoted LDLᵗ (LDLᴴ with ``hermitian``) of (B, T, T) tiles with
    static pivoting, reading the lower triangle of each (the reference's
    ``_sym_lower`` then ``ldlt_batch``).  LDLᴴ takes the real part of each
    pivot, so its d is real (held in the tiles' dtype, as there).
    Returns (L unit lower with zeros above, d (B, T), number of clamped
    pivots as a 0-d int32 tensor).  The tile becomes L below its
    diagonal and d on it, in place on a copy."""
    B, T, _ = tiles.shape
    herm = hermitian and tiles.is_complex()
    M = sym_lower(tiles, herm)
    eps = M.new_full((), eps, dtype=M.dtype.to_real())
    small = torch.empty((B, T), dtype=torch.bool, device=M.device)
    for j in range(T):
        piv = M[:, j, j]
        if herm:
            piv.imag.zero_()  # LDLᴴ pivots are real
        piv.copy_(clamp_pivot(piv, eps, small[:, j])[0])
        col = M[:, j + 1:, j]
        # the trailing update col (row j or conj(col)) / pivot
        row = col.conj_physical() if herm else M[:, j, j + 1:]
        col.div_(piv[:, None])
        M[:, j + 1:, j + 1:].addcmul_(col[:, :, None], row[:, None, :],
                                      value=-1)
    d = M.diagonal(dim1=1, dim2=2).clone()
    L = M.tril(-1)
    L.diagonal(dim1=1, dim2=2).fill_(1.0)
    return L, d, small.sum(dtype=torch.int32)


def getrf_batch(tiles: torch.Tensor, eps: float):
    """Unpivoted LU of (B, T, T) tiles with static pivoting, real or
    complex (no conjugation: reference ``getrf_batch``).  Returns (the
    combined tile: unit L strictly below the diagonal, U on and above it;
    number of clamped pivots as a 0-d int32 tensor)."""
    M = tiles.clone()
    B, T, _ = M.shape
    eps = M.new_full((), eps, dtype=M.dtype.to_real())
    small = torch.empty((B, T), dtype=torch.bool, device=M.device)
    for j in range(T):
        piv = M[:, j, j]
        piv.copy_(clamp_pivot(piv, eps, small[:, j])[0])
        col = M[:, j + 1:, j]
        col.div_(piv[:, None])
        M[:, j + 1:, j + 1:].addcmul_(col[:, :, None], M[:, None, j, j + 1:],
                                      value=-1)
    return M, small.sum(dtype=torch.int32)


def trsm_llt(panels: torch.Tensor, diags: torch.Tensor,
             hermitian: bool = True) -> torch.Tensor:
    """X op(L)ᵗ = A(I, J) -> L(I, J), op = conj for ``hermitian``: a
    batched right solve with the lower (B, T, T) ``diags`` (reference
    ``trsm_llt``)."""
    return torch.linalg.solve_triangular(op_t(diags, hermitian), panels,
                                         upper=True, left=False)


def trsm_ldlt(panels: torch.Tensor, diags: torch.Tensor, d: torch.Tensor,
              hermitian: bool = False) -> torch.Tensor:
    """X (L D)ᵗ = A(I, J) (ᴴ with ``hermitian``): the unit-lower right
    solve, then the columns divided by the (B, T) pivots ``d`` (reference
    ``trsm_ldlt``)."""
    W = torch.linalg.solve_triangular(op_t(diags, hermitian), panels,
                                      upper=True, left=False,
                                      unitriangular=True)
    return W / d[:, None, :]


def trsm_lu_l(panels: torch.Tensor, diags: torch.Tensor) -> torch.Tensor:
    """L(I, J) = A(I, J) U⁻¹, U the upper triangle of the combined LU
    ``diags`` (reference ``trsm_lu_l``)."""
    return torch.linalg.solve_triangular(diags, panels, upper=True,
                                         left=False)


def trsm_lu_u(panels_t: torch.Tensor, diags: torch.Tensor) -> torch.Tensor:
    """Uᵗ(I, J) = A(J, I)ᵗ L⁻ᵗ, L the unit lower triangle of the combined
    LU ``diags`` (reference ``trsm_lu_u``; no conjugation)."""
    return torch.linalg.solve_triangular(diags.transpose(-1, -2), panels_t,
                                         upper=True, left=False,
                                         unitriangular=True)


def round_to(x: torch.Tensor, update_dtype) -> torch.Tensor:
    """Round real ``x`` to ``update_dtype`` and back to its own dtype.

    A product of two bf16 values is exact in fp32, so a fp32 (or fp64)
    matmul of rounded operands is the bf16-operand, fp32- (fp64-)
    accumulate product of the reference (``preferred_element_type`` the
    pool's dtype).  A bf16 matmul in PyTorch would round its output to
    bf16 on CUDA instead."""
    if update_dtype is None or update_dtype == x.dtype:
        return x
    return x.to(update_dtype).to(x.dtype)


def check_pool(pool: torch.Tensor, name: str = "pool") -> None:
    """The E2 kernels take a contiguous float32 (npool, T, T) pool."""
    if pool.dtype != torch.float32 or pool.dim() != 3 or not (
        pool.is_contiguous() and pool.shape[1] == pool.shape[2]
    ):
        raise ValueError(
            f"{name} must be a contiguous float32 (npool, T, T) tensor, got "
            f"{pool.dtype} {tuple(pool.shape)}"
        )


def check_variant(pool: torch.Tensor, d, src_pool, plan) -> None:
    """The scaled (``d``: contiguous float32 (nbc, T) pivots, and a
    ``plan`` whose chunks carry each pair's source column ``pair_k``) and
    cross-pool (``src_pool``: a pool like ``pool``) operands of K1/K3."""
    if src_pool is not None:
        check_pool(src_pool, "src_pool")
        if src_pool.shape != pool.shape or src_pool.device != pool.device:
            raise ValueError("src_pool must match pool in shape and device")
    if d is not None and (
        d.dtype != torch.float32 or d.dim() != 2 or not d.is_contiguous()
        or d.shape[1] != pool.shape[1] or d.device != pool.device
    ):
        raise ValueError(
            "d must be a contiguous float32 (nbc, T) tensor on the pool's "
            f"device, got {d.dtype} {tuple(d.shape)}"
        )
    if d is not None and any(c.pair_k is None for c in plan):
        raise ValueError("the scaled variant (d) needs a plan built with gk")


def is_bf16(update_dtype) -> bool:
    """Whether an E2 kernel rounds its operands to bf16 (``update_dtype``
    bf16) or multiplies them in fp32 (None or float32)."""
    if update_dtype in (None, torch.float32):
        return False
    if update_dtype == torch.bfloat16:
        return True
    raise ValueError(f"unsupported update dtype {update_dtype}")


def gemm_scatter(pool, ga, gb, gd, update_dtype=None, scale_cols=None,
                 hermitian=False):
    """pool[gd] -= op(pool[ga] diag(scale_cols)) @ op(pool[gb])ᵗ,
    accumulated over duplicate targets, in place; op rounds to
    ``update_dtype`` (after the scaling, as the reference does), and with
    ``hermitian`` the b side is conjugated (LLᴴ, LDLᴴ).

    The plain twin of ``pastix_tpu/numeric/kernels.py`` ``gemm_scatter``;
    ``scale_cols`` (ng, T) is the D of LDLᵗ and LDLᴴ."""
    return gemm_scatter_ab(pool, pool, pool, ga, gb, gd, update_dtype,
                           scale_cols, hermitian)


def gemm_scatter_ab(dst_pool, a_pool, b_pool, ga, gb, gd, update_dtype=None,
                    scale_cols=None, hermitian=False):
    """dst_pool[gd] -= op(a_pool[ga]) @ op(b_pool[gb])ᵗ in place: the LU
    cross-pool update (reference ``gemm_scatter_ab``) and, with one pool,
    :func:`gemm_scatter`.  The triples run in chunks whose gathered
    operands hold at most ``GATHER_BYTES``; products accumulate in the
    pool's dtype.  ``update_dtype`` rounds real operands only (the
    reference's ``astype`` would drop a complex pool's imaginary part)."""
    if update_dtype is not None and dst_pool.is_complex():
        raise ValueError("update_dtype rounds real operands (a complex "
                         "one would lose its imaginary part); a complex "
                         "pool takes none")
    step = chunk_len(dst_pool)
    for lo in range(0, ga.shape[0], step):
        sl = slice(lo, lo + step)
        a = a_pool[ga[sl]]
        if scale_cols is not None:
            a = a * scale_cols[sl, None, :]
        a = round_to(a, update_dtype)
        b = conj_if(round_to(b_pool[gb[sl]], update_dtype), hermitian)
        dst_pool.index_add_(0, gd[sl], torch.bmm(a, b.transpose(1, 2)),
                            alpha=-1.0)
    return dst_pool
