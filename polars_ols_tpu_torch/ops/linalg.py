"""Batched solves of the static fits, with data-dependent fallback.

The JAX engine's ``ops/linalg.py`` as plain torch ops: the batched K <= 32
column-recurrence Cholesky (factor and substitution as O(K) whole-batch
tensor ops) and, above K = 32, the library's batched Cholesky
(``torch.linalg.cholesky_ex`` / ``torch.cholesky_solve``, where the JAX
engine calls ``jnp.linalg.cholesky`` / ``cho_solve``); its squared-pivot
condition estimate and the eigh pseudo-inverse fallback for lanes whose
factor is not finite; the partial-pivot LU of explicit 'lu'; and the SVD
least squares of explicit 'svd' and of multi-target fits (the one-sided
Jacobi SVD of the K x K factor of a Householder reduction,
``ops/jacobi.py``, with numpy lstsq's cutoff; ``_householder_reduce`` is
the plain version of the engine's reduction kernel, ops/householder.py).

Where the JAX engine branches inside the device program with
``lax.cond(ok.all(), ...)``, this module branches in Python on a bool read
from the device. Each such read is a host sync, noted where it happens.
"""

from __future__ import annotations

import torch

from ..config import F64
from .jacobi import factor_lstsq, rows_lstsq

_EPS64 = float(torch.finfo(torch.float64).eps)

# largest K of the column-recurrence Cholesky (the JAX engine's unroll
# limit, ``_UNROLL_MAX_K``); above it the library's batched Cholesky
MAX_K = 32


# lanes per call of the batched eigh: cuSOLVER's batched eigh refused
# batches of 32,768 matrices and more on the H100 (CUSOLVER_STATUS_INVALID_VALUE)
_EIGH_LANES = 1 << 14


def _eigh_chunked(A: torch.Tensor):
    """``torch.linalg.eigh`` of a batch of any size, ``_EIGH_LANES``
    matrices a call."""
    K = A.shape[-1]
    flat = A.reshape(-1, K, K)
    if flat.shape[0] <= _EIGH_LANES:
        return torch.linalg.eigh(A)
    parts = [torch.linalg.eigh(flat[i : i + _EIGH_LANES]) for i in range(0, flat.shape[0], _EIGH_LANES)]
    w = torch.cat([p[0] for p in parts]).reshape(A.shape[:-1])
    v = torch.cat([p[1] for p in parts]).reshape(A.shape)
    return w, v


def eigh_pinv_solve(A: torch.Tensor, b: torch.Tensor, rcond: float | None = None) -> torch.Tensor:
    """Pseudo-inverse solve of symmetric A via eigh, batched.

    Zero (or degenerate) systems get zero (minimum-norm) coefficients,
    since the pseudo-inverse of a zero matrix is zero. A lane whose A is
    not finite (a NaN value under null_policy 'ignore') gets NaN, as
    ``jnp.linalg.eigh`` gives it; ``torch.linalg.eigh`` would raise on it,
    so such lanes are decomposed as zero matrices and then overwritten.
    """
    bad = ~torch.isfinite(A).all(dim=-1).all(dim=-1)
    w, v = _eigh_chunked(torch.where(bad[..., None, None], 0.0, A))
    w = torch.where(bad[..., None], torch.nan, w)
    v = torch.where(bad[..., None, None], torch.nan, v)
    k = A.shape[-1]
    cut = (rcond if rcond is not None else _EPS64 * k) * w.abs().amax(dim=-1, keepdim=True)
    w_inv = torch.where(w.abs() > cut, 1.0 / torch.where(w == 0, 1.0, w), 0.0)
    # A^+ b = V diag(w_inv) V^T b   (b may be [..., K] or [..., K, M])
    if b.dim() == A.dim() - 1:
        vtb = torch.einsum("...ij,...i->...j", v, b)
        return torch.einsum("...ij,...j->...i", v, w_inv * vtb)
    vtb = torch.einsum("...ij,...im->...jm", v, b)
    return torch.einsum("...ij,...jm->...im", v, w_inv[..., None] * vtb)


def chol_factor_vectorized(A: torch.Tensor):
    """Right-looking batched Cholesky in K whole-batch steps: one scaled
    column, one rank-1 update of the trailing matrix and one sqrt each.

    Returns (L [..., K, K] lower triangular with NaN columns on non-PD
    lanes, ok [...] bool finite-factor lanes).
    """
    K = A.shape[-1]
    upper = torch.arange(K, device=A.device)
    S = A
    L_cols = []
    for j in range(K):
        d = torch.sqrt(S[..., j, j])  # NaN/0 on non-PD lanes
        col = S[..., :, j] / torch.where(d == 0, 1.0, d)[..., None]
        col = col * (upper >= j)  # zero above the diagonal
        col = torch.where((d == 0)[..., None], torch.nan, col)
        L_cols.append(col)
        S = S - col[..., :, None] * col[..., None, :]
    L = torch.stack(L_cols, dim=-1)
    ok = torch.isfinite(L).all(dim=-1).all(dim=-1)
    return L, ok


def chol_substitute_vectorized(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Forward + back substitution against a batched lower factor;
    rhs [..., K, M]."""
    K = L.shape[-1]
    z = rhs
    zs = []
    for j in range(K):  # L z = rhs
        zj = z[..., j, :] / L[..., j, j][..., None]
        zs.append(zj)
        z = z - L[..., :, j][..., None] * zj[..., None, :]
    x = torch.stack(zs, dim=-2)
    xs = [None] * K
    for j in range(K - 1, -1, -1):  # L^T x = z
        xj = x[..., j, :] / L[..., j, j][..., None]
        xs[j] = xj
        x = x - L[..., j, :][..., :, None] * xj[..., None, :]
    return torch.stack(xs, dim=-2)


def chol_factor(A: torch.Tensor):
    """(L, ok): the column recurrence up to K = 32, the library's batched
    Cholesky above (the JAX engine's ``chol_factor``). A lane the library
    cannot factor (``info != 0``) gets a NaN factor, as XLA's Cholesky
    gives it, so ``ok`` is false there and its squared pivots are NaN."""
    if A.shape[-1] <= MAX_K:
        return chol_factor_vectorized(A)
    L, info = torch.linalg.cholesky_ex(A)
    ok = (info == 0) & torch.isfinite(L).all(dim=-1).all(dim=-1)
    return torch.where(ok[..., None, None], L, torch.nan), ok


def chol_substitute(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Forward + back substitution against a batched lower factor: the
    vectorized form up to K = 32, ``torch.cholesky_solve`` above."""
    if L.shape[-1] <= MAX_K:
        return chol_substitute_vectorized(L, rhs)
    return torch.cholesky_solve(rhs, L)


def _with_fallback(A, rhs, sol, ok):
    """Failed lanes take the eigh pseudo-solve, computed for those lanes
    only. Host syncs: ``ok.all()`` (the Cholesky solves and ``solve_lu``)
    and, where a lane failed, the selection of the failed lanes."""
    if bool(ok.all()):
        return sol
    return fallback_lanes(A, rhs, sol, ok)


def fallback_lanes(A, rhs, sol, ok):
    """``sol`` with the lanes where ``ok`` is false replaced by the eigh
    pseudo-solve of those lanes alone, for a caller that has read
    ``ok.all()`` itself (engine/batch.py). Host sync: the selection of the
    failed lanes."""
    K, M = A.shape[-1], rhs.shape[-1]
    bad = torch.nonzero(~ok.reshape(-1)).flatten()
    A_bad = A.reshape(-1, K, K).index_select(0, bad)
    rhs_bad = rhs.reshape(-1, K, M).index_select(0, bad)
    out = sol.reshape(-1, K, M).clone()
    out[bad] = eigh_pinv_solve(A_bad, rhs_bad)
    return out.reshape(sol.shape)


def psd_solver(A: torch.Tensor):
    """Factor A once and return ``solve(b)`` for repeated right-hand sides
    (the CSNE sweeps). Failed lanes are identity-substituted so the
    substitution stays finite, then take the eigh fallback on every call.
    Host sync: ``ok.all()``, read once per factor."""
    L, ok = chol_factor(A)
    return psd_solver_from(A, L, ok, bool(ok.all()))


def psd_solver_from(A: torch.Tensor, L: torch.Tensor, ok: torch.Tensor, all_ok: bool):
    """``psd_solver`` on a factor ``(L, ok) = chol_factor(A)`` computed
    already, whose ``ok.all()`` the caller has read (``all_ok``): no host
    sync."""
    k = A.shape[-1]
    Ls = torch.where(ok[..., None, None], L, torch.eye(k, dtype=F64, device=A.device))

    def solve(b: torch.Tensor) -> torch.Tensor:
        rhs = b[..., None] if b.dim() == A.dim() - 1 else b
        sol = chol_substitute(Ls, rhs)
        sol = torch.where(torch.isfinite(sol), sol, 0.0)
        if not all_ok:
            sol = torch.where(ok[..., None, None], sol, eigh_pinv_solve(A, rhs))
        return sol[..., 0] if b.dim() == A.dim() - 1 else sol

    return solve


def chol_solve(A: torch.Tensor, rhs: torch.Tensor):
    """(sol, ok, L): the Cholesky solve of ``A x = rhs`` (rhs [..., K, M]),
    zero where not finite, with the failed lanes not yet replaced; the
    finite-factor lanes; the factor. Reads nothing from the device: the
    caller applies ``fallback_lanes`` where ``ok`` is not all true. Each
    lane's bits do not depend on the batch up to K = 32 (the column
    recurrence is elementwise across lanes)."""
    L, ok = chol_factor(A)
    sol = chol_substitute(L, rhs)
    return torch.where(torch.isfinite(sol), sol, 0.0), ok, L


def cond_estimate(L: torch.Tensor) -> torch.Tensor:
    """The squared ratio of extreme Cholesky pivots ``(max_j L_jj / min_j
    L_jj)^2`` of each lane, a lower bound on cond_2(A); 1 on failed lanes."""
    d2 = torch.square(torch.diagonal(L, dim1=-2, dim2=-1))
    finite = torch.isfinite(d2) & (d2 > 0)
    dmax = torch.where(finite, d2, 0.0).amax(dim=-1)
    dmin = torch.where(finite, d2, torch.inf).amin(dim=-1)
    return torch.where(finite.all(dim=-1), dmax / dmin.clamp_min(1e-300), 1.0)


def _solve_psd_inner(A: torch.Tensor, rhs: torch.Tensor):
    """(sol, ok, L): the solve with its fallback, the finite-factor lanes
    and the factor."""
    sol, ok, L = chol_solve(A, rhs)
    return _with_fallback(A, rhs, sol, ok), ok, L


def solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky solve of PSD systems with eigh-pinv fallback."""
    rhs = b[..., None] if b.dim() == A.dim() - 1 else b
    out, _, _ = _solve_psd_inner(A, rhs)
    return out[..., 0] if b.dim() == A.dim() - 1 else out


def solve_psd_cond(A: torch.Tensor, b: torch.Tensor):
    """solve_psd plus the per-lane condition estimate (solve_psd_cond_ok)."""
    sol, cond_est, _ = solve_psd_cond_ok(A, b)
    return sol, cond_est


def solve_psd_cond_ok(A: torch.Tensor, b: torch.Tensor):
    """solve_psd plus a cheap per-lane condition estimate of A: the squared
    ratio of extreme Cholesky pivots ``(max_j L_jj / min_j L_jj)^2``, a
    lower bound on cond_2(A). Failed lanes (eigh fallback) report 1.

    Returns (solution, cond_est [...], chol_ok [...]).
    """
    rhs = b[..., None] if b.dim() == A.dim() - 1 else b
    out, ok, L = _solve_psd_inner(A, rhs)
    sol = out[..., 0] if b.dim() == A.dim() - 1 else out
    return sol, cond_estimate(L), ok


def _sign(x: torch.Tensor) -> torch.Tensor:
    """+1 where x >= 0 (zero included), else -1, in x's dtype (a bare
    ``torch.where`` of two Python floats would be float32)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


# --------------------------------------------------------------------------- #
# partial-pivot LU (explicit solve_method='lu')
# --------------------------------------------------------------------------- #
def _lu_solve_vectorized(A: torch.Tensor, rhs: torch.Tensor):
    """Batched partial-pivot LU solve in K whole-batch elimination steps.

    The JAX engine extracts the pivot row with a one-hot multiply and sum
    (f64 gathers were slow on its TPU); here that row is a gather. The
    swap's rank-1 corrections, the elimination, the in-place multipliers
    and the substitutions are the JAX engine's.

    Args:
        A: [..., K, K] general square (no symmetry assumed).
        rhs: [..., K, M].
    Returns:
        (solution [..., K, M], ok [...] bool lanes with finite nonzero pivots)
    """
    K = A.shape[-1]
    rows = torch.arange(K, device=A.device)
    S, B = A, rhs
    inv_d = []  # [...] reciprocal pivots
    min_abs_d = None
    for j in range(K):
        # partial pivot: largest |S[i, j]| over i >= j (first on ties)
        mag = torch.where(rows >= j, S[..., :, j].abs(), -1.0)
        p = mag.argmax(dim=-1, keepdim=True)  # [..., 1]
        # swap rows j <-> p as S + (1_j - 1_p)(S[p] - S[j])', the JAX
        # engine's arithmetic (its rounding, so the two agree to the last
        # bits on ill-conditioned lanes). The multipliers live below the
        # diagonal of S, so the swap carries the finished L rows along, as
        # a pivot array would
        swap = (rows == j).to(S.dtype) - (rows == p).to(S.dtype)  # [..., K]
        for_p = p[..., None].expand(*p.shape[:-1], 1, K)
        S = S + swap[..., :, None] * (torch.take_along_dim(S, for_p, dim=-2) - S[..., j : j + 1, :])
        for_p = p[..., None].expand(*p.shape[:-1], 1, B.shape[-1])
        B = B + swap[..., :, None] * (torch.take_along_dim(B, for_p, dim=-2) - B[..., j : j + 1, :])
        d = S[..., j, j]
        dj = torch.where(d == 0, torch.nan, 1.0 / torch.where(d == 0, 1.0, d))
        col = S[..., :, j] * dj[..., None] * (rows > j)
        pivrow = S[..., j, :] * (rows >= j)
        # eliminate below the diagonal and store the multipliers there
        S = S - col[..., :, None] * (pivrow[..., None, :] - (rows == j).to(S.dtype))
        inv_d.append(dj)
        ad = d.abs()
        min_abs_d = ad if min_abs_d is None else torch.minimum(min_abs_d, ad)
    # S holds U on and above the diagonal, L's multipliers below it
    U = S * (rows[:, None] <= rows[None, :])
    L = S * (rows[:, None] > rows[None, :])
    ok = torch.isfinite(S).all(dim=-1).all(dim=-1) & (min_abs_d > 0)
    z = B  # forward substitution, unit lower
    zs = []
    for j in range(K):
        zj = z[..., j, :]
        zs.append(zj)
        z = z - L[..., :, j][..., None] * zj[..., None, :]
    x = torch.stack(zs, dim=-2)  # back substitution, U x = z
    xs = [None] * K
    for j in range(K - 1, -1, -1):
        xj = x[..., j, :] * inv_d[j][..., None]
        xs[j] = xj
        x = x - U[..., :, j][..., :, None] * xj[..., None, :]
    return torch.stack(xs, dim=-2), ok


def solve_lu(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched partial-pivot LU solve with the eigh pseudo-solve on lanes
    whose pivots are not finite and nonzero (the reference's fallback
    chain, src/least_squares.rs:264-328). Host sync: ``ok.all()``."""
    rhs = b[..., None] if b.dim() == A.dim() - 1 else b
    sol, ok = lu_solve(A, rhs)
    out = _with_fallback(A, rhs, sol, ok)
    return out[..., 0] if b.dim() == A.dim() - 1 else out


def lu_solve(A: torch.Tensor, rhs: torch.Tensor):
    """(sol, ok): the LU solve (rhs [..., K, M]), zero where not finite,
    the failed lanes not yet replaced; reads nothing from the device (the
    counterpart of ``chol_solve``). Each lane's bits do not depend on the
    batch."""
    sol, ok = _lu_solve_vectorized(A, rhs)
    return torch.where(torch.isfinite(sol), sol, 0.0), ok


# --------------------------------------------------------------------------- #
# Householder reduction and SVD least squares (explicit solve_method='svd')
# --------------------------------------------------------------------------- #
def _householder_reduce(X: torch.Tensor, Y: torch.Tensor):
    """Batched Householder reduction X = Q [R; 0]: returns (R [..., K, K]
    upper triangular, Q^T Y [..., K, M]) from X [..., N, K], Y [..., N, M].

    K reflections as whole-batch ops. Zero (masked or padding) rows are
    genuine zero observations; a zero pivot column makes its reflection the
    identity and leaves a zero on R's diagonal for the rank cutoff. (The
    JAX engine hands K > 32 to XLA's QR for its TPU's sake; the port's
    fits stop at K = 32.)"""
    K = X.shape[-1]
    rows = torch.arange(X.shape[-2], device=X.device)
    A, B = X, Y
    for j in range(K):
        col = A[..., :, j] * (rows >= j)
        sigma = (col * col).sum(dim=-1, keepdim=True)
        cj = A[..., j, j][..., None]
        alpha = -_sign(cj) * torch.sqrt(sigma)
        v = torch.where(rows == j, col - alpha, col)
        denom = sigma - cj * alpha  # = ||v||^2 / 2
        beta = torch.where(denom > 0, 1.0 / denom, 0.0)
        bv = beta[..., None] * v[..., :, None]
        A = A - bv * torch.einsum("...r,...rk->...k", v, A)[..., None, :]
        B = B - bv * torch.einsum("...r,...rm->...m", v, B)[..., None, :]
    return A[..., :K, :], B[..., :K, :]


def svd_lstsq_from_factor(
    R: torch.Tensor,
    QtY: torch.Tensor,
    n_valid: torch.Tensor,
    alpha: float = 0.0,
    rcond: float | None = None,
) -> torch.Tensor:
    """Minimum-norm (ridge-shrunk) least squares from a Householder
    reduction X = Q [R; 0]: the SVD of the K x K factor ``R [G, K, K]``
    has X's singular values, and ``Q^T Y [G, K, M]`` carries the targets.

    The reference's ``solve_ridge_svd`` (src/least_squares.rs:106-168):
    singular values at or below ``rcond * sigma_max`` are cut (numpy's
    default ``rcond = eps * max(n_valid, k)``, per problem) and the rest
    shrunk by ``sigma / (sigma^2 + alpha)``, through the one-sided Jacobi
    SVD of ``ops/jacobi.py`` (its kernel on CUDA tensors). Returns beta
    [G, K, M]."""
    return factor_lstsq(R, QtY, n_valid.to(F64), alpha, rcond)


def svd_lstsq(
    X: torch.Tensor,
    y: torch.Tensor,
    alpha: float = 0.0,
    rcond: float | None = None,
    n_valid: torch.Tensor | None = None,  # [...] valid rows per problem
) -> torch.Tensor:
    """Minimum-norm (ridge-shrunk) least squares via SVD, batched.

    Tall problems (N > K) take ``_householder_reduce`` and
    ``svd_lstsq_from_factor``; square ones the Jacobi SVD of X itself; wide
    ones (N < K) that of X padded with zero rows to K (the same V and
    singular values) up to K = 32, and above it the Jacobi rotations of the
    N columns of X^T (``ops/jacobi.py:rows_lstsq``), whose work scales with
    N, not K. The cutoff is numpy's ``eps * max(n, k)``, with each
    problem's own count of valid rows for n where ``n_valid`` is given.

    Args:
        X: [..., N, K] (zero rows are masked out).
        y: [..., N] or [..., N, M].
    """
    n, k = X.shape[-2], X.shape[-1]
    squeeze = y.dim() == X.dim() - 1
    Y = y[..., None] if squeeze else y
    batch = X.shape[:-2]
    if n_valid is None:
        n_valid = torch.full(batch, float(n), dtype=F64, device=X.device)
    if n > k:
        X, Y = _householder_reduce(X, Y)
    elif n < k and k > MAX_K:
        beta = rows_lstsq(
            X.reshape(-1, n, k).mT, Y.reshape(-1, n, Y.shape[-1]), n_valid.to(F64).reshape(-1), alpha, rcond
        ).reshape(*batch, k, Y.shape[-1])
        return beta[..., 0] if squeeze else beta
    elif n < k:
        X = torch.cat([X, X.new_zeros((*batch, k - n, k))], dim=-2)
        Y = torch.cat([Y, Y.new_zeros((*batch, k - n, Y.shape[-1]))], dim=-2)
    beta = factor_lstsq(
        X.reshape(-1, k, k), Y.reshape(-1, k, Y.shape[-1]), n_valid.to(F64).reshape(-1), alpha, rcond
    ).reshape(*batch, k, Y.shape[-1])
    return beta[..., 0] if squeeze else beta
