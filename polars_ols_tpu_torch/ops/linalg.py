"""Batched solves of the static fits, with data-dependent fallback.

The JAX engine's ``ops/linalg.py`` as plain torch ops: the batched K <= 32
column-recurrence Cholesky (factor and substitution as O(K) whole-batch
tensor ops), its squared-pivot condition estimate and the eigh
pseudo-inverse fallback for lanes whose factor is not finite; the
partial-pivot LU of explicit 'lu'; and the SVD least squares of explicit
'svd' (Householder reduction to the K x K factor, then one batched
``torch.linalg.svd``, with numpy lstsq's cutoff). The JAX engine's
lane-major Householder + Jacobi form of its grouped fits is not ported:
on the H100 the batched SVD was faster at every measured shape.

Where the JAX engine branches inside the device program with
``lax.cond(ok.all(), ...)``, this module branches in Python on a bool read
from the device. Each such read is a host sync, noted where it happens.
"""

from __future__ import annotations

import torch

from ..config import F64

_EPS64 = float(torch.finfo(torch.float64).eps)

# largest K of the column-recurrence Cholesky (the JAX engine's unroll
# limit); the port has no larger-K factorization yet
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


def _check_k(A: torch.Tensor) -> None:
    if A.shape[-1] > MAX_K:
        raise NotImplementedError(
            f"K={A.shape[-1]} features: the port's Cholesky covers K <= {MAX_K} "
            "(larger K is ROADMAP.md Queue 1 item 12)"
        )


def _with_fallback(A, rhs, sol, ok):
    """Failed lanes take the eigh pseudo-solve, computed for those lanes
    only. Host syncs: ``ok.all()`` (the Cholesky solves and ``solve_lu``)
    and, where a lane failed, the selection of the failed lanes."""
    if bool(ok.all()):
        return sol
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
    _check_k(A)
    k = A.shape[-1]
    L, ok = chol_factor_vectorized(A)
    Ls = torch.where(ok[..., None, None], L, torch.eye(k, dtype=F64, device=A.device))
    all_ok = bool(ok.all())

    def solve(b: torch.Tensor) -> torch.Tensor:
        rhs = b[..., None] if b.dim() == A.dim() - 1 else b
        sol = chol_substitute_vectorized(Ls, rhs)
        sol = torch.where(torch.isfinite(sol), sol, 0.0)
        if not all_ok:
            sol = torch.where(ok[..., None, None], sol, eigh_pinv_solve(A, rhs))
        return sol[..., 0] if b.dim() == A.dim() - 1 else sol

    return solve


def _solve_psd_inner(A: torch.Tensor, rhs: torch.Tensor):
    """(sol, ok, d2): the solve, the finite-factor lanes and the squared
    Cholesky pivots L_jj^2 (NaN on failed lanes) from the same factor."""
    _check_k(A)
    L, ok = chol_factor_vectorized(A)
    sol = chol_substitute_vectorized(L, rhs)
    sol = torch.where(torch.isfinite(sol), sol, 0.0)
    out = _with_fallback(A, rhs, sol, ok)
    d2 = torch.square(torch.diagonal(L, dim1=-2, dim2=-1))
    return out, ok, d2


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
    out, ok, d2 = _solve_psd_inner(A, rhs)
    finite = torch.isfinite(d2) & (d2 > 0)
    dmax = torch.where(finite, d2, 0.0).amax(dim=-1)
    dmin = torch.where(finite, d2, torch.inf).amin(dim=-1)
    cond_est = torch.where(finite.all(dim=-1), dmax / dmin.clamp_min(1e-300), 1.0)
    sol = out[..., 0] if b.dim() == A.dim() - 1 else out
    return sol, cond_est, ok


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
    _check_k(A)
    rhs = b[..., None] if b.dim() == A.dim() - 1 else b
    sol, ok = _lu_solve_vectorized(A, rhs)
    sol = torch.where(torch.isfinite(sol), sol, 0.0)
    out = _with_fallback(A, rhs, sol, ok)
    return out[..., 0] if b.dim() == A.dim() - 1 else out


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


def _default_rcond(n: int, k: int, n_valid):
    """numpy lstsq's cutoff eps * max(n, k), with each problem's own count
    of valid rows where given (not the padded row count)."""
    if n_valid is None:
        return _EPS64 * max(n, k)
    return _EPS64 * torch.clamp(n_valid.to(F64), min=float(k))


def _svd_nan_lanes(M: torch.Tensor):
    """torch.linalg.svd of a batch, NaN on lanes whose M is not finite (as
    ``jnp.linalg.svd`` gives them; torch's would raise)."""
    bad = ~torch.isfinite(M).all(dim=-1).all(dim=-1)
    u, s, vt = torch.linalg.svd(torch.where(bad[..., None, None], 0.0, M), full_matrices=False)
    nan2 = bad[..., None, None]
    return (
        torch.where(nan2, torch.nan, u),
        torch.where(bad[..., None], torch.nan, s),
        torch.where(nan2, torch.nan, vt),
    )


def svd_lstsq(
    X: torch.Tensor,
    y: torch.Tensor,
    alpha: float = 0.0,
    rcond: float | None = None,
    n_valid: torch.Tensor | None = None,  # [...] valid rows per problem
) -> torch.Tensor:
    """Minimum-norm (ridge-shrunk) least squares via SVD, batched.

    The reference's ``solve_ridge_svd`` (src/least_squares.rs:106-168):
    singular values at or below ``rcond * sigma_max`` are cut (numpy's
    default ``rcond = eps * max(n, k)``, per problem with ``n_valid``) and
    the rest shrunk by ``sigma / (sigma^2 + alpha)``. Tall problems take
    the SVD of the K x K factor of a Householder reduction, which keeps the
    singular values.

    Args:
        X: [..., N, K] (zero rows are masked out).
        y: [..., N] or [..., N, M].
    """
    n, k = X.shape[-2], X.shape[-1]
    squeeze = y.dim() == X.dim() - 1
    Y = y[..., None] if squeeze else y
    if n > k:
        R, QtY = _householder_reduce(X, Y)
        u_r, s, vt = _svd_nan_lanes(R)
        uty = torch.einsum("...ji,...jm->...im", u_r, QtY)
    else:
        u, s, vt = _svd_nan_lanes(X)
        uty = torch.einsum("...ni,...nm->...im", u, Y)
    rc = _default_rcond(n, k, n_valid) if rcond is None else rcond
    if isinstance(rc, torch.Tensor):
        rc = rc[..., None]
    cut = rc * s.amax(dim=-1, keepdim=True)
    denom = s * s + alpha
    d = torch.where(s > cut, s / torch.where(denom == 0, 1.0, denom), 0.0)
    beta = torch.einsum("...ik,...im->...km", vt, d[..., None] * uty)
    return beta[..., 0] if squeeze else beta
