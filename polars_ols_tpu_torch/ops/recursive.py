"""Recursive least squares (an exponentially forgetting Kalman filter):
the plain PyTorch version.

The reference updates a K x K covariance state row by row
(src/least_squares.rs:494-598). That recursion is the recursive solution
of a discounted ridge regression: with ``M_0 = I / c``, ``b_0 = mean0 / c``
and

    M_t = lam_t M_{t-1} + v_t x_t x_t',   b_t = lam_t b_{t-1} + v_t x_t y_t

(``lam_t`` the forgetting factor on valid rows and 1 on invalid ones, which
leave the state untouched, :586-590), the coefficient state is
``coef_t = M_t^-1 b_t``. So invalid rows forward-fill the coefficients, and
rows before the first valid one give ``mean0``.

``solve_recursive_least_squares`` is the JAX engine's function of the same
name (``ops/recursive.py:118``) as plain tensor ops: the moment states of
every row, a sequential recurrence over rows batched over groups (a
``cumsum`` without forgetting), then one batched Cholesky solve with the
eigh minimum-norm fallback (``ops/linalg.py:solve_psd``). It runs for CPU
tensors and in the tests; on the card ``ops/moving.py`` runs the
hand-written kernel instead.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from ..config import F64
from .linalg import solve_psd

Mean0 = Union[None, float, Sequence[float]]


def forgetting_factor(half_life: Optional[float]) -> float:
    """``exp(ln 0.5 / half_life)``; 1 without a half life
    (src/least_squares.rs:513-517)."""
    return math.exp(math.log(0.5) / half_life) if half_life else 1.0


def prior_mean(initial_state_mean: Mean0, k: int, device) -> torch.Tensor:
    """The prior mean [K] f64: zeros, a scalar broadcast, or one value a
    feature."""
    if initial_state_mean is None:
        return torch.zeros(k, dtype=F64, device=device)
    m = torch.as_tensor(initial_state_mean, dtype=F64, device=device)
    if m.dim() == 0:
        return m.expand(k).contiguous()
    if tuple(m.shape) != (k,):
        raise ValueError(f"initial_state_mean must be a scalar or {k} values, got {tuple(m.shape)}")
    return m


def discounted_states(Xp, yp, vp, ff: float):
    """(M [G, R, K, K], b [G, R, K], disc [G, R]): the discounted moment
    sums and the discount of the prior after every row."""
    G, R, K = Xp.shape
    Xv = torch.where(vp[..., None], Xp, 0.0)
    yv = torch.where(vp, yp, 0.0)
    U = Xv[..., :, None] * Xv[..., None, :]
    u = Xv * yv[..., None]
    if ff == 1.0:
        return U.cumsum(dim=1), u.cumsum(dim=1), torch.ones((G, R), dtype=F64, device=Xp.device)
    one = torch.ones((), dtype=F64, device=Xp.device)
    lam = torch.where(vp, ff * one, one)
    M = torch.empty_like(U)
    b = torch.empty_like(u)
    disc = torch.empty((G, R), dtype=F64, device=Xp.device)
    M_c = torch.zeros((G, K, K), dtype=F64, device=Xp.device)
    b_c = torch.zeros((G, K), dtype=F64, device=Xp.device)
    d_c = torch.ones(G, dtype=F64, device=Xp.device)
    for t in range(R):
        lt = lam[:, t]
        M_c = lt[:, None, None] * M_c + U[:, t]
        b_c = lt[:, None] * b_c + u[:, t]
        d_c = d_c * lt
        M[:, t], b[:, t], disc[:, t] = M_c, b_c, d_c
    return M, b, disc


def solve_recursive_least_squares(
    Xp: torch.Tensor,  # [G, R, K] zero-filled
    yp: torch.Tensor,  # [G, R]
    vp: torch.Tensor,  # [G, R] bool: valid rows update the state
    half_life: Optional[float],
    initial_state_covariance: Optional[float] = 10.0,
    initial_state_mean: Mean0 = None,
) -> torch.Tensor:
    """Batched RLS coefficient paths [G, R, K].

    The prior state is ``P = I * c``, ``coef = mean0`` or 0
    (src/least_squares.rs:519-522). Rows before the first valid
    observation give ``mean0``.
    """
    G, R, K = Xp.shape
    ff = forgetting_factor(half_life)
    c = 10.0 if initial_state_covariance is None else float(initial_state_covariance)
    mean0 = prior_mean(initial_state_mean, K, Xp.device)
    if R == 0:
        return torch.empty((G, 0, K), dtype=F64, device=Xp.device)
    M, b, disc = discounted_states(Xp.to(F64), yp.to(F64), vp, ff)
    reg = disc / c
    A = M + reg[..., None, None] * torch.eye(K, dtype=F64, device=Xp.device)
    rhs = b + reg[..., None] * mean0
    return solve_psd(A, rhs)
