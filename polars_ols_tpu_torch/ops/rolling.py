"""Rolling-window least squares: the window indices and the plain PyTorch
version.

The reference keeps XtX / Xty of the window with a rank-2 update per row
(src/least_squares.rs:600-1032). Two window semantics (:947-1029):

- the drop family ('drop' / 'drop_zero' / 'drop_y_zero_x'): the window is
  the last ``window`` *valid* rows. Coefficients are defined from the
  ``min_periods``-th valid row on, and stay as they are across invalid rows
  (the window is keyed on the valid rank, which an invalid row leaves
  alone).
- 'drop_window' (positional; statsmodels ``RollingOLS(missing="drop")``):
  the window is the last ``window`` rows, of which the valid ones count.
  Coefficients are refreshed where the window holds at least
  ``min_periods`` valid rows; elsewhere the last refreshed value is carried
  (NaN before the first).

``rolling_indices`` prepares, with plain tensor ops, what both the CUDA
kernel (``ops/moving.py``) and the plain version need of a window: the row
that leaves it at every row, and where the coefficients are refreshed.
``solve_rolling_ols`` is the JAX engine's function of the same name
(``ops/rolling.py:210``): window moments as the running sum of entering
minus leaving outer products, one batched Cholesky solve with the eigh
minimum-norm fallback, and the carry across rows that do not refresh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import F64
from .linalg import solve_psd


def default_min_periods(min_periods: Optional[int], k: int, window: int) -> int:
    """``min(K, window)`` unless given (src/least_squares.rs:860)."""
    return min(k, window) if min_periods is None else int(min_periods)


def rolling_indices(
    vp: torch.Tensor, window: int, min_periods: int, positional: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(leaving [G, R] int32, refresh [G, R] bool) of a window over the
    valid rows ``vp`` [G, R].

    ``leaving[g, t]`` is the row whose moment leaves the window at row t,
    or -1 where none does. ``refresh[g, t]`` says that row t solves its
    window anew; other rows carry the last refreshed coefficients.

    - positional: row ``t - window`` leaves where it exists and is valid;
      every row whose window holds >= ``min_periods`` valid rows refreshes.
    - valid-rank: at a valid row of rank r > window the valid row of rank
      ``r - window`` leaves; valid rows of rank >= ``min_periods`` refresh.
    """
    G, R = vp.shape
    dev = vp.device
    t = torch.arange(R, device=dev)
    r = vp.cumsum(dim=1)  # 1-based valid rank through t, int64
    if positional:
        has = t >= window
        src = (t - window).clamp_min(0)
        leaving = torch.where(has & vp[:, src], src, -1)
        count_w = r - torch.where(has, r[:, src], 0)
        refresh = count_w >= min_periods
    else:
        # rank -> row map by one scatter; invalid rows write the spare slot
        rank_pos = torch.zeros((G, R + 2), dtype=torch.int64, device=dev)
        rank_pos.scatter_(1, torch.where(vp, r, R + 1), t.expand(G, R))
        sub_rank = r - window
        sub_on = vp & (sub_rank >= 1)
        leaving = torch.where(sub_on, rank_pos.gather(1, sub_rank.clamp(0, R + 1)), -1)
        refresh = vp & (r >= min_periods)
    return leaving.to(torch.int32), refresh


def last_refresh(refresh: torch.Tensor) -> torch.Tensor:
    """[G, R] int64: the last row <= t that refreshes, -1 before the first."""
    t = torch.arange(refresh.shape[1], device=refresh.device)
    return torch.where(refresh, t, -1).cummax(dim=1).values


def window_states(Xp, yp, vp, leaving):
    """(W [G, R, K, K], b [G, R, K]): the window's moment sums after every
    row, as the running sum of entering minus leaving outer products."""
    Xv = torch.where(vp[..., None], Xp, 0.0)
    yv = torch.where(vp, yp, 0.0)
    on = leaving >= 0
    idx = leaving.clamp_min(0).to(torch.int64)
    Xs = torch.where(on[..., None], Xv.gather(1, idx[..., None].expand_as(Xv)), 0.0)
    ys = torch.where(on, yv.gather(1, idx), 0.0)
    dU = Xv[..., :, None] * Xv[..., None, :] - Xs[..., :, None] * Xs[..., None, :]
    du = Xv * yv[..., None] - Xs * ys[..., None]
    return dU.cumsum(dim=1), du.cumsum(dim=1)


def solve_rolling_ols(
    Xp: torch.Tensor,  # [G, R, K] zero-filled
    yp: torch.Tensor,  # [G, R]
    vp: torch.Tensor,  # [G, R] bool
    window: int,
    min_periods: Optional[int],
    alpha: float,
    positional: bool,
) -> torch.Tensor:
    """Batched rolling-OLS coefficient paths [G, R, K], NaN where no
    window has been solved yet."""
    G, R, K = Xp.shape
    if R == 0:
        return torch.empty((G, 0, K), dtype=F64, device=Xp.device)
    mp = default_min_periods(min_periods, K, window)
    leaving, refresh = rolling_indices(vp, int(window), mp, positional)
    W, b = window_states(Xp.to(F64), yp.to(F64), vp, leaving)
    A = W + float(alpha) * torch.eye(K, dtype=F64, device=Xp.device)
    coefs = solve_psd(A, b)
    last = last_refresh(refresh)
    carried = coefs.gather(1, last.clamp_min(0)[..., None].expand_as(coefs))
    return torch.where((last >= 0)[..., None], carried, torch.nan)
