"""Plain moving least squares: the benchmark's reference for ``rls`` and
``rolling_ols``, in NumPy and plain PyTorch on the CPU.

``rls`` is the literal recursive-least-squares (Kalman) recursion of the
reference engine (src/least_squares.rs:494-598), run for several groups at
once; ``rolling`` solves every row's window by a QR least-squares solve.
Both return in-sample predictions: each row's features times the
coefficients after that row. They see only the inputs the benchmark made,
in the dtype they are given (float64 the reference, float32 the control).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch


def rls(groups: List[tuple], half_life: float, c: float = 10.0, dtype=np.float64) -> List[np.ndarray]:
    """Predictions [n] of each (X [n, K], y [n]) in ``groups``: P = c I and
    zero coefficients to begin with, forgetting factor
    exp(ln 0.5 / half_life), every row valid. The groups run side by
    side, padded to the longest; a padded row leaves its state alone."""
    ff = math.exp(math.log(0.5) / half_life)
    G, K = len(groups), groups[0][0].shape[1]
    T = max(len(y) for _, y in groups)
    X = np.zeros((G, T, K), dtype)
    Y = np.zeros((G, T), dtype)
    live = np.zeros((G, T), bool)
    for g, (x, y) in enumerate(groups):
        X[g, : len(y)], Y[g, : len(y)], live[g, : len(y)] = x, y, True
    P = np.broadcast_to(np.eye(K, dtype=dtype) * dtype(c), (G, K, K)).copy()
    coef = np.zeros((G, K), dtype)
    pred = np.zeros((G, T), dtype)
    ff = dtype(ff)
    for t in range(T):
        x = X[:, t]
        Px = np.einsum("gij,gj->gi", P, x)
        r = dtype(1) + np.einsum("gi,gi->g", x, Px) / ff
        gain = Px / (r * ff)[:, None]
        err = Y[:, t] - np.einsum("gi,gi->g", x, coef)
        m = live[:, t]
        coef = np.where(m[:, None], coef + gain * err[:, None], coef)
        P = np.where(m[:, None, None], P / ff - np.einsum("gi,gj->gij", gain, gain) * r[:, None, None], P)
        pred[:, t] = np.einsum("gi,gi->g", x, coef)
    return [pred[g, : len(y)] for g, (_, y) in enumerate(groups)]


def rolling(X: np.ndarray, y: np.ndarray, window: int, min_periods: int, dtype=np.float64) -> np.ndarray:
    """Predictions [n] of one group's rolling OLS, every row valid: row i's
    window is rows max(0, i - window + 1) .. i, solved where it holds at
    least ``min_periods`` rows, NaN before. Each window is zero-padded to
    ``window`` rows (a zero row leaves a least-squares solution alone) and
    all of them go through one batched QR."""
    n, K = X.shape
    if min_periods < K:
        raise ValueError("a window with fewer rows than features has no unique solution to compare")
    tdt =torch.float64 if dtype == np.float64 else torch.float32
    Xt = torch.as_tensor(X, dtype=tdt)
    yt = torch.as_tensor(y, dtype=tdt)
    pad = torch.cat([torch.zeros(window - 1, K, dtype=tdt), Xt])
    ypad = torch.cat([torch.zeros(window - 1, dtype=tdt), yt])
    rows = torch.arange(window)[None, :] + torch.arange(n)[:, None]  # [n, window] into the padded rows
    out = np.full(n, np.nan, dtype)
    first = min_periods - 1
    if first >= n:
        return out
    rows = rows[first:]
    A, b = pad[rows], ypad[rows]  # [m, window, K], [m, window]
    Q, R = torch.linalg.qr(A)
    beta = torch.linalg.solve_triangular(R, (Q.mT @ b[..., None]), upper=True)[..., 0]
    out[first:] = (Xt[first:] * beta).sum(-1).numpy()
    return out
