"""The moving kernels (``csrc/moving.cu``): ``rls`` and ``rolling_ols``
predictions.

Frozen from ``chip_smoke.py:_moving_bound(..., fresh=False)``, the least
the function needs: Z (C = K + 1 values a row) and the valid mask read
once (rolling also a leaving-row index and a refresh mask), the row
counts read once, one prediction a row written; K (K + 3) multiply-adds
to add a row's outer products and a rank-one update of a kept factor
(2 K^2) for each row that enters or leaves, K (K + 3) / 2 + 1 multiplies
a row where the state is discounted, two triangular solves (2 K^2 + 2 K)
a solved row and 2 K for a prediction, at f64 outside the tensor cores.
Every row of the frame is valid.
"""

from __future__ import annotations

import numpy as np

from portbench.peaks import F64_PER_S, bound_s

KERNELS = frozenset({
    "walk", "walk_shared", "prefix_compose", "prefix_scan", "prefix_expand",
    "fill", "fill_shared", "moments_at", "moments_at_shared",
})


def fit_bound_s(fit: dict, K: int, counts: np.ndarray) -> float:
    kw = fit.get("kwargs", {})
    n_rows = int(counts.sum())
    rolling = fit["fit"] == "rolling_ols"
    if rolling:
        window = int(kw["window_size"])
        mp = kw.get("min_periods") or min(K, window)
        n_refresh = int(np.maximum(counts - mp + 1, 0).sum())
        n_leaving = int(np.maximum(counts - window, 0).sum())
    else:
        n_refresh, n_leaving = n_rows, 0
    per_row = 8 * (1 + K) + 1 + (5 if rolling else 0) + 8
    ops = (n_rows + n_leaving) * (K * (K + 3) + 2 * K * K) + n_refresh * (2 * K * K + 2 * K)
    if not rolling:
        ops += n_rows * (K * (K + 3) // 2 + 1)
    ops += 2 * K * n_rows
    return bound_s(n_rows * per_row + 8 * int((counts > 0).sum()), ops, F64_PER_S)


def select_bound_s(fits, cfg: dict, counts: np.ndarray) -> float:
    K = int(cfg["features"])
    return sum(fit_bound_s(f, K, counts) for f in fits if f["fit"] in ("rls", "rolling_ols"))
