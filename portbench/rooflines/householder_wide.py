"""The Householder reduction's wide form (``csrc/householder.cu``,
``householder_wide``): each group's R factor and Q^T Y under the ``svd``
fits and multi-target fits, for blocks of C = K + M > 33 columns.

Frozen from ``chip_smoke.py:_householder_bound``, with the frame's rows
in place of the program's padded block slots and one K x C factor a
group: each row's C values and its mask byte read once, the factors
written once; ~4 (C - j) operations a valid row for reflection j, at the
tensor cores' f64 rate (blocked reflections are products of matrices).
"""

from __future__ import annotations

import numpy as np

from portbench.peaks import F64_TENSOR_PER_S, bound_s
from portbench.traffic import targets

KERNELS = frozenset({"householder_wide"})
WIDE_COLUMNS = 33  # the wide form runs above this many columns


def reduction_bound_s(n_rows: int, n_groups: int, K: int, C: int) -> float:
    moved = n_rows * (8 * C + 1) + 8 * n_groups * K * C
    return bound_s(moved, 4 * n_rows * sum(C - j for j in range(K)), F64_TENSOR_PER_S)


def select_bound_s(fits, cfg: dict, counts: np.ndarray) -> float:
    K = int(cfg["features"])
    n, g = int(counts.sum()), int((counts > 0).sum())
    total = 0.0
    for f in fits:
        svd = f["fit"] == "multi_target_ols" or (
            f["fit"] in ("ols", "ridge") and f.get("kwargs", {}).get("solve_method") == "svd"
        )
        C = K + len(targets(f))
        if svd and C > WIDE_COLUMNS:
            total += reduction_bound_s(n, g, K, C)
    return total
