"""The moment kernel (``csrc/moments.cu``): each group's Z^T Z, Z the
features beside the target.

Frozen from ``chip_smoke.py:_moment_bound``, with the frame's rows in
place of the program's padded block slots: each row's C = K + 1 values
and its mask byte read once, the offsets read and the moments and counts
written once; one multiply and one add per upper-triangle entry of each
valid row, at the tensor cores' f64 rate. A select needs the moments once
for each distinct target among its fits that solve from them.
"""

from __future__ import annotations

import numpy as np

from portbench.peaks import F64_TENSOR_PER_S, bound_s

KERNELS = frozenset({
    "block_moments", "block_moments_wide", "block_moments_direct",
    "group_sums", "group_sums_tile", "group_sums_wide",
})
FITS = ("ols", "ridge")
METHODS = (None, "chol", "lu")


def stage_bound_s(n_rows: int, n_groups: int, C: int) -> float:
    moved = n_rows * (8 * C + 1) + 8 * (n_groups + 1) + 8 * n_groups * C * C + 8 * n_groups
    return bound_s(moved, n_rows * C * (C + 1), F64_TENSOR_PER_S)


def select_bound_s(fits, cfg: dict, counts: np.ndarray) -> float:
    stages = {
        f["target"] for f in fits
        if f["fit"] in FITS and f.get("kwargs", {}).get("solve_method") in METHODS
    }
    n, g = int(counts.sum()), int((counts > 0).sum())
    return len(stages) * stage_bound_s(n, g, int(cfg["features"]) + 1)
