"""polars_ols_tpu_torch — the grouped least-squares engine on PyTorch and CUDA.

The PyTorch port of ``polars_ols_tpu`` (the JAX engine, which stays the
reference): the same DataFrame / expression surface, with every group
batched into tensor programs on ``CONFIG.device`` and hand-written CUDA
kernels for the per-group moments (``csrc/moments.cu``), coordinate
descent (``csrc/cd.cu``; FISTA and the wide cyclic form above K = 32,
``csrc/cd_wide.cu``), the t-test p-values (``csrc/t_pvalue.cu``), the
moving models' scan and per-row solve (``csrc/moving.cu``), the
Householder reduction under the shared SVD (``csrc/householder.cu``) and
that SVD (``csrc/jacobi_svd.cu``).

Ported so far: the static fits, grouped (``.over(keys)``) and not, through
``col(y).least_squares.ols / wls / ridge / lasso / elastic_net(...)`` and
``DataFrame.select`` / ``with_columns``: the five static null policies,
sample weights, solve methods chol / lu / qr / svd / cd / cd_active_set
(``positive=True`` for NNLS), at any K, in predictions, residuals,
coefficients or statistics mode (a ``StatisticsSeries``); the moving
models ``rls`` / ``expanding_ols`` / ``rolling_ols`` under all six null
policies (``drop_window`` included), in predictions, residuals or
coefficients mode; multi-target OLS / ridge of a ``struct(...)`` target
(``multi_target_ols``: predictions or residuals as a struct, read by
``DataFrame.unnest``); ``predict`` / ``predict_from_formula`` of a
coefficient struct; and ``from_formula`` / the compute functions. The
rest of the frame API raises ``NotImplementedError`` naming its ROADMAP.md
queue item.

This package imports torch and numpy only; it never imports jax or
polars_ols_tpu.
"""

from __future__ import annotations

from .config import CONFIG
from .expr import col, lit, struct
from .frame import DataFrame
from .least_squares import (
    OLSKwargs,
    RLSKwargs,
    RollingKwargs,
    compute_least_squares,
    compute_least_squares_from_formula,
    compute_multi_target_least_squares,
    compute_recursive_least_squares,
    compute_rolling_least_squares,
    predict,
)
from .series import Series, StatisticsSeries, StructSeries

__version__ = "0.1.0"

__all__ = [
    "CONFIG", "DataFrame", "OLSKwargs", "RLSKwargs", "RollingKwargs", "Series",
    "StatisticsSeries", "StructSeries", "col", "compute_least_squares",
    "compute_least_squares_from_formula", "compute_multi_target_least_squares",
    "compute_recursive_least_squares", "compute_rolling_least_squares", "lit", "predict",
    "struct",
]
