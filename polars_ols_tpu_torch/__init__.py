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

Ported: the static fits, grouped (``.over(keys)``) and not, through
``col(y).least_squares.ols / wls / ridge / lasso / elastic_net(...)``: the
five static null policies, sample weights, solve methods chol / lu / qr /
svd / cd / cd_active_set (``positive=True`` for NNLS), at any K, in
predictions, residuals, coefficients or statistics mode (a
``StatisticsSeries``); the moving models ``rls`` / ``expanding_ols`` /
``rolling_ols`` under all six null policies (``drop_window`` included),
in predictions, residuals or coefficients mode; multi-target OLS / ridge
of a ``struct(...)`` target; ``predict`` / ``predict_from_formula``;
``from_formula`` and the compute functions. Around the fits, the frame
substrate: expression arithmetic, comparisons and reductions, ``filter``,
``sort``, ``unique``, ``join``, ``group_by(...).agg / first / last``,
``explode``, ``concat``, ``lazy()`` plans, the ``selectors`` module,
``warmup()`` (kernel builds and warm layout caches), ``clear_caches()``
and ``utils.trace`` (a ``torch.profiler`` Chrome trace).

This package imports torch and numpy only; it never imports jax or
polars_ols_tpu.
"""

from __future__ import annotations

from . import selectors
from .config import CONFIG
from .engine.groups import clear_caches
from .expr import Expr, col, lit, struct
from .frame import DataFrame, GroupBy, LazyFrame, concat
from .least_squares import (
    NullPolicy,
    OLSKwargs,
    OutputMode,
    RLSKwargs,
    RollingKwargs,
    SolveMethod,
    compute_least_squares,
    compute_least_squares_from_formula,
    compute_multi_target_least_squares,
    compute_recursive_least_squares,
    compute_rolling_least_squares,
    predict,
)
from .namespace import LeastSquares
from .series import ObjectSeries, Series, StatisticsSeries, StructSeries
from .warmup import warmup

__version__ = "0.1.0"

__all__ = [
    "CONFIG", "DataFrame", "Expr", "GroupBy", "LazyFrame", "LeastSquares", "NullPolicy",
    "OLSKwargs", "ObjectSeries", "OutputMode", "RLSKwargs", "RollingKwargs", "Series",
    "SolveMethod", "StatisticsSeries", "StructSeries", "clear_caches", "col",
    "compute_least_squares", "compute_least_squares_from_formula",
    "compute_multi_target_least_squares", "compute_recursive_least_squares",
    "compute_rolling_least_squares", "concat", "lit", "predict", "selectors", "struct", "warmup",
]
