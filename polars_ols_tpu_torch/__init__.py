"""polars_ols_tpu_torch — the grouped least-squares engine on PyTorch and CUDA.

The PyTorch port of ``polars_ols_tpu`` (the JAX engine, which stays the
reference): the same DataFrame / expression surface, with every group
batched into tensor programs on ``CONFIG.device`` and hand-written CUDA
kernels for the per-group moments (``csrc/moments.cu``), coordinate
descent (``csrc/cd.cu``), the t-test p-values (``csrc/t_pvalue.cu``) and
the moving models' scan and per-row solve (``csrc/moving.cu``).

Ported so far: the static fits, grouped (``.over(keys)``) and not, through
``col(y).least_squares.ols / wls / ridge / lasso / elastic_net(...)`` and
``DataFrame.select``: the five static null policies, sample weights,
solve methods chol / lu / qr / svd / cd / cd_active_set (``positive=True``
for NNLS), K <= 32, in predictions, residuals, coefficients or statistics
mode (a ``StatisticsSeries``); and the moving models ``rls`` /
``expanding_ols`` / ``rolling_ols`` under all six null policies
(``drop_window`` included), in predictions, residuals or coefficients
mode. Everything else (multi-target, ``predict``, formulas, K > 32)
raises ``NotImplementedError`` naming its ROADMAP.md queue item.

This package imports torch and numpy only; it never imports jax or
polars_ols_tpu.
"""

from __future__ import annotations

from .config import CONFIG
from .expr import col
from .frame import DataFrame
from .least_squares import OLSKwargs, RLSKwargs, RollingKwargs
from .series import Series, StatisticsSeries

__version__ = "0.1.0"

__all__ = [
    "CONFIG", "DataFrame", "OLSKwargs", "RLSKwargs", "RollingKwargs", "Series",
    "StatisticsSeries", "col",
]
