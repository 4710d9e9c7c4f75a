"""Public compute functions and kwargs dataclasses.

Same names, defaults and validation as the reference's
polars_ols/least_squares.py (:47-118); the expressions evaluate on the
batched PyTorch engine. WLS scales the engine's column stack by sqrt(w)
(reference least_squares.py:190-196); residuals are the target minus the
(unscaled) predictions.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Literal, Optional, Set, Union, get_args

from .expr import Expr, LeastSquaresExpr, parse_into_expr

logger = logging.getLogger(__name__)

ExprOrStr = Union[Expr, str]

NullPolicy = Literal["zero", "drop", "ignore", "drop_zero", "drop_y_zero_x", "drop_window"]
OutputMode = Literal["predictions", "residuals", "coefficients", "statistics"]
SolveMethod = Literal["qr", "svd", "chol", "lu", "cd", "cd_active_set"]

_VALID_NULL_POLICIES: Set[str] = set(get_args(NullPolicy))
_VALID_OUTPUT_MODES: Set[str] = set(get_args(OutputMode))
_VALID_SOLVE_METHODS: Set[Optional[str]] = set(get_args(SolveMethod)).union({None})


@dataclass
class Kwargs:
    null_policy: str = "ignore"

    def __post_init__(self):
        if self.null_policy not in _VALID_NULL_POLICIES:
            raise ValueError(
                f"unknown null_policy {self.null_policy!r}; "
                f"expected one of {sorted(_VALID_NULL_POLICIES)}"
            )


@dataclass
class OLSKwargs(Kwargs):
    """Parameters for regularized linear models (reference least_squares.py:80-118).

    Attributes:
        alpha: Regularization strength. Defaults to 0.0.
        l1_ratio: ElasticNet mixing (0 ridge, 1 lasso). Defaults to None (ridge).
        max_iter: Maximum coordinate-descent iterations. Defaults to 1000.
        tol: Convergence tolerance. Defaults to 1e-5.
        positive: Enforce non-negative coefficients (NNLS). Defaults to False.
        null_policy: Missing-data strategy. Defaults to "ignore".
        solve_method: one of qr/svd/chol/lu/cd/cd_active_set or None (auto).
        rcond: SVD small-singular-value cutoff; None -> numpy lstsq default.
    """

    alpha: Optional[float] = 0.0
    l1_ratio: Optional[float] = None
    max_iter: Optional[int] = 1_000
    tol: Optional[float] = 1.0e-5
    positive: Optional[bool] = False
    solve_method: Optional[str] = None
    rcond: Optional[float] = None

    def __post_init__(self):
        valid_ols_policies = _VALID_NULL_POLICIES - {"drop_window"}
        if self.null_policy not in valid_ols_policies:
            raise ValueError(
                f"unknown null_policy {self.null_policy!r} for a static fit; "
                f"expected one of {sorted(valid_ols_policies)}"
            )
        if self.solve_method not in _VALID_SOLVE_METHODS:
            raise ValueError(
                f"unknown solve_method {self.solve_method!r}; expected one of "
                f"{sorted(s for s in _VALID_SOLVE_METHODS if s)} or None"
            )


def _build_least_squares_expr(
    target: ExprOrStr,
    *features: ExprOrStr,
    mode: str,
    ols_kwargs: Kwargs,
    sample_weights: Optional[ExprOrStr] = None,
    add_intercept: bool = False,
) -> Expr:
    """The least-squares node for ``mode``, with the intercept folded into
    the engine's column stack and the weights into its sqrt(w) scaling
    (reference least_squares.py:163-239). Residuals subtract the engine's
    predictions, already unscaled, from the unscaled target."""
    target = parse_into_expr(target)
    features = [parse_into_expr(f) for f in features]
    weights = None if sample_weights is None else parse_into_expr(sample_weights)
    add_const = False
    if add_intercept:
        if any(f.output_name == "const" for f in features):
            logger.info("a 'const' column is present among the features; treating it as the intercept")
        else:
            add_const = True
    node_mode = "predictions" if mode == "residuals" else mode
    node = LeastSquaresExpr(
        target, features, ols_kwargs, node_mode, add_intercept=add_const, weights=weights
    )
    if mode in ("coefficients", "statistics"):
        return node.alias(mode)
    return target - node if mode == "residuals" else node


def compute_least_squares(
    target: ExprOrStr,
    *features: ExprOrStr,
    sample_weights: Optional[ExprOrStr] = None,
    add_intercept: bool = False,
    mode: str = "predictions",
    ols_kwargs: Optional[OLSKwargs] = None,
) -> Expr:
    """OLS / WLS / ridge / lasso / elastic-net least squares (reference
    least_squares.py:242-279); ``mode="statistics"`` gives a
    ``StatisticsSeries``."""
    if mode not in _VALID_OUTPUT_MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {sorted(_VALID_OUTPUT_MODES)}")
    return _build_least_squares_expr(
        target,
        *features,
        mode=mode,
        ols_kwargs=ols_kwargs or OLSKwargs(),
        sample_weights=sample_weights,
        add_intercept=add_intercept,
    )
