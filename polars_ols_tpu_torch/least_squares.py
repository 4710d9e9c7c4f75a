"""Public compute functions and kwargs dataclasses.

Same names, defaults and validation as the reference's
polars_ols/least_squares.py (:47-160); the expressions evaluate on the
batched PyTorch engine. WLS scales the engine's column stack by sqrt(w)
(reference least_squares.py:190-196); residuals are the target minus the
(unscaled) predictions. The static fits refuse ``null_policy="drop_window"``;
the recursive and rolling models take all six policies and refuse
``mode="statistics"``. A multi-target fit (a struct target) solves every
target through one shared SVD and gives predictions or residuals only;
``predict`` dots a row-aligned coefficient struct with feature columns;
``compute_least_squares_from_formula`` parses a patsy-style formula
(utils.py). Where the JAX package asserts, these functions raise
``AssertionError`` with its message.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace
from functools import partial
from typing import List, Literal, Optional, Set, Union, get_args

from .expr import Expr, LeastSquaresExpr, PredictExpr, lit, parse_into_expr

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
            raise AssertionError(
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
            raise AssertionError(
                f"unknown null_policy {self.null_policy!r} for a static fit; "
                f"expected one of {sorted(valid_ols_policies)}"
            )
        if self.solve_method not in _VALID_SOLVE_METHODS:
            raise AssertionError(
                f"unknown solve_method {self.solve_method!r}; expected one of "
                f"{sorted(s for s in _VALID_SOLVE_METHODS if s)} or None"
            )


@dataclass
class RLSKwargs(Kwargs):
    """Recursive least squares parameters (reference least_squares.py:121-140)."""

    half_life: Optional[float] = None
    initial_state_covariance: Optional[float] = 10.0
    initial_state_mean: Union[Optional[List[float]], float] = None
    null_policy: str = "drop"


@dataclass
class RollingKwargs(Kwargs):
    """Rolling OLS parameters (reference least_squares.py:143-160).

    ``use_woodbury`` is accepted and ignored: the engine solves every
    window from its moments.
    """

    window_size: int = 1_000_000  # defaults to an expanding fit
    min_periods: Optional[int] = None
    use_woodbury: Optional[bool] = None
    alpha: Optional[float] = None
    null_policy: str = "drop_window"


def _build_least_squares_expr(
    target: ExprOrStr,
    *features: ExprOrStr,
    mode: str,
    ols_kwargs: Kwargs,
    function_name: str = "least_squares",
    sample_weights: Optional[ExprOrStr] = None,
    add_intercept: bool = False,
    multi_target: bool = False,
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
        target, features, ols_kwargs, node_mode, add_intercept=add_const, weights=weights,
        function_name=function_name, multi_target=multi_target,
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
        raise AssertionError(f"unknown mode {mode!r}; expected one of {sorted(_VALID_OUTPUT_MODES)}")
    return _build_least_squares_expr(
        target,
        *features,
        mode=mode,
        ols_kwargs=ols_kwargs or OLSKwargs(),
        sample_weights=sample_weights,
        add_intercept=add_intercept,
    )


def compute_multi_target_least_squares(
    targets: ExprOrStr,
    *features: ExprOrStr,
    sample_weights: Optional[ExprOrStr] = None,
    add_intercept: bool = False,
    mode: str = "predictions",
    ols_kwargs: Optional[OLSKwargs] = None,
) -> Expr:
    """Multi-target regression of a struct target: one shared SVD serves
    all M targets (reference least_squares.py:282-329). OLS and ridge only,
    in predictions or residuals mode; the output is a struct of the
    target's fields."""
    ols_kwargs = ols_kwargs or OLSKwargs()
    msg = " Fit each target with its own expression instead."
    if ols_kwargs.positive or ols_kwargs.l1_ratio not in (None, 0.0):
        raise AssertionError(
            "multi-target fits support only unconstrained OLS/Ridge (shared SVD)." + msg
        )
    if ols_kwargs.solve_method not in ("svd", None):
        raise AssertionError(
            "multi-target fits solve through the shared SVD; pass solve_method='svd' or None"
        )
    if mode not in ("predictions", "residuals"):
        raise NotImplementedError("multi-target mode must be 'predictions' or 'residuals'." + msg)
    return _build_least_squares_expr(
        targets,
        *features,
        mode=mode,
        ols_kwargs=replace(ols_kwargs, solve_method="svd"),
        sample_weights=sample_weights,
        add_intercept=add_intercept,
        multi_target=True,
    )


def _check_moving_mode(mode: str) -> None:
    valid = _VALID_OUTPUT_MODES - {"statistics"}
    if mode not in valid:
        raise AssertionError(f"unknown mode {mode!r}; expected one of {sorted(valid)}")


def compute_recursive_least_squares(
    target: ExprOrStr,
    *features: ExprOrStr,
    sample_weights: Optional[ExprOrStr] = None,
    add_intercept: bool = False,
    mode: str = "predictions",
    rls_kwargs: Optional[RLSKwargs] = None,
) -> Expr:
    """Recursive least squares (reference least_squares.py:332-369)."""
    _check_moving_mode(mode)
    return _build_least_squares_expr(
        target,
        *features,
        mode=mode,
        function_name="recursive_least_squares",
        ols_kwargs=rls_kwargs or RLSKwargs(),
        sample_weights=sample_weights,
        add_intercept=add_intercept,
    )


def compute_rolling_least_squares(
    target: ExprOrStr,
    *features: ExprOrStr,
    sample_weights: Optional[ExprOrStr] = None,
    add_intercept: bool = False,
    mode: str = "predictions",
    rolling_kwargs: Optional[RollingKwargs] = None,
) -> Expr:
    """Rolling-window least squares (reference least_squares.py:372-409)."""
    _check_moving_mode(mode)
    expr = _build_least_squares_expr(
        target,
        *features,
        mode=mode,
        function_name="rolling_least_squares",
        ols_kwargs=rolling_kwargs or RollingKwargs(),
        sample_weights=sample_weights,
        add_intercept=add_intercept,
    )
    if mode == "residuals":
        # warm-up NaNs -> nulls (:407-409); for predictions the engine
        # does the same conversion itself
        expr = expr.fill_nan(None)
    return expr


def compute_least_squares_from_formula(
    formula: str,
    sample_weights: Optional[ExprOrStr] = None,
    mode: str = "predictions",
    **kwargs,
) -> Expr:
    """A fit from a patsy-style formula ``"y ~ x1 + x2:x3"``: recursive
    least squares with ``half_life``, rolling with ``window_size``, else a
    static fit (reference least_squares.py:412-452)."""
    from .utils import build_expressions_from_patsy_formula

    expressions, add_intercept = build_expressions_from_patsy_formula(
        formula, include_dependent_variable=True
    )
    if kwargs.get("half_life"):
        func = partial(compute_recursive_least_squares, rls_kwargs=RLSKwargs(**kwargs))
    elif kwargs.get("window_size"):
        func = partial(compute_rolling_least_squares, rolling_kwargs=RollingKwargs(**kwargs))
    else:
        func = partial(compute_least_squares, ols_kwargs=OLSKwargs(**kwargs))
    return func(
        expressions[0],
        *expressions[1:],
        add_intercept=add_intercept,
        sample_weights=sample_weights,
        mode=mode,
    )


def predict(
    coefficients: ExprOrStr,
    *features: ExprOrStr,
    null_policy: str = "zero",
    add_intercept: bool = False,
    name: Optional[str] = None,
) -> Expr:
    """Row-aligned coefficient struct dotted with the features (reference
    least_squares.py:455-491), under the null policies the reference's
    predict takes: zero, ignore or drop (src/expressions.rs:706-741)."""
    if null_policy not in ("zero", "ignore", "drop"):
        raise AssertionError(
            f"unknown null_policy {null_policy!r}; predict supports drop/ignore/zero"
        )
    coefficients = parse_into_expr(coefficients)
    features = [parse_into_expr(f) for f in features]
    if add_intercept:
        if any(f.output_name == "const" for f in features):
            logger.warning("a 'const' column is present among the features; treating it as the intercept")
        else:
            features.append(lit(1.0).alias("const"))
    return PredictExpr(coefficients, features, null_policy, name or "predictions")
