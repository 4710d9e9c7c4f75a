"""The `.least_squares` expression namespace, method for method the
reference's (polars_ols/__init__.py:35-295): ols, wls, ridge, lasso,
elastic_net, rls, rolling_ols, expanding_ols, multi_target_ols,
from_formula, predict and predict_from_formula."""

from __future__ import annotations

from typing import List, Optional, Union

from .expr import Expr
from .least_squares import (
    OLSKwargs,
    RLSKwargs,
    RollingKwargs,
    compute_least_squares,
    compute_multi_target_least_squares,
    compute_recursive_least_squares,
    compute_rolling_least_squares,
    predict,
)
from .utils import build_expressions_from_patsy_formula

ExprOrStr = Union[Expr, str]


class LeastSquares:
    """Entry points of every model, mirroring the reference namespace
    (polars_ols/__init__.py:35-295): sample_weights, add_intercept,
    mode ∈ {predictions, residuals, coefficients, statistics}, null_policy,
    solve_method; the moving models (rls, rolling_ols, expanding_ols) take
    every mode but statistics, multi-target fits predictions and residuals
    only."""

    def __init__(self, expr: Expr):
        self._expr = expr

    def least_squares(
        self,
        *features: ExprOrStr,
        sample_weights: Optional[ExprOrStr] = None,
        add_intercept: bool = False,
        mode: str = "predictions",
        null_policy: str = "ignore",
        solve_method: Optional[str] = None,
        multi_target: bool = False,
        **ols_kwargs,
    ) -> Expr:
        ols_func = compute_multi_target_least_squares if multi_target else compute_least_squares
        return ols_func(
            self._expr,
            *features,
            sample_weights=sample_weights,
            add_intercept=add_intercept,
            mode=mode,
            ols_kwargs=OLSKwargs(null_policy=null_policy, solve_method=solve_method, **ols_kwargs),
        )

    def ols(self, *features: ExprOrStr, **kwargs) -> Expr:
        """Ordinary least squares. Alias for `least_squares`."""
        return self.least_squares(*features, **kwargs)

    def multi_target_ols(self, *features: ExprOrStr, **kwargs) -> Expr:
        """One shared fit of every field of a struct target."""
        return self.least_squares(*features, multi_target=True, **kwargs)

    def wls(self, *features: ExprOrStr, sample_weights: ExprOrStr, **kwargs) -> Expr:
        """Weighted least squares via sqrt-weight scaling."""
        return self.least_squares(*features, sample_weights=sample_weights, **kwargs)

    def ridge(self, *features: ExprOrStr, alpha: float, **kwargs) -> Expr:
        return self.least_squares(*features, alpha=alpha, l1_ratio=0.0, **kwargs)

    def lasso(self, *features: ExprOrStr, alpha: float, **kwargs) -> Expr:
        """L1-penalized fit by coordinate descent (``positive=True``: NNLS)."""
        return self.least_squares(*features, alpha=alpha, l1_ratio=1.0, **kwargs)

    def elastic_net(
        self,
        *features: ExprOrStr,
        alpha: float,
        l1_ratio: float = 0.5,
        positive: bool = False,
        **kwargs,
    ) -> Expr:
        """L1 + L2-penalized fit by coordinate descent."""
        return self.least_squares(
            *features, alpha=alpha, l1_ratio=l1_ratio, positive=positive, **kwargs
        )

    def rls(
        self,
        *features: ExprOrStr,
        sample_weights: Optional[ExprOrStr] = None,
        add_intercept: bool = False,
        mode: str = "predictions",
        null_policy: str = "drop",
        half_life: Optional[float] = None,
        initial_state_covariance: Optional[float] = 10.0,
        initial_state_mean: Union[Optional[List[float]], float] = None,
    ) -> Expr:
        """Recursive least squares (an exponentially forgetting expanding
        fit). ``initial_state_mean`` reaches ``mode="coefficients"`` only:
        predictions and residuals run with a zero prior mean, as the
        reference's do."""
        return compute_recursive_least_squares(
            self._expr,
            *features,
            sample_weights=sample_weights,
            add_intercept=add_intercept,
            mode=mode,
            rls_kwargs=RLSKwargs(
                null_policy=null_policy,
                half_life=half_life,
                initial_state_mean=initial_state_mean,
                initial_state_covariance=initial_state_covariance,
            ),
        )

    def rolling_ols(
        self,
        *features: ExprOrStr,
        window_size: int,
        sample_weights: Optional[ExprOrStr] = None,
        add_intercept: bool = False,
        mode: str = "predictions",
        null_policy: str = "drop",
        min_periods: Optional[int] = None,
        use_woodbury: Optional[bool] = None,
        alpha: Optional[float] = None,
    ) -> Expr:
        """Rolling-window least squares: under the drop family the window
        is the last ``window_size`` valid rows, under 'drop_window' the
        last ``window_size`` rows (statsmodels ``missing="drop"``)."""
        return compute_rolling_least_squares(
            self._expr,
            *features,
            sample_weights=sample_weights,
            add_intercept=add_intercept,
            mode=mode,
            rolling_kwargs=RollingKwargs(
                window_size=window_size,
                min_periods=min_periods,
                use_woodbury=use_woodbury,
                alpha=alpha,
                null_policy=null_policy,
            ),
        )

    def expanding_ols(self, *features: ExprOrStr, **kwargs) -> Expr:
        """``rls`` without forgetting."""
        return self.rls(*features, half_life=None, **kwargs)

    def from_formula(self, formula: str, **kwargs) -> Expr:
        """A fit of this target on the right-hand side of a patsy-style
        formula: ``rls`` with ``half_life``, ``rolling_ols`` with
        ``window_size``, else ``least_squares``."""
        features, add_intercept = build_expressions_from_patsy_formula(
            formula, include_dependent_variable=False
        )
        if kwargs.get("half_life"):
            return self.rls(*features, add_intercept=add_intercept, **kwargs)
        if kwargs.get("window_size"):
            return self.rolling_ols(*features, add_intercept=add_intercept, **kwargs)
        return self.least_squares(*features, add_intercept=add_intercept, **kwargs)

    def predict(
        self,
        *features: ExprOrStr,
        name: Optional[str] = None,
        add_intercept: bool = False,
        null_policy: str = "zero",
    ) -> Expr:
        """This coefficient struct dotted with ``features``, row by row."""
        return predict(
            self._expr, *features, add_intercept=add_intercept, name=name, null_policy=null_policy
        )

    def predict_from_formula(self, formula: str, name: Optional[str] = None) -> Expr:
        """``predict`` on the right-hand side of a patsy-style formula."""
        features, add_intercept = build_expressions_from_patsy_formula(
            formula, include_dependent_variable=False
        )
        add_intercept &= not any(f.output_name == "const" for f in features)
        return self.predict(*features, name=name, add_intercept=add_intercept)
