"""The `.least_squares` expression namespace (ols, wls, ridge, lasso and
elastic_net so far)."""

from __future__ import annotations

from typing import Optional, Union

from .expr import Expr
from .least_squares import OLSKwargs, compute_least_squares

ExprOrStr = Union[Expr, str]

# the reference namespace's other methods -> the ROADMAP.md Queue 1 item
# that ports them
_NOT_PORTED = {
    "rls": 7,
    "rolling_ols": 7,
    "expanding_ols": 7,
    "multi_target_ols": 8,
    "from_formula": 8,
    "predict": 8,
    "predict_from_formula": 8,
}


def _not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"least_squares.{name} is not ported to polars_ols_tpu_torch yet "
        f"(ROADMAP.md Queue 1 item {_NOT_PORTED[name]})"
    )


class LeastSquares:
    """Entry points of the ported models, mirroring the reference namespace
    (polars_ols/__init__.py:35-295): sample_weights, add_intercept,
    mode ∈ {predictions, residuals, coefficients, statistics}, null_policy,
    solve_method."""

    def __init__(self, expr: Expr):
        self._expr = expr

    def __getattr__(self, name: str):
        if name not in _NOT_PORTED:
            raise AttributeError(name)
        raise _not_ported(name)

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
        if multi_target:
            raise _not_ported("multi_target_ols")
        return compute_least_squares(
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
