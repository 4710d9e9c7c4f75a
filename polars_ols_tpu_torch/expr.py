"""Expression AST and evaluator (the static-fit subset).

Column references (exact names and ``^regex$`` patterns), aliases, the
``.over()`` window context, subtraction of two expressions (residuals) and
the least-squares node, which dispatches into the batched engine
(engine/fit.py). Under ``.over()`` group ids flow into the engine as a
batch axis instead of a solver call per group.
"""

from __future__ import annotations

import re
from typing import List, Optional, Union

from .series import Series

ExprOrStr = Union["Expr", str]


class Expr:
    """Base class for all expression nodes."""

    def alias(self, name: str) -> "Expr":
        return AliasExpr(self, name)

    def over(self, *keys: ExprOrStr) -> "Expr":
        return OverExpr(self, [k if isinstance(k, str) else k.output_name for k in keys])

    def __sub__(self, other: "Expr") -> "Expr":
        if not isinstance(other, Expr):
            raise TypeError(
                f"only an expression can be subtracted, got {type(other).__name__} "
                "(literals are ROADMAP.md Queue 1 item 10)"
            )
        return SubExpr(self, other)

    @property
    def output_name(self) -> Optional[str]:
        return None

    @property
    def least_squares(self):
        from .namespace import LeastSquares

        return LeastSquares(self)

    def expand(self, df) -> List["Expr"]:
        """Expand regex column selectors against a frame's schema."""
        return [self]

    def evaluate(self, df, groups=None):
        raise NotImplementedError


class ColExpr(Expr):
    """Column reference: an exact name or a ``^regex$`` pattern."""

    def __init__(self, name: str, pattern: Optional[str] = None):
        self.name = name
        self.pattern = pattern

    @property
    def output_name(self) -> Optional[str]:
        return None if self.pattern else self.name

    def expand(self, df) -> List[Expr]:
        if self.pattern is None:
            return [self]
        rx = re.compile(self.pattern)
        return [ColExpr(n) for n in df.columns if rx.search(n)]

    def evaluate(self, df, groups=None):
        if self.pattern is not None:
            raise ValueError(f"regex selector {self.pattern!r} must be expanded first")
        return df.get_column(self.name)


class AliasExpr(Expr):
    def __init__(self, inner: Expr, name: str):
        self.inner = inner
        self.name = name

    @property
    def output_name(self) -> Optional[str]:
        return self.name

    def evaluate(self, df, groups=None):
        return self.inner.evaluate(df, groups).alias(self.name)


class OverExpr(Expr):
    """Window context: evaluates the wrapped expression with the group
    layout of the key columns."""

    def __init__(self, inner: Expr, keys: List[str]):
        self.inner = inner
        self.keys = keys

    @property
    def output_name(self) -> Optional[str]:
        return self.inner.output_name

    def evaluate(self, df, groups=None):
        from .engine.groups import layout_for_columns

        layout = layout_for_columns([df.get_column(k) for k in self.keys])
        return self.inner.evaluate(df, layout)


class SubExpr(Expr):
    """``left - right``, elementwise, null where either side is null."""

    def __init__(self, left: Expr, right: Expr):
        self.left = left
        self.right = right

    @property
    def output_name(self) -> Optional[str]:
        return self.left.output_name or self.right.output_name

    def evaluate(self, df, groups=None):
        return sub_series(self.left.evaluate(df, groups), self.right.evaluate(df, groups))


class LeastSquaresExpr(Expr):
    """The least-squares node, dispatching into the batched engine."""

    def __init__(
        self,
        target: Expr,
        features: List[Expr],
        kwargs,
        mode: str,
        add_intercept: bool = False,
        weights: Optional[Expr] = None,
    ):
        self.target = target
        self.features = features
        self.kwargs = kwargs
        self.mode = mode
        self.add_intercept = add_intercept  # engine-side 'const' column
        self.weights = weights  # engine-side WLS scaling

    @property
    def output_name(self) -> Optional[str]:
        if self.mode in ("coefficients", "statistics"):
            return self.mode
        return self.target.output_name

    def evaluate(self, df, groups=None):
        from .engine.fit import evaluate_least_squares

        feats: List[Expr] = []
        for f in self.features:
            feats.extend(f.expand(df))
        target = self.target.evaluate(df, groups)
        feat_series = [f.evaluate(df, groups) for f in feats]
        weights = None if self.weights is None else self.weights.evaluate(df, groups)
        return evaluate_least_squares(
            target,
            feat_series,
            self.kwargs,
            self.mode,
            groups,
            add_intercept=self.add_intercept,
            weights=weights,
        )


def sub_series(left: Series, right: Series) -> Series:
    """``left - right`` of two float Series of one length, named after
    ``left``; the validity is the AND of both (None when both are fully
    valid)."""
    if len(left) != len(right):
        raise ValueError(f"cannot subtract series of lengths {len(left)} and {len(right)}")
    validity = None
    if left.validity is not None or right.validity is not None:
        validity = left.valid_mask() & right.valid_mask()
    return Series(left.name, left.values - right.values, validity)


def col(name: str) -> ColExpr:
    """Column selector. ``col("^x.*$")`` expands by regex like polars."""
    if name.startswith("^") and name.endswith("$"):
        return ColExpr(name, pattern=name)
    return ColExpr(name)


def parse_into_expr(expr: ExprOrStr) -> Expr:
    """An expression, or a column name as ``col(name)``."""
    if isinstance(expr, Expr):
        return expr
    if isinstance(expr, str):
        return col(expr)
    raise TypeError(
        f"expected an expression or a column name, got {type(expr).__name__} "
        "(literals are not ported yet)"
    )
