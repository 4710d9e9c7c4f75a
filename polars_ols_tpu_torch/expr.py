"""Expression AST and evaluator (the subset the ported fits need).

Column references (exact names and ``^regex$`` patterns), literals
(``lit``), structs (``struct``), aliases, the ``.over()`` window context,
subtraction and multiplication of expressions and numbers (residuals,
formula interactions ``a:b``; field-wise on structs), ``fill_nan`` (the
rolling residuals' NaN -> null step), the least-squares node, which
dispatches into the batched engine (engine/fit.py), and the predict node.
Under ``.over()`` group ids flow into the engine as a batch axis instead
of a solver call per group.
"""

from __future__ import annotations

import numbers
import re
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .config import F64, device
from .series import Series, StructSeries

ExprOrStr = Union["Expr", str]


class Expr:
    """Base class for all expression nodes."""

    def alias(self, name: str) -> "Expr":
        return AliasExpr(self, name)

    def over(self, *keys: ExprOrStr) -> "Expr":
        return OverExpr(self, [k if isinstance(k, str) else k.output_name for k in keys])

    def __sub__(self, other) -> "Expr":
        return BinExpr("sub", self, _operand(other))

    def __mul__(self, other) -> "Expr":
        return BinExpr("mul", self, _operand(other))

    def __rmul__(self, other) -> "Expr":
        return BinExpr("mul", _operand(other), self)

    def fill_nan(self, value) -> "Expr":
        return FillNanExpr(self, value)

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


class LitExpr(Expr):
    """A literal: a number (broadcast to the frame's height), an array of
    the frame's height, or a column (``with_columns(Series(...))``)."""

    def __init__(self, value):
        self.value = value

    @property
    def output_name(self) -> Optional[str]:
        return "literal"

    def evaluate(self, df, groups=None):
        v = self.value
        if isinstance(v, (Series, StructSeries)):
            return v
        n = df.height
        if isinstance(v, numbers.Real):
            return Series("literal", torch.full((n,), float(v), dtype=F64, device=device()))
        arr = v.to(F64) if isinstance(v, torch.Tensor) else np.asarray(v, dtype=np.float64)
        if tuple(arr.shape) != (n,):
            raise ValueError(f"a literal array must have the frame's height {n}, got shape {tuple(arr.shape)}")
        return Series("literal", arr)


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


class BinExpr(Expr):
    """``left - right`` or ``left * right`` elementwise, null where either
    side is null; field-wise where a side is a struct."""

    def __init__(self, op: str, left: Expr, right: Expr):
        self.op = op
        self.left = left
        self.right = right

    @property
    def output_name(self) -> Optional[str]:
        return self.left.output_name or self.right.output_name

    def evaluate(self, df, groups=None):
        return binop_series(self.op, self.left.evaluate(df, groups), self.right.evaluate(df, groups))


class StructExpr(Expr):
    """A struct of named field expressions (``struct(...)``)."""

    def __init__(self, fields: Dict[str, Expr], name: str = "struct"):
        self.fields = fields
        self.name = name

    @property
    def output_name(self) -> Optional[str]:
        return self.name

    def evaluate(self, df, groups=None):
        cols = [e.evaluate(df, groups) for e in self.fields.values()]
        for name, c in zip(self.fields, cols):
            if not isinstance(c, Series):
                raise TypeError(f"struct field {name!r} must be a column, got {type(c).__name__}")
        values = torch.stack([c.values for c in cols], dim=1)
        validity = None
        if any(c.validity is not None for c in cols):
            validity = torch.stack([c.valid_mask() for c in cols], dim=1)
        return StructSeries(self.name, list(self.fields), values, validity, sources=tuple(cols))


class FillNanExpr(Expr):
    """``fill_nan(None)`` turns NaN values into nulls, the step the
    reference applies to rolling outputs (polars_ols/least_squares.py:
    407-409); ``fill_nan(value)`` replaces them."""

    def __init__(self, inner: Expr, value):
        self.inner = inner
        self.value = value

    @property
    def output_name(self) -> Optional[str]:
        return self.inner.output_name

    def evaluate(self, df, groups=None):
        s = self.inner.evaluate(df, groups)
        vals = s.values
        nan = torch.isnan(vals)
        if self.value is None:
            return Series(s.name, torch.where(nan, 0.0, vals), s.valid_mask() & ~nan)
        return Series(s.name, torch.where(nan, float(self.value), vals), s.validity)


class LeastSquaresExpr(Expr):
    """The least-squares node, dispatching into the batched engine;
    ``function_name`` picks the model (least_squares,
    recursive_least_squares, rolling_least_squares), ``multi_target`` a
    struct target's shared fit."""

    def __init__(
        self,
        target: Expr,
        features: List[Expr],
        kwargs,
        mode: str,
        add_intercept: bool = False,
        weights: Optional[Expr] = None,
        function_name: str = "least_squares",
        multi_target: bool = False,
    ):
        self.function_name = function_name
        self.target = target
        self.features = features
        self.kwargs = kwargs
        self.mode = mode
        self.add_intercept = add_intercept  # engine-side 'const' column
        self.weights = weights  # engine-side WLS scaling
        self.multi_target = multi_target

    @property
    def output_name(self) -> Optional[str]:
        if self.mode in ("coefficients", "statistics"):
            return self.mode
        return self.target.output_name

    def evaluate(self, df, groups=None):
        from .engine.fit import evaluate_least_squares

        target = self.target.evaluate(df, groups)
        feat_series = [f.evaluate(df, groups) for f in _expand(self.features, df)]
        weights = None if self.weights is None else self.weights.evaluate(df, groups)
        return evaluate_least_squares(
            target,
            feat_series,
            self.kwargs,
            self.mode,
            groups,
            add_intercept=self.add_intercept,
            weights=weights,
            function_name=self.function_name,
            multi_target=self.multi_target,
        )


class PredictExpr(Expr):
    """A row-aligned coefficient struct dotted with feature columns (the
    reference's ``predict``, src/expressions.rs:706-741)."""

    def __init__(self, coefficients: Expr, features: List[Expr], null_policy: str, name: str):
        self.coefficients = coefficients
        self.features = features
        self.null_policy = null_policy
        self.name = name

    @property
    def output_name(self) -> Optional[str]:
        return self.name

    def evaluate(self, df, groups=None):
        from .engine.fit import evaluate_predict

        coef = self.coefficients.evaluate(df, groups)
        feat_series = [f.evaluate(df, groups) for f in _expand(self.features, df)]
        return evaluate_predict(coef, feat_series, self.null_policy, self.name)


def _expand(exprs: List[Expr], df) -> List[Expr]:
    out: List[Expr] = []
    for e in exprs:
        out.extend(e.expand(df))
    return out


def _operand(other) -> Expr:
    """The other side of an arithmetic operator: an expression, or a number
    as a literal."""
    if isinstance(other, Expr):
        return other
    if isinstance(other, numbers.Real):
        return LitExpr(other)
    raise TypeError(
        f"arithmetic takes an expression or a number, got {type(other).__name__} "
        "(wrap an array in lit(); '+', '/' and negation are ROADMAP.md Queue 1 item 10)"
    )


_OPS = {"sub": torch.sub, "mul": torch.mul}


def binop_series(op: str, left, right):
    """``left - right`` or ``left * right`` of two columns of one length.
    Series: named after ``left`` (after ``right`` where ``left`` is a
    literal), validity the AND of both (None when both are fully valid).
    A struct side works field-wise (a Series broadcasts over the fields):
    named and fielded after the struct, validity [N, M] the AND of both."""
    if len(left) != len(right):
        raise ValueError(f"cannot combine series of lengths {len(left)} and {len(right)}")
    fn = _OPS[op]
    if isinstance(left, StructSeries) or isinstance(right, StructSeries):
        return _binop_struct(fn, left, right)
    validity = None
    if left.validity is not None or right.validity is not None:
        validity = left.valid_mask() & right.valid_mask()
    name = left.name if left.name != "literal" else right.name
    return Series(name, fn(left.values, right.values), validity)


def _binop_struct(fn, left, right):
    s = left if isinstance(left, StructSeries) else right

    def parts(side):
        if isinstance(side, StructSeries):
            return side.values, side.validity
        v = side.validity
        return side.values[:, None], None if v is None else v[:, None]

    (lv, lm), (rv, rm) = parts(left), parts(right)
    if isinstance(left, StructSeries) and isinstance(right, StructSeries):
        if len(left.field_names) != len(right.field_names):
            raise ValueError(
                f"structs of {len(left.field_names)} and {len(right.field_names)} fields"
            )
    values = fn(lv, rv)
    validity = None
    if lm is not None or rm is not None:
        ones = torch.ones(values.shape, dtype=torch.bool, device=values.device)
        validity = (ones if lm is None else lm & ones) & (ones if rm is None else rm)
    return StructSeries(s.name, s.field_names, values, validity)


def col(name: str) -> ColExpr:
    """Column selector. ``col("^x.*$")`` expands by regex like polars."""
    if name.startswith("^") and name.endswith("$"):
        return ColExpr(name, pattern=name)
    return ColExpr(name)


def lit(value) -> LitExpr:
    """A literal column: a number, an array of the frame's height, or a
    column."""
    return LitExpr(value)


def struct(*args, **named) -> StructExpr:
    """A struct of columns: positional expressions (or names) take their
    output names, keywords name their fields."""
    fields: Dict[str, Expr] = {}
    for a in args:
        e = parse_into_expr(a)
        fields[e.output_name or f"field_{len(fields)}"] = e
    for k, v in named.items():
        fields[k] = parse_into_expr(v)
    return StructExpr(fields)


def parse_into_expr(expr) -> Expr:
    """An expression; a column name as ``col(name)``; anything else as a
    literal."""
    if isinstance(expr, Expr):
        return expr
    if isinstance(expr, str):
        return col(expr)
    return lit(expr)
