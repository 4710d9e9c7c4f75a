"""Expression AST and evaluator.

Column references (exact names, ``^regex$`` patterns and the selectors of
``selectors.py``), literals (``lit``), structs (``struct``), aliases and
``.meta.output_name``, the ``.over()`` window context, arithmetic
(``+ - * / **``, negation; field-wise on structs), comparisons and ``& | ~``
(0 / 1 columns, null where an operand is), elementwise functions (``abs``,
``exp``, ``log``, ``log1p``, ``sqrt``, ``round``, ``clip``), ``shift``,
``fill_null`` / ``fill_nan`` / ``forward_fill`` / ``is_null``, the
reductions (a one-row column in a select; a row per group under
``GroupBy.agg``, as segment sums / mins / maxes on the device), the
least-squares node, which dispatches into the batched engine
(engine/fit.py), and the predict node. Under ``.over()`` group ids flow
into the engine as a batch axis instead of a solver call per group.
Values are computed on ``CONFIG.device``.
"""

from __future__ import annotations

import numbers
import re
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .config import F64, device
from .series import ObjectSeries, Series, StructSeries

ExprOrStr = Union["Expr", str]


class Expr:
    """Base class for all expression nodes."""

    def _binop(self, other, op: str, reflected: bool = False) -> "Expr":
        other = _operand(other)
        return BinExpr(op, other, self) if reflected else BinExpr(op, self, other)

    def __add__(self, other):
        return self._binop(other, "add")

    def __radd__(self, other):
        return self._binop(other, "add", True)

    def __sub__(self, other):
        return self._binop(other, "sub")

    def __rsub__(self, other):
        return self._binop(other, "sub", True)

    def __mul__(self, other):
        return self._binop(other, "mul")

    def __rmul__(self, other):
        return self._binop(other, "mul", True)

    def __truediv__(self, other):
        return self._binop(other, "div")

    def __rtruediv__(self, other):
        return self._binop(other, "div", True)

    def __pow__(self, other):
        return self._binop(other, "pow")

    def __neg__(self):
        return UnaryExpr("neg", self)

    # comparisons and boolean algebra (filter predicates); defining __eq__
    # would clear __hash__: expressions hash by identity
    __hash__ = object.__hash__

    def __gt__(self, other):
        return self._binop(other, "gt")

    def __ge__(self, other):
        return self._binop(other, "ge")

    def __lt__(self, other):
        return self._binop(other, "lt")

    def __le__(self, other):
        return self._binop(other, "le")

    def __eq__(self, other):  # noqa: PLW0177 - a polars-style expression
        return self._binop(other, "eq")

    def __ne__(self, other):
        return self._binop(other, "ne")

    def __and__(self, other):
        return self._binop(other, "and")

    def __rand__(self, other):
        return self._binop(other, "and", True)

    def __or__(self, other):
        return self._binop(other, "or")

    def __ror__(self, other):
        return self._binop(other, "or", True)

    def __invert__(self):
        return UnaryExpr("not", self)

    def __bool__(self):
        # `e1 == e2` builds an expression: a bare truth test would pass
        # silently, so it raises as in polars
        raise TypeError(
            "the truth value of an Expr is ambiguous; to combine or compare "
            "expressions use &, |, ==, etc. and evaluate through a frame"
        )

    def add(self, other):
        return self + other

    def sub(self, other):
        return self - other

    def mul(self, other):
        return self * other

    def pow(self, other):
        return self**other

    def abs(self):
        return UnaryExpr("abs", self)

    def exp(self):
        return UnaryExpr("exp", self)

    def log(self):
        return UnaryExpr("log", self)

    def log1p(self):
        return UnaryExpr("log1p", self)

    def sqrt(self):
        return UnaryExpr("sqrt", self)

    def round(self, decimals: int = 0):
        return RoundExpr(self, decimals)

    def clip(self, lower_bound=None, upper_bound=None):
        return ClipExpr(self, lower_bound, upper_bound)

    def shift(self, n: int = 1):
        return ShiftExpr(self, n)

    def alias(self, name: str) -> "Expr":
        return AliasExpr(self, name)

    def fill_null(self, value: float) -> "Expr":
        return FillNullExpr(self, value)

    def fill_nan(self, value) -> "Expr":
        return FillNanExpr(self, value)

    def is_null(self) -> "Expr":
        return UnaryExpr("is_null", self)

    def is_not_null(self) -> "Expr":
        return UnaryExpr("is_not_null", self)

    def forward_fill(self) -> "Expr":
        return UnaryExpr("forward_fill", self)

    # reductions: one row in a select, one row per group under GroupBy.agg
    def sum(self) -> "Expr":
        return AggExpr(self, "sum")

    def mean(self) -> "Expr":
        return AggExpr(self, "mean")

    def min(self) -> "Expr":
        return AggExpr(self, "min")

    def max(self) -> "Expr":
        return AggExpr(self, "max")

    def count(self) -> "Expr":
        return AggExpr(self, "count")

    def n_unique(self) -> "Expr":
        return AggExpr(self, "n_unique")

    def std(self, ddof: int = 1) -> "Expr":
        return AggExpr(self, "std", ddof=ddof)

    def var(self, ddof: int = 1) -> "Expr":
        return AggExpr(self, "var", ddof=ddof)

    def first(self) -> "Expr":
        return AggExpr(self, "first")

    def last(self) -> "Expr":
        return AggExpr(self, "last")

    def over(self, *keys: ExprOrStr) -> "Expr":
        return OverExpr(self, [k if isinstance(k, str) else k.output_name for k in keys])

    @property
    def meta(self) -> "_ExprMeta":
        return _ExprMeta(self)

    @property
    def output_name(self) -> Optional[str]:
        return None

    @property
    def least_squares(self):
        from .namespace import LeastSquares

        return LeastSquares(self)

    def expand(self, df) -> List["Expr"]:
        """Expand regex and selector column references against a frame's
        schema (polars' wildcard expansion, which the reference relies on,
        polars_ols/least_squares.py:226-233)."""
        return [self]

    def evaluate(self, df, groups=None):
        raise NotImplementedError

    def evaluate_grouped(self, df, layout, first_idx):
        """One row per group under ``GroupBy.agg``: evaluated in the
        ``.over()`` context (where results are group-constant, e.g.
        coefficients), each group's first row kept. Reductions override
        this with segment reductions."""
        return self.evaluate(df, layout).gather(first_idx)


class _ExprMeta:
    def __init__(self, expr: Expr):
        self._expr = expr

    @property
    def output_name(self) -> Optional[str]:
        return self._expr.output_name


class ColExpr(Expr):
    """Column reference: an exact name, a ``^regex$`` pattern, or a
    selector of ``selectors.py`` (a name prefix, every column)."""

    def __init__(self, name: str, matcher: Optional[str] = None, pattern: Optional[str] = None):
        self.name = name
        self.matcher = matcher  # None | "regex" | "starts_with" | "all"
        self.pattern = pattern

    @property
    def output_name(self) -> Optional[str]:
        return None if self.matcher else self.name

    def expand(self, df) -> List[Expr]:
        if self.matcher is None:
            return [self]
        names = df.columns
        if self.matcher == "regex":
            rx = re.compile(self.pattern)
            return [ColExpr(n) for n in names if rx.search(n)]
        if self.matcher == "starts_with":
            return [ColExpr(n) for n in names if n.startswith(self.pattern)]
        if self.matcher == "all":
            return [ColExpr(n) for n in names]
        raise ValueError(f"unknown column matcher {self.matcher!r}")

    def evaluate(self, df, groups=None):
        if self.matcher is not None:
            raise ValueError(f"column selector {self.name!r} must be expanded first")
        return df.get_column(self.name)


class LitExpr(Expr):
    """A literal: a number (broadcast to the frame's height), ``None`` (an
    all-null column), an array of the frame's height, or a column
    (``with_columns(Series(...))``)."""

    def __init__(self, value):
        self.value = value

    @property
    def output_name(self) -> Optional[str]:
        return "literal"

    def evaluate(self, df, groups=None):
        v = self.value
        if isinstance(v, (Series, StructSeries, ObjectSeries)):
            return v
        n = df.height
        if v is None:
            dev = device()
            return Series("literal", torch.zeros(n, dtype=F64, device=dev), torch.zeros(n, dtype=torch.bool, device=dev))
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

    def evaluate_grouped(self, df, layout, first_idx):
        return self.inner.evaluate_grouped(df, layout, first_idx).alias(self.name)


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
    """``left <op> right`` elementwise, null where either side is null;
    field-wise where a side is a struct."""

    def __init__(self, op: str, left: Expr, right: Expr):
        self.op = op
        self.left = left
        self.right = right

    @property
    def output_name(self) -> Optional[str]:
        return self.left.output_name or self.right.output_name

    def evaluate(self, df, groups=None):
        return binop_series(self.op, self.left.evaluate(df, groups), self.right.evaluate(df, groups))


_UNARY = {
    "neg": torch.neg,
    "abs": torch.abs,
    "exp": torch.exp,
    "log": torch.log,
    "log1p": torch.log1p,
    "sqrt": torch.sqrt,
    "not": lambda v: (v == 0.0).to(F64),
}


class UnaryExpr(Expr):
    """An elementwise function of one column (validity kept), or its null
    mask (``is_null`` / ``is_not_null``), or ``forward_fill``."""

    def __init__(self, op: str, inner: Expr):
        self.op = op
        self.inner = inner

    @property
    def output_name(self) -> Optional[str]:
        return self.inner.output_name

    def evaluate(self, df, groups=None):
        s = self.inner.evaluate(df, groups)
        if self.op in ("is_null", "is_not_null", "forward_fill"):
            return getattr(s, self.op)()
        return Series(s.name, _UNARY[self.op](s.f64()), s.validity)


class RoundExpr(Expr):
    """Rounding to ``decimals`` places, half to even."""

    def __init__(self, inner: Expr, decimals: int):
        self.inner = inner
        self.decimals = int(decimals)

    @property
    def output_name(self) -> Optional[str]:
        return self.inner.output_name

    def evaluate(self, df, groups=None):
        s = self.inner.evaluate(df, groups)
        return Series(s.name, torch.round(s.f64(), decimals=self.decimals), s.validity)


class ClipExpr(Expr):
    def __init__(self, inner: Expr, lower_bound=None, upper_bound=None):
        self.inner = inner
        self.lower = lower_bound
        self.upper = upper_bound

    @property
    def output_name(self) -> Optional[str]:
        return self.inner.output_name

    def evaluate(self, df, groups=None):
        s = self.inner.evaluate(df, groups)
        vals = s.f64()
        if self.lower is not None:
            vals = torch.clamp(vals, min=float(self.lower))
        if self.upper is not None:
            vals = torch.clamp(vals, max=float(self.upper))
        return Series(s.name, vals, s.validity)


class ShiftExpr(Expr):
    """The column moved ``n`` rows down (up for n < 0), with nulls where
    it has no row to take (polars' ``Expr.shift`` in a select)."""

    def __init__(self, inner: Expr, n: int):
        self.inner = inner
        self.n = int(n)

    @property
    def output_name(self) -> Optional[str]:
        return self.inner.output_name

    def evaluate(self, df, groups=None):
        s = self.inner.evaluate(df, groups)
        vals, n = s.f64(), self.n
        pos = torch.arange(len(vals), device=vals.device)
        edge = pos < n if n >= 0 else pos >= len(vals) + n
        out = torch.where(edge, 0.0, torch.roll(vals, n))
        return Series(s.name, out, torch.roll(s.valid_mask(), n) & ~edge)


class FillNullExpr(Expr):
    def __init__(self, inner: Expr, value: float):
        self.inner = inner
        self.value = value

    @property
    def output_name(self) -> Optional[str]:
        return self.inner.output_name

    def evaluate(self, df, groups=None):
        return self.inner.evaluate(df, groups).fill_null(self.value)


class AggExpr(Expr):
    """A reduction: one row in a select context; one row per group under
    ``GroupBy.agg``, by segment reductions on the device (``index_add_``
    sums, ``scatter_reduce`` minima and maxima over the layout's group ids).
    Nulls are left out; ``mean`` / ``min`` / ``max`` of a group without a
    valid row are null, ``std`` / ``var`` of a group of at most ``ddof``."""

    def __init__(self, inner: Expr, op: str, ddof: int = 1):
        self.inner = inner
        self.op = op
        self.ddof = ddof

    @property
    def output_name(self) -> Optional[str]:
        return self.inner.output_name

    def _reduce(self, vals, valid, gids, G: int):
        """(values [G], validity [G] or None) of the reduction."""
        dev = vals.device

        def seg(v):
            return torch.zeros(G, dtype=F64, device=dev).index_add_(0, gids, v)

        x = torch.where(valid, vals, 0.0)
        n = seg(valid.to(F64))
        if self.op == "count":
            return n, None
        if self.op == "sum":
            return seg(x), None
        mean = seg(x) / torch.clamp(n, min=1.0)
        if self.op == "mean":
            return mean, n > 0
        if self.op in ("var", "std"):
            dev_ = torch.where(valid, vals - mean.index_select(0, gids), 0.0)
            var = seg(dev_ * dev_) / torch.clamp(n - self.ddof, min=1.0)
            return (torch.sqrt(var) if self.op == "std" else var), n > self.ddof
        if self.op in ("min", "max"):
            fill = torch.inf if self.op == "min" else -torch.inf
            out = torch.full((G,), fill, dtype=F64, device=dev)
            out.scatter_reduce_(0, gids, torch.where(valid, vals, fill), "amin" if self.op == "min" else "amax")
            return out, n > 0
        raise ValueError(f"unknown reduction {self.op!r}")

    def evaluate(self, df, groups=None):
        s = self.inner.evaluate(df, None)
        if self.op in ("first", "last"):
            return s.gather(np.asarray([0 if self.op == "first" else len(s) - 1]))
        if self.op == "n_unique":
            vals = s.to_numpy()
            return Series(s.name, np.asarray([float(len(np.unique(vals[~np.isnan(vals)])))]))
        vals = s.f64()
        gids = torch.zeros(len(vals), dtype=torch.int64, device=vals.device)
        out, ok = self._reduce(vals, s.valid_mask(), gids, 1)
        return Series(s.name, out, ok)

    def evaluate_grouped(self, df, layout, first_idx):
        s = self.inner.evaluate(df, None)
        G = layout.num_groups
        if self.op in ("first", "last"):
            starts = np.zeros(G, dtype=np.int64)
            np.cumsum(layout.counts[:-1], out=starts[1:])
            at = starts if self.op == "first" else starts + layout.counts - 1
            return s.gather(layout.order[at])
        if self.op == "n_unique":
            # lexsort by (group, value), then count group starts and value
            # changes: host work, no per-group loop
            vals = s.to_numpy().astype(float)
            finite = ~np.isnan(vals)
            v, g = vals[finite], layout.gids[finite]
            out = np.zeros(G)
            if len(v):
                order = np.lexsort((v, g))
                gs, vs = g[order], v[order]
                new = np.empty(len(gs), dtype=bool)
                new[0] = True
                new[1:] = (gs[1:] != gs[:-1]) | (vs[1:] != vs[:-1])
                out = np.bincount(gs[new], minlength=G)[:G].astype(float)
            return Series(s.name, out)
        out, ok = self._reduce(s.f64(), s.valid_mask(), layout.device_gids(), G)
        return Series(s.name, out, ok)


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
        values = torch.stack([c.f64() for c in cols], dim=1)
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
        vals = s.f64()
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

    def inputs(self, df, groups=None):
        """(target, features, weights) evaluated under ``groups``."""
        target = self.target.evaluate(df, groups)
        feat_series = [f.evaluate(df, groups) for f in _expand(self.features, df)]
        weights = None if self.weights is None else self.weights.evaluate(df, groups)
        return target, feat_series, weights

    def evaluate(self, df, groups=None):
        from .engine.fit import evaluate_least_squares

        target, feat_series, weights = self.inputs(df, groups)
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
    """The other side of an operator: an expression, else a literal."""
    return other if isinstance(other, Expr) else LitExpr(other)


_OPS = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "pow": torch.pow,
    "gt": torch.gt,
    "ge": torch.ge,
    "lt": torch.lt,
    "le": torch.le,
    "eq": torch.eq,
    "ne": torch.ne,
    "and": lambda a, b: (a != 0.0) & (b != 0.0),
    "or": lambda a, b: (a != 0.0) | (b != 0.0),
}
_STRUCT_OPS = ("add", "sub", "mul", "div")


def binop_series(op: str, left, right):
    """``left <op> right`` of two columns of one length, or of a column and
    a one-row column (broadcast). Arithmetic gives f64, comparisons and
    ``and`` / ``or`` 0 / 1 (null where an operand is, as polars' non-Kleene
    operators). Series: named after ``left`` (after ``right`` where
    ``left`` is a literal), validity the AND of both (None when both are
    fully valid). A struct side works field-wise for + - * / (a Series
    broadcasts over the fields): named and fielded after the struct,
    validity [N, M] the AND of both."""
    fn = _OPS[op]
    if isinstance(left, StructSeries) or isinstance(right, StructSeries):
        if op not in _STRUCT_OPS:
            raise TypeError(f"operator {op!r} does not apply to a struct column")
        if len(left) != len(right):
            raise ValueError(f"cannot combine series of lengths {len(left)} and {len(right)}")
        return _binop_struct(fn, left, right)
    n = max(len(left), len(right))
    if min(len(left), len(right)) != n and min(len(left), len(right)) != 1:
        raise ValueError(f"cannot combine series of lengths {len(left)} and {len(right)}")

    def values(s):
        v = s.f64()
        return v.expand(n) if len(v) == 1 and n > 1 else v

    def valid(s):
        m = s.valid_mask()
        return m.expand(n) if len(m) == 1 and n > 1 else m

    validity = None
    if left.validity is not None or right.validity is not None:
        validity = valid(left) & valid(right)
    out = fn(values(left), values(right))
    name = left.name if left.name != "literal" else right.name
    return Series(name, out.to(F64) if out.dtype == torch.bool else out, validity)


def _binop_struct(fn, left, right):
    s = left if isinstance(left, StructSeries) else right

    def parts(side):
        if isinstance(side, StructSeries):
            return side.values, side.validity
        v = side.validity
        return side.f64()[:, None], None if v is None else v[:, None]

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
    """Column selector. ``col("^x.*$")`` expands by regex like polars,
    ``col("*")`` to every column."""
    if name == "*":
        return ColExpr(name, matcher="all")
    if name.startswith("^") and name.endswith("$"):
        return ColExpr(name, matcher="regex", pattern=name)
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
