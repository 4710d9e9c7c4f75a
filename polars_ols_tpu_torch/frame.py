"""Eager columnar DataFrame over torch tensors (the subset the fits need:
construction from a dict of arrays, column access, eager ``select`` and
``with_columns``, and ``unnest`` of struct columns)."""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .expr import Expr, parse_into_expr
from .series import Series, StatisticsSeries, StructSeries


class DataFrame:
    def __init__(self, data: Optional[Dict[str, object]] = None):
        self._columns: Dict[str, object] = {}
        for name, v in (data or {}).items():
            self._columns[name] = (
                v.alias(name) if isinstance(v, (Series, StructSeries, StatisticsSeries)) else Series(name, v)
            )
        heights = {len(c) for c in self._columns.values()}
        if len(heights) > 1:
            raise ValueError(f"column heights differ: {sorted(heights)}")

    @classmethod
    def _from_columns(cls, cols) -> "DataFrame":
        df = cls()
        for c in cols:
            df._columns[c.name] = c
        return df

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    @property
    def height(self) -> int:
        return len(next(iter(self._columns.values()))) if self._columns else 0

    @property
    def width(self) -> int:
        return len(self._columns)

    @property
    def shape(self):
        return (self.height, self.width)

    def get_column(self, name: str):
        if name not in self._columns:
            raise KeyError(f"column {name!r} not found; available: {self.columns}")
        return self._columns[name]

    def __getitem__(self, name: str):
        if not isinstance(name, str):
            raise TypeError(f"column access takes a name, got {type(name).__name__}")
        return self.get_column(name)

    def _evaluate(self, exprs, named) -> list:
        """Evaluate each expression eagerly, in order (the fused multi-query
        select is ROADMAP Queue 1 item 9)."""
        all_exprs: List[Expr] = []
        for e in exprs:
            all_exprs.extend(parse_into_expr(e).expand(self))
        for name, e in named.items():
            all_exprs.append(parse_into_expr(e).alias(name))
        return [e.evaluate(self) for e in all_exprs]

    def select(self, *exprs, **named) -> "DataFrame":
        results = self._evaluate(exprs, named)
        heights = {len(r) for r in results}
        if len(heights) > 1:
            raise ValueError(f"select results differ in height: {sorted(heights)}")
        return DataFrame._from_columns(results)

    def with_columns(self, *exprs, **named) -> "DataFrame":
        """This frame with the expressions' results added, or replacing the
        columns of their names; a one-row result (a fit without ``.over()``
        in coefficients mode) is broadcast to every row."""
        out = dict(self._columns)
        for r in self._evaluate(exprs, named):
            out[r.name] = _broadcast(r, self.height)
        return DataFrame._from_columns(list(out.values()))

    def unnest(self, *names: str) -> "DataFrame":
        """Struct columns ``names`` replaced by their fields, in place."""
        missing = [n for n in names if n not in self._columns]
        if missing:
            raise KeyError(f"columns {missing} not found; available: {self.columns}")
        out = []
        for name, c in self._columns.items():
            if name not in names:
                out.append(c)
            elif isinstance(c, StructSeries):
                out.extend(c.fields())
            elif isinstance(c, StatisticsSeries):
                raise NotImplementedError(
                    "unnest of a statistics column is not ported to polars_ols_tpu_torch yet "
                    "(ROADMAP.md Queue 1 item 10)"
                )
            else:
                raise TypeError(f"column {name!r} is not a struct")
        return DataFrame._from_columns(out)

    def __repr__(self) -> str:  # pragma: no cover
        return f"DataFrame(shape={self.shape}, columns={self.columns})"


def _broadcast(c, n: int):
    """A column of ``n`` rows: ``c`` itself, or its one row repeated."""
    if len(c) == n:
        return c
    if len(c) != 1:
        raise ValueError(f"a column of {len(c)} rows does not fit a frame of {n}")
    if isinstance(c, StatisticsSeries):
        return c.gather(torch.zeros(n, dtype=torch.int64))
    if isinstance(c, StructSeries):
        validity = None if c.validity is None else c.validity.expand(n, -1)
        return StructSeries(c.name, c.field_names, c.values.expand(n, -1), validity)
    validity = None if c.validity is None else c.validity.expand(n)
    return Series(c.name, c.values.expand(n), validity)
