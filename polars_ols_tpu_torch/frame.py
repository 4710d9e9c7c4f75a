"""Eager columnar DataFrame over torch tensors (the main-path subset:
construction from a dict of arrays, column access and eager ``select``)."""

from __future__ import annotations

from typing import Dict, List, Optional

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

    def select(self, *exprs, **named) -> "DataFrame":
        """Evaluate each expression eagerly, in order (the fused multi-query
        select is ROADMAP Queue 1 item 9)."""
        all_exprs: List[Expr] = []
        for e in exprs:
            all_exprs.extend(parse_into_expr(e).expand(self))
        for name, e in named.items():
            all_exprs.append(parse_into_expr(e).alias(name))
        results = [e.evaluate(self) for e in all_exprs]
        heights = {len(r) for r in results}
        if len(heights) > 1:
            raise ValueError(f"select results differ in height: {sorted(heights)}")
        return DataFrame._from_columns(results)

    def __repr__(self) -> str:  # pragma: no cover
        return f"DataFrame(shape={self.shape}, columns={self.columns})"
