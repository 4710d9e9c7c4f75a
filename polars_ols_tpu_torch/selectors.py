"""Column selectors (the subset of polars.selectors the workload uses)."""

from __future__ import annotations

from .expr import ColExpr


def starts_with(prefix: str) -> ColExpr:
    return ColExpr(f"starts_with:{prefix}", matcher="starts_with", pattern=prefix)


def all() -> ColExpr:  # noqa: A001
    return ColExpr("*", matcher="all")
