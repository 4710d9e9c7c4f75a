"""The one general traffic generator: a mix file's data made into the
program's select expressions.

A mix (``mixes/<name>.json``) is a closed loop of one client: ``selects``
is the cycle of selects it issues over the same frame, each a list of
fits. A fit names its kind (``ols``, ``ridge``, ``rls``,
``rolling_ols``, ``multi_target_ols``), its ``label`` (the output column),
its ``target`` (a column, or a list of columns for a struct target) and
its keyword arguments; every fit takes all of the configuration's
features, predicts, and runs per group (``.over(key)``).
"""

from __future__ import annotations

from typing import List

STATIC = ("ols", "ridge", "multi_target_ols")
MOVING = ("rls", "rolling_ols")


def targets(fit: dict) -> List[str]:
    t = fit["target"]
    return list(t) if isinstance(t, (list, tuple)) else [t]


def build_fit(pt, fit: dict, cfg: dict):
    """The program's expression of one fit."""
    col = pt.col
    feats = [col(f"x{i + 1}") for i in range(int(cfg["features"]))]
    kind, kwargs = fit["fit"], dict(fit.get("kwargs", {}))
    if kind == "multi_target_ols":
        ns = pt.struct(*[col(t) for t in targets(fit)]).least_squares
    else:
        ns = col(fit["target"]).least_squares
    if kind not in STATIC + MOVING:
        raise ValueError(f"unknown fit {kind!r}")
    return getattr(ns, kind)(*feats, **kwargs).over(cfg["key"]).alias(fit["label"])


def build_selects(pt, mix: dict, cfg: dict) -> list:
    """[[expression, ...] a select] in the cycle's order."""
    return [[build_fit(pt, fit, cfg) for fit in select] for select in mix["selects"]]
