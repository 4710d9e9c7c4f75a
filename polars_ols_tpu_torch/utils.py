"""Formula parsing, timing, profiling and device syncs.

The subset of the patsy grammar the reference supports without patsy
(polars_ols/utils.py:61-108): ``~`` separates the dependent variable, ``+``
adds terms, ``a:b`` is the product of columns (aliased ``"a:b"``), the
intercept is on by default and removed by ``- 1`` / ``+ 0``, and ``- term``
removes a term left to right. Categorical ``C(...)`` terms and function
terms are refused, as the reference's asserts refuse them
(utils.py:99-102).
"""

from __future__ import annotations

import os
import re
import tempfile
import time
from contextlib import contextmanager
from functools import reduce
from typing import List, Optional, Tuple

import torch

from .config import device
from .expr import Expr, col

_TERM = re.compile(r"[A-Za-z_][\w.]*(:[A-Za-z_][\w.]*)*")


def build_expressions_from_patsy_formula(
    formula: str, include_dependent_variable: bool = False
) -> Tuple[List[Expr], bool]:
    """The expressions of a patsy-style formula and whether it keeps the
    intercept.

    Example:
        >>> exprs, intercept = build_expressions_from_patsy_formula(
        ...     "y ~ x1 + x2 + x3:x4 - 1", include_dependent_variable=True)
        >>> [e.output_name for e in exprs], intercept
        (['y', 'x1', 'x2', 'x3:x4'], False)

        Term removal works like patsy's, left to right: ``x1 + x2 - x2``
        keeps ``x1``, and removing an absent term changes nothing.
    """
    if include_dependent_variable:
        if "~" not in formula:
            raise AssertionError("formula must contain '~' to include a dependent variable")
        lhs, rhs = formula.split("~", 1)
        lhs_terms = [t.strip() for t in lhs.split("+") if t.strip()]
        if len(lhs_terms) != 1:
            raise AssertionError("only one dependent variable is supported")
    else:
        rhs = formula.split("~", 1)[-1]
        lhs_terms = []

    add_intercept = True
    terms: List[str] = []
    # tokens split before each sign, so that '-1' / '+0' stay whole
    for raw in re.split(r"(?=[+-])", rhs.replace(" ", "")):
        t = raw.lstrip("+")
        if not t:
            continue
        if t in ("-1", "0"):
            add_intercept = False
        elif t == "1":
            add_intercept = True
        elif t.startswith("-"):
            terms = [term for term in terms if term != t[1:]]
        elif t not in terms:
            terms.append(t)

    if any("C(" in t for t in terms):
        raise AssertionError("categorical variables are not yet supported")
    for t in terms:
        if not _TERM.fullmatch(t):
            raise AssertionError(
                f"formula term {t!r} is not supported (transformation functions are not handled)"
            )

    exprs: List[Expr] = [col(t) for t in lhs_terms]
    for t in terms:
        if ":" in t:
            exprs.append(reduce(lambda a, b: a * b, [col(p) for p in t.split(":")]).alias(t))
        else:
            exprs.append(col(t))
    return exprs, add_intercept


@contextmanager
def timer(msg: Optional[str] = None, precision: int = 3):
    """Wall-clock timer that prints milliseconds (reference utils.py:111-118);
    the block gets a callable that returns the seconds elapsed so far."""
    start = time.perf_counter()
    end = None
    try:
        yield lambda: (end or time.perf_counter()) - start
    finally:
        end = time.perf_counter()
        print(f"{msg or 'task'} took: {(end - start) * 1_000:.{precision}f} ms")


@contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block with ``torch.profiler`` (host activity,
    and the device's kernels and copies when ``CONFIG.device`` is a CUDA
    device) and write it to ``<log_dir>/trace.json`` as a Chrome trace
    (open it in Perfetto or ``chrome://tracing``: the host's launches on
    the CPU rows, the kernels on the GPU stream rows, with their names,
    grids and durations). ``log_dir`` defaults to a directory under the
    temporary directory; the block gets ``log_dir``.

    Example:
        with trace("traces/over"):
            df.select(col("y").least_squares.ols("x1").over("g"))
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "pols_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    on_card = device().type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        yield log_dir
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _leaf(x):
    """A tensor that ``x`` (a series, or a tensor) keeps its values in."""
    from .series import BlockPermuted, StatisticsSeries, StructSeries

    if isinstance(x, StatisticsSeries):
        return x._base["r2"]
    if isinstance(x, StructSeries):
        return x.values
    v = getattr(x, "_values", x)
    return v.flat if isinstance(v, BlockPermuted) else v


def device_sync(x) -> None:
    """Wait for the device work behind ``x`` (a series or a tensor) to
    finish: ``torch.cuda.synchronize`` of its device where it is a CUDA
    tensor, nothing on the CPU. A deferred row order is not materialised."""
    leaf = _leaf(x)
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
