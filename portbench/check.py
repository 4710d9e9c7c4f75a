"""The comparison that decides ``correct``.

A run keeps what its timed selects returned at a sample drawn from the
seed: for every select of the cycle, its first run in the window and one
later run, each at every row of a sample of groups (``check_groups`` of
the mix, drawn from the seed, with the largest group always among them).
Once the window has closed, the plain reference (``reference/``) fits
those groups again from the benchmark's own inputs and each output column
is compared:

- ``err.<label>`` (``err.<label>.<field>`` for a struct target): the
  largest gap between a program answer and the reference's over the
  sampled rows where both have one, over the reference's largest
  magnitude there. Non-finite where either side gives a non-finite
  number at a row that has an answer.
- ``nulls``: rows whose null status differs from the reference's (NaN
  where no window was solved yet), over every column; limit 0.

Each number has its limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from .reference import moving as ref_moving
from .reference import static as ref_static
from .traffic import MOVING, targets

LATER_RUNS = 16  # the later run kept of each select is drawn from its runs 1 .. LATER_RUNS - 1


def plan(mix: dict, cfg: dict, key: np.ndarray, seed: int):
    """(rows, group of each row, runs): the sampled rows in row order, and
    for each select of the cycle the runs of it whose answers are kept."""
    rng = np.random.default_rng(int(seed) & ((1 << 63) - 1))
    counts = np.bincount(key, minlength=int(cfg["groups"]))
    present = np.flatnonzero(counts)
    n = min(int(mix["check_groups"]), len(present))
    chosen = set(rng.choice(present, size=n, replace=False).tolist())
    chosen.add(int(np.argmax(counts)))
    rows = np.flatnonzero(np.isin(key, np.fromiter(chosen, np.int64)))
    runs = [{0, int(rng.integers(1, LATER_RUNS))} for _ in mix["selects"]]
    return rows, key[rows], runs


def _answers(series) -> tuple:
    """(values, null) on the host of an output column; a struct's are [n, M]."""
    vals = series.values.cpu().numpy()
    null = np.zeros(vals.shape, bool) if series.validity is None else ~series.validity.cpu().numpy()
    return vals, null | np.isnan(vals)


def keep(out, fits: List[dict], rows_dev) -> Dict[str, tuple]:
    """label -> (values, null) of one select's output at the sampled rows,
    gathered on the device, copied to the host after the window."""
    kept = {}
    for fit in fits:
        s = out[fit["label"]]
        kept[fit["label"]] = s.gather(rows_dev)
    return kept


def to_host(kept: Dict[str, object]) -> Dict[str, tuple]:
    return {label: _answers(s) for label, s in kept.items()}


def reference(mix: dict, cfg: dict, host: dict, gids: np.ndarray, dtype=np.float64) -> Dict[str, np.ndarray]:
    """label -> the reference's answers at the sampled rows ([n] or [n, M],
    NaN where the reference gives none), in ``dtype``."""
    order = np.argsort(gids, kind="stable")
    bounds = np.flatnonzero(np.diff(gids[order])) + 1
    groups = np.split(order, bounds)  # each group's positions among the sampled rows, in row order
    x = host["x"]
    out = {}
    fits = {fit["label"]: fit for select in mix["selects"] for fit in select}
    for label, fit in fits.items():
        ys = [host[t] for t in targets(fit)]
        Y = ys[0] if len(ys) == 1 else np.stack(ys, axis=1)
        pred = np.full(Y.shape, np.nan, dtype)
        kind, kw = fit["fit"], fit.get("kwargs", {})
        if kind == "rls":
            got = ref_moving.rls([(x[g], Y[g]) for g in groups], float(kw["half_life"]), dtype=dtype)
            for g, p in zip(groups, got):
                pred[g] = p
        elif kind == "rolling_ols":
            mp = kw.get("min_periods") or min(x.shape[1], int(kw["window_size"]))
            for g in groups:
                pred[g] = ref_moving.rolling(x[g], Y[g], int(kw["window_size"]), mp, dtype)
        elif kind not in MOVING:
            for g in groups:
                pred[g] = ref_static.predictions(fit, x[g], Y[g], dtype)
        else:
            raise ValueError(f"no reference for fit {kind!r}")
        out[label] = pred
    return out


def _gap(p: np.ndarray, r: np.ndarray, both: np.ndarray) -> float:
    if not both.any():
        return 0.0
    d, scale = np.abs(p[both] - r[both]), np.abs(r[both]).max()
    if not (np.isfinite(d).all() and math.isfinite(scale)):
        return math.inf
    return float(d.max() / scale) if scale > 0 else float(d.max())


def compare(mix: dict, samples: List[Dict[str, tuple]], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The compared numbers of the kept answers ``samples`` (each label ->
    (values, null)) against the reference's answers ``ref``."""
    fits = {fit["label"]: fit for select in mix["selects"] for fit in select}
    nums: Dict[str, float] = {}
    nulls = 0
    for sample in samples:
        for label, (vals, null) in sample.items():
            r = ref[label]
            rnull = np.isnan(r)
            nulls += int((null != rnull).sum())
            both = ~null & ~rnull
            names = targets(fits[label])
            if vals.ndim == 1:
                gaps = {f"err.{label}": _gap(vals, r, both)}
            else:
                gaps = {f"err.{label}.{t}": _gap(vals[:, j], r[:, j], both[:, j]) for j, t in enumerate(names)}
            for name, gap in gaps.items():
                nums[name] = max(nums.get(name, 0.0), gap)
    nums["nulls"] = float(nulls)
    return nums


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit, and no number without one."""
    return set(nums) == set(limits) and all(nums[k] <= limits[k] for k in nums)
