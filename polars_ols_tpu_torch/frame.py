"""Eager columnar DataFrame over torch tensors, with a deferred LazyFrame.

The slice of the polars engine that polars_ols relies on (reference layer
L3, SURVEY §1): column storage with validity masks, expression evaluation
with scalar broadcasting, row selection (filter, head / tail / slice,
sort, unique, drop_nulls), joins (inner / left / full / semi / anti /
cross), group_by / partition_by, struct and statistics unnesting,
explode, concat and the host conversions.

Value columns stay on ``CONFIG.device``: rows are selected, reordered and
joined by one gather a column (``index_select``), and a mask an expression
computes stays on the device (``torch.nonzero``). The row positions of
sort, unique, join and group_by are computed on the host from the key
columns (numpy and the port's native factorizer, engine/groups.py), as the
JAX package computes them; only key columns make that trip. Object
columns (``ObjectSeries``) live on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .config import F64, device
from .expr import Expr, col, parse_into_expr
from .series import (
    AnySeries, ObjectSeries, Series, StatisticsSeries, StructSeries, device_index, host_index,
)


def _to_series(name: str, data) -> AnySeries:
    if isinstance(data, (Series, StructSeries, StatisticsSeries, ObjectSeries)):
        return data.alias(name)
    if isinstance(data, np.ndarray) and data.dtype == object:
        return ObjectSeries(name, list(data))
    if isinstance(data, (list, tuple)) and len(data) and isinstance(data[0], str):
        return ObjectSeries(name, list(data))
    return Series(name, data)


def _on_host(c) -> bool:
    """Whether a column's rows live on the host (object and key columns)."""
    return isinstance(c, ObjectSeries) or (isinstance(c, Series) and isinstance(c._values, np.ndarray))


class _Rows:
    """Row positions for a frame's columns: each column takes them in its
    own place, host numpy or a device tensor, each form made once."""

    def __init__(self, idx):
        self._host = None if isinstance(idx, torch.Tensor) else np.asarray(idx, dtype=np.int64)
        self._dev = idx if isinstance(idx, torch.Tensor) else None

    def __len__(self) -> int:
        return len(self._host) if self._host is not None else int(self._dev.shape[0])

    def host(self) -> np.ndarray:
        if self._host is None:
            self._host = host_index(self._dev)
        return self._host

    def dev(self) -> torch.Tensor:
        if self._dev is None:
            self._dev = device_index(self._host, device())
        return self._dev

    def take(self, c):
        return c.gather(self.host() if _on_host(c) else self.dev())


class DataFrame:
    def __init__(self, data=None, schema: Optional[List[str]] = None):
        self._columns: Dict[str, AnySeries] = {}
        if data is None:
            return
        if isinstance(data, dict):
            for name, v in data.items():
                self._columns[name] = _to_series(name, v)
        elif isinstance(data, np.ndarray):
            if schema is None or data.ndim != 2 or data.shape[1] != len(schema):
                raise ValueError("2-D data takes a schema of one name a column")
            for j, name in enumerate(schema):
                self._columns[name] = Series(name, data[:, j])
        elif isinstance(data, list) and data and isinstance(data[0], (Series, StructSeries, ObjectSeries)):
            for s in data:
                self._columns[s.name] = s
        else:
            raise TypeError(f"unsupported DataFrame source: {type(data).__name__}")
        heights = {len(c) for c in self._columns.values()}
        if len(heights) > 1:
            raise ValueError(f"column heights differ: {sorted(heights)}")

    @classmethod
    def _from_columns(cls, cols: Sequence[AnySeries]) -> "DataFrame":
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

    def __len__(self) -> int:
        return self.height

    def get_column(self, name: str):
        if name not in self._columns:
            raise KeyError(f"column {name!r} not found; available: {self.columns}")
        return self._columns[name]

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.get_column(key)
        if isinstance(key, (list, tuple)):
            return self.select(*[col(k) for k in key])
        if isinstance(key, int):
            return self._take_rows(np.asarray([key if key >= 0 else self.height + key]))
        if isinstance(key, slice):
            return self._take_rows(np.arange(self.height)[key])
        raise TypeError(f"a frame is indexed by a name, names, a row or a slice, not {type(key).__name__}")

    # ------------------------------------------------------------------ #
    def _evaluate(self, exprs, named) -> list:
        """The expressions' columns, in order: where there are two or
        more, their fits run together (engine/batch.py: shared moments,
        batched solves, one host read) and anything else is evaluated on
        its own in its place."""
        all_exprs: List[Expr] = []
        for e in exprs:
            all_exprs.extend(parse_into_expr(e).expand(self))
        for name, e in named.items():
            all_exprs.append(parse_into_expr(e).alias(name))
        if len(all_exprs) > 1:
            from .engine.batch import try_fused_select

            fused = try_fused_select(self, all_exprs)
            if fused is not None:
                return fused
        return [e.evaluate(self) for e in all_exprs]

    def select(self, *exprs, **named) -> "DataFrame":
        """The expressions' results; one-row results (reductions, a fit
        without ``.over()`` in coefficients mode) beside longer ones are
        broadcast to their height, as in polars."""
        results = self._evaluate(exprs, named)
        heights = {len(r) for r in results}
        if len(heights) > 1:
            n = max(heights)
            results = [_broadcast(r, n) for r in results]
        return DataFrame._from_columns(results)

    def with_columns(self, *exprs, **named) -> "DataFrame":
        """This frame with the expressions' results added, or replacing the
        columns of their names; a one-row result is broadcast to every
        row."""
        out = dict(self._columns)
        for r in self._evaluate(exprs, named):
            out[r.name] = _broadcast(r, self.height)
        return DataFrame._from_columns(list(out.values()))

    def with_row_index(self, name: str = "index") -> "DataFrame":
        idx = Series(name, torch.arange(self.height, dtype=F64, device=device()))
        return DataFrame._from_columns([idx, *self._columns.values()])

    def drop(self, *names) -> "DataFrame":
        gone = set()
        for n in names:
            gone.update(n if isinstance(n, (list, tuple)) else [n])
        return DataFrame._from_columns([c for k, c in self._columns.items() if k not in gone])

    def rename(self, mapping: Dict[str, str]) -> "DataFrame":
        return DataFrame._from_columns([c.alias(mapping.get(k, k)) for k, c in self._columns.items()])

    # ------------------------------------------------------------------ #
    def _take_rows(self, idx) -> "DataFrame":
        rows = _Rows(idx)
        return DataFrame._from_columns([rows.take(c) for c in self._columns.values()])

    def filter(self, mask) -> "DataFrame":
        """Rows where ``mask`` is true: an expression (its nulls count as
        false; evaluated and selected on the device) or a bool array."""
        if isinstance(mask, Expr):
            s = mask.evaluate(self)
            m = (s.f64() != 0.0) & s.valid_mask()
        elif isinstance(mask, torch.Tensor):
            m = mask.to(torch.bool)
        else:
            m = np.asarray(mask, dtype=bool)
        if isinstance(m, torch.Tensor):
            return self._take_rows(torch.nonzero(m).flatten())
        return self._take_rows(np.flatnonzero(m))

    def fill_null(self, value: float) -> "DataFrame":
        return DataFrame._from_columns(
            [c.fill_null(value) if isinstance(c, Series) else c for c in self._columns.values()]
        )

    def fill_nan(self, value) -> "DataFrame":
        """NaN values of float columns replaced by ``value``, or made null
        by ``None``."""
        cols = []
        for c in self._columns.values():
            if isinstance(c, Series) and c.is_float:
                vals = c.f64()
                nan = torch.isnan(vals)
                if value is None:
                    cols.append(Series(c.name, torch.where(nan, 0.0, vals), c.valid_mask() & ~nan))
                else:
                    cols.append(Series(c.name, torch.where(nan, float(value), vals), c.validity))
            else:
                cols.append(c)
        return DataFrame._from_columns(cols)

    def drop_nulls(self, subset: Optional[List[str]] = None) -> "DataFrame":
        """Rows without a null in ``subset`` (every column by default); a
        struct row is null where all its fields are."""
        mask = torch.ones(self.height, dtype=torch.bool, device=device())
        for n in subset or self.columns:
            c = self.get_column(n)
            if isinstance(c, Series) and c.validity is not None:
                mask &= c.validity
            elif isinstance(c, StructSeries) and c.validity is not None:
                mask &= c.validity.any(dim=1)  # a struct row is null where every field is
        return self.filter(mask)

    # ------------------------------------------------------------------ #
    def unnest(self, *names: str) -> "DataFrame":
        """Struct columns ``names`` replaced by their fields, in place. A
        statistics column gives its scalar fields as device columns and
        ``feature_names`` and its list fields as host object columns (the
        one place they leave the device); an object column of dicts gives
        one column a key."""
        missing = [n for n in names if n not in self._columns]
        if missing:
            raise KeyError(f"columns {missing} not found; available: {self.columns}")
        out: List[AnySeries] = []
        for name, c in self._columns.items():
            if name not in names:
                out.append(c)
            elif isinstance(c, StatisticsSeries):
                arrays = c.arrays
                out.extend(Series(f, arrays[f]) for f in c.SCALAR_FIELDS)
                out.append(ObjectSeries("feature_names", [list(c.feature_names)] * len(c)))
                host = torch.cat([arrays[f] for f in c.LIST_FIELDS], dim=1).cpu().numpy()
                k = len(c.feature_names)
                for j, f in enumerate(c.LIST_FIELDS):
                    out.append(ObjectSeries(f, host[:, j * k : (j + 1) * k].tolist()))
            elif isinstance(c, StructSeries):
                out.extend(c.fields())
            elif isinstance(c, ObjectSeries) and c.values and isinstance(c.values[0], dict):
                for f in c.values[0]:
                    vals = [row[f] for row in c.values]
                    if isinstance(vals[0], (list, np.ndarray, str)):
                        out.append(ObjectSeries(f, vals))
                    else:
                        out.append(Series(f, np.asarray(vals, dtype=np.float64)))
            else:
                raise TypeError(f"column {name!r} is not a struct")
        return DataFrame._from_columns(out)

    def explode(self, names: List[str]) -> "DataFrame":
        """One row per element of the list columns ``names`` (of equal
        lengths a row); the other columns repeat their row."""
        names = list(names)
        first = self.get_column(names[0])
        if not isinstance(first, ObjectSeries):
            raise TypeError("explode expects list-valued object columns")
        lengths = [len(v) for v in first.values]
        out: List[AnySeries] = []
        rows = _Rows(np.repeat(np.arange(self.height), lengths))
        for name, c in self._columns.items():
            if name in names:
                flat = [x for v in c.values for x in v]
                if flat and isinstance(flat[0], str):
                    out.append(ObjectSeries(name, flat))
                else:
                    out.append(Series(name, np.asarray(flat, dtype=np.float64)))
            else:
                out.append(rows.take(c))
        return DataFrame._from_columns(out)

    def head(self, n: int = 5) -> "DataFrame":
        return self._take_rows(np.arange(min(max(n, 0), self.height)))

    def tail(self, n: int = 5) -> "DataFrame":
        h = self.height
        return self._take_rows(np.arange(max(h - max(n, 0), 0), h))

    def slice(self, offset: int, length: Optional[int] = None) -> "DataFrame":
        h = self.height
        start = offset if offset >= 0 else max(h + offset, 0)
        stop = h if length is None else min(start + length, h)
        return self._take_rows(np.arange(min(start, h), stop))

    # ------------------------------------------------------------------ #
    def _key_array(self, keys: List[str]) -> np.ndarray:
        cols = [self.get_column(k).to_numpy() for k in keys]
        return cols[0] if len(cols) == 1 else np.rec.fromarrays(cols)

    def group_by(self, *keys) -> "GroupBy":
        return GroupBy(self, [k if isinstance(k, str) else k.meta.output_name for k in keys])

    def partition_by(self, *keys: str) -> List["DataFrame"]:
        """One frame a distinct key, in the keys' sorted order; each keeps
        its rows' order."""
        from .engine.groups import layout_for_columns

        layout = layout_for_columns([self.get_column(k) for k in keys])
        return [self._take_rows(part) for part in np.split(layout.order, np.cumsum(layout.counts)[:-1])]

    def _unique_keys(self) -> List[np.ndarray]:
        """Host key arrays of every column: values (and validity where a
        column has a null: an all-valid mask keys nothing), struct fields, a
        statistics column's row index into its groups (or its fields), the
        reprs of objects."""
        keys: List[np.ndarray] = []
        for c in self._columns.values():
            if isinstance(c, Series):
                keys.append(c.to_numpy())
                if c.validity is not None and not bool(c.validity.all()):
                    keys.append(c.validity.cpu().numpy().astype(np.int8))
            elif isinstance(c, StructSeries):
                m = c.values.cpu().numpy()
                keys.extend(m[:, j] for j in range(m.shape[1]))
                if c.validity is not None and not bool(c.validity.all()):
                    v = c.validity.cpu().numpy().astype(np.int8)
                    keys.extend(v[:, j] for j in range(v.shape[1]))
            elif isinstance(c, StatisticsSeries):
                if c._row_index is not None:
                    keys.append(c.composed_index())
                else:
                    # rows can tie on the scalar metrics (two exact fits at
                    # r2 = 1) and differ in coefficients: every field
                    for f in c.SCALAR_FIELDS:
                        keys.append(c.arrays[f].cpu().numpy())
                    for f in c.LIST_FIELDS:
                        m = c.arrays[f].cpu().numpy()
                        keys.extend(m[:, j] for j in range(m.shape[1]))
            else:
                keys.append(np.asarray([repr(v) for v in c.values]))
        return keys

    def unique(self) -> "DataFrame":
        """The first row of each distinct row, in the frame's order. Rows are
        keyed by the native factorizer; where a float key holds NaN beside
        other keys, by numpy's unique of the records, whose NaN fields never
        compare equal (the JAX package's rule)."""
        from .engine.groups import build_layout, factorize_arrays

        keys = self._unique_keys()
        nan_rows = len(keys) > 1 and any(
            np.issubdtype(k.dtype, np.floating) and np.isnan(k).any() for k in keys
        )
        if nan_rows:
            _, first = np.unique(np.rec.fromarrays(keys), return_index=True)
            return self._take_rows(np.sort(first))
        if self.height == 0:
            return self
        gids = factorize_arrays(keys)
        layout = build_layout(gids, len(gids))  # a counting sort: rows grouped, in order
        starts = np.zeros(layout.num_groups, dtype=np.int64)
        np.cumsum(layout.counts[:-1], out=starts[1:])
        return self._take_rows(np.sort(layout.order[starts]))

    def sort(self, by: Union[str, List[str]], descending: Union[bool, List[bool]] = False) -> "DataFrame":
        """Stable multi-key sort; ``descending`` is a bool or one a key
        (polars' signature). NaN keys sort last in either direction, as in
        the reference (numpy's argsort of the negated key)."""
        by = [by] if isinstance(by, str) else list(by)
        desc = [descending] * len(by) if isinstance(descending, bool) else list(descending)
        if len(desc) != len(by):
            raise AssertionError("descending must match the number of sort keys")
        keys = []
        for k, d in zip(by, desc):
            v = np.asarray(self.get_column(k).to_numpy())
            if v.dtype == object or v.dtype.kind in "US":
                _, v = np.unique(v, return_inverse=True)  # dense rank codes
            if d:
                if v.dtype.kind == "b":
                    v = ~v
                elif v.dtype.kind == "u":
                    v = -v.astype(np.int64)
                else:
                    v = -v
            keys.append(v)
        return self._take_rows(np.lexsort(keys[::-1]))  # lexsort's primary key is the last

    def _join_codes(self, other: "DataFrame", on: List[str]):
        """Shared dense key codes of both frames' rows, from the native
        hash factorizer (no sort of the combined keys); None where a key
        column needs the generic sort path (object keys, NaN keys)."""
        from .engine.groups import _factorize_numeric

        arrays = []
        for k in on:
            lv = np.asarray(self.get_column(k).to_numpy())
            rv = np.asarray(other.get_column(k).to_numpy())
            if lv.dtype == object or rv.dtype == object:
                return None
            v = np.concatenate([lv, rv])
            if np.issubdtype(v.dtype, np.floating) and np.isnan(v).any():
                return None
            arrays.append(_factorize_numeric(v).astype(np.int64))
        combined = arrays[0]
        for a in arrays[1:]:
            radix = int(a.max(initial=0)) + 1
            if int(combined.max(initial=0)) > (2**62) // radix:
                # numpy wraps int64 silently: compact the running code first
                combined = _factorize_numeric(combined).astype(np.int64)
                if int(combined.max(initial=0)) > (2**62) // radix:
                    return None
            combined = combined * radix + a
        if len(arrays) > 1:
            combined = _factorize_numeric(combined)
        return combined[: self.height], combined[self.height :]

    def join(self, other: "DataFrame", on: Union[str, List[str], None] = None, how: str = "inner") -> "DataFrame":
        """Hash join: the native factorizer's codes and counting-sort
        positions on the host (generic keys, object or NaN, through a
        sort-merge), then one gather a column on the device. ``how``:
        inner, left, full (alias outer; key columns coalesced), semi,
        anti, cross. Rows come in left-row-major order."""
        if how not in ("inner", "left", "full", "outer", "semi", "anti", "cross"):
            raise AssertionError(how)
        if how == "cross":
            if on is not None:
                raise AssertionError("cross join takes no key columns")
            n, m = self.height, len(other)
            li, ri = _Rows(np.repeat(np.arange(n), m)), _Rows(np.tile(np.arange(m), n))
            cols = [li.take(c) for c in self._columns.values()]
            for k, c in other._columns.items():
                cols.append(ri.take(c).alias(k + "_right" if k in self._columns else k))
            return DataFrame._from_columns(cols)
        on = [on] if isinstance(on, str) else list(on)
        fast = self._join_codes(other, on) if self.height and len(other) else None
        if fast is not None:
            lcode, rcode = fast
            ncodes = int(max(lcode.max(initial=-1), rcode.max(initial=-1))) + 1
            cnt = np.bincount(rcode, minlength=ncodes)
            code_starts = np.zeros(ncodes, dtype=np.int64)
            np.cumsum(cnt[:-1], out=code_starts[1:])
            r_order = np.argsort(rcode, kind="stable")
            starts, counts = code_starts[lcode], cnt[lcode]
        else:
            lk, rk = self._key_array(on), other._key_array(on)
            _, inv = np.unique(np.concatenate([lk, rk]), return_inverse=True)
            lcode, rcode = inv[: len(lk)], inv[len(lk) :]
            r_order = np.argsort(rcode, kind="stable")
            r_sorted = rcode[r_order]
            starts = np.searchsorted(r_sorted, lcode, "left")
            counts = np.searchsorted(r_sorted, lcode, "right") - starts
        if how == "semi":
            return self._take_rows(np.flatnonzero(counts > 0))
        if how == "anti":
            return self._take_rows(np.flatnonzero(counts == 0))
        if how in ("full", "outer"):
            out = self._join_with_positions(other, on, "left", counts, starts, r_order)
            # right rows whose key is not on the left, appended with nulls in
            # the left-only columns and their own key values
            if len(rcode):
                l_present = np.isin(rcode, lcode) if fast is None else (
                    np.bincount(lcode, minlength=int(rcode.max(initial=-1)) + 1)[rcode] > 0
                )
            else:
                l_present = np.zeros(0, dtype=bool)
            extra = _Rows(np.flatnonzero(~l_present))
            if len(extra) == 0:
                return out
            cols: List[AnySeries] = []
            for k, c in self._columns.items():
                if k in on:
                    cols.append(extra.take(other.get_column(k)).alias(k))
                else:
                    cols.append(_null_column(c, len(extra)))
            for k, c in other._columns.items():
                if k not in on:
                    cols.append(extra.take(c).alias(k + "_right" if k in self._columns else k))
            return concat([out, DataFrame._from_columns(cols)])
        return self._join_with_positions(other, on, how, counts, starts, r_order)

    def _join_with_positions(self, other, on, how, counts, starts, r_order) -> "DataFrame":
        if how == "left":
            matched = counts > 0
            counts = np.maximum(counts, 1)  # an unmatched row keeps one null row
        total = int(counts.sum())
        li = np.repeat(np.arange(self.height), counts)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        within = np.arange(total) - np.repeat(offsets, counts)
        ri_pos = np.repeat(starts, counts) + within
        keep = None
        if how == "left":
            valid_r = np.repeat(matched, counts)
            if len(r_order) == 0:
                ri = np.zeros(total, dtype=np.int64)
            else:
                ri = r_order[np.where(valid_r, np.minimum(ri_pos, len(r_order) - 1), 0)]
            if not valid_r.all():
                keep = valid_r
        else:
            ri = r_order[ri_pos]
        lrows, rrows = _Rows(li), _Rows(ri)
        cols = [lrows.take(c) for c in self._columns.values()]
        for k, c in other._columns.items():
            if k in self._columns:
                if k in on:
                    continue
                c = c.alias(k + "_right")
            if how == "left" and len(other) == 0:
                cols.append(_null_column(c, total))
                continue
            rcol = rrows.take(c)
            cols.append(rcol if keep is None else _mask_rows(rcol, keep))
        return DataFrame._from_columns(cols)

    # ------------------------------------------------------------------ #
    def to_numpy(self) -> np.ndarray:
        arrs = []
        for c in self._columns.values():
            a = c.to_numpy()
            arrs.append(a[:, None] if a.ndim == 1 else a)
        dtype = object if any(a.dtype == object for a in arrs) else np.float64
        return np.concatenate([a.astype(dtype) for a in arrs], axis=1)

    def to_dict(self, as_series: bool = True):
        if as_series:
            return dict(self._columns)
        return {k: c.to_numpy() for k, c in self._columns.items()}

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({k: list(c.to_numpy()) for k, c in self._columns.items()})

    def lazy(self) -> "LazyFrame":
        return LazyFrame(self)

    def rechunk(self) -> "DataFrame":
        return self

    def item(self):
        if self.shape != (1, 1):
            raise AssertionError(f"item() needs a frame of one row and one column, this one is {self.shape}")
        return next(iter(self._columns.values())).item()

    def count(self) -> "DataFrame":
        return DataFrame({
            k: np.asarray([float(c.count() if isinstance(c, Series) else len(c))])
            for k, c in self._columns.items()
        })

    def max_horizontal(self) -> Series:
        return Series("max", self.to_numpy().astype(np.float64).max(axis=1))

    def __repr__(self) -> str:  # pragma: no cover
        return f"DataFrame(shape={self.shape}, columns={self.columns})"


def _mask_rows(c: AnySeries, keep: np.ndarray) -> AnySeries:
    """``c`` null where ``keep`` is False (a left join's unmatched rows):
    Series and structs through their validity, statistics columns as NaN
    metrics, object columns as None."""
    if isinstance(c, ObjectSeries):
        return ObjectSeries(c.name, [v if ok else None for v, ok in zip(c.values, keep)])
    kd = torch.as_tensor(keep, device=device())
    if isinstance(c, Series):
        return Series(c.name, c._values, c.valid_mask() & kd)
    if isinstance(c, StructSeries):
        valid = c.validity if c.validity is not None else torch.ones_like(c.values, dtype=torch.bool)
        return StructSeries(c.name, c.field_names, c.values, valid & kd[:, None])
    arrays = {k: torch.where(kd if v.dim() == 1 else kd[:, None], v, torch.nan) for k, v in c.arrays.items()}
    return StatisticsSeries(c.name, c.feature_names, arrays)


def _null_column(c: AnySeries, n: int) -> AnySeries:
    """An all-null column of ``n`` rows of ``c``'s type."""
    dev = device()
    if isinstance(c, StructSeries):
        k = len(c.field_names)
        return StructSeries(c.name, c.field_names, torch.zeros((n, k), dtype=F64, device=dev),
                            torch.zeros((n, k), dtype=torch.bool, device=dev))
    if isinstance(c, StatisticsSeries):
        arrays = {k: torch.full((n,) + tuple(v.shape[1:]), torch.nan, dtype=F64, device=dev)
                  for k, v in c.arrays.items()}
        return StatisticsSeries(c.name, c.feature_names, arrays)
    if isinstance(c, ObjectSeries):
        return ObjectSeries(c.name, [None] * n)
    return Series(c.name, torch.zeros(n, dtype=F64, device=dev), torch.zeros(n, dtype=torch.bool, device=dev))


def _broadcast(c, n: int):
    """A column of ``n`` rows: ``c`` itself, or its one row repeated."""
    if len(c) == n:
        return c
    if len(c) != 1:
        raise ValueError(f"a column of {len(c)} rows does not fit a frame of {n}")
    if isinstance(c, StatisticsSeries):  # the row index made on the card: an upload would synchronise
        return c.gather(torch.zeros(n, dtype=torch.int64, device=device()))
    if isinstance(c, ObjectSeries) or (isinstance(c, Series) and _on_host(c)):
        return c.gather(np.zeros(n, dtype=np.int64))
    if isinstance(c, StructSeries):
        validity = None if c.validity is None else c.validity.expand(n, -1)
        return StructSeries(c.name, c.field_names, c.values.expand(n, -1), validity)
    validity = None if c.validity is None else c.validity.expand(n)
    return Series(c.name, c.values.expand(n), validity)


class GroupBy:
    def __init__(self, df: DataFrame, keys: List[str]):
        self._df = df
        self._keys = keys

    def _boundaries(self):
        """(layout, first row, last row of each group), the rows from the
        key columns' cached layout (groups in sorted key order)."""
        from .engine.groups import layout_for_columns

        layout = layout_for_columns([self._df.get_column(k) for k in self._keys])
        starts = np.zeros(layout.num_groups, dtype=np.int64)
        np.cumsum(layout.counts[:-1], out=starts[1:])
        return layout, layout.order[starts], layout.order[starts + layout.counts - 1]

    def first(self) -> DataFrame:
        return self._df._take_rows(self._boundaries()[1])

    def last(self) -> DataFrame:
        return self._df._take_rows(self._boundaries()[2])

    def agg(self, *exprs, **named) -> DataFrame:
        """One row per group: the keys, then each expression's result.
        Reductions reduce by segments on the device; other expressions
        (least-squares coefficients or statistics, constant in a group)
        are evaluated in the ``.over()`` context and keep each group's
        first row."""
        layout, first_idx, _ = self._boundaries()
        rows = _Rows(first_idx)
        out: List[AnySeries] = [rows.take(self._df.get_column(k)) for k in self._keys]
        all_exprs: List[Expr] = []
        for e in exprs:
            all_exprs.extend(parse_into_expr(e).expand(self._df))
        for name, e in named.items():
            all_exprs.append(parse_into_expr(e).alias(name))
        for e in all_exprs:
            out.append(e.evaluate_grouped(self._df, layout, rows.dev()))
        return DataFrame._from_columns(out)


class LazyFrame:
    """A deferred query plan over a DataFrame.

    Frame-to-frame operations record (method, args) plan nodes and run
    nothing, on the host or the device, until ``collect()`` replays the
    plan (the polars lazy planner's role for the reference, SURVEY layer
    L3). Anything else (``to_numpy``, ``item``, metadata) collects first.
    """

    _DEFERRABLE = frozenset({
        "select", "with_columns", "with_row_index", "filter", "fill_null", "fill_nan",
        "drop_nulls", "drop", "rename", "unnest", "explode", "sort", "join", "unique",
        "head", "tail", "slice",
    })

    def __init__(self, df: DataFrame, plan: Optional[List] = None):
        self._df = df
        self._plan = plan or []
        self._collected: Optional[DataFrame] = None

    def collect(self) -> DataFrame:
        # a plan never changes (deferring builds a new LazyFrame), so the
        # collected frame is kept
        if self._collected is None:
            out = self._df
            for name, args, kwargs in self._plan:
                out = getattr(out, name)(*args, **kwargs)
            self._collected = out
        return self._collected

    def explain(self) -> str:
        """The deferred plan, first step on top."""
        lines = [f"DF [{', '.join(self._df.columns)}]"]
        lines += [f"  .{name}(...)" for name, _, _ in self._plan]
        return "\n".join(lines)

    def __getattr__(self, name):
        if name in LazyFrame._DEFERRABLE:
            def defer(*args, **kwargs):
                return LazyFrame(self._df, self._plan + [(name, args, kwargs)])

            return defer
        return getattr(self.collect(), name)


def concat(frames: List[DataFrame], how: str = "vertical", rechunk: bool = True) -> DataFrame:
    """Frames stacked row-wise (``vertical``: the first frame's columns,
    each concatenated on its device with its validity; NaN stays a valid
    value) or side by side (``horizontal``: equal heights, distinct
    names)."""
    if how not in ("vertical", "horizontal"):
        raise AssertionError(how)
    if how == "horizontal":
        heights = {f.height for f in frames}
        if len(heights) != 1:
            raise AssertionError(f"horizontal concat requires equal heights, got {heights}")
        cols: List[AnySeries] = []
        seen: set = set()
        for f in frames:
            for name, c in f._columns.items():
                if name in seen:
                    raise AssertionError(f"duplicate column {name!r} in horizontal concat")
                seen.add(name)
                cols.append(c)
        return DataFrame._from_columns(cols)
    cols = []
    for name in frames[0].columns:
        parts = [f.get_column(name) for f in frames]
        first = parts[0]
        if isinstance(first, Series):
            validity = None
            if any(p.validity is not None for p in parts):
                validity = torch.cat([p.valid_mask() for p in parts])
            if all(_on_host(p) for p in parts):
                vals = np.concatenate([np.asarray(p._values) for p in parts])
            else:
                vals = torch.cat([p.f64() for p in parts])
            cols.append(Series(name, vals, validity))
        elif isinstance(first, StructSeries):
            vals = torch.cat([p.values for p in parts])
            valid = torch.cat([
                p.validity if p.validity is not None else torch.ones_like(p.values, dtype=torch.bool)
                for p in parts
            ])
            cols.append(StructSeries(name, first.field_names, vals, valid))
        elif isinstance(first, StatisticsSeries):
            if not all(isinstance(p, StatisticsSeries) and p.feature_names == first.feature_names for p in parts):
                raise AssertionError("statistics columns with differing features cannot be concatenated")
            arrays = {k: torch.cat([p.arrays[k] for p in parts]) for k in first.SCALAR_FIELDS + first.LIST_FIELDS}
            cols.append(StatisticsSeries(name, first.feature_names, arrays))
        else:
            cols.append(ObjectSeries(name, [v for p in parts for v in p.values]))
    return DataFrame._from_columns(cols)
