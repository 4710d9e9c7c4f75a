"""Columnar series backed by torch tensors.

Float columns are f64 tensors on ``CONFIG.device``; integer and string
columns (typically group keys) stay host-side numpy arrays, since group
factorization runs on the host. ``validity`` is an optional bool mask: a
null is distinct from a NaN value, which stays valid. ``None`` entries of
a Python list are nulls. ``ObjectSeries`` holds arbitrary Python objects
(strings, the list fields of an unnested statistics column) on the host.

Rows are selected by ``gather``: a device column takes the positions as a
device int64 tensor (``index_select``), a host column as numpy; either form
is accepted and converted where the column needs the other.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import F64, device


class BlockPermuted:
    """Deferred row-order view of block-laid-out values.

    The grouped engine computes per-row results in its split-padded block
    layout; restoring row order is an [N]-element gather that consumers
    which never need the full column in row order (reductions, slices) can
    skip. The permutation is carried as an index map and materialised on
    first full-column access.
    """

    __slots__ = ("flat", "idx")

    def __init__(self, flat: torch.Tensor, idx: torch.Tensor) -> None:
        self.flat = flat  # [S*R] block-ordered values
        self.idx = idx  # [N] int64 row-order gather map into flat

    def __len__(self) -> int:
        return int(self.idx.shape[0])

    def materialize(self) -> torch.Tensor:
        return self.flat.index_select(0, self.idx)

    def take(self, indices: torch.Tensor) -> torch.Tensor:
        """Rows ``indices`` in row order through the index map: two small
        gathers, the other rows untouched."""
        return self.flat.index_select(0, self.idx.index_select(0, indices))


def device_index(indices, dev: torch.device) -> torch.Tensor:
    """Row positions as an int64 tensor on ``dev``."""
    if isinstance(indices, torch.Tensor):
        return indices.to(device=dev, dtype=torch.int64)
    return torch.as_tensor(np.asarray(indices, dtype=np.int64), device=dev)


def host_index(indices) -> np.ndarray:
    """Row positions as a host int64 array."""
    if isinstance(indices, torch.Tensor):
        return indices.cpu().numpy()
    return np.asarray(indices, dtype=np.int64)


def _mask_positions(mask) -> Union[torch.Tensor, np.ndarray]:
    """The positions of the True rows of a bool mask, in the mask's place:
    a device mask stays on the device (``torch.nonzero``)."""
    if isinstance(mask, torch.Tensor):
        return torch.nonzero(mask.to(torch.bool)).flatten()
    return np.flatnonzero(np.asarray(mask, dtype=bool))


def _from_list(values, validity):
    """(array, validity) of a Python sequence: ``None`` entries are nulls
    (filled with 0.0 in a float column); a NaN entry stays a valid NaN."""
    nulls = np.array([v is None for v in values], dtype=bool)
    if not nulls.any():
        return np.asarray(values), validity
    try:
        arr = np.asarray([0.0 if v is None else v for v in values], dtype=np.float64)
    except (TypeError, ValueError):  # non-numeric keys with nulls
        arr = np.asarray(values, dtype=object)
    return arr, (~nulls if validity is None else validity)


def _as_column(values):
    if isinstance(values, np.ndarray) and np.issubdtype(values.dtype, np.floating):
        return torch.as_tensor(values, dtype=F64, device=device())
    if isinstance(values, torch.Tensor) and values.is_floating_point():
        return values.to(device=device(), dtype=F64)
    return values


class Series:
    """A named 1-D column with an optional validity mask."""

    __slots__ = ("name", "_values", "validity", "_layout_cache", "__weakref__")

    def __init__(self, name: str, values, validity=None) -> None:
        self.name = name
        if isinstance(values, Series):
            validity = values.validity if validity is None else validity
            values = values._values
        if isinstance(values, (list, tuple)):
            values, validity = _from_list(values, validity)
        self._values = values if isinstance(values, BlockPermuted) else _as_column(values)
        if validity is not None:
            if not isinstance(validity, torch.Tensor):
                validity = np.asarray(validity)
            validity = torch.as_tensor(validity, dtype=torch.bool, device=device())
        self.validity = validity
        self._layout_cache = None

    @property
    def values(self):
        """Column values; a deferred block permutation materialises (and is
        cached) on first full-column access."""
        v = self._values
        if isinstance(v, BlockPermuted):
            v = v.materialize()
            self._values = v
        return v

    @property
    def is_lazy(self) -> bool:
        return isinstance(self._values, BlockPermuted)

    @property
    def is_float(self) -> bool:
        v = self._values
        return isinstance(v, BlockPermuted) or (isinstance(v, torch.Tensor) and v.is_floating_point())

    def __len__(self) -> int:
        return len(self._values)

    @property
    def height(self) -> int:
        return len(self)

    def alias(self, name: str) -> "Series":
        return Series(name, self._values, self.validity)

    def valid_mask(self) -> torch.Tensor:
        """Validity as a device bool tensor (all True without a mask)."""
        if self.validity is None:
            return torch.ones(len(self), dtype=torch.bool, device=device())
        return self.validity

    def f64(self) -> torch.Tensor:
        """The values as an f64 tensor on the device (a host key column is
        uploaded; a bool column gives 0 / 1)."""
        v = self.values
        if isinstance(v, torch.Tensor):
            return v.to(device=device(), dtype=F64)
        return torch.as_tensor(np.asarray(v, dtype=np.float64), device=device())

    def null_count(self) -> int:
        return 0 if self.validity is None else int((~self.validity).sum())

    def is_null(self) -> "Series":
        return Series(self.name, ~self.valid_mask())

    def is_not_null(self) -> "Series":
        return Series(self.name, self.valid_mask())

    def fill_null(self, value: float) -> "Series":
        if self.validity is None:
            return self
        return Series(self.name, torch.where(self.validity, self.f64(), float(value)))

    def forward_fill(self) -> "Series":
        """Each null or NaN slot takes the last valid non-NaN value before
        it; slots with none before them stay null."""
        vals = self.f64()
        if self.validity is not None:
            vals = torch.where(self.validity, vals, torch.nan)
        pos = torch.arange(len(vals), device=vals.device)
        last = torch.cummax(torch.where(torch.isnan(vals), -1, pos), dim=0).values
        out = vals.index_select(0, last.clamp(min=0))
        valid = (last >= 0) & ~torch.isnan(out)
        return Series(self.name, torch.where(valid, out, 0.0), valid)

    def to_numpy(self) -> np.ndarray:
        """Host copy, with null slots as NaN (None in a non-float column)."""
        vals = self.values
        if isinstance(vals, torch.Tensor):
            vals = vals.cpu().numpy()
        if self.validity is not None:
            mask = self.validity.cpu().numpy()
            if np.issubdtype(vals.dtype, np.floating):
                vals = np.where(mask, vals, np.nan)
            else:
                vals = np.asarray([v if ok else None for v, ok in zip(vals.tolist(), mask)], dtype=object)
        return vals

    def to_list(self) -> list:
        return [None if isinstance(v, float) and np.isnan(v) else v for v in self.to_numpy().tolist()]

    def gather(self, indices) -> "Series":
        """Rows ``indices`` (host ints or a device tensor); a deferred
        permutation stays deferred."""
        v = self._values
        if isinstance(v, BlockPermuted):
            vals = v.take(device_index(indices, v.idx.device))
        elif isinstance(v, torch.Tensor):
            vals = v.index_select(0, device_index(indices, v.device))
        else:
            vals = v[host_index(indices)]
        validity = None
        if self.validity is not None:
            validity = self.validity.index_select(0, device_index(indices, self.validity.device))
        return Series(self.name, vals, validity)

    def head(self, n: int = 5) -> "Series":
        return self.gather(np.arange(min(max(n, 0), len(self))))

    def tail(self, n: int = 5) -> "Series":
        m = len(self)
        return self.gather(np.arange(max(0, m - max(n, 0)), m))

    def filter(self, mask) -> "Series":
        return self.gather(_mask_positions(mask))

    def slice(self, offset: int, length: Optional[int] = None) -> "Series":
        stop = len(self) if length is None else offset + length
        return self.gather(np.arange(offset, min(stop, len(self))))

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self.gather(np.arange(len(self))[i])
        return self.gather(np.asarray([i if i >= 0 else len(self) + i])).to_numpy()[0]

    def item(self):
        if len(self) != 1:
            raise ValueError(f"item() needs a series of one row, {self.name!r} has {len(self)}")
        return self[0]

    # null-aware scalar reductions (the polars Series surface), on the device
    def _valid_values(self) -> torch.Tensor:
        vals = self.f64()
        return vals if self.validity is None else vals[self.validity]

    def sum(self) -> float:
        return float(self._valid_values().sum())

    def mean(self) -> Optional[float]:
        v = self._valid_values()
        return float(v.mean()) if len(v) else None

    def min(self) -> Optional[float]:
        v = self._valid_values()
        return float(v.min()) if len(v) else None

    def max(self) -> Optional[float]:
        v = self._valid_values()
        return float(v.max()) if len(v) else None

    def std(self, ddof: int = 1) -> Optional[float]:
        v = self._valid_values()
        return float(v.std(correction=ddof)) if len(v) > ddof else None

    def var(self, ddof: int = 1) -> Optional[float]:
        v = self._valid_values()
        return float(v.var(correction=ddof)) if len(v) > ddof else None

    def median(self) -> Optional[float]:
        # numpy's median (the mean of the middle two of an even count);
        # torch.median gives the lower one
        v = self._valid_values().cpu().numpy()
        return float(np.median(v)) if len(v) else None

    def count(self) -> int:
        return len(self) - self.null_count()

    def __repr__(self) -> str:  # pragma: no cover
        return f"Series(name={self.name!r}, len={len(self)})"


class StructSeries:
    """A struct column: named fields over a shared [N, K] f64 matrix with
    per-field validity [N, K] or None (NaN coefficients become nulls, like
    the reference's coefficient structs, src/expressions.rs:114-143; a
    multi-target fit's targets and predictions are structs too).

    ``sources`` holds the field Series a ``struct(...)`` expression stacked
    (None otherwise): a query rebuilds its struct, so the engine keys its
    caches on these Series, which stay the same from query to query.
    """

    __slots__ = ("name", "field_names", "values", "validity", "sources")

    def __init__(
        self,
        name: str,
        field_names: Sequence[str],
        values: torch.Tensor,
        validity: Optional[torch.Tensor] = None,
        sources: Optional[Tuple["Series", ...]] = None,
    ) -> None:
        self.name = name
        self.field_names: List[str] = list(field_names)
        if not isinstance(values, torch.Tensor):
            values = torch.as_tensor(np.asarray(values, dtype=np.float64), device=device())
        if values.dtype != F64 or values.dim() != 2 or values.shape[1] != len(self.field_names):
            raise AssertionError(
                f"struct values must be [N, {len(self.field_names)}] float64, "
                f"got {values.dtype} {tuple(values.shape)}"
            )
        if validity is not None:
            if not isinstance(validity, torch.Tensor):
                validity = torch.as_tensor(np.asarray(validity, dtype=bool), device=values.device)
            if validity.dim() == 1 and validity.shape[0] == values.shape[0]:
                # a row validity: every field of a null row is null
                validity = validity[:, None].expand(values.shape).contiguous()
            if tuple(validity.shape) != tuple(values.shape):
                raise AssertionError(
                    f"struct validity must be {tuple(values.shape)} or [N], got {tuple(validity.shape)}"
                )
        self.values = values
        self.validity = validity
        self.sources = sources

    def __len__(self) -> int:
        return int(self.values.shape[0])

    @property
    def height(self) -> int:
        return len(self)

    def alias(self, name: str) -> "StructSeries":
        return StructSeries(name, self.field_names, self.values, self.validity, self.sources)

    def gather(self, indices) -> "StructSeries":
        idx = device_index(indices, self.values.device)
        validity = None if self.validity is None else self.validity.index_select(0, idx)
        return StructSeries(self.name, self.field_names, self.values.index_select(0, idx), validity)

    def filter(self, mask) -> "StructSeries":
        return self.gather(_mask_positions(mask))

    def valid_mask(self) -> torch.Tensor:
        """Row validity [N]: a row is valid when every field is."""
        if self.validity is None:
            return torch.ones(len(self), dtype=torch.bool, device=self.values.device)
        return self.validity.all(dim=1)

    def field(self, name: str) -> Series:
        """The field ``name`` as a Series."""
        j = self.field_names.index(name)
        return Series(name, self.values[:, j], None if self.validity is None else self.validity[:, j])

    def fields(self) -> List[Series]:
        return [self.field(n) for n in self.field_names]

    def to_numpy(self) -> np.ndarray:
        vals = self.values.cpu().numpy()
        if self.validity is not None:
            vals = np.where(self.validity.cpu().numpy(), vals, np.nan)
        return vals

    def __repr__(self) -> str:  # pragma: no cover
        return f"StructSeries(name={self.name!r}, fields={self.field_names}, len={len(self)})"


class StatisticsSeries:
    """The statistics struct column (reference src/expressions.rs:448-509):
    scalar fields r2 / mae / mse and list fields coefficients /
    standard_errors / t_values / p_values, beside the feature names.

    The fields stay device tensors, [G] scalars and [G, K] lists, one row
    per group. A row broadcast (``.over()``) or any other gather is
    deferred: the series records a chain of index maps into the base and
    composes it only when ``arrays`` is read, with one gather of all fields
    packed together. ``values`` builds the row dicts from one host fetch.
    """

    __slots__ = ("name", "feature_names", "_base", "_row_index", "_mat", "_rows")

    SCALAR_FIELDS = ("r2", "mae", "mse")
    LIST_FIELDS = ("coefficients", "standard_errors", "t_values", "p_values")

    def __init__(
        self,
        name: str,
        feature_names: Sequence[str],
        arrays: dict,
        row_index: Optional[Tuple[torch.Tensor, ...]] = None,
    ) -> None:
        self.name = name
        self.feature_names: List[str] = list(feature_names)
        self._base = arrays  # field -> device tensor, [G] or [G, K]
        # index maps into the base, applied outermost-first, or None
        self._row_index = row_index
        self._mat = None
        self._rows = None

    def __len__(self) -> int:
        if self._row_index is not None:
            return int(self._row_index[-1].shape[0])
        return int(self._base["r2"].shape[0])

    @property
    def height(self) -> int:
        return len(self)

    def _index(self) -> torch.Tensor:
        idx = self._row_index[-1]
        for link in self._row_index[-2::-1]:
            idx = link.index_select(0, idx)
        return idx

    @property
    def arrays(self) -> dict:
        """Row-level field tensors (composes a deferred gather, once)."""
        if self._row_index is None:
            return self._base
        if self._mat is None:
            keys = list(self._base)
            cols = [self._base[k] for k in keys]
            packed = torch.cat([c[:, None] if c.dim() == 1 else c for c in cols], dim=1)
            out = packed.index_select(0, self._index())
            self._mat, at = {}, 0
            for key, c in zip(keys, cols):
                width = 1 if c.dim() == 1 else c.shape[1]
                part = out[:, at : at + width]
                self._mat[key] = part[:, 0] if c.dim() == 1 else part
                at += width
        return self._mat

    def composed_index(self) -> Optional[np.ndarray]:
        """The final per-row index into the base (host numpy), or None when
        the series is base-level."""
        return None if self._row_index is None else self._index().cpu().numpy()

    def gather(self, indices) -> "StatisticsSeries":
        """Rows ``indices`` (a device tensor, or host ints), deferred."""
        idx = device_index(indices, self._base["r2"].device)
        chain = (idx,) if self._row_index is None else self._row_index + (idx,)
        return StatisticsSeries(self.name, self.feature_names, self._base, chain)

    def head(self, n: int = 5) -> "StatisticsSeries":
        return self.gather(np.arange(min(n, len(self))))

    def tail(self, n: int = 5) -> "StatisticsSeries":
        return self.gather(np.arange(max(0, len(self) - n), len(self)))

    def filter(self, mask) -> "StatisticsSeries":
        return self.gather(_mask_positions(mask))

    def alias(self, name: str) -> "StatisticsSeries":
        return StatisticsSeries(name, self.feature_names, self._base, self._row_index)

    @property
    def values(self) -> list:
        """One dict per row: r2, mae, mse, feature_names, coefficients,
        standard_errors, t_values, p_values (one host fetch)."""
        if self._rows is None:
            arrays = self.arrays
            packed = torch.cat(
                [arrays[k][:, None] for k in self.SCALAR_FIELDS]
                + [arrays[k] for k in self.LIST_FIELDS],
                dim=1,
            ).cpu().numpy()
            k = len(self.feature_names)
            ns = len(self.SCALAR_FIELDS)
            rows = []
            for r in packed:
                row = {key: float(r[i]) for i, key in enumerate(self.SCALAR_FIELDS)}
                row["feature_names"] = list(self.feature_names)
                for j, key in enumerate(self.LIST_FIELDS):
                    row[key] = r[ns + j * k : ns + (j + 1) * k].tolist()
                rows.append(row)
            self._rows = rows
        return self._rows

    def to_list(self) -> list:
        return list(self.values)

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.values, dtype=object)

    def __getitem__(self, i):
        return self.values[i]

    def item(self) -> dict:
        if len(self) != 1:
            raise ValueError(f"item() needs a series of one row, this one has {len(self)}")
        return self.values[0]

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"StatisticsSeries(name={self.name!r}, len={len(self)}, "
            f"features={self.feature_names})"
        )


class ObjectSeries:
    """A host column of arbitrary Python objects: strings, or the list
    fields of an unnested statistics column (the reference's statistics
    struct, src/expressions.rs:448-466)."""

    __slots__ = ("name", "values", "_layout_cache", "__weakref__")

    def __init__(self, name: str, values: Iterable) -> None:
        self.name = name
        self.values = list(values)
        self._layout_cache = None

    def __len__(self) -> int:
        return len(self.values)

    @property
    def height(self) -> int:
        return len(self)

    def alias(self, name: str) -> "ObjectSeries":
        return ObjectSeries(name, self.values)

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.values, dtype=object)

    def to_list(self) -> list:
        return list(self.values)

    def gather(self, indices) -> "ObjectSeries":
        return ObjectSeries(self.name, [self.values[i] for i in host_index(indices).tolist()])

    def filter(self, mask) -> "ObjectSeries":
        return self.gather(host_index(_mask_positions(mask)))

    def __getitem__(self, i):
        return self.values[i]

    def item(self):
        if len(self.values) != 1:
            raise ValueError(f"item() needs a series of one row, {self.name!r} has {len(self)}")
        return self.values[0]

    def __repr__(self) -> str:  # pragma: no cover
        return f"ObjectSeries(name={self.name!r}, len={len(self)})"


AnySeries = Union[Series, StructSeries, StatisticsSeries, ObjectSeries]
