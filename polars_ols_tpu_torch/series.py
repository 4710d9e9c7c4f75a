"""Columnar series backed by torch tensors.

Float columns are f64 tensors on ``CONFIG.device``; integer and string
columns (typically group keys) stay host-side numpy arrays, since group
factorization runs on the host. ``validity`` is an optional bool mask: a
null is distinct from a NaN value, which stays valid. ``None`` entries of
a Python list are nulls.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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

    __slots__ = ("name", "_values", "validity", "_layout_cache")

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

    def __len__(self) -> int:
        return len(self._values)

    def alias(self, name: str) -> "Series":
        return Series(name, self._values, self.validity)

    def valid_mask(self) -> torch.Tensor:
        """Validity as a device bool tensor (all True without a mask)."""
        if self.validity is None:
            return torch.ones(len(self), dtype=torch.bool, device=device())
        return self.validity

    def to_numpy(self) -> np.ndarray:
        """Host copy, with null slots as NaN."""
        vals = self.values
        if isinstance(vals, torch.Tensor):
            vals = vals.cpu().numpy()
        if self.validity is not None:
            vals = np.where(self.validity.cpu().numpy(), vals, np.nan)
        return vals

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
        if values.dtype != F64 or values.dim() != 2 or values.shape[1] != len(self.field_names):
            raise ValueError(
                f"struct values must be [N, {len(self.field_names)}] float64, "
                f"got {values.dtype} {tuple(values.shape)}"
            )
        if validity is not None and tuple(validity.shape) != tuple(values.shape):
            raise ValueError(
                f"struct validity must be {tuple(values.shape)}, got {tuple(validity.shape)}"
            )
        self.values = values
        self.validity = validity
        self.sources = sources

    def __len__(self) -> int:
        return int(self.values.shape[0])

    def alias(self, name: str) -> "StructSeries":
        return StructSeries(name, self.field_names, self.values, self.validity, self.sources)

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
        device = self._base["r2"].device
        if isinstance(indices, torch.Tensor):
            idx = indices.to(device=device, dtype=torch.int64)
        else:
            idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=device)
        chain = (idx,) if self._row_index is None else self._row_index + (idx,)
        return StatisticsSeries(self.name, self.feature_names, self._base, chain)

    def head(self, n: int = 5) -> "StatisticsSeries":
        return self.gather(np.arange(min(n, len(self))))

    def tail(self, n: int = 5) -> "StatisticsSeries":
        return self.gather(np.arange(max(0, len(self) - n), len(self)))

    def filter(self, mask) -> "StatisticsSeries":
        if isinstance(mask, torch.Tensor):
            return self.gather(torch.nonzero(mask.to(torch.bool)).flatten())
        return self.gather(np.nonzero(np.asarray(mask, dtype=bool))[0])

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
