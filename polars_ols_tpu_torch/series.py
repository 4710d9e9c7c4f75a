"""Columnar series backed by torch tensors.

Float columns are f64 tensors on ``CONFIG.device``; integer and string
columns (typically group keys) stay host-side numpy arrays, since group
factorization runs on the host. ``validity`` is an optional bool mask: a
null is distinct from a NaN value, which stays valid. ``None`` entries of
a Python list are nulls.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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
    per-field validity (NaN coefficients become nulls, like the
    reference's coefficient structs, src/expressions.rs:114-143)."""

    __slots__ = ("name", "field_names", "values", "validity")

    def __init__(
        self,
        name: str,
        field_names: Sequence[str],
        values: torch.Tensor,
        validity: Optional[torch.Tensor] = None,
    ) -> None:
        self.name = name
        self.field_names: List[str] = list(field_names)
        if values.dtype != F64 or values.dim() != 2 or values.shape[1] != len(self.field_names):
            raise ValueError(
                f"struct values must be [N, {len(self.field_names)}] float64, "
                f"got {values.dtype} {tuple(values.shape)}"
            )
        self.values = values
        self.validity = validity

    def __len__(self) -> int:
        return int(self.values.shape[0])

    def alias(self, name: str) -> "StructSeries":
        return StructSeries(name, self.field_names, self.values, self.validity)

    def to_numpy(self) -> np.ndarray:
        vals = self.values.cpu().numpy()
        if self.validity is not None:
            vals = np.where(self.validity.cpu().numpy(), vals, np.nan)
        return vals

    def __repr__(self) -> str:  # pragma: no cover
        return f"StructSeries(name={self.name!r}, fields={self.field_names}, len={len(self)})"
