"""Group factorization and batched layouts.

Rows are factorized into integer group ids on the host, then laid out on
the device as split-padded row blocks ``[S, R_cap, ...]``: heavy groups are
split into several blocks whose partial moments are summed per group, and
the blocks of one group are contiguous (``block_group`` is
``repeat(arange(G), n_blocks)``), so the CSR offsets ``[G+1]`` into the
block axis describe the block -> group map completely.

Host arrays are numpy (the native C++ helpers build them); the memoized
device maps are torch tensors on ``CONFIG.device``. Gather maps are int64:
``torch.index_select`` wants int64 and, unlike ``jnp.take``, does not clamp
an out-of-range index.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import device

# single-group (no .over()) layouts memoized on row count: the layout's
# content depends only on n, and its device caches (the materialized
# partition) survive across queries. Small LRU: big-N host maps are large.
_SINGLE_LAYOUTS: Dict[int, "GroupLayout"] = {}
_SINGLE_LAYOUTS_LIMIT = 4

# the native unpad helper emits int32 positions
_INT32_LIMIT = 2**31

# owners of device caches (layouts, and the columns the layouts and the fit
# stacks hang off); clear_caches() walks them
_CACHE_OWNERS: "weakref.WeakSet" = weakref.WeakSet()


def register_cache_owner(obj) -> None:
    _CACHE_OWNERS.add(obj)


def clear_caches() -> None:
    """Release every device cache: the layouts' index tensors and
    partitions (``GroupLayout._dev``, on every device), the layouts cached
    on key columns and the fit stacks cached on target columns
    (engine/fit.py), and the single-group layouts. Frees device memory
    between unrelated workloads; later queries rebuild what they need."""
    for obj in list(_CACHE_OWNERS):
        if isinstance(obj, GroupLayout):
            obj._devs.clear()
        elif obj._layout_cache:
            obj._layout_cache.clear()
    _SINGLE_LAYOUTS.clear()


def single_layout(n_rows: int) -> "GroupLayout":
    layout = _SINGLE_LAYOUTS.get(n_rows)
    if layout is None:
        layout = build_layout(None, n_rows)
        register_cache_owner(layout)
        if len(_SINGLE_LAYOUTS) >= _SINGLE_LAYOUTS_LIMIT:
            _SINGLE_LAYOUTS.pop(next(iter(_SINGLE_LAYOUTS)))
        _SINGLE_LAYOUTS[n_rows] = layout
    else:
        _SINGLE_LAYOUTS[n_rows] = _SINGLE_LAYOUTS.pop(n_rows)  # LRU touch
    return layout


def factorize_columns(cols: Sequence) -> np.ndarray:
    """Factorize one or more key columns into dense group ids [N] (host)."""
    return factorize_arrays([c.to_numpy() for c in cols])


def factorize_arrays(keys: Sequence[np.ndarray]) -> np.ndarray:
    """Dense ids [N] of the distinct tuples of one or more host key arrays,
    in their sorted order."""
    arrays = []
    for vals in keys:
        if vals.dtype == object:
            _, inv = np.unique(vals.astype(str), return_inverse=True)
        else:
            inv = _factorize_numeric(np.asarray(vals))
        arrays.append(inv.astype(np.int64))
    if len(arrays) == 1:
        return arrays[0]
    combined = arrays[0]
    for a in arrays[1:]:
        radix = int(a.max(initial=0)) + 1
        if int(combined.max(initial=0)) > (2**62) // radix:
            # compact before the mixed-radix step: numpy wraps int64
            # silently, which would collide distinct key tuples
            combined = _factorize_numeric(combined)
        combined = combined * radix + a
    return _factorize_numeric(combined).astype(np.int64)


def _factorize_numeric(vals: np.ndarray) -> np.ndarray:
    from .native import native_factorize

    if np.issubdtype(vals.dtype, np.floating):
        ints = vals.astype(np.int64)
        if np.all(ints.astype(vals.dtype) == vals):
            vals = ints
        elif not np.isnan(vals).any():
            # non-integral floats: factorize the canonicalized bit pattern
            # (+0.0 == -0.0; bit equality == value equality without NaNs)
            canon = np.where(vals == 0.0, 0.0, vals.astype(np.float64))
            out = native_factorize(canon.view(np.int64), sort_keys=canon)
            if out is not None:
                return out
    if np.issubdtype(vals.dtype, np.integer):
        vals = vals.astype(np.int64)
        if len(vals):
            # dense-range fast path (group keys are usually small integers):
            # ids come out value-sorted, numpy.unique order without a remap
            lo, hi = int(vals.min()), int(vals.max())
            span = hi - lo
            if 0 <= span <= max(min(4 * len(vals), 1 << 20), 1024):
                off = vals - lo
                present = np.zeros(span + 1, dtype=bool)
                present[off] = True
                ids = np.cumsum(present, dtype=np.int64) - 1
                return ids[off]
        out = native_factorize(vals)
        if out is not None:
            return out
    _, inv = np.unique(vals, return_inverse=True)
    return inv


def _to_device(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device())


@dataclass(eq=False)  # identity eq/hash: numpy fields have no scalar ==
class GroupLayout:
    """Host-computed layout metadata for a batch of groups.

    Device index tensors derived from it are built once and memoized in
    ``_dev``, the caches of the configured device (single-group layouts are
    memoized per row count and outlive a change of ``CONFIG.device``);
    layouts are cached per group-key column (`layout_for_columns`), so
    steady-state queries never re-upload them.
    """

    gids: np.ndarray  # [N] group id per row
    num_groups: int
    counts: np.ndarray  # [G] rows per group
    order: np.ndarray  # [N] stable argsort of gids (rows grouped contiguously)
    rank_in_group: np.ndarray  # [N] 0-based position of each row inside its group
    _devs: Dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def _dev(self) -> Dict:
        """The device caches of ``CONFIG.device``."""
        return self._devs.setdefault(str(device()), {})

    def _blocks_per_group(self, r_cap: int) -> np.ndarray:
        return np.maximum(1, -(-self.counts // r_cap))

    def device_gids(self) -> torch.Tensor:
        """Per-row group ids as a device int64 tensor."""
        if "gids" not in self._dev:
            self._dev["gids"] = _to_device(self.gids, torch.int64)
        return self._dev["gids"]

    def device_counts(self) -> torch.Tensor:
        """Rows per group as a device int64 tensor [G]."""
        if "counts" not in self._dev:
            self._dev["counts"] = _to_device(self.counts, torch.int64)
        return self._dev["counts"]

    def device_padded(self):
        """(gather [G*R], pad_mask [G,R], R) device tensors, memoized."""
        if "padded" not in self._dev:
            gather, pmask, R = padded_indices(self)
            self._dev["padded"] = (
                _to_device(gather.reshape(-1), torch.int64),
                _to_device(pmask, torch.bool),
                R,
            )
        return self._dev["padded"]

    def device_split(self, r_cap: int):
        """(gather [S*R_cap], pad_mask [S,R_cap], block_group [S], S) device
        tensors for the split-padded moment layout, memoized per r_cap."""
        key = ("split", r_cap)
        if key not in self._dev:
            gather, pmask, block_group, S = split_padded_indices(self, r_cap)
            self._dev[key] = (
                _to_device(gather.reshape(-1), torch.int64),
                _to_device(pmask, torch.bool),
                _to_device(block_group, torch.int64),
                S,
            )
        return self._dev[key]

    def device_block_offsets(self, r_cap: int) -> torch.Tensor:
        """CSR offsets [G+1] into the block axis of the split-padded layout:
        group g owns blocks ``offsets[g] .. offsets[g+1]-1``. Checked once
        against the layout's block -> group map (contiguous blocks per
        group), which the moment kernel relies on."""
        key = ("block_offsets", r_cap)
        if key not in self._dev:
            n_blocks = self._blocks_per_group(r_cap)
            offsets = np.zeros(self.num_groups + 1, dtype=np.int64)
            np.cumsum(n_blocks, out=offsets[1:])
            block_group = self.device_split(r_cap)[2].cpu().numpy()
            expected = np.repeat(np.arange(self.num_groups), n_blocks)
            if not np.array_equal(block_group, expected):
                raise RuntimeError(
                    "split layout blocks are not contiguous per group; the CSR "
                    "block offsets would not describe block_group"
                )
            self._dev[key] = _to_device(offsets, torch.int64)
        return self._dev[key]

    def device_split_unpad(self, r_cap: int) -> torch.Tensor:
        """Row-order gather map [N] out of the flattened split-padded
        [S * r_cap] layout (inverse of device_split's gather)."""
        key = ("split_unpad", r_cap)
        if key not in self._dev:
            from .native import native_unpad_map

            n_blocks = self._blocks_per_group(r_cap)
            block_first = np.zeros(self.num_groups, dtype=np.int64)
            np.cumsum(n_blocks[:-1], out=block_first[1:])
            flat = None
            if int(n_blocks.sum()) * r_cap < _INT32_LIMIT:
                flat = native_unpad_map(
                    self.gids, self.rank_in_group, block_first, r_cap
                )
            if flat is None:  # numpy path (no native library, or int64 range)
                blk = block_first[self.gids] + self.rank_in_group // r_cap
                flat = blk * r_cap + self.rank_in_group % r_cap
            self._dev[key] = _to_device(flat, torch.int64)
        return self._dev[key]

    def device_unpad(self, R: int) -> torch.Tensor:
        """Row-order gather map [N] out of a padded [G, R] layout."""
        key = ("unpad", R)
        if key not in self._dev:
            self._dev[key] = _to_device(
                self.gids * R + self.rank_in_group, torch.int64
            )
        return self._dev[key]


def layout_from_arrays(
    gids, num_groups: int, counts, order, rank_in_group
) -> GroupLayout:
    """A layout from host arrays computed elsewhere, e.g. another engine's
    layout of the same rows, so that both run on the identical layout."""
    return GroupLayout(
        np.asarray(gids, dtype=np.int64).copy(),
        int(num_groups),
        np.asarray(counts, dtype=np.int64).copy(),
        np.asarray(order, dtype=np.int64).copy(),
        np.asarray(rank_in_group, dtype=np.int64).copy(),
    )


def layout_for_columns(cols: Sequence) -> GroupLayout:
    """Factorize key columns into a GroupLayout, memoized on the first key
    column (columns are immutable, so repeated `.over()` evaluations against
    the same keys reuse the layout and its device tensors)."""
    cache = getattr(cols[0], "_layout_cache", None)
    key = tuple(id(c) for c in cols)
    if cache is not None and key in cache:
        return cache[key][0]
    gids = factorize_columns(cols)
    layout = build_layout(gids, len(gids))
    register_cache_owner(layout)
    if cache is None:
        cache = {}
        cols[0]._layout_cache = cache
        register_cache_owner(cols[0])
    # hold refs to the key columns so the ids in `key` stay valid
    cache[key] = (layout, tuple(cols))
    return layout


def build_layout(gids: Optional[np.ndarray], n_rows: int, num_groups: Optional[int] = None) -> GroupLayout:
    """The layout of ``n_rows`` rows with group ids ``gids`` (one group
    where None); ``num_groups`` (default ``max(gids) + 1``) may add groups
    with no rows, as a shard's layout of all groups has
    (parallel/sharded.py)."""
    if gids is None:
        gids = np.zeros(n_rows, dtype=np.int64)
    if n_rows > 0:
        from .native import native_layout_build

        if num_groups is None:
            num_groups = int(gids.max()) + 1
        nat = native_layout_build(gids, num_groups)
        if nat is not None:
            counts, order, rank = nat
            return GroupLayout(gids, num_groups, counts, order, rank)
    counts = np.bincount(gids, minlength=num_groups or 0).astype(np.int64)
    num_groups = len(counts)
    order = np.argsort(gids, kind="stable")
    sorted_gids = gids[order]
    first = np.zeros(num_groups, dtype=np.int64)
    np.cumsum(counts[:-1], out=first[1:])
    rank_sorted = np.arange(n_rows, dtype=np.int64) - first[sorted_gids]
    rank = np.empty(n_rows, dtype=np.int64)
    rank[order] = rank_sorted
    return GroupLayout(gids, num_groups, counts, order, rank)


def bucket_size(n: int) -> int:
    """Round ``n`` up to a shape bucket (8 sub-buckets per power of two,
    <=12.5% padding waste). Kept from the reference engine so both engines
    pick the same block width for the same data."""
    if n <= 8:
        return max(n, 1)
    step = 1 << (max(0, (n - 1).bit_length() - 4))
    return -(-n // step) * step


def padded_indices(layout: GroupLayout) -> Tuple[np.ndarray, np.ndarray, int]:
    """Row-gather indices for the fully padded [G, R_max] layout.

    Returns (gather_idx [G, R], pad_mask [G, R], R). Padding rows gather
    row 0 and are masked out.
    """
    from .native import native_scatter_blocks

    G = layout.num_groups
    R = bucket_size(int(layout.counts.max())) if G else 0
    nat = native_scatter_blocks(
        layout.gids, layout.rank_in_group,
        np.arange(G, dtype=np.int64), R, G,
    ) if R else None
    if nat is not None:
        return nat[0], nat[1], R
    gather = np.zeros((G, R), dtype=np.int64)
    mask = np.zeros((G, R), dtype=bool)
    rows = np.arange(len(layout.gids), dtype=np.int64)
    gather[layout.gids, layout.rank_in_group] = rows
    mask[layout.gids, layout.rank_in_group] = True
    return gather, mask, R


def split_padded_indices(
    layout: GroupLayout, r_cap: int = 512
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Row-gather indices for the split-padded [S, R_cap] layout.

    Groups larger than ``r_cap`` rows are split across several contiguous
    blocks. Returns (gather_idx [S, R_cap], pad_mask [S, R_cap],
    block_group [S], S).
    """
    from .native import native_scatter_blocks

    n_blocks_per_group = layout._blocks_per_group(r_cap)
    S = int(n_blocks_per_group.sum())
    block_group = np.repeat(
        np.arange(layout.num_groups, dtype=np.int64), n_blocks_per_group
    )
    block_first = np.zeros(layout.num_groups, dtype=np.int64)
    np.cumsum(n_blocks_per_group[:-1], out=block_first[1:])

    nat = native_scatter_blocks(
        layout.gids, layout.rank_in_group, block_first, r_cap, S
    )
    if nat is not None:
        return nat[0], nat[1], block_group, S

    rows = np.arange(len(layout.gids), dtype=np.int64)
    block_of_row = block_first[layout.gids] + layout.rank_in_group // r_cap
    slot_of_row = layout.rank_in_group % r_cap

    gather = np.zeros((S, r_cap), dtype=np.int64)
    mask = np.zeros((S, r_cap), dtype=bool)
    gather[block_of_row, slot_of_row] = rows
    mask[block_of_row, slot_of_row] = True
    return gather, mask, block_group, S
