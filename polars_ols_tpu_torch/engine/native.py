"""ctypes bindings to the native C++ host helpers.

The helpers (O(N) hash factorization of group keys, the counting-sort group
layout and the one-pass block scatter / unpad maps) are the C++ source
``engine/native/factorize.cpp`` of this package, a copy of the JAX
package's file of the same name kept here so that the port stands on its
own. It has no Python dependency; it is compiled with ``g++`` into the
package's git-ignored build directory at first use.

The shared object is named by a hash of the source and flags. A rebuilt
source therefore gets a new path, and dlopen can never hand back a stale
handle for an old build of the same path.

Falls back to numpy when ``g++`` is missing or the build fails;
``native_loaded()`` reports which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "native" / "factorize.cpp"
_CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_LIB = None
_TRIED = False


def _build() -> Optional[Path]:
    """Compile the source into BUILD_DIR (once per source revision); None
    when there is no compiler or the build fails."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None or not SOURCE.exists():
        return None
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(_CXXFLAGS).encode())
    out = BUILD_DIR / f"libpols_native_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name and rename: concurrent test workers may
    # race to build the same library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            [cxx, *_CXXFLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, timeout=300, check=False,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.pols_factorize_i64.argtypes = [i64p, ctypes.c_int64, i64p]
    lib.pols_factorize_i64.restype = ctypes.c_int64
    lib.pols_layout_build.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p,
    ]
    lib.pols_layout_build.restype = ctypes.c_int64
    lib.pols_scatter_blocks.argtypes = [
        i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.pols_scatter_blocks.restype = None
    lib.pols_unpad_map.argtypes = [
        i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pols_unpad_map.restype = None
    _LIB = lib
    return _LIB


def native_loaded() -> bool:
    """True when the C++ helpers are built and loaded (False: numpy paths)."""
    return _load() is not None


def _i64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a: np.ndarray, ctype=ctypes.c_int64):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_factorize(
    keys: np.ndarray, sort_keys: Optional[np.ndarray] = None
) -> Optional[np.ndarray]:
    """Dense-factorize int64 keys into group ids, remapped from first-seen
    order to sorted-unique order (numpy.unique semantics); ``sort_keys``
    supplies the ordering value when ``keys`` are raw bit patterns. None
    when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    keys = _i64(keys)
    out = np.empty(len(keys), dtype=np.int64)
    n_groups = lib.pols_factorize_i64(_ptr(keys), len(keys), _ptr(out))
    if n_groups < 0:
        return None
    order_vals = keys if sort_keys is None else sort_keys
    first_pos = np.full(n_groups, len(keys), dtype=np.int64)
    np.minimum.at(first_pos, out, np.arange(len(keys), dtype=np.int64))
    remap = np.argsort(np.argsort(order_vals[first_pos]))
    return remap[out]


def native_layout_build(gids: np.ndarray, num_groups: int):
    """Counting-sort group layout (counts, order, rank) in two linear
    passes. None when the library is unavailable or a gid is out of range."""
    lib = _load()
    if lib is None:
        return None
    gids = _i64(gids)
    n = len(gids)
    counts = np.empty(num_groups, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    rank = np.empty(n, dtype=np.int64)
    rc = lib.pols_layout_build(
        _ptr(gids), n, num_groups, _ptr(counts), _ptr(order), _ptr(rank)
    )
    if rc != 0:
        return None
    return counts, order, rank


def native_scatter_blocks(
    gids: np.ndarray, rank: np.ndarray, block_first: np.ndarray,
    r_cap: int, n_blocks: int,
):
    """One-pass scatter of rows into a blocked [S, r_cap] (gather, mask)
    pair. None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    gids, rank, block_first = _i64(gids), _i64(rank), _i64(block_first)
    gather = np.zeros((n_blocks, r_cap), dtype=np.int64)
    mask = np.zeros((n_blocks, r_cap), dtype=bool)
    lib.pols_scatter_blocks(
        _ptr(gids), _ptr(rank), _ptr(block_first), r_cap, len(gids),
        _ptr(gather), _ptr(mask, ctypes.c_uint8),
    )
    return gather, mask


def native_unpad_map(
    gids: np.ndarray, rank: np.ndarray, block_first: np.ndarray, r_cap: int
):
    """Row-order gather map [N] (int32) out of the blocked [S, r_cap]
    layout, one pass. None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    gids, rank, block_first = _i64(gids), _i64(rank), _i64(block_first)
    out = np.empty(len(gids), dtype=np.int32)
    lib.pols_unpad_map(
        _ptr(gids), _ptr(rank), _ptr(block_first), r_cap, len(gids),
        _ptr(out, ctypes.c_int32),
    )
    return out
