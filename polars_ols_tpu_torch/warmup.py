"""Build the CUDA kernels and run one query of each standard program family
at a workload's shape, so that the first real queries start warm.

On the card, a cold process pays for two things the JAX package does not
have in this form: each hand-written kernel (``csrc/*.cu``) is compiled by
``nvcc`` at its first use (seconds per source; ``cd_wide.cu``, with eight
template widths of two kernels, takes the longest), and each query's first
run builds its host layout, uploads the index maps and fills the layout
caches (engine/groups.py, engine/fit.py). ``warmup`` pays both up front:
it builds every source, one ``nvcc`` each and all at once (a source built
before, in the package's build directory, is loaded, not rebuilt), then
runs one query per (family, mode) on a synthetic frame of the given shape.
On the CPU it builds nothing and runs the queries on the plain versions.

Usage: call ``polars_ols_tpu_torch.warmup(n_rows, n_features,
n_groups=...)`` once at service start with the workload's shapes.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np

from .config import device
from .expr import col
from .frame import DataFrame
from .utils import device_sync

#: family name -> kwargs for the `least_squares` namespace entry point
_FAMILIES = {
    "ols": dict(),
    "ols_qr": dict(solve_method="qr"),
    "ols_svd": dict(solve_method="svd"),
    "ridge": dict(alpha=0.01),
    "wls": dict(),  # sample_weights attached below
    "elastic_net": dict(alpha=0.01, l1_ratio=0.5),
    "rls": dict(half_life=20.0),
    "rolling_ols": dict(window_size=64),
}

DEFAULT_FAMILIES = ("ols", "ridge", "wls", "elastic_net", "rls", "rolling_ols")


def _build_kernels() -> float:
    """Build every ``csrc/*.cu`` at once, one ``nvcc`` each; the seconds
    taken (sources built before are loaded from the build directory)."""
    from .ops.kernels import CSRC, build

    sources = sorted(p.stem for p in CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build, sources))
    return time.perf_counter() - t0


def warmup(
    n_rows: int,
    n_features: int,
    n_groups: Optional[int] = None,
    families: Sequence[str] = DEFAULT_FAMILIES,
    modes: Sequence[str] = ("predictions",),
    statistics: bool = False,
    seed: int = 0,
    verbose: bool = False,
) -> Dict[str, float]:
    """Build the kernels (on the card), then run one query per (family,
    mode) at this shape.

    Returns {"family/mode": seconds}: each query's first-call time on the
    host clock, synchronised with the device. ``n_groups=None`` warms the
    single-frame path; an integer warms the grouped ``.over()`` path at
    that group count.
    """
    unknown = set(families) - set(_FAMILIES)
    if unknown:
        raise AssertionError(f"unknown families {sorted(unknown)}; pick from {sorted(_FAMILIES)}")
    if device().type == "cuda":
        seconds = _build_kernels()
        if verbose:  # pragma: no cover
            print(f"warmup: kernels built in {seconds:.2f}s")
    rng = np.random.default_rng(seed)
    data = {
        "y": rng.normal(size=n_rows),
        "w": rng.uniform(0.5, 1.5, size=n_rows),
        **{f"x{i}": rng.normal(size=n_rows) for i in range(n_features)},
    }
    if n_groups is not None:
        data["g"] = rng.integers(n_groups, size=n_rows).astype(float)
    df = DataFrame(data)
    feats = [col(f"x{i}") for i in range(n_features)]

    modes = list(modes) + (["statistics"] if statistics else [])
    timings: Dict[str, float] = {}
    for fam in families:
        kwargs = dict(_FAMILIES[fam])
        entry = "ols" if fam in ("ols_qr", "ols_svd") else fam
        for mode in modes:
            if mode == "statistics" and fam in ("rls", "rolling_ols"):
                continue  # the moving models have no statistics mode (as the reference)
            call_kwargs = dict(kwargs, mode=mode)
            if entry == "wls":
                call_kwargs["sample_weights"] = col("w")
            expr = getattr(col("y").least_squares, entry)(*feats, **call_kwargs)
            if n_groups is not None:
                expr = expr.over("g")
            t0 = time.perf_counter()
            out = df.select(expr.alias("out"))
            device_sync(out["out"])
            timings[f"{fam}/{mode}"] = time.perf_counter() - t0
            if verbose:  # pragma: no cover
                print(f"warmup {fam}/{mode}: {timings[f'{fam}/{mode}']:.2f}s")
    return timings
