"""Times the wide configurations' ``svd`` and multi-target queries of two
checkouts of this repository in turns on one GPU.

    python3 chip_ab_svd.py OTHER_CHECKOUT

Runs each checkout's ``polars_ols_tpu_torch`` in a process of its own
(other, this, this, other), each building its kernels from its own sources
into its own ``_build/``. Each process makes ``chip_smoke.py``'s two wide
frames (``_suite_frame``: B "grouped_largek", 500,000 rows x 40 features x
1,000 groups with its 40 fault targets, and A "large", 10,000 x 100; seeded
numpy, so both checkouts fit the same data) and runs B's ``ols_svd``,
``ridge_svd``, multi-target ``struct(y, y2)`` and fault query (40 targets on
3 features) and A's ``ols_svd`` and ``ridge_svd`` (``_wide_queries``):
the wall ms, median of ``chip_smoke.TIMING_REPS`` after a warm call, and
the device busy ms, launches and host syncs a query from
``chip_smoke._profile``. These queries run the Householder reduction and the
Jacobi SVD (the fault query's Jacobi, K = 3, the thread form). Prints the
card, one line a process and, last, one JSON object. Exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ORDER = ("other", "this", "this", "other")
QUERIES = {"B": ("ols_svd", "ridge_svd", "multi_target", "fault_multi_target"), "A": ("ols_svd", "ridge_svd")}


def run(root: Path) -> dict:
    """Each query's wall, busy, launches and host syncs, in this process."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    import polars_ols_tpu_torch as pt
    from polars_ols_tpu_torch import CONFIG, col

    CONFIG.lazy_row_order = False
    out = {}
    for name, shape in (("B", cs.LARGEK_SHAPE), ("A", cs.LARGE_SHAPE)):
        n, k, groups = shape
        frame, x, *_ = cs._suite_frame(pt, torch, n, k, groups)
        fault = None
        if groups:
            rng_f = np.random.default_rng(11)
            T = x[:, :cs.FAULT_K] @ rng_f.normal(size=(cs.FAULT_K, cs.FAULT_TARGETS)) + 0.1 * rng_f.normal(
                size=(n, cs.FAULT_TARGETS))
            fault = [f"t{j}" for j in range(cs.FAULT_TARGETS)]
            frame = frame.with_columns(**{
                t: pt.Series(t, torch.as_tensor(T[:, j], device="cuda")) for j, t in enumerate(fault)
            })
        queries = cs._wide_queries(pt, col, k, bool(groups), fault)
        for label in QUERIES[name]:
            q, _ = queries[label]
            fn = lambda q=q: frame.select(q)  # noqa: E731
            wall = cs._timed_median(fn, torch)
            prof = cs._profile(fn, torch)
            out[f"{name} {label}"] = {
                "wall_ms": wall * 1e3,
                **({key: prof[key] for key in ("busy_ms", "launches", "host_syncs", "idle_share")} if prof else {}),
            }
        del frame
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--run":
        print(json.dumps(run(Path(argv[1]).resolve())))
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab_svd: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    here, other = Path(__file__).resolve().parent, Path(argv[0]).resolve()
    results = {"this": [], "other": []}
    for side in ORDER:
        root = here if side == "this" else other
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--run", str(root)],
            capture_output=True, text=True, cwd=root,
        )
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        results[side].append(got)
        print(f"{side} ({root}): {json.dumps(got)} ({smi})")
    summary = {
        label: {side: [r[label] for r in runs] for side, runs in results.items()}
        for label in results["this"][0]
    }
    print(json.dumps({"device": smi, "queries": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
