"""Times selects of two checkouts of this repository in turns on one GPU.

    python3 chip_ab_select.py OTHER_CHECKOUT

Runs each checkout's ``polars_ols_tpu_torch`` in a process of its own
(other, this, this, other, twice), each building its kernels from its own
sources into its own ``_build/``. Each process makes the main frame
(8,000,000 rows x 5 features x 10,000 groups, f64, ``bench.py``'s shape;
made on the card from a seeded generator, so both checkouts fit the same
data) and times, as the median wall ms of REPS calls after a warm call
(host clock around ``select()`` and a synchronize), single fits
``.over("group")`` (ols, qr, statistics, rls) and the smoke's alpha sweep
(ols and seven ridge alphas) with ``CONFIG.fused_select`` off and on.
Prints the card, one line a process and, last, one JSON object with each
query's medians by checkout. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N_ROWS, N_FEATURES, N_GROUPS = 8_000_000, 5, 10_000
ALPHAS = (1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0, 1000.0)
REPS = 30
ORDER = ("other", "this", "this", "other") * 2


def _queries(pt):
    ls = pt.col("y").least_squares
    f = [pt.col(f"x{i + 1}") for i in range(N_FEATURES)]
    sweep = [ls.ols(*f).over("group").alias("ols")] + [
        ls.ridge(*f, alpha=a).over("group").alias(f"ridge_{a}") for a in ALPHAS
    ]
    return {
        "ols": ([ls.ols(*f).over("group")], True),
        "qr": ([ls.ols(*f, solve_method="qr").over("group")], True),
        "statistics": ([ls.ols(*f, mode="statistics").over("group")], True),
        "rls": ([ls.rls(*f, half_life=252.0).over("group")], True),
        "sweep/eager": (sweep, False),
        "sweep/fused": (sweep, True),
    }


def run(root: Path) -> dict:
    """The medians of one checkout, in this process."""
    sys.path.insert(0, str(root))
    import torch

    import polars_ols_tpu_torch as pt
    from polars_ols_tpu_torch import CONFIG

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N_ROWS, N_FEATURES, dtype=torch.float64, device="cuda", generator=gen)
    y = x.sum(dim=1) + 0.1 * torch.randn(N_ROWS, dtype=torch.float64, device="cuda", generator=gen)
    g = torch.randint(0, N_GROUPS, (N_ROWS,), device="cuda", generator=gen).to(torch.float64)
    data = {f"x{i + 1}": x[:, i].contiguous() for i in range(N_FEATURES)}
    df = pt.DataFrame({**data, "y": y, "group": g.cpu().numpy()})
    CONFIG.lazy_row_order = False
    out = {}
    for label, (exprs, fused) in _queries(pt).items():
        CONFIG.fused_select = fused
        df.select(*exprs)
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            df.select(*exprs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[label] = statistics.median(times)
    CONFIG.fused_select = True
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
        print("chip_ab_select: torch sees no CUDA device", file=sys.stderr)
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
        medians = json.loads(proc.stdout.strip().splitlines()[-1])
        results[side].append(medians)
        print(f"{side} ({root}): wall ms, median of {REPS}: {json.dumps(medians)} ({smi})")
    summary = {
        label: {side: [m[label] for m in runs] for side, runs in results.items()}
        for label in results["this"][0]
    }
    print(json.dumps({"device": smi, "wall_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
