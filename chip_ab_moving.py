"""Times the moving kernel's shared form (csrc/moving.cu, K > 8) of two
checkouts of this repository in turns on one GPU, and this checkout's
phases.

    python3 chip_ab_moving.py OTHER_CHECKOUT

Loads ``polars_ols_tpu_torch`` from this checkout and, under another name,
from OTHER_CHECKOUT (``chip_ab_jacobi.other_ops``; each builds its kernel
from its own sources into its own ``_build/``). At three frames of random
rows made on the card (``chip_smoke._moving_args``): B "grouped_largek"'s
group sizes at K = 40 (1,000 groups, 500,000 rows), A "large"'s one group
of 10,000 rows at K = 100, and the main frame's group sizes at K = 16 and
32 (10,000 groups, 8,000,000 rows), for rls(252) and rolling_ols(252), it
holds this checkout's predictions to the other's (equal NaN patterns,
values within chip_smoke.MOVING_KERNEL_TOL where a rolling window holds
K + SETTLED_EXTRA rows), times the two in turns (``chip_smoke._in_turns``:
other, this, this, other, ...), device ms per launch of the predictions,
and times this checkout's walk stopped after each of its phases
(``chip_smoke._moving_phases``). Prints the card, one line a frame and
model and, last, one JSON object. Exits non-zero without a CUDA device or
when the two disagree.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs
from chip_ab_jacobi import other_ops

# label: (group sizes, K, seed of the rows)
SHAPES = {
    "B": (cs.largek_counts, 40, 40),
    "A": (lambda: np.asarray([cs.LARGE_SHAPE[0]]), 100, 100),
    "main K=16": (cs.main_frame_counts, 16, 26),
    "main K=32": (cs.main_frame_counts, 32, 42),
}


def _kernel_ms(fn, torch):
    """{kernel name: device ms} of one call of fn (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        ms = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3
        if ms > 0:
            name = e.key.replace("void ", "").replace("(anonymous namespace)::", "")
            out[name.split("((")[0].split("(")[0][:60]] = ms
    return out


def main(argv) -> int:
    import torch

    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab_moving: torch sees no CUDA device", file=sys.stderr)
        return 1
    from polars_ols_tpu_torch.ops import moving, recursive, rolling

    other = other_ops(Path(argv[0]).resolve(), "moving")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    ff = recursive.forgetting_factor(cs.HALF_LIFE)
    rows = []
    for label, (sizes, K, seed) in SHAPES.items():
        counts = sizes()
        R = int(counts.max())
        args = cs._moving_args(counts, R, K, rolling, ff, torch, seed)
        phases = cs._moving_phases(label, counts, args, moving, torch, smi)
        for model, a in args.items():
            out = moving._launch(*a, "predictions", None, counts)
            ref = other._launch(*a, "predictions", None, counts)
            settled = None
            if model == "rolling":
                settled = cs._window_counts(a[1].cpu().numpy(), cs.WINDOW, True) >= K + cs.SETTLED_EXTRA
            err = cs._moving_diff(out, ref, counts, settled)
            live = torch.arange(R, device=out.device) < a[2][:, None]  # the groups' own rows
            same_bits = bool(torch.equal(torch.nan_to_num(out[live]), torch.nan_to_num(ref[live])))
            del out, ref
            times = cs._in_turns({
                "other": lambda a=a: other._launch_kernels(*a, "predictions", None, counts),
                "this": lambda a=a: moving._launch_kernels(*a, "predictions", None, counts),
            }, 1, torch)
            T = moving.stretch_rows(K, model == "rolling")
            walkers = moving._resident_warps(a[0].device, K, model == "rolling", T, False)
            plan = moving.plan_ranges(counts, moving.plan_unit(K, model == "rolling", T), walkers, None,
                                      moving.plan_waves(K))
            shape = {"layout": moving.shared_layout(K, model == "rolling", T), "walkers": walkers,
                     "range_rows": plan.L, "ranges": plan.M,
                     "kernels_ms": _kernel_ms(lambda a=a: moving._launch_kernels(*a, "predictions", None, counts),
                                              torch)}
            print(f"moving {model} on {label}: {json.dumps(shape)}")
            row = {"frame": label, "model": model, "G": len(counts), "rows": int(counts.sum()), "K": K, **shape,
                   "ms": times["this"][0], "other_ms": times["other"][0], "max_abs_err": err,
                   "same_bits": same_bits, "phases_ms": phases[model]}
            print(f"moving {model} on {label} (G={len(counts)}, {int(counts.sum())} rows, K={K}): this checkout "
                  f"{row['ms']!r} ms, other {row['other_ms']!r} ms per launch of the predictions; max abs "
                  f"difference {err!r}, same bits: {same_bits} ({smi})")
            rows.append(row)
        del args
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "moving_ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
