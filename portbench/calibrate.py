"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 portbench/calibrate.py --workload grouped_k5.ols --seeds 1 2 3 --control-seeds 1 2 3

For each seed, in one process: the cell's set-up at its own size, the
cycle run until every kept run of it is reached (a run's sample, at the
cell's load), and the compared numbers of those answers against the
reference (the lower readings). For each control seed, the control: the
reference computed in float32, the precision below the configuration's
float64, put in the program's place and compared the same way (the upper
readings). One JSON line a reading; the benchmark's own runs do not run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import check, harness  # noqa: E402


def program_readings(cell, seed: int, device: str) -> dict:
    """The compared numbers of the program's answers for ``seed``."""
    state = harness.setup(cell, seed, device)
    loop = harness.Loop()
    harness.drive(state, cell, loop, count=len(state.selects) * check.LATER_RUNS)
    t0 = time.perf_counter()
    correct, nums = harness.judge(state, cell, loop)
    return {"correct": correct, "nums": nums, "samples": len(loop.kept),
            "reference_s": time.perf_counter() - t0, "state": state}


def control_readings(cell, state, samples: int) -> dict:
    """The compared numbers of the float32 reference in the program's place,
    with as many kept answers as a run compares."""
    host = state.inputs.host_rows(state.rows)
    ref = check.reference(cell.mix, cell.cfg, host, state.gids)
    low = check.reference(cell.mix, cell.cfg, host, state.gids, np.float32)
    stand_in = {label: (v.astype(np.float64), np.isnan(v)) for label, v in low.items()}
    per_select = [{f["label"]: stand_in[f["label"]] for f in fits} for fits in cell.mix["selects"]]
    kept = [per_select[i % len(per_select)] for i in range(samples)]
    nums = check.compare(cell.mix, kept, ref)
    return {"correct": check.verdict(nums, cell.limits), "nums": nums}


def release(state) -> None:
    """Free the program's caches and the frame before the next seed."""
    state.pt.clear_caches()
    if state.device.startswith("cuda"):
        state.torch.cuda.synchronize()
        state.torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch

    cell = harness.Cell.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); readings for the limits come from the card",
              file=sys.stderr)
        return 2
    low: dict = {}
    high: dict = {}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        got = program_readings(cell, seed, "cuda")
        state = got.pop("state")
        if seed in args.seeds:
            print(json.dumps({"cell": cell.name, "seed": seed, "side": "program", **got}), flush=True)
            for k, v in got["nums"].items():
                low[k] = max(low.get(k, 0.0), v)
        if seed in args.control_seeds:
            ctl = control_readings(cell, state, got["samples"])
            print(json.dumps({"cell": cell.name, "seed": seed, "side": "control", **ctl}), flush=True)
            for k, v in ctl["nums"].items():
                high[k] = min(high.get(k, float("inf")), v)
        release(state)
        del state
    print(json.dumps({"cell": cell.name, "lower": low, "upper": high, "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
