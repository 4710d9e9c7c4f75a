"""Run one cell of the benchmark once.

A cell (``BENCHMARK.json``'s ``workloads``) is a configuration (its file
under ``configs/``: the frame's sizes) under a mix (``mixes/<traffic>.json``:
the cycle of selects one client issues over the frame). A run:

1. set-up: imports the program, makes the inputs on the device from the
   seed (``data.py``), builds the frame and the mix's expressions
   (``traffic.py``) and runs every select of the cycle ``WARM_PASSES``
   times, which builds the kernels and fills the program's layout caches;
2. ``--trace 0``: the window, a closed loop over the cycle for
   ``--seconds``; each select is timed from the ``select`` call to the
   synchronise after its output columns are materialised in row order;
   ``--trace 1``: half the window unprofiled, then ``TRACE_SELECTS``
   selects under ``torch.profiler``, read by the per-layer readers;
3. the check (``check.py``): the answers kept from the timed selects
   against the plain reference, each compared number beside its limit.

It prints the result as the last line of standard output and the compared
numbers as the last lines of standard error.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from portbench import check, data, traffic
from portbench.metrics import reader_file
from portbench.tracing import Stretch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
WARM_PASSES = 2
TRACE_SELECTS = 24  # selects in the profiled stretch
PROFILE_TRIES = 5
FORBIDDEN = ("jax", "jaxlib", "flax", "polars_ols_tpu")
GIB = float(1 << 30)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload of the manifest with its configuration, mix, limits and
    the metrics it reports."""

    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    @classmethod
    def load(cls, workload: str, root: Path = ROOT) -> "Cell":
        manifest = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; the manifest has {sorted(cells)}")
        w = cells[workload]
        config = {c["name"]: c for c in manifest["configs"]}[w["config"]]

        def applies(m):
            return workload in m.get("workloads", [workload])

        return cls(
            name=workload, chips=int(w["chips"]), cfg=load_json(root / config["file"]),
            mix=load_json(BENCH / "mixes" / f"{w['traffic']}.json"),
            limits=load_json(BENCH / "limits" / f"{workload}.json"),
            end_to_end=[m for m in manifest["end_to_end"] if applies(m)],
            per_layer=[m for m in manifest["per_layer"] if applies(m)],
        )


@dataclass
class State:
    """What set-up made: the program module, the inputs, the frame, the
    cycle's expressions and the sample plan."""

    pt: object
    torch: object
    device: str
    inputs: data.Inputs
    frame: object
    selects: list
    rows: np.ndarray
    gids: np.ndarray
    runs: list
    rows_dev: object


@dataclass
class Loop:
    """The closed loop's record: each select's latency (s) and host span
    (s), failures, and the answers kept at the sampled runs."""

    latencies: List[float] = field(default_factory=list)
    host: List[float] = field(default_factory=list)
    failed: int = 0
    errors: List[str] = field(default_factory=list)
    kept: List[tuple] = field(default_factory=list)  # (select of the cycle, label -> answers)
    issued: int = 0
    end: float = 0.0


def sync(torch, device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def finish(out) -> None:
    """Materialise every output column (a deferred row order is gathered)."""
    for name in out.columns:
        out[name].values


def setup(cell: Cell, seed: int, device: str, t_start: Optional[float] = None) -> State:
    """Everything before the window; prints the seconds of each step on
    standard error (``start``: from ``t_start``, the process's first line,
    through the imports of the harness and torch)."""
    t = [time.perf_counter()] if t_start is None else [t_start, time.perf_counter()]
    import torch

    import polars_ols_tpu_torch as pt

    pt.CONFIG.device = device
    pt.CONFIG.lazy_row_order = False  # outputs in row order inside the select
    t.append(time.perf_counter())
    inputs = data.make_inputs(cell.cfg, seed, device)
    sync(torch, device)
    t.append(time.perf_counter())
    frame = pt.DataFrame(inputs.columns(cell.cfg))
    selects = traffic.build_selects(pt, cell.mix, cell.cfg)
    rows, gids, runs = check.plan(cell.mix, cell.cfg, inputs.key, seed)
    state = State(pt, torch, device, inputs, frame, selects, rows, gids, runs,
                  torch.as_tensor(rows, device=device))
    t.append(time.perf_counter())
    for _ in range(WARM_PASSES):
        for exprs, fits in zip(selects, cell.mix["selects"]):
            out = frame.select(*exprs)
            finish(out)
            check.keep(out, fits, state.rows_dev)
            sync(torch, device)
        t.append(time.perf_counter())
    steps = ["start"] * (t_start is not None) + ["program_import", "inputs", "frame"]
    steps += [f"warm_pass_{i + 1}" for i in range(WARM_PASSES)]
    print("setup_s by step: " + json.dumps({k: b - a for k, a, b in zip(steps, t, t[1:])}), file=sys.stderr)
    return state


def drive(state: State, cell: Cell, loop: Loop, seconds: Optional[float] = None,
          count: Optional[int] = None, marked: bool = False) -> None:
    """Issue selects of the cycle one after another, each after the last
    one completed, until ``seconds`` have passed or ``count`` were issued;
    ``marked``: each select call inside a profiler span of its own."""
    from torch.profiler import record_function

    torch, frame, L = state.torch, state.frame, len(state.selects)
    fits = cell.mix["selects"]
    start = time.perf_counter()
    stop_at = start + seconds if seconds is not None else math.inf
    issued = 0
    while (count is None or issued < count) and time.perf_counter() < stop_at:
        i = loop.issued
        p, run = i % L, i // L
        t0 = time.perf_counter()
        try:
            if marked:
                with record_function("portbench.select"):
                    out = frame.select(*state.selects[p])
            else:
                out = frame.select(*state.selects[p])
            t1 = time.perf_counter()
            finish(out)
            sync(torch, state.device)
        except Exception as e:  # a failed select counts against the attempts; the loop goes on
            loop.failed += 1
            if len(loop.errors) < 3:
                loop.errors.append(f"{type(e).__name__}: {e}")
            out = None
            t1 = time.perf_counter()
        else:
            loop.latencies.append(time.perf_counter() - t0)
            loop.host.append(t1 - t0)
            if run in state.runs[p]:
                loop.kept.append((p, check.keep(out, fits[p], state.rows_dev)))
        loop.issued += 1
        issued += 1
        loop.end = time.perf_counter()


def judge(state: State, cell: Cell, loop: Loop):
    """(correct, compared numbers): the kept answers against the reference."""
    host = state.inputs.host_rows(state.rows)
    ref = check.reference(cell.mix, cell.cfg, host, state.gids)
    nums = check.compare(cell.mix, [check.to_host(kept) for _, kept in loop.kept], ref)
    covered = {p for p, _ in loop.kept} == set(range(len(state.selects)))
    return check.verdict(nums, cell.limits) and covered and loop.failed == 0, nums


def load_reader(name: str):
    path = reader_file(BENCH / "metrics", name)
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Context:
    """What a per-layer reader reads (metrics/__init__.py)."""

    cfg: dict
    mix: dict
    counts: np.ndarray
    stretch: Stretch
    host_ms: List[float]
    rows_per_s: float  # the traced run's rate before the stretch, profiler off


def profile_stretch(state: State, cell: Cell, loop: Loop) -> Stretch:
    """TRACE_SELECTS selects under the profiler, taken again where the
    device recorded fewer kernels than the host launched. Raises where
    the last try is still short of kernels: its device shares would read
    wrong, so the run gives no result."""
    from torch.profiler import ProfilerActivity, profile

    L = len(state.selects)
    for attempt in range(1, PROFILE_TRIES + 1):
        first = loop.issued
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            drive(state, cell, loop, count=TRACE_SELECTS, marked=True)
            wall = time.perf_counter() - t0
        fits = [cell.mix["selects"][i % L] for i in range(first, loop.issued)]
        stretch = Stretch.from_profile(prof, TRACE_SELECTS, fits, wall)
        if stretch.complete:
            return stretch
        print(f"profiled stretch {attempt} of {PROFILE_TRIES}: {stretch.dropped} kernel records "
              f"dropped of {stretch.launches} launches", file=sys.stderr)
    raise RuntimeError(f"every profiled stretch dropped kernel records ({PROFILE_TRIES} tries)")


def power_limit() -> Optional[str]:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and proc.stdout.strip() else None


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda") -> dict:
    """One run of ``cell``; returns the result's fields."""
    state = setup(cell, seed, device, t_start)
    torch = state.torch
    loop = Loop()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    out: dict = {}
    if not trace:
        drive(state, cell, loop, seconds=seconds)
        if not loop.latencies:
            raise RuntimeError(f"no select completed in the window: {loop.errors}")
        window = loop.end - t_window
        n_rows = int(cell.cfg["rows"])
        values = {
            "rows_per_s": n_rows * len(loop.latencies) / window,
            "query_ms_p95": float(np.percentile(np.asarray(loop.latencies) * 1e3, 95)),
            "setup_s": setup_s,
        }
    else:
        drive(state, cell, loop, seconds=seconds / 2)
        host_ms = [h * 1e3 for h in loop.host]
        rate = int(cell.cfg["rows"]) * len(loop.latencies) / (loop.end - t_window)
        stretch = profile_stretch(state, cell, loop)
        ctx = Context(cell.cfg, cell.mix, np.bincount(state.inputs.key, minlength=int(cell.cfg["groups"])),
                      stretch, host_ms, rate)
        values = {}
        for m in cell.per_layer:
            got = load_reader(m["name"]).read(ctx)
            if got is not None:
                values[m["name"]] = float(got)
        out["device_extra"] = {"busy_s": stretch.busy_s, "window_s": stretch.wall_s}
        out["breakdown"] = {"device_ops": stretch.top_device_ops(), "idle_gaps": stretch.idle_gaps()}
    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    values["device_mem_peak_gib"] = peak / GIB
    wanted = cell.per_layer if trace else cell.end_to_end
    out["metrics"] = {}
    for m in wanted:  # a split quantity, <quantity>.<part>, is the quantity's value
        v = values.get(m["name"], values.get(m["name"].split(".", 1)[0]))
        if v is not None:
            out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    missing = sorted({m["name"] for m in wanted} - set(out["metrics"]))
    if not trace and missing:
        raise RuntimeError(f"the harness computes no end-to-end metric named {missing}")
    correct, nums = judge(state, cell, loop)
    out.update(correct=correct, nums=nums, attempted=loop.issued, failed=loop.failed, errors=loop.errors,
               peak=peak)
    return out


def number(v: float):
    """A compared number for the JSON line: a non-finite one as a string."""
    return v if math.isfinite(v) else str(v)


def loaded_forbidden() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(args, t_start: float) -> int:
    import torch

    cell = Cell.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    got = run(cell, args.seed, float(args.seconds), bool(args.trace), t_start)
    found = loaded_forbidden()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    device = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
        "memory_peak_bytes": got["peak"], "power_limit": power_limit(),
        **got.get("device_extra", {}),
    }
    for e in got["errors"]:
        print(f"failed select: {e}", file=sys.stderr)
    result = {
        "correct": got["correct"], "attempted": got["attempted"], "failed": got["failed"],
        "metrics": got["metrics"], "device": device,
        **({"breakdown": got["breakdown"]} if "breakdown" in got else {}),
        "checks": {k: {"value": number(v), "limit": cell.limits.get(k)} for k, v in got["nums"].items()},
    }
    print(json.dumps(result), flush=True)
    for k, v in got["nums"].items():
        print(f"check {k} {v!r} limit {cell.limits.get(k)!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0
