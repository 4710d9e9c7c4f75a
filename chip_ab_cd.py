"""Times the wide coordinate-descent kernels and the wide configurations'
coordinate-descent queries of two checkouts of this repository in turns on
one GPU.

    python3 chip_ab_cd.py OTHER_CHECKOUT [--no-queries]

Runs each checkout's ``polars_ols_tpu_torch`` in a process of its own
(other, this, this, other), each building its kernels from its own sources
into its own ``_build/``. Each process makes ``chip_smoke.py``'s two wide
frames (``_suite_frame``: B "grouped_largek", 500,000 rows x 40 features x
1,000 groups, and A "large", 10,000 x 100; seeded numpy, so both checkouts
fit the same data) and times, by ``chip_smoke._wide_cd_ms``:

- ``cd_fista`` (the suite's elastic net, max_iter 200) and
  ``cd_cyclic_wide`` (the lasso's cd_active_set) on B's and A's moments,
  whole and stopped early (FISTA at max_iter 0: the power steps alone; the
  cyclic form at max_iter 1: one sweep);
- both on ``chip_smoke.FISTA_CHECKS`` / ``CYCLIC_WIDE_CHECKS`` (moments
  drawn on the card from their seeds) and FISTA on test_fit_wide's lasso
  (``chip_smoke.FIT_WIDE``: one group of 10 rows x 1,000 features);

each with its iteration or sweep counts (median, max) and an FNV digest of
its w, so the two checkouts' bits can be compared; then B's and A's CD
queries (``elastic_net``, ``lasso``, ``nnls`` (positive=True),
``lasso_active_set``, ``elastic_net_statistics``; ``_wide_queries``): the
wall ms, median of ``chip_smoke.TIMING_REPS`` after a warm call, and the
device busy ms, launches and host syncs a query from
``chip_smoke._profile``. Prints the card, one line a process and, last, one
JSON object. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ORDER = ("other", "this", "this", "other")
QUERIES = ("elastic_net", "lasso", "nnls", "lasso_active_set", "elastic_net_statistics")


def _digest(t) -> str:
    """FNV-1a over the bytes of a tensor (NaN payloads included)."""
    h = 0xCBF29CE484222325
    for byte in t.detach().cpu().contiguous().numpy().tobytes():
        h = ((h ^ byte) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return f"{h:016x}"


def _kernel(cs, cd, torch, args, fista, early=None):
    """ms a launch (``_wide_cd_ms``), counts and w's digest of one wide
    kernel; ``early`` replaces max_iter."""
    if early is not None:
        args = (*args[:5], early, *args[6:])
    w, counts = cd.launch_wide(*args, not fista, fista=fista)
    torch.cuda.synchronize()
    ms, _ = cs._wide_cd_ms(lambda: cd.launch_wide(*args, not fista, fista=fista), torch)
    c = counts.cpu().numpy()
    return {"ms": ms, "counts_median": float(np.median(c)), "counts_max": int(c.max()), "w": _digest(w)}


def run(root: Path, queries: bool) -> dict:
    """Each timing of this checkout, in this process."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    import polars_ols_tpu_torch as pt
    from polars_ols_tpu_torch import CONFIG, col
    from polars_ols_tpu_torch.engine import fit, groups
    from polars_ols_tpu_torch.ops import cd
    from polars_ols_tpu_torch.ops.direct import grouped_moments

    CONFIG.lazy_row_order = False
    out = {}
    for name, shape in (("B", cs.LARGEK_SHAPE), ("A", cs.LARGE_SHAPE)):
        n, k, n_groups = shape
        frame, *_ = cs._suite_frame(pt, torch, n, k, n_groups)
        layout, Zp, wp, offsets = cs._wide_blocks(fit, groups, frame, k, bool(n_groups))
        XtX, Xty, counts = grouped_moments(Zp, wp, offsets, layout.num_groups)
        XtX, Xty = XtX.contiguous(), Xty.contiguous()
        del Zp, wp
        enet = (XtX, Xty, counts, cs.WIDE_ALPHA, 0.5, 200, 1e-5, False)
        lasso = (XtX, Xty, counts, cs.WIDE_ALPHA, 1.0, 1000, 1e-5, False)
        out[f"{name} cd_fista"] = _kernel(cs, cd, torch, enet, True)
        out[f"{name} cd_fista power steps"] = _kernel(cs, cd, torch, enet, True, early=0)
        out[f"{name} cd_cyclic_wide"] = _kernel(cs, cd, torch, lasso, False)
        out[f"{name} cd_cyclic_wide 1 sweep"] = _kernel(cs, cd, torch, lasso, False, early=1)
        del XtX, Xty
        if queries:
            for label, (q, _) in cs._wide_queries(pt, col, k, bool(n_groups)).items():
                if label not in QUERIES:
                    continue
                fn = lambda q=q: frame.select(q)  # noqa: E731
                wall = cs._timed_median(fn, torch)
                prof = cs._profile(fn, torch)
                out[f"{name} query {label}"] = {
                    "wall_ms": wall * 1e3,
                    **({key: prof[key] for key in ("busy_ms", "launches", "host_syncs", "idle_share")} if prof else {}),
                }
        del frame
        torch.cuda.empty_cache()
    for checks, fista in ((cs.FISTA_CHECKS, True), (cs.CYCLIC_WIDE_CHECKS, False)):
        for i, (K, G, rows, kw) in enumerate(checks):
            XtX, Xty, counts = cs._wide_cd_moments(1_000 * K + G + i, G, K, rows, torch)
            args = (XtX, Xty, counts, kw["alpha"], kw.get("l1_ratio", 0.5), kw.get("max_iter", 1000),
                    kw.get("tol", 1e-5), kw.get("positive", False))
            out[f"{'cd_fista' if fista else 'cd_cyclic_wide'} K={K} G={G}"] = _kernel(cs, cd, torch, args, fista)
            del XtX, Xty
    n, K, kw = cs.FIT_WIDE
    rng = np.random.default_rng(0)  # tests/test_ols.py:_make_data(10, 1_000, scale=1e-4)
    X = rng.normal(size=(n, K))
    y = X.sum(axis=1) + rng.normal(size=n, scale=1e-4)
    m = (torch.as_tensor((X.T @ X)[None], device="cuda"), torch.as_tensor((X.T @ y)[None], device="cuda"),
         torch.full((1,), float(n), dtype=torch.float64, device="cuda"))
    args = (*m, kw["alpha"], kw["l1_ratio"], kw["max_iter"], kw["tol"], False)
    out[f"cd_fista K={K} G=1 (test_fit_wide)"] = _kernel(cs, cd, torch, args, True)
    return out


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--run":
        print(json.dumps(run(Path(argv[1]).resolve(), "--no-queries" not in argv)))
        return 0
    args = [a for a in argv if a != "--no-queries"]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab_cd: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    here, other = Path(__file__).resolve().parent, Path(args[0]).resolve()
    extra = ["--no-queries"] if "--no-queries" in argv else []
    results = {"this": [], "other": []}
    for side in ORDER:
        root = here if side == "this" else other
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--run", str(root), *extra],
            capture_output=True, text=True, cwd=root,
        )
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        results[side].append(got)
        print(f"{side} ({root}): {json.dumps(got)} ({smi})")
    summary = {
        label: {side: [r.get(label) for r in runs] for side, runs in results.items()}
        for label in results["this"][0]
    }
    print(json.dumps({"device": smi, "timings": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
