"""Times the Jacobi SVD kernel (csrc/jacobi_svd.cu) of two checkouts of
this repository in turns on one GPU.

    python3 chip_ab_jacobi.py OTHER_CHECKOUT

Loads ``polars_ols_tpu_torch`` from this checkout and, under another name,
from OTHER_CHECKOUT (each builds its kernel from its own sources into its
own ``_build/``). At K = 5, 6, 7 and 8 (10,000 factors: the main path's
groups), K = 16 and 32 (2,000: the smoke's edge batches) and the wide
form's shapes (B "grouped_largek": 1,000 factors of K = 40, M = 1 and its
multi-target M = 2; 1,000 of K = 48 and 64, either side of the segment
width's step; A "large": one of K = 100) it makes the smoke's
triangular factors (``chip_smoke._jacobi_edge``, kind "factor", seed K),
holds each checkout's ``factor_lstsq`` to this checkout's plain version
(``chip_smoke._jacobi_err``: within JACOBI_RTOL of each group's largest
|beta|, NaN where it has NaN) and times the two in turns
(``chip_smoke._in_turns``: other, this, this, other, ...), device ms per
launch; at B and A also each checkout's phases (stopped after 0, 1 and
all sweeps, in turns), and the wide form's rows mode at K = 1,000 / n = 10
/ 100 problems and K = 100 / n = 20 / 1,000. Prints the card, one line a
shape and, last, one JSON object. Exits non-zero without a CUDA device or
when a kernel disagrees.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs

# (K, groups, targets, label)
SHAPES = ((5, 10_000, 2, None), (6, 10_000, 2, None), (7, 10_000, 2, None), (8, 10_000, 2, None),
          (16, 2_000, 2, None), (32, 2_000, 2, None), (40, 1_000, 1, "B"), (40, 1_000, 2, "B multi-target"),
          (48, 1_000, 1, None), (64, 1_000, 1, None), (100, 1, 1, "A"))
PHASED = ("B", "A")
# (K, n, problems) of the rows mode
ROWS = ((1_000, 10, 100), (100, 20, 1_000))


def other_ops(root: Path, name: str):
    """ops/<name>.py of the package under ``root``, loaded as ``pols_other``."""
    if "pols_other" not in sys.modules:
        pkg = root / "polars_ols_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            "pols_other", pkg / "__init__.py", submodule_search_locations=[str(pkg)]
        )
        mod = importlib.util.module_from_spec(spec)
        sys.modules["pols_other"] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"pols_other.ops.{name}")


def main(argv) -> int:
    import torch

    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab_jacobi: torch sees no CUDA device", file=sys.stderr)
        return 1
    from polars_ols_tpu_torch.ops import jacobi

    other = other_ops(Path(argv[0]).resolve(), "jacobi")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    rows = []
    for K, G, M, label in SHAPES:
        F, Y, nv = cs._jacobi_edge(np.random.default_rng(K), G, K, M, "factor", torch)
        b_p = jacobi.factor_lstsq_ref(F, Y, nv)
        err = {
            "this": cs._jacobi_err(f"K={K} this checkout", jacobi.factor_lstsq(F, Y, nv), b_p, torch),
            "other": cs._jacobi_err(f"K={K} other checkout", other.factor_lstsq(F, Y, nv), b_p, torch),
        }
        times = cs._in_turns({
            "other": lambda: other.factor_lstsq(F, Y, nv),
            "this": lambda: jacobi.factor_lstsq(F, Y, nv),
        }, cs.JACOBI_LAUNCHES, torch)
        form = jacobi.kernel_form(K, G)
        row = {"K": K, "G": G, "M": M, "shape": label, "form": form[0], "threads": form[1],
               "ctas": jacobi.wide_ctas(K, G) if form[0] == "wide" else 1,
               "ms": times["this"][0], "other_ms": times["other"][0],
               "max_abs_err": err["this"], "other_max_abs_err": err["other"]}
        print(f"jacobi_svd K={K} G={G} M={M}{' (' + label + ')' if label else ''}: this checkout ({row['form']} "
              f"form, {row['threads']} threads, {row['ctas']} CTAs a group) {row['ms']!r} ms, other "
              f"{row['other_ms']!r} ms per launch; max abs err vs this plain version {err['this']!r} / "
              f"{err['other']!r} ({smi})")
        if label in PHASED:
            steps = (0, 1, jacobi.MAX_SWEEPS)
            fns = {}
            for n in steps:
                fns[f"this {n}"] = lambda n=n: jacobi.factor_lstsq(F, Y, nv, max_sweeps=n)
                fns[f"other {n}"] = lambda n=n: other.factor_lstsq(F, Y, nv, max_sweeps=n)
            ph = cs._in_turns(fns, cs.JACOBI_LAUNCHES, torch)
            row["phases_ms"] = {f"{n} sweeps": ph[f"this {n}"][0] for n in steps}
            row["other_phases_ms"] = {f"{n} sweeps": ph[f"other {n}"][0] for n in steps}
            _, _, sweeps, _ = jacobi.jacobi_ref(F)
            row["sweeps_median"] = float(sweeps.double().median())
            row["sweeps_max"] = int(sweeps.max())
            print(f"jacobi_svd {label} phases, ms per launch: this checkout {json.dumps(row['phases_ms'])}, "
                  f"other {json.dumps(row['other_phases_ms'])}; sweeps median {row['sweeps_median']!r} max "
                  f"{row['sweeps_max']} ({smi})")
        rows.append(row)
    for K, n, G in ROWS:
        rng = np.random.default_rng(K + n)
        Xt = torch.as_tensor(rng.normal(size=(G, n, K)), device="cuda").mT
        Yt = torch.as_tensor(rng.normal(size=(G, n, 1)), device="cuda")
        nv = torch.full((G,), float(n), dtype=torch.float64, device="cuda")
        b_p = jacobi.rows_lstsq_ref(Xt, Yt, nv)
        err = {
            "this": cs._jacobi_err(f"rows K={K} n={n} this checkout", jacobi.rows_lstsq(Xt, Yt, nv), b_p, torch),
            "other": cs._jacobi_err(f"rows K={K} n={n} other checkout", other.rows_lstsq(Xt, Yt, nv), b_p, torch),
        }
        times = cs._in_turns({
            "other": lambda: other.rows_lstsq(Xt, Yt, nv),
            "this": lambda: jacobi.rows_lstsq(Xt, Yt, nv),
        }, cs.JACOBI_LAUNCHES, torch)
        row = {"K": K, "n": n, "G": G, "shape": "rows mode", "ctas": jacobi.wide_ctas(K, G, n),
               "ms": times["this"][0], "other_ms": times["other"][0],
               "max_abs_err": err["this"], "other_max_abs_err": err["other"]}
        print(f"jacobi_svd rows mode K={K} n={n} G={G} ({row['ctas']} CTAs a problem): this checkout "
              f"{row['ms']!r} ms, other {row['other_ms']!r} ms per launch; max abs err vs this plain version "
              f"{err['this']!r} / {err['other']!r} ({smi})")
        rows.append(row)
    print(json.dumps({"card": smi, "jacobi_ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
