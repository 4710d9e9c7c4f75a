"""Times the Jacobi SVD kernel (csrc/jacobi_svd.cu) of two checkouts of
this repository in turns on one GPU.

    python3 chip_ab_jacobi.py OTHER_CHECKOUT

Loads ``polars_ols_tpu_torch`` from this checkout and, under another name,
from OTHER_CHECKOUT (each builds its kernel from its own sources into its
own ``_build/``). At K = 5, 6, 7 and 8 (10,000 factors: the main path's
groups) and K = 16 and 32 (2,000: the smoke's edge batches) it makes the
smoke's triangular factors (``chip_smoke._jacobi_edge``, kind "factor",
M = 2, seed K), holds each checkout's ``factor_lstsq`` to this checkout's
plain version (``chip_smoke._jacobi_err``: within JACOBI_RTOL of each
group's largest |beta|, NaN where it has NaN) and times the two in turns
(``chip_smoke._in_turns``: other, this, this, other, ...), device ms per
launch. Prints the card, one line a K and, last, one JSON object. Exits
non-zero without a CUDA device or when a kernel disagrees.
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

SHAPES = ((5, 10_000), (6, 10_000), (7, 10_000), (8, 10_000), (16, 2_000), (32, 2_000))
M = 2


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
    for K, G in SHAPES:
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
        row = {"K": K, "G": G, "M": M, "form": jacobi.kernel_form(K)[0],
               "ms": times["this"][0], "other_ms": times["other"][0],
               "max_abs_err": err["this"], "other_max_abs_err": err["other"]}
        print(f"jacobi_svd K={K} G={G} M={M}: this checkout ({row['form']} form) {row['ms']!r} ms, "
              f"other {row['other_ms']!r} ms per launch; max abs err vs this plain version "
              f"{err['this']!r} / {err['other']!r} ({smi})")
        rows.append(row)
    print(json.dumps({"card": smi, "jacobi_ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
