"""Times the Householder reduction kernel (csrc/householder.cu) of two
checkouts of this repository in turns on one GPU.

    python3 chip_ab_householder.py OTHER_CHECKOUT

Loads ``polars_ols_tpu_torch`` from this checkout and, under another name,
from OTHER_CHECKOUT (``chip_ab_jacobi.other_ops``; each builds its kernel
from its own sources into its own ``_build/``). At the wide form's blocks
of the smoke's two wide configurations, B "grouped_largek" (1,280 blocks
of 512 rows x 41 columns, K = 40), its multi-target (C = 42) and fault
(40 targets on K = 3) blocks, A "large" (20 x 512 x 101, K = 100), and
blocks of 2,000 and 9,000 rows at C = 41, on seeded normal rows with ~2 %
masked, it holds each checkout's ``householder_blocks`` to this
checkout's plain version (``chip_smoke._reduction_err``: each entry within
REDUCTION_RTOL of its column's norm), says whether the two give the same
bits, and times them in turns (``chip_smoke._in_turns``: other, this,
this, other, ...), device ms per launch; at B and A also each checkout's
phases (the kernel stopped after 0, 1, 8 and all K reflections, in turns).
Prints the card, one line a shape and, last, one JSON object. Exits
non-zero without a CUDA device or when a kernel disagrees.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs
from chip_ab_jacobi import other_ops

# label: (blocks, rows, columns, K)
SHAPES = {
    "B": (1_280, 512, 41, 40), "A": (20, 512, 101, 100), "B multi-target": (1_280, 512, 42, 40),
    "B fault": (1_280, 512, 43, 3), "R=2000": (20, 2_000, 41, 40), "R=9000": (2, 9_000, 41, 40),
}
PHASED = ("B", "A")


def main(argv) -> int:
    import torch

    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab_householder: torch sees no CUDA device", file=sys.stderr)
        return 1
    from polars_ols_tpu_torch.ops import householder

    other = other_ops(Path(argv[0]).resolve(), "householder")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    rows = []
    for label, (S, R, C, K) in SHAPES.items():
        rng = np.random.default_rng(C)
        Z = torch.as_tensor(rng.normal(size=(S, R, C)), device="cuda")
        w = torch.as_tensor(rng.random((S, R)) > 0.02, device="cuda")
        T_this = householder.householder_blocks(Z, w, K)
        T_other = other.householder_blocks(Z, w, K)
        T_p = householder.householder_blocks_ref(Z, w, K)
        err = {
            "this": max(cs._reduction_err(T_this, T_p, Z, w, C - K, torch)),
            "other": max(cs._reduction_err(T_other, T_p, Z, w, C - K, torch)),
        }
        same_bits = bool(torch.equal(T_this, T_other))
        del T_this, T_other, T_p
        times = cs._in_turns({
            "other": lambda: other.householder_blocks(Z, w, K),
            "this": lambda: householder.householder_blocks(Z, w, K),
        }, cs.HOUSEHOLDER_LAUNCHES, torch)
        row = {"shape": label, "S": S, "R": R, "C": C, "K": K, "form": householder.kernel_form(R, C),
               "ctas": householder.cluster_ctas(R, C),
               "ms": times["this"][0], "other_ms": times["other"][0], "same_bits": same_bits,
               "max_abs_err": err["this"], "other_max_abs_err": err["other"]}
        print(f"householder {label} S={S} R={R} C={C} K={K} ({row['form']}, {row['ctas']} CTAs a block): this "
              f"checkout {row['ms']!r} ms, other {row['other_ms']!r} ms per launch; same bits: {same_bits}; max "
              f"abs err vs this plain version {err['this']!r} / {err['other']!r} ({smi})")
        if label in PHASED:
            steps = sorted({0, 1, 8, K})
            fns = {}
            for r in steps:
                fns[f"this {r}"] = lambda r=r: householder._launch(Z, w, K, r)
                fns[f"other {r}"] = lambda r=r: other._launch(Z, w, K, r)
            ph = cs._in_turns(fns, cs.HOUSEHOLDER_LAUNCHES, torch)
            row["phases_ms"] = {f"{r} reflections": ph[f"this {r}"][0] for r in steps}
            row["other_phases_ms"] = {f"{r} reflections": ph[f"other {r}"][0] for r in steps}
            print(f"householder {label} phases, ms per launch: this checkout {json.dumps(row['phases_ms'])}, "
                  f"other {json.dumps(row['other_phases_ms'])} ({smi})")
        rows.append(row)
    print(json.dumps({"card": smi, "householder_ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
