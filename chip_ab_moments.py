"""Times the moment kernel (csrc/moments.cu) of two checkouts of this
repository in turns on one GPU, beside ``torch.bmm``.

    python3 chip_ab_moments.py OTHER_CHECKOUT

Loads ``polars_ols_tpu_torch`` from this checkout and, under another name,
from OTHER_CHECKOUT (``chip_ab_jacobi.other_ops``; each builds its kernel
from its own sources into its own ``_build/``). At the wide form's blocks
of the smoke's two wide configurations, B "grouped_largek" (1,280 blocks
of 512 rows x 41 columns in 1,000 groups) and A "large" (20 x 512 x 101,
one group), and at the main path's (20,000 x 512 x 6 in 10,000 groups:
the register form, which this comparison should find unchanged), on
seeded normal rows with ~2 % masked, it holds each checkout's
``grouped_moments_blocks`` to this checkout's plain version (rtol 1e-12,
atol 1e-13 max|M|, counts exact), says whether the two give the same
bits, and times them in turns with this checkout's block pass alone (no
group, so no group sum) and ``torch.bmm`` of the pre-masked blocks
(``chip_smoke._in_turns``: other, this, blocks, bmm, bmm, blocks, this,
other, ...), device ms per launch. Prints the card, one line a shape and, last, one
JSON object. Exits non-zero without a CUDA device or when a kernel
disagrees.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs
from chip_ab_jacobi import other_ops

# label: (blocks, rows, columns, groups)
SHAPES = {"B": (1_280, 512, 41, 1_000), "A": (20, 512, 101, 1), "main": (20_000, 512, 6, 10_000)}


def main(argv) -> int:
    import torch

    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab_moments: torch sees no CUDA device", file=sys.stderr)
        return 1
    from polars_ols_tpu_torch.ops import moments

    other = other_ops(Path(argv[0]).resolve(), "moments")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    rows = []
    for label, (S, R, C, G) in SHAPES.items():
        rng = np.random.default_rng(C)
        Z = torch.as_tensor(rng.normal(size=(S, R, C)), device="cuda")
        w = torch.as_tensor(rng.random((S, R)) > 0.02, device="cuda")
        cuts = np.sort(rng.choice(np.arange(1, S), size=G - 1, replace=False)) if G > 1 else []
        offsets = torch.as_tensor(np.concatenate([[0], cuts, [S]]).astype(np.int64), device="cuda")
        M_p, c_p = moments.grouped_moments_blocks_ref(Z, w, offsets, G)
        scale = float(M_p.abs().max())
        err = {}
        out = {}
        for name, mod in (("this", moments), ("other", other)):
            M_k, c_k = mod.grouped_moments_blocks(Z, w, offsets, G)
            torch.testing.assert_close(M_k, M_p, rtol=1e-12, atol=1e-13 * scale)
            if not torch.equal(c_k, c_p):
                raise AssertionError(f"{label}: {name} checkout's counts differ from the plain version's")
            err[name] = float((M_k - M_p).abs().max())
            out[name] = M_k
        same_bits = bool(torch.equal(out["this"], out["other"]))
        del out, M_p
        Zm = torch.where(w[..., None], Z, torch.zeros((), dtype=Z.dtype, device=Z.device))
        none = torch.zeros(1, dtype=torch.int64, device="cuda")  # no group: the block pass alone
        times = cs._in_turns({
            "other": lambda: other.grouped_moments_blocks(Z, w, offsets, G),
            "this": lambda: moments.grouped_moments_blocks(Z, w, offsets, G),
            "this_blocks": lambda: moments.grouped_moments_blocks(Z, w, none, 0),
            "library": lambda: torch.bmm(Zm.mT, Zm),
        }, cs.MOMENT_LAUNCHES, torch)
        bound = cs._moment_bound(Z, w, G)
        row = {"shape": label, "S": S, "R": R, "C": C, "G": G, "ms": times["this"][0],
               "block_pass_ms": times["this_blocks"][0],
               "other_ms": times["other"][0], "library_ms": times["library"][0], **bound,
               "same_bits": same_bits, "max_abs_err": err["this"], "other_max_abs_err": err["other"]}
        print(f"moments {label} S={S} R={R} C={C} G={G}: this checkout {row['ms']!r} ms, other "
              f"{row['other_ms']!r} ms, torch.bmm {row['library_ms']!r} ms per launch (this checkout's block pass alone, no group sum: {row['block_pass_ms']!r} ms); bound {json.dumps(bound)}; "
              f"same bits: {same_bits}; max abs err vs plain {err['this']!r} / {err['other']!r} ({smi})")
        rows.append(row)
        del Z, w, Zm
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "moments_ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
