"""Kernel work counts, one file a kernel (``rooflines/<kernel>.py``).

Each file names the device functions of its kernel (``KERNELS``) and
gives ``select_bound_s(fits, cfg, counts)``: the least time, on the peaks
of ``peaks.py``, of the work the inputs of one select need of that kernel,
counted from the configuration's shapes and the groups' valid rows
(``counts``), whatever implements it. A roofline share is the bound over
the stretch's selects over the kernels' device time in the stretch.
"""

from __future__ import annotations

import importlib
from typing import Optional


def share(ctx, kernel: str) -> Optional[float]:
    """The stretch's share of the roofline of ``rooflines/<kernel>.py``,
    in %; None where the kernel did not run or no select needed it."""
    mod = importlib.import_module(f"portbench.rooflines.{kernel}")
    spent = ctx.stretch.kernel_s(mod.KERNELS)
    need = sum(mod.select_bound_s(fits, ctx.cfg, ctx.counts) for fits in ctx.stretch.fits)
    if spent <= 0.0 or need <= 0.0:
        return None
    return 100.0 * need / spent
