"""The one generator of the benchmark's inputs: a configuration's frame,
made from the seed on the device.

Every column comes from one ``torch.Generator`` seeded with ``--seed``, in
a few large calls and in the order of ``benchmarks/suite.py:_make_df``:
the features x1..xK ~ N(0, 1), ``y = sum(x) + noise N(0, 1)``, ``y2 = x b
+ noise N(0, 1)`` with b ~ N(0, 1), ``w = U(0, 1) + weight_offset`` and
the group key. The groups' sizes are one fixed draw for the configuration
(``group_sizes``: a multinomial of the rows over equally likely groups,
from numpy's generator seeded with ``sizes_seed``), so every seed gives
the program the same work; the seed permutes which rows belong to which
group. The key goes to the host as an int64 array: the program factorizes
keys on the host and keeps integer columns there. The same seed gives the
same inputs on the same device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

F64 = torch.float64
SEED_MASK = (1 << 63) - 1


@dataclass
class Inputs:
    """The generated columns: float columns as f64 tensors on the device
    (``x`` is [K, N], one contiguous row a feature), the key on the host."""

    x: torch.Tensor
    y: torch.Tensor
    y2: torch.Tensor
    w: torch.Tensor
    key: np.ndarray

    def columns(self, cfg: dict) -> Dict[str, object]:
        """Name -> column, as the program's DataFrame takes them."""
        cols = {"y": self.y, "y2": self.y2, "w": self.w}
        cols.update({f"x{i + 1}": self.x[i] for i in range(self.x.shape[0])})
        cols[cfg["key"]] = self.key
        return cols

    def host_rows(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        """The float columns at ``rows`` on the host: x [n, K], y, y2."""
        idx = torch.as_tensor(rows, device=self.y.device)
        return {
            "x": self.x.index_select(1, idx).T.cpu().numpy(),
            "y": self.y.index_select(0, idx).cpu().numpy(),
            "y2": self.y2.index_select(0, idx).cpu().numpy(),
        }


def group_sizes(cfg: dict) -> np.ndarray:
    """The rows of each group [groups], the same for every seed."""
    n, g = int(cfg["rows"]), int(cfg["groups"])
    return np.random.default_rng(int(cfg["sizes_seed"])).multinomial(n, np.full(g, 1.0 / g))


def make_inputs(cfg: dict, seed: int, device: str) -> Inputs:
    """The configuration's columns for ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    n, k = int(cfg["rows"]), int(cfg["features"])
    noise = float(cfg["noise"])
    x = torch.randn((k, n), generator=gen, device=device, dtype=F64)
    y = x.sum(0) + noise * torch.randn(n, generator=gen, device=device, dtype=F64)
    b = torch.randn(k, generator=gen, device=device, dtype=F64)
    y2 = b @ x + noise * torch.randn(n, generator=gen, device=device, dtype=F64)
    w = torch.rand(n, generator=gen, device=device, dtype=F64) + float(cfg["weight_offset"])
    sizes = torch.as_tensor(group_sizes(cfg), device=device)
    ids = torch.repeat_interleave(torch.arange(len(sizes), device=device), sizes)
    key = ids[torch.randperm(n, generator=gen, device=device)]
    return Inputs(x=x, y=y, y2=y2, w=w, key=key.cpu().numpy())
