"""Runtime configuration for the PyTorch/CUDA least-squares engine.

The engine computes in f64 throughout (the reference casts every series to
Float64). torch's default dtype is f32, so every tensor the package creates
names ``torch.float64`` explicitly; the global default is never changed.

The device is explicit. ``CONFIG.device`` defaults to ``"cuda"`` and is set
by ``POLS_TORCH_DEVICE`` or by assignment. There is no automatic CPU
fallback: with the device set to ``cuda`` and no GPU present, the first
tensor creation raises.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

F64 = torch.float64

# shared libraries built at first use (the native host helpers and the CUDA
# kernels); git-ignored, each file named by a hash of its source and flags
BUILD_DIR = Path(__file__).resolve().parent / "_build"


class Config:
    """Runtime configuration knobs.

    Attributes:
        device: torch device string every column and layout tensor lives on.
        moment_chunk_rows: row-block cap of the split-padded moment layout
            (heavy groups split into blocks of at most this many rows).
        lazy_row_order: grouped predictions return block-ordered values
            with a deferred row-order permutation (series.BlockPermuted)
            instead of paying the [N] gather inside the query.
        fused_select: the fit expressions of a select of two or more
            expressions run together (engine/batch.py: shared moments,
            batched solves, one host read); off, each expression is
            evaluated on its own.
    """

    def __init__(self) -> None:
        self.device = os.environ.get("POLS_TORCH_DEVICE", "cuda")
        self.moment_chunk_rows = int(os.environ.get("POLS_TORCH_CHUNK_ROWS", 512))
        self.lazy_row_order = bool(int(os.environ.get("POLS_TORCH_LAZY", "1")))
        self.fused_select = bool(int(os.environ.get("POLS_TORCH_FUSED_SELECT", "1")))


CONFIG = Config()

# the weight given to rows whose sample weight is null (the reference's
# `_EPSILON`, polars_ols/least_squares.py:63)
EPSILON: float = 1.0e-12


def device() -> torch.device:
    """The configured device, checked: a CUDA device without a GPU raises
    instead of silently running on the CPU."""
    dev = torch.device(CONFIG.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"CONFIG.device is {CONFIG.device!r} but torch sees no CUDA device; "
            "set POLS_TORCH_DEVICE=cpu (or CONFIG.device = 'cpu') to run on the CPU"
        )
    return dev
