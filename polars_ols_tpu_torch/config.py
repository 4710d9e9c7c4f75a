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
        virtual_devices: n > 0 makes the mesh (parallel/sharded.py) n
            shards, each on the one ``device()``; 0 (the default) gives it
            one shard a device: every visible CUDA device where ``device``
            is CUDA, the one CPU otherwise. This is the counterpart of the
            XLA host-platform device count the JAX package's tests set
            (``--xla_force_host_platform_device_count=8``), not a mode of
            its own. ``POLS_TORCH_VIRTUAL_DEVICES``.
        auto_shard: grouped fits run through the sharded engine
            (parallel/sharded.py) when the mesh has more than one shard. On
            by default only when more than one CUDA device is visible and
            ``device`` is CUDA; off on the CPU. ``POLS_TORCH_AUTO_SHARD``.
    """

    def __init__(self) -> None:
        self.device = os.environ.get("POLS_TORCH_DEVICE", "cuda")
        self.moment_chunk_rows = int(os.environ.get("POLS_TORCH_CHUNK_ROWS", 512))
        self.lazy_row_order = bool(int(os.environ.get("POLS_TORCH_LAZY", "1")))
        self.fused_select = bool(int(os.environ.get("POLS_TORCH_FUSED_SELECT", "1")))
        self.virtual_devices = int(os.environ.get("POLS_TORCH_VIRTUAL_DEVICES", "0"))
        env = os.environ.get("POLS_TORCH_AUTO_SHARD")
        self._auto_shard = None if env is None else bool(int(env))

    @property
    def auto_shard(self) -> bool:
        if self._auto_shard is None:
            return (
                torch.device(self.device).type == "cuda"
                and torch.cuda.is_available()
                and torch.cuda.device_count() > 1
            )
        return self._auto_shard

    @auto_shard.setter
    def auto_shard(self, value) -> None:
        self._auto_shard = None if value is None else bool(value)


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
