"""The probe kernel: a scaled copy ``x * 2`` of an f32 ``[M, N]`` tensor,
ungridded (one tile of all rows) or gridded (row tiles of ``block_rows``).

The port of ``experiments/pallas_grid_probe.py``. On a CUDA tensor
``scale_copy`` always launches the hand-written kernel
``csrc/grid_probe.cu`` and counts the launch in ``scale_copy_launches``; a
failed build or launch raises. The kernel cuts each tile into 8 KB chunks,
one thread block each, and stages every chunk through shared memory with
Hopper's bulk copies completed on an mbarrier. On a CPU tensor it runs the
plain version ``scale_copy_ref``. Run the probe on the card with

    python -m polars_ols_tpu_torch.ops.grid_probe

which prints ``ungridded: OK`` and ``gridded: OK`` when both forms equal
``x * 2`` exactly, and exits non-zero otherwise.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Optional

import torch

from . import kernels

# kernel launches made by scale_copy since the last reset
scale_copy_launches = 0

# the JAX probe's shapes: a [2048, 256] array, one [256, 256] tile ungridded,
# eight such tiles gridded
PROBE_ROWS, PROBE_COLS, PROBE_TILE_ROWS = 2048, 256, 256

_BOUND = None


def _kernel():
    global _BOUND
    if _BOUND is None:
        lib = kernels.load("grid_probe")
        i64 = ctypes.c_int64
        lib.pols_scale_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64, ctypes.c_void_p,
        ]
        lib.pols_scale_copy.restype = ctypes.c_int
        lib.pols_empty_launch.argtypes = [ctypes.c_void_p]
        lib.pols_empty_launch.restype = ctypes.c_int
        lib.pols_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pols_cuda_error_string.restype = ctypes.c_char_p
        _BOUND = lib
    return _BOUND


def scale_copy_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x * 2``."""
    return x * 2.0


def scale_copy(x: torch.Tensor, block_rows: Optional[int] = None) -> torch.Tensor:
    """``x * 2`` of a contiguous f32 [M, N] tensor, as the JAX probe's
    ``copy_kernel`` over one tile of all M rows (``block_rows`` None) or
    over tiles of ``block_rows`` rows, which must divide M. On the card each
    tile is cut into 8 KB chunks, one thread block per chunk."""
    global scale_copy_launches
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise TypeError(
            f"x must be a contiguous [M, N] float32 tensor, got {x.dtype} "
            f"{tuple(x.shape)} (contiguous={x.is_contiguous()})"
        )
    rows, cols = x.shape
    tile = rows if block_rows is None else int(block_rows)
    if tile < 1 or rows % tile != 0:
        raise ValueError(f"block_rows={block_rows} must divide the {rows} rows")
    if x.device.type == "cpu":
        return scale_copy_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {x.device}")
    out = torch.empty_like(x)
    lib = _kernel()
    args = (x.data_ptr(), out.data_ptr(), rows, cols, tile,
            torch.cuda.current_stream(x.device).cuda_stream)
    # the device guard costs host time on every call: enter it only when
    # the launch needs another device current
    if x.device.index == torch.cuda.current_device():
        rc = lib.pols_scale_copy(*args)
    else:
        with torch.cuda.device(x.device):
            rc = lib.pols_scale_copy(*args)
    if rc != 0:
        msg = lib.pols_cuda_error_string(rc).decode()
        raise RuntimeError(f"probe kernel launch failed: CUDA error {rc} ({msg})")
    scale_copy_launches += 1
    return out


def empty_launch(device: torch.device) -> None:
    """Launch an empty kernel on ``device``'s current stream: the floor of
    every kernel's time per launch (it computes nothing and is not counted
    among the probe's launches)."""
    if device.type != "cuda":
        raise ValueError(f"the empty kernel runs on a CUDA device, not {device}")
    lib = _kernel()
    rc = lib.pols_empty_launch(torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = lib.pols_cuda_error_string(rc).decode()
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc} ({msg})")


def run_probe(device: torch.device) -> None:
    """Both forms of the JAX probe on ``device``, each held to ``x * 2``
    exactly (doubling an f32 is exact); raises on a mismatch."""
    x = torch.arange(PROBE_ROWS * PROBE_COLS, dtype=torch.float32, device=device)
    x = x.reshape(PROBE_ROWS, PROBE_COLS)
    head = x[:PROBE_TILE_ROWS]
    if not torch.equal(scale_copy(head), head * 2.0):
        raise AssertionError("ungridded probe kernel differs from x * 2")
    print("ungridded: OK", flush=True)
    if not torch.equal(scale_copy(x, PROBE_TILE_ROWS), x * 2.0):
        raise AssertionError("gridded probe kernel differs from x * 2")
    print("gridded: OK", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("grid_probe: torch sees no CUDA device; nothing to run", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    run_probe(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
