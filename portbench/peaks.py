"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W):
device memory bandwidth, f64 on the tensor cores (DMMA: products of
matrices) and f64 outside them. A card set below 700 W runs slower; the
run prints its power limit beside these shares."""

from __future__ import annotations

BYTES_PER_S = 3.35e12
F64_TENSOR_PER_S = 67e12
F64_PER_S = 34e12


def bound_s(moved_bytes: float, ops: float, ops_per_s: float) -> float:
    """The least time: the larger of the bytes over the memory rate and the
    operations over their peak rate."""
    return max(moved_bytes / BYTES_PER_S, ops / ops_per_s)
