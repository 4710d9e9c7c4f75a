"""Grouped f64 moments of the split-padded block layout.

``grouped_moments_blocks`` returns, for every group, ``M = Z^T diag(w) Z``
over its row blocks (``Z = [y | X]``, target in column 0) and its count of
valid rows: the per-group output of the JAX engine's Pallas digit-moment
kernel (``ops/pallas_moments.py:moments_from_digits_pallas``) and of its
f64 einsum form (``ops/direct.py:grouped_moments``).

On a CUDA tensor it always launches the hand-written kernel
``csrc/moments.cu`` and counts the launch in ``moments_kernel_launches``;
a failed build or launch raises. The kernel keeps each lane's sums in
registers up to ``MAX_REGISTER_COLS`` columns (K = 32) and takes its wide
form above, on the FP64 tensor cores (8 x 8 tiles of m8n8k4 steps): up to
``MAX_STAGED_COLS`` a CTA covers a block's whole triangle of tiles from
rows staged once in shared memory, and where the blocks are too few to
fill the card it takes a piece of a block's rows (``piece_rows``: each
piece writes its own partial, and the group sum adds a group's blocks and
their pieces in order, ``partial_order``); above it a warp reads its tiles'
columns from device memory, up to ``MAX_COLS``. On a CPU tensor it runs
the plain torch version ``grouped_moments_blocks_ref`` (used by the CPU
tests); nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..config import F64
from . import kernels

# kernel launches made by grouped_moments_blocks since the last reset
moments_kernel_launches = 0

# C = 1 + K columns: the register forms up to 33, the wide form above, whose
# C(C + 1) / 2 + 1 entries a block are indexed by 32-bit ints
MAX_REGISTER_COLS = 33
MAX_COLS = 65_534
# the wide form's staged path (one CTA a block's triangle of tiles) up to
# this C; rows reach it in chunks of STAGE_ROWS
MAX_STAGED_COLS = 128
STAGE_ROWS = 16

_BOUND = None
_SM_COUNT = {}


def piece_rows(S: int, R: int, C: int, sms: int) -> int:
    """Rows of a block one CTA of the kernel takes: R (the whole block)
    unless C takes the wide form's staged path and the S blocks are fewer
    than half the ``sms`` SMs; then the block is cut into about sms // S
    pieces, a multiple of STAGE_ROWS rows each (the last the rest), so that
    the CTAs fill the card."""
    per = sms // S if S > 0 else 0
    if not MAX_REGISTER_COLS < C <= MAX_STAGED_COLS or per < 2:
        return R
    rows = -(-R // per)
    rows = -(-rows // STAGE_ROWS) * STAGE_ROWS
    return min(rows, R) if rows < R else R


def pieces(R: int, rows: int) -> int:
    """Pieces of a block of R rows cut into ``rows`` rows each."""
    return -(-R // rows)


def partial_order(block_offsets, n_pieces: int):
    """For each group, the rows of the kernel's partials [S * n_pieces,
    slots] that the group sum adds, in its order: the group's blocks in
    block order, each block's pieces in row order (plain Python, host
    offsets)."""
    offs = [int(o) for o in block_offsets]
    return [list(range(a * n_pieces, b * n_pieces)) for a, b in zip(offs[:-1], offs[1:])]


def grouped_moments_pieces_ref(
    Zp: torch.Tensor, wp: torch.Tensor, block_offsets: torch.Tensor, num_groups: int, rows: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's summation structure in plain torch: each block cut in
    pieces of ``rows`` rows, a partial a piece, each group's partials added
    one by one in ``partial_order``."""
    S, R, C = Zp.shape
    n = pieces(R, rows)
    Zm = torch.where(wp[..., None], Zp, torch.zeros((), dtype=F64, device=Zp.device))
    parts, cparts = [], []
    for s in range(S):
        for p in range(n):
            z = Zm[s, p * rows:(p + 1) * rows]
            parts.append(z.mT @ z)
            cparts.append(wp[s, p * rows:(p + 1) * rows].sum(dtype=F64))
    M = torch.zeros((num_groups, C, C), dtype=F64, device=Zp.device)
    counts = torch.zeros((num_groups,), dtype=F64, device=Zp.device)
    for g, order in enumerate(partial_order(block_offsets.tolist(), n)):
        for q in order:
            M[g] += parts[q]
            counts[g] += cparts[q]
    return M, counts


def _kernel():
    global _BOUND
    if _BOUND is None:
        lib = kernels.load("moments")
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.pols_grouped_moments.argtypes = [
            vp, vp, vp, i64, i64, i64, i64, i64, vp, vp, vp, vp,
        ]
        lib.pols_grouped_moments.restype = ctypes.c_int
        lib.pols_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pols_cuda_error_string.restype = ctypes.c_char_p
        _BOUND = lib
    return _BOUND


def _sm_count(device) -> int:
    key = str(device)
    if key not in _SM_COUNT:
        _SM_COUNT[key] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SM_COUNT[key]


def _check(Zp, wp, block_offsets, num_groups: int) -> None:
    if Zp.dtype != F64 or Zp.dim() != 3:
        raise TypeError(f"Zp must be a [S, R, C] float64 tensor, got {Zp.dtype} {tuple(Zp.shape)}")
    S, R, C = Zp.shape
    if not 1 <= C <= MAX_COLS or R < 1:
        raise ValueError(f"Zp has C={C}, R={R}; the moment kernel takes 1 <= C <= {MAX_COLS}, R >= 1")
    if wp.dtype != torch.bool or tuple(wp.shape) != (S, R):
        raise TypeError(f"wp must be a [{S}, {R}] bool tensor, got {wp.dtype} {tuple(wp.shape)}")
    if block_offsets.dtype != torch.int64 or tuple(block_offsets.shape) != (num_groups + 1,):
        raise TypeError(
            f"block_offsets must be a [{num_groups + 1}] int64 tensor, "
            f"got {block_offsets.dtype} {tuple(block_offsets.shape)}"
        )
    if not (Zp.device == wp.device == block_offsets.device):
        raise ValueError("Zp, wp and block_offsets must be on one device")
    if not (Zp.is_contiguous() and wp.is_contiguous() and block_offsets.is_contiguous()):
        raise ValueError("Zp, wp and block_offsets must be contiguous")


def grouped_moments_blocks_ref(
    Zp: torch.Tensor, wp: torch.Tensor, block_offsets: torch.Tensor, num_groups: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: batched einsum of each block's masked rows, then
    a segment sum over each group's contiguous blocks."""
    Zm = torch.where(wp[..., None], Zp, torch.zeros((), dtype=F64, device=Zp.device))
    Mb = torch.einsum("src,srd->scd", Zm, Zm)
    cb = wp.sum(dim=1, dtype=F64)
    M = torch.segment_reduce(Mb, "sum", offsets=block_offsets, axis=0)
    counts = torch.segment_reduce(cb, "sum", offsets=block_offsets, axis=0)
    return M, counts


def grouped_moments_blocks(
    Zp: torch.Tensor, wp: torch.Tensor, block_offsets: torch.Tensor, num_groups: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group moments (M [G, C, C] f64, counts [G] f64) of the blocks
    Zp [S, R, C] f64 under the row mask wp [S, R] bool; group g owns blocks
    ``block_offsets[g] .. block_offsets[g+1]-1``."""
    global moments_kernel_launches
    _check(Zp, wp, block_offsets, num_groups)
    if Zp.device.type == "cpu":
        return grouped_moments_blocks_ref(Zp, wp, block_offsets, num_groups)
    if Zp.device.type != "cuda":
        raise ValueError(f"no moment kernel for device {Zp.device}")
    S, R, C = Zp.shape
    slots = C * (C + 1) // 2 + 1
    rows = piece_rows(S, R, C, _sm_count(Zp.device))
    partial = torch.empty((S * pieces(R, rows), slots), dtype=F64, device=Zp.device)
    M = torch.empty((num_groups, C, C), dtype=F64, device=Zp.device)
    counts = torch.empty((num_groups,), dtype=F64, device=Zp.device)
    lib = _kernel()
    with torch.cuda.device(Zp.device):
        rc = lib.pols_grouped_moments(
            Zp.data_ptr(), wp.data_ptr(), block_offsets.data_ptr(),
            S, R, C, num_groups, rows,
            partial.data_ptr(), M.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(Zp.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.pols_cuda_error_string(rc).decode()
        raise RuntimeError(f"moment kernel launch failed: CUDA error {rc} ({msg})")
    moments_kernel_launches += 1
    return M, counts
