"""The moving models on the card: recursive least squares and rolling OLS
through the hand-written scan-and-solve kernel ``csrc/moving.cu``.

The JAX engine's fast path (``ops/moving.py:solve_recursive_lanes`` `:553`,
``solve_rolling_lanes`` `:601`) scans lane-major f32 inverse states with
refinement passes, shaped by its accelerator. Here one kernel family keeps
the exact f64 moments of every (group, row chunk) in one thread's
registers and solves each row afresh by Cholesky; a warp stages the rows
of its 32 chunks through shared memory, a few rows of each at a time, so
that its loads and stores stay contiguous:

1. a summary per chunk (its discounted or entering-minus-leaving moment
   sum and its total discount),
2. a prefix over each group's chunk summaries, which gives every chunk its
   exact start state (a long group's chunks in segments: composed,
   scanned over the segments, expanded),
3. all (group, chunk) pairs walk their rows at once from those states,
   solve, and write the coefficients ``[G, R, K]`` or the predictions
   ``x_t . beta_t`` ``[G, R]``,
4. the first rows of a chunk that only carry coefficients take them from
   the nearest earlier chunk that solved any.

Sums run in a fixed order, so results repeat bit for bit. Rows whose
Cholesky meets a pivot that is not positive and finite are flagged; their
moments are recomputed by a second small kernel and solved again with the
eigh minimum-norm solve (``ops/linalg.py:eigh_pinv_solve``), as the JAX
engine's ``solve_psd`` does. That costs one host sync a call to read the
flag count, and two more only where a row was flagged
(``moving_host_syncs`` counts them).

Both entry points take the padded layout ``Zp [G, R, 1+K]`` (target in
slot 0, zero-filled features), the valid rows ``vp [G, R]`` and each
group's row count ``rows [G]``; rows from ``rows[g]`` on are never read or
written. On CUDA tensors they always launch the kernel (counted in
``moving_kernel_launches``; a failed build or launch raises); on CPU
tensors they run the plain versions ``ops/recursive.py`` /
``ops/rolling.py``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..config import F64
from . import kernels
from .linalg import eigh_pinv_solve
from .recursive import Mean0, forgetting_factor, prior_mean, solve_recursive_least_squares
from .rolling import default_min_periods, last_refresh, rolling_indices, solve_rolling_ols

# calls that launched the kernel family since the last reset
moving_kernel_launches = 0
# host syncs those calls made: one each for the flag count, two more where
# rows were flagged
moving_host_syncs = 0
# rows re-solved by the eigh fallback since the last reset
moving_flagged_rows = 0

# largest K of the per-thread Cholesky
MAX_K = 32
WANTS = ("coefficients", "predictions")
MIN_CHUNK_ROWS = 32
# walkers (one thread each) the chunk length aims at per SM: several times
# the ~512 threads an SM holds at the walk's register budget, because
# shorter chunks ran no slower on the H100 and the rolling walk faster
# (chip_smoke.py's chunk sweep at the main frame; PERF.md section 6)
_WALKERS_PER_SM = 4096
# chunks a group up to which one thread per state entry runs the whole prefix
_ONE_SEGMENT_CHUNKS = 64

_BOUND = None
_SM_COUNT = {}


def _kernel():
    global _BOUND
    if _BOUND is None:
        lib = kernels.load("moving")
        vp, i64, f64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
        lib.pols_moving.argtypes = [
            vp, vp, vp, vp, vp, i64, i64, i32, i64, i64, i32, f64, f64, vp, i64,
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
        ]
        lib.pols_moving.restype = ctypes.c_int
        lib.pols_moving_moments_at.argtypes = [
            vp, vp, vp, i64, i64, i32, i64, i64, i32, f64, f64, vp,
            vp, vp, vp, i64, vp, vp, vp,
        ]
        lib.pols_moving_moments_at.restype = ctypes.c_int
        lib.pols_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pols_cuda_error_string.restype = ctypes.c_char_p
        _BOUND = lib
    return _BOUND


def _sm_count(device) -> int:
    key = str(device)
    if key not in _SM_COUNT:
        _SM_COUNT[key] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SM_COUNT[key]


def chunk_rows(n_rows: int, sm_count: int) -> int:
    """Rows a chunk: the power of two that fills the card (``n_rows`` over
    the walkers it holds), at least ``MIN_CHUNK_ROWS``; one group of
    millions of rows is cut as finely as thousands of short ones."""
    want = max(MIN_CHUNK_ROWS, n_rows / float(sm_count * _WALKERS_PER_SM))
    return 1 << math.ceil(math.log2(want))


def prefix_segments(n_chunks: int) -> int:
    """Segments the prefix over a group's chunks runs in: one up to
    ``_ONE_SEGMENT_CHUNKS`` chunks, else the power of two near their square
    root, which balances the passes within the segments against the pass
    over them."""
    if n_chunks <= _ONE_SEGMENT_CHUNKS:
        return 1
    return 1 << round(math.log2(math.sqrt(n_chunks)))


def _check(Zp, vp, rows, want: str) -> None:
    if Zp.dtype != F64 or Zp.dim() != 3 or Zp.shape[2] < 2:
        raise TypeError(f"Zp must be a [G, R, 1+K] float64 tensor, got {Zp.dtype} {tuple(Zp.shape)}")
    G, R, C = Zp.shape
    if C - 1 > MAX_K:
        raise NotImplementedError(
            f"K={C - 1} features: the port's moving models cover K <= {MAX_K} "
            "(larger K is ROADMAP.md Queue 1 item 12)"
        )
    if vp.dtype != torch.bool or tuple(vp.shape) != (G, R):
        raise TypeError(f"vp must be a [{G}, {R}] bool tensor, got {vp.dtype} {tuple(vp.shape)}")
    if rows.dtype != torch.int64 or tuple(rows.shape) != (G,):
        raise TypeError(f"rows must be a [{G}] int64 tensor, got {rows.dtype} {tuple(rows.shape)}")
    if not (Zp.device == vp.device == rows.device):
        raise ValueError("Zp, vp and rows must be on one device")
    if not (Zp.is_contiguous() and vp.is_contiguous() and rows.is_contiguous()):
        raise ValueError("Zp, vp and rows must be contiguous")
    if R >= 2**31:
        raise ValueError(f"R={R} rows a group: the leaving-row index is int32")
    if want not in WANTS:
        raise ValueError(f"want must be one of {WANTS}, got {want!r}")


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        msg = lib.pols_cuda_error_string(rc).decode()
        raise RuntimeError(f"moving kernel ({what}) launch failed: CUDA error {rc} ({msg})")


def _from_coefs(coefs, Zp, want: str):
    if want == "coefficients":
        return coefs
    return (Zp[..., 1:] * coefs).sum(dim=-1)


def _launch_kernels(Zp, vp, rows, refresh, leaving, rolling, ff, reg0, mean0, want, chunk):
    """Queue the kernel family on CUDA tensors, without synchronising:
    (out, flag [G, R] uint8, nflag [1] int32, state) where ``state`` is
    what ``pols_moving_moments_at`` needs again. ``refresh`` [G, R] bool;
    ``leaving`` [G, R] int32 or None (no row ever leaves: the recursive
    model)."""
    global moving_kernel_launches
    G, R, C = Zp.shape
    K = C - 1
    dev = Zp.device
    shape = (G, R, K) if want == "coefficients" else (G, R)
    out = torch.empty(shape, dtype=F64, device=dev)
    L = int(chunk) if chunk else chunk_rows(int(G * R), _sm_count(dev))
    if L < 1:
        raise ValueError(f"chunk must be positive, got {L}")
    NC = -(-R // L)
    S = prefix_segments(NC)
    E = K * (K + 1) // 2 + K + 1
    summ = torch.empty((G, NC, E), dtype=F64, device=dev)
    seed = torch.empty((G, NC, E), dtype=F64, device=dev)
    comp = segseed = None
    if S > 1:
        comp = torch.empty((G, S, E), dtype=F64, device=dev)
        segseed = torch.empty((G, S, E), dtype=F64, device=dev)
    tail = torch.empty((G, NC, K), dtype=F64, device=dev)
    has = torch.empty((G, NC), dtype=torch.uint8, device=dev)
    flag = torch.zeros((G, R), dtype=torch.uint8, device=dev)
    nflag = torch.zeros(1, dtype=torch.int32, device=dev)
    mean_host = (ctypes.c_double * MAX_K)(*mean0, *([0.0] * (MAX_K - len(mean0))))
    lib = _kernel()
    leaving_ptr = None if leaving is None else leaving.data_ptr()
    model = (int(rolling), float(ff), float(reg0), mean_host)
    with torch.cuda.device(dev):
        rc = lib.pols_moving(
            Zp.data_ptr(), vp.data_ptr(), rows.data_ptr(), refresh.data_ptr(), leaving_ptr,
            G, R, K, L, NC, *model, S,
            summ.data_ptr(), seed.data_ptr(),
            None if comp is None else comp.data_ptr(),
            None if segseed is None else segseed.data_ptr(),
            tail.data_ptr(), has.data_ptr(),
            out.data_ptr() if want == "coefficients" else None,
            out.data_ptr() if want == "predictions" else None,
            flag.data_ptr(), nflag.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, lib, "scan and solve")
    moving_kernel_launches += 1
    return out, flag, nflag, (leaving_ptr, L, NC, model, seed)


def _resolve_flagged(out, flag, state, Zp, vp, rows, refresh, want):
    """The eigh minimum-norm solve of the rows whose Cholesky failed, and of
    the rows that carry their coefficients, written into ``out``. Two host
    syncs (the ``nonzero`` calls)."""
    G, R, C = Zp.shape
    K = C - 1
    dev = Zp.device
    leaving_ptr, L, NC, model, seed = state
    live = torch.arange(R, device=dev) < rows[:, None]
    flagged = flag.bool() & live
    fg, ft = torch.nonzero(flagged, as_tuple=True)  # host sync; row-major order
    F = int(fg.shape[0])
    A = torch.empty((F, K, K), dtype=F64, device=dev)
    rhs = torch.empty((F, K), dtype=F64, device=dev)
    lib = _kernel()
    with torch.cuda.device(dev):
        rc = lib.pols_moving_moments_at(
            Zp.data_ptr(), vp.data_ptr(), leaving_ptr, G, R, K, L, NC, *model, seed.data_ptr(),
            fg.data_ptr(), ft.data_ptr(), F, A.data_ptr(), rhs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, lib, "moments of the flagged rows")
    beta = eigh_pinv_solve(A, rhs)
    last = last_refresh(refresh)
    carries = (last >= 0) & flagged.gather(1, last.clamp_min(0)) & live
    cg, ct = torch.nonzero(carries, as_tuple=True)  # host sync
    slot = torch.searchsorted(fg * R + ft, cg * R + last[cg, ct])
    if want == "coefficients":
        out[cg, ct] = beta[slot]
    else:
        out[cg, ct] = (Zp[cg, ct, 1:] * beta[slot]).sum(dim=-1)


def _launch(Zp, vp, rows, refresh, leaving, rolling, ff, reg0, mean0, want, chunk):
    """The kernel family, then the eigh fallback where any row was flagged
    (one host sync to read the count, two more in the fallback)."""
    global moving_host_syncs, moving_flagged_rows
    if Zp.shape[0] == 0 or Zp.shape[1] == 0:
        shape = Zp.shape[:2] + ((Zp.shape[2] - 1,) if want == "coefficients" else ())
        return torch.empty(shape, dtype=F64, device=Zp.device)
    out, flag, nflag, state = _launch_kernels(
        Zp, vp, rows, refresh, leaving, rolling, ff, reg0, mean0, want, chunk
    )
    moving_host_syncs += 1
    n_flagged = int(nflag.item())  # host sync: the one read every call makes
    if n_flagged:
        moving_host_syncs += 2
        moving_flagged_rows += n_flagged
        _resolve_flagged(out, flag, state, Zp, vp, rows, refresh, want)
    return out


def recursive_least_squares(
    Zp: torch.Tensor,  # [G, R, 1+K]: target in slot 0, zero-filled features
    vp: torch.Tensor,  # [G, R] bool: valid rows update the state
    rows: torch.Tensor,  # [G] int64: rows of each group
    half_life: Optional[float],
    initial_state_covariance: Optional[float] = 10.0,
    initial_state_mean: Mean0 = None,
    want: str = "coefficients",
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """RLS coefficient paths [G, R, K] or their predictions [G, R]
    (``want``); the meaning of the arguments is
    ``ops/recursive.py:solve_recursive_least_squares``'s. ``chunk`` sets
    the rows a chunk (default: chosen from the sizes and the card)."""
    _check(Zp, vp, rows, want)
    K = Zp.shape[2] - 1
    if Zp.device.type == "cpu":
        coefs = solve_recursive_least_squares(
            Zp[..., 1:], Zp[..., 0], vp, half_life, initial_state_covariance, initial_state_mean
        )
        return _from_coefs(coefs, Zp, want)
    if Zp.device.type != "cuda":
        raise ValueError(f"no moving kernel for device {Zp.device}")
    c = 10.0 if initial_state_covariance is None else float(initial_state_covariance)
    mean0 = prior_mean(initial_state_mean, K, "cpu").tolist()
    return _launch(
        Zp, vp, rows, vp, None, False, forgetting_factor(half_life), 1.0 / c, mean0, want, chunk
    )


def rolling_ols(
    Zp: torch.Tensor,  # [G, R, 1+K]
    vp: torch.Tensor,  # [G, R] bool
    rows: torch.Tensor,  # [G] int64
    window: int,
    min_periods: Optional[int] = None,
    alpha: float = 0.0,
    positional: bool = True,
    want: str = "coefficients",
    chunk: Optional[int] = None,
    indices=None,
) -> torch.Tensor:
    """Rolling-OLS coefficient paths [G, R, K] (NaN before the first solved
    window) or their predictions [G, R]; the meaning of the arguments is
    ``ops/rolling.py:solve_rolling_ols``'s. ``indices`` takes a prepared
    ``rolling_indices`` result for these ``vp``, window and semantics."""
    _check(Zp, vp, rows, want)
    K = Zp.shape[2] - 1
    if Zp.device.type == "cpu":
        coefs = solve_rolling_ols(
            Zp[..., 1:], Zp[..., 0], vp, window, min_periods, alpha, positional
        )
        return _from_coefs(coefs, Zp, want)
    if Zp.device.type != "cuda":
        raise ValueError(f"no moving kernel for device {Zp.device}")
    if indices is None:
        mp = default_min_periods(min_periods, K, int(window))
        indices = rolling_indices(vp, int(window), mp, positional)
    leaving, refresh = indices
    return _launch(
        Zp, vp, rows, refresh.contiguous(), leaving.contiguous(), True, 1.0, float(alpha),
        [0.0] * K, want, chunk,
    )
