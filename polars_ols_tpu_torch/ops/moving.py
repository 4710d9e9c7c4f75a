"""The moving models on the card: recursive least squares and rolling OLS
through the hand-written scan-and-solve kernel ``csrc/moving.cu``.

The JAX engine's fast path (``ops/moving.py:solve_recursive_lanes`` `:553`,
``solve_rolling_lanes`` `:601`) scans lane-major f32 inverse states with
refinement passes, shaped by its accelerator. Here the kernel keeps exact
f64 moments and solves each refresh row afresh by Cholesky. The kernel
has two forms, picked by K in its C entry. In the register form (K <= 8)
a warp owns a range of one group's rows and walks it in stretches of
32 x T rows (lane j owns rows [j T, (j + 1) T) of a stretch), each
bulk-copied into shared memory behind the previous one's arithmetic:

1. every lane forms its rows' summary from a zero start (the discounted
   or entering-minus-leaving moment sum and the total discount), a
   shuffle scan over the lanes composes them, and the carry of the
   earlier stretches gives every lane its exact start state;
2. the lanes walk their rows again from there, solve, and write the
   coefficients ``[G, R, K]`` or the predictions ``x_t . beta_t``
   ``[G, R]``; the last solved beta passes on to later lanes and
   stretches, so rows that only carry it are written in the same pass.

In the shared form (K > 8) a walker is a block of up to 4 warps (as
many as its shared memory holds, ``shared_layout(K, ...)[2]`` threads;
one warp past K = 100, with its states and factor in a device-memory
workspace of ``shared_layout(K, ...)[0]`` doubles) that takes a stretch
of one run of 32 x T rows a warp at a time. Each run but the last forms
its summary from a zero start, the summaries are composed in warp order
onto the walker's carry (each run's exact start state), and every warp
walks its run and solves each refresh row with its own LDL'
factorisation of the augmented system (the factor in registers up to
K = 48, in shared memory above) under warp barriers only; a run's rows
before its first solve take the last beta of an earlier run. The planner
counts its stretches of warps x 32 T rows (``plan_unit``). The moments,
the pivot test and the eigh fallback are the register form's, so a
query's results do not change formulation at any K.

A group of at most ``L`` rows (the planner's rows a range) is one range:
it reads Z once and needs nothing else. A longer group is cut into ranges
of ``L`` rows, and only those ranges pay a summary pass, a prefix over
their summaries (in segments of ``SEGMENT_RANGES`` ranges) and a fill of
a later range's leading rows that carry a beta solved before it.
``plan_ranges`` chooses ``L`` from the host-side row counts and the
walkers the card holds (warps, or the shared form's blocks), so that the
ranges make ``WAVES`` waves of resident walkers.

Sums run in a fixed order, so results repeat bit for bit. Rows whose
Cholesky meets a pivot that is not positive and finite are flagged; their
moments are recomputed by a second small kernel (from the start state the
walk kept for the stretch that holds them) and solved again with the eigh
minimum-norm solve (``ops/linalg.py:eigh_pinv_solve``), as the JAX
engine's ``solve_psd`` does. That costs one host sync a call to read the
flag count, and two more only where a row was flagged
(``moving_host_syncs`` counts them).

Both entry points take the padded layout ``Zp [G, R, 1+K]`` (target in
slot 0, zero-filled features), the valid rows ``vp [G, R]`` and each
group's row count ``rows [G]`` (and, to plan without reading them back,
the same counts on the host); rows from ``rows[g]`` on are never read or
written. On CUDA tensors they always launch the kernel (counted in
``moving_kernel_launches``; a failed build or launch raises); on CPU
tensors they run the plain versions ``ops/recursive.py`` /
``ops/rolling.py``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
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

# the largest K of the shared form (the register form takes K <= 8)
MAX_K = 8192
WANTS = ("coefficients", "predictions")
LANES = 32
# waves of resident walkers the planner's ranges fill: enough that groups of
# unequal length even out at the end of the grid; the shared form's walkers
# (blocks of warps, several runs at once) take half as many, so that
# groups of about equal length (500 +- 25 rows at "grouped_largek") are
# not cut into a range and a short rest that pays the summary pass, the
# prefix and the fill
WAVES = 4
SHARED_WAVES = 2
# ranges of a long group whose summaries one thread composes in turn
SEGMENT_RANGES = 32

_BOUND = None
_SM_COUNT = {}
_RESIDENT = {}
_LAYOUTS = {}
_MEANS = {}
_PLANS = {}
_PLAN_CACHE_SIZE = 16


def _kernel():
    global _BOUND
    if _BOUND is None:
        lib = kernels.load("moving")
        vp, i64, f64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
        lib.pols_moving.argtypes = [
            vp, vp, vp, vp, vp, i64, i64, i32, i32, i64, i32, f64, f64, vp,
            vp, i64, vp, i64, vp, i64,
            vp, vp, vp, vp, vp, i64, vp, vp, vp, vp, vp, vp, i64, vp, i32, vp,
        ]
        lib.pols_moving.restype = ctypes.c_int
        lib.pols_moving_moments_at.argtypes = [
            vp, vp, vp, i64, i64, i32, i32, f64, f64, vp, vp,
            vp, vp, vp, vp, i64, vp, vp, vp,
        ]
        lib.pols_moving_moments_at.restype = ctypes.c_int
        lib.pols_moving_resident_warps.argtypes = [i32, i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
        lib.pols_moving_resident_warps.restype = ctypes.c_int
        lib.pols_moving_shared_layout.argtypes = [
            i32, i32, i32, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.pols_moving_shared_layout.restype = ctypes.c_int
        lib.pols_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pols_cuda_error_string.restype = ctypes.c_char_p
        _BOUND = lib
    return _BOUND


def _sm_count(device) -> int:
    key = str(device)
    if key not in _SM_COUNT:
        _SM_COUNT[key] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SM_COUNT[key]


def _resident_warps(device, K: int, rolling: bool, T: int, coefs: bool) -> int:
    """Walkers of the walk the card holds at once (the occupancy of its
    shared memory and registers, times the SMs): warps in the register
    form, blocks of warps in the shared form (its persistent grid)."""
    key = (str(device), K, rolling, T, coefs)
    if key not in _RESIDENT:
        lib = _kernel()
        warps = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.pols_moving_resident_warps(K, int(rolling), T, int(coefs), ctypes.byref(warps))
        _raise_on(rc, lib, "occupancy")
        _RESIDENT[key] = max(1, warps.value) * _sm_count(device)
    return _RESIDENT[key]


def shared_layout(K: int, rolling: bool, T: int):
    """(workspace doubles a walker, rows a stage, threads a walker) of the
    kernel at K features and runs of 32 T rows, as its C entry lays them
    out (builds the kernel): in the shared form a walker of w warps stages
    w runs at once, or, with one warp, a run in pieces of fewer rows where
    the stage does not fit; (0, 32 T, 32) in the register form."""
    key = (K, bool(rolling), T)
    if key not in _LAYOUTS:
        doubles, rows, threads = ctypes.c_int64(0), ctypes.c_int(0), ctypes.c_int(0)
        rc = _kernel().pols_moving_shared_layout(
            K, int(rolling), T, ctypes.byref(doubles), ctypes.byref(rows), ctypes.byref(threads)
        )
        if rc != 0:
            raise ValueError(f"the moving kernel has no layout for K={K}, T={T}")
        _LAYOUTS[key] = (doubles.value, rows.value, threads.value)
    return _LAYOUTS[key]


def _mean_on(dev, mean0) -> torch.Tensor:
    """The prior mean as K doubles on the device, kept per (device, values)."""
    key = (str(dev), tuple(mean0))
    hit = _MEANS.get(key)
    if hit is None:
        if len(_MEANS) >= _PLAN_CACHE_SIZE:
            _MEANS.pop(next(iter(_MEANS)))
        hit = _MEANS[key] = torch.tensor(list(mean0), dtype=F64, device=dev)
    return hit


def stretch_rows(K: int, rolling: bool) -> int:
    """Rows a lane owns in a stretch (T): the fastest of chip_smoke.py's
    sweeps on the H100 (PERF.md section 6): 5 for the recursive model up
    to K = 8, 3 for rolling up to K = 5 (it also holds the stretch's
    leaving rows), 2 for rolling up to K = 8, 1 above K = 8 (the shared
    form, which walks a stretch's rows in order: 32 rows a stretch are
    enough to hide the next one's copy, and its stages stay small beside
    the state). An odd T puts the lanes' rows on distinct
    shared-memory banks where K + 1 is odd; where K + 1 is even two lanes
    share one at best."""
    if K > 8:
        return 1
    if rolling:
        return 3 if K <= 5 else 2
    return 5


def stretch_runs(n: int, warps: int, T: int):
    """The runs of a shared-form stretch of n rows (at most warps x 32 T)
    as its warps walk them: warp w takes rows [w 32 T, (w + 1) 32 T), the
    last run what is left; one warp takes all n rows (its stage may hold
    them in pieces). [(first row, rows)] of the warps that have rows."""
    if warps == 1:
        return [(0, n)]
    run = LANES * T
    return [(lo, min(run, n - lo)) for lo in range(0, n, run)]


def plan_unit(K: int, rolling: bool, T: int) -> int:
    """The ``T`` that ``plan_ranges`` takes for the kernel at K features
    and T rows a lane: T in the register form; in the shared form T times
    the warps of a walker, which takes a stretch of one run of 32 T rows a
    warp at once and keeps one start state a stretch for the flagged rows
    (``shared_layout``, so it builds the kernel)."""
    if K <= 8:
        return T
    return T * (shared_layout(K, rolling, T)[2] // LANES)


def plan_waves(K: int) -> int:
    """Waves of walkers the planner fills at K features: WAVES in the
    register form, SHARED_WAVES in the shared form."""
    return WAVES if K <= 8 else SHARED_WAVES


@dataclass(frozen=True)
class Plan:
    """How the kernel cuts the groups: ``L`` rows a range; the ``M``
    ranges of the groups longer than that (``ranges [M, 2]``: group, first
    row, a group's ranges contiguous and in row order); their segments for
    the prefix (``seg_first [NS + 1]`` into the ranges, ``grp_seg [NL + 1]``
    into the segments, one run per long group); each group's first range
    (``range_off [G]``, -1 for a group that is one range); and the
    stretches of the longest range (``nsmax``)."""

    T: int
    L: int
    ranges: np.ndarray
    seg_first: np.ndarray
    grp_seg: np.ndarray
    range_off: np.ndarray
    nsmax: int

    @property
    def M(self) -> int:
        return int(self.ranges.shape[0])


def plan_ranges(counts, T: int, resident_warps: int, chunk: Optional[int] = None, waves: int = WAVES) -> Plan:
    """The ranges of groups of ``counts`` rows (host int64 [G]) for
    stretches of ``LANES * T`` rows on a card that holds
    ``resident_warps`` walkers: ``chunk`` rows a range where given, else the
    rows that make ``waves`` waves of walkers out of all rows, a whole
    number of stretches and at least one. A group of at most that many rows
    is one range; a longer one is cut into ranges of that many rows."""
    counts = np.asarray(counts, dtype=np.int64)
    stretch = LANES * T
    if chunk is not None:
        L = int(chunk)
        if L < 1:
            raise ValueError(f"chunk must be positive, got {L}")
    else:
        want = -(-int(counts.sum()) // (waves * max(1, int(resident_warps))))
        L = max(stretch, -(-want // stretch) * stretch)
    long_g = np.flatnonzero(counts > L)
    n_ranges = -(-counts[long_g] // L)
    starts = np.concatenate([[0], np.cumsum(n_ranges)]).astype(np.int64)
    M = int(starts[-1])
    within = np.arange(M, dtype=np.int64) - np.repeat(starts[:-1], n_ranges)
    ranges = np.stack([np.repeat(long_g, n_ranges), within * L], axis=1).astype(np.int64)
    n_segs = -(-n_ranges // SEGMENT_RANGES)
    grp_seg = np.concatenate([[0], np.cumsum(n_segs)]).astype(np.int64)
    seg_in = np.arange(int(grp_seg[-1]), dtype=np.int64) - np.repeat(grp_seg[:-1], n_segs)
    seg_first = np.repeat(starts[:-1], n_segs) + seg_in * SEGMENT_RANGES
    seg_first = np.concatenate([seg_first, [M]]).astype(np.int64)
    range_off = np.full(len(counts), -1, dtype=np.int64)
    range_off[long_g] = starts[:-1]
    longest = min(L, int(counts.max())) if len(counts) else 0
    nsmax = max(1, -(-longest // stretch))
    return Plan(T, L, ranges, seg_first, grp_seg, range_off, nsmax)


def _plan_for(counts, T: int, resident: int, chunk, dev, waves: int = WAVES):
    """(plan, its tables on the device: ranges, seg_first, grp_seg,
    range_off, or None without long groups), made and uploaded once per
    (counts, T, card, chunk, waves) and kept: the entry holds ``counts``,
    its key uses the array's id."""
    key = (id(counts), T, resident, chunk, str(dev), waves)
    hit = _PLANS.get(key)
    if hit is not None and hit[0] is counts:
        return hit[1], hit[2]
    plan = plan_ranges(counts, T, resident, chunk, waves)
    tables = (None,) * 4
    if plan.M:
        flat = np.concatenate([plan.ranges.reshape(-1), plan.seg_first, plan.grp_seg, plan.range_off])
        buf = torch.as_tensor(flat, device=dev)
        cut = np.cumsum([plan.ranges.size, plan.seg_first.size, plan.grp_seg.size])
        tables = (buf[: cut[0]], buf[cut[0]: cut[1]], buf[cut[1]: cut[2]], buf[cut[2]:])
    if len(_PLANS) >= _PLAN_CACHE_SIZE:
        _PLANS.pop(next(iter(_PLANS)))
    _PLANS[key] = (counts, plan, tables)
    return plan, tables


def _check(Zp, vp, rows, want: str) -> None:
    if Zp.dtype != F64 or Zp.dim() != 3 or Zp.shape[2] < 2:
        raise TypeError(f"Zp must be a [G, R, 1+K] float64 tensor, got {Zp.dtype} {tuple(Zp.shape)}")
    G, R, C = Zp.shape
    if C - 1 > MAX_K and Zp.device.type != "cpu":
        raise ValueError(f"K={C - 1} features: the moving kernel takes K <= {MAX_K}")
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


def _launch_kernels(Zp, vp, rows, refresh, leaving, rolling, ff, reg0, mean0, want, chunk,
                    counts=None, stretch=None, phase=0):
    """Queue the kernel family on CUDA tensors, without synchronising:
    (out, flag [G, R] uint8, nflag [1] int32, state) where ``state`` is
    what ``pols_moving_moments_at`` needs again. ``refresh`` [G, R] bool;
    ``leaving`` [G, R] int32 or None (no row ever leaves: the recursive
    model); ``counts`` the host copy of ``rows`` (read back where not
    given: a host sync); ``stretch`` rows a lane (default
    ``stretch_rows``); ``phase`` 1 / 2 / 3 stops the shared form's walk
    after its update, its LDL' and its back substitution (the output is
    then not written: for timing the phases), 0 runs it all."""
    global moving_kernel_launches
    G, R, C = Zp.shape
    K = C - 1
    dev = Zp.device
    coefs = want == "coefficients"
    out = torch.empty((G, R, K) if coefs else (G, R), dtype=F64, device=dev)
    if counts is None:
        counts = rows.cpu().numpy()
    T = int(stretch) if stretch else stretch_rows(K, rolling)
    walkers = _resident_warps(dev, K, rolling, T, coefs)
    plan, tables = _plan_for(counts, plan_unit(K, rolling, T), walkers, chunk, dev, plan_waves(K))
    E = K * (K + 1) // 2 + K + 1
    M, NS, NL = plan.M, len(plan.seg_first) - 1, len(plan.grp_seg) - 1
    summ = seed = segtot = segseed = tail = has = None
    if M:
        summ = torch.empty((M, E), dtype=F64, device=dev)
        seed = torch.empty((M, E), dtype=F64, device=dev)
        if NS > NL:
            segtot = torch.empty((NS, E), dtype=F64, device=dev)
            segseed = torch.empty((NS, E), dtype=F64, device=dev)
        tail = torch.empty((M, K), dtype=F64, device=dev)
        has = torch.empty(M, dtype=torch.uint8, device=dev)
    sseed = torch.empty((G + M, plan.nsmax, E), dtype=F64, device=dev)
    flag = torch.zeros((G, R), dtype=torch.uint8, device=dev)
    nflag = torch.zeros(1, dtype=torch.int32, device=dev)
    per_walker = shared_layout(K, rolling, T)[0]  # the shared form's workspace, where it has one
    work = torch.empty(walkers * per_walker, dtype=F64, device=dev) if per_walker else None
    mean_dev = _mean_on(dev, mean0)
    lib = _kernel()
    leaving_ptr = None if leaving is None else leaving.data_ptr()
    model = (int(rolling), float(ff), float(reg0), mean_dev.data_ptr())

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = lib.pols_moving(
            Zp.data_ptr(), vp.data_ptr(), rows.data_ptr(), refresh.data_ptr(), leaving_ptr,
            G, R, K, T, plan.L, *model,
            ptr(tables[0]), M, ptr(tables[1]), NS, ptr(tables[2]), NL,
            ptr(summ), ptr(seed), ptr(segtot), ptr(segseed), sseed.data_ptr(), plan.nsmax,
            ptr(tail), ptr(has), out.data_ptr() if coefs else None, None if coefs else out.data_ptr(),
            flag.data_ptr(), nflag.data_ptr(), walkers, ptr(work), int(phase),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, lib, "scan and solve")
    moving_kernel_launches += 1
    return out, flag, nflag, (leaving_ptr, model, plan, tables[3], sseed, mean_dev)


def _resolve_flagged(out, flag, state, Zp, vp, rows, refresh, want):
    """The eigh minimum-norm solve of the rows whose Cholesky failed, and of
    the rows that carry their coefficients, written into ``out``. Two host
    syncs (the ``nonzero`` calls)."""
    G, R, C = Zp.shape
    K = C - 1
    dev = Zp.device
    leaving_ptr, model, plan, range_off, sseed, _ = state
    live = torch.arange(R, device=dev) < rows[:, None]
    flagged = flag.bool() & live
    fg, ft = torch.nonzero(flagged, as_tuple=True)  # host sync; row-major order
    F = int(fg.shape[0])
    # the walk's item (group, or G + its range) and the stretch of each row
    item, t0 = fg, torch.zeros_like(ft)
    if range_off is not None:
        off = range_off[fg]
        cut = off >= 0
        item = torch.where(cut, G + off + ft // plan.L, fg)
        t0 = torch.where(cut, ft // plan.L * plan.L, t0)
    stretch = LANES * plan.T
    st = (ft - t0) // stretch
    fa = (t0 + st * stretch).contiguous()
    fseed = (item * plan.nsmax + st).contiguous()
    A = torch.empty((F, K, K), dtype=F64, device=dev)
    rhs = torch.empty((F, K), dtype=F64, device=dev)
    lib = _kernel()
    with torch.cuda.device(dev):
        rc = lib.pols_moving_moments_at(
            Zp.data_ptr(), vp.data_ptr(), leaving_ptr, G, R, K, *model, sseed.data_ptr(),
            fg.data_ptr(), ft.data_ptr(), fa.data_ptr(), fseed.data_ptr(), F, A.data_ptr(),
            rhs.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
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


@dataclass(eq=False)
class Deferred:
    """A moving call whose flag count is not read yet (``defer=True``):
    ``out`` is final once ``finish`` has run with the count of ``nflag``
    ([1] int32 on the device; None where nothing can be flagged: the plain
    versions, an empty layout), which the caller reads with its other
    flags (engine/batch.py)."""

    out: torch.Tensor
    nflag: Optional[torch.Tensor] = None
    resolve: Optional[tuple] = None  # _resolve_flagged's arguments but ``out``

    def finish(self, n_flagged: int) -> torch.Tensor:
        """``out``, its flagged rows given the eigh solve where
        ``n_flagged`` (read from ``nflag``) is not 0: two host syncs."""
        global moving_host_syncs, moving_flagged_rows
        if n_flagged:
            moving_host_syncs += 2
            moving_flagged_rows += n_flagged
            _resolve_flagged(self.out, *self.resolve)
        return self.out


def _launch(Zp, vp, rows, refresh, leaving, rolling, ff, reg0, mean0, want, chunk, counts, defer=False):
    """The kernel family, then the eigh fallback where any row was flagged
    (one host sync to read the count, two more in the fallback); with
    ``defer`` the queued call as a ``Deferred``, the count not read."""
    global moving_host_syncs
    if Zp.shape[0] == 0 or Zp.shape[1] == 0:
        shape = Zp.shape[:2] + ((Zp.shape[2] - 1,) if want == "coefficients" else ())
        out = torch.empty(shape, dtype=F64, device=Zp.device)
        return Deferred(out) if defer else out
    out, flag, nflag, state = _launch_kernels(
        Zp, vp, rows, refresh, leaving, rolling, ff, reg0, mean0, want, chunk, counts
    )
    pending = Deferred(out, nflag, (flag, state, Zp, vp, rows, refresh, want))
    if defer:
        return pending
    moving_host_syncs += 1
    return pending.finish(int(nflag.item()))  # host sync: the one read every call makes


def recursive_least_squares(
    Zp: torch.Tensor,  # [G, R, 1+K]: target in slot 0, zero-filled features
    vp: torch.Tensor,  # [G, R] bool: valid rows update the state
    rows: torch.Tensor,  # [G] int64: rows of each group
    half_life: Optional[float],
    initial_state_covariance: Optional[float] = 10.0,
    initial_state_mean: Mean0 = None,
    want: str = "coefficients",
    chunk: Optional[int] = None,
    counts=None,
    defer: bool = False,
):
    """RLS coefficient paths [G, R, K] or their predictions [G, R]
    (``want``); the meaning of the arguments is
    ``ops/recursive.py:solve_recursive_least_squares``'s. ``chunk`` sets
    the rows a range (default: chosen from the sizes and the card);
    ``counts`` is ``rows`` on the host (numpy), where the caller has it.
    ``defer`` returns a ``Deferred`` whose flag count the caller reads."""
    _check(Zp, vp, rows, want)
    K = Zp.shape[2] - 1
    if Zp.device.type == "cpu":
        coefs = solve_recursive_least_squares(
            Zp[..., 1:], Zp[..., 0], vp, half_life, initial_state_covariance, initial_state_mean
        )
        out = _from_coefs(coefs, Zp, want)
        return Deferred(out) if defer else out
    if Zp.device.type != "cuda":
        raise ValueError(f"no moving kernel for device {Zp.device}")
    c = 10.0 if initial_state_covariance is None else float(initial_state_covariance)
    mean0 = prior_mean(initial_state_mean, K, "cpu").tolist()
    return _launch(
        Zp, vp, rows, vp, None, False, forgetting_factor(half_life), 1.0 / c, mean0, want, chunk, counts,
        defer,
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
    counts=None,
    defer: bool = False,
):
    """Rolling-OLS coefficient paths [G, R, K] (NaN before the first solved
    window) or their predictions [G, R]; the meaning of the arguments is
    ``ops/rolling.py:solve_rolling_ols``'s. ``indices`` takes a prepared
    ``rolling_indices`` result for these ``vp``, window and semantics;
    ``chunk``, ``counts`` and ``defer`` are ``recursive_least_squares``'s."""
    _check(Zp, vp, rows, want)
    K = Zp.shape[2] - 1
    if Zp.device.type == "cpu":
        coefs = solve_rolling_ols(
            Zp[..., 1:], Zp[..., 0], vp, window, min_periods, alpha, positional
        )
        out = _from_coefs(coefs, Zp, want)
        return Deferred(out) if defer else out
    if Zp.device.type != "cuda":
        raise ValueError(f"no moving kernel for device {Zp.device}")
    if indices is None:
        mp = default_min_periods(min_periods, K, int(window))
        indices = rolling_indices(vp, int(window), mp, positional)
    leaving, refresh = indices
    return _launch(
        Zp, vp, rows, refresh.contiguous(), leaving.contiguous(), True, 1.0, float(alpha),
        [0.0] * K, want, chunk, counts, defer,
    )
