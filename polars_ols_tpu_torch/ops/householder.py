"""Householder reduction of masked row blocks, and the tree that reduces a
group's blocks to one factor (TSQR).

``householder_blocks`` takes blocks ``Z [B, R, C]`` (the M target columns
first, then the K feature columns: the port's ``[y | X]``) and their row
mask ``w [B, R]``, and returns ``T [B, K, C]``: the first K rows after K
Householder reflections of the feature columns, i.e. the triangular factor
R of the features (``T[..., M:]``) beside ``Q^T Y`` (``T[..., :M]``). It is
the reduction under the JAX engine's shared SVD
(``polars_ols_tpu/ops/linalg.py:_householder_reduce`` :382,
``householder_lanes`` :435; XLA, no Pallas kernel), which every
multi-target fit and every explicit 'svd' solve runs.

On a CUDA tensor it always launches the hand-written kernel
``csrc/householder.cu`` and counts the launch in
``householder_kernel_launches``; a failed build or launch raises. On a CPU
tensor it runs the plain version ``householder_blocks_ref``; nothing falls
back from one to the other. Both select the masked rows away (a padding
slot gathers row 0, whose NaN must not reach another group), and both use
the reflections of ``ops/linalg.py:_householder_reduce``, so they agree
entry for entry.

The kernel has two forms, which its C entry picks by the block's shape
(``kernel_form`` reads the choice back): up to ``MAX_COLS`` columns a
thread holds its rows of the panel in registers (blocks of at most
``MAX_ROWS`` rows); above, the wide form (more than 32 features, or
targets beside the features past 33 columns) reduces a block of any
number of rows by blocked (compact WY) reflections, panels of eight
columns whose trailing updates are FP64 tensor-core products; its panel
lives in one CTA's shared memory where it fits, else in the shared memory
of a cluster of 2, 4 or 8 CTAs (``cluster_ctas``), else in a device-memory
workspace that ``_launch`` allocates. ``householder_blocks_wy`` is the
plain torch form of that blocked arithmetic. ``reduce_groups`` cuts
register form blocks longer than ``MAX_ROWS`` into pieces first.

A group whose rows span several blocks is reduced as a tree:
``plan_reduction`` (host-side, from the blocks per group and their rows)
stacks each group's ``[n, K, C]`` partial factors, as many to a block as
fit ``max(MAX_ROWS, 2 K)`` rows (at least two; a factor of a block of
fewer rows than K stacks only those rows, the rest are zero), and
``reduce_groups`` reduces the stacks with the same kernel until one factor
is left per group. Stacked factors are genuine rows, so the last factor is
the reduction of all of the group's rows (up to the signs of its rows,
which the SVD that consumes it does not see).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import F64
from . import kernels
from .linalg import _householder_reduce

# kernel launches made by householder_blocks since the last reset
householder_kernel_launches = 0

# C = M + K columns of the register form; wider blocks take the wide form
MAX_COLS = 33
# rows a block holds: the register form's limit (a thread block of at most
# 512 threads holds the panel in registers) and the split layout's default
# cap; the wide form takes any number
MAX_ROWS = 512
# reflections a panel of the wide form's blocked (compact WY) arithmetic
WY_PANEL = 8
# the kernel's forms, as pols_householder_form numbers them
FORMS = ("register", "wide (panel in shared memory)", "wide (panel in device memory)",
         "wide (panel in a cluster's shared memory)")

_BOUND = None


def _kernel():
    global _BOUND
    if _BOUND is None:
        lib = kernels.load("householder")
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.pols_householder_blocks.argtypes = [vp, vp, i64, i64, i64, i64, i64, vp, vp, vp]
        lib.pols_householder_blocks.restype = ctypes.c_int
        lib.pols_householder_form.argtypes = [i64, i64]
        lib.pols_householder_form.restype = ctypes.c_int
        lib.pols_householder_ctas.argtypes = [i64, i64]
        lib.pols_householder_ctas.restype = ctypes.c_int
        lib.pols_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pols_cuda_error_string.restype = ctypes.c_char_p
        _BOUND = lib
    return _BOUND


def kernel_form(R: int, C: int) -> str:
    """The form the kernel launches for blocks of R rows and C columns, as
    its C entry picks it (builds the kernel)."""
    form = _kernel().pols_householder_form(R, C)
    if form < 0:
        raise ValueError(f"the Householder kernel has no form for blocks of R={R}, C={C}")
    return FORMS[form]


def cluster_ctas(R: int, C: int) -> int:
    """CTAs the wide form gives a block of R rows and C columns (builds the
    kernel): 1, or the 2, 4 or 8 of a cluster whose CTAs' shared memory
    holds the panel (0: the register form)."""
    return _kernel().pols_householder_ctas(R, C)


def _check(Z, w, K: int) -> None:
    if Z.dtype != F64 or Z.dim() != 3:
        raise TypeError(f"Z must be a [B, R, C] float64 tensor, got {Z.dtype} {tuple(Z.shape)}")
    B, R, C = Z.shape
    if C < 2 or not 1 <= K < C or R < 1:
        raise ValueError(f"Z has C={C}, R={R} with K={K}; the reduction takes 1 <= K < C, R >= 1")
    if C <= MAX_COLS and R > MAX_ROWS:
        raise ValueError(f"a block of R={R} rows and C={C} columns: the kernel takes at most {MAX_ROWS} rows")
    if w.dtype != torch.bool or tuple(w.shape) != (B, R):
        raise TypeError(f"w must be a [{B}, {R}] bool tensor, got {w.dtype} {tuple(w.shape)}")
    if Z.device != w.device:
        raise ValueError("Z and w must be on one device")
    if not (Z.is_contiguous() and w.is_contiguous()):
        raise ValueError("Z and w must be contiguous")


def householder_blocks_ref(Z: torch.Tensor, w: torch.Tensor, K: int) -> torch.Tensor:
    """Plain version: ``_householder_reduce`` over the batch of selected
    blocks (a block of fewer than K rows padded with zero rows first)."""
    _check(Z, w, K)
    B, R, C = Z.shape
    Zs = torch.where(w[..., None], Z, torch.zeros((), dtype=F64, device=Z.device))
    if R < K:
        Zs = torch.cat([Zs, Zs.new_zeros((B, K - R, C))], dim=1)
    M = C - K
    Rf, QtY = _householder_reduce(Zs[..., M:], Zs[..., :M])
    return torch.cat([QtY, Rf], dim=-1)


def householder_blocks_wy(Z: torch.Tensor, w: torch.Tensor, K: int, reflections: Optional[int] = None,
                          nb: int = WY_PANEL) -> torch.Tensor:
    """The wide form's blocked arithmetic in torch ops (the kernel's own
    plain form; ``householder_blocks_ref`` stays the contract's plain
    version). Panels of ``nb`` feature columns: each panel's reflections
    are ``_householder_reduce``'s, over the panel's columns only, with
    ``v^T a_c = g_c - alpha a_jc`` from ``g_c = sum_{r >= j} a_rj a_rc``
    (for the panel's earlier columns that is ``v_c^T v_j``); the pivot
    column keeps v below the diagonal and alpha on it; then the targets and
    the later features take the panel at once, ``A -= V (T^T (V^T A))``,
    with T the upper triangle of the compact WY form (LAPACK's dlarft,
    forward, columnwise). The first ``reflections`` (default K) only;
    reflected columns are zero below the diagonal, rows below a block's
    last are zero."""
    _check(Z, w, K)
    B, R, C = Z.shape
    M = C - K
    A = torch.where(w[..., None], Z, torch.zeros((), dtype=F64, device=Z.device)).clone()
    steps = min(K, R, K if reflections is None else int(reflections))
    rows = torch.arange(R, device=Z.device)
    for j0 in range(0, steps, nb):
        pw, nbp, pc = min(nb, K - j0), min(nb, steps - j0), M + j0
        P = A[..., pc:pc + pw].clone()
        beta, vdiag = A.new_zeros((nb, B)), A.new_zeros((nb, B))
        wvv = A.new_zeros((B, nb, nb))
        for ii in range(nbp):
            j = j0 + ii
            act = rows >= j
            g = (torch.where(act[None, :, None], P[..., ii:ii + 1] * P, 0.0)).sum(dim=1)  # [B, pw]
            rj = P[:, j, :]
            sigma, piv = g[:, ii], rj[:, ii]
            alpha = -torch.where(piv >= 0, 1.0, -1.0).to(F64) * torch.sqrt(sigma)
            denom = sigma - piv * alpha
            beta[ii] = torch.where(denom > 0, 1.0 / torch.where(denom > 0, denom, 1.0), 0.0)
            vdiag[ii] = piv - alpha
            d = g - alpha[:, None] * rj
            wvv[:, :ii, ii] = d[:, :ii]
            v = torch.where(rows == j, vdiag[ii][:, None], P[..., ii]) * act
            upd = P[..., ii + 1:] - (beta[ii][:, None] * v)[..., None] * d[:, None, ii + 1:]
            P[..., ii + 1:] = torch.where(act[None, :, None], upd, P[..., ii + 1:])
            P[:, j, ii] = alpha
        A[..., pc:pc + pw] = P
        V = A.new_zeros((B, R, nb))
        T = A.new_zeros((B, nb, nb))
        for i in range(nbp):
            p = j0 + i
            V[:, :, i] = torch.where(rows > p, A[..., pc + i], 0.0)
            V[:, p, i] = vdiag[i]
            T[:, i, i] = beta[i]
            if i:
                T[:, :i, i] = -beta[i][:, None] * (T[:, :i, :i] @ wvv[:, :i, i:i + 1])[..., 0]
        trail = list(range(M)) + list(range(pc + pw, C))
        At = A[..., trail]
        A[..., trail] = At - V @ (T.mT @ (V.mT @ At))
    out = A.new_zeros((B, K, C))
    top = min(R, K)
    out[:, :top] = A[:, :top]
    r, c = torch.meshgrid(torch.arange(K, device=Z.device), torch.arange(C, device=Z.device), indexing="ij")
    below = (c >= M) & (c - M < steps) & (r > c - M)
    return torch.where(below, 0.0, out)


def householder_blocks(Z: torch.Tensor, w: torch.Tensor, K: int) -> torch.Tensor:
    """``T [B, K, C]``: the first K rows of each block ``Z [B, R, C]`` f64
    (targets first) under the row mask ``w [B, R]`` bool after K Householder
    reflections of its last K columns."""
    _check(Z, w, K)
    if Z.device.type == "cpu":
        return householder_blocks_ref(Z, w, K)
    return _launch(Z, w, K, K)


def _launch(Z: torch.Tensor, w: torch.Tensor, K: int, reflections: int) -> torch.Tensor:
    """The kernel's ``T`` after its first ``reflections`` reflections (K for
    the reduction; fewer times the kernel's phases)."""
    global householder_kernel_launches
    if Z.device.type != "cuda":
        raise ValueError(f"no Householder kernel for device {Z.device}")
    B, R, C = Z.shape
    T = torch.empty((B, K, C), dtype=F64, device=Z.device)
    lib = _kernel()
    form = lib.pols_householder_form(R, C)
    if form < 0:
        raise ValueError(f"the Householder kernel has no form for blocks of R={R}, C={C}")
    # the wide form's panels, where they do not fit in shared memory
    work = torch.empty((B, R, C) if form == 2 else (0,), dtype=F64, device=Z.device)
    with torch.cuda.device(Z.device):
        rc = lib.pols_householder_blocks(
            Z.data_ptr(), w.data_ptr(), B, R, C, K, reflections, work.data_ptr() if form == 2 else None,
            T.data_ptr(), torch.cuda.current_stream(Z.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.pols_cuda_error_string(rc).decode()
        raise RuntimeError(f"Householder kernel launch failed: CUDA error {rc} ({msg})")
    householder_kernel_launches += 1
    return T


@dataclass
class ReductionPlan:
    """The reduction tree of one layout (host arrays; ``on`` moves them to a
    device).

    Attributes:
        levels: for each level after the first, (gather [S, R] int64 into
            the previous level's factor rows ``[S_prev * K]``, mask [S, R]
            bool); a block holds the leading rows of several factors of one
            group.
        final: [G] index of each group's last factor into all levels'
            factors concatenated, or None where the last level's blocks are
            the groups in order.
    """

    levels: List[Tuple[torch.Tensor, torch.Tensor]]
    final: Optional[torch.Tensor]


def plan_reduction(blocks_per_group: np.ndarray, K: int, device=None, rows: Optional[int] = None) -> ReductionPlan:
    """The tree that reduces each group's ``blocks_per_group[g]`` factors
    (contiguous, in group order) of blocks of ``rows`` rows (default: K or
    more) to one. Groups with one factor are done; the others stack the
    leading ``h`` rows of theirs (h = K, or the rows of a block of fewer:
    the factor's rows below those are zero), ``max(MAX_ROWS, 2 K) // h`` (at
    least two) to a block, level by level."""
    h = K if rows is None else max(1, min(K, int(rows)))
    units = np.asarray(blocks_per_group, dtype=np.int64).copy()
    G = len(units)
    first = np.zeros(G, dtype=np.int64)
    np.cumsum(units[:-1], out=first[1:])
    final = np.full(G, -1, dtype=np.int64)
    done = units == 1
    final[done] = first[done]
    base, size = 0, int(units.sum())  # the current level's offset and factor count
    levels = []
    while not done.all():
        per = max(2, max(MAX_ROWS, 2 * K) // h)
        active = np.flatnonzero(~done)
        nb = -(-units[active] // per)  # the next level's blocks of each active group
        S = int(nb.sum())
        width = int(min(per, units[active].max())) * h
        blk_group = np.repeat(active, nb)
        blk_first = np.zeros(len(active), dtype=np.int64)
        np.cumsum(nb[:-1], out=blk_first[1:])
        f_lo = (np.arange(S) - np.repeat(blk_first, nb)) * per
        f_cnt = np.minimum(per, units[blk_group] - f_lo)
        slot = np.arange(width)
        mask = slot[None, :] // h < f_cnt[:, None]
        src = (first[blk_group][:, None] + f_lo[:, None] + slot[None, :] // h) * K + slot[None, :] % h
        levels.append((np.where(mask, src, 0), mask))
        h = min(K, width)
        base += size
        size = S
        units = np.zeros(G, dtype=np.int64)
        units[active] = nb
        first[active] = blk_first
        newly = np.zeros(G, dtype=bool)
        newly[active] = nb == 1
        final[newly] = base + first[newly]
        done |= newly
    in_order = size == G and np.array_equal(final, base + np.arange(G))
    dev = device if device is not None else torch.device("cpu")
    return ReductionPlan(
        [(torch.as_tensor(g, device=dev), torch.as_tensor(m, device=dev)) for g, m in levels],
        None if in_order else torch.as_tensor(final, device=dev),
    )


def reduce_groups(Z: torch.Tensor, w: torch.Tensor, K: int, plan: ReductionPlan) -> torch.Tensor:
    """Each group's factor ``[G, K, C]`` of its blocks ``Z [S, R, C]`` under
    ``w [S, R]``: the blocks' reduction, then the plan's levels (one
    launch each, on the stacked factors; a plan made for blocks of R rows,
    or of K or more). Register form blocks of more than ``MAX_ROWS`` rows
    (a larger ``CONFIG.moment_chunk_rows``) are first cut into pieces of
    that many, and each block's stacked piece factors stand in for its
    rows; the wide form takes a block whole."""
    S, R, C = Z.shape
    limit = MAX_ROWS
    while C <= MAX_COLS and R > limit:
        n = -(-R // limit)
        pad = n * limit - R
        Z = torch.cat([Z, Z.new_zeros((S, pad, C))], dim=1).reshape(S * n, limit, C)
        w = torch.cat([w, w.new_zeros((S, pad))], dim=1).reshape(S * n, limit)
        R = n * K
        Z = householder_blocks(Z, w, K).reshape(S, R, C)
        w = torch.ones((S, R), dtype=torch.bool, device=Z.device)
    outs = [householder_blocks(Z, w, K)]
    for gather, mask in plan.levels:
        rows = outs[-1].reshape(-1, C).index_select(0, gather.reshape(-1))
        outs.append(householder_blocks(rows.reshape(*mask.shape, C), mask, K))
    if plan.final is None:
        return outs[-1]
    return torch.cat(outs).index_select(0, plan.final)
