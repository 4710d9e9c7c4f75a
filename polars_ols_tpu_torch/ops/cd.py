"""Cyclic coordinate descent for lasso / elastic net / NNLS on the moments.

The JAX engine's ``ops/cd.py:solve_elastic_net_cov`` (its K < 33 branch,
``_cd_cov_single`` vmapped over groups): the covariance form of the
reference's cyclic coordinate descent (src/least_squares.rs:386-492). It
minimizes ``1/(2n)||y - Xw||^2 + alpha*l1*||w||_1 +
0.5*alpha*(1-l1)*||w||^2`` per group, alpha scaled by the group's valid
rows (``max(n_valid, 1)``); each coordinate step is ``w_j <-
S(Xty_j - (XtX w)_j + XtX_jj w_j, a_l1) / (XtX_jj + a_l2)`` (a
denominator that is not positive becomes 1), clamped at 0 when
``positive``; sweeps stop when ``||w_new - w_old||_2 < tol`` or after
``max_iter``. ``active_set`` freezes a coordinate for good the first time
its update lands below ``tol`` in absolute value (the reference's
``cd_active_set``, src/least_squares.rs:447-488).

On a CUDA tensor ``solve_elastic_net_cov`` always launches the
hand-written kernel ``csrc/cd.cu`` (``32 / KB`` groups a warp, KB the
bucket 8, 16 or 32 that holds K) and counts the
launch in ``cd_kernel_launches``; a failed build or launch raises. On a
CPU tensor it runs ``solve_elastic_net_cov_ref``. Both form ``(XtX w)_j``
and the squared step norm as sequential sums in k-order from separately
rounded products, so the two give the same bits and the same sweep counts.

K > 32 (the JAX engine's FISTA with an active-set polish) is ROADMAP.md
Queue 1 item 12b; the row form ``solve_elastic_net`` waits for the sharded
path (item 11).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..config import F64
from . import kernels

# kernel launches made by solve_elastic_net_cov since the last reset
cd_kernel_launches = 0

# largest K of the cyclic form (one warp lane per coordinate)
MAX_K = 32

_BOUND = None


def _kernel():
    global _BOUND
    if _BOUND is None:
        lib = kernels.load("cd")
        vp, i64, f64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
        lib.pols_cd_cov.argtypes = [
            vp, vp, vp, i64, i64, f64, f64, f64, i32, f64, i32, i32, vp, vp, vp,
        ]
        lib.pols_cd_cov.restype = ctypes.c_int
        lib.pols_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pols_cuda_error_string.restype = ctypes.c_char_p
        _BOUND = lib
    return _BOUND


def _check(XtX, Xty, n_valid) -> None:
    if XtX.dtype != F64 or XtX.dim() != 3 or XtX.shape[1] != XtX.shape[2]:
        raise TypeError(f"XtX must be a [G, K, K] float64 tensor, got {XtX.dtype} {tuple(XtX.shape)}")
    G, K, _ = XtX.shape
    if K > MAX_K:
        raise NotImplementedError(
            f"K={K} features: the port's coordinate descent covers K <= {MAX_K} "
            "(larger K is ROADMAP.md Queue 1 item 12b)"
        )
    if Xty.dtype != F64 or tuple(Xty.shape) != (G, K):
        raise TypeError(f"Xty must be a [{G}, {K}] float64 tensor, got {Xty.dtype} {tuple(Xty.shape)}")
    if n_valid.dtype != F64 or tuple(n_valid.shape) != (G,):
        raise TypeError(f"n_valid must be a [{G}] float64 tensor, got {n_valid.dtype} {tuple(n_valid.shape)}")
    if not (XtX.device == Xty.device == n_valid.device):
        raise ValueError("XtX, Xty and n_valid must be on one device")
    if not (XtX.is_contiguous() and Xty.is_contiguous() and n_valid.is_contiguous()):
        raise ValueError("XtX, Xty and n_valid must be contiguous")


def _soft_threshold(x: torch.Tensor, a: torch.Tensor, positive: bool) -> torch.Tensor:
    """sign(x) * max(|x| - a, 0), clamped at 0 when positive; NaN stays NaN
    (src/least_squares.rs:373-379)."""
    zero = torch.zeros((), dtype=F64, device=x.device)
    out = torch.sign(x) * torch.maximum(x.abs() - a, zero)
    return torch.maximum(out, zero) if positive else out


def solve_elastic_net_cov_ref(
    XtX: torch.Tensor,  # [G, K, K]
    Xty: torch.Tensor,  # [G, K]
    n_valid: torch.Tensor,  # [G]
    alpha: float,
    l1_ratio: float = 0.5,
    max_iter: int = 1000,
    tol: float = 1e-5,
    positive: bool = False,
    active_set: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: every group sweeps in lockstep, and a group whose
    loop has ended keeps its iterate (as under ``vmap(while_loop)``).
    Returns (w [G, K] f64, sweeps [G] int32). Host sync: one per sweep."""
    _check(XtX, Xty, n_valid)
    G, K = Xty.shape
    a = alpha * torch.clamp_min(n_valid, 1.0)
    a_l1 = a * l1_ratio
    a_l2 = a * (1.0 - l1_ratio)
    diag = torch.diagonal(XtX, dim1=-2, dim2=-1)
    denom = diag + a_l2[:, None]
    denom = torch.where(denom > 0, denom, 1.0)
    w = torch.zeros((G, K), dtype=F64, device=XtX.device)
    active = torch.ones((G, K), dtype=torch.bool, device=XtX.device)
    sweeps = torch.zeros(G, dtype=torch.int32, device=XtX.device)
    delta = torch.full((G,), torch.inf, dtype=F64, device=XtX.device)
    running = (sweeps < max_iter) & (delta >= tol)
    while bool(running.any()):  # host sync
        cols = list(w.unbind(1))
        act = list(active.unbind(1))
        for j in range(K):
            acc = XtX[:, j, 0] * cols[0]
            for k in range(1, K):
                acc = acc + XtX[:, j, k] * cols[k]
            rho = Xty[:, j] - acc + diag[:, j] * cols[j]
            wj = _soft_threshold(rho, a_l1, positive) / denom[:, j]
            if active_set:
                wj = torch.where(act[j], wj, cols[j])
                act[j] = act[j] & (wj.abs() >= tol)
            cols[j] = wj
        d = cols[0] - w[:, 0]
        sq = d * d
        for k in range(1, K):
            d = cols[k] - w[:, k]
            sq = sq + d * d
        w = torch.where(running[:, None], torch.stack(cols, dim=1), w)
        if active_set:
            active = torch.where(running[:, None], torch.stack(act, dim=1), active)
        delta = torch.where(running, torch.sqrt(sq), delta)
        sweeps = sweeps + running.to(torch.int32)
        running = (sweeps < max_iter) & (delta >= tol)
    return w, sweeps


def solve_elastic_net_cov(
    XtX: torch.Tensor,
    Xty: torch.Tensor,
    n_valid: torch.Tensor,
    alpha: float,
    l1_ratio: float = 0.5,
    max_iter: int = 1000,
    tol: float = 1e-5,
    positive: bool = False,
    active_set: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group elastic-net coefficients (w [G, K] f64, sweeps [G] int32)
    from the moments XtX [G, K, K], Xty [G, K] and valid-row counts
    n_valid [G] (contiguous f64, K <= 32)."""
    global cd_kernel_launches
    _check(XtX, Xty, n_valid)
    if XtX.device.type == "cpu":
        return solve_elastic_net_cov_ref(
            XtX, Xty, n_valid, alpha, l1_ratio, max_iter, tol, positive, active_set
        )
    if XtX.device.type != "cuda":
        raise ValueError(f"no coordinate-descent kernel for device {XtX.device}")
    G, K = Xty.shape
    w = torch.empty((G, K), dtype=F64, device=XtX.device)
    sweeps = torch.empty(G, dtype=torch.int32, device=XtX.device)
    lib = _kernel()
    with torch.cuda.device(XtX.device):
        rc = lib.pols_cd_cov(
            XtX.data_ptr(), Xty.data_ptr(), n_valid.data_ptr(), G, K,
            float(alpha), float(l1_ratio), 1.0 - float(l1_ratio), int(max_iter),
            float(tol), int(bool(positive)), int(bool(active_set)),
            w.data_ptr(), sweeps.data_ptr(),
            torch.cuda.current_stream(XtX.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.pols_cuda_error_string(rc).decode()
        raise RuntimeError(f"coordinate-descent kernel launch failed: CUDA error {rc} ({msg})")
    cd_kernel_launches += 1
    return w, sweeps
