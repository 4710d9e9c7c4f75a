"""Minimum-norm (ridge-shrunk) least squares from a square factor, by a
one-sided Jacobi SVD.

``factor_lstsq(F, QtY, n_valid, alpha, rcond)`` takes the K x K factors
``F [G, K, K]`` of a Householder reduction (``X = Q [F; 0]``) and their
targets ``Q^T Y [G, K, M]`` and returns ``beta [G, K, M]``: the SVD of F
by one-sided Jacobi rotations of its columns (F V = W, W's column norms
the singular values, U = W / sigma), numpy lstsq's cutoff at ``rcond *
max sigma`` (``rcond`` None: ``eps * max(n_valid, K)`` per group) and the
ridge shrink ``sigma / (sigma^2 + alpha)``: ``beta = V diag(d) U^T Q^T Y``.
It is the JAX package's ``jacobi_svd_lanes`` with the shrink of
``svd_lstsq_lanes`` (``polars_ols_tpu/ops/linalg.py:463,499``; XLA, no
Pallas kernel), which its grouped 'svd' and multi-target fits run.

The rotations are the JAX function's (cyclic order p < q, ``tau = (aqq -
app) / (2 apq)``, ``t = sign(tau) / (|tau| + sqrt(1 + tau^2))`` with
sign(0) = +1, ``c = 1 / sqrt(1 + t^2)``, ``s = c t``), but where that
function runs a fixed 8 sweeps, each group here sweeps until a sweep
rotates none of its pairs. A pair is rotated only while ``|apq| > sqrt(K)
eps sqrt(app) sqrt(aqq)`` (a K-term dot product rounds to ~sqrt(K) eps of
the norms' product, so a tighter test may never end; LAPACK's dgesvj uses
the same) and while neither column is below eps of the other (such a
column is rounding noise, below any cutoff, and its rotations shrink it by
eps a sweep without ending; leaving it changes the other by eps^2).
``MAX_SWEEPS`` caps the sweeps (8 do not converge at K = 32; random and
rank-deficient factors took at most 10 there, 7 at K = 5). A group whose
factor holds a non-finite value gets NaN in every entry of beta; a
non-finite target spreads NaN through its own column, as the arithmetic
does.

On a CUDA tensor ``factor_lstsq`` always launches the hand-written kernel
``csrc/jacobi_svd.cu`` and counts the launch in ``jacobi_kernel_launches``;
a failed build or launch raises. On a CPU tensor it runs the plain version
``factor_lstsq_ref``, the same arithmetic, sweep rule and cap in torch ops;
nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..config import F64
from . import kernels

# kernel launches made by factor_lstsq since the last reset
jacobi_kernel_launches = 0

# the port's fits take K <= 32 (a group is one segment of at most a warp)
MAX_K = 32
# sweeps a group may take before its rotations stop, converged or not
MAX_SWEEPS = 30

_EPS64 = float(torch.finfo(torch.float64).eps)

_BOUND = None


def _kernel():
    global _BOUND
    if _BOUND is None:
        lib = kernels.load("jacobi_svd")
        vp, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
        lib.pols_factor_lstsq.argtypes = [
            vp, i64, i64, i64, vp, i64, i64, i64, vp, i64, i64, i64, f64, f64, ctypes.c_int, vp, vp,
        ]
        lib.pols_factor_lstsq.restype = ctypes.c_int
        lib.pols_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pols_cuda_error_string.restype = ctypes.c_char_p
        _BOUND = lib
    return _BOUND


def _check(F, QtY, n_valid) -> None:
    if F.dtype != F64 or F.dim() != 3 or F.shape[1] != F.shape[2]:
        raise TypeError(f"F must be a [G, K, K] float64 tensor, got {F.dtype} {tuple(F.shape)}")
    G, K, _ = F.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"F has K={K}; the Jacobi SVD takes 1 <= K <= {MAX_K}")
    if QtY.dtype != F64 or QtY.dim() != 3 or tuple(QtY.shape[:2]) != (G, K):
        raise TypeError(f"QtY must be a [{G}, {K}, M] float64 tensor, got {QtY.dtype} {tuple(QtY.shape)}")
    if n_valid.dtype != F64 or tuple(n_valid.shape) != (G,):
        raise TypeError(f"n_valid must be a [{G}] float64 tensor, got {n_valid.dtype} {tuple(n_valid.shape)}")
    if not (F.device == QtY.device == n_valid.device):
        raise ValueError("F, QtY and n_valid must be on one device")


def jacobi_ref(F: torch.Tensor):
    """(W, V, sweeps, rotated): the one-sided Jacobi rotations of F's
    columns (W = F V), the sweeps each group ran (the last one rotated
    nothing, unless the cap stopped it) and which pairs each group rotated,
    ``rotated [G, sweeps run, K(K-1)/2]`` bool in the cyclic pair order.
    Groups whose F is not finite are not rotated (0 sweeps). Synchronises
    once a sweep (whether any group still rotates)."""
    G, K, _ = F.shape
    W = F.clone()
    V = torch.eye(K, dtype=F64, device=F.device).expand(G, K, K).clone()
    active = torch.isfinite(F).all(dim=-1).all(dim=-1)
    tol = math.sqrt(K) * _EPS64
    sweeps = torch.zeros(G, dtype=torch.int64, device=F.device)
    record = []
    for _ in range(MAX_SWEEPS if K > 1 else 0):
        if not bool(active.any()):
            break
        rotated = torch.zeros_like(active)
        record.append([])
        for p in range(K - 1):
            for q in range(p + 1, K):
                wp, wq = W[:, :, p].clone(), W[:, :, q].clone()
                app = (wp * wp).sum(dim=-1)
                aqq = (wq * wq).sum(dim=-1)
                apq = (wp * wq).sum(dim=-1)
                na, nq = app.sqrt(), aqq.sqrt()
                rot = active & (apq.abs() > tol * na * nq)
                rot &= torch.minimum(na, nq) > _EPS64 * torch.maximum(na, nq)
                tau = (aqq - app) / (2.0 * torch.where(apq == 0, 1.0, apq))
                t = torch.where(tau >= 0, 1.0, -1.0).to(F64) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
                c = 1.0 / torch.sqrt(1.0 + t * t)
                s = (c * t)[:, None]
                c = c[:, None]
                r = rot[:, None]
                W[:, :, p] = torch.where(r, c * wp - s * wq, wp)
                W[:, :, q] = torch.where(r, s * wp + c * wq, wq)
                vp, vq = V[:, :, p].clone(), V[:, :, q].clone()
                V[:, :, p] = torch.where(r, c * vp - s * vq, vp)
                V[:, :, q] = torch.where(r, s * vp + c * vq, vq)
                rotated |= rot
                record[-1].append(rot)
        sweeps += active
        active &= rotated
    pairs = K * (K - 1) // 2
    rotated = (torch.stack([torch.stack(r, dim=-1) for r in record], dim=1) if record
               else torch.zeros((G, 0, pairs), dtype=torch.bool, device=F.device))
    return W, V, sweeps, rotated


def factor_lstsq_ref(F, QtY, n_valid, alpha: float = 0.0, rcond: float | None = None) -> torch.Tensor:
    """Plain version: ``jacobi_ref``, then the kernel's cutoff and shrink."""
    _check(F, QtY, n_valid)
    K = F.shape[-1]
    W, V, _, _ = jacobi_ref(F)
    sigma = torch.sqrt((W * W).sum(dim=-2))  # [G, K]
    U = W / torch.where(sigma == 0, 1.0, sigma)[:, None, :]
    uty = torch.einsum("gij,gim->gjm", U, QtY)
    rc = _EPS64 * torch.clamp(n_valid, min=float(K)) if rcond is None else torch.full_like(n_valid, rcond)
    cut = rc * sigma.amax(dim=-1)
    denom = sigma * sigma + alpha
    d = torch.where(sigma > cut[:, None], sigma / torch.where(denom == 0, 1.0, denom), 0.0)
    beta = torch.einsum("gij,gjm->gim", V, d[..., None] * uty)
    bad = ~torch.isfinite(F).all(dim=-1).all(dim=-1)
    return torch.where(bad[:, None, None], torch.nan, beta)


def factor_lstsq(F, QtY, n_valid, alpha: float = 0.0, rcond: float | None = None) -> torch.Tensor:
    """``beta [G, K, M]`` from the factors ``F [G, K, K]`` f64 and their
    targets ``QtY [G, K, M]`` (views of any strides), ``n_valid [G]`` f64
    valid rows a group (numpy's default cutoff), ridge ``alpha`` and
    ``rcond`` (None: numpy's default)."""
    global jacobi_kernel_launches
    _check(F, QtY, n_valid)
    if F.device.type == "cpu":
        return factor_lstsq_ref(F, QtY, n_valid, alpha, rcond)
    if F.device.type != "cuda":
        raise ValueError(f"no Jacobi SVD kernel for device {F.device}")
    G, K, M = QtY.shape
    beta = torch.empty((G, K, M), dtype=F64, device=F.device)
    n_valid = n_valid.contiguous()
    lib = _kernel()
    with torch.cuda.device(F.device):
        rc = lib.pols_factor_lstsq(
            F.data_ptr(), *F.stride(), QtY.data_ptr(), *QtY.stride(), n_valid.data_ptr(), G, K, M,
            float(alpha), -1.0 if rcond is None else float(rcond), int(rcond is None),
            beta.data_ptr(), torch.cuda.current_stream(F.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.pols_cuda_error_string(rc).decode()
        raise RuntimeError(f"Jacobi SVD kernel launch failed: CUDA error {rc} ({msg})")
    jacobi_kernel_launches += 1
    return beta
