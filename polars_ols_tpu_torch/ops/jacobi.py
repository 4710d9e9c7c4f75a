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
sign(0) = +1, ``s = c t``), with ``c = rsqrt(1 + t^2)`` (one root where
that function takes a root and a division), but where that function runs
a fixed 8 sweeps, each group here sweeps until a sweep rotates none of its
pairs. A pair is rotated only while ``apq^2 > K eps^2 app aqq`` (``|apq| >
sqrt(K) eps |wp| |wq|``: a K-term dot product rounds to ~sqrt(K) eps of the
norms' product, so a tighter test may never end; LAPACK's dgesvj uses the
same) and while ``min(app, aqq) > eps^2 max(app, aqq)`` (neither column
below eps of the other: such a column is rounding noise, below any cutoff,
and its rotations shrink it by eps a sweep without ending; leaving it
changes the other by eps^2). The tests take no root; so that no square
over- or underflows, each group is first scaled by a power of two, its
largest entry in [1, 2) (exact: the rotations are the unscaled group's).
``MAX_SWEEPS`` caps the sweeps (8 do not converge at K = 32; random and
rank-deficient factors took at most 10 there, 7 at K = 5). A group whose
factor holds a non-finite value gets NaN in every entry of beta; a
non-finite target spreads NaN through its own column, as the arithmetic
does.

On a CUDA tensor ``factor_lstsq`` always launches the hand-written kernel
``csrc/jacobi_svd.cu`` and counts the launch in ``jacobi_kernel_launches``;
a failed build or launch raises. On a CPU tensor it runs the plain version
``factor_lstsq_ref``, the same scaling, formulas, sweep rule and cap in
torch ops (the kernel's angle takes its divisions and roots as Newton steps
from the hardware's estimates, within an ulp); nothing falls back from one
to the other. The kernel has three forms, which its C entry picks by K
(one thread a group, W and V in its registers, up to K = 8; a segment of
16 / 32 lanes a group up to ``MAX_K`` = 32; above, the wide form: a CTA of
several warps a group, or a cluster of 2-8 CTAs that split its columns
where the groups are fewer than the SMs (``wide_ctas``), W and V in shared
memory where they fit, else in a device-memory workspace that ``_launch``
allocates): ``kernel_form`` reads the choice back. The wide form takes a
sweep's pairs in the parallel order of the circle method (``sweep_rounds``:
rounds of pairs that share no column, one round a barrier), not the cyclic
order, each pair's angle once (on one lane); its plain version takes the
same order, a round at a time. ``max_sweeps`` below
``MAX_SWEEPS`` stops the rotations early (both versions), which times the
kernel's phases.

``rows_lstsq(Xt, Y, n_valid, ...)`` is the wide form's rows mode: the
minimum-norm (ridge-shrunk) solution of problems ``X [n, K]`` with fewer
rows than features, from ``Xt = X^T [G, K, n]``: the n columns of X^T
(each of length K) are rotated to orthogonality, ``X^T V = W``, so that
``X^T = U diag(sigma) V^T`` with ``sigma = |W|`` and ``U = W / sigma``,
and ``beta = U diag(d) V^T Y`` with the same cutoff (``eps * max(n_valid,
K)``) and shrink. Its plain version is ``rows_lstsq_ref``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..config import F64
from . import kernels

# kernel launches made by factor_lstsq since the last reset
jacobi_kernel_launches = 0

# largest K of the segment form (a group is one segment of at most a warp);
# larger K takes the wide form
MAX_K = 32
# sweeps a group may take before its rotations stop, converged or not
MAX_SWEEPS = 30
# the kernel's forms, as pols_factor_lstsq_form numbers them
FORMS = ("thread", "segment", "wide")

_EPS64 = float(torch.finfo(torch.float64).eps)

_BOUND = None


def _kernel():
    global _BOUND
    if _BOUND is None:
        lib = kernels.load("jacobi_svd")
        vp, i64, f64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
        lib.pols_factor_lstsq.argtypes = [
            vp, i64, i64, i64, vp, i64, i64, i64, vp, i64, i64, i64, f64, f64, i32, i32, vp, vp, vp,
        ]
        lib.pols_factor_lstsq.restype = ctypes.c_int
        lib.pols_rows_lstsq.argtypes = [
            vp, i64, i64, i64, vp, i64, i64, i64, vp, i64, i64, i64, i64, f64, f64, i32, i32, vp, vp, vp,
        ]
        lib.pols_rows_lstsq.restype = ctypes.c_int
        lib.pols_wide_workspace.argtypes = [i64, i64, i64]
        lib.pols_wide_workspace.restype = ctypes.c_int64
        lib.pols_wide_ctas.argtypes = [i64, i64, i64]
        lib.pols_wide_ctas.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.pols_factor_lstsq_form.argtypes = [i64, i64, ip, ip]
        lib.pols_factor_lstsq_form.restype = ctypes.c_int
        lib.pols_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pols_cuda_error_string.restype = ctypes.c_char_p
        _BOUND = lib
    return _BOUND


def kernel_form(K: int, G: int = 1):
    """(form, threads a block, groups a block) that the kernel launches at
    K for G groups, as its C entry picks them (builds the kernel; the wide
    form's threads depend on G and the card's SMs)."""
    if K < 1:
        raise ValueError(f"the Jacobi SVD kernel takes K >= 1, got K={K}")
    threads, groups = ctypes.c_int(), ctypes.c_int()
    form = _kernel().pols_factor_lstsq_form(K, G, ctypes.byref(threads), ctypes.byref(groups))
    if form < 0:
        raise RuntimeError(f"the Jacobi SVD kernel has no form at K={K}, G={G}")
    return FORMS[form], threads.value, groups.value


def wide_ctas(K: int, G: int = 1, n: int | None = None) -> int:
    """CTAs the wide form gives each of G problems of K x K (``n``: the
    rows mode's K x n), as its C entry picks them (builds the kernel): a
    cluster of 2, 4 or 8 that splits W's and V's columns where the problems
    are fewer than the SMs, else 1."""
    ctas = _kernel().pols_wide_ctas(G, K, K if n is None else n)
    if ctas < 1:
        raise RuntimeError(f"the Jacobi SVD kernel's wide form has no layout at K={K}, n={n}, G={G}")
    return ctas


def sweep_rounds(K: int, wide: bool):
    """The pairs (p, q) of one sweep over K columns, as rounds run in turn.
    ``wide``: the circle method's K - 1 rounds (K rounded up to even; pair k
    of round r is (r, m - 1) for k = 0, else (r + k, r - k) mod m - 1, p <
    q, pairs with the odd count's idle slot left out), whose pairs share no
    column; else the cyclic order, a pair a round."""
    if not wide:
        return [[(p, q)] for p in range(K - 1) for q in range(p + 1, K)]
    m = K + (K & 1)
    rounds = []
    for r in range(m - 1):
        pairs = []
        for k in range(m // 2):
            a, b = (r, m - 1) if k == 0 else ((r + k) % (m - 1), (r - k) % (m - 1))
            if max(a, b) < K:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
    return rounds


def _check(F, QtY, n_valid, max_sweeps) -> None:
    if F.dtype != F64 or F.dim() != 3 or F.shape[1] != F.shape[2]:
        raise TypeError(f"F must be a [G, K, K] float64 tensor, got {F.dtype} {tuple(F.shape)}")
    G, K, _ = F.shape
    if K < 1:
        raise ValueError(f"F has K={K}; the Jacobi SVD takes K >= 1")
    if QtY.dtype != F64 or QtY.dim() != 3 or tuple(QtY.shape[:2]) != (G, K):
        raise TypeError(f"QtY must be a [{G}, {K}, M] float64 tensor, got {QtY.dtype} {tuple(QtY.shape)}")
    _check_rest(F, QtY, n_valid, max_sweeps)


def _check_rows(Xt, Y, n_valid, max_sweeps) -> None:
    if Xt.dtype != F64 or Xt.dim() != 3 or not 1 <= Xt.shape[2] <= Xt.shape[1]:
        raise TypeError(f"Xt must be a [G, K, n] float64 tensor with 1 <= n <= K, got {Xt.dtype} {tuple(Xt.shape)}")
    G, _, n = Xt.shape
    if Y.dtype != F64 or Y.dim() != 3 or tuple(Y.shape[:2]) != (G, n):
        raise TypeError(f"Y must be a [{G}, {n}, M] float64 tensor, got {Y.dtype} {tuple(Y.shape)}")
    _check_rest(Xt, Y, n_valid, max_sweeps)


def _check_rest(F, QtY, n_valid, max_sweeps) -> None:
    G = F.shape[0]
    if n_valid.dtype != F64 or tuple(n_valid.shape) != (G,):
        raise TypeError(f"n_valid must be a [{G}] float64 tensor, got {n_valid.dtype} {tuple(n_valid.shape)}")
    if not (F.device == QtY.device == n_valid.device):
        raise ValueError("F, QtY and n_valid must be on one device")
    if isinstance(max_sweeps, bool) or not isinstance(max_sweeps, int) or not 0 <= max_sweeps <= MAX_SWEEPS:
        raise ValueError(f"max_sweeps must be an int in 0..{MAX_SWEEPS}, got {max_sweeps!r}")


def _rotations(F: torch.Tensor, max_sweeps: int, wide: bool):
    """(W, V, sweeps, rotated, ex): ``jacobi_ref``'s rotations of the scaled
    group F 2^-ex (its largest entry in [1, 2), ex clamped to [-1000, 999]
    as the kernel clamps it), W left scaled. F is [G, rows, K]: its K
    columns are rotated, and the test's dots have ``rows`` terms. The pairs
    go in ``sweep_rounds(K, wide)``'s order, a round at a time."""
    G, rows, K = F.shape
    active = torch.isfinite(F).all(dim=-1).all(dim=-1)
    amax = torch.where(active, F.abs().amax(dim=(-2, -1)), 1.0)
    _, e = torch.frexp(amax)
    ex = torch.where(e < -1000, -1000, torch.clamp(e, max=1000) - 1)
    # columns as rows: Wt [G, K, rows], Vt [G, K, K]
    Wt = (F * torch.ldexp(torch.ones_like(amax), -ex)[:, None, None]).mT.contiguous()
    Vt = torch.eye(K, dtype=F64, device=F.device).expand(G, K, K).clone()
    tol2 = rows * _EPS64 * _EPS64
    sweeps = torch.zeros(G, dtype=torch.int64, device=F.device)
    rounds = [(torch.tensor([p for p, _ in r], device=F.device), torch.tensor([q for _, q in r], device=F.device))
              for r in sweep_rounds(K, wide)]
    record = []
    for _ in range(max_sweeps if K > 1 else 0):
        if not bool(active.any()):
            break
        rotated = torch.zeros_like(active)
        record.append([])
        for P, Q in rounds:
            wp, wq = Wt[:, P], Wt[:, Q]  # [G, pairs, rows]
            app = (wp * wp).sum(dim=-1)
            aqq = (wq * wq).sum(dim=-1)
            apq = (wp * wq).sum(dim=-1)
            rot = active[:, None] & (apq * apq > tol2 * app * aqq)
            rot &= torch.minimum(app, aqq) > _EPS64 * _EPS64 * torch.maximum(app, aqq)
            tau = (aqq - app) / (2.0 * torch.where(apq == 0, 1.0, apq))
            t = torch.where(tau >= 0, 1.0, -1.0).to(F64) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            c = torch.rsqrt(1.0 + t * t)
            s = (c * t)[..., None]
            c = c[..., None]
            r = rot[..., None]
            Wt[:, P] = torch.where(r, c * wp - s * wq, wp)
            Wt[:, Q] = torch.where(r, s * wp + c * wq, wq)
            vp, vq = Vt[:, P], Vt[:, Q]
            Vt[:, P] = torch.where(r, c * vp - s * vq, vp)
            Vt[:, Q] = torch.where(r, s * vp + c * vq, vq)
            rotated |= rot.any(dim=-1)
            record[-1].append(rot)
        sweeps += active
        active &= rotated
    pairs = K * (K - 1) // 2
    rotated = (torch.stack([torch.cat(r, dim=-1) for r in record], dim=1) if record
               else torch.zeros((G, 0, pairs), dtype=torch.bool, device=F.device))
    return Wt.mT.contiguous(), Vt.mT.contiguous(), sweeps, rotated, ex


def jacobi_ref(F: torch.Tensor, max_sweeps: int = MAX_SWEEPS):
    """(W, V, sweeps, rotated): the one-sided Jacobi rotations of F's
    columns (W = F V), the sweeps each group ran (the last one rotated
    nothing, unless the cap ``max_sweeps`` stopped it) and which pairs each
    group rotated, ``rotated [G, sweeps run, K(K-1)/2]`` bool in the order
    of ``sweep_rounds(K, K > MAX_K)`` (the kernel's form at K). Groups whose
    F is not finite are not rotated (0 sweeps). Synchronises once a sweep
    (whether any group still rotates)."""
    W, V, sweeps, rotated, ex = _rotations(F, max_sweeps, F.shape[-1] > MAX_K)
    return W * torch.ldexp(torch.ones_like(W[:, 0, 0]), ex)[:, None, None], V, sweeps, rotated


def factor_lstsq_ref(F, QtY, n_valid, alpha: float = 0.0, rcond: float | None = None,
                     max_sweeps: int = MAX_SWEEPS) -> torch.Tensor:
    """Plain version: ``jacobi_ref``'s rotations, then the kernel's cutoff
    and shrink (U and sigma from the scaled W, sigma then unscaled)."""
    _check(F, QtY, n_valid, max_sweeps)
    K = F.shape[-1]
    W, V, _, _, ex = _rotations(F, max_sweeps, K > MAX_K)
    sigma_s = torch.sqrt((W * W).sum(dim=-2))  # [G, K]
    U = W / torch.where(sigma_s == 0, 1.0, sigma_s)[:, None, :]
    sigma = sigma_s * torch.ldexp(torch.ones_like(sigma_s[:, 0]), ex)[:, None]
    uty = torch.einsum("gij,gim->gjm", U, QtY)
    rc = _EPS64 * torch.clamp(n_valid, min=float(K)) if rcond is None else torch.full_like(n_valid, rcond)
    cut = rc * sigma.amax(dim=-1)
    denom = sigma * sigma + alpha
    d = torch.where(sigma > cut[:, None], sigma / torch.where(denom == 0, 1.0, denom), 0.0)
    beta = torch.einsum("gij,gjm->gim", V, d[..., None] * uty)
    bad = ~torch.isfinite(F).all(dim=-1).all(dim=-1)
    return torch.where(bad[:, None, None], torch.nan, beta)


def rows_lstsq_ref(Xt, Y, n_valid, alpha: float = 0.0, rcond: float | None = None,
                   max_sweeps: int = MAX_SWEEPS) -> torch.Tensor:
    """Plain version of ``rows_lstsq``: ``jacobi_ref``'s rotations of the n
    columns of ``Xt [G, K, n]``, then beta = (W / sigma) diag(d) V^T Y."""
    _check_rows(Xt, Y, n_valid, max_sweeps)
    K = Xt.shape[1]
    W, V, _, _, ex = _rotations(Xt, max_sweeps, True)
    sigma_s = torch.sqrt((W * W).sum(dim=-2))  # [G, n]
    U = W / torch.where(sigma_s == 0, 1.0, sigma_s)[:, None, :]
    sigma = sigma_s * torch.ldexp(torch.ones_like(sigma_s[:, 0]), ex)[:, None]
    vty = torch.einsum("gij,gim->gjm", V, Y)
    rc = _EPS64 * torch.clamp(n_valid, min=float(K)) if rcond is None else torch.full_like(n_valid, rcond)
    cut = rc * sigma.amax(dim=-1)
    denom = sigma * sigma + alpha
    d = torch.where(sigma > cut[:, None], sigma / torch.where(denom == 0, 1.0, denom), 0.0)
    beta = torch.einsum("gij,gjm->gim", U, d[..., None] * vty)
    bad = ~torch.isfinite(Xt).all(dim=-1).all(dim=-1)
    return torch.where(bad[:, None, None], torch.nan, beta)


def rows_lstsq(Xt, Y, n_valid, alpha: float = 0.0, rcond: float | None = None,
               max_sweeps: int = MAX_SWEEPS) -> torch.Tensor:
    """``beta [G, K, M]``: the minimum-norm (ridge-shrunk) solutions of the
    problems ``X [G, n, K]`` (n <= K) given as ``Xt = X^T [G, K, n]`` and
    their targets ``Y [G, n, M]`` (views of any strides), ``n_valid [G]``
    f64, ``alpha``, ``rcond`` (None: numpy's default) and ``max_sweeps``:
    the wide form's rows mode on a CUDA tensor, ``rows_lstsq_ref`` on a CPU
    one."""
    _check_rows(Xt, Y, n_valid, max_sweeps)
    if Xt.device.type == "cpu":
        return rows_lstsq_ref(Xt, Y, n_valid, alpha, rcond, max_sweeps)
    return _launch(Xt, Y, n_valid, alpha, rcond, max_sweeps, rows_mode=True)


def factor_lstsq(F, QtY, n_valid, alpha: float = 0.0, rcond: float | None = None,
                 max_sweeps: int = MAX_SWEEPS) -> torch.Tensor:
    """``beta [G, K, M]`` from the factors ``F [G, K, K]`` f64 and their
    targets ``QtY [G, K, M]`` (views of any strides), ``n_valid [G]`` f64
    valid rows a group (numpy's default cutoff), ridge ``alpha`` and
    ``rcond`` (None: numpy's default), after at most ``max_sweeps``
    sweeps."""
    _check(F, QtY, n_valid, max_sweeps)
    if F.device.type == "cpu":
        return factor_lstsq_ref(F, QtY, n_valid, alpha, rcond, max_sweeps)
    return _launch(F, QtY, n_valid, alpha, rcond, max_sweeps)


def _launch(F, QtY, n_valid, alpha, rcond, max_sweeps: int, rows_mode: bool = False) -> torch.Tensor:
    """The kernel's beta, in the form its C entry picks by K (``rows_mode``:
    the wide form's rows mode, F = X^T [G, K, n] and QtY = Y [G, n, M])."""
    global jacobi_kernel_launches
    if F.device.type != "cuda":
        raise ValueError(f"no Jacobi SVD kernel for device {F.device}")
    G, K, n = F.shape
    M = QtY.shape[2]
    beta = torch.empty((G, K, M), dtype=F64, device=F.device)
    n_valid = n_valid.contiguous()
    lib = _kernel()
    per = lib.pols_wide_workspace(G, K, n) if rows_mode or K > MAX_K else 0
    if per < 0:
        raise RuntimeError("Jacobi SVD kernel: no CUDA device for the wide form's layout")
    work = torch.empty((G * per,), dtype=F64, device=F.device) if per else None
    head = (F.data_ptr(), *F.stride(), QtY.data_ptr(), *QtY.stride(), n_valid.data_ptr(), G, K)
    tail = (float(alpha), -1.0 if rcond is None else float(rcond), int(rcond is None), max_sweeps,
            None if work is None else work.data_ptr(), beta.data_ptr())
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        if rows_mode:
            rc = lib.pols_rows_lstsq(*head, n, M, *tail, stream)
        else:
            rc = lib.pols_factor_lstsq(*head, M, *tail, stream)
    if rc != 0:
        msg = lib.pols_cuda_error_string(rc).decode()
        raise RuntimeError(f"Jacobi SVD kernel launch failed: CUDA error {rc} ({msg})")
    jacobi_kernel_launches += 1
    return beta
