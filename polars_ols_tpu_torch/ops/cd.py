"""Coordinate descent for lasso / elastic net / NNLS on the moments.

The JAX engine's ``ops/cd.py:solve_elastic_net_cov``: per group it
minimizes ``1/(2n)||y - Xw||^2 + alpha*l1*||w||_1 +
0.5*alpha*(1-l1)*||w||^2`` on the moments XtX [G, K, K], Xty [G, K],
alpha scaled by the group's valid rows (``max(n_valid, 1)``). K is the
width of XtX, intercept included. Three routes, as in the JAX function:

- K <= 32: cyclic coordinate descent (``_cd_cov_single``, the reference's
  src/least_squares.rs:386-492). Each coordinate step is ``w_j <-
  S(Xty_j - (XtX w)_j + XtX_jj w_j, a_l1) / (XtX_jj + a_l2)`` (a
  denominator that is not positive becomes 1), clamped at 0 when
  ``positive``; sweeps stop when ``||w_new - w_old||_2 < tol`` or after
  ``max_iter``. ``active_set`` freezes a coordinate for good the first
  time its update lands below ``tol`` in absolute value (the reference's
  ``cd_active_set``, src/least_squares.rs:447-488). Kernel ``csrc/cd.cu``
  (``32 / KB`` groups a warp), counted in ``cd_kernel_launches``; its sums
  run in k-order.
- K > 32 with ``active_set``: the same cyclic iteration, with each
  ``(XtX w)_j`` and the step norm summed in the tree order below. Kernel
  ``csrc/cd_wide.cu:cd_cyclic_wide`` (a warp a group; of a coordinate's
  dot only the leaf changed last waits on the chain), counted in
  ``cyclic_wide_kernel_launches``.
- K > 32 otherwise: FISTA with adaptive restart (``_cd_cov_single_fista``:
  24 power steps for the step 1/L, then proximal-gradient iterations
  until ``||w_new - w||_2 < 0.05 tol`` or ``4 max_iter`` of them), then
  the active-set polish (``_active_set_polish``, torch ops on
  ``ops/linalg.py:solve_psd``). Kernel ``csrc/cd_wide.cu:cd_fista`` (a
  row of XtX z four lanes'; a group one CTA of 2-16 warps, or a cluster of
  8 CTAs where the groups are few and wide: ``wide_plan``), counted in
  ``fista_kernel_launches``.

The wide kernels take K <= ``MAX_WIDE_K`` (8,192) and raise past it.

The tree order of the wide routes: a sum over k of K > 32 separately
rounded terms, zero-padded to W = the least power of two >= K, is added
pairwise by halving, k with k + W/2, then k + W/4, .. down to k + 1
(``_tree_sum``: log2 W whole-tensor adds, so a matrix-vector product is
one multiply and log2 W adds). The kernels split it over threads: P
threads (a power of two) hold the terms k = r + P j, each adds its own as
the same tree over j, and log2 P levels of an xor butterfly finish it
(tests/test_torch_cd_order.py emulates each split). So
kernel and plain version give the same bits (up to the sign of an exact
zero), the same restarts and the same iteration counts: the wide cyclic
form's plain version always, FISTA's with ``kernel_order=True`` (the card
checks'); the CPU path runs FISTA's products with XtX through the
library's matrix-vector product (see ``fista_ref``).

On a CUDA tensor ``solve_elastic_net_cov`` always launches the route's
kernel; a failed build or launch raises. On a CPU tensor it runs
``solve_elastic_net_cov_ref``. The polish is the same torch code on both.
The row form ``solve_elastic_net`` (the JAX package's residual-update
solver on padded groups, which the sharded path's group-parallel solves
take) computes each group's moments with the moment kernel and runs
``solve_elastic_net_cov``: the covariance form makes the same coordinate
steps, ``x_j' r = Xty_j - (XtX w)_j + XtX_jj w_j``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from ..config import F64
from . import kernels
from .linalg import solve_psd
from .moments import grouped_moments_blocks

# kernel launches made by solve_elastic_net_cov since the last reset, by
# kernel: csrc/cd.cu (K <= 32), and csrc/cd_wide.cu's FISTA and wide
# cyclic forms (K > 32)
cd_kernel_launches = 0
fista_kernel_launches = 0
cyclic_wide_kernel_launches = 0

# largest K of the warp-segment cyclic form (one warp lane per coordinate);
# above it the wide routes (the JAX engine's _FISTA_MIN_K = MAX_K + 1)
MAX_K = 32
# largest K of the wide kernels (a lane's leaves of the tree order, W / 32,
# at most 256)
MAX_WIDE_K = 8192
LANES = 32
POWER_STEPS = 24
# FISTA's stop test is this much tighter than tol, its cap this many
# times max_iter (the JAX engine's inner_tol and 4 * max_iter)
INNER_TOL = 0.05
ITER_FACTOR = 4

_BOUND = {}


def _error_string(lib):
    lib.pols_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pols_cuda_error_string.restype = ctypes.c_char_p


def _kernel():
    if "cd" not in _BOUND:
        lib = kernels.load("cd")
        vp, i64, f64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
        lib.pols_cd_cov.argtypes = [
            vp, vp, vp, i64, i64, f64, f64, f64, i32, f64, i32, i32, vp, vp, vp,
        ]
        lib.pols_cd_cov.restype = ctypes.c_int
        _error_string(lib)
        _BOUND["cd"] = lib
    return _BOUND["cd"]


def _wide_kernel():
    if "cd_wide" not in _BOUND:
        lib = kernels.load("cd_wide")
        vp, i64, f64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
        lib.pols_cd_fista.argtypes = [
            vp, vp, vp, i64, i64, f64, f64, f64, i32, f64, i32, vp, vp, vp, vp,
        ]
        lib.pols_cd_fista.restype = ctypes.c_int
        lib.pols_cd_cyclic_wide.argtypes = [
            vp, vp, vp, i64, i64, f64, f64, f64, i32, f64, i32, i32, vp, vp, vp, vp,
        ]
        lib.pols_cd_cyclic_wide.restype = ctypes.c_int
        ip = ctypes.POINTER(i32)
        lib.pols_cd_wide_plan.argtypes = [i64, i64, i32, ip, ip, ip, ip, ctypes.POINTER(i64)]
        lib.pols_cd_wide_plan.restype = ctypes.c_int
        _error_string(lib)
        _BOUND["cd_wide"] = lib
    return _BOUND["cd_wide"]


# the wide kernels' forms, by the number pols_cd_wide_plan reports
WIDE_FORMS = {0: "team", 1: "lone", 2: "cluster", 3: "warp"}


class WidePlan(NamedTuple):
    form: str  # WIDE_FORMS: FISTA's team / lone / cluster, the cyclic form's warp
    warps: int  # a CTA
    ctas: int  # a group
    xtx_shared: bool  # XtX (a CTA's rows) in shared memory, else read from device memory
    work: int  # workspace doubles a group (0: the vectors sit in shared memory)


def wide_plan(G: int, K: int, fista: bool) -> WidePlan:
    """What a launch of the wide kernel takes at G groups of K on the
    current device, as its C entry picks it (builds the kernel). FISTA: a
    team, one CTA a group of 2 warps at W = 64 (W the tree width), 4 at
    128, 16 at 256 and 512, 8 above, where the groups are at least the SMs;
    lone, one CTA of 8 or 16 warps, where they are fewer and W <= 256; a
    cluster of 8 CTAs of 16 warps where they are at most an eighth of the
    SMs and 257 <= K <= 4,096. The cyclic form: a
    warp a group. XtX sits in shared memory while it fits beside the
    vectors; the vectors take a device-memory workspace only where they
    alone do not fit."""
    out = [ctypes.c_int(0) for _ in range(4)]
    work = ctypes.c_int64(0)
    rc = _wide_kernel().pols_cd_wide_plan(int(G), int(K), int(bool(fista)), *map(ctypes.byref, out), ctypes.byref(work))
    if rc != 0:
        raise ValueError(f"no wide coordinate-descent plan at G={G}, K={K}")
    form, warps, ctas, shared = (v.value for v in out)
    return WidePlan(WIDE_FORMS[form], warps, ctas, bool(shared), int(work.value))


def wide_layout(K: int, fista: bool) -> Tuple[bool, int]:
    """(XtX in shared memory, workspace doubles a group) of the wide
    kernel at K where the groups are at least the SMs (``wide_plan``)."""
    plan = wide_plan(1 << 30, K, fista)
    return plan.xtx_shared, plan.work


def _check(XtX, Xty, n_valid) -> None:
    if XtX.dtype != F64 or XtX.dim() != 3 or XtX.shape[1] != XtX.shape[2]:
        raise TypeError(f"XtX must be a [G, K, K] float64 tensor, got {XtX.dtype} {tuple(XtX.shape)}")
    G, K, _ = XtX.shape
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


def _strengths(n_valid, alpha: float, l1_ratio: float):
    """(a_l1, a_l2) [G]: alpha scaled by max(n_valid, 1), split by l1_ratio."""
    a = alpha * torch.clamp_min(n_valid, 1.0)
    return a * l1_ratio, a * (1.0 - l1_ratio)


def tree_width(K: int) -> int:
    """The width the tree order pads a sum of K terms to: the least power
    of two >= max(K, 32)."""
    return max(LANES, 1 << (K - 1).bit_length())


def _padded(x: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """x zero-padded on its last ``dims`` axes to ``tree_width``."""
    K = x.shape[-1]
    extra = tree_width(K) - K
    return torch.nn.functional.pad(x, (0, extra) * dims) if extra else x


def _tree_sum(terms: torch.Tensor, own: bool = False) -> torch.Tensor:
    """Sum over the last axis of ``terms`` [..., W] (W = ``tree_width``,
    zero-padded) in the tree order of the wide kernels: halving adds, k
    with k + W/2, then with k + W/4, .. to k + 1. ``own``: terms is the
    caller's temporary and is added into in place."""
    h = terms.shape[-1] // 2
    if not own:
        terms = terms[..., :h] + terms[..., h : 2 * h]
        h //= 2
    while h >= 1:
        terms = terms[..., :h].add_(terms[..., h : 2 * h])
        h //= 2
    return terms[..., 0]


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x [G, W] in the tree order, A [G, K, W] (columns zero-padded) and
    x [G, W] zero-padded; the rows past K are zero."""
    return _padded(_tree_sum(A * x[:, None, :], own=True))


def _cyclic_narrow_ref(XtX, Xty, n_valid, alpha, l1_ratio, max_iter, tol, positive, active_set):
    """Cyclic coordinate descent at K <= 32, every sum in k-order
    (``csrc/cd.cu``'s order)."""
    G, K = Xty.shape
    a_l1, a_l2 = _strengths(n_valid, alpha, l1_ratio)
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


def _cyclic_wide_ref(XtX, Xty, n_valid, alpha, l1_ratio, max_iter, tol, positive, active_set):
    """Cyclic coordinate descent at K > 32, ``(XtX w)_j`` and the step norm
    in the tree order (``csrc/cd_wide.cu:cd_cyclic_wide``'s)."""
    G, K = Xty.shape
    a_l1, a_l2 = _strengths(n_valid, alpha, l1_ratio)
    diag = torch.diagonal(XtX, dim1=-2, dim2=-1)
    denom = diag + a_l2[:, None]
    denom = torch.where(denom > 0, denom, 1.0)
    w = torch.zeros((G, K), dtype=F64, device=XtX.device)
    active = torch.ones((G, K), dtype=torch.bool, device=XtX.device)
    sweeps = torch.zeros(G, dtype=torch.int32, device=XtX.device)
    delta = torch.full((G,), torch.inf, dtype=F64, device=XtX.device)
    running = (sweeps < max_iter) & (delta >= tol)
    A = _padded(XtX)
    while bool(running.any()):  # host sync
        cur = w.clone()
        act = active.clone()
        for j in range(K):
            acc = _tree_sum(A[:, j, :] * _padded(cur), own=True)
            wj_old = cur[:, j]
            rho = Xty[:, j] - acc + diag[:, j] * wj_old
            wj = _soft_threshold(rho, a_l1, positive) / denom[:, j]
            if active_set:
                wj = torch.where(act[:, j], wj, wj_old)
                act[:, j] = act[:, j] & (wj.abs() >= tol)
            cur[:, j] = wj
        d = _padded(cur - w)
        sq = _tree_sum(d * d, own=True)
        w = torch.where(running[:, None], cur, w)
        if active_set:
            active = torch.where(running[:, None], act, active)
        delta = torch.where(running, torch.sqrt(sq), delta)
        sweeps = sweeps + running.to(torch.int32)
        running = (sweeps < max_iter) & (delta >= tol)
    return w, sweeps


def fista_ref(XtX, Xty, n_valid, alpha, l1_ratio, max_iter, tol, positive, kernel_order=False):
    """FISTA with adaptive restart, every group in lockstep (a group whose
    loop has ended keeps its iterate, as under ``vmap(while_loop)``).
    Returns (w [G, K] before the polish, iterations [G] int32). Host sync:
    one an iteration.

    With ``kernel_order`` every sum is in the tree order of
    ``csrc/cd_wide.cu:cd_fista`` (the vectors held zero-padded to
    ``tree_width(K)``, where the kernel adds zeros), so it gives the
    kernel's bits and iteration counts: what the card checks compare.
    Otherwise the products with XtX go to the library's matrix-vector
    product and the dots to ``sum``, as the CPU path runs it: the tree
    order materialises a [G, K, W] product and halves it, several times
    the memory traffic of the library's product, and test_fit_wide's
    lasso takes 12,000 iterations at K = 1,000."""
    G, K = Xty.shape
    dev = XtX.device
    a_l1, a_l2 = _strengths(n_valid, alpha, l1_ratio)
    if kernel_order:
        A, b = _padded(XtX), _padded(Xty)

        def matvec(x):
            return _matvec(A, x)

        def dot(terms):
            return _tree_sum(terms, own=True)
    else:
        A, b = XtX, Xty

        def matvec(x):
            return torch.matmul(A, x[..., None])[..., 0]

        def dot(terms):
            return terms.sum(-1)
    width = b.shape[-1]
    # step 1/L, L = lambda_max(XtX) * 1.02 + a_l2 by power iteration
    v = torch.zeros((G, width), dtype=F64, device=dev)
    v[:, :K] = 1.0 / math.sqrt(K)
    floor = torch.tensor(1e-300, dtype=F64, device=dev)
    for _ in range(POWER_STEPS):
        v = matvec(v)
        v = v / torch.maximum(torch.sqrt(dot(v * v)), floor)[:, None]
    L = dot(v * matvec(v)) * 1.02 + a_l2 + 1e-300
    L1 = L[:, None]
    thr = (a_l1 / L)[:, None]
    l2 = a_l2[:, None]
    inner_tol = tol * INNER_TOL
    cap = ITER_FACTOR * max_iter
    w = torch.zeros((G, width), dtype=F64, device=dev)
    z = torch.zeros((G, width), dtype=F64, device=dev)
    t = torch.ones(G, dtype=F64, device=dev)
    its = torch.zeros(G, dtype=torch.int32, device=dev)
    delta = torch.full((G,), torch.inf, dtype=F64, device=dev)
    running = (its < cap) & (delta >= inner_tol)
    while bool(running.any()):  # host sync
        grad = matvec(z) - b + l2 * z
        w_new = _soft_threshold(z - grad / L1, thr, positive)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        dw = w_new - w
        z_new = w_new + ((t - 1.0) / t_new)[:, None] * dw
        # adaptive restart (O'Donoghue-Candes gradient scheme) and the
        # step norm, both sums in one
        restart_dot, sq = dot(torch.stack([(z - w_new) * dw, dw * dw])).unbind(0)
        restart = restart_dot > 0.0
        z_new = torch.where(restart[:, None], w_new, z_new)
        t_new = torch.where(restart, 1.0, t_new)
        run = running[:, None]
        w = torch.where(run, w_new, w)
        z = torch.where(run, z_new, z)
        t = torch.where(running, t_new, t)
        delta = torch.where(running, torch.sqrt(sq), delta)
        its = its + running.to(torch.int32)
        running = (its < cap) & (delta >= inner_tol)
    return w[:, :K].contiguous(), its


def _objective(XtX, Xty, a_l1, a_l2, w):
    """[G] covariance-form elastic-net objective, constant dropped."""
    Aw = (XtX * w[:, None, :]).sum(-1)
    return (
        0.5 * (w * Aw).sum(-1)
        - (Xty * w).sum(-1)
        + a_l1 * w.abs().sum(-1)
        + 0.5 * a_l2 * (w * w).sum(-1)
    )


def active_set_polish(XtX, Xty, a_l1, a_l2, w, positive: bool):
    """Newton polish of the FISTA iterate ``w`` [G, K] on its support (the
    JAX engine's ``_active_set_polish``): on a fixed support A with signs
    s the optimum solves ``(XtX_AA + a_l2 I) w_A = Xty_A - a_l1 s_A``.
    Round 1 solves on w's support and zeroes a coordinate whose solved
    sign contradicts s; round 2 admits the zero coordinates whose KKT
    residual ``|Xty - XtX w - a_l2 w|`` exceeds a_l1 (with its sign) and
    solves again. The JAX engine runs round 2 under a scalar ``lax.cond``
    when any group of the batch shrank or violated; here both rounds run
    and the same batch-wide flag selects on the device (no host read). A
    monotone safeguard keeps a group's result only where its objective is
    no higher than the FISTA iterate's (a NaN objective keeps the iterate):
    in the underdetermined pure lasso (n << K, a_l2 = 0) the support's
    system is rank-deficient and its pseudo-solve need not be optimal.
    Host syncs: those of ``solve_psd`` (its fallback check), twice."""
    K = XtX.shape[-1]
    eye = torch.eye(K, dtype=F64, device=XtX.device)
    B = XtX + a_l2[:, None, None] * eye

    def solve_on_support(w):
        s = (w > 0.0).to(F64) if positive else torch.sign(w)
        m = s.abs()
        A = B * (m[:, :, None] * m[:, None, :])
        A = A + eye * (1.0 - m)[:, :, None]  # identity rows off the support
        rhs = (Xty - a_l1[:, None] * s) * m
        w_new = solve_psd(A, rhs)
        shrunk = (m > 0.0) & (s * w_new <= 0.0)
        return torch.where(shrunk, 0.0, w_new), shrunk.any()

    w_in = w
    w1, any_shrunk = solve_on_support(w)
    rho = Xty - (XtX * w1[:, None, :]).sum(-1) - a_l2[:, None] * w1
    pad = a_l1[:, None] * (1.0 + 1e-12)
    viol = (w1 == 0.0) & ((rho if positive else rho.abs()) > pad)
    w2, _ = solve_on_support(torch.where(viol, torch.sign(rho), w1))  # admitted with the KKT sign
    w = torch.where(any_shrunk | viol.any(), w2, w1)
    better = _objective(XtX, Xty, a_l1, a_l2, w) <= _objective(XtX, Xty, a_l1, a_l2, w_in)
    return torch.where(better[:, None], w, w_in)


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
    """Plain version of every route. Returns (w [G, K] f64, sweeps or, on
    the FISTA route, iterations [G] int32). Host sync: one per sweep or
    iteration."""
    _check(XtX, Xty, n_valid)
    args = (XtX, Xty, n_valid, alpha, l1_ratio, max_iter, tol, positive)
    K = XtX.shape[-1]
    if K <= MAX_K:
        return _cyclic_narrow_ref(*args, active_set)
    if active_set:
        return _cyclic_wide_ref(*args, active_set)
    w, its = fista_ref(*args)
    return active_set_polish(XtX, Xty, *_strengths(n_valid, alpha, l1_ratio), w, positive), its


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.pols_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _launch_narrow(XtX, Xty, n_valid, alpha, l1_ratio, max_iter, tol, positive, active_set):
    global cd_kernel_launches
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
    _raise_on(lib, rc, "coordinate-descent")
    cd_kernel_launches += 1
    return w, sweeps


def launch_wide(XtX, Xty, n_valid, alpha, l1_ratio, max_iter, tol, positive, active_set, fista):
    """One launch of a ``csrc/cd_wide.cu`` kernel: FISTA (w before the
    polish, iterations) or the wide cyclic form (w, sweeps), without
    synchronising."""
    global fista_kernel_launches, cyclic_wide_kernel_launches
    G, K = Xty.shape
    if K > MAX_WIDE_K:
        raise ValueError(f"K={K} features: the wide coordinate-descent kernels take K <= {MAX_WIDE_K}")
    w = torch.empty((G, K), dtype=F64, device=XtX.device)
    counts = torch.empty(G, dtype=torch.int32, device=XtX.device)
    lib = _wide_kernel()
    head = (XtX.data_ptr(), Xty.data_ptr(), n_valid.data_ptr(), G, K,
            float(alpha), float(l1_ratio), 1.0 - float(l1_ratio), int(max_iter), float(tol),
            int(bool(positive)))
    with torch.cuda.device(XtX.device):
        per = wide_plan(G, K, fista).work
        work = torch.empty((G * per,), dtype=F64, device=XtX.device) if per else None
        tail = (None if work is None else work.data_ptr(), w.data_ptr(), counts.data_ptr())
        stream = torch.cuda.current_stream(XtX.device).cuda_stream
        if fista:
            rc = lib.pols_cd_fista(*head, *tail, stream)
        else:
            rc = lib.pols_cd_cyclic_wide(*head, int(bool(active_set)), *tail, stream)
    _raise_on(lib, rc, "FISTA" if fista else "wide cyclic coordinate-descent")
    if fista:
        fista_kernel_launches += 1
    else:
        cyclic_wide_kernel_launches += 1
    return w, counts


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
    """Per-group elastic-net coefficients (w [G, K] f64, sweeps or FISTA
    iterations [G] int32) from the moments XtX [G, K, K], Xty [G, K] and
    valid-row counts n_valid [G] (contiguous f64), by the route K and
    ``active_set`` pick."""
    _check(XtX, Xty, n_valid)
    if XtX.device.type == "cpu":
        return solve_elastic_net_cov_ref(
            XtX, Xty, n_valid, alpha, l1_ratio, max_iter, tol, positive, active_set
        )
    if XtX.device.type != "cuda":
        raise ValueError(f"no coordinate-descent kernel for device {XtX.device}")
    args = (XtX, Xty, n_valid, alpha, l1_ratio, max_iter, tol, positive, active_set)
    K = XtX.shape[-1]
    if K <= MAX_K:
        return _launch_narrow(*args)
    if active_set:
        return launch_wide(*args, fista=False)
    w, its = launch_wide(*args, fista=True)
    return active_set_polish(XtX, Xty, *_strengths(n_valid, alpha, l1_ratio), w, positive), its


def solve_elastic_net(
    Xp: torch.Tensor,  # [G, R, K] padded groups (masked rows zeroed)
    yp: torch.Tensor,  # [G, R]
    n_valid: torch.Tensor,  # [G]
    alpha: float,
    l1_ratio: float = 0.5,
    max_iter: int = 1000,
    tol: float = 1e-5,
    positive: bool = False,
) -> torch.Tensor:
    """Batched elastic-net fit of whole groups -> coefficients [G, K]: each
    group's moments (one block a group, ops/moments.py: csrc/moments.cu on
    the card), then ``solve_elastic_net_cov`` (csrc/cd.cu or cd_wide.cu)."""
    G, R, K = Xp.shape
    Z = torch.cat([yp.to(F64)[..., None], Xp.to(F64)], dim=2).contiguous()
    wp = torch.ones((G, R), dtype=torch.bool, device=Xp.device)
    offsets = torch.arange(G + 1, dtype=torch.int64, device=Xp.device)
    M, _ = grouped_moments_blocks(Z, wp, offsets, G)
    w, _ = solve_elastic_net_cov(
        M[:, 1:, 1:].contiguous(), M[:, 1:, 0].contiguous(), n_valid.to(F64).contiguous(), alpha,
        l1_ratio, max_iter, tol, positive,
    )
    return w
