"""Two-sided Student-t p-values through the regularized incomplete beta.

``p = I_x(dof/2, 1/2)`` with ``x = dof / (dof + t^2)``: the JAX engine's
``ops/linalg.py:t_two_sided_p_value``, which calls
``jax.scipy.special.betainc``. torch has no incomplete beta, so
``betainc_half_ref`` computes ``I_x(a, 1/2)`` itself:

- ``a >= 15`` and ``-log x <= 1`` (every t-test with more than 30 degrees
  of freedom and ``t^2 < 1.7 dof``): the large-``a`` expansion of
  DiDonato and Morris (ACM TOMS 708, ``bgrat``). With ``T = a - 1/4`` and
  ``z = -T log x``, ``I_x(a, 1/2) = Gamma(a+1/2) / (Gamma(a) sqrt(T)) *
  sum_n c_n Gamma(1/2 + 2n, z) / (sqrt(pi) T^2n)``, where ``c_n`` are the
  Taylor coefficients of ``(sinh(w/2) / (w/2))^(-1/2)`` in ``w^2`` and the
  upper incomplete gammas come from ``erfc(sqrt(z))`` by their recurrence.
  The continued fraction below loses ``~a * eps`` near ``x = 1`` (its
  terms cancel like ``1 - x``): 1e-10 relative at a million degrees of
  freedom, where this expansion keeps ~1e-13.
- otherwise: the continued fraction of DLMF 8.17.22 by the forward
  recurrence of its convergents (no division inside the loop), with the
  symmetry ``I_x(a, b) = 1 - I_{1-x}(b, a)`` where ``x > (a+1)/(a+b+2)``.
  It converges in at most ~25 iterations over this region (checked against
  mpmath for ``a`` from 0.5 to 4e6); the cap is 200.

``log B(a, 1/2)`` takes ``lgamma(a + 1/2) - lgamma(a)`` from the Stirling
series for ``a >= 8`` (the plain difference of two ``lgamma`` loses their
magnitude's rounding, ~1e-8 relative at a = 4e6).

Edge values follow jnp's ``betainc``: NaN where ``a < 0``, ``x`` is
outside [0, 1] or either is NaN; 1 where ``a == 0 < x``; 0 where
``a == x == 0``. So a negative or NaN dof, or a NaN t, gives NaN, and
``t = 0`` gives 1.

On a CUDA tensor ``t_two_sided_p_value`` always launches the hand-written
kernel ``csrc/t_pvalue.cu`` (one thread per element, the same arithmetic)
and counts the launch in ``t_pvalue_kernel_launches``; a failed build or
launch raises. On a CPU tensor it runs ``t_two_sided_p_value_ref``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..config import F64
from . import kernels

# kernel launches made by t_two_sided_p_value since the last reset
t_pvalue_kernel_launches = 0

_EPS = 2.0**-52
_CF_BIG = 2.0**200  # the continued fraction's convergents are rescaled past this
CF_MAX_ITER = 200
A_SERIES = 15.0  # the large-a expansion from this a ...
U_SERIES = 1.0  # ... while -log x stays below this
# Taylor coefficients of (sinh(w/2) / (w/2))^(-1/2) in w^2 (mpmath, 60
# digits, rounded); the same literals are in csrc/t_pvalue.cu
SERIES_COEFFS = (
    1.0,
    -0.020833333333333332,
    0.000390625,
    -7.879670965608466e-06,
    1.6967665791721782e-07,
    -3.805064191721906e-09,
    8.748377596315407e-11,
    -2.044523359411974e-12,
    4.833351797967704e-14,
    -1.152434101767386e-15,
    2.76605204359937e-17,
    -6.67428195089166e-19,
    1.61745507718158e-20,
    -3.93397792009138e-22,
    9.597634062586047e-24,
    -2.347690291162632e-25,
)
_LOG_SQRT_PI = 0.5 * math.log(math.pi)
_INV_SQRT_PI = 1.0 / math.sqrt(math.pi)
# continued-fraction iterations between the plain version's convergence checks (each
# check is a host sync)
_CHECK_EVERY = 8

_BOUND = None


def _kernel():
    global _BOUND
    if _BOUND is None:
        lib = kernels.load("t_pvalue")
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.pols_t_pvalue.argtypes = [vp, vp, i64, i64, vp, ctypes.c_int, vp]
        lib.pols_t_pvalue.restype = ctypes.c_int
        lib.pols_f64_chain.argtypes = [ctypes.c_int, i64, vp, vp]
        lib.pols_f64_chain.restype = ctypes.c_int
        lib.pols_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pols_cuda_error_string.restype = ctypes.c_char_p
        _BOUND = lib
    return _BOUND


def _stirling_tail(z: torch.Tensor) -> torch.Tensor:
    """sum_k B_2k / (2k (2k-1) z^(2k-1)), k = 1..7: lgamma's Stirling
    series after its leading terms."""
    z2 = 1.0 / (z * z)
    s = z2 * (1.0 / 156.0)
    for c in (-691.0 / 360360.0, 1.0 / 1188.0, -1.0 / 1680.0, 1.0 / 1260.0, -1.0 / 360.0):
        s = z2 * (c + s)
    return (1.0 / 12.0 + s) / z


def log_gamma_ratio_half(a: torch.Tensor) -> torch.Tensor:
    """``lgamma(a + 1/2) - lgamma(a)`` for a > 0: the plain difference below
    a = 8, the Stirling series above it."""
    small = a < 8.0
    a_big = torch.where(small, 8.0, a)
    big = (
        0.5 * torch.log(a_big) + a_big * torch.log1p(0.5 / a_big) - 0.5
        + (_stirling_tail(a_big + 0.5) - _stirling_tail(a_big))
    )
    a_small = torch.where(small, a, 1.0)
    return torch.where(small, torch.lgamma(a_small + 0.5) - torch.lgamma(a_small), big)


def _continued_fraction(p: torch.Tensor, q: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The continued fraction of I_z(p, q) (DLMF 8.17.22) by the forward
    recurrence of its convergents ``A_n / B_n`` (Wallis; Numerical Recipes'
    first ``betacf``): two multiply-adds a half step and one division at
    the end, where the modified Lentz form divides four times an
    iteration. An iteration ends a lane when its two half steps' convergents
    agree to eps, tested without dividing: ``|A_n B_{n-1} - A_{n-1} B_n| <=
    eps |A_{n-1} B_n|``; converged lanes keep their value. All four terms
    are rescaled by 2^-200 where ``|B_n|`` passes 2^200 (and back below
    2^-200), which changes no ratio."""
    qab, qap, qam = p + q, p + 1.0, p - 1.0
    one = torch.ones_like(z)
    am, bm, az = one, one, one
    bz = 1.0 - qab * z / qap
    live = torch.ones_like(z, dtype=torch.bool)
    for m in range(1, CF_MAX_ITER + 1):
        m2 = 2.0 * m
        aa = (m * (q - m)) / ((qam + m2) * (p + m2)) * z
        ap = az + aa * am
        bp = bz + aa * bm
        aa = -((p + m) * (qab + m)) / ((p + m2) * (qap + m2)) * z
        app = ap + aa * az
        bpp = bp + aa * bz
        scale = torch.where(
            bpp.abs() > _CF_BIG, one / _CF_BIG, torch.where(bpp.abs() < 1.0 / _CF_BIG, one * _CF_BIG, one)
        )
        am = torch.where(live, ap * scale, am)
        bm = torch.where(live, bp * scale, bm)
        az = torch.where(live, app * scale, az)
        bz = torch.where(live, bpp * scale, bz)
        live = live & ~((app * bp - ap * bpp).abs() <= _EPS * (ap * bpp).abs())
        if m % _CHECK_EVERY == 0 and not bool(live.any()):  # host sync
            break
    return az / bz


def _betainc_half_cf(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """I_x(a, 1/2) by the continued fraction, for 0 < a < inf, 0 < x < 1."""
    direct = x < (a + 1.0) / (a + 2.5)
    y = 1.0 - x
    p = torch.where(direct, a, 0.5)
    h = _continued_fraction(p, torch.where(direct, 0.5, a), torch.where(direct, x, y))
    # x^a y^(1/2) / (p B(a, 1/2))
    log_front = (
        a * torch.log(x) + 0.5 * torch.log1p(-x)
        + log_gamma_ratio_half(a) - _LOG_SQRT_PI - torch.log(p)
    )
    val = torch.exp(log_front) * h
    return torch.where(direct, val, 1.0 - val)


def _betainc_half_series(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """I_x(a, 1/2) by the large-a expansion, u = -log x in [0, 1]: the
    terms c_n Gamma(1/2 + 2n, z) / (sqrt(pi) T^2n), summed until one falls
    below eps of the sum."""
    T = a - 0.25
    z = T * u
    inv_T2, z2 = 1.0 / (T * T), z * z
    H = torch.special.erfc(torch.sqrt(z))  # Gamma(1/2, z) / sqrt(pi)
    E = torch.sqrt(z) * torch.exp(-z) * _INV_SQRT_PI  # z^(1/2) e^-z / sqrt(pi)
    s = H
    live = torch.ones_like(s, dtype=torch.bool)
    for n in range(1, len(SERIES_COEFFS)):
        sn = 2.0 * n - 1.5
        # two steps of Gamma(s+1, z) = s Gamma(s, z) + z^s e^-z, times 1 / T^2
        H = ((sn + 1.0) * sn * H + ((sn + 1.0) + z) * E) * inv_T2
        E = E * z2 * inv_T2
        term = SERIES_COEFFS[n] * H
        s = torch.where(live, s + term, s)
        live = live & ~(term.abs() <= _EPS * s.abs())
    return torch.exp(log_gamma_ratio_half(a) - 0.5 * torch.log(T)) * s


def betainc_half_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The regularized incomplete beta ``I_x(a, 1/2)``, elementwise over the
    broadcast of ``a`` and ``x`` (f64), with jnp's edge values."""
    a, x = torch.broadcast_tensors(torch.as_tensor(a, dtype=F64), torch.as_tensor(x, dtype=F64))
    nan = (a < 0) | (x < 0) | (x > 1) | torch.isnan(a) | torch.isnan(x)
    one = ((a == 0) & (x != 0)) | (torch.isinf(a) & (x == 1))
    zero = (torch.isinf(a) & (x != 1)) | ((a == 0) & (x == 0))
    edge = nan | one | zero | (x == 0) | (x == 1)
    a_in = torch.where(edge, 1.0, a)
    x_in = torch.where(edge, 0.5, x)
    u = -torch.log(x_in)
    series = (a_in >= A_SERIES) & (u <= U_SERIES)
    # each lane runs one branch; the other sees a harmless stand-in
    p_series = _betainc_half_series(torch.where(series, a_in, A_SERIES), torch.where(series, u, 0.5))
    p_cf = _betainc_half_cf(torch.where(series, 1.0, a_in), torch.where(series, 0.5, x_in))
    out = torch.where(series, p_series, p_cf)
    out = torch.where(x == 0, 0.0, torch.where(x == 1, 1.0, out))
    out = torch.where(zero, 0.0, out)
    out = torch.where(one, 1.0, out)
    return torch.where(nan, torch.nan, out)


def t_two_sided_p_value_ref(t: torch.Tensor, dof: torch.Tensor) -> torch.Tensor:
    """Plain version: ``I_x(dof/2, 1/2)``, ``x = dof / (dof + t^2)``, for
    t [G, K] and dof [G]."""
    d = dof[:, None]
    return betainc_half_ref(d / 2.0, d / (d + t * t))


def _check(t: torch.Tensor, dof: torch.Tensor) -> None:
    if t.dtype != F64 or t.dim() != 2:
        raise TypeError(f"t must be a [G, K] float64 tensor, got {t.dtype} {tuple(t.shape)}")
    if dof.dtype != F64 or tuple(dof.shape) != (t.shape[0],):
        raise TypeError(
            f"dof must be a [{t.shape[0]}] float64 tensor, got {dof.dtype} {tuple(dof.shape)}"
        )
    if t.device != dof.device:
        raise ValueError("t and dof must be on one device")
    if not (t.is_contiguous() and dof.is_contiguous()):
        raise ValueError("t and dof must be contiguous")


def _launch(t: torch.Tensor, dof: torch.Tensor, stage: int) -> torch.Tensor:
    G, K = t.shape
    p = torch.empty_like(t)
    lib = _kernel()
    with torch.cuda.device(t.device):
        rc = lib.pols_t_pvalue(
            t.data_ptr(), dof.data_ptr(), G, K, p.data_ptr(), stage,
            torch.cuda.current_stream(t.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.pols_cuda_error_string(rc).decode()
        raise RuntimeError(f"p-value kernel launch failed: CUDA error {rc} ({msg})")
    return p


def t_two_sided_p_value(t: torch.Tensor, dof: torch.Tensor) -> torch.Tensor:
    """Two-sided Student-t p-values [G, K] of t [G, K] f64 with degrees of
    freedom dof [G] f64 (one per row)."""
    global t_pvalue_kernel_launches
    _check(t, dof)
    if t.device.type == "cpu":
        return t_two_sided_p_value_ref(t, dof)
    if t.device.type != "cuda":
        raise ValueError(f"no p-value kernel for device {t.device}")
    p = _launch(t, dof, 0)
    t_pvalue_kernel_launches += 1
    return p


TIMING_STAGES = {"load_store": 1, "front": 2}


def t_pvalue_timing_stage(t: torch.Tensor, dof: torch.Tensor, stage: str) -> torch.Tensor:
    """A part of the kernel's work on CUDA tensors, for the timing breakdown
    only (the result is no p-value): ``load_store`` loads, forms x and
    stores; ``front`` adds the continued-fraction branch's front factor
    (log, log1p, the lgamma ratio, exp) without the fraction."""
    _check(t, dof)
    if t.device.type != "cuda":
        raise ValueError("the timing stages run on the card only")
    return _launch(t, dof, TIMING_STAGES[stage])


CHAIN_OPS = ("fma", "div", "sqrt", "log", "log1p", "exp", "erfc", "rcp", "rsqrt")


def f64_chain(n: int, seed: torch.Tensor, op: str = "fma") -> None:
    """Run ``n`` dependent f64 operations of kind ``op`` (one of
    ``CHAIN_OPS``) on one warp of the card, seeded from ``seed[0]`` (a CUDA
    f64 tensor holding a value in [0, 1]): the yardstick of the p-value
    and Jacobi SVD kernels' latency bounds (``rcp`` and ``rsqrt`` are the
    hardware's f64 estimates, ``rcp.approx`` / ``rsqrt.approx``). Every kind but ``fma`` carries one more
    dependent add or multiply a step. Nothing it computes is kept; two chain
    lengths timed against each other give the time of one step."""
    if seed.device.type != "cuda" or seed.dtype != F64 or seed.numel() < 1:
        raise ValueError("seed must be a CUDA float64 tensor of at least one element")
    lib = _kernel()
    with torch.cuda.device(seed.device):
        rc = lib.pols_f64_chain(
            CHAIN_OPS.index(op), int(n), seed.data_ptr(),
            torch.cuda.current_stream(seed.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.pols_cuda_error_string(rc).decode()
        raise RuntimeError(f"f64 chain launch failed: CUDA error {rc} ({msg})")
