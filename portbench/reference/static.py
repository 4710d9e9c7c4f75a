"""Plain per-group static least squares: the benchmark's reference for the
static fits, in NumPy.

Each function fits one group's rows from the inputs the benchmark made
(never from anything the program computed) in the dtype it is given:
float64 is the reference, float32 its lower-precision control.
"""

from __future__ import annotations

import numpy as np


def lstsq(X: np.ndarray, Y: np.ndarray, dtype=np.float64) -> np.ndarray:
    """The minimum-norm least-squares coefficients of ``Y`` ([n] or [n, M])
    on ``X`` [n, K] (LAPACK's SVD solver, numpy's default cutoff)."""
    return np.linalg.lstsq(X.astype(dtype), Y.astype(dtype), rcond=None)[0]


def ridge(X: np.ndarray, y: np.ndarray, alpha: float, dtype=np.float64) -> np.ndarray:
    """argmin_b |y - X b|^2 + alpha |b|^2, as the least-squares solution of
    X stacked over sqrt(alpha) I (no normal equations: their condition is
    the square of X's)."""
    K = X.shape[1]
    Xa = np.concatenate([X, np.sqrt(alpha) * np.eye(K)], axis=0)
    ya = np.concatenate([y, np.zeros(K)])
    return lstsq(Xa, ya, dtype)


def predictions(fit: dict, X: np.ndarray, Y: np.ndarray, dtype=np.float64) -> np.ndarray:
    """One group's in-sample predictions [n] (or [n, M] for several
    targets) of the static fit ``fit`` (a mix file's entry)."""
    kind = fit["fit"]
    kwargs = fit.get("kwargs", {})
    if kind == "ridge":
        beta = ridge(X, Y, float(kwargs["alpha"]), dtype)
    elif kind in ("ols", "multi_target_ols"):
        beta = lstsq(X, Y, dtype)
    else:
        raise ValueError(f"no static reference for fit {kind!r}")
    return X.astype(dtype) @ beta
