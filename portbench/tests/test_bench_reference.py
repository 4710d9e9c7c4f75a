"""The plain reference against closed forms and numpy's lstsq at tiny sizes."""

import math

import numpy as np
import pytest

from portbench.reference import moving, static


def _data(n, k, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k))
    return X, X.sum(1) + 0.1 * rng.normal(size=n)


def test_static_fits_equal_numpy_lstsq():
    X, y = _data(50, 4)
    beta = np.linalg.lstsq(X, y, rcond=None)[0]
    np.testing.assert_allclose(static.predictions({"fit": "ols"}, X, y), X @ beta, rtol=1e-12, atol=1e-12)
    ridge = np.linalg.solve(X.T @ X + 2.5 * np.eye(4), X.T @ y)
    got = static.predictions({"fit": "ridge", "kwargs": {"alpha": 2.5}}, X, y)
    np.testing.assert_allclose(got, X @ ridge, rtol=1e-11, atol=1e-12)


def test_multi_target_is_one_lstsq_a_target():
    X, y = _data(40, 3, seed=1)
    y2 = X @ [1.0, -2.0, 0.5] + 0.01
    got = static.predictions({"fit": "multi_target_ols"}, X, np.stack([y, y2], 1))
    for j, t in enumerate((y, y2)):
        np.testing.assert_allclose(got[:, j], X @ np.linalg.lstsq(X, t, rcond=None)[0], rtol=1e-12, atol=1e-12)


def test_float32_reference_is_float32():
    X, y = _data(30, 3, seed=2)
    assert static.predictions({"fit": "ols"}, X, y, np.float32).dtype == np.float32


def test_rls_is_the_discounted_ridge_closed_form():
    """coef_t = M_t^-1 b_t with M_0 = I / c, M_t = lam M_{t-1} + x x',
    b_t = lam b_{t-1} + x y: the Kalman recursion's closed form."""
    groups = [_data(35, 3, seed=s) for s in (3, 4)]
    groups[1] = (groups[1][0][:20], groups[1][1][:20])  # groups of different lengths run side by side
    got = moving.rls(groups, half_life=10.0, c=10.0)
    lam = math.exp(math.log(0.5) / 10.0)
    for (X, y), p in zip(groups, got):
        M, b = np.eye(3) / 10.0, np.zeros(3)
        for t in range(len(y)):
            M = lam * M + np.outer(X[t], X[t])
            b = lam * b + X[t] * y[t]
            assert p[t] == pytest.approx(X[t] @ np.linalg.solve(M, b), rel=1e-10, abs=1e-12)


def test_rolling_is_lstsq_a_window():
    X, y = _data(40, 3, seed=5)
    got = moving.rolling(X, y, window=9, min_periods=4)
    assert np.isnan(got[:3]).all()
    for i in range(3, 40):
        lo = max(0, i - 8)
        beta = np.linalg.lstsq(X[lo:i + 1], y[lo:i + 1], rcond=None)[0]
        assert got[i] == pytest.approx(X[i] @ beta, rel=1e-10, abs=1e-12)


def test_rolling_refuses_windows_narrower_than_the_features():
    X, y = _data(10, 3)
    with pytest.raises(ValueError):
        moving.rolling(X, y, window=5, min_periods=2)
