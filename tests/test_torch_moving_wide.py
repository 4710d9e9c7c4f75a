"""The moving models above K = 32 features: the PyTorch port against the
JAX engine and against the JAX suite's own oracles.

Above 32 features the JAX engine leaves the exact moments: its classic
paths propagate a Sherman-Morrison inverse (``ops/recursive.py:
_rls_sm_single``, ``ops/rolling.py:_windowed_sm_scan``), and for rolling at
``alpha = 0`` a diffuse ridge of 1e-10 of the data's scale stands in for the
warm-up inversion. The port keeps the exact f64 moments and solves every
refresh row from them at any K. So the two engines are held to each other
at the JAX suite's own tolerances for those paths
(``tests/test_largek_moving.py``: the Kalman oracle rtol 1e-8 / atol 1e-10
at :48, long-history RLS rtol 2e-7 / atol 2e-8 at :201, grouped rolling
2e-5 at :146, the ridge-exact rolling 1e-8 at :74), with identical nulls;
and the port alone to the oracles themselves (a literal Kalman recursion,
a numpy solve per window) at its own tolerance, rtol 1e-9 / atol 1e-11.
Rolling windows at ``alpha = 0`` are compared as numbers where they hold
2 K fit rows (JAX's ridge is relative to the data's scale, and a window of
about K rows amplifies it by its condition number); their nulls on every
row. A window made singular by duplicated rows is held to numpy ``lstsq``
per window: the port re-solves every window from exact moments, so it
recovers once the duplicates have left, as the reference's exact path
does (the JAX engine's propagated inverse notes that it cannot,
``ops/rolling.py:_windowed_sm_scan``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import polars_ols_tpu as pj  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.ops import moving  # noqa: E402

KALMAN_TOL = dict(rtol=1e-8, atol=1e-10)
LONG_RLS_TOL = dict(rtol=2e-7, atol=2e-8)
ROLLING_TOL = dict(rtol=2e-5, atol=2e-5)
RIDGE_TOL = dict(rtol=1e-8, atol=1e-8)
TIGHT = dict(rtol=1e-9, atol=1e-11)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _data(k: int, sizes, seed: int, nulls: bool):
    """Groups of ``sizes`` rows (interleaved), k features of unequal scale,
    ~3 % nulls per column in the odd-numbered groups (row 0 valid)."""
    rng = np.random.default_rng(seed)
    gids = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    n = len(gids)
    X = rng.normal(size=(n, k)) * np.resize([1.0, 2.0, 0.5], k)
    y = X @ np.linspace(1.0, -0.5, k) + rng.normal(size=n) * 0.1
    valid = np.ones((n, 1 + k), dtype=bool)
    if nulls:
        valid = rng.random((n, 1 + k)) > 0.03
        valid[gids % 2 == 0] = True
        valid[0] = True
    return dict(y=y, X=X, valid=valid, gids=gids, w=rng.random(n) + 0.1, nulls=nulls)


def _frame(mod, d):
    v = d["valid"]
    mask = (lambda j: v[:, j]) if d["nulls"] else (lambda j: None)
    cols = {"y": mod.Series("y", d["y"], mask(0))}
    for i in range(d["X"].shape[1]):
        cols[f"x{i}"] = mod.Series(f"x{i}", d["X"][:, i], mask(1 + i))
    cols["w"] = d["w"]
    cols["g"] = d["gids"].astype(float)
    return mod.DataFrame(cols)


def _arrays(s):
    vals = np.asarray(s.values.cpu() if isinstance(s.values, torch.Tensor) else s.values)
    valid = s.validity
    valid = np.ones(vals.shape, dtype=bool) if valid is None else np.asarray(
        valid.cpu() if isinstance(valid, torch.Tensor) else valid
    )
    return vals, valid


def _fit_rows(d, policy):
    v = d["valid"]
    if policy in ("ignore", "zero"):
        return np.ones(len(d["y"]), dtype=bool)
    return v[:, 0] if policy == "drop_y_zero_x" else v.all(axis=1)


def _window_fill(d, policy, grouped, window):
    """Fit rows in each row's window (the whole history without one)."""
    fit = _fit_rows(d, policy).astype(np.int64)
    groups = d["gids"] if grouped else np.zeros(len(fit), dtype=np.int64)
    out = np.zeros(len(fit), dtype=np.int64)
    for g in np.unique(groups):
        m = np.flatnonzero(groups == g)
        c = np.cumsum(fit[m])
        if window is not None:
            if policy == "drop_window":
                c = c - np.concatenate([np.zeros(window, dtype=np.int64), c])[: len(m)]
            else:
                c = np.minimum(c, window)
        out[m] = c
    return out


# id: (model, K, group sizes, null policy, grouped, mode, model kwargs)
API_CASES = {
    "rls_k33_drop_over": ("rls", 33, [150, 90, 200], "drop", True, "predictions", dict(half_life=60.0)),
    "rls_k40_mean_coefficients": (
        "rls", 40, [400], "drop", False, "coefficients", dict(initial_state_mean=0.25),
    ),
    "rls_k64_zero_over_residuals": (
        "rls", 64, [120, 300, 80, 60, 40], "zero", True, "residuals", dict(half_life=252.0),
    ),
    "rls_k40_long_history": ("rls", 40, [600, 250], "drop", True, "predictions", dict(half_life=252.0)),
    "expanding_k40_drop_y_zero_x": (
        "expanding_ols", 40, [300, 180], "drop_y_zero_x", True, "coefficients", {},
    ),
    "rolling_k40_drop_window": (
        "rolling_ols", 40, [400, 260, 140], "drop_window", True, "predictions", dict(window_size=120),
    ),
    "rolling_k33_drop_min_periods": (
        "rolling_ols", 33, [300, 200], "drop", True, "coefficients", dict(window_size=100, min_periods=50),
    ),
    "rolling_k64_ridge_ignore": (
        "rolling_ols", 64, [500], "ignore", False, "predictions", dict(window_size=150, alpha=0.5),
    ),
    "rolling_k40_ridge_drop_zero": (
        "rolling_ols", 40, [350, 150], "drop_zero", True, "residuals", dict(window_size=90, alpha=0.1),
    ),
    "rolling_k100_single": (
        "rolling_ols", 100, [600], "drop", False, "coefficients", dict(window_size=300, alpha=0.1),
    ),
}


@pytest.mark.parametrize("case", list(API_CASES))
def test_moving_models_above_32_match_jax(case):
    model, k, sizes, policy, grouped, mode, kw = API_CASES[case]
    d = _data(k, sizes, seed=len(case) + k, nulls=policy not in ("ignore",))
    feats = [f"x{i}" for i in range(k)]
    if "initial_state_mean" in kw:
        kw = dict(kw, initial_state_mean=list(np.linspace(-kw["initial_state_mean"], kw["initial_state_mean"], k)))
    out = []
    for mod in (pt, pj):
        e = getattr(mod.col("y").least_squares, model)(*feats, mode=mode, null_policy=policy, **kw)
        s = _frame(mod, d).select(e.over("g") if grouped else e)
        out.append(_arrays(s["coefficients" if mode == "coefficients" else "y"]))
    (tv, tm), (jv, jm) = out
    assert tv.shape == jv.shape
    np.testing.assert_array_equal(tm, jm)
    if model == "rolling_ols":
        tol = RIDGE_TOL if kw.get("alpha", 0.0) > 0 else ROLLING_TOL
        need = k + 3 if kw.get("alpha", 0.0) > 0 else 2 * k
        settled = _window_fill(d, policy, grouped, kw["window_size"]) >= need
    else:
        # the Kalman oracle's tolerance up to 400 rows a group, the long history's beyond
        tol = KALMAN_TOL if max(sizes) <= 400 else LONG_RLS_TOL
        settled = np.ones(len(d["y"]), dtype=bool)
    m = tm & (settled[:, None] if tv.ndim == 2 else settled)
    assert m.sum() > len(d["y"]) // 4
    np.testing.assert_allclose(tv[m], jv[m], **tol)


def _kalman(X, y, v, ff, c=10.0):
    """tests/test_largek_moving.py:_kalman_oracle."""
    K = X.shape[1]
    P, coef = np.eye(K) * c, np.zeros(K)
    out = np.zeros_like(X)
    for t in range(len(y)):
        if v[t]:
            Px = P @ X[t]
            r = 1.0 + X[t] @ Px / ff
            g = Px / (r * ff)
            coef = coef + g * (y[t] - X[t] @ coef)
            P = P / ff - np.outer(g, g) * r
        out[t] = coef
    return out


def _padded(groups, k):
    """(Zp, vp, rows) of groups [(X, y, v)] padded to the longest."""
    R = max(len(y) for _, y, _ in groups)
    Zp = np.zeros((len(groups), R, 1 + k))
    vp = np.zeros((len(groups), R), dtype=bool)
    for g, (X, y, v) in enumerate(groups):
        Zp[g, : len(y), 0], Zp[g, : len(y), 1:], vp[g, : len(y)] = y, X, v
    rows = torch.as_tensor([len(y) for _, y, _ in groups], dtype=torch.int64)
    return torch.as_tensor(Zp), torch.as_tensor(vp), rows


@pytest.mark.parametrize("k,half_life", [(33, 60.0), (40, None), (64, 252.0)])
def test_rls_above_32_matches_the_kalman_oracle_tightly(k, half_life):
    # the JAX suite's oracle (test_largek_moving.py:19), at the port's own
    # tolerance, on groups of unequal length with invalid rows; ranges
    # forced small (a no-op for the plain version on the CPU, the kernel's
    # summary pass, prefix and fill on the card)
    rng = np.random.default_rng(k)
    groups = []
    for n in (400, 150, 37):
        X = rng.normal(size=(n, k))
        groups.append((X, X @ rng.normal(size=k) + rng.normal(size=n) * 0.1, rng.random(n) > 0.1))
    Zp, vp, rows = _padded(groups, k)
    out = moving.recursive_least_squares(Zp, vp, rows, half_life, 10.0, want="coefficients", chunk=32).numpy()
    ff = np.exp(np.log(0.5) / half_life) if half_life else 1.0
    for g, (X, y, v) in enumerate(groups):
        np.testing.assert_allclose(out[g, : len(y)], _kalman(X, y, v, ff), **TIGHT)


@pytest.mark.parametrize("k,alpha,positional", [(40, 0.5, True), (40, 0.0, True), (64, 0.0, False)])
def test_rolling_above_32_matches_the_window_solve_tightly(k, alpha, positional):
    # the JAX suite's oracle (test_largek_moving.py:68, np.linalg.solve of
    # each window), at the port's own tolerance, with the null pattern of
    # the window semantics: NaN until min_periods valid rows
    rng = np.random.default_rng(100 + k)
    window, n = 120, 320
    X = rng.normal(size=(n, k))
    y = X @ rng.normal(size=k) + rng.normal(size=n) * 0.1
    v = rng.random(n) > 0.05
    Zp, vp, rows = _padded([(X, y, v)], k)
    out = moving.rolling_ols(Zp, vp, rows, window, None, alpha, positional, want="coefficients", chunk=64)
    out = out.numpy()[0]
    valid_rows = np.flatnonzero(v)
    for t in range(n):
        if positional:
            members = valid_rows[(valid_rows > t - window) & (valid_rows <= t)]
            defined = len(members) >= k
        else:
            members = valid_rows[valid_rows <= t][-window:]
            defined = v[t] and len(members) >= k
        if not defined:
            continue  # carried or NaN: the pattern is checked below
        if len(members) < k + 3 and alpha == 0.0:
            continue
        Xw, yw = X[members], y[members]
        beta = np.linalg.solve(Xw.T @ Xw + alpha * np.eye(k), Xw.T @ yw)
        np.testing.assert_allclose(out[t], beta, **TIGHT)
    first = valid_rows[k - 1]  # the k-th valid row: the first defined window
    assert np.isnan(out[:first]).all() and not np.isnan(out[first:]).any()


def test_rolling_recovers_after_a_singular_window_above_32():
    # rows 100..179 repeat 20 rows four times: every window of 60 rows inside
    # them has rank 20 < K = 40. The port's Cholesky fails there and the
    # minimum-norm solve takes over; once the block has slid out the exact
    # moments solve again. Held to numpy lstsq per window: the fitted
    # values inside the block, the coefficients once it has left.
    rng = np.random.default_rng(9)
    k, window, n = 40, 60, 320
    X = rng.normal(size=(n, k))
    X[100:180] = np.tile(X[100:120], (4, 1))
    y = X @ rng.normal(size=k) + rng.normal(size=n) * 0.1
    Zp, vp, rows = _padded([(X, y, np.ones(n, dtype=bool))], k)
    out = moving.rolling_ols(Zp, vp, rows, window, None, 0.0, True, want="coefficients").numpy()[0]
    assert not np.isnan(out[k - 1:]).any()
    for t in range(k - 1, n):
        lo = max(0, t - window + 1)
        Xw, yw = X[lo: t + 1], y[lo: t + 1]
        ref = np.linalg.lstsq(Xw, yw, rcond=None)[0]
        if np.linalg.matrix_rank(Xw) < k:
            np.testing.assert_allclose(Xw @ out[t], Xw @ ref, rtol=1e-6, atol=1e-8)
        elif t - window + 1 >= 180 or t < 100:
            np.testing.assert_allclose(out[t], ref, **TIGHT)
