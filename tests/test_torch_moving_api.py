"""The moving models through both engines' public API.

``rls``, ``rolling_ols`` and ``expanding_ols`` on the same numpy-seeded
frame (7 groups of unequal sizes, ~4 % nulls drawn independently per column
in 4 of them; row 0 valid, see tests/test_torch_static.py) through the JAX
engine and the PyTorch port: every mode x every null policy x grouped /
ungrouped, weighted and with an intercept. Values rtol 1e-7 / atol 1e-9
(the moving solvers' tolerance, tests/test_torch_moving.py) where both are
valid, and identical validity. Rolling windows are compared as numbers
from the row on where they hold K + 3 valid rows (a window with fewer rows
than features is singular, and round-off decides its branch in both
engines); the validity is compared on every row.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import polars_ols_tpu as pj  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.ops import moving  # noqa: E402

TOL = dict(rtol=1e-7, atol=1e-9)
N, K, G = 1_400, 3, 7
POLICIES = ["ignore", "zero", "drop", "drop_zero", "drop_y_zero_x", "drop_window"]
MODES = ["predictions", "residuals", "coefficients"]
WINDOW = 25
FEATURES = [f"x{i + 1}" for i in range(K)]


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _data(seed: int = 0, nulls: bool = True, k: int = K):
    rng = np.random.default_rng(seed)
    p = np.linspace(1.0, 4.0, G) ** 2
    gids = rng.choice(G, size=N, p=p / p.sum())
    X = rng.normal(size=(N, k)) * np.resize([1.0, 4.0, 0.25], k)
    y = X @ np.linspace(1.0, -0.5, k) + rng.normal(size=N) * 0.1
    valid = np.ones((N, 1 + k), dtype=bool)
    if nulls:
        valid = rng.random((N, 1 + k)) > 0.04
        valid[gids % 2 == 0] = True
        valid[0] = True
    return dict(y=y, X=X, valid=valid, gids=gids, w=rng.random(N) + 0.1, nulls=nulls)


def _frame(mod, d):
    v = d["valid"]
    mask = (lambda j: v[:, j]) if d["nulls"] else (lambda j: None)
    cols = {"y": mod.Series("y", d["y"], mask(0))}
    for i in range(d["X"].shape[1]):
        cols[f"x{i + 1}"] = mod.Series(f"x{i + 1}", d["X"][:, i], mask(1 + i))
    cols["w"] = d["w"]
    cols["g"] = d["gids"].astype(float)
    return mod.DataFrame(cols)


def _expr(mod, model: str, grouped: bool, features=FEATURES, **kw):
    ns = mod.col("y").least_squares
    if model == "rolling_ols":
        kw.setdefault("window_size", WINDOW)
    e = getattr(ns, model)(*features, **kw)
    return e.over("g") if grouped else e


def _arrays(s):
    vals = np.asarray(s.values.cpu() if isinstance(s.values, torch.Tensor) else s.values)
    valid = s.validity
    if valid is None:
        valid = np.ones(vals.shape, dtype=bool)
    valid = np.asarray(valid.cpu() if isinstance(valid, torch.Tensor) else valid)
    return vals, valid


def _both(d, model, grouped, **kw):
    column = "coefficients" if kw.get("mode") == "coefficients" else "y"
    t = _frame(pt, d).select(_expr(pt, model, grouped, **kw))[column]
    j = _frame(pj, d).select(_expr(pj, model, grouped, **kw))[column]
    return _arrays(t), _arrays(j)


def _fit_rows(d, policy):
    """Rows that enter the fit under a moving model's null policy."""
    v = d["valid"]
    if policy in ("ignore", "zero"):
        return np.ones(N, dtype=bool)
    return v[:, 0] if policy == "drop_y_zero_x" else v.all(axis=1)


def _settled(d, policy, grouped, need):
    """Rows from which on the group has seen ``need`` fit rows."""
    fit = _fit_rows(d, policy).astype(np.int64)
    if not grouped:
        return np.cumsum(fit) >= need
    out = np.zeros(N, dtype=bool)
    for g in range(G):
        m = d["gids"] == g
        out[m] = np.cumsum(fit[m]) >= need
    return out


def _assert_same(t, j, settled=None):
    (tv, tm), (jv, jm) = t, j
    assert tv.shape == jv.shape and tv.dtype == np.float64
    np.testing.assert_array_equal(tm, jm)  # nulls exactly where the JAX engine has them
    m = tm if settled is None else tm & (settled[:, None] if tv.ndim == 2 else settled)
    assert m.any()
    np.testing.assert_allclose(tv[m], jv[m], **TOL)


# --------------------------------------------------------------------------- #
# every mode x every policy x grouping
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("grouped", [True, False], ids=["over", "single"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", POLICIES)
def test_rls_matches_jax(policy, mode, grouped):
    d = _data()
    t, j = _both(d, "rls", grouped, mode=mode, null_policy=policy, half_life=20.0)
    _assert_same(t, j)


@pytest.mark.parametrize("grouped", [True, False], ids=["over", "single"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", POLICIES)
def test_rolling_matches_jax(policy, mode, grouped):
    d = _data()
    t, j = _both(d, "rolling_ols", grouped, mode=mode, null_policy=policy)
    _assert_same(t, j, _settled(d, policy, grouped, K + 3 + 2))
    if mode != "coefficients":  # warm-up rows are null
        assert not t[1][:2].any()


@pytest.mark.parametrize("grouped", [True, False], ids=["over", "single"])
@pytest.mark.parametrize("mode", MODES)
def test_expanding_matches_jax(mode, grouped):
    d = _data()
    t, j = _both(d, "expanding_ols", grouped, mode=mode)
    _assert_same(t, j)


@pytest.mark.parametrize("model", ["rls", "rolling_ols", "expanding_ols"])
@pytest.mark.parametrize("mode", MODES)
def test_weighted_with_intercept_matches_jax(model, mode):
    d = _data(seed=1)
    t, j = _both(d, model, True, mode=mode, sample_weights="w", add_intercept=True)
    settled = _settled(d, "drop", True, K + 1 + 3 + 2) if model == "rolling_ols" else None
    _assert_same(t, j, settled)
    if mode == "coefficients":
        assert t[0].shape == (N, K + 1)  # the intercept is a coefficient


@pytest.mark.parametrize("kw", [
    dict(window_size=10, min_periods=2, alpha=0.1),
    dict(window_size=10, min_periods=10),
    dict(window_size=60, null_policy="drop_window", min_periods=4),
    dict(window_size=5, null_policy="drop_window", alpha=0.05),
], ids=["ridge-mp2", "mp-window", "positional-mp4", "positional-ridge"])
def test_rolling_options_match_jax(kw):
    d = _data(seed=2)
    t, j = _both(d, "rolling_ols", True, mode="coefficients", **kw)
    policy = kw.get("null_policy", "drop")
    settled = None if kw.get("alpha") else _settled(d, policy, True, K + 3 + 2)
    if kw.get("window_size") == 10 and not kw.get("alpha"):
        # a window of 10 rows holds K + 3 fit rows only where few are null
        fit = _fit_rows(d, policy)
        settled = settled & np.isin(d["gids"], [g for g in range(G) if fit[d["gids"] == g].all()])
    _assert_same(t, j, settled)


# --------------------------------------------------------------------------- #
# semantics
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mean", [0.5, [0.5, -1.0, 2.0]], ids=["scalar", "list"])
def test_initial_state_mean_reaches_the_coefficients_only(mean):
    d = _data(seed=3)
    kw = dict(half_life=30.0, initial_state_mean=mean)
    t, j = _both(d, "rls", True, mode="coefficients", **kw)
    _assert_same(t, j)
    plain, _ = _both(d, "rls", True, mode="coefficients", half_life=30.0)
    assert np.abs(t[0] - plain[0]).max() > 1e-3  # the prior mean matters there
    for mode in ("predictions", "residuals"):  # ... and is dropped here
        with_mean, j_mean = _both(d, "rls", True, mode=mode, **kw)
        without, _ = _both(d, "rls", True, mode=mode, half_life=30.0)
        _assert_same(with_mean, j_mean)
        np.testing.assert_array_equal(with_mean[0], without[0])


@pytest.mark.parametrize("mode", MODES)
def test_expanding_is_rls_without_forgetting(mode):
    df = _frame(pt, _data(seed=4))
    column = "coefficients" if mode == "coefficients" else "y"
    a = df.select(_expr(pt, "expanding_ols", True, mode=mode))[column]
    b = df.select(_expr(pt, "rls", True, mode=mode, half_life=None))[column]
    np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())


@pytest.mark.parametrize("mode", MODES)
def test_drop_equals_drop_window_without_nulls(mode):
    d = _data(seed=5, nulls=False)
    a, ja = _both(d, "rolling_ols", True, mode=mode, null_policy="drop")
    b, _ = _both(d, "rolling_ols", True, mode=mode, null_policy="drop_window")
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0][a[1]], b[0][b[1]])
    _assert_same(a, ja, _settled(d, "drop", True, K + 3 + 2))


@pytest.mark.parametrize("policy", ["drop", "drop_window"])
def test_min_periods_beyond_the_data_gives_all_nulls(policy):
    d = _data(seed=6)
    kw = dict(window_size=5_000, min_periods=5_000, null_policy=policy)
    for mode in MODES:
        t, j = _both(d, "rolling_ols", True, mode=mode, **kw)
        assert not t[1].any() and not j[1].any()


def test_groups_shorter_than_min_periods_are_null():
    d = _data(seed=7)
    counts = np.bincount(d["gids"], minlength=G)
    mp = int(np.sort(counts)[2]) + 1  # three groups never reach it
    t, j = _both(d, "rolling_ols", True, mode="predictions", window_size=2_000, min_periods=mp,
                 null_policy="drop_window")
    np.testing.assert_array_equal(t[1], j[1])
    short = np.isin(d["gids"], np.flatnonzero(counts < mp))
    assert not t[1][short].any() and t[1][~short].any()


def test_predictions_are_lazy_under_over_and_f64():
    df = _frame(pt, _data(seed=8))
    s = df.select(_expr(pt, "rls", True, half_life=20.0))["y"]
    assert s.is_lazy and s.values.dtype == torch.float64
    CONFIG.lazy_row_order = False
    try:
        m = df.select(_expr(pt, "rls", True, half_life=20.0))["y"]
    finally:
        CONFIG.lazy_row_order = True
    assert not m.is_lazy
    np.testing.assert_array_equal(s.to_numpy(), m.to_numpy())


def test_the_cpu_path_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(moving, "moving_kernel_launches", 0)
    df = _frame(pt, _data(seed=9))
    df.select(_expr(pt, "rolling_ols", True))["y"].to_numpy()
    df.select(_expr(pt, "rls", False))["y"].to_numpy()
    assert moving.moving_kernel_launches == 0


def test_regex_features_and_the_struct_fields():
    df = _frame(pt, _data(seed=10))
    c = df.select(pt.col("y").least_squares.rolling_ols(pt.col("^x.*$"), window_size=30, mode="coefficients"))
    s = c["coefficients"]
    assert s.field_names == FEATURES
    vals, valid = _arrays(s)
    assert not valid[:2].any() and valid[-1].all()  # NaN warm-up rows are null fields


# --------------------------------------------------------------------------- #
# what is refused
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("model", ["rls", "rolling_ols", "expanding_ols"])
def test_statistics_mode_is_refused(model):
    with pytest.raises(ValueError, match="unknown mode 'statistics'"):
        _expr(pt, model, True, mode="statistics")
    with pytest.raises(AssertionError, match="unknown mode 'statistics'"):
        _expr(pj, model, True, mode="statistics")


@pytest.mark.parametrize("model", ["rls", "rolling_ols", "expanding_ols"])
def test_more_than_32_features_raise_item_12(model):
    d = _data(seed=11, nulls=False, k=33)
    feats = [f"x{i + 1}" for i in range(33)]
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 12"):
        _frame(pt, d).select(_expr(pt, model, True, features=feats))


def test_an_unknown_policy_is_refused_and_static_fits_refuse_drop_window():
    with pytest.raises(ValueError, match="unknown null_policy"):
        pt.col("y").least_squares.rls("x1", null_policy="skip")
    with pytest.raises(ValueError, match="static fit"):
        pt.col("y").least_squares.ols("x1", null_policy="drop_window")
    assert pt.RollingKwargs().null_policy == "drop_window"
    assert pt.RollingKwargs().window_size == 1_000_000
    assert pt.RLSKwargs().null_policy == "drop"
    assert pt.RLSKwargs().initial_state_covariance == 10.0
