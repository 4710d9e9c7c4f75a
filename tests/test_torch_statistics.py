"""Statistics (``mode="statistics"``) and the t-test p-values through both
engines.

The p-values are held to the JAX engine's
``polars_ols_tpu.ops.linalg.t_two_sided_p_value`` at rtol 1e-10 /
atol 1e-14 for dof <= 1000, and to ``scipy.special.betainc`` at rtol 1e-12
for dof up to 8e6 (JAX's own ``betainc`` drifts there: ~1e-8 relative at
dof 8e6), with jnp's edge values. ``residual_metrics`` /
``feature_metrics`` take the same arrays in both engines, with a non-PD
lane and ridge on and off. The public API runs on the same numpy-seeded
frames in both engines (13 groups of unequal sizes, ~3 % nulls per column
in 8 of them, a small ``moment_chunk_rows`` that splits heavy groups
across blocks): five policies x {ols, ridge, lasso}, WLS, every
``solve_method``, grouped and single, skewed group sizes and a group with
n == K (df 0). Every field at rtol 1e-9 / atol 1e-12, except the p-values
as above; NaN and inf sit where the JAX engine has them. Row 0 stays valid
and finite (see tests/test_torch_static.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
scipy_special = pytest.importorskip("scipy.special")

import oracles  # noqa: E402
import polars_ols_tpu as pj  # noqa: E402
from polars_ols_tpu import CONFIG as JCONFIG  # noqa: E402
from polars_ols_tpu.ops import statistics as jstats  # noqa: E402
from polars_ols_tpu.ops.linalg import t_two_sided_p_value as jax_p_value  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.ops import special, statistics  # noqa: E402

TOL = dict(rtol=1e-9, atol=1e-12)
P_JAX_TOL = dict(rtol=1e-10, atol=1e-14)
P_SCIPY_RTOL = 1e-12
N, K, G = 3_000, 4, 13
CHUNK_ROWS = 64
POLICIES = ["ignore", "zero", "drop", "drop_zero", "drop_y_zero_x"]
MODELS = {
    "ols": ("ols", dict()),
    "ridge": ("ridge", dict(alpha=0.7)),
    "lasso": ("lasso", dict(alpha=0.01)),
}
FIELDS = ("coefficients", "r2", "mae", "mse", "standard_errors", "t_values", "p_values")


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    monkeypatch.setattr(CONFIG, "moment_chunk_rows", CHUNK_ROWS)
    monkeypatch.setattr(JCONFIG, "moment_chunk_rows", CHUNK_ROWS)


def _data(seed: int, null_rate: float = 0.03, sizes=None):
    """N rows in G groups of ~20 .. ~500 rows, or of exactly ``sizes``."""
    rng = np.random.default_rng(seed)
    if sizes is None:
        p = np.linspace(1.0, 6.0, G) ** 2
        gids = rng.choice(G, size=N, p=p / p.sum())
    else:
        gids = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    X = rng.normal(size=(N, K)) * np.asarray([1.0, 10.0, 0.1, 100.0])
    y = X @ np.asarray([1.0, 0.5, 0.0, -0.005]) + rng.normal(size=N) * 0.5
    valid = rng.random((N, 1 + K)) > null_rate
    valid[gids % 3 == 0] = True  # groups without nulls
    valid[0] = True  # row 0 feeds the JAX engine's padding slots
    w = rng.random(N) + 0.1
    return dict(y=y, X=X, valid=valid, gids=gids, w=w)


def _cols(mod, d, nulls: bool = True):
    v = d["valid"]
    cols = {"y": mod.Series("y", d["y"], v[:, 0] if nulls else None)}
    for i in range(K):
        cols[f"x{i + 1}"] = mod.Series(f"x{i + 1}", d["X"][:, i], v[:, 1 + i] if nulls else None)
    cols["w"] = d["w"]
    cols["g"] = d["gids"].astype(float)
    return cols


def _query(col, model: str = "ols", grouped: bool = True, **kw):
    method, mkw = MODELS[model]
    expr = getattr(col("y").least_squares, method)(
        *[col(f"x{i + 1}") for i in range(K)], mode="statistics", **mkw, **kw
    )
    return expr.over("g") if grouped else expr


def _fields(s):
    """Row-level fields of either engine's statistics column, as numpy."""
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in s.arrays.items()}


def _both(d, model="ols", nulls=True, **kw):
    t = pt.DataFrame(_cols(pt, d, nulls)).select(_query(pt.col, model, **kw))["statistics"]
    j = pj.DataFrame(_cols(pj, d, nulls)).select(_query(pj.col, model, **kw))["statistics"]
    return t, j


def _assert_same(t, j):
    assert isinstance(t, pt.StatisticsSeries) and len(t) == len(j)
    assert t.feature_names == j.feature_names
    tf, jf = _fields(t), _fields(j)
    assert sorted(tf) == sorted(jf) == sorted(FIELDS)
    for name in FIELDS:
        assert tf[name].shape == jf[name].shape, name
        tol = P_JAX_TOL if name == "p_values" else TOL
        # equal_nan and equal infinities: NaN / inf exactly where JAX has them
        np.testing.assert_allclose(tf[name], jf[name], err_msg=name, **tol)


# --------------------------------------------------------------------------- #
# p-values
# --------------------------------------------------------------------------- #
def _t_dof(seed: int, G_: int, dof_lo: float, dof_hi: float):
    rng = np.random.default_rng(seed)
    dof = np.exp(rng.uniform(np.log(dof_lo), np.log(dof_hi), G_))
    t = np.exp(rng.uniform(np.log(1e-3), np.log(40.0), (G_, 5))) * rng.choice([-1.0, 1.0], (G_, 5))
    return t, dof


def test_p_values_match_jax_up_to_dof_1000():
    t, dof = _t_dof(0, 2_000, 1.0, 1_000.0)
    dof[:4] = (1.0, 2.5, 3.0, 1_000.0)
    got = special.t_two_sided_p_value(torch.as_tensor(t), torch.as_tensor(dof)).numpy()
    want = np.asarray(jax_p_value(t, dof[:, None]))
    # JAX's betainc is the engine that moves: alone it is already up to
    # 6.7e-12 from scipy at dof 800-1000 (the port: 1.1e-13), and in some
    # orders of the whole suite a few of its elements reach 1.6e-10. Where
    # it is within 5e-11 of scipy the port is held to it; on the few
    # elements where it is not, to scipy, as at dof 8e6 below.
    x = dof[:, None] / (dof[:, None] + t * t)
    ref = scipy_special.betainc(dof[:, None] / 2.0, 0.5, x)
    steady = np.abs(want - ref) <= 5e-11 * np.abs(ref)
    assert steady.mean() > 0.99
    np.testing.assert_allclose(got[steady], want[steady], **P_JAX_TOL)
    np.testing.assert_allclose(got[~steady], ref[~steady], rtol=P_SCIPY_RTOL, atol=1e-300)


@pytest.mark.parametrize("dof_range", [(1.0, 30.0), (30.0, 1e4), (1e4, 8e6)], ids=["small", "mid", "large"])
def test_p_values_match_scipy(dof_range):
    t, dof = _t_dof(1, 2_000, *dof_range)
    dof[0] = dof_range[1]
    got = special.t_two_sided_p_value(torch.as_tensor(t), torch.as_tensor(dof)).numpy()
    x = dof[:, None] / (dof[:, None] + t * t)
    want = scipy_special.betainc(dof[:, None] / 2.0, 0.5, x)
    np.testing.assert_allclose(got, want, rtol=P_SCIPY_RTOL, atol=1e-300)


def test_p_values_at_dof_8e6_where_jax_drifts():
    # the large-a expansion keeps scipy's accuracy where the continued
    # fraction (and JAX's betainc) lose ~a * eps
    t = np.asarray([[0.5, 1.5, 1.73, 1.8, 2.0], [3.0, 5.0, 10.0, 20.0, 1e-3]])
    dof = np.asarray([8e6, 8e6])
    got = special.t_two_sided_p_value(torch.as_tensor(t), torch.as_tensor(dof)).numpy()
    want = scipy_special.betainc(4e6, 0.5, dof[:, None] / (dof[:, None] + t * t))
    np.testing.assert_allclose(got, want, rtol=P_SCIPY_RTOL)
    drift = np.abs(np.asarray(jax_p_value(t, dof[:, None])) - want) / want
    assert drift.max() > 1e-10  # why the port is held to scipy here


def test_p_value_edges_match_jax():
    t = np.asarray([0.0, 0.0, 1.0, 1.0, np.nan, np.inf, -np.inf, 1.0, 2.0, 0.0, 1.0, 1e-200, 40.0])
    dof = np.asarray([5.0, 0.0, 0.0, -1.0, 5.0, 5.0, 5.0, np.inf, np.nan, -2.0, 1e-300, 3.0, 8e6])
    got = special.t_two_sided_p_value(torch.as_tensor(t[:, None]), torch.as_tensor(dof)).numpy()[:, 0]
    want = np.asarray(jax_p_value(t, dof))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)  # NaN where jnp's is
    assert got[0] == 1.0 and np.isnan(got[[3, 4, 8, 9]]).all()


@pytest.mark.parametrize("a", [0.5, 1.25, 7.9, 8.1, 14.9, 15.0, 400.0, 4e6])
def test_betainc_half_matches_scipy(a):
    x = np.concatenate([np.linspace(0.0, 1.0, 41), 1.0 - np.logspace(-7, -1, 12), [np.exp(-1.0)]])
    got = special.betainc_half_ref(torch.tensor(a, dtype=torch.float64), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, scipy_special.betainc(a, 0.5, x), rtol=P_SCIPY_RTOL, atol=1e-300)
    # closer to x = 1 scipy itself drifts at small a (3.5e-11 at a = 0.5,
    # 1 - x = 1e-12): there the referee is mpmath at 40 digits
    import mpmath

    mpmath.mp.dps = 40
    near = 1.0 - np.logspace(-13, -8, 6)
    got = special.betainc_half_ref(torch.tensor(a, dtype=torch.float64), torch.as_tensor(near)).numpy()
    want = [float(mpmath.betainc(a, 0.5, 0, mpmath.mpf(v), regularized=True)) for v in near]
    np.testing.assert_allclose(got, want, rtol=P_SCIPY_RTOL)


def test_p_value_wrapper_checks_its_inputs(monkeypatch):
    monkeypatch.setattr(special, "t_pvalue_kernel_launches", 0)
    t = torch.ones((3, 2), dtype=torch.float64)
    with pytest.raises(TypeError, match="dof"):
        special.t_two_sided_p_value(t, torch.ones((3, 1), dtype=torch.float64))
    with pytest.raises(TypeError, match="t must"):
        special.t_two_sided_p_value(t.float(), torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        special.t_two_sided_p_value(t.t(), torch.ones(2, dtype=torch.float64))
    special.t_two_sided_p_value(t, torch.ones(3, dtype=torch.float64))
    assert special.t_pvalue_kernel_launches == 0  # CPU tensors: the plain version


# --------------------------------------------------------------------------- #
# residual and feature metrics
# --------------------------------------------------------------------------- #
def _padded(seed: int, groups: int = 9, R: int = 40, k: int = 3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(groups, R, k))
    y = X @ rng.normal(size=k) + rng.normal(size=(groups, R)) + 5.0
    w = rng.random((groups, R)) > 0.3
    w[:, :k + 1] = True
    preds = y - rng.normal(size=(groups, R)) * 0.3
    return X, y, w, preds


def test_residual_metrics_match_jax():
    X, y, w, preds = _padded(0)
    want = jstats.residual_metrics(y, preds, w)
    got = statistics.residual_metrics(*(torch.as_tensor(a) for a in (y, preds, w)))
    for name in ("mse", "mae", "r2", "rss"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), err_msg=name, **TOL)
    # the same groups cut into two row blocks each: the block form
    yb, pb, wb = (np.concatenate([a[:, :20], a[:, 20:]], axis=1).reshape(-1, 20) for a in (y, preds, w))
    groups = y.shape[0]
    blocks = (torch.arange(groups).repeat_interleave(2), torch.arange(0, 2 * groups + 1, 2))
    got_b = statistics.residual_metrics(*(torch.as_tensor(a) for a in (yb, pb, wb)), blocks=blocks)
    for name in ("mse", "mae", "r2", "rss"):
        np.testing.assert_allclose(got_b[name].numpy(), np.asarray(want[name]), err_msg=name, **TOL)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1e-3], ids=["ols", "ridge", "small_alpha"])
def test_feature_metrics_match_jax(alpha):
    X, y, w, _ = _padded(1)
    Xm = X * w[..., None]
    XtX = np.einsum("grk,grl->gkl", Xm, Xm)
    Xty = np.einsum("grk,gr->gk", Xm, y * w)
    XtX[2] = -np.eye(3)  # a lane whose Cholesky fails: NaN feature metrics
    n = w.sum(axis=1).astype(float)
    rss = np.random.default_rng(2).random(len(n)) * n
    want = jstats.feature_metrics(XtX, Xty, rss, n, alpha)
    got = statistics.feature_metrics(*(torch.as_tensor(a) for a in (XtX, Xty, rss, n)), alpha)
    for name in ("coefficients", "standard_errors", "t_values"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), err_msg=name, **TOL)
    np.testing.assert_allclose(got["p_values"].numpy(), np.asarray(want["p_values"]), **P_JAX_TOL)
    assert np.isnan(got["standard_errors"][2].numpy()).all()


# --------------------------------------------------------------------------- #
# the public API
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("grouped", [True, False], ids=["over", "single"])
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("policy", POLICIES)
def test_statistics_match_jax(policy, model, grouped):
    d = _data(seed=3)
    _assert_same(*_both(d, model, null_policy=policy, grouped=grouped))


@pytest.mark.parametrize("grouped", [True, False], ids=["over", "single"])
@pytest.mark.parametrize("policy", ["valid", "drop"])
@pytest.mark.parametrize("model", ["ols", "lasso"])
def test_statistics_wls_match_jax(model, policy, grouped):
    d = _data(seed=4)
    kw = dict(sample_weights="w", grouped=grouped)
    if policy == "drop":
        kw["null_policy"] = "drop"
    _assert_same(*_both(d, model, nulls=policy != "valid", **kw))


@pytest.mark.parametrize("grouped", [True, False], ids=["over", "single"])
@pytest.mark.parametrize("method", ["chol", "lu", "qr", "svd"])
def test_statistics_solve_methods_match_jax(method, grouped):
    d = _data(seed=5)
    _assert_same(*_both(d, nulls=False, solve_method=method, grouped=grouped))
    _assert_same(*_both(d, "ridge", null_policy="drop", solve_method=method, grouped=grouped))


def test_statistics_skewed_groups_and_a_group_with_n_equal_k():
    # sizes from 6 to 1,654 rows, and one group of exactly K rows fitted
    # exactly (diagonal power-of-two features, integer targets): df = 0 and
    # RSS = 0, so its se / t / p are NaN in both engines
    sizes = [6, 8, 12, 18, 27, 40, 60, 90, 135, 200, 300, 450, 1_654]
    d = _data(seed=6, null_rate=0.0, sizes=sizes)
    Xs = np.diag([1.0, 2.0, 4.0, 8.0])
    ys = np.asarray([3.0, -2.0, 5.0, 1.0])
    d["X"] = np.concatenate([d["X"], Xs])
    d["y"] = np.concatenate([d["y"], ys])
    d["valid"] = np.concatenate([d["valid"], np.ones((K, 1 + K), dtype=bool)])
    d["w"] = np.concatenate([d["w"], np.ones(K)])
    d["gids"] = np.concatenate([d["gids"], np.full(K, G)])
    for model in ("ols", "ridge"):
        t, j = _both(d, model, nulls=False)
        _assert_same(t, j)
    t, _ = _both(d, "ols", nulls=False)
    row = _fields(t)
    last = slice(N, N + K)
    assert np.isnan(row["standard_errors"][last]).all() and np.isnan(row["p_values"][last]).all()
    np.testing.assert_allclose(row["coefficients"][N], ys / np.diag(Xs), **TOL)
    counts = np.bincount(d["gids"])
    assert counts.min() <= K and counts.max() > 1_000


def test_statistics_match_the_numpy_oracle():
    # one group of OLS and of ridge against tests/oracles.py (statsmodels'
    # summary numbers, the reference's ridge df)
    d = _data(seed=7)
    df = pt.DataFrame(_cols(pt, d, nulls=False))
    feats = [f"x{i + 1}" for i in range(K)]
    ols = df.select(pt.col("y").least_squares.ols(*feats, mode="statistics"))["statistics"].item()
    want = oracles.ols_statistics(d["X"], d["y"])
    for got_key, want_key in (("coefficients", "coef"), ("standard_errors", "se"),
                              ("t_values", "t"), ("p_values", "p")):
        np.testing.assert_allclose(ols[got_key], want[want_key], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose([ols["r2"], ols["mse"]], [want["r2"], want["mse"]], rtol=1e-9)
    ridge = df.select(pt.col("y").least_squares.ridge(
        *feats, alpha=3.0, mode="statistics"))["statistics"].item()
    want = oracles.ridge_statistics(d["X"], d["y"], 3.0)
    for got_key, want_key in (("coefficients", "coef"), ("standard_errors", "se"), ("t_values", "t")):
        np.testing.assert_allclose(ridge[got_key], want[want_key], rtol=1e-8, atol=1e-12)


def test_statistics_series_rows_match_jax():
    d = _data(seed=8)
    t, j = _both(d, "ridge", null_policy="drop")
    assert len(t) == N
    rows_t, rows_j = t.values, j.values
    assert list(rows_t[0]) == [
        "r2", "mae", "mse", "feature_names", "coefficients", "standard_errors", "t_values", "p_values",
    ] == list(rows_j[0])
    for rt, rj in zip(rows_t[:50], rows_j[:50]):
        assert rt["feature_names"] == rj["feature_names"] == [f"x{i + 1}" for i in range(K)]
        for key in ("r2", "mae", "mse", "coefficients", "standard_errors", "t_values"):
            np.testing.assert_allclose(rt[key], rj[key], err_msg=key, **TOL)
    assert t.to_list() == rows_t and t[3] == rows_t[3]
    np.testing.assert_array_equal(t.composed_index(), j.composed_index())


def test_statistics_series_gather_head_tail_filter():
    d = _data(seed=9)
    t, j = _both(d)
    idx = np.asarray([5, 0, 2_999, 17, 17])
    mask = np.arange(N) % 7 == 3
    pairs = [
        (t.gather(idx), j.gather(idx)),
        (t.gather(torch.as_tensor(idx)), j.gather(idx)),
        (t.head(12), j.head(12)),
        (t.tail(4), j.tail(4)),
        (t.filter(mask), j.filter(mask)),
        (t.filter(torch.as_tensor(mask)), j.filter(mask)),
        (t.head(40).gather([5, 0, 39]).alias("s"), j.head(40).gather([5, 0, 39])),
    ]
    for got, want in pairs:
        _assert_same(got, want)
        np.testing.assert_array_equal(got.composed_index(), want.composed_index())
    assert pairs[-1][0].name == "s"
    single = pt.DataFrame(_cols(pt, d)).select(_query(pt.col, grouped=False))["statistics"]
    assert len(single) == 1 and single.composed_index() is None
    assert single.item()["feature_names"] == [f"x{i + 1}" for i in range(K)]
    with pytest.raises(ValueError, match="one row"):
        t.item()


def test_cpu_statistics_launch_no_kernel(monkeypatch):
    from polars_ols_tpu_torch.ops import cd, moments

    monkeypatch.setattr(special, "t_pvalue_kernel_launches", 0)
    monkeypatch.setattr(cd, "cd_kernel_launches", 0)
    monkeypatch.setattr(moments, "moments_kernel_launches", 0)
    d = _data(seed=10)
    df = pt.DataFrame(_cols(pt, d))
    for model in ("ols", "lasso"):
        df.select(_query(pt.col, model, null_policy="drop"))["statistics"].values
    assert special.t_pvalue_kernel_launches == cd.cd_kernel_launches == 0
    assert moments.moments_kernel_launches == 0
