"""The PyTorch port's counterpart of tests/test_engine_preprocessing.py.

Weighted and intercept queries repeated on cached stacks; CD, weighted and
``svd`` statistics as ``StatisticsSeries`` against the numpy oracles at
that file's tolerances; the frame fixes (a left join masks struct and
object columns: a ``StructSeries`` built from numpy values with a row
validity; an empty right frame; concat keeps NaN apart from null; a lazy
frame collects once) and an alpha sweep on one layout. The JAX file's
transfer guard and XLA compile counter have no counterpart on the port's
CPU path; the port's own observables stand in for them: a repeated query
gathers no layout (``fit.layout_gathers``) and reads the device once a
fit for its flags, or never (``batch.flag_reads``). One more case:
``StatisticsSeries.height``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import oracles  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG, col  # noqa: E402
from polars_ols_tpu_torch.engine import batch, fit  # noqa: E402
from polars_ols_tpu_torch.series import ObjectSeries, Series, StatisticsSeries, StructSeries  # noqa: E402


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _make_weighted(n=400, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2))
    y = x.sum(axis=1) + rng.normal(size=n) * 0.1
    w = rng.uniform(0.25, 4.0, size=n)
    g = rng.integers(4, size=n).astype(float)
    return pt.DataFrame({"y": y, "x1": x[:, 0], "x2": x[:, 1], "w": w, "g": g}), x, y, w, g


def test_no_host_fetch_in_wls_rolling_query():
    """A repeated grouped WLS rolling query with an intercept reuses its
    cached stack and layout and reads nothing back for flags."""
    df, *_ = _make_weighted()
    expr = col("y").least_squares.rolling_ols(
        col("x1"), col("x2"), window_size=50, min_periods=5, sample_weights=col("w"), add_intercept=True,
    ).over("g")
    warm = df.select(expr)["y"].to_numpy()
    gathers, reads = fit.layout_gathers, batch.flag_reads
    out = df.select(expr)
    assert (fit.layout_gathers, batch.flag_reads) == (gathers, reads)
    vals = out["y"].to_numpy()
    valid = out["y"].valid_mask().numpy()
    assert np.isfinite(vals[valid]).all()
    np.testing.assert_array_equal(vals, warm)


def test_no_host_fetch_in_wls_statistics_query():
    """Repeated weighted grouped statistics gather no layout, read the
    device once (the fit's flags) and give a StatisticsSeries."""
    df, *_ = _make_weighted()
    expr = col("y").least_squares.ols(
        col("x1"), col("x2"), mode="statistics", sample_weights=col("w"), add_intercept=True,
    ).over("g")
    assert isinstance(df.select(expr)["statistics"], StatisticsSeries)
    gathers, reads = fit.layout_gathers, batch.flag_reads
    out = df.select(expr)
    assert isinstance(out["statistics"], StatisticsSeries)
    assert (fit.layout_gathers, batch.flag_reads) == (gathers, reads + 1)
    assert np.isfinite(out["statistics"][0]["r2"])


def test_binop_keeps_validity_without_sync():
    a = Series("a", np.array([1.0, 2.0, 3.0]), np.array([True, False, True]))
    df = pt.DataFrame({"a": a, "b": np.array([1.0, 1.0, 1.0])})
    out = df.select((col("a") * 2.0 + col("b")).alias("c"))
    assert out["c"].to_list() == [3.0, None, 7.0]


def test_cd_statistics_oracle():
    """Elastic-net statistics: CD coefficients and residual metrics,
    normal-equation se / t / p (src/statistics.rs:116)."""
    rng = np.random.default_rng(11)
    n = 500
    x = rng.normal(size=(n, 3))
    y = x[:, 0] + 0.5 * x[:, 1] + rng.normal(size=n) * 0.1
    df = pt.DataFrame({"y": y, "x1": x[:, 0], "x2": x[:, 1], "x3": x[:, 2]})
    alpha, l1_ratio = 0.01, 1.0
    stats_col = df.select(
        col("y").least_squares.least_squares(
            col("x1"), col("x2"), col("x3"), mode="statistics", alpha=alpha, l1_ratio=l1_ratio,
        )
    )["statistics"]
    assert isinstance(stats_col, StatisticsSeries)
    row = stats_col[0]
    beta_cd = oracles.elastic_net_cd(x, y, alpha=alpha, l1_ratio=l1_ratio)
    np.testing.assert_allclose(row["coefficients"], beta_cd, rtol=1e-4, atol=1e-6)
    resid = y - x @ beta_cd
    assert row["mse"] == pytest.approx(float(resid @ resid) / n, rel=1e-4)
    assert row["mae"] == pytest.approx(float(np.abs(resid).mean()), rel=1e-4)
    sst = float(((y - y.mean()) ** 2).sum())
    assert row["r2"] == pytest.approx(1.0 - float(resid @ resid) / sst, rel=1e-4)
    res_ne = oracles.ridge_statistics(x, y, alpha)
    np.testing.assert_allclose(row["standard_errors"], res_ne["se"], rtol=1e-6)
    np.testing.assert_allclose(row["t_values"], res_ne["t"], rtol=1e-6)
    np.testing.assert_allclose(row["p_values"], res_ne["p"], rtol=1e-5, atol=1e-12)


def test_weighted_statistics_oracle():
    """WLS statistics are OLS statistics of the sqrt(w)-scaled data."""
    df, x, y, w, _ = _make_weighted()
    stats_col = df.select(
        col("y").least_squares.ols(col("x1"), col("x2"), mode="statistics", sample_weights=col("w"))
    )["statistics"]
    assert isinstance(stats_col, StatisticsSeries)
    row = stats_col[0]
    sw = np.sqrt(w)
    res = oracles.ols_statistics(x * sw[:, None], y * sw)
    np.testing.assert_allclose(row["coefficients"], res["coef"], rtol=1e-8)
    np.testing.assert_allclose(row["standard_errors"], res["se"], rtol=1e-6)
    np.testing.assert_allclose(row["p_values"], res["p"], rtol=1e-5, atol=1e-12)
    assert row["r2"] == pytest.approx(res["r2"], rel=1e-6)


def test_svd_statistics_device_native():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 2))
    y = x.sum(axis=1) + rng.normal(size=300) * 0.1
    df = pt.DataFrame({"y": y, "x1": x[:, 0], "x2": x[:, 1]})
    stats_col = df.select(
        col("y").least_squares.least_squares(col("x1"), col("x2"), mode="statistics", solve_method="svd")
    )["statistics"]
    assert isinstance(stats_col, StatisticsSeries)
    res = oracles.ols_statistics(x, y)
    row = stats_col[0]
    np.testing.assert_allclose(row["coefficients"], res["coef"], rtol=1e-8)
    np.testing.assert_allclose(row["standard_errors"], res["se"], rtol=1e-6)


def test_left_join_masks_struct_and_object_columns():
    left = pt.DataFrame({"k": np.array([0.0, 1.0, 2.0]), "a": np.array([1.0, 2.0, 3.0])})
    coef = StructSeries("c", ["x1", "x2"], np.array([[1.0, 2.0], [3.0, 4.0]]))
    obj = ObjectSeries("o", [["p"], ["q"]])
    right = pt.DataFrame({"k": np.array([0.0, 1.0]), "c": coef, "o": obj})
    out = left.join(right, on="k", how="left")
    c = out["c"]
    assert np.asarray(c.valid_mask())[:2].all()
    assert not np.asarray(c.valid_mask())[2]
    assert out["o"].to_list() == [["p"], ["q"], None]


def test_struct_series_takes_numpy_values_and_a_row_validity():
    """The constructor converts numpy or list values to f64 on the device
    and broadcasts a 1-D row validity to every field; a bad shape
    asserts, as in the JAX package."""
    s = StructSeries("c", ["a", "b"], [[1, 2], [3, 4], [5, 6]], np.array([True, False, True]))
    assert s.values.dtype == torch.float64 and s.values.device == torch.device("cpu")
    np.testing.assert_array_equal(s.validity.numpy(), [[True, True], [False, False], [True, True]])
    np.testing.assert_array_equal(s.to_numpy()[1], [np.nan, np.nan])
    with pytest.raises(AssertionError):
        StructSeries("c", ["a", "b"], np.zeros((3, 3)))


def test_left_join_empty_right_frame():
    left = pt.DataFrame({"k": np.array([0.0, 1.0]), "a": np.array([1.0, 2.0])})
    right = pt.DataFrame({"k": np.array([]), "b": np.array([])})
    out = left.join(right, on="k", how="left")
    assert out.height == 2
    assert out["b"].to_list() == [None, None]
    assert out["a"].to_list() == [1.0, 2.0]


def test_concat_preserves_valid_nan_values():
    s1 = Series("v", np.array([1.0, np.nan]))
    s2 = Series("v", np.array([3.0, 4.0]), np.array([True, False]))
    df = pt.concat([pt.DataFrame({"v": s1}), pt.DataFrame({"v": s2})])
    out = df["v"]
    np.testing.assert_array_equal(np.asarray(out.valid_mask()), [True, True, True, False])
    assert np.isnan(np.asarray(out.values)[1])
    assert out.to_list()[3] is None


def test_lazyframe_caches_collect():
    df = pt.DataFrame({"a": np.arange(4.0)})
    lf = df.lazy().with_columns(b=col("a") * 2.0)
    first = lf.collect()
    assert lf.collect() is first
    assert lf.columns == ["a", "b"]


def test_alpha_sweep_reuses_compiled_program():
    """A ridge sweep over alphas on one layout gathers its blocks once
    (the counterpart of the JAX engine's one compiled program) and
    matches the normal equations at every alpha."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(600, 3))
    y = x.sum(axis=1) + rng.normal(size=600) * 0.1
    g = rng.integers(6, size=600).astype(float)
    df = pt.DataFrame({"y": y, "x1": x[:, 0], "x2": x[:, 1], "x3": x[:, 2], "g": g})
    feats = [col("x1"), col("x2"), col("x3")]
    df.select(col("y").least_squares.ridge(*feats, alpha=0.125).over("g"))["y"].to_numpy()
    gathers = fit.layout_gathers
    for alpha in (0.25, 0.5, 2.0):
        df.select(col("y").least_squares.ridge(*feats, alpha=alpha).over("g"))["y"].to_numpy()
    assert fit.layout_gathers == gathers
    for alpha in (0.125, 2.0):
        out = df.select(col("y").least_squares.ridge(*feats, alpha=alpha, mode="coefficients").over("g"))
        out = out["coefficients"].to_numpy()
        for gi in range(6):
            m = g == gi
            ref = np.linalg.solve(x[m].T @ x[m] + alpha * np.eye(3), x[m].T @ y[m])
            np.testing.assert_allclose(out[m][0], ref, atol=1e-8)


def test_statistics_series_height():
    df, *_ = _make_weighted()
    grouped = df.select(col("y").least_squares.ols(col("x1"), col("x2"), mode="statistics").over("g"))
    s = grouped["statistics"]
    assert isinstance(s, StatisticsSeries)
    assert s.height == len(s) == df.height
    alone = df.select(col("y").least_squares.ols(col("x1"), col("x2"), mode="statistics"))["statistics"]
    assert alone.height == 1
