"""Error-path parity of the PyTorch port with the JAX package.

The 11 cases of tests/test_error_paths.py through the port: bad kwargs
(null policy, solve method, mode, ``drop_window`` on a static fit) raise
``AssertionError`` with the JAX package's messages, as do the formula's
categorical terms, predict's policies and arity and a non-positive CD
penalty; multi-target coefficients and statistics raise
``NotImplementedError``; a missing column is a ``KeyError``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG, col  # noqa: E402


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


@pytest.fixture
def df():
    rng = np.random.default_rng(0)
    n = 200
    return pt.DataFrame({"y": rng.normal(size=n), "x1": rng.normal(size=n), "x2": rng.normal(size=n)})


def test_unknown_null_policy(df):
    with pytest.raises(AssertionError, match="null_policy"):
        df.select(col("y").least_squares.ols(col("x1"), null_policy="nope"))


def test_unknown_solve_method(df):
    with pytest.raises(AssertionError, match="solve_method"):
        df.select(col("y").least_squares.ols(col("x1"), solve_method="nope"))


def test_unknown_mode(df):
    with pytest.raises(AssertionError, match="mode"):
        df.select(col("y").least_squares.ols(col("x1"), mode="nope"))


def test_drop_window_rejected_for_static_fits(df):
    with pytest.raises(AssertionError, match="static"):
        df.select(col("y").least_squares.ols(col("x1"), null_policy="drop_window"))


def test_missing_column_is_lookup_error(df):
    with pytest.raises(KeyError, match="zz"):
        df.select(col("y").least_squares.ols(col("zz")))


def test_formula_categorical_unsupported(df):
    with pytest.raises(AssertionError, match="categorical"):
        df.select(col("y").least_squares.from_formula("x1 + C(x2)"))


def test_multi_target_coefficients_unsupported(df):
    with pytest.raises(NotImplementedError, match="predictions"):
        df.select(pt.struct(col("y"), col("x2")).least_squares.multi_target_ols(col("x1"), mode="coefficients"))


def test_multi_target_statistics_unsupported(df):
    with pytest.raises(NotImplementedError, match="predictions"):
        df.select(pt.struct(col("y"), col("x2")).least_squares.multi_target_ols(col("x1"), mode="statistics"))


def test_predict_rejects_fit_only_null_policies(df):
    fitted = df.with_columns(col("y").least_squares.ols(col("x1"), mode="coefficients").alias("c"))
    with pytest.raises(AssertionError, match="drop/ignore/zero"):
        fitted.select(col("c").least_squares.predict(col("x1"), null_policy="drop_zero"))


def test_elastic_net_requires_positive_alpha(df):
    with pytest.raises(AssertionError, match="alpha"):
        df.select(col("y").least_squares.elastic_net(col("x1"), alpha=0.0, l1_ratio=0.5))
    with pytest.raises(AssertionError, match="non-negative"):
        df.select(col("y").least_squares.ridge(col("x1"), alpha=-1.0))


def test_predict_feature_count_mismatch(df):
    fitted = df.with_columns(
        col("y").least_squares.ols(col("x1"), col("x2"), mode="coefficients").alias("c")
    )
    with pytest.raises(AssertionError, match="feature"):
        fitted.select(col("c").least_squares.predict(col("x1")))
