"""The grouped-OLS main path through both engines' public API.

``df.select(col("y").least_squares.ols(...).over("g"))`` in the PyTorch
port must give the JAX engine's predictions (lazy and materialized) and
coefficients at rtol 1e-9 / atol 1e-11 (the JAX suite's coefficient
tolerance against lstsq, tests/test_ozaki.py:60). The frames have 13
groups of unequal sizes, and a small ``moment_chunk_rows`` splits the
heavy groups across several blocks. Ill-conditioned groups (the CSNE
refinement) and groups with an all-zero feature (the eigh fallback)
follow tests/test_conditioning.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import polars_ols_tpu as pj  # noqa: E402
from polars_ols_tpu import CONFIG as JCONFIG  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.ops import moments  # noqa: E402

RTOL, ATOL = 1e-9, 1e-11
N, K, G = 3_000, 4, 13
CHUNK_ROWS = 64


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    monkeypatch.setattr(CONFIG, "moment_chunk_rows", CHUNK_ROWS)
    monkeypatch.setattr(JCONFIG, "moment_chunk_rows", CHUNK_ROWS)


def _data(seed: int = 0, kind: str = "well"):
    rng = np.random.default_rng(seed)
    p = np.linspace(1.0, 6.0, G) ** 2  # group sizes ~20 .. ~500 rows
    gids = rng.choice(G, size=N, p=p / p.sum())
    X = rng.normal(size=(N, K)) * np.asarray([1.0, 10.0, 0.1, 100.0])
    if kind == "ill":  # cond(X'X) ~ 1e10 in every group: CSNE sweeps
        X[:, 1] = X[:, 0] + 1e-5 * rng.normal(size=N)
    elif kind == "deficient":  # an all-zero feature in 4 groups: eigh fallback
        X[gids < 4, 2] = 0.0
    y = X @ np.asarray([1.0, -0.5, 2.0, 0.25]) + rng.normal(size=N) * 0.1
    cols = {"y": y, **{f"x{i + 1}": X[:, i] for i in range(K)}, "g": gids.astype(float)}
    return cols, X, y, gids


def _both(cols, make_expr, column: str):
    """Run one query through both engines; returns (whether the port's
    column came back lazy, port values, jax values) as numpy."""
    t = pt.DataFrame(cols).select(make_expr(pt.col))[column]
    j = pj.DataFrame(cols).select(make_expr(pj.col))[column]
    return getattr(t, "is_lazy", False), t.to_numpy(), j.to_numpy()


def _ols(col, **kw):
    return col("y").least_squares.ols(*[col(f"x{i + 1}") for i in range(K)], **kw)


def test_heavy_groups_split_across_blocks():
    cols, *_ = _data()
    from polars_ols_tpu_torch.engine import fit, groups

    layout = groups.layout_for_columns([pt.DataFrame(cols)["g"]])
    _, pmask, block_group, S = fit._split_layout(layout)
    assert pmask.shape[1] == CHUNK_ROWS and S > G
    assert np.bincount(block_group.numpy()).max() >= 4


@pytest.mark.parametrize("lazy", [True, False])
def test_grouped_predictions_match_jax(lazy, monkeypatch):
    monkeypatch.setattr(CONFIG, "lazy_row_order", lazy)
    monkeypatch.setattr(JCONFIG, "lazy_row_order", lazy)
    cols, X, y, gids = _data()
    is_lazy, t, j = _both(cols, lambda col: _ols(col).over("g"), "y")
    assert is_lazy == lazy
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    for g in range(G):  # and both agree with numpy
        m = gids == g
        beta = np.linalg.lstsq(X[m], y[m], rcond=None)[0]
        np.testing.assert_allclose(t[m], X[m] @ beta, rtol=1e-8, atol=1e-10)


def test_grouped_coefficients_match_jax():
    cols, *_ = _data(seed=1)
    _, t, j = _both(cols, lambda col: _ols(col, mode="coefficients").over("g"), "coefficients")
    assert t.shape == (N, K)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_ungrouped_fit_matches_jax():
    cols, *_ = _data(seed=2)
    _, t, j = _both(cols, lambda col: _ols(col, mode="coefficients"), "coefficients")
    assert t.shape == (1, K)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    _, t, j = _both(cols, lambda col: _ols(col), "y")
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_grouped_ridge_matches_jax():
    cols, *_ = _data(seed=3)

    def ridge(col):
        feats = [col(f"x{i + 1}") for i in range(K)]
        return col("y").least_squares.ridge(*feats, alpha=0.7, mode="coefficients").over("g")

    _, t, j = _both(cols, ridge, "coefficients")
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def test_intercept_and_regex_features_match_jax():
    cols, *_ = _data(seed=4)

    def query(col):
        return col("y").least_squares.ols(col("^x.*$"), add_intercept=True).over("g")

    _, t, j = _both(cols, query, "y")
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["ill", "deficient"])
def test_hard_groups_match_jax(kind):
    cols, X, y, gids = _data(seed=5, kind=kind)
    _, t, j = _both(cols, lambda col: _ols(col).over("g"), "y")
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    _, tc, jc = _both(cols, lambda col: _ols(col, mode="coefficients").over("g"), "coefficients")
    if kind == "deficient":  # minimum-norm: the zero feature gets 0
        np.testing.assert_allclose(tc, jc, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tc[gids < 4, 2], 0.0, atol=1e-12)
    for g in range(G):
        m = gids == g
        beta = np.linalg.lstsq(X[m], y[m], rcond=None)[0]
        np.testing.assert_allclose(t[m], X[m] @ beta, rtol=1e-8, atol=1e-10)


def test_cpu_slice_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(moments, "moments_kernel_launches", 0)
    cols, *_ = _data(seed=6)
    pt.DataFrame(cols).select(_ols(pt.col).over("g"))["y"].to_numpy()
    assert moments.moments_kernel_launches == 0


def _ols2(**kw):
    return lambda c: c("y").least_squares.ols("x1", "x2", **kw)


NOT_PORTED = {
    "multi_target": _ols2(multi_target=True),
    "from_formula": lambda c: c("y").least_squares.from_formula("y ~ x1 + x2", half_life=20),
    "predict": lambda c: c("y").least_squares.predict("x1", "x2"),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_unported_paths_raise(case):
    cols, *_ = _data(seed=7)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        pt.DataFrame(cols).select(NOT_PORTED[case](pt.col))


def test_lasso_above_32_features_raises_item_12():
    rng = np.random.default_rng(8)
    cols = {"y": rng.normal(size=100), **{f"x{i}": rng.normal(size=100) for i in range(33)}}
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 12"):
        pt.DataFrame(cols).select(pt.col("y").least_squares.lasso(pt.col("^x.*$"), alpha=0.1))
