"""Static fits above 32 features through both engines' public API.

Above K = 32 the port takes the moment kernel's wide form, the library's
batched Cholesky (where the JAX engine calls ``jnp.linalg.cholesky``), and
the Householder and Jacobi kernels' wide forms; on the CPU each runs its
plain version. The same numpy-seeded frames (a few groups of some hundred
rows; ~2 % nulls per column in all but every third group, row 0 valid; a
small ``moment_chunk_rows`` that splits each group across blocks, so the
Householder tree runs) go through the JAX package and the port at K = 33,
40 and 64 with every static solve method, and at K = 40 in the four modes
under the five null policies with WLS. Coordinate descent (FISTA and the
wide cyclic form, tests/test_torch_cd_wide.py holds them in full) and the
moving models (tests/test_torch_moving_wide.py) match the JAX engine here
at K = 33.

Tolerances: coefficients rtol 1e-9 / atol 1e-11 (the JAX suite's against
lstsq, tests/test_ozaki.py:60), predictions and residuals rtol 1e-8 /
atol 1e-10, statistics fields rtol 1e-8 (the same solves; the two
engines' moments sum in different orders), identical null masks. Explicit
'lu' solves the normal equations with no refinement: its frames keep the
features at one scale, as tests/test_torch_static.py does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import polars_ols_tpu as pj  # noqa: E402
from polars_ols_tpu import CONFIG as JCONFIG  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402

COEF_TOL = dict(rtol=1e-9, atol=1e-11)
PRED_TOL = dict(rtol=1e-8, atol=1e-10)
STAT_TOL = dict(rtol=1e-8, atol=1e-12)
CHUNK_ROWS = 128
POLICIES = ["ignore", "zero", "drop", "drop_zero", "drop_y_zero_x"]
METHODS = [None, "chol", "qr", "lu", "svd"]


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    monkeypatch.setattr(CONFIG, "moment_chunk_rows", CHUNK_ROWS)
    monkeypatch.setattr(JCONFIG, "moment_chunk_rows", CHUNK_ROWS)


def _data(k: int, n: int = 900, groups: int = 3, seed: int = 0, null_rate: float = 0.02):
    rng = np.random.default_rng(seed + k)
    gids = rng.integers(groups, size=n)
    X = rng.normal(size=(n, k))
    y = X @ np.linspace(1.0, -0.5, k) + rng.normal(size=n) * 0.1
    valid = rng.random((n, 1 + k)) > null_rate
    valid[gids % 3 == 0] = True  # groups without nulls: finite under every policy
    valid[0] = True  # row 0 feeds the JAX engine's padding slots
    w = rng.random(n) + 0.1
    return dict(y=y, X=X, valid=valid, gids=gids, w=w)


def _frame(mod, d, nulls: bool = True):
    k = d["X"].shape[1]
    v = d["valid"]
    cols = {"y": mod.Series("y", d["y"], v[:, 0] if nulls else None)}
    for i in range(k):
        cols[f"x{i}"] = mod.Series(f"x{i}", d["X"][:, i], v[:, 1 + i] if nulls else None)
    cols["w"] = d["w"]
    cols["g"] = d["gids"].astype(float)
    return mod.DataFrame(cols)


def _both(d, build, nulls: bool = True):
    """The selected column of each engine: (port, jax)."""
    feats = [f"x{i}" for i in range(d["X"].shape[1])]
    out = []
    for mod in (pt, pj):
        s = _frame(mod, d, nulls).select(build(mod.col("y").least_squares, feats))
        out.append(s[s.columns[0]])
    return out


def _values(s):
    """(values [N] or [N, K] with NaN at nulls, validity or None)."""
    v = np.asarray(s.to_numpy(), dtype=float)
    return v, None if s.validity is None else np.asarray(s.validity)


@pytest.mark.parametrize("method", METHODS, ids=str)
@pytest.mark.parametrize("k", [33, 40, 64])
def test_static_methods_above_32_match_jax(k, method):
    d = _data(k)
    for mode in ("predictions", "coefficients"):
        t, j = _both(d, lambda ls, f: ls.ols(*f, solve_method=method, mode=mode, null_policy="drop").over("g"))
        (tv, tm), (jv, jm) = _values(t), _values(j)
        if tm is not None or jm is not None:
            np.testing.assert_array_equal(tm, jm)
        np.testing.assert_allclose(tv, jv, **(COEF_TOL if mode == "coefficients" else PRED_TOL))
        assert np.isfinite(tv[~np.isnan(jv)]).all()


@pytest.mark.parametrize("mode", ["predictions", "residuals", "coefficients", "statistics"])
@pytest.mark.parametrize("policy", POLICIES)
def test_wls_modes_and_policies_above_32_match_jax(policy, mode):
    d = _data(40, seed=1)
    t, j = _both(d, lambda ls, f: ls.wls(*f, sample_weights="w", mode=mode, null_policy=policy).over("g"))
    if mode == "statistics":
        ta, ja = t.arrays, j.arrays
        for key in pt.StatisticsSeries.SCALAR_FIELDS + pt.StatisticsSeries.LIST_FIELDS:
            np.testing.assert_allclose(ta[key].numpy(), np.asarray(ja[key]), err_msg=key, **STAT_TOL)
        return
    (tv, tm), (jv, jm) = _values(t), _values(j)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tv, jv, **(COEF_TOL if mode == "coefficients" else PRED_TOL))


@pytest.mark.parametrize("query", ["ridge_chol", "ridge_svd", "ridge_intercept", "ols_lazy_single_group"])
def test_ridge_intercept_and_one_group_above_32_match_jax(query):
    d = _data(36, seed=2)
    build = {
        "ridge_chol": lambda ls, f: ls.ridge(*f, alpha=0.1).over("g"),
        "ridge_svd": lambda ls, f: ls.ridge(*f, alpha=0.1, solve_method="svd").over("g"),
        "ridge_intercept": lambda ls, f: ls.ols(*f[:32], add_intercept=True, null_policy="zero").over("g"),
        "ols_lazy_single_group": lambda ls, f: ls.ols(*f, null_policy="drop_zero"),
    }[query]
    t, j = _both(d, build, nulls=query != "ridge_svd")
    (tv, tm), (jv, jm) = _values(t), _values(j)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tv, jv, **PRED_TOL)


@pytest.mark.parametrize("query", ["materialized", "predict", "formula"])
def test_materialized_predict_and_formula_above_32_match_jax(query, monkeypatch):
    # predictions in row order (not deferred), predict from a coefficient
    # struct of 40 fields, and a formula of 40 terms with its intercept
    d = _data(40, seed=3)
    feats = [f"x{i}" for i in range(40)]
    monkeypatch.setattr(CONFIG, "lazy_row_order", query != "materialized")
    out = []
    for mod in (pt, pj):
        df = _frame(mod, d)
        ls = mod.col("y").least_squares
        if query == "materialized":
            s = df.select(ls.ols(*feats, null_policy="drop").over("g"))["y"]
            assert mod is pj or not s.is_lazy
        elif query == "predict":
            dfc = df.with_columns(ls.ols(*feats, mode="coefficients", null_policy="zero").over("g"))
            s = dfc.select(mod.col("coefficients").least_squares.predict(*feats, null_policy="zero"))["predictions"]
        else:
            s = df.select(ls.from_formula(" + ".join(feats), null_policy="drop_zero").over("g"))["y"]
        out.append(_values(s))
    (tv, tm), (jv, jm) = out
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tv, jv, **PRED_TOL)


@pytest.mark.parametrize(
    "model", ["lasso", "elastic_net", "nnls", "cd_active_set", "rls", "rolling_ols", "expanding_ols"]
)
def test_cd_and_moving_models_above_32_raise_their_items(model):
    # coordinate descent above K = 32 (once refused as ROADMAP item 12b)
    # and the moving models run at any K and match the JAX engine: CD at the
    # JAX suite's CD tolerance (rtol 1e-8 / atol 1e-10, tests/test_ols.py:465)
    # in predictions, coefficients and statistics mode, the moving models at
    # the JAX suite's tolerances for their paths above 32
    # (tests/test_largek_moving.py: the Kalman oracle's rtol 1e-8 / atol
    # 1e-10, grouped rolling's 2e-5 where a window holds 2 K fit rows),
    # with identical nulls
    d = _data(33, n=200)
    moving = {
        "rls": lambda ls, f: ls.rls(*f, half_life=20.0),
        "rolling_ols": lambda ls, f: ls.rolling_ols(*f, window_size=180),
        "expanding_ols": lambda ls, f: ls.expanding_ols(*f),
    }
    if model in moving:
        (tv, tm), (jv, jm) = (_values(s) for s in _both(d, moving[model]))
        np.testing.assert_array_equal(tm, jm)
        if model == "rls":
            np.testing.assert_allclose(tv, jv, rtol=1e-8, atol=1e-10)
        else:
            fit = np.cumsum(d["valid"].all(axis=1))
            if model == "rolling_ols":
                fit = fit - np.concatenate([np.zeros(180, dtype=fit.dtype), fit])[: len(fit)]
            m = tm & (fit >= 66)
            assert m.sum() > 20
            np.testing.assert_allclose(tv[m], jv[m], rtol=2e-5, atol=2e-5)
        return
    kw = {
        "lasso": dict(alpha=0.1),
        "elastic_net": dict(alpha=0.1, l1_ratio=0.5),
        "nnls": dict(alpha=0.1, positive=True),
        "cd_active_set": dict(alpha=0.1, solve_method="cd_active_set"),
    }[model]
    method = "elastic_net" if model == "elastic_net" else "lasso"
    for mode in ("predictions", "coefficients", "statistics"):
        t, j = _both(d, lambda ls, f: getattr(ls, method)(*f, mode=mode, null_policy="drop", **kw).over("g"))
        if mode == "statistics":
            ta, ja = t.arrays, j.arrays
            for key in pt.StatisticsSeries.SCALAR_FIELDS + pt.StatisticsSeries.LIST_FIELDS:
                np.testing.assert_allclose(ta[key].numpy(), np.asarray(ja[key]), err_msg=key, rtol=1e-8, atol=1e-10)
            continue
        (tv, tm), (jv, jm) = _values(t), _values(j)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_allclose(tv, jv, rtol=1e-8, atol=1e-10)
        assert np.isfinite(tv[~np.isnan(jv)]).all()
        if mode == "coefficients":
            assert (tv == 0).any() and (tv != 0).any()
            if model == "nnls":
                assert tv.min() >= 0.0
