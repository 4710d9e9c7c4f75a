"""The rest of the static fits through both engines' public API.

Null policies, WLS, residuals and explicit lu / qr / svd: the same
numpy-seeded frames (13 groups of unequal sizes; ~3 % nulls drawn
independently per column in 8 of them, the other 5 fully valid; a small
``moment_chunk_rows`` that splits heavy groups across blocks) go through
the JAX engine and the PyTorch port. Frames without nulls carry no
validity mask, so they take the engines' fully valid paths.

Tolerances: coefficients rtol 1e-9 / atol 1e-11 (the JAX suite's against
lstsq, tests/test_ozaki.py:60), predictions and residuals rtol 1e-8 /
atol 1e-10, and identical null masks. Explicit 'lu' solves the normal
equations with no refinement, so two engines summing the moments in
different orders differ by ~eps * cond(X'X) there: its cases use features
of one scale.

Row 0 stays valid and finite in every frame compared with the JAX engine:
that engine fills padding slots with row 0 and masks them by
multiplication, so a NaN there reaches every padded group
(polars_ols_tpu/engine/groups.py:320,356, ops/direct.py:41-43). The port
selects instead; ``test_row0_nan_stays_in_its_group`` pins that against
numpy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import polars_ols_tpu as pj  # noqa: E402
from polars_ols_tpu import CONFIG as JCONFIG  # noqa: E402
from polars_ols_tpu.ops import masking as jmasking  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.engine import fit  # noqa: E402
from polars_ols_tpu_torch.ops import masking, moments  # noqa: E402

COEF_TOL = dict(rtol=1e-9, atol=1e-11)
PRED_TOL = dict(rtol=1e-8, atol=1e-10)
N, K, G = 3_000, 4, 13
CHUNK_ROWS = 64
POLICIES = ["ignore", "zero", "drop", "drop_zero", "drop_y_zero_x"]
MODES = ["predictions", "residuals", "coefficients"]


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    monkeypatch.setattr(CONFIG, "moment_chunk_rows", CHUNK_ROWS)
    monkeypatch.setattr(JCONFIG, "moment_chunk_rows", CHUNK_ROWS)


def _data(seed: int, scales=(1.0, 10.0, 0.1, 100.0), null_rate: float = 0.03, k: int = K):
    rng = np.random.default_rng(seed)
    p = np.linspace(1.0, 6.0, G) ** 2  # group sizes ~20 .. ~500 rows
    gids = rng.choice(G, size=N, p=p / p.sum())
    X = rng.normal(size=(N, k)) * np.resize(np.asarray(scales), k)
    y = X @ np.linspace(1.0, -0.5, k) + rng.normal(size=N) * 0.1
    valid = rng.random((N, 1 + k)) > null_rate
    valid[gids % 3 == 0] = True  # groups without nulls: finite under every policy
    valid[0] = True  # row 0 feeds the JAX engine's padding slots
    w = rng.random(N) + 0.1
    w_valid = np.ones(N, dtype=bool)
    w_valid[[5, 900]] = False  # null weights: EPSILON
    return dict(y=y, X=X, valid=valid, gids=gids, w=w, w_valid=w_valid)


def _cols(mod, d, nulls: bool = True):
    """The frame's columns for one engine (``mod`` is pj or pt)."""
    k = d["X"].shape[1]
    v = d["valid"]
    cols = {"y": mod.Series("y", d["y"], v[:, 0] if nulls else None)}
    for i in range(k):
        cols[f"x{i + 1}"] = mod.Series(f"x{i + 1}", d["X"][:, i], v[:, 1 + i] if nulls else None)
    cols["w"] = mod.Series("w", d["w"], d["w_valid"])
    cols["g"] = d["gids"].astype(float)
    return cols


def _query(col, k=K, grouped=True, **kw):
    expr = col("y").least_squares.ols(*[col(f"x{i + 1}") for i in range(k)], **kw)
    return expr.over("g") if grouped else expr


def _arrays(s):
    """(values, validity) of either engine's Series / StructSeries."""
    vals = np.asarray(s.values.cpu() if isinstance(s.values, torch.Tensor) else s.values)
    valid = s.validity
    if valid is None:
        valid = np.ones(vals.shape, dtype=bool)
    valid = np.asarray(valid.cpu() if isinstance(valid, torch.Tensor) else valid)
    return vals, valid


def _both(d, nulls=True, k=K, **kw):
    """One query through both engines: ((port values, validity), (jax ...))."""
    column = "coefficients" if kw.get("mode") == "coefficients" else "y"
    t = pt.DataFrame(_cols(pt, d, nulls)).select(_query(pt.col, k, **kw))[column]
    j = pj.DataFrame(_cols(pj, d, nulls)).select(_query(pj.col, k, **kw))[column]
    return _arrays(t), _arrays(j)


def _assert_same(t, j, mode):
    (tv, tm), (jv, jm) = t, j
    assert tv.shape == jv.shape
    np.testing.assert_array_equal(tm, jm)  # nulls exactly where the JAX engine has them
    tol = COEF_TOL if mode == "coefficients" else PRED_TOL
    np.testing.assert_allclose(tv[tm], jv[jm], **tol)


# --------------------------------------------------------------------------- #
# series and masking
# --------------------------------------------------------------------------- #
def test_series_from_list_with_none_has_a_validity_mask():
    s = pt.Series("a", [1.0, None, float("nan"), 4.0])
    np.testing.assert_array_equal(s.valid_mask().numpy(), [True, False, True, True])
    assert s.values.dtype == torch.float64
    vals = s.values.numpy()
    assert vals[1] == 0.0 and np.isnan(vals[2])  # a NaN value stays valid
    assert pt.Series("b", [1.0, 2.0]).validity is None
    np.testing.assert_array_equal(pt.Series("b", [1.0, 2.0]).valid_mask().numpy(), [True, True])


@pytest.mark.parametrize("policy", POLICIES)
def test_prepare_problem_matches_jax(policy):
    d = _data(seed=1)
    yv, xv = d["valid"][:, 0], d["valid"][:, 1:]
    t = masking.prepare_problem(
        policy, torch.as_tensor(d["y"]), torch.as_tensor(yv),
        torch.as_tensor(d["X"]), torch.as_tensor(xv),
    )
    j = jmasking.prepare_problem(policy, d["y"], yv, d["X"], xv)
    for name in ("y", "X", "fit_mask", "X_predict", "predict_valid"):
        tv, jv = getattr(t, name), getattr(j, name)
        assert (tv is None) == (jv is None), name
        if tv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=name)
            assert tv.dtype == (torch.bool if jv.dtype == bool else torch.float64)


def test_moving_policies_raise_naming_their_item():
    # the moving semantics are ported (every policy matches the JAX
    # engine's below), at K = 33 too (once ROADMAP Queue 1 item 12c): rls
    # under 'drop_window' on 33 collinear features matches the JAX engine
    # at the Kalman oracle's tolerance (tests/test_largek_moving.py:48)
    cols = {"y": np.arange(40.0), **{f"x{i}": np.arange(40.0) + i for i in range(33)}}
    out = []
    for mod in (pt, pj):
        s = mod.DataFrame(cols).select(mod.col("y").least_squares.rls(mod.col("^x.*$"), null_policy="drop_window"))
        out.append(np.asarray(s["y"].to_numpy()))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("policy", POLICIES + ["drop_window"])
def test_prepare_problem_moving_matches_jax(policy):
    d = _data(seed=1)
    yv, xv = d["valid"][:, 0], d["valid"][:, 1:]
    t = masking.prepare_problem(
        policy, torch.as_tensor(d["y"]), torch.as_tensor(yv),
        torch.as_tensor(d["X"]), torch.as_tensor(xv), moving=True,
    )
    j = jmasking.prepare_problem(policy, d["y"], yv, d["X"], xv, moving=True)
    for name in ("y", "X", "fit_mask", "X_predict", "predict_valid"):
        tv, jv = getattr(t, name), getattr(j, name)
        assert (tv is None) == (jv is None), name
        if tv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=name)


# --------------------------------------------------------------------------- #
# the engine: policies x modes x grouping, WLS, explicit solvers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("grouped", [True, False], ids=["over", "single"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", POLICIES)
def test_null_policy_matches_jax(policy, mode, grouped):
    d = _data(seed=2)
    t, j = _both(d, null_policy=policy, mode=mode, grouped=grouped)
    _assert_same(t, j, mode)
    if grouped:  # the groups without nulls are compared as numbers
        clean = d["gids"] % 3 == 0
        assert np.isfinite(t[0][clean]).all() and np.isfinite(j[0][clean]).all()


@pytest.mark.parametrize("grouped", [True, False], ids=["over", "single"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("policy", ["valid", "drop", "drop_zero"])
def test_wls_matches_jax(policy, mode, grouped):
    d = _data(seed=3)
    kw = dict(sample_weights="w", mode=mode, grouped=grouped)
    if policy == "valid":
        t, j = _both(d, nulls=False, **kw)
    else:
        t, j = _both(d, null_policy=policy, **kw)
    _assert_same(t, j, mode)


@pytest.mark.parametrize("grouped", [True, False], ids=["over", "single"])
@pytest.mark.parametrize("policy", ["valid", "ignore", "drop", "drop_zero"])
@pytest.mark.parametrize("method", ["lu", "qr", "svd"])
def test_explicit_solver_matches_jax(method, policy, grouped):
    scales = (1.0,) if method == "lu" else (1.0, 10.0, 0.1, 100.0)
    d = _data(seed=4, scales=scales)
    nulls = policy != "valid"
    kw = dict(solve_method=method, grouped=grouped)
    if nulls:
        kw["null_policy"] = policy
    for mode in ("predictions", "coefficients"):
        _assert_same(*_both(d, nulls=nulls, mode=mode, **kw), mode)


@pytest.mark.parametrize("method", ["lu", "qr", "svd"])
def test_explicit_solver_ridge_matches_jax(method):
    d = _data(seed=13, scales=(1.0,))

    def query(col, mode):
        feats = [col(f"x{i + 1}") for i in range(K)]
        return col("y").least_squares.ridge(
            *feats, alpha=0.7, solve_method=method, null_policy="drop", mode=mode
        ).over("g")

    for mode in ("predictions", "coefficients"):
        column = "coefficients" if mode == "coefficients" else "y"
        t = pt.DataFrame(_cols(pt, d)).select(query(pt.col, mode))[column]
        j = pj.DataFrame(_cols(pj, d)).select(query(pj.col, mode))[column]
        _assert_same(_arrays(t), _arrays(j), mode)


@pytest.mark.parametrize("kind", ["full_rank", "rank_deficient"])
def test_single_group_svd_above_k8_matches_jax(kind):
    # K = 10 > 8, one group: the JAX engine takes its guarded moment path
    # (rerouted to the row-space SVD when the factor fails); the port takes
    # its one SVD path, and both give the minimum-norm solution
    d = _data(seed=6, scales=(1.0,), k=10)
    if kind == "rank_deficient":
        d["X"][:, 9] = d["X"][:, 8]
    for mode in ("predictions", "coefficients"):
        t, j = _both(d, nulls=False, k=10, solve_method="svd", mode=mode, grouped=False)
        _assert_same(t, j, mode)
    beta = np.linalg.lstsq(d["X"], d["y"], rcond=None)[0]  # minimum norm
    np.testing.assert_allclose(t[0][0], beta, **COEF_TOL)


def test_residuals_are_target_minus_predictions():
    d = _data(seed=7)
    df = pt.DataFrame(_cols(pt, d))
    preds = df.select(_query(pt.col, null_policy="drop"))["y"]
    resid = df.select(_query(pt.col, null_policy="drop", mode="residuals"))["y"]
    target = df["y"]
    np.testing.assert_array_equal(
        resid.valid_mask().numpy(), (preds.valid_mask() & target.valid_mask()).numpy()
    )
    m = resid.valid_mask().numpy()
    np.testing.assert_array_equal(
        resid.values.numpy()[m], (target.values - preds.values).numpy()[m]
    )


def test_weighted_predictions_are_unscaled():
    # one group, fully valid, with a null weight: the fit is weighted
    # lstsq on sqrt(w)-scaled rows, the predictions X @ beta
    d = _data(seed=8)
    t = pt.DataFrame(_cols(pt, d, nulls=False))
    sq = np.where(d["w_valid"], np.sqrt(d["w"]), 1e-12)
    beta = np.linalg.lstsq(d["X"] * sq[:, None], d["y"] * sq, rcond=None)[0]
    preds = t.select(_query(pt.col, grouped=False, sample_weights="w"))["y"].to_numpy()
    np.testing.assert_allclose(preds, d["X"] @ beta, **PRED_TOL)
    coefs = t.select(pt.col("y").least_squares.wls(
        *[f"x{i + 1}" for i in range(K)], sample_weights="w", mode="coefficients"
    ))["coefficients"].to_numpy()
    np.testing.assert_allclose(coefs[0], beta, **COEF_TOL)


def test_row0_nan_stays_in_its_group():
    # a NaN value in row 0 makes the port's group of row 0 NaN and no other:
    # each other group matches numpy lstsq on its own rows (the JAX engine
    # spreads the NaN to every group with padding slots)
    d = _data(seed=9, scales=(1.0,))
    X, y, gids = d["X"], d["y"].copy(), d["gids"]
    y[0] = np.nan
    cols = {"y": y, **{f"x{i + 1}": X[:, i] for i in range(K)}, "g": gids.astype(float)}
    for method in (None, "svd"):
        out = pt.DataFrame(cols).select(_query(pt.col, solve_method=method, mode="coefficients"))
        coefs = out["coefficients"].to_numpy()
        for g in range(G):
            m = gids == g
            if g == gids[0]:
                continue  # numpy lstsq has no answer for a NaN target
            beta = np.linalg.lstsq(X[m], y[m], rcond=None)[0]
            np.testing.assert_allclose(coefs[m][0], beta, **COEF_TOL)


def test_blocks_are_cached_per_policy_and_weighting():
    d = _data(seed=10)
    df = pt.DataFrame(_cols(pt, d))
    for policy in ("drop", "zero"):
        df.select(_query(pt.col, null_policy=policy))
    df.select(_query(pt.col, null_policy="drop", sample_weights="w"))
    from polars_ols_tpu_torch.engine import groups

    layout = groups.layout_for_columns([df["g"]])
    keys = [k for k in layout._dev if isinstance(k, tuple) and k[0] == "blocks"]
    assert len(keys) == 2  # an LRU of two partitions
    assert len({k[1] for k in keys}) == 2  # weighted and unweighted stacks
    vals, valid = fit._stack_cached(df["y"], [df[f"x{i + 1}"] for i in range(K)])
    Zp_drop, wp_drop, pv = fit._blocks_cached(layout, vals, valid, "drop")
    Zp_zero, wp_zero, _ = fit._blocks_cached(layout, vals, valid, "zero")
    assert pv is not None and not torch.equal(wp_drop, wp_zero)


def test_lazy_and_materialized_predictions_agree(monkeypatch):
    d = _data(seed=11)
    df = pt.DataFrame(_cols(pt, d))
    out = {}
    for lazy in (True, False):
        monkeypatch.setattr(CONFIG, "lazy_row_order", lazy)
        for method in (None, "svd"):
            s = df.select(_query(pt.col, null_policy="drop", solve_method=method))["y"]
            assert s.is_lazy == lazy
            out[lazy, method] = _arrays(s)
    for method in (None, "svd"):
        np.testing.assert_array_equal(out[True, method][0], out[False, method][0])
        np.testing.assert_array_equal(out[True, method][1], out[False, method][1])


def test_cpu_static_fits_launch_no_kernel(monkeypatch):
    monkeypatch.setattr(moments, "moments_kernel_launches", 0)
    d = _data(seed=12)
    df = pt.DataFrame(_cols(pt, d))
    for method in ("lu", "qr", None):
        df.select(_query(pt.col, null_policy="drop", solve_method=method))["y"].to_numpy()
    assert moments.moments_kernel_launches == 0
