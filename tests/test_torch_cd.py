"""Coordinate descent (lasso / elastic net / NNLS) through both engines.

``solve_elastic_net_cov_ref`` against the JAX engine's
``solve_elastic_net_cov`` on the same random moments (lasso, elastic net,
positive, active set, a lane stopped by ``max_iter``, an all-zero column
whose denominator falls back to 1, a group without rows), and the public
API in both engines on the same numpy-seeded frames (13 groups of unequal
sizes, ~3 % nulls per column in 8 of them, a small ``moment_chunk_rows``
that splits heavy groups across blocks): predictions, residuals and
coefficients of ``lasso`` / ``elastic_net`` / ``positive=True`` /
``ols(alpha, solve_method="cd")`` / ``ridge(solve_method="cd")``, under
the five static null policies, with WLS, grouped and single.

Tolerance rtol 1e-8 / atol 1e-10 (the JAX suite's for its CD against its
literal oracle, tests/test_ols.py:465): both engines run the same iterate
sequence on moments summed in different orders. Row 0 stays valid and
finite (see tests/test_torch_static.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import oracles  # noqa: E402
import polars_ols_tpu as pj  # noqa: E402
from polars_ols_tpu import CONFIG as JCONFIG  # noqa: E402
from polars_ols_tpu.ops.cd import solve_elastic_net_cov as jax_cd  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.ops import cd  # noqa: E402

TOL = dict(rtol=1e-8, atol=1e-10)
N, K, G = 3_000, 4, 13
CHUNK_ROWS = 64
POLICIES = ["ignore", "zero", "drop", "drop_zero", "drop_y_zero_x"]
MODES = ["predictions", "residuals", "coefficients"]
# the CD entry points of the namespace, as (method, kwargs)
MODELS = {
    "lasso": ("lasso", dict(alpha=0.01)),
    "elastic_net": ("elastic_net", dict(alpha=0.02, l1_ratio=0.3)),
    "nnls": ("lasso", dict(alpha=0.01, positive=True)),
    "ols_cd": ("ols", dict(alpha=0.01, solve_method="cd")),  # elastic net at l1 0.5
    "ridge_cd": ("ridge", dict(alpha=0.05, solve_method="cd")),  # CD with l1 0
}


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    monkeypatch.setattr(CONFIG, "moment_chunk_rows", CHUNK_ROWS)
    monkeypatch.setattr(JCONFIG, "moment_chunk_rows", CHUNK_ROWS)


def _data(seed: int, null_rate: float = 0.03):
    rng = np.random.default_rng(seed)
    p = np.linspace(1.0, 6.0, G) ** 2  # group sizes ~20 .. ~500 rows
    gids = rng.choice(G, size=N, p=p / p.sum())
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


def _query(col, model: str, grouped: bool = True, **kw):
    method, mkw = MODELS[model]
    expr = getattr(col("y").least_squares, method)(
        *[col(f"x{i + 1}") for i in range(K)], **mkw, **kw
    )
    return expr.over("g") if grouped else expr


def _both(d, model, nulls=True, **kw):
    """(port, jax) numpy output of one query, nulls as NaN."""
    column = "coefficients" if kw.get("mode") == "coefficients" else "y"
    t = pt.DataFrame(_cols(pt, d, nulls)).select(_query(pt.col, model, **kw))[column]
    j = pj.DataFrame(_cols(pj, d, nulls)).select(_query(pj.col, model, **kw))[column]
    return t.to_numpy(), j.to_numpy()


def _assert_same(t, j):
    assert t.shape == j.shape
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t, j, **TOL)


# --------------------------------------------------------------------------- #
# the solver on moments
# --------------------------------------------------------------------------- #
def _moments(seed: int, groups: int = 40, k: int = 5):
    """Moments of groups of 10..300 rows with correlated features and sparse
    true coefficients; group 1 has an all-zero feature, group 2 no rows."""
    rng = np.random.default_rng(seed)
    XtX = np.zeros((groups, k, k))
    Xty = np.zeros((groups, k))
    n = rng.integers(10, 300, size=groups).astype(float)
    for g in range(groups):
        X = rng.normal(size=(int(n[g]), k)) @ (np.eye(k) + 0.4 * rng.normal(size=(k, k)))
        if g == 1:
            X[:, 2] = 0.0
        y = X @ (rng.normal(size=k) * (rng.random(k) > 0.4)) + rng.normal(size=int(n[g]))
        XtX[g], Xty[g] = X.T @ X, X.T @ y
    XtX[2], Xty[2], n[2] = 0.0, 0.0, 0.0
    return XtX, Xty, n


CD_CASES = {
    "lasso": dict(alpha=0.05, l1_ratio=1.0),
    "elastic_net": dict(alpha=0.05, l1_ratio=0.5),
    "positive": dict(alpha=0.05, l1_ratio=0.8, positive=True),
    "active_set": dict(alpha=0.05, l1_ratio=1.0, active_set=True),
    "active_set_positive": dict(alpha=0.02, l1_ratio=0.6, positive=True, active_set=True),
    "max_iter": dict(alpha=0.001, l1_ratio=1.0, max_iter=3),
    "tight_tol": dict(alpha=0.01, l1_ratio=0.9, tol=1e-10),
}


@pytest.mark.parametrize("case", sorted(CD_CASES))
def test_cd_ref_matches_jax(case):
    kw = CD_CASES[case]
    XtX, Xty, n = _moments(seed=len(case))
    w, sweeps = cd.solve_elastic_net_cov_ref(
        torch.as_tensor(XtX), torch.as_tensor(Xty), torch.as_tensor(n), **kw
    )
    wj = np.asarray(jax_cd(XtX, Xty, n, **kw))
    np.testing.assert_allclose(w.numpy(), wj, **TOL)
    assert sweeps.dtype == torch.int32 and int(sweeps.min()) >= 1
    assert int(sweeps.max()) <= kw.get("max_iter", 1000)
    if case == "max_iter":
        assert int(sweeps.max()) == 3
    assert float(np.abs(w[2].numpy()).max()) == 0.0 and int(sweeps[2]) == 1  # no rows
    assert float(w[1, 2]) == 0.0  # the zero column: denominator 1, zero update
    if kw.get("positive"):
        assert float(w.min()) >= 0.0
    nz = (w.numpy() != 0).mean()
    assert 0.0 < nz < 1.0  # both zero and nonzero coefficients


@pytest.mark.parametrize("k", [8, 9, 16, 17])
def test_cd_ref_matches_jax_at_the_kernels_k_buckets(k):
    """K on both sides of the kernel's buckets (8 | 9, 16 | 17), at a group
    count that is no multiple of the groups a warp holds (4 or 2)."""
    kw = dict(alpha=0.05, l1_ratio=0.8, positive=k % 2 == 1)
    XtX, Xty, n = _moments(seed=k, groups=37, k=k)
    w, sweeps = cd.solve_elastic_net_cov_ref(
        torch.as_tensor(XtX), torch.as_tensor(Xty), torch.as_tensor(n), **kw
    )
    np.testing.assert_allclose(w.numpy(), np.asarray(jax_cd(XtX, Xty, n, **kw)), **TOL)
    assert int(sweeps.min()) >= 1 and float(np.abs(w[2].numpy()).max()) == 0.0


def test_cd_wrapper_on_cpu_is_the_plain_version(monkeypatch):
    monkeypatch.setattr(cd, "cd_kernel_launches", 0)
    XtX, Xty, n = (torch.as_tensor(a) for a in _moments(seed=3))
    w, s = cd.solve_elastic_net_cov(XtX, Xty, n, alpha=0.05, l1_ratio=1.0)
    w_ref, s_ref = cd.solve_elastic_net_cov_ref(XtX, Xty, n, alpha=0.05, l1_ratio=1.0)
    assert torch.equal(w, w_ref) and torch.equal(s, s_ref)
    assert cd.cd_kernel_launches == 0


def test_cd_wrapper_checks_its_inputs():
    XtX, Xty, n = (torch.as_tensor(a) for a in _moments(seed=4, groups=3))
    with pytest.raises(TypeError, match="Xty"):
        cd.solve_elastic_net_cov(XtX, Xty[:, :4], n, alpha=0.1)
    with pytest.raises(TypeError, match="n_valid"):
        cd.solve_elastic_net_cov(XtX, Xty, n.to(torch.float32), alpha=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        cd.solve_elastic_net_cov(XtX.transpose(1, 2), Xty, n, alpha=0.1)
    # K = 33 is no longer refused: zero moments give zero coefficients
    # after one FISTA iteration
    big = torch.zeros((2, 33, 33), dtype=torch.float64)
    w, its = cd.solve_elastic_net_cov(big, torch.zeros((2, 33), dtype=torch.float64),
                                      torch.ones(2, dtype=torch.float64), alpha=0.1)
    assert w.shape == (2, 33) and float(w.abs().max()) == 0.0 and its.tolist() == [1, 1]
    with pytest.raises(TypeError, match="Xty"):
        cd.solve_elastic_net_cov(big, torch.zeros((2, 32), dtype=torch.float64),
                                 torch.ones(2, dtype=torch.float64), alpha=0.1)


def test_soft_threshold_keeps_nan_and_clamps():
    x = torch.tensor([3.0, -3.0, 0.5, float("nan")], dtype=torch.float64)
    a = torch.tensor(1.0, dtype=torch.float64)
    out = cd._soft_threshold(x, a, positive=False)
    np.testing.assert_array_equal(out[:3].numpy(), [2.0, -2.0, 0.0])
    assert torch.isnan(out[3])
    np.testing.assert_array_equal(cd._soft_threshold(x, a, positive=True)[:3].numpy(), [2.0, 0.0, 0.0])


# --------------------------------------------------------------------------- #
# the public API
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("grouped", [True, False], ids=["over", "single"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_cd_models_match_jax(model, mode, grouped):
    d = _data(seed=1)
    t, j = _both(d, model, nulls=False, mode=mode, grouped=grouped)
    _assert_same(t, j)
    assert np.isfinite(t).all()


@pytest.mark.parametrize("grouped", [True, False], ids=["over", "single"])
@pytest.mark.parametrize("policy", POLICIES)
def test_cd_null_policies_match_jax(policy, grouped):
    d = _data(seed=2)
    for mode in MODES:
        _assert_same(*_both(d, "lasso", null_policy=policy, mode=mode, grouped=grouped))


@pytest.mark.parametrize("grouped", [True, False], ids=["over", "single"])
@pytest.mark.parametrize("policy", ["valid", "drop"])
def test_cd_wls_matches_jax(policy, grouped):
    d = _data(seed=3)
    kw = dict(sample_weights="w", grouped=grouped)
    if policy == "drop":
        kw["null_policy"] = "drop"
    for mode in ("predictions", "coefficients"):
        _assert_same(*_both(d, "elastic_net", nulls=policy != "valid", mode=mode, **kw))


@pytest.mark.parametrize("model", ["lasso", "nnls"])
def test_cd_active_set_matches_jax(model):
    d = _data(seed=4)
    for mode in ("predictions", "coefficients"):
        _assert_same(*_both(d, model, nulls=False, mode=mode, solve_method="cd_active_set"))


def test_lasso_sparsity_through_the_api():
    # the chosen alpha leaves both zero and nonzero coefficients, and NNLS
    # none below zero
    d = _data(seed=5)
    lasso, _ = _both(d, "lasso", nulls=False, mode="coefficients")
    assert (lasso == 0).any() and (lasso != 0).any()
    nnls, _ = _both(d, "nnls", nulls=False, mode="coefficients")
    assert nnls.min() >= 0.0 and (nnls > 0).any()


@pytest.mark.parametrize("kw", [dict(l1_ratio=1.0), dict(l1_ratio=0.5, positive=True)],
                         ids=["lasso", "nnls_enet"])
def test_one_group_matches_the_literal_oracle(kw):
    # tests/oracles.py:elastic_net_cd is the reference's row-form CD; the
    # covariance form gives the same iterates
    d = _data(seed=6)
    X, y = d["X"] / np.asarray([1.0, 10.0, 0.1, 100.0]), d["y"]
    df = pt.DataFrame({"y": y, **{f"x{i + 1}": X[:, i] for i in range(K)}})
    got = df.select(pt.col("y").least_squares.elastic_net(
        *[f"x{i + 1}" for i in range(K)], alpha=0.05, mode="coefficients", tol=1e-8, **kw
    ))["coefficients"].to_numpy()[0]
    want = oracles.elastic_net_cd(X, y, alpha=0.05, tol=1e-8, **kw)
    np.testing.assert_allclose(got, want, **TOL)


def test_cd_defaults_follow_the_jax_engine():
    # ols(alpha, solve_method="cd") is an elastic net at l1 0.5, and the
    # default max_iter / tol are 1000 / 1e-5
    d = _data(seed=7)
    df = pt.DataFrame(_cols(pt, d, nulls=False))
    feats = [f"x{i + 1}" for i in range(K)]
    a = df.select(pt.col("y").least_squares.ols(
        *feats, alpha=0.01, solve_method="cd", mode="coefficients").over("g"))
    b = df.select(pt.col("y").least_squares.elastic_net(
        *feats, alpha=0.01, l1_ratio=0.5, max_iter=1000, tol=1e-5, mode="coefficients").over("g"))
    np.testing.assert_array_equal(a["coefficients"].to_numpy(), b["coefficients"].to_numpy())


def test_cpu_cd_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(cd, "cd_kernel_launches", 0)
    d = _data(seed=9)
    pt.DataFrame(_cols(pt, d)).select(_query(pt.col, "lasso", null_policy="drop"))["y"].to_numpy()
    assert cd.cd_kernel_launches == 0
