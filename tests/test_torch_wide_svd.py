"""Wide problems in the PyTorch port: one group of many features, fewer
rows than features, collinear columns, and the plain versions of the
kernels' wide forms.

- One group of 300 rows x 100 features (the reference suite's "large"
  configuration, benchmarks/suite.py:275, at small depth): its queries
  (explicit qr, svd, ridge by Cholesky and by svd, WLS, the auto method,
  statistics) against the JAX package and numpy lstsq; coefficients rtol
  1e-9 / atol 1e-11 (the JAX suite's, tests/test_ozaki.py:60),
  predictions 1e-8 / 1e-10.
- The JAX suite's ``test_fit_wide`` (tests/test_ols.py:243) and
  ``test_fit_multi_collinear`` (:270) through the port, at those tests'
  own tolerances, beside the JAX package; ``test_fit_wide``'s lasso runs
  FISTA and the active-set polish above K = 32.
- The plain versions at wide C against the JAX package and numpy:
  ``grouped_moments_blocks_ref`` (rtol 1e-13 to the f64 einsum form, 5e-13
  to the digit form, tests/test_ozaki.py:39), ``householder_blocks_ref``
  at C = 43 / 101 (1e-12 of each column's norm to the JAX reduction),
  ``factor_lstsq_ref`` at K = 40 / 100 and ``rows_lstsq_ref`` (rtol 1e-9 /
  atol 1e-10 to numpy lstsq, rtol 1e-12 / 1e-12 to the JAX package's
  ``svd_lstsq``, its LAPACK SVD).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import polars_ols_tpu as pj  # noqa: E402
from polars_ols_tpu.ops import direct as jdirect  # noqa: E402
from polars_ols_tpu.ops import linalg as jlinalg  # noqa: E402
from polars_ols_tpu.ops.ozaki import decompose_blocks, moments_from_digits  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.ops import householder, jacobi, moments  # noqa: E402

COEF_TOL = dict(rtol=1e-9, atol=1e-11)
PRED_TOL = dict(rtol=1e-8, atol=1e-10)
NUMPY_TOL = dict(rtol=1e-9, atol=1e-10)
SOLVER_TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


# --------------------------------------------------------------------------- #
# one group of 100 features: the "large" configuration at small depth
# --------------------------------------------------------------------------- #
LARGE_QUERIES = {
    "ols_qr": lambda ls, f: ls.ols(*f, solve_method="qr", mode="coefficients"),
    "ols_svd": lambda ls, f: ls.ols(*f, solve_method="svd", mode="coefficients"),
    "ridge_chol": lambda ls, f: ls.ridge(*f, alpha=0.1, mode="coefficients"),
    "ridge_svd": lambda ls, f: ls.ridge(*f, alpha=0.1, solve_method="svd", mode="coefficients"),
    "wls": lambda ls, f: ls.wls(*f, sample_weights="w", mode="coefficients"),
    "ols": lambda ls, f: ls.ols(*f, mode="coefficients"),
    "statistics": lambda ls, f: ls.ols(*f, mode="statistics"),
}


def _large(n=300, k=100, seed=0):
    """benchmarks/suite.py:_make_df's columns at n rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k))
    y = x.sum(axis=1) + rng.normal(size=n, scale=0.1)
    w = rng.random(n) + 0.1
    return x, y, w


@pytest.mark.parametrize("query", sorted(LARGE_QUERIES))
def test_one_group_of_100_features_matches_jax_and_numpy(query):
    x, y, w = _large()
    feats = [f"x{i + 1}" for i in range(x.shape[1])]
    out = []
    for mod in (pt, pj):
        df = mod.DataFrame({"y": y, **{f: x[:, i] for i, f in enumerate(feats)}, "w": w})
        out.append(df.select(LARGE_QUERIES[query](mod.col("y").least_squares, feats)))
    if query == "statistics":
        t, j = (o["statistics"].arrays for o in out)
        for key in ("coefficients", "standard_errors", "t_values", "p_values", "r2", "mse", "mae"):
            np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]), rtol=1e-8, atol=1e-12, err_msg=key)
        beta = t["coefficients"].numpy()[0]
    else:
        t, j = (np.asarray(o["coefficients"].to_numpy()) for o in out)
        np.testing.assert_allclose(t, j, **COEF_TOL)
        beta = t[0]
    sw = np.sqrt(w) if query == "wls" else np.ones_like(w)
    alpha = 0.1 if query.startswith("ridge") else 0.0
    A = x * sw[:, None]
    want = np.linalg.solve(A.T @ A + alpha * np.eye(x.shape[1]), A.T @ (y * sw))
    np.testing.assert_allclose(beta, want, **NUMPY_TOL)


# --------------------------------------------------------------------------- #
# the JAX suite's wide and collinear cases
# --------------------------------------------------------------------------- #
def _make_data(mod, n_samples, n_features, scale, dup=False):
    """tests/test_ols.py:_make_data (no groups, no nulls) for either engine;
    ``dup`` adds test_fit_multi_collinear's column x_{K+1} = x_K + 1e-12
    (made here: the port's frame has no column arithmetic yet, ROADMAP
    Queue 1 item 10)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n_samples, n_features))
    eps = rng.normal(size=n_samples, scale=scale)
    data = {f"x{i + 1}": x[:, i] for i in range(n_features)}
    data["y"] = x.sum(1) + eps
    if dup:
        data[f"x{n_features + 1}"] = data[f"x{n_features}"] + 1.0e-12
    return mod.DataFrame(data), x, data["y"]


@pytest.mark.parametrize("n_features", (2, 10, 100, 1_000))
def test_fit_wide(n_features):
    # tests/test_ols.py:243 through the port: ols and ridge on 10 rows,
    # their predictions correlated with y to 1e-5 (that test's tolerance),
    # ols at numpy's minimum-norm solution
    df, x, y = _make_data(pt, 10, n_features, 1e-4)
    features = [pt.col(f"x{i + 1}") for i in range(n_features)]
    ls = pt.col("y").least_squares
    out = df.with_columns(
        ls.ols(*features, mode="coefficients").alias("coef_ols"),
        ls.ridge(*features, mode="coefficients", alpha=1e-5).alias("coef_ridge"),
    )
    for cname in ("coef_ols", "coef_ridge"):
        preds = (
            out.with_columns(coefficients=out[cname])
            .select(pt.col("coefficients").least_squares.predict(*features))["predictions"]
            .to_numpy()
        )
        corr = np.corrcoef(preds, y)[0, 1]
        assert corr == pytest.approx(1.0, rel=1e-5, abs=1e-5), cname
    beta = np.asarray(out["coef_ols"].to_numpy())[0]
    np.testing.assert_allclose(beta, np.linalg.lstsq(x, y, rcond=None)[0], **NUMPY_TOL)
    # the lasso: cyclic CD up to K = 32, FISTA and the active-set polish
    # above (12,000 iterations at this alpha and tol); its predictions
    # correlated with y to 1e-5, as the JAX test holds the JAX engine's
    lasso = ls.lasso(*features, mode="coefficients", alpha=1e-6, tol=1e-8, max_iter=3_000)
    coef = np.asarray(df.select(lasso)["coefficients"].to_numpy())
    assert coef.shape == (1, n_features) and np.isfinite(coef).all()
    corr = np.corrcoef(x @ coef[0], y)[0, 1]
    assert corr == pytest.approx(1.0, rel=1e-5, abs=1e-5), "coef_lasso"


@pytest.mark.parametrize(
    "n_features, solve_method",
    [(10, "svd"), (99, "svd"), (300, "svd"), (90, "qr")],
)
def test_fit_multi_collinear(n_features, solve_method):
    # tests/test_ols.py:270 through the port, at its tolerances, and the
    # port's coefficients against the JAX package's at the same ones
    coefs = []
    for mod in (pt, pj):
        df, _, _ = _make_data(mod, 100, n_features, 1e-4, dup=True)
        features = [mod.col(f) for f in df.columns if f.startswith("x")]
        coef = (
            df.select(mod.col("y").least_squares.ols(
                *features, mode="coefficients", solve_method=solve_method, rcond=1e-16
            ))
            ["coefficients"]
            .to_numpy()[0]
        )
        feats = [f for f in df.columns if f.startswith("x")]
        x = np.stack([df[f].to_numpy() for f in feats], axis=1)
        y = df["y"].to_numpy()
        coefs.append(coef)
    coef_expected = np.linalg.lstsq(x, y, rcond=1e-16)[0]
    for coef in coefs:
        if solve_method == "svd":
            assert np.allclose(coef, coef_expected, rtol=1e-2, atol=1e-2)
            assert np.allclose(x @ coef, x @ coef_expected, rtol=1e-4, atol=1e-4)
        else:
            assert not np.isnan(coef).any()
            assert np.allclose(x @ coef, x @ coef_expected, rtol=1e-4, atol=1e-4)
    assert np.allclose(x @ coefs[0], x @ coefs[1], rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# the plain versions of the wide forms
# --------------------------------------------------------------------------- #
def _blocks(seed: int, n_groups: int, R: int, C: int):
    rng = np.random.default_rng(seed)
    n_blocks = rng.integers(1, 4, size=n_groups)
    S = int(n_blocks.sum())
    Zp = rng.normal(size=(S, R, C)) * np.exp(rng.normal(size=(1, 1, C)) * 3)
    wp = rng.random((S, R)) > 0.15
    return Zp, wp, np.repeat(np.arange(n_groups), n_blocks), np.concatenate([[0], np.cumsum(n_blocks)])


@pytest.mark.parametrize("G,R,C", [(3, 64, 34), (4, 37, 64), (2, 40, 101)])
def test_plain_moments_at_wide_c_match_jax(G, R, C):
    Zp, wp, bg, offsets = _blocks(C, G, R, C)
    M_t, c_t = moments.grouped_moments_blocks(
        torch.as_tensor(Zp), torch.as_tensor(wp), torch.as_tensor(offsets), G
    )
    M_t = M_t.numpy()
    XtX_j, Xty_j, c_j = jdirect.grouped_moments(
        jnp.asarray(Zp[..., 1:]), jnp.asarray(Zp[..., 0]), jnp.asarray(wp), jnp.asarray(bg), G
    )
    for t, j in ((M_t[:, 1:, 1:], XtX_j), (M_t[:, 1:, 0], Xty_j)):
        j = np.asarray(j)
        np.testing.assert_allclose(t, j, rtol=1e-13, atol=1e-13 * np.abs(j).max())
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    Zcat, m = decompose_blocks(jnp.asarray(Zp), jnp.asarray(wp))
    M_d, _ = moments_from_digits(Zcat, m, jnp.asarray(wp), jnp.asarray(bg), G)
    M_d = np.asarray(M_d)
    np.testing.assert_allclose(M_t, M_d, rtol=5e-13, atol=1e-13 * np.abs(M_d).max())


@pytest.mark.parametrize("B,R,C,k", [(6, 200, 43, 3), (3, 150, 101, 100), (3, 60, 101, 100)])
def test_plain_householder_at_wide_c_matches_jax(B, R, C, k):
    # a block of fewer rows than features (R = 60 < K = 100) gives zero
    # rows below its last
    rng = np.random.default_rng(C + R)
    Z = rng.normal(size=(B, R, C)) * np.exp(rng.normal(size=(1, 1, C)))
    w = rng.random((B, R)) > 0.2
    T = householder.householder_blocks(torch.as_tensor(Z), torch.as_tensor(w), k).numpy()
    Zs = np.where(w[..., None], Z, 0.0)
    if R < k:
        Zs = np.concatenate([Zs, np.zeros((B, k - R, C))], axis=1)
        assert (T[:, R:] == 0).all()
    m = C - k
    Rj, Qj = jlinalg._householder_reduce(jnp.asarray(Zs[..., m:]), jnp.asarray(Zs[..., :m]))
    norm = np.sqrt((Zs * Zs).sum(axis=1, keepdims=True))
    assert (np.abs(T[..., m:] - np.asarray(Rj)) <= 1e-12 * norm[..., m:]).all()
    assert (np.abs(T[..., :m] - np.asarray(Qj)) <= 1e-12 * norm[..., :m]).all()


@pytest.mark.parametrize("K,G", [(40, 4), (100, 2)])
def test_plain_factor_lstsq_at_wide_k_matches_jax_and_numpy(K, G):
    # the rotations of ops/jacobi.py:factor_lstsq_ref at K > 32: within the
    # 30-sweep cap (K = 100 takes 9 sweeps on these factors), at numpy's
    # beta and the JAX package's LAPACK-SVD solve
    rng = np.random.default_rng(K)
    X = rng.normal(size=(G, 3 * K + 2, K)) * np.exp(rng.normal(size=(G, 1, K)))
    F = np.linalg.qr(X, mode="r")
    Y = rng.normal(size=(G, K, 2))
    n_valid = torch.full((G,), 3.0 * K + 2, dtype=torch.float64)
    _, _, sweeps, _ = jacobi.jacobi_ref(torch.as_tensor(F))
    assert int(sweeps.max()) < jacobi.MAX_SWEEPS
    t = jacobi.factor_lstsq(torch.as_tensor(F), torch.as_tensor(Y), n_valid).numpy()
    j = np.asarray(jlinalg.svd_lstsq(jnp.asarray(F), jnp.asarray(Y), n_valid=jnp.asarray(n_valid.numpy())))
    np.testing.assert_allclose(t, j, **SOLVER_TOL)
    for g in range(G):
        np.testing.assert_allclose(t[g], np.linalg.lstsq(F[g], Y[g], rcond=None)[0], **NUMPY_TOL)


@pytest.mark.parametrize("K,n", [(100, 10), (1_000, 10), (40, 33)])
def test_plain_rows_lstsq_matches_jax_and_numpy(K, n):
    # fewer rows than features above K = 32: the n columns of X^T rotated
    # (ops/jacobi.py:rows_lstsq_ref, through linalg.svd_lstsq), against the
    # JAX package's svd_lstsq of X and numpy's minimum-norm lstsq
    rng = np.random.default_rng(K + n)
    X = rng.normal(size=(2, n, K))
    Y = rng.normal(size=(2, n, 2))
    from polars_ols_tpu_torch.ops import linalg

    t = linalg.svd_lstsq(torch.as_tensor(X), torch.as_tensor(Y)).numpy()
    j = np.asarray(jlinalg.svd_lstsq(jnp.asarray(X), jnp.asarray(Y)))
    np.testing.assert_allclose(t, j, **SOLVER_TOL)
    for g in range(2):
        np.testing.assert_allclose(t[g], np.linalg.lstsq(X[g], Y[g], rcond=None)[0], **NUMPY_TOL)
    Xn = X.copy()
    Xn[1, 0, 0] = np.nan
    b = jacobi.rows_lstsq(torch.as_tensor(Xn).mT, torch.as_tensor(Y), torch.full((2,), float(n), dtype=torch.float64))
    assert torch.isnan(b[1]).all() and torch.isfinite(b[0]).all()
