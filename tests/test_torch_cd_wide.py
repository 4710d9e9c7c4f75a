"""Coordinate descent above 32 features through both engines.

Above K = 32 the JAX engine's ``solve_elastic_net_cov`` runs FISTA with an
active-set polish (``_cd_cov_single_fista``, ``_active_set_polish``), or
for ``cd_active_set`` the cyclic ``_cd_cov_single``; the port runs the
same routes (``ops/cd.py``), on the CPU through their plain versions,
whose sums are in the tree order of the CUDA kernels
(``csrc/cd_wide.cu``).

- The tree order: ``_tree_sum`` against a literal emulation of a warp's
  lanes (each lane's streamed halving tree over its strided terms, a stack
  of partial sums, then the xor butterfly), bit for bit.
- The plain routes on moments against the JAX function at K = 33, 40 and
  100 over several groups, ``positive`` on and off, with a group without
  rows (zero coefficients after one iteration) and a NaN group (NaN
  coefficients after one iteration, as 'ignore' gives it).
- The polish alone against the JAX engine's on the same iterate: its
  second round (a support missing a coordinate that the KKT conditions
  admit) and its monotone safeguard on the underdetermined lasso (n << K,
  a_l2 = 0).
- The public API: lasso / elastic net / NNLS / ``cd_active_set`` under
  the five static null policies, ``mode="statistics"``, and the JAX
  suite's ``test_elastic_net`` cases above 32 against sklearn.

Tolerances: the JAX suite's for its CD, rtol 1e-8 / atol 1e-10
(tests/test_ols.py:465); sklearn at its own (rtol / atol 1e-4, and the
positive case's 1e-3 / 1e-4, tests/test_ols.py:352-418). Row 0 of a frame
stays valid and finite (see tests/test_torch_static.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import polars_ols_tpu as pj  # noqa: E402
from polars_ols_tpu import CONFIG as JCONFIG  # noqa: E402
from polars_ols_tpu.ops import cd as jcd  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.ops import cd  # noqa: E402

TOL = dict(rtol=1e-8, atol=1e-10)
CHUNK_ROWS = 64
POLICIES = ["ignore", "zero", "drop", "drop_zero", "drop_y_zero_x"]


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    monkeypatch.setattr(CONFIG, "moment_chunk_rows", CHUNK_ROWS)
    monkeypatch.setattr(JCONFIG, "moment_chunk_rows", CHUNK_ROWS)


# --------------------------------------------------------------------------- #
# the tree order
# --------------------------------------------------------------------------- #
def _lanes_sum(terms):
    """A warp's sum of ``terms`` [K] as csrc/cd_wide.cu:tree_sum makes it:
    lane l streams its terms k = l + 32 t in bit-reversed t through a
    binary-counter stack (a leaf past K is +0.0), then the lanes' sums go
    through the xor butterfly; lane 0's result."""
    K = len(terms)
    M = cd.tree_width(K) // 32
    bits = M.bit_length() - 1
    lane_sums = []
    for lane in range(32):
        stack = [0.0] * (bits + 1)
        for idx in range(M):
            t = int(format(idx, f"0{bits}b")[::-1], 2) if bits else 0
            k = lane + 32 * t
            v = float(terms[k]) if k < K else 0.0
            lev = 0
            while lev < bits and (idx >> lev) & 1:
                v = stack[lev] + v
                lev += 1
            stack[lev] = v
        lane_sums.append(stack[bits])
    for off in (16, 8, 4, 2, 1):
        lane_sums = [lane_sums[i] + lane_sums[i ^ off] for i in range(32)]
    return lane_sums[0]


@pytest.mark.parametrize("K", [33, 40, 64, 100, 129, 1_000])
def test_tree_sum_is_the_kernels_lane_order(K):
    rng = np.random.default_rng(K)
    terms = rng.normal(size=K) * np.exp(rng.normal(size=K) * 8)  # magnitudes 1e-10 .. 1e10
    got = float(cd._tree_sum(cd._padded(torch.as_tensor(terms)[None]))[0])
    want = _lanes_sum(terms)
    assert got == want
    assert cd.tree_width(K) == max(32, 1 << (K - 1).bit_length())


def test_matvec_rows_are_tree_sums():
    rng = np.random.default_rng(1)
    A = torch.as_tensor(rng.normal(size=(2, 45, 45)))
    x = torch.as_tensor(rng.normal(size=(2, 45)))
    q = cd._matvec(cd._padded(A), cd._padded(x))
    assert q.shape == (2, 64) and float(q[:, 45:].abs().max()) == 0.0
    for g in range(2):
        for i in (0, 17, 44):
            assert float(q[g, i]) == _lanes_sum((A[g, i] * x[g]).numpy())


# --------------------------------------------------------------------------- #
# the plain routes on moments against the JAX function
# --------------------------------------------------------------------------- #
def _moments(seed: int, G: int, K: int, rows=None):
    """Moments of G groups of K + 10 .. 3 K rows (``rows`` each where
    given) with sparse coefficients of both signs; group 0 has no rows and
    group 1 a NaN entry."""
    rng = np.random.default_rng(seed)
    n = rng.integers(K + 10, 3 * K, size=G) if rows is None else np.full(G, rows)
    XtX = np.zeros((G, K, K))
    Xty = np.zeros((G, K))
    for g in range(G):
        X = rng.normal(size=(int(n[g]), K)) @ (np.eye(K) + 0.3 * rng.normal(size=(K, K)) / np.sqrt(K))
        y = X @ (rng.normal(size=K) * (rng.random(K) > 0.5)) + rng.normal(size=int(n[g]))
        XtX[g], Xty[g] = X.T @ X, X.T @ y
    nv = n.astype(float)
    if G > 2:
        XtX[0], Xty[0], nv[0] = 0.0, 0.0, 0.0
        XtX[1, 3, 5] = XtX[1, 5, 3] = np.nan
    return XtX, Xty, nv


ROUTE_CASES = {
    # id: (K, groups, settings)
    "k33_enet": (33, 6, dict(alpha=0.05, l1_ratio=0.5)),
    "k33_active_set": (33, 6, dict(alpha=0.05, l1_ratio=1.0, active_set=True)),
    "k40_lasso_positive": (40, 6, dict(alpha=0.05, l1_ratio=1.0, positive=True)),
    "k40_active_set_positive": (40, 5, dict(alpha=0.02, l1_ratio=0.6, positive=True, active_set=True)),
    "k40_l1_zero": (40, 4, dict(alpha=0.05, l1_ratio=0.0)),
    "k100_enet": (100, 4, dict(alpha=0.05, l1_ratio=0.5)),
    "k100_active_set": (100, 3, dict(alpha=0.2, l1_ratio=1.0, active_set=True)),
    "k100_max_iter": (100, 4, dict(alpha=0.001, l1_ratio=1.0, max_iter=3)),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_wide_routes_match_jax(case):
    K, G, kw = ROUTE_CASES[case]
    XtX, Xty, n = _moments(K + G, G, K)
    w, counts = cd.solve_elastic_net_cov_ref(torch.as_tensor(XtX), torch.as_tensor(Xty), torch.as_tensor(n), **kw)
    wj = np.asarray(jcd.solve_elastic_net_cov(XtX, Xty, n, **kw))
    w = w.numpy()
    np.testing.assert_array_equal(np.isnan(w), np.isnan(wj))
    np.testing.assert_allclose(w, wj, **TOL)
    assert counts.dtype == torch.int32
    assert float(np.abs(w[0]).max()) == 0.0 and int(counts[0]) == 1  # no rows
    assert np.isnan(w[1]).any() and int(counts[1]) == 1  # NaN: the stop test is false at once
    cap = kw.get("max_iter", 1000) * (1 if kw.get("active_set") else 4)
    assert int(counts.max()) <= cap
    if "max_iter" in kw:
        assert int(counts.max()) == cap
    rest = w[2:]
    assert (rest == 0).any() and (rest != 0).any() or kw["l1_ratio"] == 0.0
    if kw.get("positive"):
        assert rest.min() >= 0.0


def test_wide_wrapper_on_cpu_is_the_plain_version(monkeypatch):
    for name in ("cd_kernel_launches", "fista_kernel_launches", "cyclic_wide_kernel_launches"):
        monkeypatch.setattr(cd, name, 0)
    XtX, Xty, n = (torch.as_tensor(a) for a in _moments(3, 4, 36))
    for kw in (dict(alpha=0.05), dict(alpha=0.05, l1_ratio=1.0, active_set=True)):
        w, c = cd.solve_elastic_net_cov(XtX, Xty, n, **kw)
        w_ref, c_ref = cd.solve_elastic_net_cov_ref(XtX, Xty, n, **kw)
        assert torch.equal(torch.nan_to_num(w), torch.nan_to_num(w_ref)) and torch.equal(c, c_ref)
    assert cd.cd_kernel_launches == cd.fista_kernel_launches == cd.cyclic_wide_kernel_launches == 0


def test_fista_keeps_a_finished_groups_iterate():
    # groups stop at different iterations: each keeps its own iterate, so a
    # group alone gives what it gives among others (in the kernel's order)
    XtX, Xty, n = (torch.as_tensor(a) for a in _moments(5, 5, 40))
    args = (0.01, 0.5, 1000, 1e-5, False)
    w_all, it_all = cd.fista_ref(XtX, Xty, n, *args, kernel_order=True)
    assert len(set(it_all[2:].tolist())) > 1
    for g in (2, 4):
        w_one, it_one = cd.fista_ref(XtX[g : g + 1], Xty[g : g + 1], n[g : g + 1], *args, kernel_order=True)
        assert torch.equal(w_one[0], w_all[g]) and int(it_one[0]) == int(it_all[g])


@pytest.mark.parametrize("K", [33, 100])
def test_fista_in_the_kernels_order_matches_jax(K):
    # the tree order (what the card holds the kernel to, bit for bit) runs
    # the same iteration as the CPU path's library products: after the
    # polish both match the JAX engine
    kw = dict(alpha=0.05, l1_ratio=0.5, max_iter=1000, tol=1e-5, positive=K == 33)
    XtX, Xty, n = _moments(K + 7, 4, K)
    args = (torch.as_tensor(XtX), torch.as_tensor(Xty), torch.as_tensor(n))
    wj = np.asarray(jcd.solve_elastic_net_cov(XtX, Xty, n, **kw))
    w_tree, it_tree = cd.fista_ref(*args, *kw.values(), kernel_order=True)
    w_lib, it_lib = cd.fista_ref(*args, *kw.values())
    strengths = cd._strengths(args[2], kw["alpha"], kw["l1_ratio"])
    for w in (w_tree, w_lib):
        got = cd.active_set_polish(args[0], args[1], *strengths, w, kw["positive"]).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(wj))
        np.testing.assert_allclose(got, wj, **TOL)
    assert int(it_tree[0]) == int(it_lib[0]) == 1 and int(it_tree[1]) == 1
    assert np.abs(it_tree.numpy()[2:] - it_lib.numpy()[2:]).max() <= 2


# --------------------------------------------------------------------------- #
# the polish
# --------------------------------------------------------------------------- #
def _both_polish(XtX, Xty, n, alpha, l1_ratio, w, positive=False):
    a = alpha * np.maximum(n, 1.0)
    a_l1, a_l2 = a * l1_ratio, a * (1.0 - l1_ratio)
    got = cd.active_set_polish(*(torch.as_tensor(v) for v in (XtX, Xty, a_l1, a_l2, w)), positive).numpy()
    want = np.asarray(jcd._active_set_polish(*(jnp.asarray(v) for v in (XtX, Xty, a_l1, a_l2, w)), positive))
    return got, want, a_l1, a_l2


def _objective(XtX, Xty, a_l1, a_l2, w):
    return 0.5 * w @ XtX @ w - Xty @ w + a_l1 * np.abs(w).sum() + 0.5 * a_l2 * w @ w


def test_polish_second_round_admits_what_the_kkt_conditions_ask():
    # the FISTA iterate with its smallest support coordinate zeroed: round 1
    # solves on the smaller support, the zeroed coordinate violates its KKT
    # condition, round 2 admits it with the residual's sign, and the result
    # is the optimum (the KKT conditions hold)
    XtX, Xty, n = _moments(11, 4, 36)
    XtX, Xty, n = XtX[2:], Xty[2:], n[2:]
    alpha, l1 = 0.05, 0.7
    w, _ = cd.fista_ref(*(torch.as_tensor(v) for v in (XtX, Xty, n)), alpha, l1, 1000, 1e-8, False)
    w = w.numpy().copy()
    j = int(np.argmin(np.where(w[0] != 0, np.abs(w[0]), np.inf)))
    w[0, j] = 0.0
    got, want, a_l1, a_l2 = _both_polish(XtX, Xty, n, alpha, l1, w)
    np.testing.assert_allclose(got, want, **TOL)
    assert got[0, j] != 0.0
    for g in range(2):
        r = Xty[g] - XtX[g] @ got[g] - a_l2[g] * got[g]
        on = got[g] != 0
        np.testing.assert_allclose(r[on], a_l1[g] * np.sign(got[g][on]), rtol=1e-9, atol=1e-9)
        assert (np.abs(r[~on]) <= a_l1[g] * (1 + 1e-9)).all()


@pytest.mark.parametrize("positive", [False, True], ids=["lasso", "nnls"])
def test_polish_safeguard_on_the_underdetermined_lasso(positive):
    # n << K with a_l2 = 0: the support's system is rank-deficient; the
    # polish keeps a group's result only where it does not raise the
    # objective, and so never returns a worse point than FISTA's
    K, rows = 60, 12
    XtX, Xty, n = _moments(12, 4, K, rows=rows)
    XtX, Xty, n = XtX[2:], Xty[2:], n[2:]
    alpha = 1e-3
    w, _ = cd.fista_ref(*(torch.as_tensor(v) for v in (XtX, Xty, n)), alpha, 1.0, 50, 1e-5, positive)
    w = w.numpy()
    got, want, a_l1, a_l2 = _both_polish(XtX, Xty, n, alpha, 1.0, w, positive)
    np.testing.assert_allclose(got, want, **TOL)
    for g in range(2):
        assert _objective(XtX[g], Xty[g], a_l1[g], 0.0, got[g]) <= _objective(XtX[g], Xty[g], a_l1[g], 0.0, w[g])
    if positive:
        assert got.min() >= 0.0


def test_polish_keeps_a_nan_group_and_zero_group():
    XtX, Xty, n = _moments(13, 3, 34)
    w = np.zeros((3, 34))
    w[1] = np.nan
    w[2, :3] = 0.1
    got, want, _, _ = _both_polish(XtX, Xty, n, 0.05, 0.5, w)
    assert np.isnan(got[1]).all() and float(np.abs(got[0]).max()) == 0.0
    np.testing.assert_allclose(got, want, **TOL)


# --------------------------------------------------------------------------- #
# the public API
# --------------------------------------------------------------------------- #
def _frame_data(k: int, n: int = 600, groups: int = 4, seed: int = 0, null_rate: float = 0.02):
    rng = np.random.default_rng(seed + k)
    gids = rng.integers(groups, size=n)
    X = rng.normal(size=(n, k))
    y = X @ (np.linspace(1.0, -0.5, k) * (rng.random(k) > 0.5)) + rng.normal(size=n) * 0.5
    valid = rng.random((n, 1 + k)) > null_rate
    valid[gids % 2 == 0] = True  # groups without nulls: finite under every policy
    valid[0] = True
    return dict(y=y, X=X, valid=valid, gids=gids)


def _frame(mod, d):
    k = d["X"].shape[1]
    v = d["valid"]
    cols = {"y": mod.Series("y", d["y"], v[:, 0])}
    for i in range(k):
        cols[f"x{i}"] = mod.Series(f"x{i}", d["X"][:, i], v[:, 1 + i])
    cols["g"] = d["gids"].astype(float)
    return mod.DataFrame(cols)


def _both(d, build):
    feats = [f"x{i}" for i in range(d["X"].shape[1])]
    out = []
    for mod in (pt, pj):
        s = _frame(mod, d).select(build(mod.col("y").least_squares, feats))
        out.append(s[s.columns[0]])
    return out


def _assert_same(t, j):
    tv, jv = np.asarray(t.to_numpy(), dtype=float), np.asarray(j.to_numpy(), dtype=float)
    tm = None if t.validity is None else np.asarray(t.validity)
    jm = None if j.validity is None else np.asarray(j.validity)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv))
    np.testing.assert_allclose(tv, jv, **TOL)
    return tv


@pytest.mark.parametrize("policy", POLICIES)
def test_null_policies_above_32_match_jax(policy):
    # lasso (FISTA) in the three modes and cd_active_set's predictions under
    # each static null policy, 4 groups of ~150 rows at K = 36
    d = _frame_data(36, seed=1)
    for mode in ("predictions", "residuals", "coefficients"):
        tv = _assert_same(*_both(d, lambda ls, f: ls.lasso(*f, alpha=0.05, mode=mode, null_policy=policy).over("g")))
        assert np.isfinite(tv[d["gids"] % 2 == 0]).all()
    _assert_same(*_both(d, lambda ls, f: ls.lasso(
        *f, alpha=0.05, solve_method="cd_active_set", null_policy=policy).over("g")))


@pytest.mark.parametrize("model", ["elastic_net", "cd_active_set"])
def test_statistics_above_32_match_jax(model):
    # mode="statistics": the coefficients field is the CD estimate, r2 /
    # mae / mse its residuals', se / t / p from the normal equations
    d = _frame_data(40, seed=2)
    kw = dict(alpha=0.05, l1_ratio=0.5) if model == "elastic_net" else dict(alpha=0.05, solve_method="cd_active_set")
    method = "elastic_net" if model == "elastic_net" else "lasso"
    t, j = _both(d, lambda ls, f: getattr(ls, method)(*f, mode="statistics", null_policy="drop", **kw).over("g"))
    ta, ja = t.arrays, j.arrays
    for key in pt.StatisticsSeries.SCALAR_FIELDS + pt.StatisticsSeries.LIST_FIELDS:
        np.testing.assert_allclose(ta[key].numpy(), np.asarray(ja[key]), err_msg=key, **TOL)
    assert (ta["coefficients"].numpy() == 0).any()


def _sklearn_data(k: int, sparsity: float, n: int = 2_000):
    """tests/test_ols.py:_make_data(n_features=k, sparsity=...), seed 0."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, k))
    eps = rng.normal(size=n, scale=0.1)
    return x, x[:, : int(k * (1.0 - sparsity))].sum(1) + eps


@pytest.mark.parametrize(
    "k,sparsity,solve_method,positive",
    [(50, 0.5, "cd", False), (100, 0.9, "cd", False), (100, 0.9, "cd_active_set", False), (50, 0.5, "cd", True)],
    ids=["k50", "k100", "k100_active_set", "k50_positive"],
)
def test_elastic_net_above_32_matches_sklearn(k, sparsity, solve_method, positive):
    # the JAX suite's test_elastic_net / test_elastic_net_positive_large_k
    # (tests/test_ols.py:352-418) through the port, at their tolerances
    from sklearn.linear_model import ElasticNet

    x, y = _sklearn_data(k, sparsity)
    mdl = ElasticNet(fit_intercept=False, alpha=0.3, l1_ratio=0.5, positive=positive, max_iter=1000, tol=1e-4)
    mdl.fit(x, y)
    df = pt.DataFrame({"y": y, **{f"x{i + 1}": x[:, i] for i in range(k)}})
    expr = pt.col("y").least_squares.elastic_net(
        *[pt.col(f"x{i + 1}") for i in range(k)], l1_ratio=0.5, alpha=0.3, max_iter=1000, tol=1e-4,
        solve_method=solve_method, positive=positive, mode="coefficients" if positive else "predictions",
    )
    out = df.select(expr)
    if positive:
        coefs = out["coefficients"].to_numpy()[0]
        assert (coefs >= 0.0).all()
        np.testing.assert_allclose(coefs, mdl.coef_, rtol=1e-3, atol=1e-4)
    else:
        np.testing.assert_allclose(out["y"].to_numpy(), mdl.predict(x), rtol=1e-4, atol=1e-4)
