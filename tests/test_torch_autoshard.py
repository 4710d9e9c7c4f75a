"""Every model family of the PyTorch port through the expression API with
CONFIG.auto_shard on (a mesh of 8 virtual CPU shards), against the port on
one shard and against the JAX package's single-device output.

The 14 cases of tests/test_autoshard.py on the same seeded frames. The
sharded output is held to the port's one-shard output at that file's
tolerances (rtol 1e-8 / atol 1e-10 for the families; its own for
multi-target, coefficients and statistics), and to the JAX engine on one
device at the port's parity tolerances: the static fits and statistics at
rtol 1e-8 / atol 1e-10 (p-values rtol 1e-6), the moving models at the
moving solvers' rtol 1e-7 / atol 1e-9 (tests/test_torch_moving_api.py),
rolling windows from the row on where a group holds K + 3 rows (a window
with fewer rows than features is singular, and round-off picks its
branch in both engines). Each case checks that the query took the sharded
path (``parallel.sharded.calls``). The JAX outputs are computed once a
module, with its auto_shard off: no JAX sharded program is compiled.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import polars_ols_tpu as pj  # noqa: E402
from polars_ols_tpu.config import CONFIG as JCONFIG  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.parallel import sharded  # noqa: E402

FAMILY_TOL = dict(rtol=1e-8, atol=1e-10)
MOVING_TOL = dict(rtol=1e-7, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    monkeypatch.setattr(CONFIG, "virtual_devices", 8)
    monkeypatch.setattr(CONFIG, "auto_shard", False)
    monkeypatch.setattr(JCONFIG, "auto_shard", False)


def _data(n=4_000, n_groups=64, nulls=False, seed=31):
    rng = np.random.default_rng(seed)
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    y = 1.5 * x1 - 0.5 * x2 + rng.normal(size=n) * 0.1
    d = {"x1": x1, "x2": x2, "w": rng.uniform(0.5, 2.0, size=n)}
    mask = None
    if nulls:
        mask = ~(rng.random(n) < 0.1)
        y = np.where(mask, y, 0.0)
    return d, y, mask, rng.integers(n_groups, size=n).astype(float)


def _frame(mod, nulls=False):
    d, y, mask, g = _data(nulls=nulls)
    return mod.DataFrame({**d, "y": mod.Series("y", y, mask), "g": g})


def _first(res):
    return res[res.columns[0]].to_numpy()


def _select(mod, df, expr, shard=None):
    """The first column of ``df.select(expr)``; on the port with auto_shard
    at ``shard``, the sharded calls checked."""
    if mod is pj:
        return _first(df.select(expr))
    CONFIG.auto_shard = shard
    before = dict(sharded.calls)
    try:
        out = df.select(expr)
    finally:
        CONFIG.auto_shard = False
    took = sum(sharded.calls.values()) - sum(before.values())
    assert took == (1 if shard else 0), (shard, took)
    return out


FAMILIES = {
    "ols": ("ols", {}, False),
    "ols_lu": ("ols", {"solve_method": "lu"}, False),
    "ols_nulls_drop": ("ols", {"null_policy": "drop"}, True),
    "ridge": ("ridge", {"alpha": 0.05}, False),
    "wls": ("wls", {"sample_weights": "w"}, False),
    "lasso": ("lasso", {"alpha": 0.001}, False),
    "elastic_net": ("elastic_net", {"alpha": 0.001, "l1_ratio": 0.5}, False),
    "rls": ("rls", {"half_life": 30.0}, False),
    "rolling": ("rolling_ols", {"window_size": 40}, False),
    "expanding": ("expanding_ols", {}, False),
}


def _expr(mod, name, **extra):
    fn, kw, _ = FAMILIES[name]
    kw = dict(kw, **extra)
    if "sample_weights" in kw:
        kw["sample_weights"] = mod.col(kw["sample_weights"])
    return getattr(mod.col("y").least_squares, fn)(mod.col("x1"), mod.col("x2"), **kw).over("g")


_JAX = {}


def _jax(key, build):
    if key not in _JAX:
        _JAX[key] = build()
    return _JAX[key]


def _settled(g, k=2):
    """Rows from the one on where their group holds K + 3 rows."""
    rank = np.zeros(len(g), dtype=np.int64)
    seen = {}
    for i, v in enumerate(g):
        rank[i] = seen.get(v, 0)
        seen[v] = rank[i] + 1
    return rank >= k + 3


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_sharded_matches_single_device(name):
    nulls = FAMILIES[name][2]
    df = _frame(pt, nulls)
    single = _first(_select(pt, df, _expr(pt, name), shard=False))
    out = _first(_select(pt, df, _expr(pt, name), shard=True))
    np.testing.assert_allclose(out, single, equal_nan=True, **FAMILY_TOL)
    ref = _jax(name, lambda: _select(pj, _frame(pj, nulls), _expr(pj, name)))
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    if FAMILIES[name][0] in ("rls", "rolling_ols", "expanding_ols"):
        m = _settled(_data()[3]) & ~np.isnan(ref)
        np.testing.assert_allclose(out[m], ref[m], **MOVING_TOL)
    else:
        np.testing.assert_allclose(out, ref, equal_nan=True, **FAMILY_TOL)


def _mt_data():
    rng = np.random.default_rng(7)
    n, G = 4_000, 64
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    return {
        "x1": x1, "x2": x2, "y1": x1 - x2 + rng.normal(size=n) * 0.1,
        "y2": 2.0 * x1 + x2 + rng.normal(size=n) * 0.1, "g": rng.integers(G, size=n).astype(float),
    }


def _mt_expr(mod):
    return (
        mod.struct(mod.col("y1"), mod.col("y2")).least_squares.multi_target_ols(mod.col("x1"), mod.col("x2"))
        .over("g").alias("preds")
    )


def test_sharded_multi_target():
    """Multi-target fits (one shared SVD a group) shard the groups."""
    df = pt.DataFrame(_mt_data())
    single = _select(pt, df, _mt_expr(pt), shard=False)["preds"].to_numpy()
    out = _select(pt, df, _mt_expr(pt), shard=True)["preds"].to_numpy()
    np.testing.assert_allclose(out, single, rtol=1e-10, atol=1e-12)
    ref = _jax("mt", lambda: pj.DataFrame(_mt_data()).select(_mt_expr(pj))["preds"].to_numpy())
    np.testing.assert_allclose(out, ref, **FAMILY_TOL)


def _check_stats(stats, ref, rel=1e-8, coef=None):
    for s, s1 in zip(stats, ref):
        for key in ("r2", "mse", "mae"):
            assert s[key] == pytest.approx(s1[key], rel=rel)
        if coef is not None:
            np.testing.assert_allclose(s["coefficients"], s1["coefficients"], **coef)
        np.testing.assert_allclose(s["standard_errors"], s1["standard_errors"], rtol=1e-7)
        np.testing.assert_allclose(s["p_values"], s1["p_values"], rtol=1e-6, atol=1e-12)


def test_sharded_coefficients_and_statistics():
    df = _frame(pt)

    def coefs(shard):
        e = pt.col("y").least_squares.ols(pt.col("x1"), pt.col("x2"), mode="coefficients").over("g")
        return _select(pt, df, e, shard).unnest("coefficients").to_numpy()

    def stats(mod, df, shard=None):
        e = mod.col("y").least_squares.ols(mod.col("x1"), mod.col("x2"), mode="statistics").over("g")
        out = _select(mod, df, e, shard) if mod is pt else df.select(e)
        return out["statistics"].to_list()

    out = coefs(True)
    np.testing.assert_allclose(out, coefs(False), rtol=1e-9, atol=1e-12)
    jc = _jax("coefs", lambda: _frame(pj).select(
        pj.col("y").least_squares.ols(pj.col("x1"), pj.col("x2"), mode="coefficients").over("g")
    ).unnest("coefficients").to_numpy())
    np.testing.assert_allclose(out, jc, **FAMILY_TOL)
    st = stats(pt, df, True)
    _check_stats(st, stats(pt, df, False))
    _check_stats(st, _jax("stats", lambda: stats(pj, _frame(pj))), coef=FAMILY_TOL)


def test_sharded_cd_statistics():
    """mode='statistics' with coordinate descent (lasso) shards: CD
    coefficients and residual metrics, normal-equation se / t / p."""
    df = _frame(pt)

    def expr(mod):
        return mod.col("y").least_squares.lasso(mod.col("x1"), mod.col("x2"), alpha=0.001, mode="statistics").over("g")

    st = _select(pt, df, expr(pt), True)["statistics"].to_list()
    single = _select(pt, df, expr(pt), False)["statistics"].to_list()
    _check_stats(st, single, rel=1e-7, coef=dict(rtol=1e-6, atol=1e-9))
    ref = _jax("cd_stats", lambda: _frame(pj).select(expr(pj))["statistics"].to_list())
    _check_stats(st, ref, rel=1e-7, coef=dict(rtol=1e-6, atol=1e-9))


@pytest.mark.parametrize("noise", [1e-7, 1e-5])
def test_sharded_near_collinear_refinement(noise):
    """The sharded normal-equation solve runs the CSNE sweeps on
    ill-conditioned groups, as the single-device engine does. At the JAX
    test's noise of 1e-7 (cond(X) ~2e7 a group, past the sweeps' reach of
    ~1e7) it is held to lstsq at that test's rtol 1e-5 / atol 2e-6 only:
    there the answer depends on the rounding of the moments' sums, and the
    one-device outputs of both engines sit up to 1.2e-4 from lstsq. At
    1e-5 (cond(X) ~2e5, cond(X'X) past the 1e6 gate) the sweeps converge,
    and the result is held to the port on one device and to the JAX engine
    at rtol 1e-8 / atol 1e-10."""
    rng = np.random.default_rng(32)
    n = 5_000
    x1 = rng.normal(size=n)
    x2 = x1 + noise * rng.normal(size=n)
    y = 1.5 * x1 - 0.5 * x2 + rng.normal(size=n) * 0.1
    g = rng.integers(20, size=n).astype(float)
    data = {"y": y, "x1": x1, "x2": x2, "g": g}
    df = pt.DataFrame(data)
    e = pt.col("y").least_squares.ols(pt.col("x1"), pt.col("x2")).over("g")
    runs = sharded.csne_runs
    out = _first(_select(pt, df, e, True))
    assert sharded.csne_runs == runs + 1
    x = np.stack([x1, x2], axis=1)
    expected = np.empty_like(y)
    for gid in np.unique(g):
        m = g == gid
        expected[m] = x[m] @ np.linalg.lstsq(x[m], y[m], rcond=None)[0]
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=2e-6)
    if noise == 1e-5:
        np.testing.assert_allclose(out, _first(_select(pt, df, e, False)), **FAMILY_TOL)
        ref = _jax(("collinear", noise), lambda: _first(pj.DataFrame(data).select(
            pj.col("y").least_squares.ols(pj.col("x1"), pj.col("x2")).over("g")
        )))
        np.testing.assert_allclose(out, ref, **FAMILY_TOL)


@pytest.mark.parametrize("case", ["one_group", "fewer_groups_than_shards"])
def test_fits_that_stay_on_one_device(case, caplog):
    """With auto_shard on, a fit of one group, and a whole-group solve of
    fewer groups than shards, stay on one device (with a log line, as in
    the JAX engine) and give the one-device result."""
    import logging

    d, y, _, g = _data()
    if case == "one_group":
        df = pt.DataFrame({**d, "y": y})
        expr = pt.col("y").least_squares.ols(pt.col("x1"), pt.col("x2"))
    else:
        df = pt.DataFrame({**d, "y": y, "g": g % 3})
        expr = pt.col("y").least_squares.rls(pt.col("x1"), pt.col("x2"), half_life=30.0).over("g")
    single = _first(df.select(expr))
    CONFIG.auto_shard = True
    before = dict(sharded.calls)
    try:
        with caplog.at_level(logging.INFO, logger="polars_ols_tpu_torch.engine.fit"):
            out = _first(df.select(expr))
    finally:
        CONFIG.auto_shard = False
    assert sharded.calls == before
    assert any("stays on one device" in r.getMessage() for r in caplog.records)
    np.testing.assert_array_equal(out, single)
