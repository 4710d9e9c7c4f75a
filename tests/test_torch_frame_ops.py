"""The frame substrate of the port against the JAX package's: the
counterpart of each test of tests/test_frame_ops.py.

Each test runs the same operation on frames built from the same numpy
inputs in both packages and holds the port to the JAX package's result and
to the oracle of the JAX test. Row selections, orders, null masks and
string keys must be equal; float outputs of frame operations and
aggregations agree at rtol 1e-12 (their sums run in another order); fits
at the suite's rtol 1e-9 / atol 1e-11. Two JAX tests exercise mechanisms
of the JAX package: shape bucketing (here the port's ``bucket_size``,
which keeps the same block widths as the JAX engine) and the hash join's
sort-merge fallback (the port has both paths: the same monkeypatch).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import polars_ols_tpu as pj  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402

OPS_TOL = dict(rtol=1e-12, atol=1e-13)
FIT_TOL = dict(rtol=1e-9, atol=1e-11)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    # the suite runs six workers on the host's cores: torch's intra-op
    # threads in each oversubscribe them (a case of 1 s alone took minutes)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")


def _both(fn):
    """(port, jax) results of ``fn(module)``."""
    return fn(pt), fn(pj)


def assert_frames_match(t, j, tol=OPS_TOL):
    """Same columns in the same order, equal null masks and object values,
    float values within ``tol`` (NaN where the JAX frame has NaN)."""
    assert t.columns == j.columns
    assert t.height == j.height
    for c in t.columns:
        tc, jc = t[c], j[c]
        if isinstance(tc, pt.StatisticsSeries):
            assert tc.feature_names == jc.feature_names
            for f, v in tc.arrays.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(jc.arrays[f]), err_msg=f"{c}.{f}", **tol)
            continue
        a, b = tc.to_numpy(), jc.to_numpy()
        if a.dtype == object or b.dtype == object:
            assert [repr(v) for v in a.tolist()] == [repr(v) for v in b.tolist()], c
            continue
        np.testing.assert_allclose(a.astype(float), b.astype(float), err_msg=c, **tol)
        if getattr(jc, "validity", None) is not None or getattr(tc, "validity", None) is not None:
            np.testing.assert_array_equal(np.isnan(a.astype(float)), np.isnan(b.astype(float)), err_msg=c)


def test_join_inner_matches_bruteforce():
    rng = np.random.default_rng(0)
    lk = rng.integers(8, size=200).astype(float)
    rk = rng.integers(8, size=50).astype(float)
    a, b = rng.normal(size=200), rng.normal(size=50)

    def run(m):
        return m.DataFrame({"k": lk, "a": a}).join(m.DataFrame({"k": rk, "b": b}), on="k", how="inner")

    out, jout = _both(run)
    pairs = [(i, j) for i in range(200) for j in range(50) if lk[i] == rk[j]]
    assert out.height == len(pairs)
    np.testing.assert_array_equal(out["a"].to_numpy(), a[[i for i, _ in pairs]])
    np.testing.assert_array_equal(out["b"].to_numpy(), b[[j for _, j in pairs]])
    assert_frames_match(out, jout)
    assert out["a"].values.device.type == "cpu" and isinstance(out["a"].values, torch.Tensor)


def test_join_left_nulls_unmatched():
    def run(m):
        left = m.DataFrame({"k": [1.0, 2.0, 3.0], "a": [10.0, 20.0, 30.0]})
        return left.join(m.DataFrame({"k": [1.0, 3.0], "b": [-1.0, -3.0]}), on="k", how="left")

    out, jout = _both(run)
    assert out.height == 3
    assert out["b"].to_list() == [-1.0, None, -3.0] == jout["b"].to_list()
    np.testing.assert_allclose(out["a"].to_numpy(), [10.0, 20.0, 30.0])
    assert_frames_match(out, jout)


def test_join_left_struct_unmatched_and_empty_right():
    rng = np.random.default_rng(5)
    n = 200
    g = np.repeat([1.0, 3.0], n // 2)
    x, y = rng.normal(size=n), rng.normal(size=n)

    def run(m):
        train = m.DataFrame({"g": g, "x": x, "y": y})
        coefs = train.select(
            "g", m.col("y").least_squares.ols(m.col("x"), mode="coefficients").over("g")
        ).unique()
        test = m.DataFrame({"g": [1.0, 2.0, 3.0]})
        out = test.join(coefs, on="g", how="left")
        empty = coefs.filter(m.col("g") > 99.0)
        return out, test.join(empty, on="g", how="left")

    (out, out2), (jout, jout2) = _both(run)
    vals = out["coefficients"].to_numpy()
    assert np.isfinite(vals[0]).all() and np.isfinite(vals[2]).all()
    assert np.isnan(vals[1]).all()
    assert out2.height == 3 and np.isnan(out2["coefficients"].to_numpy()).all()
    assert_frames_match(out, jout, FIT_TOL)
    assert_frames_match(out2, jout2)


def test_expr_comparisons_and_boolean_algebra():
    def run(m):
        df = m.DataFrame({
            "a": m.Series("a", [1.0, 2.0, 0.0, 4.0], [True, True, False, True]),
            "b": [3.0, 1.0, 5.0, 4.0],
        })
        c = m.col
        return [
            df.filter(c("a") > c("b")),
            df.filter((c("a") >= 1.0) & (c("b") <= 3.0)),
            df.filter(~(c("b") < 4.0)),
            df.filter((c("a") == 4.0) | (c("b") == 3.0)),
            df.filter(c("a") != c("a")),
            df.select((c("a") > 1.5).alias("gt"), (c("a") == c("b")).alias("eq"), (~(c("a") < 2.0)).alias("n")),
        ]

    outs, jouts = _both(run)
    np.testing.assert_allclose(outs[0]["a"].to_numpy(), [2.0])
    np.testing.assert_allclose(outs[1]["b"].to_numpy(), [3.0, 1.0])
    np.testing.assert_allclose(outs[2]["b"].to_numpy(), [5.0, 4.0])
    np.testing.assert_allclose(outs[3]["b"].to_numpy(), [3.0, 4.0])
    assert outs[4].height == 0
    for o, jo in zip(outs, jouts):
        assert_frames_match(o, jo)


def test_group_by_agg_reductions():
    rng = np.random.default_rng(1)
    n = 1_000
    g = rng.integers(6, size=n).astype(float)
    x = rng.normal(size=n)

    def run(m):
        col = m.col
        return m.DataFrame({"g": g, "x": x}).group_by("g").agg(
            col("x").mean().alias("mean"), col("x").sum().alias("sum"),
            col("x").min().alias("min"), col("x").max().alias("max"),
            col("x").count().alias("count"), col("x").std().alias("std"),
            col("x").var(ddof=0).alias("var0"), col("x").n_unique().alias("nu"),
            col("x").first().alias("first"), col("x").last().alias("last"),
        )

    out, jout = _both(run)
    for i, gid in enumerate(out["g"].to_numpy()):
        m = g == gid
        idx = np.flatnonzero(m)
        np.testing.assert_allclose(out["mean"].to_numpy()[i], x[m].mean(), rtol=1e-12)
        np.testing.assert_allclose(out["sum"].to_numpy()[i], x[m].sum(), rtol=1e-12)
        assert out["min"].to_numpy()[i] == x[m].min() and out["max"].to_numpy()[i] == x[m].max()
        assert out["count"].to_numpy()[i] == m.sum() == out["nu"].to_numpy()[i]
        np.testing.assert_allclose(out["std"].to_numpy()[i], x[m].std(ddof=1), rtol=1e-12)
        np.testing.assert_allclose(out["var0"].to_numpy()[i], x[m].var(), rtol=1e-12)
        assert out["first"].to_numpy()[i] == x[idx[0]] and out["last"].to_numpy()[i] == x[idx[-1]]
    assert_frames_match(out, jout)


def test_group_by_agg_with_nulls():
    def run(m):
        df = m.DataFrame({
            "g": [0.0, 0.0, 1.0, 1.0, 2.0],
            "x": m.Series("x", np.array([1.0, 0.0, 3.0, 4.0, 5.0]), np.array([True, False, True, True, False])),
        })
        c = m.col
        return df.group_by("g").agg(
            c("x").mean().alias("m"), c("x").count().alias("c"), c("x").std().alias("s"),
            c("x").min().alias("lo"), c("x").sum().alias("sum"),
        )

    out, jout = _both(run)
    assert out["m"].to_list() == [1.0, 3.5, None]
    np.testing.assert_allclose(out["c"].to_numpy(), [1.0, 2.0, 0.0])
    assert out["s"].to_list()[0] is None and out["lo"].to_list()[2] is None
    assert_frames_match(out, jout)


def test_group_by_agg_least_squares_coefficients():
    rng = np.random.default_rng(2)
    n = 3_000
    g = rng.integers(12, size=n).astype(float)
    x1, x2 = rng.normal(size=(2, n))
    y = 2.0 * x1 - x2 + rng.normal(size=n) * 0.1

    def run(m):
        df = m.DataFrame({"g": g, "y": y, "x1": x1, "x2": x2})
        return df.group_by("g").agg(m.col("y").least_squares.ols(m.col("x1"), m.col("x2"), mode="coefficients"))

    out, jout = _both(run)
    assert out.height == 12
    betas = out["coefficients"].to_numpy()
    x = np.stack([x1, x2], axis=1)
    for i, gid in enumerate(out["g"].to_numpy()):
        m = g == gid
        np.testing.assert_allclose(betas[i], np.linalg.lstsq(x[m], y[m], rcond=None)[0], rtol=1e-8, atol=1e-10)
    assert_frames_match(out, jout, FIT_TOL)


def test_lazyframe_defers_execution(monkeypatch):
    import polars_ols_tpu_torch.engine.fit as fit_mod

    rng = np.random.default_rng(9)
    n = 500
    data = {"y": rng.normal(size=n), "x1": rng.normal(size=n), "g": rng.integers(5, size=n).astype(float)}
    calls = {"n": 0}
    orig = fit_mod.evaluate_least_squares

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(fit_mod, "evaluate_least_squares", counting)
    lf = pt.DataFrame(data).lazy().with_columns(
        pt.col("y").least_squares.ols(pt.col("x1")).over("g").alias("p")
    )
    assert calls["n"] == 0, "plan construction must not evaluate"
    assert "with_columns" in lf.explain()
    out = lf.collect()
    assert calls["n"] == 1 and "p" in out.columns
    assert lf.columns == out.columns and calls["n"] == 1  # the collected frame is kept
    jout = pj.DataFrame(data).lazy().with_columns(
        pj.col("y").least_squares.ols(pj.col("x1")).over("g").alias("p")
    ).collect()
    assert_frames_match(out, jout, FIT_TOL)


def test_select_scalar_aggregations():
    def run(m):
        df = m.DataFrame({"x": [1.0, 2.0, 3.0, 4.0]})
        c = m.col
        return df.select(
            c("x").mean().alias("m"), c("x").sum().alias("s"), c("x").first().alias("f"),
            c("x").max().alias("mx"), c("x").n_unique().alias("nu"),
        ), df.select("x", (c("x") - c("x").mean()).alias("d"))

    (out, cen), (jout, jcen) = _both(run)
    assert out["m"].item() == pytest.approx(2.5) and out["s"].item() == pytest.approx(10.0)
    assert out["f"].item() == 1.0 and out["nu"].item() == 4.0
    np.testing.assert_allclose(cen["d"].to_numpy(), [-1.5, -0.5, 0.5, 1.5])
    assert_frames_match(out, jout)
    assert_frames_match(cen, jcen)


def test_shape_bucketing_bounds_compiled_programs():
    """The port keeps the JAX engine's shape buckets (engine/groups.py:
    bucket_size) so that both engines cut the same blocks: the same bucket
    for every size, and the same padded widths for the same layouts."""
    from polars_ols_tpu.engine.groups import bucket_size as jbucket
    from polars_ols_tpu.engine.groups import build_layout as jbuild
    from polars_ols_tpu.engine.groups import padded_indices as jpadded

    from polars_ols_tpu_torch.engine.groups import bucket_size, build_layout, padded_indices

    assert bucket_size(1) == 1 and bucket_size(8) == 8
    for lo, hi in ((129, 144), (1001, 1024), (517, 576)):
        assert bucket_size(lo) == bucket_size(hi)
    for n in (9, 100, 1000, 12345):
        b = bucket_size(n)
        assert b >= n and (b - n) / n <= 0.125
    assert [bucket_size(n) for n in range(1, 5000)] == [jbucket(n) for n in range(1, 5000)]
    rng = np.random.default_rng(0)
    widths = set()
    for max_count in (130, 140):
        gids = np.concatenate([np.zeros(max_count, np.int64), rng.integers(1, 50, 1000)])
        gather, mask, R = padded_indices(build_layout(gids, len(gids)))
        jgather, jmask, jR = jpadded(jbuild(gids, len(gids)))
        assert R == jR
        np.testing.assert_array_equal(mask, np.asarray(jmask))
        np.testing.assert_array_equal(gather[mask], np.asarray(jgather)[np.asarray(jmask)])
        widths.add(R)
    assert len(widths) == 1


def test_expression_math_ops():
    vals = np.asarray([1.0, 2.0, np.nan, 4.0, 8.0])

    def run(m):
        c = m.col
        return m.DataFrame({"x": vals}).select(
            c("x").log().alias("lg"), c("x").exp().alias("ex"), (c("x") ** 2).alias("sq"),
            c("x").clip(1.5, 4.0).alias("cl"), c("x").shift(1).alias("sh"),
            c("x").shift(-2).alias("shn"), c("x").sqrt().alias("rt"), c("x").log1p().alias("l1"),
            (-c("x")).abs().alias("ab"), (c("x") / 3.0).round(2).alias("rd"),
            (1.0 - c("x") / 2.0 + c("x") * 0.5).alias("ar"), c("x").pow(0.5).alias("pw"),
        )

    out, jout = _both(run)
    np.testing.assert_allclose(out["lg"].to_numpy(), np.log(vals))
    np.testing.assert_allclose(out["ex"].to_numpy(), np.exp(vals))
    np.testing.assert_allclose(out["sq"].to_numpy(), vals**2)
    np.testing.assert_allclose(out["cl"].to_numpy(), np.clip(vals, 1.5, 4.0))
    sh = out["sh"].to_numpy()
    assert np.isnan(sh[0]) and np.allclose(sh[1:], vals[:-1], equal_nan=True)
    shn = out["shn"].to_numpy()
    assert np.isnan(shn[-2:]).all() and np.allclose(shn[:-2], vals[2:], equal_nan=True)
    assert_frames_match(out, jout)


def test_head_tail_slice():
    rng = np.random.default_rng(0)
    n = 100
    data = {"y": rng.normal(size=n), "x": rng.normal(size=n), "g": rng.integers(4, size=n).astype(float)}

    def run(m):
        df = m.DataFrame({"a": np.arange(10.0), "b": np.arange(10.0) * 2})
        col = m.col
        out = m.DataFrame(data).select(
            "g",
            col("y").least_squares.ols(col("x"), mode="coefficients").over("g").alias("c"),
            col("y").least_squares.ols(col("x"), mode="statistics").over("g").alias("s"),
        )
        return df, out

    (df, out), (jdf, jout) = _both(run)
    np.testing.assert_array_equal(df.head(3)["a"].to_numpy(), [0, 1, 2])
    np.testing.assert_array_equal(df.tail(2)["b"].to_numpy(), [16, 18])
    np.testing.assert_array_equal(df.slice(2, 3)["a"].to_numpy(), [2, 3, 4])
    np.testing.assert_array_equal(df.slice(-3)["a"].to_numpy(), [7, 8, 9])
    assert df.head(0).shape == (0, 2) and df.head(99).shape == (10, 2)
    for f, jf in ((df.slice(2, 3), jdf.slice(2, 3)), (df[1:7:2], jdf[1:7:2]), (df[-1], jdf[-1])):
        assert_frames_match(f, jf)
    t = out.tail(3)
    assert t.shape == (3, 3) and len(t["s"]) == 3
    assert_frames_match(t, jout.tail(3), FIT_TOL)


def test_join_hash_fast_path_matches_sort_merge(monkeypatch):
    rng = np.random.default_rng(8)
    ldata = {
        "k": rng.integers(0, 12, 200).astype(float),
        "k2": rng.integers(0, 3, 200).astype(float),
        "a": rng.normal(size=200),
    }
    rdata = {
        "k": rng.integers(5, 20, 60).astype(float),
        "k2": rng.integers(0, 3, 60).astype(float),
        "b": rng.normal(size=60),
    }

    def run_all(m):
        left, right = m.DataFrame(ldata), m.DataFrame(rdata)
        outs = []
        for how in ("inner", "left", "full", "semi", "anti"):
            for on in ("k", ["k", "k2"]):
                out = left.join(right, on=on, how=how)
                outs.append({c: out[c].to_numpy() for c in out.columns})
        return outs

    fast = run_all(pt)
    monkeypatch.setattr(pt.DataFrame, "_join_codes", lambda *a, **k: None)
    slow = run_all(pt)
    jax = run_all(pj)
    for f, s, j in zip(fast, slow, jax):
        assert list(f) == list(s) == list(j)
        for c in f:
            np.testing.assert_array_equal(f[c], s[c], err_msg=c)
            np.testing.assert_array_equal(f[c], j[c], err_msg=c)


def test_series_scalar_reductions():
    def run(m):
        s = m.Series("s", np.asarray([1.0, 2.0, 0.0, 4.0]), np.asarray([True, True, False, True]))
        empty = m.Series("e", np.asarray([np.nan]), np.asarray([False]))
        return [s.sum(), s.mean(), s.min(), s.max(), s.median(), s.std(), s.var(), s.count(),
                empty.sum(), empty.mean(), empty.max(), empty.std(), s.to_list(), s.is_null().to_list(),
                s.fill_null(-1.0).to_list(), s.head(2).to_list(), s.tail(1).item(), s[1], s.null_count()]

    got, want = _both(run)
    assert got[0] == 7.0 and got[1] == pytest.approx(7 / 3)
    assert got[2] == 1.0 and got[3] == 4.0 and got[4] == 2.0
    assert got[5] == pytest.approx(np.std([1, 2, 4], ddof=1))
    assert got[8] == 0.0 and got[9] is None and got[10] is None
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, float):
            assert a == pytest.approx(b, rel=1e-12)
        else:
            assert a == b


def test_sort_descending_single_and_multi():
    def run(m):
        df = m.DataFrame({"g": [1.0, 2.0, 1.0, 2.0, 1.0], "v": [3.0, 1.0, 2.0, 5.0, 4.0]})
        df3 = m.DataFrame({"s": ["b", "a", "c"], "v": [1.0, 2.0, 3.0]})
        return df.sort("v", descending=True), df.sort(["g", "v"], descending=[False, True]), \
            df3.sort("s", descending=True), df3.sort("s")

    outs, jouts = _both(run)
    np.testing.assert_allclose(outs[0]["v"].to_numpy(), [5.0, 4.0, 3.0, 2.0, 1.0])
    np.testing.assert_allclose(outs[1]["g"].to_numpy(), [1, 1, 1, 2, 2])
    np.testing.assert_allclose(outs[1]["v"].to_numpy(), [4.0, 3.0, 2.0, 5.0, 1.0])
    assert outs[2]["s"].to_list() == ["c", "b", "a"]
    for o, jo in zip(outs, jouts):
        assert_frames_match(o, jo)


def test_sort_descending_nans_last_and_stable():
    def run(m):
        df = m.DataFrame({"v": [np.nan, 1.0, 3.0, 2.0], "i": [0.0, 1.0, 2.0, 3.0]})
        df2 = m.DataFrame({"k": [1.0, 1.0, 0.0, 1.0], "i": [0.0, 1.0, 2.0, 3.0]})
        return df.sort("v", descending=True), df.sort("v"), df2.sort("k", descending=True)

    outs, jouts = _both(run)
    np.testing.assert_allclose(outs[0]["v"].to_numpy()[:3], [3.0, 2.0, 1.0])
    assert np.isnan(outs[0]["v"].to_numpy()[3]) and np.isnan(outs[1]["v"].to_numpy()[3])
    np.testing.assert_allclose(outs[2]["i"].to_numpy(), [0.0, 1.0, 3.0, 2.0])
    for o, jo in zip(outs, jouts):
        assert_frames_match(o, jo)


def test_join_semi_anti():
    def run(m):
        left = m.DataFrame({"k": [1.0, 2.0, 3.0, 2.0], "a": [10.0, 20.0, 30.0, 40.0]})
        right = m.DataFrame({"k": [2.0, 2.0, 9.0], "b": [-1.0, -2.0, -9.0]})
        return left.join(right, on="k", how="semi"), left.join(right, on="k", how="anti")

    (semi, anti), (jsemi, janti) = _both(run)
    assert semi.columns == ["k", "a"]
    np.testing.assert_allclose(semi["a"].to_numpy(), [20.0, 40.0])
    np.testing.assert_allclose(anti["a"].to_numpy(), [10.0, 30.0])
    assert_frames_match(semi, jsemi)
    assert_frames_match(anti, janti)


def test_join_full_coalesced():
    def run(m):
        left = m.DataFrame({"k": [1.0, 2.0, 3.0], "a": [10.0, 20.0, 30.0]})
        right = m.DataFrame({"k": [2.0, 4.0], "b": [-2.0, -4.0]})
        return left.join(right, on="k", how="full").sort("k"), left.join(right, on="k", how="outer")

    (out, out2), (jout, jout2) = _both(run)
    np.testing.assert_allclose(out["k"].to_numpy(), [1.0, 2.0, 3.0, 4.0])
    assert out["a"].to_list() == [10.0, 20.0, 30.0, None]
    assert out["b"].to_list() == [None, -2.0, None, -4.0]
    assert out2.height == 4
    assert_frames_match(out, jout)
    assert_frames_match(out2, jout2)


def test_join_full_no_unmatched_right_equals_left():
    def run(m):
        left = m.DataFrame({"k": [1.0, 2.0], "a": [1.0, 2.0]})
        right = m.DataFrame({"k": [1.0, 2.0], "b": [9.0, 8.0]})
        return left.join(right, on="k", how="full"), left.join(right, on="k", how="left")

    (out, lj), (jout, _) = _both(run)
    assert out.height == lj.height
    np.testing.assert_allclose(out["b"].to_numpy(), lj["b"].to_numpy())
    assert_frames_match(out, jout)


def test_join_cross():
    def run(m):
        return m.DataFrame({"a": [1.0, 2.0]}).join(m.DataFrame({"b": [10.0, 20.0, 30.0]}), how="cross")

    out, jout = _both(run)
    assert out.height == 6
    np.testing.assert_allclose(out["a"].to_numpy(), [1, 1, 1, 2, 2, 2])
    np.testing.assert_allclose(out["b"].to_numpy(), [10, 20, 30, 10, 20, 30])
    assert_frames_match(out, jout)


def test_concat_horizontal():
    a = pt.DataFrame({"x": [1.0, 2.0]})
    b = pt.DataFrame({"y": [3.0, 4.0], "z": [5.0, 6.0]})
    out = pt.concat([a, b], how="horizontal")
    assert out.columns == ["x", "y", "z"] and out.height == 2
    assert_frames_match(out, pj.concat([pj.DataFrame({"x": [1.0, 2.0]}),
                                        pj.DataFrame({"y": [3.0, 4.0], "z": [5.0, 6.0]})], how="horizontal"))
    with pytest.raises(AssertionError, match="duplicate column"):
        pt.concat([a, a], how="horizontal")
    with pytest.raises(AssertionError, match="equal heights"):
        pt.concat([a, pt.DataFrame({"w": [1.0]})], how="horizontal")


def test_concat_vertical_statistics_column():
    rng = np.random.default_rng(11)
    n = 120
    data = {"g": np.repeat([0.0, 1.0, 2.0], n // 3), "x": rng.normal(size=n), "y": rng.normal(size=n)}

    def run(m):
        stats = m.DataFrame(data).select(
            "g", m.col("y").least_squares.ols(m.col("x"), mode="statistics").over("g")
        ).unique()
        return stats, m.concat([stats, stats])

    (stats, both), (_, jboth) = _both(run)
    assert both.height == 2 * stats.height
    for field in ("r2", "coefficients"):
        top = stats["statistics"].arrays[field].numpy()
        cat = both["statistics"].arrays[field].numpy()
        np.testing.assert_allclose(cat[: stats.height], top)
        np.testing.assert_allclose(cat[stats.height:], top)
        np.testing.assert_allclose(cat, np.asarray(jboth["statistics"].arrays[field]), **FIT_TOL)
