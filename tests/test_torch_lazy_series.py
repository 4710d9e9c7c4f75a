"""The deferred row order of grouped predictions (series.BlockPermuted) in
the port, against the eager path and the JAX package: the counterpart of
each test of tests/test_lazy_series.py.

Deferred and eager predictions agree at rtol 1e-12 (the same values,
gathered twice); point and slice access does not materialise the column;
residuals materialise their operand; statistics under ``.over()`` keep
group-level base tensors with a deferred row index. Each is held to the
JAX package's output on the same frame at the suite's rtol 1e-9 /
atol 1e-11. The JAX package's second epilogue (``CONFIG.row_epilogue``,
predictions from the cached row stack) has no switch in the port: its
counterpart holds the port's two row-order paths, deferred and gathered,
to each other and to both JAX epilogues, under OLS and WLS, across
``clear_caches()``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import polars_ols_tpu as pj  # noqa: E402
from polars_ols_tpu.config import CONFIG as JCONFIG  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402

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


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    n = 5_000
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    y = 2.0 * x1 - 1.0 * x2 + rng.normal(size=n) * 0.1
    g = rng.integers(50, size=n).astype(float)
    return {"y": y, "x1": x1, "x2": x2, "g": g}


def _run(df, m, lazy: bool, monkeypatch):
    monkeypatch.setattr(CONFIG, "lazy_row_order", lazy)
    return df.select(m.col("y").least_squares.ols(m.col("x1"), m.col("x2")).over("g"))["y"]


def _jax_preds(data):
    df = pj.DataFrame(data)
    return df.select(pj.col("y").least_squares.ols(pj.col("x1"), pj.col("x2")).over("g"))["y"].to_numpy()


def test_lazy_matches_eager(data, monkeypatch):
    df = pt.DataFrame(data)
    eager = _run(df, pt, False, monkeypatch)
    lazy = _run(df, pt, True, monkeypatch)
    assert lazy.is_lazy and not eager.is_lazy
    np.testing.assert_allclose(lazy.to_numpy(), eager.to_numpy(), rtol=1e-12, atol=1e-12)
    assert not lazy.is_lazy  # materialised (and kept) by the full access
    np.testing.assert_allclose(lazy.to_numpy(), _jax_preds(data), **FIT_TOL)


def test_lazy_point_access_before_materialization(data, monkeypatch):
    df = pt.DataFrame(data)
    lazy = _run(df, pt, True, monkeypatch)
    eager = _run(df, pt, False, monkeypatch).to_numpy()
    tail = lazy.tail(4).to_numpy()
    head = lazy.head(3).to_numpy()
    assert lazy.is_lazy  # point access must not materialise the column
    np.testing.assert_allclose(tail, eager[-4:], rtol=1e-12)
    np.testing.assert_allclose(head, eager[:3], rtol=1e-12)
    np.testing.assert_allclose(lazy[10:20].to_numpy(), eager[10:20], rtol=1e-12)
    assert lazy[7] == eager[7] and lazy.slice(5, 2).to_list() == eager[5:7].tolist()
    assert lazy.is_lazy
    np.testing.assert_allclose(lazy[10:20].to_numpy(), _jax_preds(data)[10:20], **FIT_TOL)


def test_lazy_residuals_transparent(data, monkeypatch):
    df = pt.DataFrame(data)
    out = df.select(
        pt.col("y").least_squares.ols(pt.col("x1"), pt.col("x2"), mode="residuals").over("g")
    )["y"].to_numpy()
    eager_preds = _run(df, pt, False, monkeypatch).to_numpy()
    np.testing.assert_allclose(out, data["y"] - eager_preds, rtol=1e-10, atol=1e-12)
    # the frame arithmetic on a deferred column materialises it too
    lazy = _run(df, pt, True, monkeypatch)
    diff = pt.DataFrame({"y": data["y"], "p": lazy}).select((pt.col("y") - pt.col("p")).alias("r"))["r"]
    np.testing.assert_allclose(diff.to_numpy(), out, rtol=1e-12, atol=1e-13)
    jout = pj.DataFrame(data).select(
        pj.col("y").least_squares.ols(pj.col("x1"), pj.col("x2"), mode="residuals").over("g")
    )["y"].to_numpy()
    np.testing.assert_allclose(out, jout, **FIT_TOL)


def test_row_epilogue_matches_block_unpad(data, monkeypatch):
    rng = np.random.default_rng(3)
    cols = {**data, "w": rng.random(len(data["y"])) + 0.1}

    def queries(m):
        df = m.DataFrame(cols)
        c = m.col
        return {
            "ols": df.select(c("y").least_squares.ols(c("x1"), c("x2")).over("g"))["y"].to_numpy(),
            "wls": df.select(
                c("y").least_squares.wls(c("x1"), c("x2"), sample_weights=c("w")).over("g")
            )["y"].to_numpy(),
        }

    outs = {}
    for lazy in (False, True):
        monkeypatch.setattr(CONFIG, "lazy_row_order", lazy)
        pt.clear_caches()
        outs[lazy] = queries(pt)
    jouts = {}
    monkeypatch.setattr(JCONFIG, "lazy_row_order", False)
    for flag in (False, True):
        monkeypatch.setattr(JCONFIG, "row_epilogue", flag)
        pj.clear_caches()
        jouts[flag] = queries(pj)
    for key in outs[False]:
        np.testing.assert_allclose(outs[False][key], outs[True][key], rtol=1e-12, atol=1e-13, err_msg=key)
        for flag in (False, True):
            np.testing.assert_allclose(outs[True][key], jouts[flag][key], err_msg=key, **FIT_TOL)


def test_statistics_broadcast_is_deferred(data):
    df = pt.DataFrame(data)
    out = df.select(
        pt.col("y").least_squares.ols(pt.col("x1"), pt.col("x2"), mode="statistics").over("g").alias("s")
    )["s"]
    assert len(out) == len(data["y"])
    assert out._row_index is not None
    assert out._base["r2"].shape[0] == 50  # group-level, not row-level
    tail = out.gather(np.arange(len(out) - 3, len(out)))
    assert tail._base is out._base and tail._mat is None
    g = data["g"][-3:].astype(int)
    eager = {k: v.numpy() for k, v in out.arrays.items()}  # materialise
    base = out._base["r2"].numpy()
    for i, gi in enumerate(g):
        assert tail.arrays["r2"].numpy()[i] == base[gi]
        assert eager["r2"][len(out) - 3 + i] == base[gi]
    jout = pj.DataFrame(data).select(
        pj.col("y").least_squares.ols(pj.col("x1"), pj.col("x2"), mode="statistics").over("g").alias("s")
    )["s"]
    for k in ("r2", "coefficients", "standard_errors", "t_values"):
        np.testing.assert_allclose(eager[k], np.asarray(jout.arrays[k]), err_msg=k, **FIT_TOL)
