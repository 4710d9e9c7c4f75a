"""Multi-target OLS through both engines' public API.

A struct target of M fields is fitted by one shared SVD per group
(``struct(...).least_squares.multi_target_ols(...)``). The same
numpy-seeded frames go through the JAX package and the PyTorch port: the
JAX suite's four ``(alpha, mode, null_policy)`` cases
(tests/test_ols.py:711-753), its weighted grouped case (:756-783) and one
group without ``.over``, compared at atol 1e-8, the JAX suite's own
tolerance (tests/test_ols.py:753), with identical null masks; and the
coefficients behind them, through the module API (``ops/householder.py``
and ``svd_lstsq_from_factor`` on the engine's blocks), against numpy
lstsq per target at rtol 1e-9 (tests/test_ozaki.py:60). The error paths
raise what the JAX package raises (tests/test_error_paths.py:61-115).
Blocks wider than 33 columns (M targets beside K features: M = 40 / K = 3,
M = 2 / K = 32, M = 3 / K = 31, M = 2 / K = 40, on 800 rows in 4 groups)
take the Householder kernel's wide form; the port's predictions equal the
JAX package's at the same atol 1e-8, where the port raised before.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import polars_ols_tpu as pj  # noqa: E402
from polars_ols_tpu import CONFIG as JCONFIG  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.engine import fit, groups  # noqa: E402
from polars_ols_tpu_torch.ops import householder  # noqa: E402

ATOL = 1e-8
CHUNK_ROWS = 128


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    monkeypatch.setattr(CONFIG, "moment_chunk_rows", CHUNK_ROWS)
    monkeypatch.setattr(JCONFIG, "moment_chunk_rows", CHUNK_ROWS)


def _data(n=2_000, k=3, n_groups=3, missing=False, seed=0):
    """The JAX suite's ``_make_data`` (tests/test_ols.py:23-48): features,
    a group column, 10 % nulls in x1; the three targets of its
    multi-target case and a weight column. Row 0 stays valid (the JAX
    engine's padding slots read it)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k))
    g = rng.integers(n_groups, size=n).astype(float)
    valid = rng.random(n) >= 0.1 if missing else np.ones(n, dtype=bool)
    valid[0] = True
    xz = np.where(valid, x[:, 0], 0.0)
    t = {
        "y1": xz + x[:, 1] + x[:, 2],
        "y2": xz - x[:, 1] + x[:, 2],
        "y3": -xz + x[:, 1] - x[:, 2],
    }
    w = rng.uniform(0.1, 2.0, size=n)
    return dict(x=x, g=g, valid=valid, t=t, w=w)


def _frame(mod, d, targets=("y1", "y2", "y3")):
    k = d["x"].shape[1]
    cols = {"x1": mod.Series("x1", d["x"][:, 0], None if d["valid"].all() else d["valid"])}
    for i in range(1, k):
        cols[f"x{i + 1}"] = d["x"][:, i]
    for name in targets:
        cols[f"t_{name}"] = d["t"][name]
    cols["w"] = d["w"]
    cols["group"] = d["g"]
    df = mod.DataFrame(cols)
    return df.with_columns(
        mod.struct(**{name: mod.col(f"t_{name}") for name in targets}).alias("y")
    )


def _arrays(df):
    """Columns of a frame of Series as [N, C] values (nulls NaN) and
    validity."""
    vals = np.stack([df[c].to_numpy() for c in df.columns], axis=1)
    valid = np.stack(
        [np.ones(len(vals), bool) if df[c].validity is None else np.asarray(df[c].validity)
         for c in df.columns], axis=1,
    )
    return vals, valid


def _both(d, query, targets=("y1", "y2", "y3"), column="p"):
    """(port, jax) of one multi-target query, unnested to [N, M] arrays."""
    out = []
    for mod in (pt, pj):
        res = _frame(mod, d, targets).select(query(mod).alias(column)).unnest(column)
        assert res.columns == list(targets)
        out.append(_arrays(res))
    return out


@pytest.mark.parametrize(
    "alpha,mode,null_policy",
    [
        (0.0, "residuals", "ignore"),
        (0.0, "residuals", "drop"),
        (0.0001, "residuals", "drop_y_zero_x"),
        (0.01, "residuals", "drop_zero"),
    ],
)
def test_multi_target_matches_jax(alpha, mode, null_policy):
    d = _data(missing=null_policy not in {"zero", "ignore"})

    def query(mod):
        kw = mod.OLSKwargs(null_policy=null_policy, solve_method="svd", alpha=alpha)
        return mod.compute_multi_target_least_squares(
            "y", mod.col("^x.*$"), mode=mode, ols_kwargs=kw
        ).over("group")

    (tv, tm), (jv, jm) = _both(d, query)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tv, jv, atol=ATOL, equal_nan=True)
    # and each target equals its own single-target fit in the port
    kw = pt.OLSKwargs(null_policy=null_policy, solve_method="svd", alpha=alpha)
    single = _frame(pt, d).unnest("y").select(*[
        pt.compute_least_squares(t, pt.col("^x.*$"), mode=mode, ols_kwargs=kw).over("group").alias(t)
        for t in ("y1", "y2", "y3")
    ])
    np.testing.assert_allclose(tv, _arrays(single)[0], atol=ATOL, equal_nan=True)


def test_multi_target_weighted_grouped_matches_jax():
    d = _data(n_groups=5, seed=7)

    def query(mod):
        return mod.compute_multi_target_least_squares(
            "y", mod.col("^x.*$"), sample_weights=mod.col("w")
        ).over("group")

    (tv, tm), (jv, jm) = _both(d, query, targets=("y1", "y2"))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tv, jv, atol=ATOL)
    sq = np.sqrt(d["w"])
    for g in range(5):
        m = d["g"] == g
        for j, t in enumerate(("y1", "y2")):
            beta = np.linalg.lstsq(d["x"][m] * sq[m, None], d["t"][t][m] * sq[m], rcond=None)[0]
            np.testing.assert_allclose(tv[m, j], d["x"][m] @ beta, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("mode", ["predictions", "residuals"])
def test_multi_target_single_group_matches_jax(mode):
    d = _data(n=3_000, seed=3)

    def query(mod):
        return mod.struct(mod.col("t_y1"), mod.col("t_y3")).least_squares.multi_target_ols(
            "x1", "x2", "x3", add_intercept=True, mode=mode
        )

    out = []
    for mod in (pt, pj):
        res = _frame(mod, d).select(query(mod).alias("p")).unnest("p")
        assert res.columns == ["t_y1", "t_y3"]
        out.append(_arrays(res))
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_allclose(out[0][0], out[1][0], atol=ATOL)


@pytest.mark.parametrize("policy", ["zero", "drop"])
def test_multi_target_coefficients_against_lstsq(policy):
    # the engine's module path: the [Y | X] blocks, the Householder tree
    # and the SVD of the factors, per target against numpy lstsq
    d = _data(n=4_000, n_groups=6, missing=True, seed=5)
    df = _frame(pt, d)
    target = df["y"]
    feats = [df[f"x{i + 1}"] for i in range(3)]
    layout = groups.layout_for_columns([df["group"]])
    fields = list(target.sources)
    vals, valid = fit._stack_cached(fields[0], fields[1:] + feats)
    beta = fit._fit_svd(layout, vals, valid, policy, 0.0, None, m=3)[0].numpy()
    xz = np.where(d["valid"][:, None] | (np.arange(3) > 0), d["x"], 0.0)
    fit_rows = d["valid"] if policy == "drop" else np.ones(len(xz), bool)
    for g in range(6):
        m = (d["g"] == g) & fit_rows
        for j, t in enumerate(("y1", "y2", "y3")):
            want = np.linalg.lstsq(xz[m], d["t"][t][m], rcond=None)[0]
            np.testing.assert_allclose(beta[g, :, j], want, rtol=1e-9, atol=1e-11)


def test_multi_target_stack_is_cached_across_queries(monkeypatch):
    # the struct is rebuilt every query; the [N, M + K] stack is keyed on
    # its field Series and the features, so it (and the blocks) hit
    d = _data(seed=2)
    df = _frame(pt, d)
    q = pt.struct(pt.col("t_y1"), pt.col("t_y2")).least_squares.multi_target_ols(
        "x1", "x2", "x3"
    ).over("group")
    first = df.select(q)["predictions"]
    feats = [df[f"x{i + 1}"] for i in range(3)]
    key = ("stack", id(df["t_y2"])) + tuple(id(f) for f in feats)
    stacked = df["t_y1"]._layout_cache[key][0]
    assert stacked[0].dtype == torch.float64 and stacked[0].shape == (2_000, 5)
    second = df.select(q)["predictions"]
    assert df["t_y1"]._layout_cache[key][0][0] is stacked[0]
    assert torch.equal(first.values, second.values)
    assert first.values.dtype == torch.float64


def test_cpu_multi_target_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(householder, "householder_kernel_launches", 0)
    d = _data(seed=4)
    _frame(pt, d).select(
        pt.struct(pt.col("t_y1"), pt.col("t_y2")).least_squares.multi_target_ols("x1", "x2").over("group")
    )
    assert householder.householder_kernel_launches == 0


def _error_frame(mod):
    rng = np.random.default_rng(0)
    n = 200
    return mod.DataFrame({"y": rng.normal(size=n), "x1": rng.normal(size=n), "x2": rng.normal(size=n)})


ERRORS = {
    # id: (query on (mod, frame), exception, message) of tests/test_error_paths.py:61-115
    "formula_categorical": (
        lambda mod, df: df.select(mod.col("y").least_squares.from_formula("x1 + C(x2)")),
        AssertionError, "categorical",
    ),
    "multi_target_coefficients": (
        lambda mod, df: df.select(mod.struct(mod.col("y"), mod.col("x2")).least_squares.multi_target_ols(
            mod.col("x1"), mode="coefficients")),
        NotImplementedError, "predictions",
    ),
    "multi_target_statistics": (
        lambda mod, df: df.select(mod.struct(mod.col("y"), mod.col("x2")).least_squares.multi_target_ols(
            mod.col("x1"), mode="statistics")),
        NotImplementedError, "predictions",
    ),
    "multi_target_lasso": (
        lambda mod, df: df.select(mod.struct(mod.col("y"), mod.col("x2")).least_squares.multi_target_ols(
            mod.col("x1"), alpha=0.1, l1_ratio=0.5)),
        AssertionError, "unconstrained",
    ),
    "multi_target_positive": (
        lambda mod, df: df.select(mod.struct(mod.col("y"), mod.col("x2")).least_squares.multi_target_ols(
            mod.col("x1"), positive=True)),
        AssertionError, "unconstrained",
    ),
    "multi_target_chol": (
        lambda mod, df: df.select(mod.struct(mod.col("y"), mod.col("x2")).least_squares.multi_target_ols(
            mod.col("x1"), solve_method="chol")),
        AssertionError, "shared SVD",
    ),
    "predict_fit_only_policy": (
        lambda mod, df: df.with_columns(
            mod.col("y").least_squares.ols(mod.col("x1"), mode="coefficients").alias("c")
        ).select(mod.col("c").least_squares.predict(mod.col("x1"), null_policy="drop_zero")),
        AssertionError, "drop/ignore/zero",
    ),
    "elastic_net_zero_alpha": (
        lambda mod, df: df.select(mod.col("y").least_squares.elastic_net(mod.col("x1"), alpha=0.0, l1_ratio=0.5)),
        AssertionError, "alpha",
    ),
    "ridge_negative_alpha": (
        lambda mod, df: df.select(mod.col("y").least_squares.ridge(mod.col("x1"), alpha=-1.0)),
        AssertionError, "non-negative",
    ),
    "predict_feature_count": (
        lambda mod, df: df.with_columns(
            mod.col("y").least_squares.ols(mod.col("x1"), mod.col("x2"), mode="coefficients").alias("c")
        ).select(mod.col("c").least_squares.predict(mod.col("x1"))),
        AssertionError, "feature",
    ),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_paths_raise_what_jax_raises(case):
    query, exc, match = ERRORS[case]
    for mod in (pj, pt):
        with pytest.raises(exc, match=match):
            query(mod, _error_frame(mod))


def test_struct_series_fields_and_row_validity():
    # a row of a struct target counts as valid only when every field is
    # (the row mask prepare_problem takes for a 2-D target)
    rng = np.random.default_rng(6)
    a, b = rng.normal(size=6), rng.normal(size=6)
    df = pt.DataFrame({"a": pt.Series("a", a, [1, 1, 0, 1, 1, 1]), "b": pt.Series("b", b, [1, 0, 0, 1, 1, 1])})
    s = df.select(pt.struct(pt.col("a"), q=pt.col("b")).alias("s"))["s"]
    assert s.field_names == ["a", "q"] and s.sources == (df["a"], df["b"])
    np.testing.assert_array_equal(s.valid_mask().numpy(), [True, False, False, True, True, True])
    np.testing.assert_array_equal(s.field("q").to_numpy()[3:], b[3:])
    assert np.isnan(s.field("q").to_numpy()[1])
    assert [f.name for f in s.fields()] == ["a", "q"]
    assert df.with_columns(s).unnest("s").columns == ["a", "b", "q"]


def _wide_targets(m: int, k: int, seed: int):
    """800 rows in 4 groups: k features, m targets of their own
    coefficients, 5 % nulls in x0 (row 0 valid)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(800, k))
    Y = x @ rng.normal(size=(k, m)) + 0.1 * rng.normal(size=(800, m))
    valid = rng.random(800) >= 0.05
    valid[0] = True
    return x, Y, valid, np.repeat(np.arange(4.0), 200)


@pytest.mark.parametrize("null_policy", ["zero", "drop"])
@pytest.mark.parametrize("m,k", [(40, 3), (2, 32), (3, 31), (2, 40)])
def test_multi_target_wider_than_33_columns_matches_jax(m, k, null_policy):
    # M + K > 33: the shape that raised in the port (ROADMAP Queue 3,
    # fault 1), now the wide form of the Householder kernel (its plain
    # version here) under the shared SVD
    x, Y, valid, g = _wide_targets(m, k, seed=m * 100 + k)
    out = []
    for mod in (pt, pj):
        cols = {"x0": mod.Series("x0", x[:, 0], valid)}
        cols.update({f"x{i}": x[:, i] for i in range(1, k)})
        cols.update({f"t{j}": Y[:, j] for j in range(m)})
        cols["g"] = g
        q = mod.struct(*[mod.col(f"t{j}") for j in range(m)]).least_squares.multi_target_ols(
            *[f"x{i}" for i in range(k)], null_policy=null_policy, mode="residuals"
        ).over("g")
        res = mod.DataFrame(cols).select(q.alias("p")).unnest("p")
        assert res.columns == [f"t{j}" for j in range(m)]
        out.append(_arrays(res))
    (tv, tm), (jv, jm) = out
    np.testing.assert_array_equal(tm, jm)
    assert np.isfinite(tv[tm]).all()
    np.testing.assert_allclose(tv, jv, atol=ATOL, equal_nan=True)
