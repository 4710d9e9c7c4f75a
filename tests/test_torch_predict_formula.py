"""``predict``, ``predict_from_formula`` and the formula API through both
engines.

The port's own copy of the formula parser (``polars_ols_tpu_torch/utils.py``)
is held to the JAX package's ``build_expressions_from_patsy_formula`` on a
list of formulas: the same output names, the same intercept flag, the same
refusals. ``from_formula`` (static, ``half_life`` -> rls, ``window_size`` ->
rolling) and ``predict`` (null policies zero / ignore / drop, null
features, null coefficient rows, ``add_intercept``, ``predict_from_formula``)
run through both engines on numpy-seeded frames: static fits and predict at
rtol 1e-12 (the same solves; predict is a row-wise dot product), moving fits
at the moving-model parity tolerance of tests/test_torch_moving_api.py
(rtol 1e-8 / atol 1e-10) from K + 3 rows on; identical null masks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import polars_ols_tpu as pj  # noqa: E402
from polars_ols_tpu import CONFIG as JCONFIG  # noqa: E402
from polars_ols_tpu.engine import fit as jfit  # noqa: E402
from polars_ols_tpu.utils import build_expressions_from_patsy_formula as jparse  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.engine import fit as tfit  # noqa: E402
from polars_ols_tpu_torch.utils import build_expressions_from_patsy_formula as tparse  # noqa: E402
from polars_ols_tpu_torch.utils import timer  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-12)
MOVING_TOL = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    monkeypatch.setattr(CONFIG, "moment_chunk_rows", 128)
    monkeypatch.setattr(JCONFIG, "moment_chunk_rows", 128)


FORMULAS = [
    ("y ~ x1 + x2", True),
    ("y ~ x1 + x2 + x3:x4 - 1", True),
    ("y ~ x1 + x2 + x3 - x2", True),
    ("y ~ x1 + x1 + x2 - x9 - 1", True),
    ("y ~ x1 + 0", True),
    ("y ~ x1 - 1 + 1", True),
    ("x1 + x2:x3 - x2:x3 + x4", False),
    ("x1:x2:x3 + x_a.b", False),
    ("y ~ x1 + x2", False),
    ("x1 + x2 - x2 - 1", False),
]


@pytest.mark.parametrize("formula,dependent", FORMULAS)
def test_parser_matches_jax(formula, dependent):
    t_exprs, t_int = tparse(formula, include_dependent_variable=dependent)
    j_exprs, j_int = jparse(formula, include_dependent_variable=dependent)
    assert [e.output_name for e in t_exprs] == [e.meta.output_name for e in j_exprs]
    assert t_int == j_int


@pytest.mark.parametrize(
    "formula,dependent",
    [("x1 + C(x2)", False), ("y ~ log(x1) + x2", True), ("x1 + x2", True), ("y + z ~ x1", True)],
)
def test_parser_refuses_what_jax_refuses(formula, dependent):
    with pytest.raises(AssertionError) as j:
        jparse(formula, include_dependent_variable=dependent)
    with pytest.raises(AssertionError, match=str(j.value).split("(")[0].strip()[:30]):
        tparse(formula, include_dependent_variable=dependent)


def test_timer_prints_milliseconds(capsys):
    with timer("fit") as elapsed:
        assert elapsed() >= 0.0
    assert elapsed() >= 0.0
    assert capsys.readouterr().out.startswith("fit took: ")


def _data(n=1_500, n_groups=4, seed=0, nulls=False):
    """Columns y, x1..x4 and a group column, as numpy; with ``nulls``, ~5 %
    nulls in x2 (row 0 valid: the JAX engine's padding slots read it)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    y = x[:, 0] - 2 * x[:, 1] + 0.5 * x[:, 2] * x[:, 3] + rng.normal(size=n) * 0.1
    valid = rng.random(n) >= 0.05 if nulls else np.ones(n, dtype=bool)
    valid[0] = True
    return dict(x=x, y=y, g=rng.integers(n_groups, size=n).astype(float), valid=valid)


def _frame(mod, d):
    cols = {"y": d["y"], "x1": d["x"][:, 0]}
    cols["x2"] = mod.Series("x2", d["x"][:, 1], None if d["valid"].all() else d["valid"])
    cols["x3"], cols["x4"], cols["group"] = d["x"][:, 2], d["x"][:, 3], d["g"]
    return mod.DataFrame(cols)


def _values(s):
    """(values with nulls as NaN, validity) of a Series or struct column."""
    vals = s.to_numpy()
    valid = np.ones(vals.shape, bool) if s.validity is None else np.asarray(s.validity)
    return vals, valid


def _both(d, query, column):
    (tv, tm), (jv, jm) = (_values(_frame(mod, d).select(query(mod))[column]) for mod in (pt, pj))
    np.testing.assert_array_equal(tm, jm)
    return tv, jv


@pytest.mark.parametrize("grouped", [True, False], ids=["over", "single"])
@pytest.mark.parametrize("mode", ["predictions", "residuals", "coefficients"])
def test_static_from_formula_matches_jax(mode, grouped):
    d = _data(seed=1)

    def query(mod):
        e = mod.col("y").least_squares.from_formula("x1 + x2 + x3:x4", mode=mode)
        return e.over("group") if grouped else e

    tv, jv = _both(d, query, "coefficients" if mode == "coefficients" else "y")
    np.testing.assert_allclose(tv, jv, **TOL)
    if mode == "coefficients" and not grouped:  # the intercept is the last field
        X = np.column_stack([d["x"][:, 0], d["x"][:, 1], d["x"][:, 2] * d["x"][:, 3], np.ones(len(d["y"]))])
        np.testing.assert_allclose(tv[0], np.linalg.lstsq(X, d["y"], rcond=None)[0], rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("grouped", [True, False], ids=["over", "single"])
@pytest.mark.parametrize("kw", [dict(half_life=20.0), dict(window_size=60)], ids=["rls", "rolling"])
def test_moving_from_formula_matches_jax(kw, grouped):
    d = _data(seed=2, nulls=True)

    def query(mod):
        e = mod.compute_least_squares_from_formula("y ~ x1 + x2:x3 - 1", **kw)
        return e.over("group") if grouped else e

    tv, jv = _both(d, query, "y")
    # from K + 3 = 5 rows of each group on (round-off decides the branch
    # of a singular window before that)
    rank = np.zeros(len(d["y"]), dtype=int)
    for g in np.unique(d["g"]) if grouped else [None]:
        rows = np.flatnonzero(d["g"] == g) if grouped else np.arange(len(d["y"]))
        rank[rows] = np.arange(len(rows))
    m = rank >= 5
    np.testing.assert_allclose(tv[m], jv[m], **MOVING_TOL)


def test_moving_from_formula_equals_its_model():
    d = _data(seed=3)
    df = _frame(pt, d)
    x23 = (pt.col("x2") * pt.col("x3")).alias("x2:x3")
    for kw, model in ((dict(half_life=20.0), "rls"), (dict(window_size=60), "rolling_ols")):
        got = df.select(pt.col("y").least_squares.from_formula("x1 + x2:x3", **kw).over("group"))["y"]
        want = df.select(
            getattr(pt.col("y").least_squares, model)("x1", x23, add_intercept=True, **kw).over("group")
        )["y"]
        np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())


def _coef_frames(d, add_intercept=False):
    """A frame with the grouped coefficients of y on x1, x2, x4 under
    'ignore' (a null x2 makes its group's coefficients NaN, so its rows
    carry null coefficient structs), then new features for predict with
    their own nulls in x1."""
    rng = np.random.default_rng(9)
    x1_valid = rng.random(len(d["y"])) >= 0.05
    out = []
    for mod in (pt, pj):
        df = _frame(mod, d).with_columns(
            mod.col("y").least_squares.ols(
                "x1", "x2", "x4", mode="coefficients", add_intercept=add_intercept
            ).over("group")
        )
        out.append(df.with_columns(mod.Series("x1", d["x"][:, 0] * 1.5, x1_valid)))
    return out


@pytest.mark.parametrize("add_intercept", [False, True])
@pytest.mark.parametrize("policy", ["zero", "ignore", "drop"])
def test_predict_matches_jax(policy, add_intercept):
    d = _data(seed=4, nulls=True)
    # one group has a null x2: its coefficients are NaN (null fields)
    d["valid"][:] = True
    d["valid"][np.flatnonzero(d["g"] == 2)[3]] = False
    frames = _coef_frames(d, add_intercept)
    res = []
    for mod, df in zip((pt, pj), frames):
        q = mod.col("coefficients").least_squares.predict(
            "x1", "x2", "x4", null_policy=policy, add_intercept=add_intercept, name="p"
        )
        res.append(_values(df.select(q)["p"]))
    (tv, tm), (jv, jm) = res
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tv, jv, **TOL)
    group2 = d["g"] == 2
    assert np.isnan(tv[group2]).all()
    x1_valid = np.asarray(frames[0]["x1"].validity)
    if policy == "drop":  # null coefficient rows and null features are null
        assert not tm[group2].any()
        assert (tm[~group2] == (x1_valid & d["valid"])[~group2]).all()
    else:  # null features count as zero, or as NaN under 'ignore'
        finite = ~group2 & (x1_valid & d["valid"] if policy == "ignore" else True)
        assert tm.all() and np.isfinite(tv[finite]).all() and np.isnan(tv[~finite]).all()


def test_predict_equals_the_fits_predictions():
    d = _data(seed=5)
    df = _frame(pt, d).with_columns(
        pt.col("y").least_squares.ols("x1", "x2", "x3", mode="coefficients").over("group")
    )
    got = df.select(pt.col("coefficients").least_squares.predict("x1", "x2", "x3"))["predictions"]
    want = df.select(pt.col("y").least_squares.ols("x1", "x2", "x3").over("group"))["y"]
    assert got.values.dtype == torch.float64  # torch's default is float32
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=1e-12, atol=1e-14)


def test_predict_from_formula_matches_jax():
    d = _data(seed=6)
    res = []
    for mod in (pt, pj):
        df = _frame(mod, d).with_columns(
            coefficients=mod.col("y").least_squares.from_formula("x1 + x2:x3", mode="coefficients").over("group"),
            p1=mod.col("y").least_squares.from_formula("x1 + x2:x3").over("group"),
        ).with_columns(p2=mod.col("coefficients").least_squares.predict_from_formula("x1 + x2:x3"))
        res.append((df["p1"].to_numpy(), df["p2"].to_numpy()))
    np.testing.assert_allclose(res[0][1], res[1][1], **TOL)
    np.testing.assert_allclose(res[0][1], res[0][0], rtol=1e-12, atol=1e-14)


def test_evaluate_predict_matches_jax_on_partly_null_structs():
    # coefficient rows all valid, all null (a left join's unmatched row) and
    # partly null, against features with nulls, under every policy
    rng = np.random.default_rng(12)
    n, k = 12, 3
    beta = rng.normal(size=(n, k))
    bv = np.ones((n, k), bool)
    bv[2], bv[5, 1] = False, False
    X = rng.normal(size=(n, k))
    xv = rng.random((n, k)) > 0.15
    for policy in ("zero", "ignore", "drop"):
        out = []
        for mod, engine in ((pt, tfit), (pj, jfit)):
            coef = _struct(mod, beta, bv)
            feats = [mod.Series(f"x{j}", X[:, j], xv[:, j]) for j in range(k)]
            out.append(_values(engine.evaluate_predict(coef, feats, policy, "p")))
        np.testing.assert_array_equal(out[0][1], out[1][1])
        np.testing.assert_allclose(out[0][0], out[1][0], **TOL)


def _struct(mod, values, validity):
    if mod is pt:
        return pt.StructSeries("c", ["a", "b", "c"], torch.as_tensor(values), torch.as_tensor(validity))
    from polars_ols_tpu.series import StructSeries

    return StructSeries("c", ["a", "b", "c"], values, validity)
