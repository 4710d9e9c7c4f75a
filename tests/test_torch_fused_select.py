"""The fused select of the PyTorch port (engine/batch.py) against its eager
select and against the JAX package's fused select.

The 17 cases of tests/test_fused_select.py on the same seed-7 frame of 400
rows. Each select runs through the port fused and eager (every column
within atol 1e-12, nulls identical, the same names), and through the JAX
package with its fused select on: static fits and statistics at rtol 1e-9
/ atol 1e-11 (tests/test_torch_ols.py's ``FIT_TOL``), coordinate descent
at rtol 1e-8 / atol 1e-10 (``CD_TOL``), the moving models at the JAX lane
solvers' tolerance, rtol 1e-6 / atol 1e-8, from the row on where a group
holds 3 K rows (tests/test_torch_moving.py: their diffuse prior needs
them), the null pattern everywhere.

Further cases: ``rls`` residuals, with and without ``.over``, beside two
static fits; an 8-alpha sweep computes its moments once where the eager
select computes them 8 times; a fused select reads its flags from the
device once, and so does a fit alone; a collinear group (failed Cholesky
lanes), an ill-conditioned group (the CSNE sweeps) and a flagged moving
row give the eager result; a missing column raises the eager
``KeyError``; the schedule groups plans by partition, solve family and
K; a repeated select over three partitions gathers nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import polars_ols_tpu as pj  # noqa: E402
from polars_ols_tpu.config import CONFIG as JCONFIG  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.engine import batch, fit  # noqa: E402
from polars_ols_tpu_torch.ops import linalg  # noqa: E402

FIT_TOL = dict(rtol=1e-9, atol=1e-11)
CD_TOL = dict(rtol=1e-8, atol=1e-10)
MOVING_TOL = dict(rtol=1e-6, atol=1e-8)
FUSED_ATOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    # the suite runs six workers on the host's cores: torch's intra-op
    # threads in each oversubscribe them
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")
    monkeypatch.setattr(CONFIG, "fused_select", True)
    monkeypatch.setattr(JCONFIG, "fused_select", True)


def _data():
    rng = np.random.default_rng(7)
    n = 400
    x = rng.normal(size=(n, 5))
    data = {f"x{i+1}": x[:, i] for i in range(5)}
    data["y"] = x.sum(axis=1) + rng.normal(size=n, scale=0.1)
    data["y2"] = x @ rng.normal(size=5) + rng.normal(size=n, scale=0.1)
    data["w"] = rng.random(n) + 0.1
    data["g"] = rng.integers(0, 8, size=n).astype(float)
    return data


@pytest.fixture(scope="module")
def frames():
    # one pair for the module: the JAX frame's cached stacks and layouts
    # serve every case
    with pytest.MonkeyPatch.context() as patched:
        patched.setattr(CONFIG, "device", "cpu")
        data = _data()
        yield pt.DataFrame(data), pj.DataFrame(data)


def _port_arrays(c):
    """{field: (values, valid)} of a port column, as host arrays."""
    if hasattr(c, "arrays"):  # statistics
        return {k: (v.cpu().numpy(), np.isfinite(v.cpu().numpy())) for k, v in c.arrays.items()}
    if hasattr(c, "field_names"):  # struct
        v = c.values.cpu().numpy()
        valid = np.ones(v.shape, bool) if c.validity is None else c.validity.cpu().numpy()
        return {"": (v, valid)}
    return {"": (c.f64().cpu().numpy(), c.valid_mask().cpu().numpy())}


def _jax_values(c):
    if hasattr(c, "arrays"):
        return {k: np.asarray(v, dtype=float) for k, v in c.arrays.items()}
    if hasattr(c, "field_names"):
        v = np.asarray(c.values, dtype=float)
        if c.validity is not None:
            v = np.where(np.asarray(c.validity), v, np.nan)
        return {"": v}
    return {"": np.asarray(c.to_numpy(), dtype=float)}


def _fused_and_eager(df, exprs):
    fused = df.select(*exprs())
    CONFIG.fused_select = False
    try:
        eager = df.select(*exprs())
    finally:
        CONFIG.fused_select = True
    assert fused.columns == eager.columns
    for name in fused.columns:
        a, b = _port_arrays(fused[name]), _port_arrays(eager[name])
        assert a.keys() == b.keys(), name
        for key in a:
            (av, am), (bv, bm) = a[key], b[key]
            np.testing.assert_array_equal(am, bm, err_msg=f"{name} {key}: nulls")
            np.testing.assert_allclose(av[am], bv[bm], rtol=0, atol=FUSED_ATOL, err_msg=f"{name} {key}")
    return fused


def _compare(frames, exprs, tol=None, moving_k=None):
    """The select ``exprs(m)`` on both frames: the port fused against the
    port eager, then against the JAX package fused (``tol`` {column:
    tolerance}, FIT_TOL elsewhere; ``moving_k`` {column: (K, over keys)}
    of the moving columns)."""
    tdf, jdf = frames
    fused = _fused_and_eager(tdf, lambda: exprs(pt))
    want = jdf.select(*exprs(pj))
    assert fused.columns == want.columns
    tol, moving_k = tol or {}, moving_k or {}
    for name in fused.columns:
        got = {k: np.where(m, v, np.nan) for k, (v, m) in _port_arrays(fused[name]).items()}
        ref = _jax_values(want[name])
        for key in got:
            g, r = got[key], ref[key]
            if name in moving_k:
                np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=name)
                k, keys = moving_k[name]
                settled = _rank(tdf, keys) >= 3 * k
                g, r = g[settled], r[settled]
            np.testing.assert_allclose(
                g, r, equal_nan=True, err_msg=f"{name} {key}",
                **(tol.get(name) or (MOVING_TOL if name in moving_k else FIT_TOL)),
            )
    return fused


def _rank(df, keys):
    """Each row's position within its group (the frame for no keys)."""
    n = df.height
    if not keys:
        return np.arange(n)
    g = df[keys].to_numpy()
    rank = np.zeros(n, dtype=np.int64)
    for v in np.unique(g):
        rows = np.flatnonzero(g == v)
        rank[rows] = np.arange(len(rows))
    return rank


def _feats(m, k=5):
    return [m.col(f"x{i+1}") for i in range(k)]


# --------------------------------------------------------------------------- #
# the 17 cases of tests/test_fused_select.py
# --------------------------------------------------------------------------- #
def test_fused_two_plain_fits(frames):
    def exprs(m):
        ls = m.col("y").least_squares
        return ls.ols(*_feats(m)).alias("a"), ls.ridge(*_feats(m), alpha=0.3).alias("b")

    assert _compare(frames, exprs).shape == (400, 2)


def test_fused_mixed_solvers(frames):
    def exprs(m):
        ls, f = m.col("y").least_squares, _feats(m)
        return (
            ls.ols(*f, solve_method="qr").alias("qr"),
            ls.ols(*f, solve_method="svd").alias("svd"),
            ls.ols(*f, solve_method="lu").alias("lu"),
            ls.elastic_net(*f, alpha=0.1, l1_ratio=0.5).alias("en"),
        )

    _compare(frames, exprs, tol={"en": CD_TOL})


def test_fused_wls_and_modes(frames):
    def exprs(m):
        ls, f = m.col("y").least_squares, _feats(m)
        return (
            ls.wls(*f, sample_weights=m.col("w")).alias("wls"),
            ls.ols(*f, mode="residuals").alias("res"),
            ls.ols(*f, mode="coefficients"),
        )

    out = _compare(frames, exprs)
    tdf = frames[0]
    preds = tdf.select(pt.col("y").least_squares.ols(*_feats(pt)))["y"].to_numpy()
    np.testing.assert_allclose(out["res"].to_numpy(), tdf["y"].to_numpy() - preds, rtol=0, atol=1e-12)


def test_fused_wls_residuals(frames):
    def exprs(m):
        ls, f = m.col("y").least_squares, _feats(m)
        return (
            ls.wls(*f, sample_weights=m.col("w"), mode="residuals").alias("a"),
            ls.ridge(*f, alpha=0.2, mode="residuals").alias("b"),
        )

    _compare(frames, exprs)


def test_fused_grouped(frames):
    def exprs(m):
        ls, f = m.col("y").least_squares, _feats(m)
        return (
            ls.ols(*f).over("g").alias("a"),
            ls.ridge(*f, alpha=0.1).over("g").alias("b"),
            ls.ols(*f, mode="coefficients").over("g"),
        )

    assert _compare(frames, exprs).shape == (400, 3)


def test_fused_grouped_and_single_mixed(frames):
    def exprs(m):
        ls, f = m.col("y").least_squares, _feats(m, 3)
        return ls.ols(*f).over("g").alias("grouped"), ls.ols(*f).alias("pooled")

    _compare(frames, exprs)


def test_fused_distinct_targets(frames):
    def exprs(m):
        f = _feats(m)
        return m.col("y").least_squares.ols(*f).alias("a"), m.col("y2").least_squares.ols(*f).alias("b")

    _compare(frames, exprs)


def test_fused_with_nonfusable_columns(frames):
    def exprs(m):
        ls, f = m.col("y").least_squares, _feats(m)
        return (
            m.col("g"),
            ls.ols(*f).alias("a"),
            ls.rls(*f, half_life=50.0).alias("rls"),
            ls.ridge(*f, alpha=0.1).alias("b"),
        )

    out = _compare(frames, exprs, moving_k={"rls": (5, None)})
    assert out.columns == ["g", "a", "rls", "b"]


def test_fused_null_policies():
    rng = np.random.default_rng(3)
    n = 300
    x = rng.normal(size=(n, 2))
    y = x.sum(axis=1) + rng.normal(size=n, scale=0.1)
    y[::17] = np.nan

    def frame(m):
        df = m.DataFrame({"x1": x[:, 0], "x2": x[:, 1], "y": y})
        return df.with_columns(m.col("y").fill_nan(None).alias("y"))

    def exprs(m):
        ls = m.col("y").least_squares
        return (
            ls.ols(m.col("x1"), m.col("x2"), null_policy="zero").alias("z"),
            ls.ols(m.col("x1"), m.col("x2"), null_policy="drop").alias("d"),
        )

    out = _compare((frame(pt), frame(pj)), exprs)
    assert out["d"].null_count() == len(range(0, n, 17))


def test_fused_intercept(frames):
    def exprs(m):
        ls = m.col("y").least_squares
        return (
            ls.ols(m.col("x1"), m.col("x2"), add_intercept=True).alias("a"),
            ls.ridge(m.col("x1"), m.col("x2"), alpha=0.1, add_intercept=True).alias("b"),
        )

    _compare(frames, exprs)


def test_fused_single_fit_falls_back(frames, monkeypatch):
    # one fit beside a column: the fit is planned once and run as a plan
    # alone, the run its own evaluation makes
    plans = []
    real = batch.plan_fit
    monkeypatch.setattr(batch, "plan_fit", lambda *a, **k: plans.append(1) or real(*a, **k))

    def exprs(m):
        return m.col("g"), m.col("y").least_squares.ols(m.col("x1")).alias("a")

    assert _compare(frames, exprs).columns == ["g", "a"]
    assert len(plans) == 2  # once fused, once eager


def test_fused_statistics(frames):
    def exprs(m):
        ls, f = m.col("y").least_squares, _feats(m)
        return ls.ols(*f, mode="statistics").alias("s"), ls.ridge(*f, alpha=0.1).alias("p")

    _compare(frames, exprs)


def test_fused_grouped_statistics(frames):
    def exprs(m):
        ls, f = m.col("y").least_squares, _feats(m, 3)
        return ls.ols(*f, mode="statistics").over("g").alias("s"), ls.ols(*f).over("g").alias("p")

    _compare(frames, exprs)


def test_fused_moving(frames):
    def exprs(m):
        ls, f = m.col("y").least_squares, _feats(m, 3)
        return (
            ls.rls(*f, half_life=30.0).alias("rls"),
            ls.rolling_ols(*f, window_size=60).alias("roll"),
            ls.expanding_ols(*f).alias("exp"),
            ls.ols(*f).alias("static"),
        )

    _compare(frames, exprs, moving_k={c: (3, None) for c in ("rls", "roll", "exp")})


def test_fused_moving_grouped(frames):
    def exprs(m):
        ls, f = m.col("y").least_squares, _feats(m, 2)
        return (
            ls.rls(*f, half_life=20.0).over("g").alias("rls"),
            ls.rolling_ols(*f, window_size=30).over("g").alias("roll"),
        )

    _compare(frames, exprs, moving_k={c: (2, "g") for c in ("rls", "roll")})


def test_fused_moving_wls(frames):
    def exprs(m):
        ls, f = m.col("y").least_squares, _feats(m, 2)
        return (
            ls.rls(*f, half_life=20.0, sample_weights=m.col("w")).alias("a"),
            ls.rolling_ols(*f, window_size=40, sample_weights=m.col("w")).alias("b"),
        )

    _compare(frames, exprs, moving_k={c: (2, None) for c in ("a", "b")})


def test_fused_program_reuse(frames, monkeypatch):
    # the same select twice: the second reuses the cached stacks and
    # partitions, and gives the same bits
    tdf = frames[0]

    def exprs():
        ls, f = pt.col("y").least_squares, _feats(pt)
        return ls.ols(*f).alias("a"), ls.ridge(*f, alpha=0.1).alias("b")

    out1 = tdf.select(*exprs())
    monkeypatch.setattr(fit, "layout_gathers", 0)
    out2 = tdf.select(*exprs())
    assert fit.layout_gathers == 0
    assert np.array_equal(out1.to_numpy(), out2.to_numpy())


def test_fused_moving_residuals(frames):
    # rls residuals, alone and per group, beside two static fits: each is
    # y minus its own predictions
    def exprs(m):
        ls, f = m.col("y").least_squares, _feats(m, 2)
        return (
            ls.rls(*f, half_life=20.0, mode="residuals").alias("r"),
            ls.rls(*f, half_life=20.0, mode="residuals").over("g").alias("rg"),
            ls.ols(*f).alias("a"),
            ls.ridge(*f, alpha=0.1).alias("b"),
        )

    out = _compare(frames, exprs, moving_k={"r": (2, None), "rg": (2, "g")})
    tdf, ls = frames[0], pt.col("y").least_squares
    for name, e in (("r", ls.rls(*_feats(pt, 2), half_life=20.0)),
                    ("rg", ls.rls(*_feats(pt, 2), half_life=20.0).over("g"))):
        preds = tdf.select(e)["y"].to_numpy()
        np.testing.assert_array_equal(out[name].to_numpy(), tdf["y"].to_numpy() - preds, err_msg=name)


# --------------------------------------------------------------------------- #
# shared work, one read, flagged plans, errors, caches
# --------------------------------------------------------------------------- #
ALPHAS = (1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0, 1000.0)


def _sweep():
    ls, f = pt.col("y").least_squares, _feats(pt)
    return [ls.ols(*f).over("g").alias("ols")] + [
        ls.ridge(*f, alpha=a).over("g").alias(f"ridge_{a}") for a in ALPHAS
    ]


def _counted(monkeypatch):
    calls = []

    def counting(real):
        def wrapper(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)

        return wrapper

    monkeypatch.setattr(batch, "grouped_moments", counting(batch.grouped_moments))
    return calls


def test_sweep_computes_its_moments_once(frames, monkeypatch):
    calls = _counted(monkeypatch)
    _fused_and_eager(frames[0], _sweep)
    assert len(calls) == 1 + len(ALPHAS) + 1  # fused once, eager once a fit


def test_fused_select_reads_its_flags_once(frames, monkeypatch):
    tdf = frames[0]

    def no_read(*args):
        raise AssertionError("the eager path's host read ran in a fused select")

    with monkeypatch.context() as patched:
        patched.setattr(linalg, "_with_fallback", no_read)
        before = batch.flag_reads
        tdf.select(*_sweep())
        assert batch.flag_reads == before + 1
        tdf.select(_sweep()[0])  # a fit alone: a run of one plan, one read
    assert batch.flag_reads == before + 2
    # (the CPU plain versions of the moving models and of coordinate
    # descent read the device themselves; on the card they do not)
    ls, f = pt.col("y").least_squares, _feats(pt)
    tdf.select(  # every family and the moving models
        ls.ols(*f, solve_method="qr"), ls.ols(*f, solve_method="lu").alias("lu"),
        ls.ols(*f, mode="statistics"), ls.lasso(*f, alpha=0.01).alias("lasso"),
        ls.rls(*f, half_life=30.0).alias("rls"), ls.rolling_ols(*f, window_size=40).alias("roll"),
    )
    assert batch.flag_reads == before + 3


def _hard_frame():
    """Four groups of 60 rows: one whose x5 equals its x4 (its Cholesky
    fails at alpha 0), one with x5 within 1e-7 of x4 (cond(X'X) ~ 1e14:
    the CSNE sweeps), two plain."""
    rng = np.random.default_rng(11)
    n = 240
    x = rng.normal(size=(n, 5))
    g = np.repeat(np.arange(4.0), 60)
    x[g == 0, 4] = x[g == 0, 3]
    x[g == 1, 4] = x[g == 1, 3] + 1e-7 * rng.normal(size=60)
    y = x @ np.arange(1.0, 6.0) + rng.normal(size=n, scale=0.1)
    return pt.DataFrame({**{f"x{i+1}": x[:, i] for i in range(5)}, "y": y, "g": g})


def test_flagged_plans_give_the_eager_result(monkeypatch):
    df = _hard_frame()
    ls, f = pt.col("y").least_squares, _feats(pt)
    fallbacks, sweeps = [], []
    real_fallback, real_csne = batch.fallback_lanes, fit._csne_refine_blocks
    monkeypatch.setattr(batch, "fallback_lanes", lambda *a: fallbacks.append(1) or real_fallback(*a))
    monkeypatch.setattr(fit, "_csne_refine_blocks", lambda *a, **k: sweeps.append(1) or real_csne(*a, **k))
    out = _fused_and_eager(df, lambda: [
        ls.ols(*f).over("g").alias("ols"),
        ls.ols(*f, mode="coefficients").over("g"),
        ls.ridge(*f, alpha=1e-9).over("g").alias("ridge"),
        ls.ols(*f, solve_method="lu").over("g").alias("lu"),
        ls.ols(*f, mode="statistics").over("g"),
    ])
    assert fallbacks and sweeps  # the flagged continuations ran
    assert np.isfinite(out["ols"].to_numpy()).all()


def test_flagged_moving_row_gives_the_eager_result():
    # a window of collinear rows: rolling's Cholesky fails there (on the
    # card the kernel flags the row and the eigh solve takes it; here the
    # plain version's fallback)
    rng = np.random.default_rng(5)
    n = 120
    x = rng.normal(size=(n, 2))
    x[40:60, 1] = x[40:60, 0]
    y = x.sum(axis=1) + rng.normal(size=n, scale=0.1)
    df = pt.DataFrame({"x1": x[:, 0], "x2": x[:, 1], "y": y})
    ls = pt.col("y").least_squares
    _fused_and_eager(df, lambda: [
        ls.rolling_ols("x1", "x2", window_size=10).alias("roll"),
        ls.rls("x1", "x2", half_life=5.0).alias("rls"),
        ls.ols("x1", "x2").alias("ols"),
    ])


def test_what_fuses(frames):
    # every single-target fit is a plan: each family and mode, residuals
    # (over nulls too), the moving models in every mode, each null policy;
    # a column, a multi-target fit, a struct target and a nested .over are
    # evaluated on their own
    tdf = frames[0].with_columns(pt.Series("yn", frames[0]["y"].f64(), np.arange(400) % 7 != 0))
    ls, lsn, f = pt.col("y").least_squares, pt.col("yn").least_squares, _feats(pt)
    fused = [
        ls.ols(*f), ls.ols(*f, solve_method="qr"), ls.ols(*f, solve_method="lu"), ls.ols(*f, solve_method="svd"),
        ls.lasso(*f, alpha=0.1), ls.ols(*f, mode="residuals").over("g"), ls.ols(*f, mode="coefficients"),
        ls.ols(*f, mode="statistics").over("g"), ls.rls(*f, half_life=20.0), ls.rolling_ols(*f, window_size=30),
        lsn.ols(*f, null_policy="drop"), ls.rls(*f, half_life=20.0, mode="coefficients"),
        ls.rls(*f, half_life=20.0, mode="residuals"), lsn.ols(*f, mode="residuals"),
        lsn.ols(*f, null_policy="drop_zero"), lsn.ols(*f, solve_method="svd", null_policy="ignore"),
    ]
    eager = [
        pt.col("g"), pt.struct(pt.col("y"), pt.col("y2")).least_squares.multi_target_ols(*f),
        pt.struct(pt.col("y"), pt.col("y2")).least_squares.ols(*f), ls.ols(*f).over("g").over("g"),
    ]
    assert all(batch._plan_expr(tdf, e) is not None for e in fused)
    assert all(batch._plan_expr(tdf, e) is None for e in eager)


def test_what_fuses_gives_the_eager_result(frames):
    # the plans that the JAX planner leaves to its eager path give, in a
    # select, what they give alone
    tdf = frames[0].with_columns(pt.Series("yn", frames[0]["y"].f64(), np.arange(400) % 7 != 0))
    _fused_and_eager(tdf, lambda: [
        pt.col("y").least_squares.rls(*_feats(pt), half_life=20.0, mode="coefficients").alias("c"),
        pt.col("yn").least_squares.ols(*_feats(pt), mode="residuals").alias("r"),
        pt.col("yn").least_squares.ols(*_feats(pt), null_policy="drop_zero").alias("z"),
        pt.col("yn").least_squares.ols(*_feats(pt), solve_method="svd", null_policy="ignore").alias("s"),
        pt.col("y").least_squares.ols(*_feats(pt)).alias("o"),
    ])


def test_missing_column_raises_as_eager(frames):
    tdf = frames[0]
    ls = pt.col("y").least_squares

    def select():
        return tdf.select(ls.ols("x1", "x2").alias("a"), ls.ols("x1", "nope").alias("b"))

    with pytest.raises(KeyError) as fused:
        select()
    CONFIG.fused_select = False
    try:
        with pytest.raises(KeyError) as eager:
            select()
    finally:
        CONFIG.fused_select = True
    assert str(fused.value) == str(eager.value)


def test_schedule_shares_work_by_partition(frames):
    # one moment launch, one Cholesky batch, one reduction and one
    # prediction pass for the plans on y's partition; y2's its own; LU,
    # coefficients, statistics and the moving model as their kinds need
    tdf, ls, f = frames[0], pt.col("y").least_squares, _feats(pt)
    exprs = [
        ls.ols(*f), ls.ridge(*f, alpha=0.1), pt.col("y2").least_squares.ols(*f), ls.ols(*f, solve_method="lu"),
        ls.ols(*f, solve_method="svd"), ls.ridge(*f, alpha=0.1, solve_method="svd"), ls.lasso(*f, alpha=0.1),
        ls.ols(*f, mode="coefficients"), ls.ols(*f, mode="statistics"), ls.rls(*f, half_life=20.0),
    ]
    program = batch._schedule([batch._plan_expr(tdf, e) for e in exprs])
    assert program.moments == ((0, 1, 3, 6, 7, 8), (2,))
    assert program.solves == (("chol", (0, 1, 7, 8)), ("chol", (2,)), ("lu", (3,)))
    assert program.reductions == ((4, 5),)
    assert program.passes == ((0, 1, 3, 4, 5, 6), (2,))
    assert program.moving == (9,)


def test_repeated_select_over_three_partitions_gathers_nothing(monkeypatch):
    # y, y2 and the weighted stack: three partitions, one more than a
    # layout keeps of a kind; the select holds its own while it runs
    data = _data()
    df = pt.DataFrame(data)
    ls, f = pt.col("y").least_squares, _feats(pt)

    def select():
        return df.select(
            ls.ols(*f).over("g").alias("a"),
            pt.col("y2").least_squares.ols(*f).over("g").alias("b"),
            ls.wls(*f, sample_weights="w").over("g").alias("c"),
        )

    select()
    monkeypatch.setattr(fit, "layout_gathers", 0)
    select()
    assert fit.layout_gathers == 0
