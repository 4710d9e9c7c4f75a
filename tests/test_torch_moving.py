"""The moving solvers of the PyTorch port against the JAX package's.

The same numpy-seeded padded batches ``Xp [G, R, K]``, ``yp [G, R]``,
``vp [G, R]`` (three groups; ~10 % invalid rows where a case asks for them,
with a stretch of leading invalid rows in one group) go through

- the port's plain versions ``ops/recursive.py:solve_recursive_least_squares``
  and ``ops/rolling.py:solve_rolling_ols`` (what the port's wrappers
  ``ops/moving.py`` run on CPU tensors; on the card they run the CUDA
  kernel, which tests/test_torch_gpu.py holds against these),
- the JAX functions of the same names (the classic path, what the JAX
  package runs on the CPU): rtol 1e-7 / atol 1e-9, the tolerance the JAX
  suite holds them to against its oracles,
- the JAX lane solvers ``ops/moving.py:solve_recursive_lanes`` /
  ``solve_rolling_lanes``, called directly: rtol 1e-6 / atol 1e-8 (their
  diffuse prior and f32 preconditioner cost that much),
- the literal numpy Kalman recursion and per-window solves of
  tests/oracles.py.

Values are compared where the window holds at least K + 3 valid rows
(3 K against the lane solvers, whose diffuse prior needs more) or
alpha > 0: with fewer rows than features the system is singular, and
whether its Cholesky fails into the minimum-norm fallback is decided by
round-off in both packages. The NaN pattern must be equal everywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from polars_ols_tpu.ops import moving as jmoving  # noqa: E402
from polars_ols_tpu.ops import recursive as jrecursive  # noqa: E402
from polars_ols_tpu.ops import rolling as jrolling  # noqa: E402

from polars_ols_tpu_torch.ops import moving, recursive, rolling  # noqa: E402

import oracles  # noqa: E402  (tests/oracles.py)

CLASSIC_TOL = dict(rtol=1e-7, atol=1e-9)
LANES_TOL = dict(rtol=1e-6, atol=1e-8)
G, R = 3, 300


def _batch(seed: int, k: int, null_share: float, r: int = R):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(G, r, k)) * np.resize([1.0, 3.0, 0.3], k)
    beta = rng.normal(size=(G, k))
    y = np.einsum("grk,gk->gr", X, beta) + rng.normal(size=(G, r)) * 0.1
    v = np.ones((G, r), dtype=bool)
    if null_share:
        v = rng.random((G, r)) > null_share
        v[1, :7] = False  # rows before the first valid one
    return X, y, v


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _mean_arg(mean, k):
    """(port argument, JAX static argument) of a prior-mean case."""
    if mean == "list":
        vals = np.linspace(-1.0, 1.0, k)
        return list(vals), tuple(float(x) for x in vals)
    return mean, mean


def _window_counts(v, window, positional):
    """Valid rows in each row's window."""
    r = np.cumsum(v, axis=1)
    if positional:
        shifted = np.concatenate([np.zeros((v.shape[0], window), dtype=r.dtype), r], axis=1)
        return r - shifted[:, : v.shape[1]]
    return np.minimum(r, window)


def _assert_paths(got, want, settled, tol):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = settled[..., None] & ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], **tol)


# --------------------------------------------------------------------------- #
# recursive least squares
# --------------------------------------------------------------------------- #
RLS_CASES = [
    # k, half_life, prior mean, null share
    (2, None, None, 0.0),
    (2, 20.0, 0.5, 0.1),
    (5, None, None, 0.1),
    (5, 20.0, None, 0.1),
    (5, 252.0, "list", 0.1),
    (9, None, 0.5, 0.0),
    (17, 252.0, 0.5, 0.1),
    (32, 20.0, "list", 0.1),
]


@pytest.mark.parametrize("k,half_life,mean,null_share", RLS_CASES)
def test_rls_matches_jax_classic(k, half_life, mean, null_share):
    X, y, v = _batch(k, k, null_share)
    m_t, m_j = _mean_arg(mean, k)
    got = recursive.solve_recursive_least_squares(*_t(X, y, v), half_life, 10.0, m_t).numpy()
    want = np.asarray(jrecursive.solve_recursive_least_squares(
        *_j(X, y, v), half_life=half_life, initial_state_covariance=10.0, initial_state_mean=m_j,
    ))
    assert got.dtype == np.float64 and got.shape == (G, R, k)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **CLASSIC_TOL)
    if null_share:  # rows before the first valid one give the prior mean
        first = np.broadcast_to(0.0 if mean is None else np.asarray(m_t), (k,))
        np.testing.assert_allclose(got[1, :7], np.broadcast_to(first, (7, k)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("k,half_life,mean,null_share", [
    (2, None, None, 0.1), (5, 20.0, None, 0.1), (5, 252.0, 0.5, 0.0), (9, None, "list", 0.1),
])
def test_rls_matches_jax_lanes(k, half_life, mean, null_share):
    X, y, v = _batch(100 + k, k, null_share)
    m_t, m_j = _mean_arg(mean, k)
    got = recursive.solve_recursive_least_squares(*_t(X, y, v), half_life, 10.0, m_t).numpy()
    want = np.asarray(jmoving.solve_recursive_lanes(
        *_j(X, y, v), half_life=half_life, initial_state_covariance=10.0, initial_state_mean=m_j,
    ))
    np.testing.assert_allclose(got, want, **LANES_TOL)


@pytest.mark.parametrize("k,half_life,mean,cov", [
    (2, None, None, 10.0), (5, 20.0, 0.5, 10.0), (5, 252.0, None, 3.0), (9, None, 0.25, 10.0),
])
def test_rls_matches_the_kalman_recursion(k, half_life, mean, cov):
    X, y, v = _batch(200 + k, k, 0.1, r=120)
    got = recursive.solve_recursive_least_squares(*_t(X, y, v), half_life, cov, mean).numpy()
    for g in range(G):
        want = oracles.recursive_least_squares(X[g], y[g], v[g], half_life, cov, mean)
        np.testing.assert_allclose(got[g], want, **CLASSIC_TOL)


def test_rls_discount_underflow_gives_no_nan():
    # half_life 0.5: the prior's discount underflows to 0 within ~2,200 valid rows
    X, y, v = _batch(7, 3, 0.05, r=2_600)
    got = recursive.solve_recursive_least_squares(*_t(X, y, v), 0.5, 10.0, None).numpy()
    assert np.isfinite(got).all()
    ff = recursive.forgetting_factor(0.5)
    assert ff ** int(v[0].sum()) == 0.0


def test_rls_wrapper_runs_the_plain_version_on_cpu_tensors(monkeypatch):
    monkeypatch.setattr(moving, "moving_kernel_launches", 0)
    X, y, v = _batch(8, 4, 0.1, r=60)
    Z = torch.as_tensor(np.concatenate([y[..., None], X], axis=-1))
    rows = torch.full((G,), 60, dtype=torch.int64)
    vt = torch.as_tensor(v)
    coefs = moving.recursive_least_squares(Z, vt, rows, 20.0, 10.0, 0.5)
    ref = recursive.solve_recursive_least_squares(*_t(X, y, v), 20.0, 10.0, 0.5)
    assert torch.equal(coefs, ref)
    preds = moving.recursive_least_squares(Z, vt, rows, 20.0, 10.0, 0.5, want="predictions")
    np.testing.assert_allclose(preds.numpy(), np.einsum("grk,grk->gr", X, ref.numpy()), rtol=1e-12)
    assert moving.moving_kernel_launches == 0


# --------------------------------------------------------------------------- #
# rolling OLS
# --------------------------------------------------------------------------- #
ROLLING_CASES = [
    # k, window, min_periods ("w": the window), alpha, positional, null share
    (2, 2, None, 0.0, True, 0.1),
    (2, 2, None, 0.1, False, 0.1),
    (2, 10, 2, 0.0, False, 0.0),
    (5, 10, None, 0.0, True, 0.1),
    (5, 10, 2, 0.1, False, 0.1),
    (5, 63, None, 0.0, False, 0.1),
    (5, 63, "w", 0.1, True, 0.0),
    (5, 252, None, 0.0, True, 0.1),
    (5, 252, 2, 0.0, False, 0.1),
    (9, 10, None, 0.1, True, 0.1),
    (9, 252, "w", 0.0, False, 0.0),
    (17, 63, None, 0.0, True, 0.1),
    (17, 252, None, 0.1, False, 0.1),
    (32, 63, None, 0.0, False, 0.1),
]


def _rolling_args(k, window, min_periods):
    mp = window if min_periods == "w" else min_periods
    return mp, rolling.default_min_periods(mp, k, window)


@pytest.mark.parametrize("k,window,min_periods,alpha,positional,null_share", ROLLING_CASES)
def test_rolling_matches_jax_classic(k, window, min_periods, alpha, positional, null_share):
    X, y, v = _batch(300 + k + window, k, null_share)
    mp, _ = _rolling_args(k, window, min_periods)
    got = rolling.solve_rolling_ols(*_t(X, y, v), window, mp, alpha, positional).numpy()
    want = np.asarray(jrolling.solve_rolling_ols(
        *_j(X, y, v), window=window, min_periods=mp, alpha=alpha, positional=positional,
    ))
    assert got.dtype == np.float64 and got.shape == (G, R, k)
    settled = (_window_counts(v, window, positional) >= k + 3) | (alpha > 0)
    _assert_paths(got, want, settled, CLASSIC_TOL)


@pytest.mark.parametrize("k,window,min_periods,alpha,positional,null_share", [
    (2, 10, None, 0.0, True, 0.1), (5, 10, None, 0.1, False, 0.1), (5, 63, 2, 0.0, True, 0.1),
    (5, 252, "w", 0.1, False, 0.0), (8, 252, None, 0.0, True, 0.1),
])
def test_rolling_matches_jax_lanes(k, window, min_periods, alpha, positional, null_share):
    X, y, v = _batch(400 + k + window, k, null_share)
    mp, _ = _rolling_args(k, window, min_periods)
    got = rolling.solve_rolling_ols(*_t(X, y, v), window, mp, alpha, positional).numpy()
    want = np.asarray(jmoving.solve_rolling_lanes(
        *_j(X, y, v), window=window, min_periods=mp, alpha=alpha, positional=positional,
    ))
    # the lane solvers' diffuse prior needs a window well past K rows
    settled = (_window_counts(v, window, positional) >= 3 * k) | (alpha > 0)
    _assert_paths(got, want, settled, LANES_TOL)


@pytest.mark.parametrize("k,window,min_periods,alpha,positional", [
    (2, 10, None, 0.0, True), (5, 10, None, 0.0, False), (5, 63, None, 0.1, True),
    (5, 63, 8, 0.0, False), (9, 63, None, 0.0, True), (9, 30, 12, 0.1, False),
])
def test_rolling_matches_the_window_oracles(k, window, min_periods, alpha, positional):
    X, y, v = _batch(500 + k + window, k, 0.1, r=150)
    got = rolling.solve_rolling_ols(*_t(X, y, v), window, min_periods, alpha, positional).numpy()
    counts = _window_counts(v, window, positional)
    for g in range(G):
        xn, yn = np.where(v[g, :, None], X[g], np.nan), np.where(v[g], y[g], np.nan)
        if positional:
            want = oracles.rolling_ols_drop_window(xn, yn, window, min_periods, alpha)
            # the oracle leaves rows that do not refresh NaN; the solver carries
            refreshed = ~np.isnan(want[:, 0])
            np.testing.assert_array_equal(np.isnan(got[g, :, 0]), np.cumsum(refreshed) == 0)
            m = refreshed & ((counts[g] >= k + 3) | (alpha > 0))
            np.testing.assert_allclose(got[g][m], want[m], **CLASSIC_TOL)
            last = np.maximum.accumulate(np.where(refreshed, np.arange(len(refreshed)), -1))
            carried = last >= 0
            np.testing.assert_array_equal(got[g][carried], got[g][last[carried]])
        else:
            want = oracles.rolling_ols_valid_window(xn, yn, window, min_periods, alpha)
            np.testing.assert_array_equal(np.isnan(got[g]), np.isnan(want))
            m = ~np.isnan(want[:, 0]) & ((counts[g] >= k + 3) | (alpha > 0))
            np.testing.assert_allclose(got[g][m], want[m], **CLASSIC_TOL)


@pytest.mark.parametrize("positional", [True, False])
def test_rolling_indices_on_a_hand_made_mask(positional):
    v = torch.tensor([[True, False, True, True, False, True, True]])
    leaving, refresh = rolling.rolling_indices(v, 2, 2, positional)
    assert leaving.dtype == torch.int32 and refresh.dtype == torch.bool
    if positional:
        # row t - 2 leaves where it is valid; a window of two rows with two valid ones refreshes
        assert leaving[0].tolist() == [-1, -1, 0, -1, 2, 3, -1]
        assert refresh[0].tolist() == [False, False, False, True, False, False, True]
    else:
        # valid ranks 1 . 2 3 . 4 5: at rank r > 2 the row of rank r - 2 leaves
        assert leaving[0].tolist() == [-1, -1, -1, 0, -1, 2, 3]
        assert refresh[0].tolist() == [False, False, True, True, False, True, True]
    assert rolling.last_refresh(refresh)[0].tolist() == (
        [-1, -1, -1, 3, 3, 3, 6] if positional else [-1, -1, 2, 3, 3, 5, 6]
    )


def test_singular_windows_take_the_minimum_norm_solution():
    # an all-zero feature: every window's Cholesky fails; no NaN, zero on the dead feature
    X, y, v = _batch(9, 3, 0.1, r=80)
    X[..., 1] = 0.0
    got = rolling.solve_rolling_ols(*_t(X, y, v), 20, None, 0.0, True).numpy()
    want = np.asarray(jrolling.solve_rolling_ols(
        *_j(X, y, v), window=20, min_periods=None, alpha=0.0, positional=True,
    ))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    settled = _window_counts(v, 20, True) >= 6
    assert (np.abs(got[..., 1][settled]) < 1e-12).all()
    np.testing.assert_allclose(got[settled], want[settled], **CLASSIC_TOL)


def test_rolling_wrapper_runs_the_plain_version_on_cpu_tensors(monkeypatch):
    monkeypatch.setattr(moving, "moving_kernel_launches", 0)
    X, y, v = _batch(10, 4, 0.1, r=60)
    Z = torch.as_tensor(np.concatenate([y[..., None], X], axis=-1))
    rows = torch.full((G,), 60, dtype=torch.int64)
    coefs = moving.rolling_ols(Z, torch.as_tensor(v), rows, 12, None, 0.0, False)
    ref = rolling.solve_rolling_ols(*_t(X, y, v), 12, None, 0.0, False)
    assert torch.equal(torch.isnan(coefs), torch.isnan(ref))
    assert torch.equal(torch.nan_to_num(coefs), torch.nan_to_num(ref))
    assert moving.moving_kernel_launches == 0


# --------------------------------------------------------------------------- #
# the planner of csrc/moving.cu: rows a range and the table of long groups
# --------------------------------------------------------------------------- #
RESIDENT = 132 * 12  # warps an H100 holds of the K = 5 walk (132 SMs x 12)


def _check_plan(plan, counts):
    """The plan's invariants: every long group's rows are cut into ranges of
    L rows, contiguous and in row order, once each; segments never cross a
    group and hold at most SEGMENT_RANGES ranges."""
    long_g = np.flatnonzero(counts > plan.L)
    assert plan.ranges.shape == (plan.M, 2)
    assert np.array_equal(np.flatnonzero(plan.range_off >= 0), long_g)
    for g in long_g:
        first = plan.range_off[g]
        n = -(-counts[g] // plan.L)
        assert (plan.ranges[first:first + n, 0] == g).all()
        assert np.array_equal(plan.ranges[first:first + n, 1], np.arange(n) * plan.L)
    assert plan.seg_first[0] == 0 and plan.seg_first[-1] == plan.M
    assert (np.diff(plan.seg_first) >= 1).all() and (np.diff(plan.seg_first) <= moving.SEGMENT_RANGES).all()
    assert len(plan.grp_seg) == len(long_g) + 1 and plan.grp_seg[-1] == len(plan.seg_first) - 1
    for j, g in enumerate(long_g):  # a group's segments cover exactly its ranges
        s0, s1 = plan.grp_seg[j], plan.grp_seg[j + 1]
        assert plan.seg_first[s0] == plan.range_off[g]
        assert plan.seg_first[s1] == plan.range_off[g] + -(-counts[g] // plan.L)
    longest = min(plan.L, int(counts.max())) if len(counts) else 0
    assert plan.nsmax == max(1, -(-longest // (moving.LANES * plan.T)))


@pytest.mark.parametrize("case,T,chunk,want_L,want_M", [
    # 10,000 groups of up to 960 rows (8,000,000 in all): one range a group
    ("main", 5, None, 1280, 0),
    ("main", 3, None, 1344, 0),
    # one series of 2,000,000 rows: 6,250 ranges of 320 rows, 196 segments
    ("series", 5, None, 320, 6250),
    # both at once: the series is cut, the 10,000 groups are not
    ("mix", 5, None, 1600, 1250),
    # a small frame: one stretch a range at least, so its two groups of
    # ~300 rows are cut in two; empty and one-row groups are one range each
    ("tiny", 5, None, 160, 4),
    # forced rows a range: every group longer than 7 rows is cut
    ("tiny", 5, 7, 7, 90),
])
def test_plan_ranges_from_the_sizes(case, T, chunk, want_L, want_M):
    rng = np.random.default_rng(0)
    counts = {
        "main": np.concatenate([np.full(9_999, 800), [8_000_000 - 9_999 * 800]]),
        "series": np.asarray([2_000_000]),
        "mix": np.concatenate([rng.integers(640, 961, 10_000), [2_000_000]]),
        "tiny": np.asarray([0, 1, 300, 287, 40]),
    }[case]
    if case == "main":
        assert counts.max() <= 960 and counts.sum() == 8_000_000
    plan = moving.plan_ranges(counts, T, RESIDENT, chunk)
    assert plan.L == want_L and plan.M == want_M and plan.T == T
    if chunk is None:  # a whole number of stretches, and WAVES waves of warps
        assert plan.L % (moving.LANES * T) == 0
        assert plan.L >= counts.sum() / (moving.WAVES * RESIDENT)
    _check_plan(plan, counts)
    if case == "series":
        assert len(plan.seg_first) - 1 == 196 and plan.nsmax == 2


@pytest.mark.parametrize("seed,chunk", [(1, None), (2, None), (3, 100), (4, 33)])
def test_plan_warp_table_of_a_skewed_mix(seed, chunk):
    # lognormal sizes with a few groups of many ranges and empty groups
    rng = np.random.default_rng(seed)
    counts = np.floor(rng.lognormal(5.0, 1.5, 3_000)).astype(np.int64)
    counts[rng.integers(0, 3_000, 50)] = 0
    plan = moving.plan_ranges(counts, 5, 256, chunk)
    assert plan.M > 0
    _check_plan(plan, counts)
    # the walk's items: every group of at most L rows, then the table; each
    # row of each group lies in exactly one item
    cover = np.zeros(int(counts.sum()), dtype=np.int64)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for g in np.flatnonzero(counts <= plan.L):
        cover[first[g]:first[g] + counts[g]] += 1
    for g, t0 in plan.ranges:
        cover[first[g] + t0:first[g] + min(t0 + plan.L, counts[g])] += 1
    assert (cover == 1).all()


def test_plan_refuses_a_range_of_no_rows():
    with pytest.raises(ValueError, match="chunk must be positive"):
        moving.plan_ranges(np.asarray([10]), 5, RESIDENT, 0)


@pytest.mark.parametrize("k,rolling,want", [(5, False, 5), (5, True, 3), (8, False, 5), (8, True, 2),
                                           (16, False, 1), (32, True, 1)])
def test_stretch_rows_scale_with_the_width(k, rolling, want):
    assert moving.stretch_rows(k, rolling) == want


# --------------------------------------------------------------------------- #
# the kernel's order of sums: lanes, the shuffle scan, stretches, ranges
# --------------------------------------------------------------------------- #
def _entries(z):
    """A row's state contribution [.., E - 1]: x_i x_j (j <= i, packed),
    then x_i y (the kernel's order of A and b)."""
    x, y = z[..., 1:], z[..., 0]
    i, j = np.tril_indices(x.shape[-1])
    return torch.cat([x[..., i] * x[..., j], x * y[..., None]], dim=-1)


def _compose(c, s):
    """c o s for s from a zero start: (disc_s body_c + body_s, disc_c disc_s)."""
    return torch.cat([s[..., -1:] * c[..., :-1] + s[..., :-1], c[..., -1:] * s[..., -1:]], dim=-1)


def _identity(n, E):
    e = torch.zeros((n, E), dtype=torch.float64)
    e[:, -1] = 1.0
    return e


def _lane_steps(S, Z, v, leaving, ff, rows, record=None):
    """Every lane advances its state S [32, E] over its rows [32, T] of a
    stretch (rows < 0: past the range), as csrc/moving.cu:advance does."""
    for r in range(rows.shape[1]):
        t = rows[:, r]
        on = t >= 0
        tt = torch.as_tensor(np.where(on, t, 0))
        valid = torch.as_tensor(on & v[np.where(on, t, 0)])
        lam = torch.where(valid, torch.tensor(ff, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64))
        body = torch.where(valid[:, None], S[:, :-1] * lam[:, None] + _entries(Z[tt]), S[:, :-1])
        if leaving is not None:
            s = leaving[np.where(on, t, 0)]
            gone = torch.as_tensor(on & (s >= 0))
            body = torch.where(gone[:, None], body - _entries(Z[torch.as_tensor(np.maximum(s, 0))]), body)
        S = torch.cat([body, (S[:, -1] * lam)[:, None]], dim=1)
        if record is not None:
            record[t[on]] = S[torch.as_tensor(on)]
    return S


def _scan(S, k):
    """The inclusive scan over the 32 lanes: Hillis-Steele in 5 steps for
    K <= 8; for K > 8 the lanes composed in turn (the kernel's shared-memory
    scan), the discounts as one product in lane order."""
    if k > 8:
        run, out = _identity(1, S.shape[1])[0], []
        for j in range(32):
            run = torch.cat([S[j, -1] * run[:-1] + S[j, :-1], (run[-1] * S[j, -1])[None]])
            out.append(run)
        return torch.stack(out)
    lane = torch.arange(32)
    for o in (1, 2, 4, 8, 16):
        prev = torch.cat([_identity(o, S.shape[1]), S[:-o]])
        S = torch.where((lane >= o)[:, None], _compose(prev, S), S)
    return S


def _range_pass(Z, v, leaving, ff, t0, n, T, carry, record=None):
    """One warp over rows [t0, t0 + n) from the state carry [E]: per
    stretch, the lanes' summaries, the scan, each lane's start state and
    (with record) its walk; returns the carry after the range (lane 31's
    walked end state, or without record the carry composed with the
    scan's total, as the summary pass forms it)."""
    E = carry.shape[0]
    for a in range(t0, t0 + n, 32 * T):
        rows = np.arange(a, a + 32 * T).reshape(32, T)
        rows = np.where(rows < t0 + n, rows, -1)
        incl = _scan(_lane_steps(_identity(32, E), Z, v, leaving, ff, rows), Z.shape[1] - 1)
        if record is None:
            carry = _compose(carry, incl[31])
            continue
        ex = torch.cat([_identity(1, E), incl[:-1]])
        start = _compose(carry[None], ex)
        carry = _lane_steps(start, Z, v, leaving, ff, rows, record)[31]
    return carry


def _kernel_order_states(Z, v, leaving, ff, T, L):
    """The state after every row of one group [n, E], composed in the
    kernel's order: a group of at most L rows walked by one warp; a longer
    one cut into ranges of L rows whose summaries go through the segmented
    prefix (compose each segment, scan the segments, expand)."""
    n, E = Z.shape[0], _entries(Z[:1]).shape[1] + 1
    out = torch.zeros((n, E), dtype=torch.float64)
    if n <= L:
        _range_pass(Z, v, leaving, ff, 0, n, T, _identity(1, E)[0], out)
        return out
    starts = list(range(0, n, L))
    summ = [_range_pass(Z, v, leaving, ff, t0, min(L, n - t0), T, _identity(1, E)[0]) for t0 in starts]
    seg = moving.SEGMENT_RANGES
    segs = [summ[i:i + seg] for i in range(0, len(summ), seg)]
    tot = []
    for sg in segs:
        run = _identity(1, E)[0]
        for s in sg:
            run = _compose(run, s)
        tot.append(run)
    run, seeds = _identity(1, E)[0], []
    for sg, t in zip(segs, tot):
        r = run
        for s in sg:
            seeds.append(r)
            r = _compose(r, s)
        run = _compose(run, t)
    for t0, seed in zip(starts, seeds):
        _range_pass(Z, v, leaving, ff, t0, min(L, n - t0), T, seed, out)
    return out


def _packed(M, b, disc):
    k = M.shape[-1]
    i, j = np.tril_indices(k)
    return torch.cat([M[..., i, j], b, disc[..., None]], dim=-1)


def _assert_states(got, want):
    # the sums differ in order only: rtol 1e-12, atol 1e-12 of the largest entry
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("half_life,null_share,T,L,r,k", [
    (20.0, 0.1, 5, 10_000, 700, 3),  # one warp, several stretches
    (252.0, 0.0, 3, 10_000, 500, 3),
    (None, 0.1, 4, 10_000, 400, 3),  # no forgetting: the expanding window
    (20.0, 0.1, 5, 64, 700, 3),  # ranges of 64 rows
    (252.0, 0.1, 3, 16, 700, 3),  # 44 ranges: the prefix in two segments
    (0.5, 0.05, 5, 1_000, 2_600, 3),  # the discount underflows to 0
    (20.0, 0.1, 2, 10_000, 400, 9),  # K > 8: the lanes composed in turn
    (252.0, 0.1, 2, 48, 400, 9),
])
def test_scan_order_equals_the_plain_recursion(half_life, null_share, T, L, r, k):
    X, y, v = _batch(600 + r, k, null_share, r=r)
    ff = recursive.forgetting_factor(half_life)
    M, b, disc = recursive.discounted_states(*_t(X, y, v), ff)
    for g in range(G):
        Z = torch.as_tensor(np.concatenate([y[g, :, None], X[g]], axis=1))
        got = _kernel_order_states(Z, v[g], None, ff, T, L)
        _assert_states(got, _packed(M[g], b[g], disc[g]))
    if half_life == 0.5:
        assert float(got[-1, -1]) == 0.0 and float(disc[-1, -1]) == 0.0
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("window,positional,null_share,T,L,k", [
    (10, True, 0.1, 3, 10_000, 3),  # leaving rows inside the stretch
    (63, True, 0.0, 5, 10_000, 3),
    (252, True, 0.1, 3, 100, 3),  # ranges of 100 rows
    (40, False, 0.3, 3, 10_000, 3),  # a window over valid rows: a longer leaving span
    (40, False, 0.3, 4, 16, 3),  # and 44 ranges
    (63, True, 0.1, 2, 10_000, 9),  # K > 8: the lanes composed in turn
])
def test_scan_order_equals_the_window_sums(window, positional, null_share, T, L, k):
    X, y, v = _batch(700 + window, k, null_share, r=700)
    Xv, yv, vv = _t(np.where(v[..., None], X, 0.0), np.where(v, y, 0.0), v)
    leaving, _ = rolling.rolling_indices(vv, window, k, positional)
    W, b = rolling.window_states(Xv, yv, vv, leaving)
    ones = torch.ones(W.shape[:2], dtype=torch.float64)
    for g in range(G):
        Z = torch.cat([yv[g, :, None], Xv[g]], dim=1)
        got = _kernel_order_states(Z, v[g], leaving[g].numpy(), 1.0, T, L)
        _assert_states(got, _packed(W[g], b[g], ones[g]))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    Z = torch.zeros((2, 5, 3), dtype=torch.float64)
    v = torch.ones((2, 5), dtype=torch.bool)
    rows = torch.full((2,), 5, dtype=torch.int64)
    with pytest.raises(TypeError, match="float64"):
        moving.recursive_least_squares(Z.float(), v, rows, None)
    with pytest.raises(TypeError, match="bool"):
        moving.rolling_ols(Z, v.to(torch.uint8), rows, 3)
    with pytest.raises(ValueError, match="contiguous"):
        moving.recursive_least_squares(Z.transpose(0, 1).contiguous().transpose(0, 1), v, rows, None)
    with pytest.raises(ValueError, match="want"):
        moving.rolling_ols(Z, v, rows, 3, want="residuals")
    # K = 33, where the JAX engine leaves the exact moments, is taken too:
    # the wrapper matches the JAX engine's classic path at the Kalman
    # oracle's tolerance (tests/test_largek_moving.py:48)
    rng = np.random.default_rng(33)
    X = rng.normal(size=(1, 120, 33))
    y = X.sum(-1) + rng.normal(size=(1, 120)) * 0.1
    v33 = rng.random((1, 120)) > 0.1
    Z33 = torch.as_tensor(np.concatenate([y[..., None], X], axis=-1))
    got = moving.recursive_least_squares(Z33, torch.as_tensor(v33), torch.as_tensor([120]), 30.0)
    want = jrecursive.solve_recursive_least_squares(jnp.asarray(X), jnp.asarray(y), jnp.asarray(v33), 30.0, 10.0, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-10)
