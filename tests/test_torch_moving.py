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


@pytest.mark.parametrize("n_rows,want", [
    (9_600_000, 32),  # 10,000 groups padded to 960 rows on 132 SMs
    (2_000_000, 32),  # one series is cut as finely: never below the minimum
    (80_000_000, 256),
    (100, 32),
])
def test_chunk_rows_from_the_sizes(n_rows, want):
    assert moving.chunk_rows(n_rows, 132) == want


@pytest.mark.parametrize("n_chunks,want", [(1, 1), (8, 1), (64, 1), (65, 8), (3_907, 64), (62_500, 256)])
def test_prefix_segments_from_the_chunks(n_chunks, want):
    assert moving.prefix_segments(n_chunks) == want
    assert 1 <= moving.prefix_segments(n_chunks) <= n_chunks


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
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        moving.recursive_least_squares(torch.zeros((1, 4, 34), dtype=torch.float64), v[:1, :4], rows[:1], None)
