"""The host side of the moving kernel's shared form (ops/moving.py), and
the order of its sums, in plain Python.

A walker of w warps walks a range in stretches of w runs of 32 T rows
(``stretch_runs``); the planner counts its ranges in those stretches
(``plan_ranges`` at ``T x w``, ``plan_unit``), and the flagged rows find
their stretch's start state by the same count. Each run but the last
forms its summary from a zero start, the summaries are composed onto the
carry in warp order (A = disc_s A + S_A, disc = disc_c disc_s) and every
run walks from the result: these tests hold that arithmetic, emulated
literally in numpy, to the sequential recursion the plain versions
(``ops/recursive.py``, ``ops/rolling.py``) define.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from polars_ols_tpu_torch.ops import moving  # noqa: E402

WALKERS = 132  # one walker an SM


@pytest.mark.parametrize("n,warps,T", [(128, 4, 1), (127, 4, 1), (33, 4, 1), (1, 4, 1), (64, 2, 1),
                                       (96, 3, 1), (20, 1, 1), (32, 1, 1), (192, 2, 3)])
def test_stretch_runs_cover_every_row_once_in_order(n, warps, T):
    runs = moving.stretch_runs(n, warps, T)
    assert len(runs) <= warps and runs[0][0] == 0
    assert all(rows >= 1 for _, rows in runs)
    assert all(a + r == b for (a, r), (b, _) in zip(runs, runs[1:]))
    assert runs[-1][0] + runs[-1][1] == n
    if warps > 1:
        assert all(rows == moving.LANES * T for _, rows in runs[:-1])


def _check_cover(plan, counts):
    """Each row of each group in exactly one item (a group of at most L
    rows, or a range of the table), ranges in row order."""
    cover = np.zeros(int(counts.sum()), dtype=np.int64)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for g in np.flatnonzero(counts <= plan.L):
        cover[first[g]:first[g] + counts[g]] += 1
    for g, t0 in plan.ranges:
        cover[first[g] + t0:first[g] + min(t0 + plan.L, counts[g])] += 1
    assert (cover == 1).all()
    for g in np.unique(plan.ranges[:, 0]):
        starts = plan.ranges[plan.ranges[:, 0] == g, 1]
        assert np.array_equal(starts, np.arange(len(starts)) * plan.L)


@pytest.mark.parametrize("warps", [1, 2, 3, 4])
@pytest.mark.parametrize("chunk", [None, 33, 2])
def test_shared_plan_covers_every_row_once(warps, chunk):
    rng = np.random.default_rng(warps)
    counts = np.floor(rng.lognormal(5.0, 1.5, 2_000)).astype(np.int64)
    counts[rng.integers(0, 2_000, 30)] = 0
    plan = moving.plan_ranges(counts, warps, WALKERS, chunk, moving.SHARED_WAVES)
    stretch = moving.LANES * warps
    if chunk is None:
        assert plan.L % stretch == 0 and plan.L >= counts.sum() / (moving.SHARED_WAVES * WALKERS)
    assert plan.nsmax == max(1, -(-min(plan.L, int(counts.max())) // stretch))
    _check_cover(plan, counts)


@pytest.mark.parametrize("per_sm", [1, 2])
def test_grouped_largek_is_one_range_a_group(per_sm):
    # 1,000 groups of ~500 rows: at four warps a walker (stretches of 128
    # rows) and one or two walkers an SM, SHARED_WAVES waves of ranges
    # round up past the longest group, so no group pays the summary pass,
    # the prefix and the fill
    rng = np.random.default_rng(0)
    counts = np.bincount(rng.integers(1_000, size=500_000), minlength=1_000).astype(np.int64)
    plan = moving.plan_ranges(counts, 4, WALKERS * per_sm, None, moving.plan_waves(40))
    assert plan.M == 0 and plan.L >= counts.max()


def test_large_is_cut_into_ranges_for_every_walker():
    # one group of 10,000 rows at one warp a walker (K = 100): ranges of
    # two stretches, more ranges than walkers
    plan = moving.plan_ranges(np.asarray([10_000]), 1, WALKERS, None, moving.plan_waves(100))
    assert plan.L == 64 and plan.M > WALKERS


@pytest.mark.parametrize("warps,chunk", [(4, None), (2, 64), (1, 40)])
def test_a_flagged_row_finds_its_stretch_start(warps, chunk):
    # ops/moving.py:_resolve_flagged: the stretch of row t of a range that
    # starts at t0 is (t - t0) // (32 plan.T), its first row t0 + that x 32 plan.T
    counts = np.asarray([700, 33, 1, 0, 260])
    plan = moving.plan_ranges(counts, warps, 8, chunk)
    stretch = moving.LANES * plan.T
    for g, n in enumerate(counts):
        for t in range(n):
            t0 = (t // plan.L) * plan.L if n > plan.L else 0
            st = (t - t0) // stretch
            fa = t0 + st * stretch
            assert 0 <= st < plan.nsmax and fa <= t < fa + stretch and fa >= t0


def _step(A, b, disc, z, valid, gone, ff):
    """One row of the recursion on the packed-free state (A [K, K], b [K])."""
    if valid:
        A, b, disc = A * ff, b * ff, disc * ff
        x, y = z[1:], z[0]
        A, b = A + np.outer(x, x), b + x * y
    if gone is not None:
        A, b = A - np.outer(gone[1:], gone[1:]), b - gone[1:] * gone[0]
    return A, b, disc


@pytest.mark.parametrize("rolling", [False, True])
@pytest.mark.parametrize("n,warps", [(128, 4), (100, 4), (64, 2), (40, 4)])
def test_runs_composed_in_warp_order_give_the_sequential_states(rolling, n, warps):
    rng = np.random.default_rng(n + warps)
    K, window = 5, 17
    Z = rng.normal(size=(n + window, 1 + K))
    v = rng.random(n + window) > 0.1
    ff = 1.0 if rolling else 0.97
    # the carry: the state after the rows before the stretch
    A0, b0, d0 = np.eye(K) * 0.3, rng.normal(size=K), 0.8
    pre = window
    gone = [Z[t - window] if rolling and t >= window else None for t in range(n + window)]
    seq = [(A0, b0, d0)]
    for t in range(pre, pre + n):
        seq.append(_step(*seq[-1], Z[t], v[t], gone[t], ff))
    runs = moving.stretch_runs(n, warps, 1)
    summ = []
    for lo, rows in runs[:-1]:
        S = (np.zeros((K, K)), np.zeros(K), 1.0)
        for t in range(pre + lo, pre + lo + rows):
            S = _step(*S, Z[t], v[t], gone[t], ff)
        summ.append(S)
    acc = (A0, b0, d0)
    starts = [acc]
    for SA, Sb, Sd in summ:  # in warp order, onto the carry: A = disc_s A + S_A
        acc = (Sd * acc[0] + SA, Sd * acc[1] + Sb, acc[2] * Sd)
        starts.append(acc)
    for (lo, _), (A, b, d) in zip(runs, starts):
        A_s, b_s, d_s = seq[lo]
        np.testing.assert_allclose(A, A_s, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(b, b_s, rtol=1e-12, atol=1e-12)
        assert d == pytest.approx(d_s, rel=1e-14)
