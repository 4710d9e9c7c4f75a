"""The frozen roofline counts against hand counts."""

import numpy as np
import pytest

from portbench import peaks
from portbench.rooflines import householder_wide, moments, moving


def test_peaks_are_the_h100_sxm_data_sheet():
    assert (peaks.BYTES_PER_S, peaks.F64_TENSOR_PER_S, peaks.F64_PER_S) == (3.35e12, 67e12, 34e12)
    assert peaks.bound_s(3.35e12, 1.0, 1.0) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 68e12, 34e12) == pytest.approx(2.0)


def test_moments_stage():
    # 1,000 rows, 10 groups, C = 6: rows 49 bytes, offsets 88, moments 2,880, counts 80
    # (52,048 bytes); 42 operations a row (42,000) at the tensor rate
    assert moments.stage_bound_s(1_000, 10, 6) == pytest.approx(max(52_048 / 3.35e12, 42_000 / 67e12))
    counts = np.array([100] * 10)
    cfg = {"features": 5}
    one = moments.stage_bound_s(1_000, 10, 6)
    sweep = [{"fit": "ols", "target": "y"}] + [
        {"fit": "ridge", "target": "y", "kwargs": {"alpha": a}} for a in (0.1, 1.0)
    ]
    assert moments.select_bound_s(sweep, cfg, counts) == pytest.approx(one)  # one partition, moments once
    assert moments.select_bound_s(sweep + [{"fit": "ols", "target": "y2"}], cfg, counts) == pytest.approx(2 * one)
    svd = [{"fit": "ols", "target": "y", "kwargs": {"solve_method": "svd"}}, {"fit": "rls", "target": "y"}]
    assert moments.select_bound_s(svd, cfg, counts) == 0.0


def test_moving_counts():
    counts = np.array([5, 3, 0])
    # K = 2: a row 8 (1 + K) + 1 + 8 = 33 bytes, + 8 a group (two groups): 280 bytes; an entering
    # row 18 operations, a solved row 12, a discounted row 6, a prediction 4: 8 (18 + 12 + 6 + 4)
    rls = {"fit": "rls", "target": "y", "kwargs": {"half_life": 252.0}}
    assert moving.fit_bound_s(rls, 2, counts) == pytest.approx(max(280 / 3.35e12, 320 / 34e12))
    # rolling(4), min_periods 2: 6 solved rows, 1 leaving; 38 bytes a row (+ 16): 320 bytes;
    # (8 + 1) 18 + 6 x 12 + 8 x 4 = 266 operations
    rolling = {"fit": "rolling_ols", "target": "y", "kwargs": {"window_size": 4}}
    assert moving.fit_bound_s(rolling, 2, counts) == pytest.approx(max(320 / 3.35e12, 266 / 34e12))
    both = moving.select_bound_s([rls, {"fit": "ols", "target": "y"}], {"features": 2}, counts)
    assert both == pytest.approx(moving.fit_bound_s(rls, 2, counts))


def test_householder_wide_counts():
    counts = np.array([600, 400])
    cfg = {"features": 40}
    # C = 41: 1,000 rows x 329 bytes + 2 factors x 40 x 41 x 8 bytes; 4 x 1,000 x (41 + ... + 2)
    ols_svd = {"fit": "ols", "target": "y", "kwargs": {"solve_method": "svd"}}
    assert householder_wide.select_bound_s([ols_svd], cfg, counts) == pytest.approx(
        max(355_240 / 3.35e12, 4 * 1_000 * 860 / 67e12))
    multi = {"fit": "multi_target_ols", "target": ["y", "y2"]}
    assert householder_wide.select_bound_s([multi], cfg, counts) == pytest.approx(
        max((1_000 * 337 + 8 * 2 * 40 * 42) / 3.35e12, 4 * 1_000 * 900 / 67e12))
    narrow = {"fit": "ols", "target": "y", "kwargs": {"solve_method": "svd"}}
    assert householder_wide.select_bound_s([narrow], {"features": 5}, counts) == 0.0  # the register form's
    assert householder_wide.select_bound_s([{"fit": "ols", "target": "y"}], cfg, counts) == 0.0
