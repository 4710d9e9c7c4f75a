"""The arithmetic of ``chip_smoke.py`` that runs on the host: the kernels'
bounds, the replica of the p-value kernel's loop that counts its
operations, and the parsing of nvcc's register report.

The card-side phases of the script need a GPU (``python3 chip_smoke.py``
on one H100); these helpers do not, and each number the script writes into
its kernels line passes through them.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs
import oracles  # tests/oracles.py  # noqa: E402


OP_MS = {"fma": 4e-6, "div": 30e-6, "sqrt": 30e-6, "log": 80e-6, "log1p": 90e-6, "exp": 60e-6, "erfc": 120e-6,
         "rcp": 10e-6, "rsqrt": 12e-6}


@pytest.mark.parametrize(
    "moved,ops,rate,by",
    [(3.35e9, 1.0, cs.PEAK_F64_PER_S, "bytes"), (1.0, 34e9, cs.PEAK_F64_PER_S, "operations")],
)
def test_bound_is_the_larger_of_bytes_and_operations(moved, ops, rate, by):
    b = cs._bound(moved, ops, rate)
    assert b["bound_by"] == by
    assert b["bound_ms"] == pytest.approx(1.0)


def test_moment_bound_counts_each_byte_once():
    S, R, C, G = 20, 512, 6, 10
    Zp = torch.zeros((S, R, C), dtype=torch.float64)
    wp = torch.ones((S, R), dtype=torch.bool)
    wp[0, :12] = False
    b = cs._moment_bound(Zp, wp, G)
    moved = S * R * (8 * C + 1) + 8 * (G + 1) + 8 * G * C * C + 8 * G
    assert b == {"bound_ms": moved / 3.35e12 * 1e3, "bound_by": "bytes"}


@pytest.mark.parametrize("S,C,by", [(20, 101, "bytes"), (1_280, 41, "bytes"), (20, 301, "operations")])
def test_moment_bound_takes_the_tensor_cores_f64_rate(S, C, by):
    # a block's moments are a product of matrices, which the tensor cores
    # run at 67 TFLOP/s in f64: at that rate the "large" (C = 101) and
    # "grouped_largek" (C = 41) blocks are bound by their bytes, and only
    # blocks past ~160 columns by their operations
    R, G = 512, max(1, S // 2)
    Zp = torch.zeros((1, 1, C), dtype=torch.float64).expand(S, R, C)
    wp = torch.ones((1, 1), dtype=torch.bool).expand(S, R)
    b = cs._moment_bound(Zp, wp, G)
    ops_ms = S * R * C * (C + 1) / 67e12 * 1e3
    moved = S * R * (8 * C + 1) + 8 * (G + 1) + 8 * G * C * C + 8 * G
    assert b["bound_by"] == by
    assert b["bound_ms"] == pytest.approx(max(ops_ms, moved / 3.35e12 * 1e3))


def test_moment_bound_at_the_main_paths_shape():
    """S = 20,000 blocks of R = 512 rows, C = 6, G = 10,000: 0.151 ms."""
    moved = 20_000 * 512 * 49 + 8 * 10_001 + 8 * 10_000 * 36 + 8 * 10_000
    assert moved / cs.PEAK_BYTES_PER_S * 1e3 == pytest.approx(0.1507, abs=1e-4)


def test_cd_bound_counts_the_sweeps_taken():
    sweeps = np.array([3, 4, 5, 1])
    b = cs._cd_bound(4, 5, sweeps, OP_MS)
    assert b["bound_by"] == "bytes"
    moved = 8 * (4 * 25 + 4 * 5 + 4) + 8 * 4 * 5 + 4 * 4
    assert b["bound_ms"] == moved / 3.35e12 * 1e3
    # many sweeps of wide groups: the operations bound it
    heavy = cs._cd_bound(1, 32, np.array([10**6]), OP_MS)
    assert heavy["bound_by"] == "operations"
    assert heavy["bound_ms"] == 10**6 * 32 * (2 * 32 + 9) / 34e12 * 1e3


def test_cd_step_path_counts_one_coordinate_by_hand():
    # the product and its add into the row's sum, rho's subtract and add,
    # |rho| - a_l1, the clamp and the sign's multiply, then the division
    assert cs._cd_step_path() == {"fma": 2 + 2 + 3, "div": 1}
    # the stop test: the difference, its square, one add, the root, the compare
    assert cs._cd_test_path() == {"fma": 4, "sqrt": 1}


@pytest.mark.parametrize("K,sweeps,fma,div,sqrt", [
    (5, [3, 4, 5, 1], 5 * (5 * 7 + 4), 5 * 5, 5),  # the main path's lasso: at most 5 sweeps
    (1, [2], 2 * (7 + 4), 2, 2),
    (32, [10, 2], 10 * (32 * 7 + 4), 10 * 32, 10),
    (5, [0, 0], 0, 0, 0),  # no group swept: no chain
])
def test_cd_chain_counts_the_longest_path_by_hand(K, sweeps, fma, div, sqrt):
    # the group with the most sweeps sets the chain: K dependent coordinate
    # steps and the stop test a sweep
    b = cs._cd_bound(len(sweeps), K, np.asarray(sweeps), OP_MS)
    assert b["longest_path"] == {"fma": fma, "div": div, "sqrt": sqrt}
    assert b["sweeps_max"] == max(sweeps)
    assert b["latency_bound_ms"] == pytest.approx(fma * OP_MS["fma"] + div * OP_MS["div"] + sqrt * OP_MS["sqrt"])


def _cf_scalar(p, q, z):
    """csrc/t_pvalue.cu:continued_fraction, one element, counting iterations."""
    eps, big = 2.0 ** -52, 2.0 ** 200
    qab, qap, qam = p + q, p + 1.0, p - 1.0
    am, bm, az, bz = 1.0, 1.0, 1.0, 1.0 - qab * z / qap
    for m in range(1, 201):
        m2 = 2.0 * m
        aa = (m * (q - m)) / ((qam + m2) * (p + m2)) * z
        ap, bp = az + aa * am, bz + aa * bm
        aa = -((p + m) * (qab + m)) / ((p + m2) * (qap + m2)) * z
        app, bpp = ap + aa * az, bp + aa * bz
        scale = 1.0 / big if abs(bpp) > big else (big if abs(bpp) < 1.0 / big else 1.0)
        am, bm, az, bz = ap * scale, bp * scale, app * scale, bpp * scale
        if abs(app * bp - ap * bpp) <= eps * abs(ap * bpp):
            return m
    return 200


def test_lentz_replica_counts_the_kernels_iterations():
    # (the continued fraction is the convergents' forward recurrence now;
    # the replica follows it)
    rng = np.random.default_rng(0)
    p = np.concatenate([np.exp(rng.uniform(-1, 6, 40)), [0.5, 0.5, 400.0]])
    q = np.concatenate([np.full(40, 0.5), [3.0, 400.0, 0.5]])
    z = np.concatenate([rng.uniform(0, 0.9, 40), [0.2, 0.3, 1e-3]])
    got = cs._cf_iterations(p, q, z)
    want = [_cf_scalar(*args) for args in zip(p, q, z)]
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 1 and got.max() > 5


def test_pvalue_bound_reads_t_and_dof_once():
    t = torch.as_tensor(np.random.default_rng(1).normal(size=(100, 5)) * 280.0)
    dof = torch.full((100,), 795.0, dtype=torch.float64)
    b = cs._pvalue_bound(t, dof, OP_MS)
    assert b["bound_by"] in ("bytes", "operations")
    assert b["bound_ms"] >= 8 * (2 * 500 + 100) / 3.35e12 * 1e3
    assert b["latency_bound_ms"] == cs._path_ms(b["longest_path"], OP_MS) > 0
    # edge rows (t = 0, dof <= 0, NaN) count no loop and no chain
    edges = cs._pvalue_bound(torch.zeros((3, 5), dtype=torch.float64),
                             torch.tensor([0.0, -1.0, math.nan], dtype=torch.float64), OP_MS)
    assert edges == {"bound_ms": 8 * (2 * 15 + 3) / 3.35e12 * 1e3, "bound_by": "bytes",
                     "latency_bound_ms": 0, "longest_path": {}}


def test_pvalue_chain_counts_the_longest_path_by_hand():
    # continued fraction, 3 iterations: three strands through the front
    # factor, one through the recurrence
    through_log, through_log1p, through_ratio, recurrence = cs._pvalue_paths(3, 0)
    assert through_log == {"fma": 7, "div": 1, "log": 1, "exp": 1}
    assert through_log1p == {"fma": 7, "div": 1, "log1p": 1, "exp": 1}
    assert through_ratio == {"fma": 5, "div": 1, "log1p": 1, "exp": 1}
    assert recurrence == {"fma": 2 + 2 + 18 + 1, "div": 3}
    assert cs._path_ms(through_log1p, OP_MS) == 7 * 4e-6 + 30e-6 + 90e-6 + 60e-6
    # six more multiply-adds an iteration
    assert cs._pvalue_paths(25, 0)[3]["fma"] - cs._pvalue_paths(24, 0)[3]["fma"] == 6
    # series, 15 terms: x (two and a division), log, z, sqrt, erfc, three a
    # term, the last multiply
    assert cs._pvalue_paths(None, 15) == [{"fma": 2 + 1 + 45 + 1, "div": 1, "log": 1, "sqrt": 1, "erfc": 1}]


@pytest.mark.parametrize("half_life,mean0,cov", [(None, None, 10.0), (20.0, 0.5, 10.0), (252.0, [1.0, -1.0, 0.5], 3.0)])
def test_kalman_helper_matches_the_oracle(half_life, mean0, cov):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(80, 3))
    y = X @ np.array([1.0, -2.0, 0.5]) + rng.normal(size=80) * 0.1
    v = rng.random(80) > 0.15
    v[:3] = False
    ff = np.exp(np.log(0.5) / half_life) if half_life else 1.0
    got = cs._kalman_numpy(X, y, v, ff, cov, mean0)
    want = oracles.recursive_least_squares(X, y, v, half_life, cov, mean0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("positional", [True, False])
@pytest.mark.parametrize("window,min_periods", [(10, 3), (25, 8)])
def test_window_helper_matches_the_oracles(window, min_periods, positional):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(90, 3))
    y = X @ np.array([1.0, -2.0, 0.5]) + rng.normal(size=90) * 0.1
    v = rng.random(90) > 0.15
    got, counts = cs._window_numpy(X, y, v, window, min_periods, positional)
    xn, yn = np.where(v[:, None], X, np.nan), np.where(v, y, np.nan)
    if positional:
        want = oracles.rolling_ols_drop_window(xn, yn, window, min_periods)
        solved = ~np.isnan(want[:, 0])  # the oracle does not carry
        np.testing.assert_allclose(got[solved], want[solved], rtol=1e-8, atol=1e-10)
        last = np.maximum.accumulate(np.where(solved, np.arange(90), -1))
        np.testing.assert_array_equal(np.isnan(got[:, 0]), last < 0)
        np.testing.assert_array_equal(got[last >= 0], got[last[last >= 0]])
        np.testing.assert_array_equal(counts >= min_periods, solved)
    else:
        want = oracles.rolling_ols_valid_window(xn, yn, window, min_periods)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        m = ~np.isnan(want[:, 0])
        np.testing.assert_allclose(got[m], want[m], rtol=1e-8, atol=1e-10)
        np.testing.assert_array_equal(counts, np.minimum(np.cumsum(v), window))
    # a sparse selection of rows gives those rows the same coefficients
    tail = np.arange(80, 90)
    sparse, _ = cs._window_numpy(X, y, v, window, min_periods, positional, rows=tail)
    keep = tail[v[tail]] if not positional else tail[counts[tail] >= min_periods]
    np.testing.assert_array_equal(sparse[keep], got[keep])


def test_moving_bound_counts_bytes_and_operations_by_hand():
    # 1,000 rows in 10 groups, K = 2, every row valid and solved, predictions
    b = cs._moving_bound(1_000, 1_000, 1_000, 0, 2, False, True, False, 10)
    moved = 1_000 * (8 * 3 + 1 + 8) + 8 * 10
    ops = 1_000 * 10 + 1_000 * (8 / 3 + 8 + 4) + 1_000 * 6 + 2 * 2 * 1_000
    assert b == {"bound_ms": moved / 3.35e12 * 1e3, "bound_by": "bytes"}
    assert ops / 34e12 < moved / 3.35e12
    # rolling reads the leaving index and the refresh mask too, and updates twice
    r = cs._moving_bound(1_000, 1_000, 900, 800, 2, True, False, True, 10)
    assert r["bound_ms"] == (1_000 * (8 * 3 + 1 + 5 + 16) + 80) / 3.35e12 * 1e3
    # wide systems are bound by their Cholesky
    wide = cs._moving_bound(1_000, 1_000, 1_000, 0, 32, False, False, True, 1)
    assert wide["bound_by"] == "operations"
    assert wide["bound_ms"] == (1_000 * 32 * 35 + 1_000 * (32 ** 3 / 3 + 2 * 32 * 32 + 64)) / 34e12 * 1e3
    # without a fresh factorisation: a rank-one factor update a row change
    # and the two triangular solves a solved row
    upd = cs._moving_bound(1_000, 1_000, 1_000, 0, 32, False, False, True, 1, fresh=False)
    assert upd["bound_ms"] == max(
        (1_000 * (8 * 33 + 1 + 8 * 32) + 8) / 3.35e12, (1_000 * (32 * 35 + 2 * 32 * 32) + 1_000 * (2 * 32 * 32 + 64)) / 34e12
    ) * 1e3


def test_window_counts_and_closed_form():
    v = np.array([[True, False, True, True, False, True]])
    np.testing.assert_array_equal(cs._window_counts(v, 2, True), [[1, 1, 1, 2, 1, 1]])
    np.testing.assert_array_equal(cs._window_counts(v, 2, False), [[1, 1, 2, 2, 2, 2]])
    rng = np.random.default_rng(4)
    X, y = rng.normal(size=(60, 3)), rng.normal(size=60)
    vv = rng.random(60) > 0.2
    ff = 0.97
    kal = cs._kalman_numpy(X, y, vv, ff, 10.0)
    for t in (5, 30, 59):
        np.testing.assert_allclose(cs._closed_form_discounted(X, y, vv, ff, 10.0, t), kal[t], rtol=1e-9, atol=1e-12)


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__ec83ac90_10_moments_cu_df15711613block_momentsINS_8TileSumsILi9ELi5EEEEEvPKdPKhlliiiiiPd' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__ec83ac90_10_moments_cu_df15711613block_momentsINS_8TileSumsILi9ELi5EEEEEvPKdPKhlliiiiiPd
    72 bytes stack frame, 68 bytes spill stores, 92 bytes spill loads
ptxas info    : Used 168 registers, used 0 barriers, 72 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__ec83ac90_10_moments_cu_df15711613block_momentsINS_7RowSumsILi6EEEEEvPKdPKhlliiiiiPd' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__ec83ac90_10_moments_cu_df15711613block_momentsINS_7RowSumsILi6EEEEEvPKdPKhlliiiiiPd
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 112 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__ec83ac90_10_moments_cu_df15711610group_sumsEPKdPKlliiPdS4_' for 'sm_90a'
ptxas info    : Used 31 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__ba5b3885_5_cd_cu_9872a4ea6cd_covILi8EEEvPKdS2_S2_lidddidiiPdPi' for 'sm_90a'
ptxas info    : Used 59 registers, used 0 barriers, 1024 bytes smem
"""


def test_ptxas_report_names_each_kernel_with_its_registers():
    got = cs._ptxas(PTXAS)
    assert [e for e, _, _ in got] == [
        "block_moments<TileSums<9,5>>", "block_moments<RowSums<6>>", "group_sums", "cd_cov<8>",
    ]
    assert got[0][1].startswith("Used 168 registers") and "68 bytes spill stores" in got[0][2]
    assert got[1][2].startswith("0 bytes stack frame") and got[3][1].startswith("Used 59 registers")


def test_ptxas_report_names_bool_template_arguments():
    log = (
        "ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__6ae40f56_9_moving_cu_76ae805a4walkILi5E"
        "Lb0ELb1EEEvNS_7ProblemENS_4MeanENS_6LayoutEllPKdPdS6_lS6_PhS6_S6_S7_Pi' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 154 registers, used 0 barriers\n"
    )
    got = cs._ptxas(log)
    assert [e for e, _, _ in got] == ["walk<5,0,1>"]
    assert got[0][1].startswith("Used 154 registers")


@pytest.mark.parametrize("seed,sigma,cap", [(5, 1.0, 4_000), (6, 2.0, 2_000)])
def test_skewed_counts_hold_the_rows_under_the_cap(seed, sigma, cap):
    counts = cs._skewed_counts(np.random.default_rng(seed), 800_000, 1_000, sigma, cap)
    assert counts.sum() == 800_000 and counts.max() <= cap and counts.min() >= 0
    assert len(counts) == 1_000 and (counts == cap).any()


def test_householder_bound_at_the_multi_target_width():
    # S = 20,000 blocks of R = 512, C = 7, K = 5: 0.573 GB of panel, 10 MB
    # of mask and 5.6 MB of factors (0.176 ms at 3.35 TB/s) against ~1
    # GFLOP (~0.015 ms at the tensor cores' 67 TFLOP/s): bytes bound it
    S, R, C, K = 20_000, 512, 7, 5
    Z = torch.zeros((1, 1, C), dtype=torch.float64).expand(S, R, C)
    w = torch.ones((1, 1), dtype=torch.bool).expand(S, R)
    b = cs._householder_bound(Z, w, K)
    moved = S * R * (8 * C + 1) + 8 * S * K * C
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(moved / cs.PEAK_BYTES_PER_S * 1e3)
    assert b["bound_ms"] == pytest.approx(0.1759, rel=1e-3)
    flops = 4 * S * R * sum(C - j for j in range(K))
    assert flops == pytest.approx(1.0e9, rel=0.05)


def test_reduction_err_reports_and_checks_against_column_norms():
    rng = np.random.default_rng(0)
    Z = torch.as_tensor(rng.normal(size=(4, 16, 6)) * [1.0, 1e3, 1.0, 1e-3, 1.0, 1.0])
    w = torch.as_tensor(rng.random((4, 16)) > 0.2)
    T = torch.as_tensor(rng.normal(size=(4, 3, 6)))
    close = T.clone()
    close[..., 1] += 1e-11  # within 1e-12 of the 1e3-scaled column's norm
    err_r, err_q = cs._reduction_err(close, T, Z, w, 2, torch)
    assert err_q == pytest.approx(1e-11, rel=1e-3) and err_r == 0.0
    far = T.clone()
    far[..., 3] += 1e-13  # not within 1e-12 of the 1e-3-scaled column's norm
    with pytest.raises(AssertionError, match="column's norm"):
        cs._reduction_err(far, T, Z, w, 2, torch)
    nan = T.clone()
    nan[0, 0, 0] = float("nan")
    with pytest.raises(AssertionError, match="NaN"):
        cs._reduction_err(nan, T, Z, w, 2, torch)


# the angle by hand (csrc/jacobi_svd.cu:angle): 2 apq; tau = div_fast (rcp,
# then e, e + e^2, r, q, the residual, q's fix: 6); 1 + tau^2; sqrt_fast
# (rsqrt, then x y, e, y e, the fix, g, the residual, g's fix: 7); |tau| +
# the root; t = div_fast (rcp and 6); 1 + t^2; rsqrt_fast (rsqrt, then x y,
# e, y e, the fix: 4); s = c t; the rotation's multiply and multiply-add
ANGLE_FMA = 1 + 6 + 1 + 7 + 1 + 6 + 1 + 4 + 1 + 2


def test_jacobi_angle_path_counts_the_newton_steps_by_hand():
    assert ANGLE_FMA == 30
    assert cs.JACOBI_ANGLE_PATH == {"fma": ANGLE_FMA, "rcp": 2, "rsqrt": 2}


@pytest.mark.parametrize("K,fma", [(9, 1 + 4), (16, 1 + 4), (17, 1 + 5), (32, 1 + 5)])
def test_jacobi_pair_path_counts_the_segment_shuffle_adds(K, fma):
    # a product and log2(KB) shuffle adds (KB = 16 / 32 lanes), then the angle
    assert cs._jacobi_pair_path(K, "segment") == {"fma": fma + ANGLE_FMA, "rcp": 2, "rsqrt": 2}


@pytest.mark.parametrize("K", [1, 2, 5, 6, 8])
def test_jacobi_pair_path_counts_the_thread_forms_dot_chain(K):
    # a K-term chain of multiply-adds in the thread, then the angle
    assert cs._jacobi_pair_path(K, "thread") == {"fma": K + ANGLE_FMA, "rcp": 2, "rsqrt": 2}


@pytest.mark.parametrize("K,fma", [(5, 7), (9, 7), (32, 8)])
def test_jacobi_test_path_is_a_dot_its_root_and_the_threshold(K, fma):
    # the dots, then apq^2 against K eps^2 app aqq: on squares, no root
    form = "thread" if K <= 8 else "segment"
    assert cs._jacobi_test_path(K, form) == {"fma": fma}


@pytest.mark.parametrize("K,sweeps,pairs,depth", [
    (2, 3, None, 3),  # one pair: each rotation waits for the last
    (5, 1, None, 7),  # a full cyclic sweep is 2 K - 3 deep, not 10
    (5, 2, None, 12),  # the next sweep's (0, 1) waits for (1, 4)
    (5, 1, [3, 4], 1),  # (0, 4) and (1, 2) share no column
    (5, 1, [0, 4], 2),  # (0, 1) then (1, 2)
    (5, 2, [], 0),  # nothing rotated
    (8, 1, None, 13),
])
def test_jacobi_chain_follows_the_shared_columns(K, sweeps, pairs, depth):
    P = K * (K - 1) // 2
    rotated = torch.zeros((3, sweeps, P), dtype=torch.bool)
    rotated[1, :, list(range(P)) if pairs is None else pairs] = True
    got, rotations = cs._jacobi_chain(rotated, K)
    assert got.tolist() == [0, depth, 0]
    assert rotations.tolist() == [0, int(rotated[1].sum()), 0]


@pytest.mark.parametrize("K", [4, 5, 8, 40])
def test_jacobi_chain_of_the_wide_forms_rounds(K):
    # in the circle method's rounds a round's pairs share no column: a
    # sweep that rotates every pair is one rotation a round deep (K - 1
    # rounds, K rounded up to even)
    from polars_ols_tpu_torch.ops import jacobi

    pairs = [pq for rnd in jacobi.sweep_rounds(K, True) for pq in rnd]
    P = K * (K - 1) // 2
    rotated = torch.ones((2, 2, P), dtype=torch.bool)
    rotated[0] = False
    got, rotations = cs._jacobi_chain(rotated, K, pairs)
    rounds = K - 1 + (K & 1)
    assert got.tolist() == [0, 2 * rounds] and rotations.tolist() == [0, 2 * P]


def test_jacobi_bound_at_the_multi_target_factors():
    # 10,000 factors of K = 5 and targets of M = 2: ~3.7 MB (~1.1 us at
    # 3.35 TB/s) against ~0.04 GFLOP (~1.2 us at 34 TFLOP/s): operations
    # bound it. Every group rotates every pair for 4 sweeps, one for 6, and
    # then takes a sweep that rotates nothing: the latency bound is the
    # longest chain, 7 + 5 x 5 = 32 rotations, and one test
    G, K, M = 10_000, 5, 2
    F = torch.zeros((G, K, K), dtype=torch.float64)
    Y = torch.zeros((G, K, M), dtype=torch.float64)
    sweeps = torch.full((G,), 5, dtype=torch.int64)
    sweeps[3] = 7
    rotated = torch.zeros((G, 7, 10), dtype=torch.bool)
    rotated[:, :4] = True
    rotated[3, :6] = True
    op_ms = {"fma": 2e-6, "rcp": 1e-5, "rsqrt": 2e-5}
    b = cs._jacobi_bound(F, Y, sweeps, rotated, op_ms, "thread")
    moved = 8 * (G * K * K + 2 * G * K * M + G)
    assert moved / cs.PEAK_BYTES_PER_S * 1e3 == pytest.approx(0.0011, rel=0.01)
    rot = (G - 1) * 40 + 60
    tested = (5 * (G - 1) + 7) * 10
    ops = rot * (18 * K + 20) + (tested - rot) * (6 * K + 6) + G * K * K * (2 * M + 2)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(ops / cs.PEAK_F64_PER_S * 1e3)
    assert b["sweeps_max"] == 7 and b["sweeps_median"] == 5.0 and b["chain_pairs_max"] == 32
    pair = (5 + ANGLE_FMA) * 2e-6 + 2 * 1e-5 + 2 * 2e-5
    test = (5 + 2) * 2e-6
    assert b["latency_bound_ms"] == pytest.approx(32 * pair + test)
    assert b["pair_path"] == {"fma": 35, "rcp": 2, "rsqrt": 2} and b["test_path"] == {"fma": 7}
    # a group stopped by the cap (its last sweep rotated) takes no test
    rotated[3, 6] = True
    b = cs._jacobi_bound(F, Y, sweeps, rotated, op_ms, "thread")
    assert b["chain_pairs_max"] == 37 and b["latency_bound_ms"] == pytest.approx(37 * pair)


@pytest.mark.parametrize("kind,K,alpha,rcond", [
    ("factor", 5, 0.0, None), ("factor", 1, 0.0, None), ("deficient", 5, 0.0, None),
    ("nan", 5, 0.0, None), ("factor", 5, 0.3, 1e-6), ("square", 5, 0.0, None), ("factor", 16, 0.0, None),
])
def test_svd_route_agrees_with_the_jacobi_plain_version(kind, K, alpha, rcond):
    # the smoke's library yardstick (torch.linalg.svd with the cutoff and
    # shrink) and the kernel's plain version on the smoke's edge inputs:
    # the same NaN pattern, beta at rtol 1e-9 (two SVD methods)
    from polars_ols_tpu_torch.ops import jacobi

    F, Y, nv = cs._jacobi_edge(np.random.default_rng(4), 60, K, 2, kind, torch, device="cpu")
    want = jacobi.factor_lstsq_ref(F, Y, nv, alpha, rcond)
    got = cs._svd_route(F, Y, nv, alpha, rcond, torch)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    if kind == "nan":
        assert bool(torch.isnan(want[0::7]).all()) and bool(torch.isnan(want[3::7, :, 1]).all())
    ok = ~torch.isnan(want)
    np.testing.assert_allclose(got[ok].numpy(), want[ok].numpy(), rtol=1e-9, atol=1e-11)


def test_check_jacobi_runs_its_gates_on_cpu_tensors(monkeypatch, capsys):
    # a rehearsal of the smoke's Jacobi phase: on CPU tensors the wrapper is
    # the plain version, so every gate passes and the line is printed (the
    # form is the kernel's C entry's to say: a stand-in answers here)
    from polars_ols_tpu_torch.ops import jacobi

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(jacobi, "kernel_form", lambda K, G=1: ("thread", 32, 32))
    for kind in ("deficient", "nan"):
        F, Y, nv = cs._jacobi_edge(np.random.default_rng(7), 300, 5, 2, kind, torch, device="cpu")
        out = cs._check_jacobi(kind, F, Y, nv, jacobi, torch, {})
        assert out["max_abs_err"] == 0.0 and out["max_abs_err_vs_library"] < 1e-9
    assert "kernel jacobi_svd nan: G=300 K=5 M=2" in capsys.readouterr().out


def _fake_in_turns(calls):
    """An _in_turns that calls each function once (on CPU tensors) and
    reports 1 ms a launch and 2 us of host time."""
    def fake(fns, n, torch_, synced=()):
        calls.append((sorted(fns), n, tuple(synced)))
        for fn in fns.values():
            fn()
        return {name: (1.0, 2.0) for name in fns}
    return fake


def test_jacobi_phases_run_their_gates_on_cpu_tensors(monkeypatch, capsys):
    # a rehearsal of the smoke's phase timing: each capped launch is held to
    # the plain version under the same cap, then 0 / 1 / all sweeps are
    # timed in turns through the one wrapper
    from polars_ols_tpu_torch.ops import jacobi

    calls = []
    monkeypatch.setattr(cs, "_in_turns", _fake_in_turns(calls))
    F, Y, nv = cs._jacobi_edge(np.random.default_rng(8), 200, 5, 2, "factor", torch, device="cpu")
    ms = cs._jacobi_phases("rehearsal", F, Y, nv, jacobi, torch, "card, 700 W")
    assert ms == {"0 sweeps": 1.0, "1 sweeps": 1.0, f"{jacobi.MAX_SWEEPS} sweeps": 1.0}
    assert calls == [(sorted(ms), cs.JACOBI_LAUNCHES, ())]
    assert "kernel jacobi_svd phases rehearsal" in capsys.readouterr().out


def test_jacobi_phase_gate_catches_a_wrong_cap(monkeypatch):
    # a wrapper that ignored its cap would give the converged beta at 0
    # sweeps: the gate against the capped plain version refuses it
    from polars_ols_tpu_torch.ops import jacobi

    class Uncapped:
        MAX_SWEEPS = jacobi.MAX_SWEEPS
        factor_lstsq_ref = staticmethod(jacobi.factor_lstsq_ref)

        @staticmethod
        def factor_lstsq(F, Y, nv, alpha=0.0, rcond=None, max_sweeps=None):
            return jacobi.factor_lstsq(F, Y, nv, alpha, rcond)

    monkeypatch.setattr(cs, "_in_turns", _fake_in_turns([]))
    F, Y, nv = cs._jacobi_edge(np.random.default_rng(9), 100, 5, 2, "factor", torch, device="cpu")
    with pytest.raises(AssertionError, match="0 sweeps"):
        cs._jacobi_phases("wrong", F, Y, nv, Uncapped, torch, "")


def test_check_jacobi_times_what_it_is_asked(monkeypatch, capsys):
    # the edge batches time the kernel and the torch.linalg.svd route only
    # (the plain version takes seconds a call at K = 32): plain_ms is None,
    # the form and the bounds are reported
    from polars_ols_tpu_torch.ops import jacobi

    calls = []
    monkeypatch.setattr(cs, "_in_turns", _fake_in_turns(calls))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(jacobi, "kernel_form", lambda K, G=1: ("segment", 64, 4))
    F, Y, nv = cs._jacobi_edge(np.random.default_rng(10), 150, 16, 1, "factor", torch, device="cpu")
    out = cs._check_jacobi("K=16", F, Y, nv, jacobi, torch, OP_MS, timed=("kernel", "library"))
    assert calls == [(["kernel", "library"], cs.JACOBI_LAUNCHES, ("plain", "library"))]
    assert out["ms"] == out["library_ms"] == 1.0 and out["plain_ms"] is None and "segment_ms" not in out
    assert (out["form"], out["threads_per_block"], out["groups_per_block"]) == ("segment", 64, 4)
    assert out["latency_bound_ms"] > 0 and out["sweeps_max"] >= 2
    assert out["pair_path"] == cs._jacobi_pair_path(16, "segment")
    assert "segment form (64 threads, 4 groups a block)" in capsys.readouterr().out


def test_jacobi_bound_of_groups_that_never_sweep():
    # K = 1 has no pair: no sweep is recorded, and the bound has no chain
    G = 50
    F = torch.ones((G, 1, 1), dtype=torch.float64)
    Y = torch.ones((G, 1, 2), dtype=torch.float64)
    b = cs._jacobi_bound(F, Y, torch.zeros(G, dtype=torch.int64), torch.zeros((G, 0, 0), dtype=torch.bool), OP_MS,
                         "thread")
    assert b["latency_bound_ms"] == 0.0 and b["chain_pairs_max"] == 0 and b["sweeps_max"] == 0
    assert b["bound_by"] == "bytes"


@pytest.mark.parametrize("K,fma", [(33, 2 + 5), (40, 2 + 5), (100, 4 + 5), (1_000, 32 + 5)])
def test_jacobi_pair_path_counts_the_wide_forms_lane_sums(K, fma):
    # a lane's ceil(K / 32) multiply-adds and a warp's 5 shuffle adds, then
    # the Newton angle the wide form shares with the other forms
    assert cs._jacobi_pair_path(K, "wide") == {"fma": fma + ANGLE_FMA, "rcp": 2, "rsqrt": 2}


def test_check_jacobi_times_the_plain_version_once_on_the_cpu(monkeypatch, capsys):
    # the wide form's phase: the plain version runs once (here on the CPU
    # tensors it is given), and that one call is its time; the kernel and
    # the library route are timed in turns, and the chain follows the wide
    # form's rounds
    from polars_ols_tpu_torch.ops import jacobi

    calls = []
    monkeypatch.setattr(cs, "_in_turns", _fake_in_turns(calls))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(jacobi, "kernel_form", lambda K, G=1: ("wide", 32, 1))
    F, Y, nv = cs._jacobi_edge(np.random.default_rng(11), 20, 33, 2, "factor", torch, device="cpu")
    out = cs._check_jacobi("K=33", F, Y, nv, jacobi, torch, OP_MS, timed=("plain", "kernel", "library"),
                           plain_once=True)
    assert calls == [(["kernel", "library"], cs.JACOBI_LAUNCHES, ("plain", "library"))]
    assert out["plain_ms"] > 0 and out["ms"] == 1.0
    # at most 33 rounds a sweep (K = 33 rounds up to 34 columns)
    assert 0 < out["chain_pairs_max"] <= 33 * out["sweeps_max"]
    assert out["max_abs_err"] == 0.0 and out["pair_path"] == cs._jacobi_pair_path(33, "wide")
    assert "wide form (32 threads, 1 groups a block)" in capsys.readouterr().out


@pytest.mark.parametrize("label", ["ols_qr", "ols_svd", "ols", "ridge_chol", "ridge_svd", "wls"])
def test_wide_expected_is_numpys_solution_of_each_query(label):
    rng = np.random.default_rng(12)
    X, y, w = rng.normal(size=(60, 7)), rng.normal(size=60), rng.random(60) + 0.1
    beta = cs._wide_expected(label, X, y, w)
    if label.startswith("ridge"):
        grad = X.T @ (X @ beta - y) + cs.WIDE_ALPHA * beta
    elif label == "wls":
        grad = X.T @ (w * (X @ beta - y))
    else:
        grad = X.T @ (X @ beta - y)
    np.testing.assert_allclose(grad, 0.0, atol=1e-10)


def test_wide_queries_name_their_output_columns():
    import polars_ols_tpu_torch as pt

    cd_labels = ["elastic_net", "elastic_net/coef", "lasso", "lasso/coef", "nnls", "nnls/coef",
                 "lasso_active_set", "lasso_active_set/coef", "elastic_net_statistics"]
    plain = cs._wide_queries(pt, pt.col, 40, False)
    assert list(plain) == ["ols_qr", "ols_svd", "ridge_chol", "ridge_svd", "wls", "ols", "statistics", "rls",
                           "rolling", *cd_labels]
    grouped = cs._wide_queries(pt, pt.col, 40, True, fault=[f"t{j}" for j in range(cs.FAULT_TARGETS)])
    assert list(grouped)[-2:] == ["multi_target", "fault_multi_target"]
    assert {label: column for label, (_, column) in grouped.items()} == {
        **{label: "y" for label in ("ols_qr", "ols_svd", "ridge_chol", "ridge_svd", "wls", "ols", "rls", "rolling")},
        **{label: "coefficients" if label.endswith("/coef") else "y" for label in cd_labels},
        "statistics": "statistics", "elastic_net_statistics": "statistics", "multi_target": "p",
        "fault_multi_target": "p",
    }


def test_wide_cd_paths_count_the_steps_by_hand():
    # K = 40: W = 64, L = 6 adds of the tree
    p = cs._wide_cd_paths(40)
    assert p["iteration"] == {"fma": 12 + 12, "div": 1, "sqrt": 1}
    assert p["power_step"] == {"fma": 3 + 12, "div": 1, "sqrt": 1}
    assert p["coordinate"] == {"fma": 6 + 6, "div": 1} and p["sweep_end"] == {"fma": 8, "sqrt": 1}
    assert cs._wide_cd_paths(1_000)["coordinate"]["fma"] == 6 + 10  # W = 1,024


@pytest.mark.parametrize("fista", [True, False], ids=["fista", "cyclic"])
def test_cd_wide_bound_counts_what_the_groups_took(fista):
    G, K = 3, 40
    counts = np.asarray([1, 30, 12])
    b = cs._cd_wide_bound(G, K, counts, OP_MS, fista, 24)
    moved = 8 * (G * K * K + G * K + G) + 8 * G * K + 4 * G
    ops = (3 * 25 + 43) * 2 * K * K if fista else 43 * K * 2 * K
    assert b["bound_ms"] == pytest.approx(max(moved / cs.PEAK_BYTES_PER_S, ops / cs.PEAK_F64_PER_S) * 1e3)
    paths = cs._wide_cd_paths(K)
    if fista:
        want = {k: 24 * paths["power_step"].get(k, 0) + 30 * paths["iteration"].get(k, 0) for k in ("fma", "div", "sqrt")}
    else:
        want = {k: 30 * (K * paths["coordinate"].get(k, 0) + paths["sweep_end"].get(k, 0)) for k in ("fma", "div", "sqrt")}
    assert b["longest_path"] == want and b["counts_max"] == 30
    assert b["latency_bound_ms"] == pytest.approx(sum(n * OP_MS[k] for k, n in want.items()))


def test_kkt_holds_at_the_optimum_and_fails_off_it():
    # a literal numpy descent to a tight tol satisfies the elastic-net
    # conditions; a nudged coefficient does not
    rng = np.random.default_rng(3)
    X = rng.normal(size=(80, 12))
    y = X @ (rng.normal(size=12) * (rng.random(12) > 0.5)) + rng.normal(size=80)
    XtX, Xty = X.T @ X, X.T @ y
    for positive in (False, True):
        w = cs._cd_numpy(XtX, Xty, 80.0, 0.1, 0.7, positive, max_iter=100_000, tol=1e-14)
        a = 0.1 * 80
        assert (w == 0).any() and (w != 0).any()
        assert cs._kkt(XtX, Xty, a * 0.7, a * 0.3, w, positive, 1e-9, "tight") < 1e-9
        bad = w.copy()
        bad[np.flatnonzero(w)[0]] *= 1.01
        with pytest.raises(AssertionError):
            cs._kkt(XtX, Xty, a * 0.7, a * 0.3, bad, positive, 1e-9, "nudged")


@pytest.mark.parametrize("kw", [dict(alpha=0.05, l1_ratio=0.5), dict(alpha=0.05, l1_ratio=1.0, active_set=True)],
                         ids=["fista", "cyclic"])
def test_check_cd_wide_runs_its_gates_on_cpu_tensors(monkeypatch, capsys, kw):
    # a rehearsal of the smoke's wide coordinate-descent phase: on CPU
    # tensors the launch is a stand-in for the plain versions, so every gate
    # passes and the line is printed
    from polars_ols_tpu_torch.ops import cd

    def launch(*args, fista):
        return cd.fista_ref(*args[:8], kernel_order=True) if fista else cd._cyclic_wide_ref(*args)

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(cd, "launch_wide", launch)
    monkeypatch.setattr(cd, "wide_layout", lambda K, fista: (True, 0))
    rng = np.random.default_rng(4)
    X = rng.normal(size=(5, 80, 36))
    y = np.einsum("grk,gk->gr", X, rng.normal(size=(5, 36)) * (rng.random((5, 36)) > 0.6))
    XtX = torch.as_tensor(np.einsum("grk,grl->gkl", X, X))
    Xty = torch.as_tensor(np.einsum("grk,gr->gk", X, y))
    out = cs._check_cd_wide("rehearsal", XtX, Xty, torch.full((5,), 80.0, dtype=torch.float64), kw, cd, torch,
                            OP_MS, "no card", timed=False)
    assert out["max_abs_err"] == 0.0 and out["K"] == 36 and out["library_ms"] is None
    assert "kernel cd_" in capsys.readouterr().out


@pytest.mark.parametrize("G,R,K", [(10_000, 900, 8), (10_000, 900, 32), (1_000, 570, 40), (1, 10_000, 100)])
def test_plain_groups_keep_the_moving_states_under_the_budget(G, R, K):
    n = cs._plain_groups(G, R, K)
    assert 1 <= n <= G
    assert n == G or cs.PLAIN_COPIES * n * R * K * K * 8 <= cs.PLAIN_STATE_BYTES
    assert n == G or cs.PLAIN_COPIES * (n + 1) * R * K * K * 8 > cs.PLAIN_STATE_BYTES


def test_register_digests_hash_every_output_on_cpu_tensors():
    # the helper that holds the register form to its recorded bits runs on
    # CPU tensors through the plain versions: one 16-digit digest a K,
    # distinct, and the same on a second call
    from polars_ols_tpu_torch.ops import moving

    got = cs._register_digests(moving, torch, device="cpu")
    assert sorted(got) == list(range(1, 9)) == sorted(cs.REGISTER_FORM_DIGESTS)
    assert all(len(d) == 16 and int(d, 16) >= 0 for d in got.values())
    assert len(set(got.values())) == 8
    assert got == cs._register_digests(moving, torch, device="cpu")


@pytest.mark.parametrize("positional", [True, False], ids=["positional", "valid_rank"])
@pytest.mark.parametrize("min_periods", [None, 2])
def test_ridge_exact_solves_each_window_as_the_plain_version_defines_it(positional, min_periods):
    # the long-double oracle of the short ridge windows: on a well-posed
    # case (K = 3, window 6, alpha 0.5, ~20 % invalid rows) each refreshed
    # row's coefficients are the primal ridge solve of its window, carried
    # across rows that do not refresh, NaN before the first; the
    # predictions are x_t . beta; and it equals the port's plain version
    from polars_ols_tpu_torch.ops import moving, rolling

    rng = np.random.default_rng(21)
    G, R, K, window, alpha = 2, 40, 3, 6, 0.5
    Z = rng.normal(size=(G, R, 1 + K))
    v = rng.random((G, R)) > 0.2
    rows = np.asarray([R, R - 7])
    v[1, rows[1]:] = False
    coefs = cs._ridge_exact(Z, v, rows, window, min_periods, alpha, positional, "coefficients")
    preds = cs._ridge_exact(Z, v, rows, window, min_periods, alpha, positional, "predictions")
    mp = K if min_periods is None else min_periods
    for g in range(G):
        last = None
        for t in range(rows[g]):
            valid = np.flatnonzero(v[g, : t + 1])
            w = valid[valid > t - window] if positional else valid[-window:]
            if (len(w) >= mp) if positional else (v[g, t] and len(valid) >= mp):
                X, y = Z[g, w, 1:], Z[g, w, 0]
                last = np.linalg.solve(X.T @ X + alpha * np.eye(K), X.T @ y)
            if last is None:
                assert np.isnan(coefs[g, t]).all() and np.isnan(preds[g, t])
            else:
                np.testing.assert_allclose(coefs[g, t], last, rtol=1e-12, atol=1e-13)
                np.testing.assert_allclose(preds[g, t], Z[g, t, 1:] @ last, rtol=1e-12, atol=1e-13)
    Zt, vt = torch.as_tensor(Z), torch.as_tensor(v)
    plain = rolling.solve_rolling_ols(Zt[..., 1:], Zt[..., 0], vt, window, min_periods, alpha, positional)
    for want, exact in (("coefficients", coefs), ("predictions", preds)):
        ref = moving._from_coefs(plain, Zt, want).numpy()
        for g, n in enumerate(rows):
            np.testing.assert_array_equal(np.isnan(ref[g, :n]), np.isnan(exact[g, :n]))
            m = ~np.isnan(exact[g, :n])
            np.testing.assert_allclose(ref[g, :n][m], exact[g, :n][m], rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("dropped_absent", [False, True])
def test_frame_steps_pass_their_numpy_checks_on_cpu(monkeypatch, dropped_absent):
    # the smoke's frame workflow (filter, with_row_index, .over fits, column
    # arithmetic, group_by agg / last, unique, a left join then predict, a
    # two-key sort, statistics exploded) on a small frame, checked by the
    # smoke's own numpy checks with every value column on the CPU; once
    # with a frame whose filtered group exists, once without it
    import polars_ols_tpu_torch as pt
    from polars_ols_tpu_torch import CONFIG

    monkeypatch.setattr(CONFIG, "device", "cpu")
    rng = np.random.default_rng(3)
    n, k, G = 12_000, 5, 40
    x = rng.normal(size=(n, k))
    y = x @ np.arange(1.0, k + 1) + rng.normal(size=n) * 0.1
    g = rng.integers(G, size=n).astype(float)
    if dropped_absent:
        g[g == cs.FRAME_DROPPED] = cs.FRAME_DROPPED + 1
    df = pt.DataFrame({"y": y, **{f"x{i + 1}": x[:, i] for i in range(k)}, "group": g})
    out = cs.run_frame_steps(pt, df)
    shapes = cs._check_frame(out, x, y, g, np.unique(g).astype(np.int64), device="cpu")
    n_kept = int((g != cs.FRAME_DROPPED).sum())
    assert shapes["lazy"] == (n_kept, k + 6) and shapes["join_predict"] == (n, 2)
    assert shapes["explode"] == (len(np.unique(g)) * k, 9)
    with pytest.raises(AssertionError, match="not only cuda"):
        cs._check_frame(out, x, y, g, np.unique(g).astype(np.int64))
