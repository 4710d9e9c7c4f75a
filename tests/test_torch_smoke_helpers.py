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


def test_moment_bound_at_the_main_paths_shape():
    """S = 20,000 blocks of R = 512 rows, C = 6, G = 10,000: 0.151 ms."""
    moved = 20_000 * 512 * 49 + 8 * 10_001 + 8 * 10_000 * 36 + 8 * 10_000
    assert moved / cs.PEAK_BYTES_PER_S * 1e3 == pytest.approx(0.1507, abs=1e-4)


def test_cd_bound_counts_the_sweeps_taken():
    sweeps = np.array([3, 4, 5, 1])
    b = cs._cd_bound(4, 5, sweeps)
    assert b["bound_by"] == "bytes"
    moved = 8 * (4 * 25 + 4 * 5 + 4) + 8 * 4 * 5 + 4 * 4
    assert b["bound_ms"] == moved / 3.35e12 * 1e3
    # many sweeps of wide groups: the operations bound it
    heavy = cs._cd_bound(1, 32, np.array([10**6]))
    assert heavy["bound_by"] == "operations"
    assert heavy["bound_ms"] == 10**6 * 32 * (2 * 32 + 9) / 34e12 * 1e3


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


OP_MS = {"fma": 4e-6, "div": 30e-6, "sqrt": 30e-6, "log": 80e-6, "log1p": 90e-6, "exp": 60e-6, "erfc": 120e-6}


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
