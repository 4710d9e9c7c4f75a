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
import chip_smoke as cs  # noqa: E402


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


def _lentz_scalar(p, q, z):
    """csrc/t_pvalue.cu:lentz, one element, counting iterations."""
    tiny, eps = 1e-300, 2.0 ** -52

    def floor(v):
        return tiny if abs(v) < tiny else v

    qab, qap, qam = p + q, p + 1.0, p - 1.0
    c, d = 1.0, 1.0 / floor(1.0 - qab * z / qap)
    for m in range(1, 201):
        m2 = 2.0 * m
        aa = m * (q - m) * z / ((qam + m2) * (p + m2))
        d = 1.0 / floor(1.0 + aa * d)
        c = floor(1.0 + aa / c)
        aa = -(p + m) * (qab + m) * z / ((p + m2) * (qap + m2))
        d = 1.0 / floor(1.0 + aa * d)
        c = floor(1.0 + aa / c)
        if abs(d * c - 1.0) <= eps:
            return m
    return 200


def test_lentz_replica_counts_the_kernels_iterations():
    rng = np.random.default_rng(0)
    p = np.concatenate([np.exp(rng.uniform(-1, 6, 40)), [0.5, 0.5, 400.0]])
    q = np.concatenate([np.full(40, 0.5), [3.0, 400.0, 0.5]])
    z = np.concatenate([rng.uniform(0, 0.9, 40), [0.2, 0.3, 1e-3]])
    got = cs._lentz_iterations(p, q, z)
    want = [_lentz_scalar(*args) for args in zip(p, q, z)]
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 1 and got.max() > 5


def test_pvalue_bound_reads_t_and_dof_once():
    t = torch.as_tensor(np.random.default_rng(1).normal(size=(100, 5)) * 280.0)
    dof = torch.full((100,), 795.0, dtype=torch.float64)
    b = cs._pvalue_bound(t, dof)
    assert b["bound_by"] in ("bytes", "operations")
    assert b["bound_ms"] >= 8 * (2 * 500 + 100) / 3.35e12 * 1e3
    # edge rows (t = 0, dof <= 0, NaN) count no loop
    edges = cs._pvalue_bound(torch.zeros((3, 5), dtype=torch.float64),
                             torch.tensor([0.0, -1.0, math.nan], dtype=torch.float64))
    assert edges == {"bound_ms": 8 * (2 * 15 + 3) / 3.35e12 * 1e3, "bound_by": "bytes"}


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
