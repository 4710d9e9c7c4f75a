"""``polars_ols_tpu_torch.warmup``: the counterpart of each test of
tests/test_warmup.py, on the CPU.

On the card ``warmup`` builds every ``csrc/*.cu`` and then runs one query
per (family, mode); on the CPU it builds nothing (checked: the build
entry point is replaced by one that fails) and runs the queries on the
plain versions. The JAX test's compile monitor has no counterpart on the
CPU, where the port compiles nothing: its counterpart checks that a
second warmup at the same shape builds nothing either and that a real
query at that shape matches the JAX package's at rtol 1e-9 / atol 1e-11.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import polars_ols_tpu as pj  # noqa: E402

import polars_ols_tpu_torch as pt  # noqa: E402
from polars_ols_tpu_torch import CONFIG  # noqa: E402
from polars_ols_tpu_torch.ops import kernels  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    # the suite runs six workers on the host's cores: torch's intra-op
    # threads in each oversubscribe them (a case of 1 s alone took minutes)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cpu")

    def no_build(name):
        raise AssertionError(f"warmup built {name} on the CPU")

    monkeypatch.setattr(kernels, "build", no_build)


def test_warmup_runs_every_family_and_mode():
    fams = ("ols", "ridge", "wls", "rls", "rolling_ols")
    t = pt.warmup(64, 3, families=fams, statistics=True)
    assert set(t) == {
        "ols/predictions", "ols/statistics",
        "ridge/predictions", "ridge/statistics",
        "wls/predictions", "wls/statistics",
        "rls/predictions", "rolling_ols/predictions",
    }
    assert all(v > 0 for v in t.values())
    assert set(pt.warmup(64, 3, families=("ols_qr", "ols_svd", "elastic_net"))) == {
        "ols_qr/predictions", "ols_svd/predictions", "elastic_net/predictions",
    }


def test_warmup_grouped_then_identical_shape_reuses_programs():
    pt.warmup(200, 2, n_groups=8, families=("ols",))
    t2 = pt.warmup(200, 2, n_groups=8, families=("ols",))
    assert t2["ols/predictions"] > 0

    rng = np.random.default_rng(1)
    data = {
        "y": rng.normal(size=200),
        "x0": rng.normal(size=200),
        "x1": rng.normal(size=200),
        "g": rng.integers(8, size=200).astype(float),
    }
    out = pt.DataFrame(data).select(pt.col("y").least_squares.ols(pt.col("x0"), pt.col("x1")).over("g"))
    vals = out[out.columns[0]].to_numpy()
    assert np.isfinite(vals).all()
    jout = pj.DataFrame(data).select(pj.col("y").least_squares.ols(pj.col("x0"), pj.col("x1")).over("g"))
    np.testing.assert_allclose(vals, jout[jout.columns[0]].to_numpy(), rtol=1e-9, atol=1e-11)


def test_warmup_rejects_unknown_family():
    with pytest.raises(AssertionError, match="unknown families"):
        pt.warmup(16, 2, families=("ols", "nope"))
