"""The comparison that decides ``correct`` fails its control and the
faults a cell can have.

The control is the plain reference computed in float32, the precision
below the configurations' float64, put in the program's place: it has to
come out not correct. Here at a size a CPU test run holds; the
``gpu``-marked case reads it on the card at each cell's own size, on three
seeds (``calibrate.py`` prints the same readings for the limits). The
faults are planted in the program's ``DataFrame.select`` while the rest of
a run goes on as on the chip (only the look for a card is skipped): an
answer altered where it is produced, half of the batch left out, and a
state left unchanged (every answer the prior's: zero)."""

import numpy as np
import pytest

from portbench import calibrate, harness
from portbench.tests.tiny import CELLS, tiny_cell

SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)
WINDOW_S = 3.0  # long enough on the CPU, one thread, for every select of a cycle to run at least once


@pytest.fixture
def pt():
    """The program on the CPU, one torch thread (test workers share the cores)."""
    import torch

    import polars_ols_tpu_torch as pt

    device, threads = pt.CONFIG.device, torch.get_num_threads()
    pt.CONFIG.device = "cpu"
    torch.set_num_threads(1)
    yield pt
    pt.CONFIG.device = device
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct_and_control_is_not(pt, cell):
    c = tiny_cell(cell)
    got = calibrate.program_readings(c, SEEDS[0], "cpu")
    assert got["correct"], got["nums"]
    ctl = calibrate.control_readings(c, got["state"], got["samples"])
    assert not ctl["correct"], ctl["nums"]
    calibrate.release(got["state"])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size_on_card(cuda, cell):
    c = harness.Cell.load(cell)
    for seed in SEEDS:
        got = calibrate.program_readings(c, seed, cuda)
        assert got["correct"], got["nums"]
        assert not calibrate.control_readings(c, got["state"], got["samples"])["correct"]
        calibrate.release(got["state"])


def _altered(out):
    """One answer, the last row's, off by one part in a million."""
    for name in out.columns:
        s = out[name]
        v = s.values
        if v.dim() == 1:
            v[-1] = v[-1] * (1 + 1e-6)
        else:
            v[-1, 0] = v[-1, 0] * (1 + 1e-6)
    return out


def _zeroed(out):
    for name in out.columns:
        out[name].values.zero_()
    return out


def _planted(pt, monkeypatch, fault):
    select = pt.DataFrame.select

    def broken(self, *exprs, **named):
        if fault == "half_left_out":
            n = self.height
            half = select(self.slice(0, n // 2), *exprs, **named)
            out = select(self, *exprs, **named)
            for name in out.columns:
                v = out[name].values
                v[: n // 2] = half[name].values
                v[n // 2:] = 0.0
            return out
        out = select(self, *exprs, **named)
        return _altered(out) if fault == "altered" else _zeroed(out)

    monkeypatch.setattr(pt.DataFrame, "select", broken)


@pytest.mark.parametrize("fault", ["altered", "half_left_out", "state_unchanged"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(pt, monkeypatch, cell, fault):
    c = tiny_cell(cell)
    assert harness.run(c, SEEDS[1], WINDOW_S, False, 0.0, device="cpu")["correct"]
    _planted(pt, monkeypatch, fault)
    got = harness.run(c, SEEDS[1], WINDOW_S, False, 0.0, device="cpu")
    assert not got["correct"], got["nums"]
    assert max(v for k, v in got["nums"].items() if k != "nulls") > min(
        v for k, v in c.limits.items() if k != "nulls") or got["nums"]["nulls"] > 0


def test_a_failed_select_is_not_correct(pt, monkeypatch):
    c = tiny_cell("grouped_k5.ols")
    select = pt.DataFrame.select
    calls = []

    def flaky(self, *exprs, **named):
        calls.append(1)
        if len(calls) == 8:
            raise RuntimeError("a select that fails once")
        return select(self, *exprs, **named)

    monkeypatch.setattr(pt.DataFrame, "select", flaky)
    got = harness.run(c, SEEDS[2], WINDOW_S, False, 0.0, device="cpu")
    assert got["failed"] == 1 and not got["correct"] and np.isfinite(got["nums"]["err.ols"])
