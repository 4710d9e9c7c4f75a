"""Each mix builds its expressions with the program, and a select of them
gives every labelled column at the frame's height; no module of JAX or of
the JAX package is loaded by the harness, a mix or the program."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import check, data, harness, traffic
from portbench.tests.tiny import CELLS, tiny_cell


@pytest.fixture
def pt():
    import polars_ols_tpu_torch as pt

    device = pt.CONFIG.device
    pt.CONFIG.device = "cpu"
    yield pt
    pt.CONFIG.device = device


@pytest.mark.parametrize("cell", CELLS)
def test_each_mix_builds_and_selects(pt, cell):
    c = tiny_cell(cell)
    inputs = data.make_inputs(c.cfg, 3, "cpu")
    frame = pt.DataFrame(inputs.columns(c.cfg))
    selects = traffic.build_selects(pt, c.mix, c.cfg)
    assert len(selects) == len(c.mix["selects"])
    for exprs, fits in zip(selects, c.mix["selects"]):
        out = frame.select(*exprs)
        assert out.columns == [f["label"] for f in fits]
        for f in fits:
            assert len(out[f["label"]]) == c.cfg["rows"]


def test_inputs_repeat_with_the_seed():
    c = tiny_cell("grouped_k5.ols")
    a, b, other = (data.make_inputs(c.cfg, s, "cpu") for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    assert np.array_equal(a.key, b.key) and bool((a.x == b.x).all()) and bool((a.y2 == b.y2).all())
    assert not np.array_equal(a.key, other.key)
    assert a.key.dtype == np.int64 and a.key.max() < c.cfg["groups"] and float(a.w.min()) >= 0.1


def test_the_sample_holds_the_largest_group_and_whole_groups():
    c = tiny_cell("grouped_k5.ols")
    c.mix["check_groups"] = 3
    key = data.make_inputs(c.cfg, 9, "cpu").key
    rows, gids, runs = check.plan(c.mix, c.cfg, key, 9)
    counts = np.bincount(key)
    assert int(np.argmax(counts)) in set(gids.tolist()) and len(set(gids.tolist())) <= 4
    assert all((key == g).sum() == (gids == g).sum() for g in set(gids.tolist()))
    assert np.all(np.diff(rows) > 0) and all(0 in r and len(r) == 2 for r in runs)


@pytest.mark.parametrize("traffic_name", ["ols", "moving", "svd", "sweep"])
def test_no_jax_is_loaded(traffic_name):
    """A fresh process imports the harness, builds a mix's expressions with
    the program and runs its first select on the CPU; no top-level module
    named jax, jaxlib, flax or polars_ols_tpu is loaded (names compared
    whole: polars_ols_tpu_torch begins with polars_ols_tpu)."""
    cell = {"ols": "grouped_k5.ols", "moving": "grouped_largek.moving", "svd": "grouped_largek.svd",
            "sweep": "grouped_k5.sweep"}[traffic_name]
    code = f"""
import json, sys
sys.path.insert(0, {str(harness.ROOT)!r})
from portbench import data, harness, traffic
from portbench.tests.tiny import tiny_cell
import polars_ols_tpu_torch as pt
pt.CONFIG.device = "cpu"
c = tiny_cell({cell!r})
frame = pt.DataFrame(data.make_inputs(c.cfg, 1, "cpu").columns(c.cfg))
frame.select(*traffic.build_selects(pt, c.mix, c.cfg)[0])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                          env={**os.environ, "POLS_TORCH_DEVICE": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "polars_ols_tpu_torch" in top and "portbench" in top
    assert not top & set(harness.FORBIDDEN)
    assert harness.loaded_forbidden() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN))
