"""The manifest keeps the contract's rules, and its files are found by name."""

import copy
import json

import pytest

from portbench import harness, manifest

ROOT = harness.ROOT
CELLS = ("grouped_k5.ols", "grouped_largek.moving", "grouped_largek.svd", "grouped_k5.sweep")


@pytest.fixture
def m():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_manifest_keeps_every_rule(m):
    assert manifest.problems(m, ROOT) == []
    assert [w["name"] for w in m["workloads"]] == list(CELLS)


@pytest.mark.parametrize("name", ["with space", "a,b", "a/b", "", "ü", "x" * 65, ".lead"])
def test_a_bad_name_is_refused(m, name):
    bad = copy.deepcopy(m)
    bad["per_layer"][0]["name"] = name
    assert manifest.problems(bad, ROOT)


@pytest.mark.parametrize("unit", ["tokens per second", "µs", "", "x" * 17])
def test_a_bad_unit_is_refused(m, unit):
    bad = copy.deepcopy(m)
    bad["end_to_end"][0]["unit"] = unit
    assert manifest.problems(bad, ROOT)


def test_an_extra_key_is_refused(m):
    bad = copy.deepcopy(m)
    bad["end_to_end"][0]["why"] = "no such key"
    assert manifest.problems(bad, ROOT)
    bad = copy.deepcopy(m)
    del bad["workloads"][0]["why"]
    assert manifest.problems(bad, ROOT)


def test_a_metric_moving_what_its_cell_does_not_report_is_refused(m):
    bad = copy.deepcopy(m)
    host = next(x for x in bad["per_layer"] if x["name"] == "host_ms_per_query")
    host["workloads"] = host["workloads"] + ["grouped_k5.ols"]  # the host-paced cell reports no rows_per_s
    assert manifest.problems(bad, ROOT)


def test_a_missing_file_is_refused(m):
    bad = copy.deepcopy(m)
    bad["workloads"][0]["traffic"] = "no_such_mix"
    assert manifest.problems(bad, ROOT)
    bad = copy.deepcopy(m)
    bad["per_layer"].append(dict(bad["per_layer"][0], name="no_such_reader"))
    assert manifest.problems(bad, ROOT)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_loads_its_files_by_name(cell):
    c = harness.Cell.load(cell)
    config, traffic = cell.split(".")
    assert c.cfg["name"] == config and c.mix["name"] == traffic
    assert c.cfg["reduced"] == [] and c.cfg["assumed"] == []
    quantities = {m["name"].split(".")[0] for m in c.end_to_end}
    layer = {m["name"].split(".")[0] for m in c.per_layer}
    assert quantities - {"rows_per_s"} == {"query_ms_p95", "device_mem_peak_gib", "setup_s"}
    assert len(quantities) == len(c.end_to_end)
    # the rate is bound end to end, or reported per layer where its runs spread too widely
    assert ("rows_per_s" in quantities) != ("window_rows_per_s" in layer)
    assert {"host_ms_per_query", "launches_per_query", "device_idle_share"} <= layer
    compared = {"nulls"}
    for fit in (f for s in c.mix["selects"] for f in s):
        t = fit["target"]
        compared |= {f"err.{fit['label']}.{x}" for x in t} if isinstance(t, list) else {f"err.{fit['label']}"}
    assert set(c.limits) == compared and c.limits["nulls"] == 0


@pytest.mark.parametrize("name", [
    "host_ms_per_query", "host_syncs_per_query", "launches_per_query", "moments_roofline",
    "moving_roofline", "householder_wide_roofline", "device_idle_share", "window_rows_per_s",
])
def test_each_reader_loads(name):
    assert callable(harness.load_reader(name).read)
    assert harness.load_reader(f"{name}.host_paced").__file__ == harness.load_reader(name).__file__
