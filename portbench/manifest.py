"""The rules a ``BENCHMARK.json`` keeps that the harness relies on: the
entries' keys, the characters of names and units, and the files found by
name. ``problems(manifest, root)`` lists each rule broken (none: sound)."""

from __future__ import annotations

import re
from pathlib import Path
from typing import List

from portbench.metrics import reader_file

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def problems(m: dict, root: Path) -> List[str]:
    bad: List[str] = []
    bench = root / "portbench"
    configs = {c["name"]: c for c in m["configs"]}
    cells = {w["name"]: w for w in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in m[kind]]
        bad += [f"{kind} name {n!r}" for n in names if not NAME.match(n)]
        if len(names) != len(set(names)):
            bad.append(f"{kind} names repeat")
    for c in configs.values():
        if set(c) != CONFIG_KEYS or not all(NAME.match(r) for r in c["reduced"]):
            bad.append(f"config {c['name']}")
        if not (root / c["file"]).is_file():
            bad.append(f"config {c['name']} file {c['file']}")
    for w in cells.values():
        if set(w) != CELL_KEYS or w["config"] not in configs or not NAME.match(w["traffic"]):
            bad.append(f"workload {w['name']}")
        elif not (bench / "mixes" / f"{w['traffic']}.json").is_file():
            bad.append(f"workload {w['name']} mix")
        if not (bench / "limits" / f"{w['name']}.json").is_file():
            bad.append(f"workload {w['name']} limits")
    for x in m["end_to_end"] + m["per_layer"]:
        keys = E2E_KEYS if x in m["end_to_end"] else LAYER_KEYS
        if set(x) - {"workloads"} != keys or not UNIT.match(x["unit"]):
            bad.append(f"metric {x['name']} keys or unit")
        if not set(x.get("workloads", [])) <= set(cells):
            bad.append(f"metric {x['name']} names an unknown cell")
    for x in m["per_layer"]:
        moved = e2e.get(x["moves"], {"workloads": []})
        if not set(x.get("workloads", cells)) <= set(moved.get("workloads", cells)):
            bad.append(f"per_layer {x['name']}: a cell of it does not report {x['moves']!r}")
        if not reader_file(bench / "metrics", x["name"]).is_file():
            bad.append(f"per_layer {x['name']} has no reader")
    return bad
