"""``BENCHMARK.json`` against the benchmark's contract, and the files it
names."""

from __future__ import annotations

import json
import os
import re

from portbench.spec import ROOT, load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def line(text, most=200):
    return isinstance(text, str) and 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_the_keys_and_the_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and not path.startswith("/")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    assert len({c["file"] for c in BENCH["configs"]}) == len(names)
    cells = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in {(x["config"], x["traffic"]) for x in
                                                   BENCH["workloads"] if x is not w}
        cells.add(w["name"])
    assert {w["config"] for w in BENCH["workloads"]} == set(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    metric_names = list(e2e) + [m["name"] for m in BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and line(m["layer"])
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_every_cell_loads_and_reports_what_the_contract_asks():
    for w in BENCH["workloads"]:
        cell = load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        assert any(m["name"].startswith("step_mfu") for m in cell.per_layer)
        assert all(m["moves"] in names for m in cell.per_layer)
        assert cell.config.get("limits"), w["name"]


def test_the_files_are_named_from_the_characters_of_a_name():
    for d, _, files in os.walk(os.path.join(ROOT, "portbench")):
        if "__pycache__" in d:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), ROOT)
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
