"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it resolved to its file (CPU, no program)."""
import json
import re

import pytest

from wowbench import loadgen, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (spec.ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    # a full check (2 + 14 runs a cell, each run_seconds + 60 s, two
    # compiles of 90 s a cell, 1,200 s spare) fits 43,200 s at 24 cells
    per_run = BENCH["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for group in (BENCH["configs"], BENCH["workloads"],
                  BENCH["end_to_end"] + BENCH["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)
    for text in ([c["source"] for c in BENCH["configs"]]
                 + [x["why"] for x in BENCH["configs"] + BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_sources_and_bounds():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            moved = next(x for x in BENCH["end_to_end"]
                         if x["name"] == m["moves"])
            assert cell in moved.get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    w = spec.find_cell(BENCH, cell)
    cfg = spec.load_config(w["config"])
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (spec.ROOT / entry["file"]).is_file()
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for key in ("n", "d", "metric", "index", "search", "checks", "assumed"):
        assert key in cfg
    mix = loadgen.load_mix(w["traffic"])
    assert 0 < mix["trace_seconds"] < BENCH["run_seconds"] / 2
    e2e = spec.metrics_for(BENCH, cell, trace=False)
    layer = spec.metrics_for(BENCH, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    for m in e2e + layer:
        assert callable(spec.load_reader(m["name"]))


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
