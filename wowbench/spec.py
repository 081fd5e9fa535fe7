"""``BENCHMARK.json`` and the files it names, found by name.

A cell (a ``workloads`` entry) names its configuration, read from
``wowbench/configs/<config>.json``, and its traffic mix, read from
``wowbench/traffic/<traffic>.json`` and run by the generator module it
names (``loadgen``).  Every metric, end to end or per
layer, is a reader in ``wowbench/metrics/<name>.py`` with one function,
``read(r)``, that takes the run's ``harness.Readings`` and returns a
number, or None where the run holds nothing for it to read.  Adding a
cell, a mix or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CONFIG_DIR = HERE / "configs"
METRIC_DIR = HERE / "metrics"


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   f"{', '.join(w['name'] for w in bench['workloads'])}")


def load_config(name: str) -> dict:
    """Configuration ``name``'s file, with its ``name``."""
    cfg = json.loads((CONFIG_DIR / f"{name}.json").read_text())
    cfg["name"] = name
    return cfg


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones.  A metric with a ``workloads`` key
    belongs to those cells; a per-layer metric without one belongs to
    every cell that reports the end-to-end metric it ``moves``."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def load_reader(name: str):
    """The ``read`` function of metric ``name``."""
    path = METRIC_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "wowbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
