"""Traffic mixes and their generators.

A mix is a JSON file of parameters, ``wowbench/traffic/<mix>.json``.  Its
``generator`` names the module under ``wowbench/generators/`` that reads
it, so a new kind of traffic is a new generator file beside the others;
the harness's own keys are ``engine`` (``EngineConfig`` fields) and
``trace_seconds`` (the traced slice: the window's last seconds), and
every other key is the generator's.  A generator module has:

* ``check_mix(mix)``, which raises on keys it does not know;
* ``Traffic(eng, index, cfg, mix, base, seed, seconds, clock, span,
  device)``, which makes the run's inputs from the seed, and has
  ``warm()`` (set-up after the engine is built), ``start()`` and
  ``tick()`` (the window), ``close(t_close, limit_s)`` (after the window:
  drain and what else the mix sends), ``extra_rows()`` (rows it added to
  the index, for the reference), ``replies()`` (what the reference
  judges), ``checks()`` (numbers it holds itself, each beside its limit)
  and ``readings()`` (what the metric readers read).

``Log`` is the record of every request that the generators share: each
request is timed on the benchmark's clock from just before its ``submit``
to the return of the ``step()`` that produced its reply.
"""
from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
HARNESS_KEYS = {"why", "generator", "engine", "trace_seconds"}


def load_generator(name: str):
    """The generator module ``wowbench/generators/<name>.py``."""
    return importlib.import_module(f"wowbench.generators.{name}")


def load_mix(name: str) -> dict:
    """The parameters of traffic mix ``name`` (``traffic/<name>.json``),
    checked by the harness and by the mix's generator."""
    mix = json.loads((TRAFFIC_DIR / f"{name}.json").read_text())
    missing = HARNESS_KEYS - set(mix)
    if missing:
        raise ValueError(f"traffic {name}: missing {sorted(missing)}")
    load_generator(mix["generator"]).check_mix(mix)
    return mix


@dataclass
class Log:
    """Every request a loop sent, in submit order."""

    qidx: list = field(default_factory=list)  # pool index of each request
    t_submit: list = field(default_factory=list)
    t_reply: list = field(default_factory=list)  # +inf: never replied
    ids: list = field(default_factory=list)
    dists: list = field(default_factory=list)
    dc: list = field(default_factory=list)
    hops: list = field(default_factory=list)
    degraded: list = field(default_factory=list)
    rejected: int = 0

    def add(self, qi: int, t: float) -> int:
        """A request sent at ``t``; returns its number."""
        self.qidx.append(qi)
        self.t_submit.append(t)
        self.t_reply.append(np.inf)
        self.ids.append(None)
        self.dists.append(None)
        self.dc.append(0)
        self.hops.append(0)
        self.degraded.append(True)
        return len(self.qidx) - 1

    def reply(self, n: int, r, t: float) -> None:
        """Request ``n`` got reply ``r`` at ``t``."""
        self.t_reply[n] = t
        self.ids[n], self.dists[n] = r.ids, r.dists
        self.dc[n], self.hops[n] = int(r.dc), int(r.hops)
        self.degraded[n] = bool(r.degraded)

    def arrays(self) -> dict:
        return {"qidx": np.asarray(self.qidx, np.int64),
                "t_submit": np.asarray(self.t_submit, np.float64),
                "t_reply": np.asarray(self.t_reply, np.float64),
                "dc": np.asarray(self.dc, np.int64),
                "hops": np.asarray(self.hops, np.int64),
                "degraded": np.asarray(self.degraded, bool)}

    def answers(self, k: int) -> tuple:
        """(rows replied, ids i64[R, k], dists f32[R, k]) of the replied
        requests."""
        rows = np.flatnonzero(np.isfinite(np.asarray(self.t_reply)))
        ids = np.asarray([self.ids[i][:k] for i in rows], np.int64)
        dists = np.asarray([self.dists[i][:k] for i in rows], np.float32)
        return rows, ids.reshape(-1, k), dists.reshape(-1, k)
