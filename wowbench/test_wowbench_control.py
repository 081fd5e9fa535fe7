"""``correct`` has to come out false for the control and for a run whose
timed path is broken underneath (CPU, at the sizes of
``test_wowbench_loadgen.tiny``).

The control is the reference in the program's place at TF32
(``wowbench.control``).  The planted faults are the ones a cell of this
benchmark can have: a hop chunk that returns its state unchanged; half of
the requests left unanswered; an answer altered where the engine produces
it; and, in the ingest cell, an apply that returns without inserting its
rows.  A one-card cell has no exchange between cards to leave out.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.serve import lifecycle
from wowbench import control, harness, spec
from wowbench.test_wowbench_loadgen import BENCH, cache, tiny  # noqa: F401


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct(cell):
    _, cfg, mix = tiny(cell)
    for seed in (1, 2, 2**31 + 3):
        r = control.readings(cfg, mix, seed, 1.0, "cpu")
        assert not r["correct"]
        gap, limit = r["checks"]["dist_gap"]
        assert gap > 3 * limit  # the control fails by its distances
        assert r["checks"]["recall"][0] >= r["checks"]["recall"][1]


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(lifecycle, "_run_hop_chunk",
                        lambda di, st, cfg, h: st)


def _half_unanswered(monkeypatch):
    step = lifecycle.ServeEngine.step
    monkeypatch.setattr(lifecycle.ServeEngine, "step", lambda self: [
        r for r in step(self) if r.rid % 2 == 0])


def _answer_altered(monkeypatch):
    reply = lifecycle.ServeEngine._reply

    def altered(self, req, ids, dists, **kw):
        ids = ids.copy()
        if ids[1] >= 0:  # the first two answers trade places
            ids[[0, 1]] = ids[[1, 0]]
        return reply(self, req, ids, dists, **kw)

    monkeypatch.setattr(lifecycle.ServeEngine, "_reply", altered)


def _apply_skipped(monkeypatch):
    monkeypatch.setattr(lifecycle.ServeEngine, "_apply_ingest_one",
                        lambda self: self._ingest_q.popleft())


FAULTS = {"unchanged_state": _unchanged_state,
          "half_unanswered": _half_unanswered,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("cell,fault", [
    *(("sift128-read", f) for f in FAULTS),
    ("sift128-ingest", "answer_altered"),
    ("sift128-ingest", "apply_skipped"),
])
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault, cache):
    w, cfg, mix = tiny(cell)
    (FAULTS.get(fault) or _apply_skipped)(monkeypatch)
    out = harness.run(w, cfg, mix, BENCH, 9, 1.0, False, time.perf_counter(),
                      device="cpu", drain_s=10, cache_dir=cache)
    assert not out["correct"], out["checks"]
    failed = [n for n, c in out["checks"].items()
              if (c["value"] < c["limit"] if n.endswith("recall")
                  else c["value"] > c["limit"])]
    assert failed
