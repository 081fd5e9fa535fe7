"""The port's wowlint (``repro_torch.analysis``) against the JAX package's
(``repro.analysis``), and the serve engine's snapshot refresh that the
ported capture guard holds to the reference's contract.

Lint parity: every fixture of ``tests/test_analysis.py`` has a torch twin
here with its violations on the same lines, and the JAX engine on the
original and the port's engine on the twin report the same lines; the
port's engine on the reference's own fixture text reports the reference's
(pass, line) set for the passes whose idiom is the same in both packages
(durability, replication, shape, and dtype on numpy).  Then the clean
fixture, suppressions, the baseline, the shipped tree (clean with the
empty ``wowlint_torch_baseline.json``, no dead module), the CLI, the real
tree's roots and traced set, and a host sync planted in a copy of
``_hop_body``.

The refresh: the reference's gate scenario (``test_analysis.py``: n 520,
d 12, 120 rows ingested between two waves) through both engines on the
CPU — replies equal under the tie rule, the serving set's buffers kept
across the refresh — and a wave in flight across a refresh finishing on
its launch snapshot, bitwise ``search_batch`` there.  The capture counts
themselves need the card (``tests/test_torch_capture_guard.py``).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax  # noqa: F401  (the reference engine below runs on JAX)
import numpy as np
import pytest

import repro.core as rc
from repro.analysis.engine import lint_paths as ref_lint_paths
from repro.serve import lifecycle as rl
from repro_torch.analysis.callgraph import RepoIndex, load_module_file
from repro_torch.analysis.engine import (
    REPO_ROOT,
    lint_paths,
    lint_repo,
    report_dead,
    surface_files,
)
from repro_torch.analysis.findings import load_baseline, save_baseline
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.core import WoWIndex, make_workload
from repro_torch.core.device_search import (
    SearchResult,
    compare_results,
    search_batch,
)
from repro_torch.core.snapshot import take_snapshot
from repro_torch.serve.lifecycle import EngineConfig, ServeEngine

import test_analysis as ref_fixtures

ROOT = Path(__file__).resolve().parents[1]

# ------------------------------------------------------------ torch twins
# each twin keeps its reference fixture's violations on the same lines
CAPTURE_BAD = """
    import numpy as np
    import torch


    # captured by `capture` below: a graph root
    def hop(x):
        if x > 0:                 # branch on a tensor
            return np.asarray(x)  # host transfer
        for v in x:               # python loop over a tensor
            x = x + v
        return float(torch.sum(x))  # host sync


    def capture(graph, x):
        with torch.cuda.graph(graph):
            hop(x)
"""

CAPTURE_CLEAN = """
    import numpy as np
    import torch



    # captured by `capture` below; `n` is static by its annotation
    def hop(x, n: int):
        if n > 3:                      # static arg: legal
            x = x + float(n)           # float() of a static: legal
        for _ in range(n):             # loop over static: legal
            x = helper(x, n)
        B, = x.shape                   # .shape is static
        if B > 8:
            x = x[:8]
        return torch.where(x > 0, x, 0.0)

    def helper(x, n):
        w = np.arange(n)               # static arg from call site
        return x * w.sum()


    def capture(graph, x):
        with torch.cuda.graph(graph):
            hop(x, 4)
"""

CAPTURE_CALLEE = """
    import torch
    from repro_torch.kernels import _build

    # launches a csrc library: a kernel root
    def root(x):
        return helper(x, _build.load("k"))

    def helper(y, lib):
        if y.sum() > 0:   # tainted via call-site propagation
            return y
        return -y
"""

SHAPE_BAD = """
    import torch

    def assemble(take):
        wave_cap = 100          # non-pow2 sizing literal
        buf = torch.zeros((48, 4))  # 48 = 1.5*32 half-step: legal
        pad = torch.empty(0)        # empty: legal
        return wave_cap, buf, pad
"""

DTYPE_BAD = """
    import torch

    def distances(vectors, q):
        dists = torch.zeros(8, dtype=torch.float64)  # distance-named f64
        vec16 = vectors.half()                       # distance value f16
        attrs = torch.zeros(8, dtype=torch.float64)  # order keys: legal
        return dists, vec16, attrs
"""

DTYPE_QUANT_BAD = """
    import torch

    def serve(q_vectors, scales, vectors):
        deq_vec = q_vectors.float()              # dequant outside the kernels
        scales = scales.to(torch.float16)        # scales must stay f32
        q_vectors = vectors.to(torch.int8)       # quantization: legal
        q_slab = torch.zeros((4, 4), dtype=torch.bfloat16)  # storage: legal
        return deq_vec, scales, q_vectors, q_slab
"""

INPLACE_BAD = """
    import torch


    # writes `dst` in place (where JAX would donate it)
    def scatter(dst, idx, rows):
        return dst.index_copy_(0, idx, rows)

    def update(buf, idx, rows):
        out = scatter(buf, idx, rows)
        return out + buf          # buf was written in place: stale name

    def update_ok(buf, idx, rows):
        buf = scatter(buf, idx, rows)   # same-statement rebind: safe
        return buf + 1
"""

# (reference fixture, twin, reference pass, port pass); the durability and
# replication fixtures are idiom-neutral: their twin is the same text
TWINS = {
    "jit-purity": ("JIT_PURITY_BAD", CAPTURE_BAD, "jit-purity",
                   "capture-purity"),
    "jit-purity-callee": ("JIT_PURITY_CALLEE", CAPTURE_CALLEE, "jit-purity",
                          "capture-purity"),
    "jit-purity-clean": ("JIT_PURITY_CLEAN", CAPTURE_CLEAN, "jit-purity",
                         "capture-purity"),
    "shape-discipline": ("SHAPE_BAD", SHAPE_BAD, "shape-discipline",
                         "shape-discipline"),
    "dtype-drift": ("DTYPE_BAD", DTYPE_BAD, "dtype-drift", "dtype-drift"),
    "dtype-drift-quant": ("DTYPE_QUANT_BAD", DTYPE_QUANT_BAD, "dtype-drift",
                          "dtype-drift"),
    "donation-safety": ("DONATION_BAD", INPLACE_BAD, "donation-safety",
                        "inplace-safety"),
    "durability-ordering": ("DURABILITY_BAD",
                            ref_fixtures.DURABILITY_BAD,
                            "durability-ordering", "durability-ordering"),
    "replication-ordering": ("REPLICATION_BAD",
                             ref_fixtures.REPLICATION_BAD,
                             "replication-ordering", "replication-ordering"),
}
SEEDED = [k for k in TWINS if k != "jit-purity-clean"]
NEUTRAL = ["SHAPE_BAD", "DTYPE_BAD", "DTYPE_QUANT_BAD", "DURABILITY_BAD",
           "REPLICATION_BAD"]
PORT_PASS = {"SHAPE_BAD": "shape-discipline", "DTYPE_BAD": "dtype-drift",
             "DTYPE_QUANT_BAD": "dtype-drift",
             "DURABILITY_BAD": "durability-ordering",
             "REPLICATION_BAD": "replication-ordering"}


def _fixture(tmp_path, name, code):
    p = tmp_path / name
    p.write_text(textwrap.dedent(code))
    return p


def _lines(findings):
    return sorted(f.line for f in findings)


# ------------------------------------------------------- (a) twin parity
@pytest.mark.parametrize("case", sorted(TWINS))
def test_twin_reports_the_reference_lines(tmp_path, case):
    name, twin, ref_pass, port_pass = TWINS[case]
    ref = ref_lint_paths([_fixture(tmp_path, "ref.py",
                                   getattr(ref_fixtures, name))],
                         passes=[ref_pass])
    got = lint_paths([_fixture(tmp_path, "twin.py", twin)],
                     passes=[port_pass])
    assert _lines(got) == _lines(ref)
    assert {f.pass_name for f in got} <= {port_pass}
    if case != "jit-purity-clean":
        assert got, f"{port_pass} missed its seeded violation"


# --------------------------------- (b) the reference's text, port's engine
@pytest.mark.parametrize("name", NEUTRAL)
def test_port_engine_on_reference_fixture(tmp_path, name):
    p = _fixture(tmp_path, "ref.py", getattr(ref_fixtures, name))
    ref = ref_lint_paths([p], passes=[PORT_PASS[name]])
    got = lint_paths([p], passes=[PORT_PASS[name]])
    assert {(f.pass_name, f.line) for f in got} == \
        {(f.pass_name, f.line) for f in ref}
    assert got


# ------------------------------------------------------------- (c) clean
@pytest.mark.parametrize("code", [CAPTURE_CLEAN,
                                  ref_fixtures.JIT_PURITY_CLEAN],
                         ids=["twin", "reference_text"])
def test_clean_fixture_stays_clean(tmp_path, code):
    assert lint_paths([_fixture(tmp_path, "clean.py", code)],
                      passes=["capture-purity"]) == []


CAPTURE_KINDS = """
    import torch


    def hop(x, idx):
        m = x > 0
        y = x[m]                          # boolean-mask indexing
        n = torch.nonzero(x)              # data-sized output
        h = x.cpu()                       # host transfer
        v = x.sum().item()                # host sync
        z = x if x.sum() > 0 else -x      # ternary on a tensor
        while x.max() > 1:                # while on a tensor
            x = x / 2
        return x[idx], y, n, h, v, z      # integer indexing: legal


    def capture(graph, x, idx):
        with torch.cuda.graph(graph):
            hop(x, idx)
"""


def test_capture_purity_finds_each_violation_kind(tmp_path):
    msgs = " | ".join(f.message for f in lint_paths(
        [_fixture(tmp_path, "kinds.py", CAPTURE_KINDS)],
        passes=["capture-purity"]))
    for kind in ("boolean-mask indexing", "torch.nonzero", ".cpu()",
                 ".item()", "ternary on a tensor", "`while` on a tensor"):
        assert kind in msgs, kind
    assert msgs.count("(in traced `hop`)") == 6


# ---------------------------------------------- (d) suppression, baseline
def test_inline_suppression(tmp_path):
    code = SHAPE_BAD.replace(
        "wave_cap = 100",
        "wave_cap = 100  # wowlint: disable=shape-discipline")
    p = _fixture(tmp_path, "sup.py", code)
    assert lint_paths([p], passes=["shape-discipline"]) == []
    code = CAPTURE_BAD.replace(
        "if x > 0:", "if x > 0:  # wowlint: disable=all")
    left = lint_paths([_fixture(tmp_path, "sup2.py", code)])
    assert _lines(left) == [9, 10, 12]


def test_baseline_filters_accepted_findings(tmp_path):
    p = _fixture(tmp_path, "bad.py", SHAPE_BAD)
    findings = lint_paths([p], passes=["shape-discipline"])
    assert findings
    bl = tmp_path / "baseline.json"
    save_baseline(bl, findings)
    accepted = load_baseline(bl)
    assert all(f.key() in accepted for f in findings)
    assert [f for f in findings if f.key() not in accepted] == []
    assert cli_main(["--fail-on-findings", "--baseline", str(bl),
                     "--pass", "shape-discipline"]) == 0


# ------------------------------------------------- (e), (f) shipped tree
def test_shipped_port_tree_lints_clean():
    assert load_baseline(REPO_ROOT / "wowlint_torch_baseline.json") == set()
    assert lint_repo() == [], "src/repro_torch must lint clean"


def test_no_dead_modules_in_port_surface():
    assert report_dead() == []


# ------------------------------------------------------------- (g) CLI
@pytest.mark.parametrize("case", SEEDED)
def test_cli_exits_1_on_seeded_twin(tmp_path, case, capsys):
    _, twin, _, port_pass = TWINS[case]
    p = str(_fixture(tmp_path, f"{case}.py", twin))
    assert cli_main(["--fail-on-findings", "--pass", port_pass, p]) == 1
    assert port_pass in capsys.readouterr().out
    assert cli_main(["--pass", port_pass, p]) == 0


def test_cli_module_entry_point(tmp_path):
    """``python -m repro_torch.analysis`` in a process of its own exits 1
    on the seeded twins and never imports JAX."""
    paths = [str(_fixture(tmp_path, f"{c}.py", TWINS[c][1]))
             for c in SEEDED]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    code = ("import sys, runpy\n"
            "sys.argv = ['wowlint'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('repro_torch.analysis', "
            "run_name='__main__')\n"
            "finally:\n"
            "    assert 'jax' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code, "--fail-on-findings",
                          *paths], capture_output=True, text=True, env=env,
                         timeout=120)
    assert res.returncode == 1, res.stdout + res.stderr
    n = len(lint_paths([Path(p) for p in paths]))
    assert f"{n} finding(s) in {len(SEEDED)} file(s)" in res.stdout


# ---------------------------------------------- (h), (i) the real tree
LM_KERNELS = ("flash_attention", "rwkv6", "mamba_scan")


def test_real_tree_roots_and_traced_set():
    """The call graph sees the port's real boundaries.  The three LM
    kernel modules are quarantined from the surface; indexed, their
    launch wrappers are roots too."""
    kern = ROOT / "src" / "repro_torch" / "kernels"
    files = surface_files() + [
        load_module_file(kern / f"{m}.py", f"repro_torch.kernels.{m}", ROOT)
        for m in LM_KERNELS]
    idx = RepoIndex(files)
    roots = {f.qualname: f.root_kind for f in idx.functions.values()
             if f.root}
    assert roots["repro_torch.core.device_search:_hop_body"] == "graph"
    wrappers = {"repro_torch.kernels.gather_distance:gather_norm_dot",
                "repro_torch.kernels.distance:batched_dot",
                "repro_torch.kernels.flash_attention:flash_attention",
                "repro_torch.kernels.rwkv6:wkv6",
                "repro_torch.kernels.mamba_scan:mamba_scan"}
    assert {q for q, k in roots.items() if k == "kernel"} == wrappers
    hop = idx.functions["repro_torch.core.device_search:_hop_body"]
    assert hop.static_params == {"cfg"}  # a frozen config; di, st: tensors
    traced = idx.traced_functions()
    for q in ("_hop_body", "_select_candidates", "_merge_sorted", "_eval",
              "_visited_mark"):
        assert f"repro_torch.core.device_search:{q}" in traced
    assert "repro_torch.kernels.ops:gather_norm_dot" in traced
    # the host-side loops must NOT be in the traced set
    assert not any(q.endswith((":warmup", ":_run_hops", ":_run_chunk",
                               ":_drive_chunked")) for q in traced)


def test_planted_host_sync_in_hop_body_is_found(tmp_path):
    """Not vacuous on the real tree: a ``.item()`` planted in a copy of
    ``device_search.py``'s ``_hop_body`` is found, and the copy without
    it is clean."""
    src = (ROOT / "src" / "repro_torch" / "core" /
           "device_search.py").read_text()
    anchor = "    is_seed = st.t == 0\n"
    assert src.count(anchor) == 1
    clean = tmp_path / "device_search.py"
    clean.write_text(src)
    assert lint_paths([clean], passes=["capture-purity"]) == []
    planted = tmp_path / "planted" / "device_search.py"
    planted.parent.mkdir()
    planted.write_text(src.replace(
        anchor, anchor + "    probe = st.res_d.sum().item()\n"))
    line = src[: src.index(anchor)].count("\n") + 2
    found = lint_paths([planted], passes=["capture-purity"])
    assert [(f.line, "_hop_body" in f.message) for f in found] == \
        [(line, True)], found


# -------------------------------------------------------------- refresh
GATE_KW = dict(k=5, width=16, max_wave=8, adaptive=False, visited="bitmap",
               build_backend="numpy")


def _gate_indexes():
    wl = make_workload(n=520, d=12, nq=16, seed=3, k=5, with_gt=False)
    kw = dict(dim=12, m=12, ef_construction=48, o=4, seed=0)
    tidx, jidx = WoWIndex(**kw), rc.WoWIndex(**kw)
    for ix in (tidx, jidx):
        ix.insert_batch(wl.vectors, wl.attrs, batch_size=128,
                        backend="numpy")
    rng = np.random.default_rng(11)
    extra_v = rng.normal(size=(120, 12)).astype(np.float32)
    extra_a = np.arange(120) / 120.0 + float(np.max(wl.attrs)) + 1.0
    return wl, tidx, jidx, extra_v, extra_a


def _set_ptrs(eng):
    return [tuple(t.data_ptr() for t in buf)
            for buf, _ in eng._sets._sets.values()]


def _as_result(replies):
    return SearchResult(
        ids=np.stack([np.asarray(r.ids, np.int64) for r in replies]),
        dists=np.stack([np.asarray(r.dists) for r in replies]),
        dc=np.asarray([r.dc for r in replies]),
        hops=np.asarray([r.hops for r in replies]))


def test_refresh_within_capacity_keeps_buffers_and_matches_jax():
    """The reference's gate scenario through both engines: warm up, serve
    a wave, ingest 120 rows within the pow2 capacities, serve again.  The
    replies agree under the tie rule, and the port's refresh reuses its
    serving set (the same data pointers, so the graphs captured on it at
    warm-up stay valid on the card)."""
    wl, tidx, jidx, extra_v, extra_a = _gate_indexes()
    teng = ServeEngine(index=tidx, config=EngineConfig(**GATE_KW),
                       device="cpu")
    jeng = rl.ServeEngine(index=jidx, config=rl.EngineConfig(**GATE_KW))
    for eng in (teng, jeng):
        eng.warmup()
    ptrs = _set_ptrs(teng)
    assert len(ptrs) == 1

    def serve_wave(eng, base):
        for i in range(8):
            eng.submit(wl.queries[base + i], wl.ranges[base + i])
        replies = sorted(eng.drain(), key=lambda r: r.rid)
        assert len(replies) == 8
        return replies

    got = {id(e): serve_wave(e, 0) for e in (teng, jeng)}
    cap = teng._di.vectors.shape
    for eng in (teng, jeng):
        assert eng.submit_ingest(extra_v, extra_a).accepted == 120
        eng.drain()
    assert len(tidx) == len(jidx) == 640
    for e in (teng, jeng):
        got[id(e)] += serve_wave(e, 8)
    assert teng._di.vectors.shape == cap  # 640 rows: the same capacity
    assert teng._snap.vectors.shape[0] == 640  # ... on a refreshed snapshot
    assert _set_ptrs(teng) == ptrs
    scale = float(2 * (wl.vectors ** 2).sum(1).max())
    a, b = _as_result(got[id(teng)]), _as_result(got[id(jeng)])
    rep = compare_results(a, b, scale=scale)
    assert rep["faults"] == [], rep
    np.testing.assert_array_equal(a.hops, b.hops)
    np.testing.assert_array_equal(a.dc, b.dc)


def test_wave_in_flight_across_refresh_finishes_on_its_snapshot():
    """A wave launched before an ingest's refresh finishes on the snapshot
    it launched with, bitwise ``search_batch`` there, while the wave
    launched after it is bitwise ``search_batch`` on the refreshed one;
    the serving set switches between them by copies into the same
    buffers."""
    wl, tidx, _, extra_v, extra_a = _gate_indexes()
    # short chunks and ingest at every turn: the apply lands while wave A
    # still has hops to run
    eng = ServeEngine(index=tidx, device="cpu", config=EngineConfig(
        **GATE_KW, chunk=(4, 4), ingest_share=1.0))
    eng.warmup()
    ptrs = _set_ptrs(eng)
    snap1 = take_snapshot(tidx)
    tickets_a = [eng.submit(wl.queries[i], wl.ranges[i]) for i in range(8)]
    replies = eng.step()  # wave A: launched, first chunk run
    eng.submit_ingest(extra_v, extra_a)
    replies += eng.step()  # the apply, then wave A's second chunk
    assert eng.pending_ingest == 0 and len(tidx) == 640
    snap2 = take_snapshot(tidx)
    tickets_b = [eng.submit(wl.queries[8 + i], wl.ranges[8 + i])
                 for i in range(8)]
    replies += eng.step()  # wave B: assembled on the refreshed snapshot
    assert eng.stats.waves == 2
    assert len(eng._waves) == 2, "wave A must still be in flight"
    replies += eng.drain()
    assert eng.serving_set_stats()["copies"] >= 2  # A's and B's turns
    assert _set_ptrs(eng) == ptrs
    by_rid = {r.rid: r for r in replies}
    for tickets, snap, base in ((tickets_a, snap1, 0), (tickets_b, snap2, 8)):
        want = search_batch(snap, wl.queries[base:base + 8],
                            wl.ranges[base:base + 8], k=5, width=16,
                            visited="bitmap", device="cpu")
        for i, t in enumerate(tickets):
            r = by_rid[t.rid]
            assert not r.degraded
            ids = np.where(want.ids[i] >= 0,
                           snap.ids_map[np.clip(want.ids[i], 0, None)], -1)
            np.testing.assert_array_equal(r.ids, ids)
            np.testing.assert_array_equal(r.dists, want.dists[i])
            assert (r.hops, r.dc) == (want.hops[i], want.dc[i])
