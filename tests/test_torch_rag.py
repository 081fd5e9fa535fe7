"""The port's ``RagPipeline`` (``repro_torch.serve.engine``) against the
JAX package's, on the CPU.

With one stub server for both pipelines (its ``embed`` is a lookup in one
seeded numpy table, so both indexes receive identical vectors) the host
builds are equal: ``add_documents`` ids and ``IngestResult`` fields,
``retrieve`` results and ``stats()`` counters are equal, and
``retrieve_batch`` follows ``compare_results``' tie rule, before and after
an ingest (the lazy incremental snapshot refresh), with the adaptive hash
filter too.  With the real reduced qwen2 (``from_jax_params``), the
replies of ``engine()`` equal ``retrieve_batch``'s bit for bit and new
documents become visible after ``add_documents``.  The durable branch
(``index_dir``) raises and names ROADMAP A6.  The port's example runs at
its reduced size.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import LMServer as JaxLMServer
from repro.serve.engine import RagPipeline as JaxRagPipeline
from repro_torch.core.device_search import SearchResult, compare_results
from repro_torch.models import from_jax_params
from repro_torch.serve import LMServer, RagPipeline

from test_torch_models import noisy_values, reduced_cfgs

ROOT = Path(__file__).resolve().parents[1]
DIM, VOCAB = 16, 400
COUNTS = ("submitted", "admitted", "served", "degraded", "expired",
          "ingest", "docs", "index_size")


class StubServer:
    """An ``LMServer`` stand-in: the embedding of a token row is the row
    of one seeded table picked by its first token."""

    device = torch.device("cpu")

    def __init__(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.table = rng.standard_normal((VOCAB, DIM)).astype(np.float32)

    def embed(self, tokens):
        return self.table[np.asarray(tokens)[:, 0]]


def _docs(lo: int, n: int, seed: int):
    """``n`` documents whose first token is lo.. (distinct embeddings),
    with year attributes in 1990-2024 as in the example."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, size=(n, 12)).astype(np.int32)
    toks[:, 0] = np.arange(lo, lo + n)
    years = 1990.0 + np.arange(lo, lo + n) % 35
    return toks, years


def _queries(seed: int, B: int = 24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, size=(B, 6)).astype(np.int32)
    lo = rng.integers(1990, 2025, size=B)
    span = rng.choice([0, 2, 10, 40], size=B)
    ranges = np.stack([lo, np.minimum(lo + span, 2030)], 1).astype(np.float32)
    return toks, ranges


def _same_ingest(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (a.accepted, a.rejected, a.lsn, a.pending) == \
        (b.accepted, b.rejected, b.lsn, b.pending)


def _tie_rule(got, want):
    zeros = np.zeros(len(got[0]), np.int64)
    rep = compare_results(SearchResult(got[0], got[1], zeros, zeros),
                          SearchResult(want[0], want[1], zeros, zeros),
                          scale=float(2 * DIM * 16))
    assert rep["faults"] == [] and len(rep["tie_flips"]) <= 1, rep


@pytest.mark.parametrize("visited,adaptive,compact", [
    ("bitmap", False, None), ("hash", True, (8, 8))],
    ids=["bitmap", "hash-adaptive-compact"])
def test_pipeline_matches_jax(visited, adaptive, compact):
    server = StubServer()
    kw = dict(dim=DIM, m=8, ef_construction=32, visited=visited,
              visited_adaptive=adaptive, compact=compact)
    tp, jp = RagPipeline(server, **kw), JaxRagPipeline(server, **kw)
    toks, years = _docs(0, 200, seed=1)
    years[7] = np.nan  # rejected row by row, in both
    a, b = tp.add_documents(toks, years, batch_size=64), \
        jp.add_documents(toks, years, batch_size=64)
    _same_ingest(a, b)
    assert a.accepted == 199 and a.rejected == [(7, "non-finite attribute")]
    assert tp.add_document(*(x[0] for x in _docs(200, 1, seed=2))) == \
        jp.add_document(*(x[0] for x in _docs(200, 1, seed=2)))

    qt, qr = _queries(3)
    for i in range(4):
        ti, td, ts = tp.retrieve(qt[i], tuple(qr[i]), k=5)
        ji, jd, js = jp.retrieve(qt[i], tuple(qr[i]), k=5)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
        assert (ts.dc, ts.hops) == (js.dc, js.hops)
    for _ in range(2):  # the second batch reads the adaptive hop log
        _tie_rule(tp.retrieve_batch(qt, qr, k=5, width=32),
                  jp.retrieve_batch(qt, qr, k=5, width=32))
    # ingest while serving: the next batch refreshes the snapshot
    toks2, years2 = _docs(201, 100, seed=4)
    _same_ingest(tp.add_documents(toks2, years2),
                 jp.add_documents(toks2, years2))
    got = tp.retrieve_batch(qt, qr, k=5, width=32)
    _tie_rule(got, jp.retrieve_batch(qt, qr, k=5, width=32))
    assert (got[0] >= 201).any()  # new documents are served
    ts, js = tp.stats(), jp.stats()
    assert {k: ts[k] for k in COUNTS} == {k: js[k] for k in COUNTS}
    assert ts["served"] == 3 * len(qt) and ts["index_size"] == 300


@pytest.fixture(scope="module")
def qwen():
    cfg, tcfg = reduced_cfgs("qwen2-7b")
    vals = noisy_values(cfg, seed=2)
    return cfg, tcfg, vals


def test_engine_equals_retrieve_batch_on_reduced_qwen2(qwen):
    """The real reduced qwen2 embeds; ``engine()`` (the request lifecycle
    over the same index, knobs and stats) replies bitwise what
    ``retrieve_batch`` answers, before and after ``add_documents``, and
    the ingested documents are served."""
    cfg, tcfg, vals = qwen
    server = LMServer(tcfg, from_jax_params(tcfg, vals, device="cpu"),
                      max_len=32, device="cpu")
    rag = RagPipeline(server, dim=tcfg.d_model, m=8, ef_construction=32)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tcfg.vocab_size, (96, 12)).astype(np.int32)
    years = 1990.0 + np.arange(96) % 35
    rag.add_documents(toks, years)
    qt = rng.integers(0, tcfg.vocab_size, (20, 6)).astype(np.int32)
    lo = rng.integers(1990, 2020, 20)
    qr = np.stack([lo, lo + rng.choice([0, 4, 34], 20)], 1).astype(np.float32)

    def both(qt, qr):
        ids, dists = rag.retrieve_batch(qt, qr, k=5, width=32)
        eng = rag.engine(k=5, width=32, max_wave=8, adaptive=False)
        emb = server.embed(qt)
        tickets = [eng.submit(emb[i], qr[i]) for i in range(len(qt))]
        replies = {r.rid: r for r in eng.drain()}
        for i, t in enumerate(tickets):
            r = replies[t.rid]
            assert not r.degraded
            np.testing.assert_array_equal(r.ids, ids[i])
            np.testing.assert_array_equal(r.dists, dists[i])
        return ids, eng

    both(qt, qr)
    served = rag.stats()["served"]
    assert served == 2 * len(qt)  # the engine shares the pipeline's stats
    new = rng.integers(0, tcfg.vocab_size, (16, 12)).astype(np.int32)
    res = rag.add_documents(new, np.full(16, 2030.0))
    assert res.accepted == 16 and (np.asarray(res) >= 96).all()
    ids, _ = both(qt[:4], np.asarray([[2030.0, 2030.0]] * 4, np.float32))
    assert ((ids >= 96) | (ids == -1)).all() and (ids >= 96).any()
    # JAX's pipeline on the same weights embeds the same vectors
    jserver = JaxLMServer(cfg, jax.tree.map(jnp.asarray, vals), max_len=32)
    np.testing.assert_allclose(server.embed(qt), jserver.embed(qt),
                               atol=1e-6)


def test_durable_branch_names_a6():
    server = StubServer()
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        RagPipeline(server, dim=DIM, index_dir="somewhere")
    rag = RagPipeline(server, dim=DIM)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        rag.checkpoint()
    with pytest.raises(ValueError, match="vec_dtype"):
        RagPipeline(server, dim=DIM, vec_dtype="fp8")


def test_example_runs_on_cpu():
    """``examples/rag_serve_torch.py --device cpu``: the host, batched and
    engine retrievals agree and every answer lies in its range."""
    spec = importlib.util.spec_from_file_location(
        "rag_serve_torch", ROOT / "examples" / "rag_serve_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu"])
    ids, _ = out["batch"]
    for row, r, host in zip(ids, out["engine"], out["host"]):
        np.testing.assert_array_equal(r.ids, row)
        assert not r.degraded
        assert set(host.tolist()) == set(row[row >= 0].tolist())
    assert out["stats"]["served"] == 6 and out["stats"]["docs"] == 120
    assert out["generated"].shape == (8,)
