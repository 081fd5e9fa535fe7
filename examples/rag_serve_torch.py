"""RAG serving on the PyTorch port: an assigned-arch LM backbone embeds
documents and queries; WoW retrieves the nearest documents whose attribute
(a year) passes the range filter — the paper's medical-QA scenario (§1)
end to end, the port's counterpart of ``examples/rag_serve.py``.

    PYTHONPATH=src python examples/rag_serve_torch.py               # the card
    PYTHONPATH=src python examples/rag_serve_torch.py --device cpu

The model is qwen2-7b reduced to 2 layers and a 128-token vocabulary, with
random weights (``init_params``, a generator seeded 0).  The queries are
served three ways: the host index (``retrieve``), one batched device wave
(``retrieve_batch``) and the request-lifecycle engine (``engine()``).
``main`` returns what it printed.
"""
import argparse
import os
import sys

os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

RANGES = [(1990, 2024), (2010, 2015), (2020, 2020)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serve import LMServer, RagPipeline

    dev = resolve_device(args.device)
    cfg = get_arch("qwen2-7b").reduced(vocab_size=128, num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    server = LMServer(cfg, init_params(cfg, gen, device=dev), max_len=64,
                      device=dev)
    rag = RagPipeline(server, dim=cfg.d_model, m=8, ef_construction=32)
    rng = np.random.default_rng(0)

    # corpus: 120 documents, each tagged with a "year" attribute
    print(f"indexing 120 documents on {dev} (streaming inserts, no "
          "rebuild)...")
    for doc_id in range(120):
        tokens = rng.integers(0, 128, size=24).astype(np.int32)
        year = float(1990 + doc_id % 35)
        rag.add_document(tokens, year, payload=f"doc-{doc_id} ({int(year)})")

    query = rng.integers(0, 128, size=16).astype(np.int32)
    out = {"host": [], "batch": None, "engine": None}
    for lo, hi in RANGES:
        ids, dists, st = rag.retrieve(query, (lo, hi), k=3)
        docs = [rag.docs[i] for i in ids]
        out["host"].append(ids)
        print(f"range [{lo}, {hi}] -> {docs}  (DC={st.dc}, "
              f"filter checks={st.filter_checks})")

    # the same query under every range as one device wave, then through
    # the request-lifecycle engine (same index, knobs and stats)
    toks = np.stack([query] * len(RANGES))
    ranges = np.asarray(RANGES, np.float32)
    ids, dists = rag.retrieve_batch(toks, ranges, k=3)
    out["batch"] = (ids, dists)
    eng = rag.engine(k=3, width=48)
    emb = server.embed(toks)
    tickets = [eng.submit(emb[i], RANGES[i]) for i in range(len(RANGES))]
    replies = {r.rid: r for r in eng.drain()}
    out["engine"] = [replies[t.rid] for t in tickets]
    for (lo, hi), row, r in zip(RANGES, ids, out["engine"]):
        print(f"range [{lo}, {hi}] device wave -> "
              f"{[rag.docs[i] for i in row if i >= 0]}, engine -> "
              f"{[rag.docs[i] for i in r.ids if i >= 0]}")
    out["stats"] = rag.stats()
    print(f"served {out['stats']['served']} requests, p50 "
          f"{out['stats']['p50_ms']:.1f} ms")

    # generation from the same server
    gen_out = server.generate(query[None, :], steps=8)
    out["generated"] = gen_out[0]
    print("generated continuation tokens:", gen_out[0].tolist())
    return out


if __name__ == "__main__":
    main()
