"""The benchmark's command:

    python -m wowbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  The program builds its kernels under
``build/kernels`` in the checkout (its own default), and the benchmark
keeps the base index it builds under ``build/index`` (``index_cache``).  It runs one cell of ``BENCHMARK.json``
on the CUDA card (``harness.run``) and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number the comparison with the reference held beside its
limit; those numbers are also the last lines of its standard error.

It exits non-zero and prints no result where CUDA is absent or the card
count is below the cell's, and where ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro`` is loaded once the window has closed.  Every build
and kernel cache stays in fixed directories under ``build/`` in the
checkout, so only a checkout's first run builds.
"""
import time

T_PROCESS = time.perf_counter()  # noqa: E402  (set-up starts here)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "cuda_cache"}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _caches() -> None:
    for var, sub in CACHES.items():
        path = ROOT / "build" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m wowbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()

    from . import spec

    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, args.workload)
    cfg = spec.load_config(cell["config"])
    from . import loadgen

    mix = loadgen.load_mix(cell["traffic"])

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"wowbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from . import harness  # puts the program on sys.path

    seed = args.seed % 2**63
    out = harness.run(cell, cfg, mix, bench, seed, args.seconds,
                      bool(args.trace), T_PROCESS)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"wowbench: the run loaded {loaded}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
