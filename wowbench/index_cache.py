"""The base index of a configuration, built once in a checkout and loaded
by every later run.

The first run of a configuration in a checkout builds the index over the
base rows (``data.make_base``) with ``WoWIndex.insert_batch(...,
backend="device")`` at the configuration's micro-batch and writes it with
the program's own checkpoint (``WoWIndex.checkpoint``) under
``build/index/<config>-<key>/``.  Every run, that first one too, then
serves an index loaded from there by the program's cold-start path
(``repro_torch.persist.checkpoint.load``).  ``key`` digests the
configuration file and the program's sources, so a changed configuration
or program builds anew; the directory is otherwise fixed, so later runs
find it.  The build runs in a process of its own
(``python -m wowbench.index_cache``), so that the run that measures
starts from the same state whether or not it found the index; it is
staged in a directory of its own and renamed into place only once
written whole.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

from . import data, spec

CACHE_DIR = spec.ROOT / "build" / "index"
PROGRAM = spec.ROOT / "src" / "repro_torch"


def key(cfg: dict) -> str:
    """A digest of the configuration and of the program's sources."""
    h = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
    for p in sorted(PROGRAM.rglob("*")):
        if p.suffix in (".py", ".cu", ".cuh", ".h"):
            h.update(str(p.relative_to(PROGRAM)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(cfg: dict, root: Path, device) -> float:
    """Build the base index over the configuration's base rows and
    checkpoint it to ``root``; returns the build's seconds."""
    from repro_torch.core.index import WoWIndex

    base = data.make_base(cfg["n"], cfg["d"], cfg["data_seed"], device)
    ix = cfg["index"]
    idx = WoWIndex(dim=cfg["d"], m=ix["m"], ef_construction=ix["ef_construction"],
                   o=ix["o"], metric=cfg["metric"], seed=cfg["data_seed"],
                   vec_dtype=ix["vec_dtype"], device=device)
    t = time.perf_counter()
    idx.insert_batch(base.vectors.cpu().numpy(), base.attrs.cpu().numpy(),
                     batch_size=ix["build_batch"], backend="device")
    seconds = time.perf_counter() - t
    stage = root.with_name(f"{root.name}.stage{os.getpid()}")
    shutil.rmtree(stage, ignore_errors=True)
    idx.checkpoint(str(stage), incremental=False)
    (stage / "build.json").write_text(json.dumps(
        {"rows": len(idx), "build_s": seconds}))
    try:
        stage.rename(root)
    except OSError:  # another process put it in place first
        shutil.rmtree(stage, ignore_errors=True)
    return seconds


def load(cfg: dict, device, cache_dir: Path | None = None):
    """The configuration's base index, built first (in a child process)
    where the checkout has none -> (index, seconds spent building, or
    0)."""
    from repro_torch.persist import checkpoint

    root = Path(cache_dir or CACHE_DIR) / f"{cfg['name']}-{key(cfg)}"
    built = 0.0
    if not (root / "build.json").is_file():
        root.parent.mkdir(parents=True, exist_ok=True)
        t = time.perf_counter()
        subprocess.run([sys.executable, "-m", "wowbench.index_cache",
                        "--config", json.dumps(cfg), "--root", str(root),
                        "--device", str(device)],
                       cwd=spec.ROOT, check=True)
        built = time.perf_counter() - t
    return checkpoint.load(str(root), device=device), built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m wowbench.index_cache")
    ap.add_argument("--config", required=True, help="the configuration, JSON")
    ap.add_argument("--root", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(spec.ROOT / "src"))  # the program under test
    if args.device == "cpu":
        import torch

        torch.set_num_threads(2)
    build(json.loads(args.config), Path(args.root), args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
