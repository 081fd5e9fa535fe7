"""Atomic, shard-aware, async train checkpoints (the port of
``repro.train.checkpoint``, with its on-disk layout).

Layout::

    <dir>/step_000000123/
        shard_00000.npz      flattened {path -> array} for this host's leaves
        MANIFEST.json        step, host count, leaf paths, written last

Shards and manifest are written into ``step_N.tmp``, fsynced, and the
directory is ``os.rename``d: a reader never sees a partial checkpoint, and
``latest_step`` takes the largest complete directory.  Leaf paths are the
JAX package's: dict keys, sequence indices and NamedTuple fields as
``.name`` (``params/blocks/l0/attn/wq``, ``opt/.m/embed``, ``opt/.step``),
so a checkpoint written by either package restores in the other.  A
tree's leaves are torch tensors (bf16 written as f32, which restores into
bf16 exactly), numpy arrays or numbers.  ``AsyncCheckpointer`` copies the
tensors to the host at ``save`` and writes them on a thread of its own
(numpy leaves are taken as they are, as the JAX package takes them: the
caller hands them over); ``wait()`` joins it.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree):
    """(key, child) pairs of a tree node in the JAX flattening's order, or
    None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _leaves(tree, prefix: str = ""):
    """(path, leaf) pairs, paths joined with '/' as the JAX package's
    ``_flatten`` joins them."""
    items = _items(tree)
    if items is None:
        yield prefix, tree
        return
    for k, child in items:
        yield from _leaves(child, f"{prefix}/{k}" if prefix else k)


def _to_host(leaf) -> np.ndarray:
    """A tensor as a host copy that nothing else aliases (bf16 as f32);
    anything else as ``np.asarray`` gives it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.cpu() if t.device.type != "cpu" else t.clone()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {k: _to_host(v) for k, v in _leaves(tree)}


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    items = _items(tree)
    if items is None:
        return next(leaves)
    vals = [_unflatten(c, leaves) for _, c in items]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), vals))
    if _is_namedtuple(tree):
        return type(tree)(*vals)
    return type(tree)(vals)


def save(ckpt_dir: str, step: int, tree: Any, process_index: int = 0,
         num_processes: int = 1) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if os.path.exists(os.path.join(final, "MANIFEST.json")):
        return final  # idempotent: this step is already published
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    with open(os.path.join(tmp, f"shard_{process_index:05d}.npz"),
              "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    if process_index == 0:
        manifest = {"step": step, "num_processes": num_processes,
                    "keys": sorted(flat.keys())}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(n[5:]) for n in os.listdir(ckpt_dir)
             if n.startswith("step_") and not n.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, n, "MANIFEST.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``, whose leaves give shape and
    dtype: a torch tensor (any device, ``meta`` too) comes back as a CPU
    tensor of its dtype, anything else with ``shape``/``dtype`` as a numpy
    array."""
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    flat: dict[str, np.ndarray] = {}
    for p in range(manifest["num_processes"]):
        path = os.path.join(d, f"shard_{p:05d}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                flat.update({k: z[k] for k in z.files})
    missing = set(manifest["keys"]) - set(flat)
    if missing:
        raise FileNotFoundError(
            f"checkpoint {d} missing leaves: {sorted(missing)[:5]}")
    out = []
    for key, leaf in _leaves(like):
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                             f"expected {tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            out.append(torch.from_numpy(np.array(arr)).to(leaf.dtype))
        else:
            out.append(arr.astype(leaf.dtype))
    return _unflatten(like, iter(out))


class AsyncCheckpointer:
    """Background writer; keeps at most ``keep`` checkpoints.  A failed
    write is raised by the next ``save`` or by ``wait``."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Exception | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree = item
            try:
                save(self.ckpt_dir, step, host_tree)
                self._gc()
            except Exception as e:  # surfaced on next save/wait
                self._err = e

    def _gc(self):
        steps = sorted(int(n[5:]) for n in os.listdir(self.ckpt_dir)
                       if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def save(self, step: int, tree: Any) -> None:
        if self._err:
            raise self._err
        self._q.put((step, _flatten(tree)))  # fetched to the host now

    def wait(self) -> None:
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise self._err
