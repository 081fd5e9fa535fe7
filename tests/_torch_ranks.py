"""Run a function on N ``torch.distributed`` ranks for the port's
distributed tests: spawned processes on the CPU, joined by gloo over a
``FileStore`` under the test's ``tmp_path`` (no TCP port), one thread each.

The rank functions below import only ``repro_torch`` (the children never
load JAX) and return plain data for the parent to compare.
"""
from __future__ import annotations

import hashlib
import multiprocessing as mp
import queue
import traceback


def _entry(fn, rank: int, world: int, store_path: str, args, out) -> None:
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        try:
            res = fn(*args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:  # the parent reports it
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 240.0):
    """``fn(*args)`` on ranks 0..world-1 -> their results in rank order;
    a rank that raises fails the caller with its traceback."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = str(tmp_path / f"store-{fn.__name__}-{world}")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, store, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            try:
                rank, ok, res = out.get(timeout=timeout)
            except queue.Empty:
                raise AssertionError(f"{fn.__name__}: a rank hung") from None
            if not ok:
                raise AssertionError(f"{fn.__name__} rank {rank}:\n{res}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


def arena_digest(arena) -> str:
    """sha256 over the bytes of an arena's device buffers."""
    import torch

    h = hashlib.sha256()
    for t in (arena.vectors, arena.q_scales, arena.sq_norms, arena.attrs,
              arena.neighbors):
        if t is not None:
            h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def graph_of(idx) -> dict:
    """What the parent compares of an index: adjacency, degree counts,
    ``state_digest``."""
    from repro_torch.persist import state_digest

    return {"layers": [a.copy() for a in idx.graph.layers],
            "counts": [c.copy() for c in idx.graph.counts],
            "digest": state_digest(idx)}


def sharded_build(vectors, attrs, bs: int, kw: dict, vec_dtype: str,
                  shards: int | None = None) -> dict:
    """One rank's ``insert_batch(backend="sharded")`` on the CPU, in
    micro-batch calls of ``bs`` (the fresh vertices of each call are
    returned for the window-invariant checks)."""
    import torch.distributed as dist

    from repro_torch.core import WoWIndex

    idx = WoWIndex(dim=vectors.shape[1], vec_dtype=vec_dtype, device="cpu",
                   **kw)
    vids = []
    for s in range(0, len(attrs), bs):
        vids.append(idx.insert_batch(vectors[s:s + bs], attrs[s:s + bs],
                                     batch_size=bs, backend="sharded",
                                     shards=shards))
    arena = idx._arena
    return {"rank": dist.get_rank(), "num_shards": arena.num_shards,
            "arena": arena_digest(arena), "stats": dict(arena.stats),
            "vids": vids, **graph_of(idx)}


def mesh_error(shards: int) -> str:
    """The ``ValueError`` of a build mesh whose size is not the world
    size ("" if none was raised)."""
    from repro_torch.parallel import build_mesh

    try:
        build_mesh(shards, device="cpu")
    except ValueError as e:
        return str(e)
    return ""


def serve_waves(snap, queries, ranges, data: int, model: int,
                kw: dict) -> dict:
    """Two waves of ``make_serving_fn`` on a ``(data, model)`` mesh of
    this world's ranks: each wave's result, the histogram and the visited
    filter's size after each."""
    from repro_torch.core.distributed import make_serving_fn
    from repro_torch.parallel import serving_mesh

    mesh = serving_mesh(data, model, device="cpu")
    fn = make_serving_fn(mesh, snap, **kw)
    waves, bits = [], []
    for _ in range(2):
        waves.append(tuple(fn(queries, ranges)))
        bits.append(fn.state["bits"])
    return {"coord": (mesh.coord("data"), mesh.coord("model")),
            "waves": waves, "bits": bits, "hist": fn.state["hist"].copy()}


def two_ranks(builds: list, err_shards: int) -> dict:
    """The two-rank cases in one spawn: each sharded build of ``builds``
    (argument tuples of ``sharded_build``), and the world-size error."""
    return {"builds": [sharded_build(*b) for b in builds],
            "error": mesh_error(err_shards)}


def four_ranks(build: tuple, serve: tuple) -> dict:
    """The four-rank cases in one spawn: a sharded build at 4 shards and
    the serving function on a 2 x 2 mesh."""
    return {"build": sharded_build(*build), "serve": serve_waves(*serve)}


def train_ranks(g_all, e_all, steps: int, ws, xs) -> dict:
    """The training collectives on four ranks in one spawn: this rank's
    shared-scale int8 payload and ``compressed_psum`` of its row of
    ``g_all``/``e_all``; the running mean of ``steps`` error-feedback
    reductions of that row; and ``make_gpipe`` over a 1-D ``pod`` mesh of
    every rank (stage s = rank s, ``tanh(x @ w)``) and over a 2 x 2
    ``(pod, data)`` mesh (two stages a column)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.parallel import build_mesh, serving_mesh
    from repro_torch.train.compress import compressed_psum, shared_quantize
    from repro_torch.train.pipeline import make_gpipe

    rank = dist.get_rank()
    g = torch.from_numpy(g_all[rank])
    e = torch.from_numpy(e_all[rank])
    q, scale, _ = shared_quantize(g, e)
    out, new_e = compressed_psum({"w": g}, {"w": e})
    err = {"w": torch.zeros_like(g)}
    acc = torch.zeros_like(g)
    for _ in range(steps):
        mean, err = compressed_psum({"w": g}, err)
        acc += mean["w"]
    def stage(w, x):
        return torch.tanh(x @ w)

    mesh = build_mesh(dist.get_world_size(), axis="pod", device="cpu")
    got = make_gpipe(mesh, stage, "pod")(torch.from_numpy(ws),
                                         torch.from_numpy(xs))
    # a 2 x 2 (pod, data) mesh: each data column runs its own two stages
    grid = serving_mesh(2, 2, device="cpu")
    grid = dataclasses.replace(grid, axes=("pod", "data"))
    got2 = make_gpipe(grid, stage, "pod")(torch.from_numpy(ws[:2]),
                                          torch.from_numpy(xs))
    return {"q": q.numpy(), "scale": float(scale), "out": out["w"].numpy(),
            "new_e": new_e["w"].numpy(), "ef_mean": (acc / steps).numpy(),
            "gpipe": got.numpy(), "gpipe_2x2": got2.numpy()}


def mesh_train(inputs_path: str, ckpt_dir: str, shape: tuple,
               steps: int, arch: str = "qwen2-7b",
               dts: tuple = ("f32", "bf16"), rules: str = "tp_fsdp",
               tune="", token_key: str = "", moe: dict | None = None
               ) -> dict:
    """The mesh train step on this world's ranks as a ``shape`` ``(data,
    model)`` mesh, from the JAX init values and batch in ``inputs_path``
    (``_mesh_cfg(arch)``; ``token_key`` names another batch there), 2
    microbatches, at each compute dtype of ``dts`` (the f32 forward by a
    partial of ``models.model.forward``, as the JAX side does it), under
    the rule set ``rules`` and the tuning presets ``tune`` (or a dict
    of knobs for ``set_tuning``): each step's
    loss and grad norm, every gradient leaf gathered to its JAX layout,
    the rank's resident bytes against the specs' share, the names in its
    gather buckets; after the f32 run rank 0 writes ``jax_state`` of the
    gathered state to ``ckpt_dir`` at step ``steps``.  ``moe``: MoE
    fields that replace ``_mesh_cfg``'s."""
    import functools
    import math

    import numpy as np
    import torch

    import dataclasses

    import repro_torch.models.model as mm
    from repro_torch.launch.dryrun import RULES
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import from_jax_params
    from repro_torch.models.tuning import (
        TUNING, Tuning, apply_preset, set_tuning,
    )
    from repro_torch.parallel import param_shardings, token_sharding
    from repro_torch.train import AdamW, make_train_step, jit_train_step
    from repro_torch.train import save
    from repro_torch.train.train_loop import jax_state

    data = np.load(inputs_path)
    values: dict = {}
    for k in data.files:
        if k.startswith("values/"):
            node = values
            parts = k.split("/")[1:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[k]
    tokens = torch.from_numpy(data[f"tokens{token_key}"])
    labels = torch.from_numpy(data[f"labels{token_key}"])
    cfg = _mesh_cfg(arch, moe)
    grads_seen: list = []

    class Capture(AdamW):
        def update(self, grads, state, params, decay, norm=None):
            grads_seen.append({k: g.clone() for k, g in grads.items()})
            return AdamW.update(self, grads, state, params, decay, norm=norm)

    mesh = make_host_mesh(shape, ("data", "model"), device="cpu")
    forward = mm.forward
    out = {}
    saved = dataclasses.asdict(TUNING)
    set_tuning(**tune) if isinstance(tune, dict) else apply_preset(tune)
    try:
        for dt in dts:
            mm.forward = (functools.partial(forward,
                                            compute_dtype=torch.float32)
                          if dt == "f32" else forward)
            params = from_jax_params(cfg, values, device="cpu")
            params.requires_grad_(True)
            opt = Capture(lr=1e-3, warmup=0)
            specs = param_shardings(params, RULES[rules], mesh)
            blocks = {n: s for n, s in specs.items()
                      if n.startswith("blocks.")}
            step = make_train_step(cfg, opt, microbatches=2,
                                   grad_shardings=specs,
                                   block_param_specs=blocks)
            js = jit_train_step(step, mesh, specs,
                                token_sharding(mesh, tokens.shape[0]))
            state = opt.init(params)
            runs = []
            for _ in range(steps):
                grads_seen.clear()
                params, state, m = js(params, state, tokens, labels)
                stats = dict(js.stats)  # the step's, before this gather
                full = js.sharded.gather(grads_seen[0])
                runs.append({"metrics": {k: float(v) for k, v in m.items()},
                             "grads": mm.to_jax_values(cfg, full),
                             "stats": stats})
            share = sum(math.prod(lay.local) * 4 for lay in
                        js.sharded.layouts.values())
            res = {"runs": runs, "resident": js.sharded.resident_bytes(
                params, state), "share": 3 * share,
                   "compute_shapes": {n: lay.shape for n, lay in
                                      js.sharded.compute_layouts.items()},
                   "bucket_names": sorted(
                       n for b in [js.sharded.top, *js.sharded.layer_buckets]
                       for n in b.names),
                   "expert_leaves": sorted(js.sharded.expert_leaves),
                   "local_shapes": {n: lay.local for n, lay in
                                    js.sharded.layouts.items()}}
            if dt == "f32":
                fp, fst = js.sharded.full_state(params, state)
                if mesh.rank == 0:
                    save(ckpt_dir, steps, jax_state(cfg, fp, fst))
                res["values"] = mm.to_jax_values(cfg, fp)
            out[dt] = res
    finally:
        mm.forward = forward
        for k, v in saved.items():
            setattr(TUNING, k, v)
    return out


def tp_mesh_train(cases: list, shape: tuple, steps: int) -> dict:
    """``mesh_train`` at f32 compute for each ``(arch, inputs_path,
    ckpt_dir)`` of ``cases`` on this world's ranks as a ``shape`` mesh, in
    one spawn -> ``{arch: its result}``."""
    return {arch: mesh_train(inp, ckpt, shape, steps, arch, ("f32",))
            for arch, inp, ckpt in cases}


def _mesh_cfg(arch: str = "qwen2-7b", moe: dict | None = None):
    """The reduced qwen2-7b of the JAX package's sharded-step test, or
    ``arch`` cut the same way (Jamba to one 8-layer scan unit); an MoE's
    capacity factor is 1.0, so that a microbatch's busier experts drop
    tokens, and ``moe`` replaces more of its fields."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    cfg = cfg.reduced(
        num_layers=max(2, cfg.scan_unit), vocab_size=64, d_model=32,
        d_ff=64, num_heads=4, num_kv_heads=2, head_dim=16)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0, **(moe or {})))
    return cfg


def ep_data_train(inputs_path: str, ckpt_dir: str, steps: int) -> dict:
    """The 2 x 2 step of the reduced qwen2-moe-a2.7b under
    ``RULES_EP_DATA`` and the ``moe_ep_data`` preset at f32 compute."""
    return mesh_train(inputs_path, ckpt_dir, (2, 2), steps,
                      "qwen2-moe-a2.7b", ("f32",), rules="ep_data",
                      tune="moe_ep_data")


def seq_parallel(inputs_path: str, ckpt_dir: str, steps: int,
                 serve: dict, moe_path: str, moe: dict,
                 moe_steps: int) -> dict:
    """On three ranks as a ``(data 1, model 3)`` mesh: the reduced
    qwen2-7b's step under ``seq_parallel_attn`` on the batch at T
    divisible by 3 and on the one at T % 3 != 0 (``_b``), the latter
    again with the residual stream's sequence split over ``model``
    (``residual_spec``), the serving forward of ``serve_split`` under
    each of ``serve``'s preset lists, and under ``cache_seq_shard`` with
    6 q heads, which split over ``model`` while the 2 kv heads do not;
    then ``moe_steps`` of Jamba's step (one 8-layer unit, its MoE fields
    ``moe``, from the values in ``moe_path``) without a preset."""
    train = {key: mesh_train(inputs_path, ckpt_dir + key, (1, 3), steps,
                             "qwen2-7b", ("f32",), tune="seq_parallel_attn",
                             token_key=key)["f32"]
             for key in ("", "_b")}
    train["_b_rows"] = mesh_train(
        inputs_path, ckpt_dir + "_rows", (1, 3), steps, "qwen2-7b",
        ("f32",), tune={"attn_seq_axis": "model",
                        "residual_spec": (None, "model", None)},
        token_key="_b")["f32"]
    tunes = serve.pop("tunes")
    return {"train": train,
            "serve": {tune: serve_split(inputs_path, tune, **serve)
                      for tune in tunes},
            "heads": serve_split(inputs_path, "cache_seq_shard", heads=6,
                                 **serve),
            "moe": mesh_train(moe_path, ckpt_dir + "_moe", (1, 3),
                              moe_steps, "jamba-1.5-large-398b", ("f32",),
                              moe=moe)["f32"]}


def residual_split(cases: list, serves: list) -> dict:
    """On two ranks as a ``(data 1, model 2)`` mesh: ``mesh_train`` at
    f32 compute for each ``(tag, arch, inputs_path, residual_spec or
    None, token_key)`` of ``cases``, and ``serve_split`` for each ``(tag,
    arch, inputs_path, residual_spec, prompt, cache_len, decode)`` of
    ``serves`` -> ``{"train": {tag: runs}, "serve": {tag: result}}``."""
    train = {}
    for tag, arch, inp, spec, key in cases:
        tune = "" if spec is None else {"residual_spec": spec}
        train[tag] = mesh_train(inp, inp + tag, (1, 2), 2, arch, ("f32",),
                                tune=tune, token_key=key)["f32"]["runs"]
    serve = {tag: serve_split(inp, {"residual_spec": spec}, prompt,
                              cache_len, decode, arch=arch)
             for tag, arch, inp, spec, prompt, cache_len, decode in serves}
    return {"train": train, "serve": serve}


def serve_split(inputs_path: str, tune, prompt: int, cache_len: int,
                decode: int, heads: int = 4, arch: str = "qwen2-7b"
                ) -> dict:
    """The reduced ``arch``'s (``_mesh_cfg``) serving forward on this
    world's ranks as a ``(data 1, model n)`` mesh under the presets
    ``tune`` (or a dict of knobs for ``set_tuning``), at f32 compute: a
    prefill of the first ``prompt`` tokens of the batch in
    ``inputs_path`` into a ``cache_len``-slot cache, then ``decode``
    steps fed the batch's next tokens -> every step's logits (gathered
    over ``model`` where the vocab splits), each KV cache's shape and its
    spec by ``parallel.cache_sharding``, and whether the first attention
    layer's ``wq`` splits.  ``heads``: the q heads (the JAX init values
    ``values/``, or ``values{heads}/`` for another count)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import from_jax_params
    from repro_torch.models.model import (
        abstract_cache, forward, init_cache, named_tensors,
    )
    from repro_torch.models.tuning import TUNING, apply_preset, set_tuning
    from repro_torch.parallel import (
        RULES_TP_FSDP, cache_sharding, param_shardings, token_sharding,
    )
    from repro_torch.train.train_loop import ShardedParams

    data = np.load(inputs_path)
    tag = "values/" if heads == 4 else f"values{heads}/"
    values: dict = {}
    for k in data.files:
        if k.startswith(tag):
            node = values
            parts = k.split("/")[1:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[k]
    tokens = torch.from_numpy(data["tokens"])
    cfg = dataclasses.replace(_mesh_cfg(arch), num_heads=heads)
    mesh = make_host_mesh((1, dist.get_world_size()), ("data", "model"),
                          device="cpu")
    saved = dataclasses.asdict(TUNING)
    set_tuning(**tune) if isinstance(tune, dict) else apply_preset(tune)
    try:
        params = from_jax_params(cfg, values, device="cpu")
        specs = param_shardings(params, RULES_TP_FSDP, mesh)
        B = tokens.shape[0]
        sp = ShardedParams(cfg, mesh, specs,
                           (token_sharding(mesh, B)[0],))
        sp.shard(params)
        tp = sp.model_split()
        tree = sp.tree(named_tensors(params))
        caches = init_cache(cfg, B, cache_len, torch.float32, device="cpu",
                            tp=tp)
        shapes = [list(c.k.shape) for c in caches if hasattr(c, "k")]
        specs_c = [list(c.k) for c in cache_sharding(
            cfg, mesh, B, cache_len)(abstract_cache(cfg, B, cache_len))
            if hasattr(c, "k")]
        kw = dict(cache_len=cache_len, backend="ref",
                  compute_dtype=torch.float32, tp=tp)

        def whole(lg):
            lg = lg[:, -1]
            return (tp.all_gather(lg, -1) if lg.shape[-1] < cfg.vocab_size
                    else lg).numpy()

        with torch.no_grad():
            logits, caches, _ = forward(tree, cfg, tokens[:, :prompt],
                                        mode="prefill", caches=caches,
                                        last_only=True, **kw)
            steps = [whole(logits)]
            for i in range(decode):
                pos = torch.full((B,), prompt + i, dtype=torch.int32)
                logits, caches, _ = forward(
                    tree, cfg, tokens[:, prompt + i:prompt + i + 1],
                    mode="decode", caches=caches, pos=pos, **kw)
                steps.append(whole(logits))
    finally:
        for k, v in saved.items():
            setattr(TUNING, k, v)
    return {"logits": steps, "cache_shapes": shapes, "cache_specs": specs_c,
            "stats": dict(sp.stats),
            "q_split": next((sp.parts[n] is not None for n in sp.parts
                             if n.endswith(".attn.wq")), False)}
