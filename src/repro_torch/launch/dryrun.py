"""Multi-pod dry run (the port of ``repro.launch.dryrun``): plan every
(arch x input shape x mesh) cell on the production mesh, walk one rank's
step and derive the roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-1.6b \\
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape decode_32k --mesh 4x4

Per cell: abstract parameters and caches (the ``meta`` device); the
specs (``parallel.param_shardings``, ``token_sharding``,
``cache_sharding``); then one run of the port's own step on
``FakeTensor``s of rank 0's shapes (nothing computed, nothing
allocated): the train step of ``jit_train_step`` over a ``RankMesh`` of
the mesh's size, or a prefill or decode forward over the rank's rows.
Both compute rank 0's part over ``model`` (tensor and expert
parallelism, ``parallel.tensor_parallel``, as the train step does):
every layer is all-gathered over the FSDP axes only, in bf16, when the
forward reads it (``train_loop.ShardedParams``), and its products run
over the rank's heads, mlp, experts, inner channels or vocab.  Under
``--rules ep_data`` the experts stay on their ``data`` rank (never
gathered) and the tokens travel to them by an all-to-all over ``data``;
the walk cannot read the routing's counts on fake tensors, so it sends
each rank's tokens evenly (``ExpertSplit.sizes``).  A serving forward
routes each rank's rows as part of the whole batch (``models.moe.
routed_over``), as the train step does.  Under ``--tune
seq_parallel_attn`` (or ``opt``) a cell whose query heads do not divide
``model`` attends for rank 0's slice of the query rows and all-gathers
the rows (``models.attention``).  Under ``residual_spec`` (set by
``set_tuning``; ``model`` on the batch or the sequence) the residual
stream is split over ``model`` inside the layer stack, so the record
counts the gathers and reduce-scatters that replace the ``model``
all-reduces and the smaller unit inputs that remat keeps.  A decode or
prefill cache follows
``cache_specs``, the plan's spec of each state: a KV cache holds the
rank's kv heads when they divide ``model``, else under
``cache_seq_shard`` its ``1 / n`` of the slots; the SSM states stay
whole.  Its collectives are real calls on torch's ``fake`` process-group
backend sized to the mesh and its ``model``, ``data`` and FSDP groups
(each returns at once).  The run goes under ``launch.op_cost``;
``launch.roofline`` turns the counts into the H100's terms.

Record keys are the reference's: ``hlo_flops_per_device`` and
``hlo_bytes_per_device`` hold the walk's counts, ``xla_cost_analysis``
is None (no compiler's count exists), and ``compile_s`` is ``trace_s``
(the walk's seconds).  ``memory`` holds the rank's parameter, moment and
cache bytes beside the reference's keys: ``argument_bytes`` (parameters,
moments, caches, inputs), ``temp_bytes`` (the peak of live bytes the step
allocated, gradients included), ``output_bytes`` (what it allocated and
returned), ``alias_bytes`` 0 (the step updates in place) and
``total_bytes = argument_bytes + temp_bytes``.  ``rank_collectives``
holds rank 0's collectives by kind as ``ShardedParams.stats`` counts
them (calls, bytes given and the ring model's wire bytes; ``tp_`` the
``model`` group's, ``ep_`` the experts' all-to-alls and counts over
``data``, ``route_`` the MoE counts).  ``tuning`` states every knob;
``tuning_inert`` names those set that have no effect on the port's step
(``models.tuning.inert_knobs``).  A cell that fails is written as
``error``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time

import torch

from ..configs import all_archs, get_arch
from ..configs.base import ArchConfig
from ..parallel.logical import (
    RULES_DP_ONLY, RULES_EP_DATA, RULES_TP_FSDP, expert_data_leaves,
    param_shardings,
)
from ..parallel.sharding import cache_sharding, token_sharding
from .mesh import AbstractMesh, make_production_mesh
from .roofline import active_param_count, model_flops, roofline_terms

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# target microbatch rows per device for train_4k (activation-memory lever)
MB_ROWS = {
    "jamba-1.5-large-398b": 1,
    "chameleon-34b": 1,
    "qwen3-14b": 1,
    "qwen2-7b": 2,
    "h2o-danube-3-4b": 2,
    "qwen1.5-4b": 2,
    "musicgen-large": 2,
    "qwen2-moe-a2.7b": 4,
    "deepseek-moe-16b": 4,
    "rwkv6-1.6b": 4,
}

BF16_ADAM = {"jamba-1.5-large-398b"}

RULES = {"tp_fsdp": RULES_TP_FSDP, "dp_only": RULES_DP_ONLY,
         "ep_data": RULES_EP_DATA}


def skip_reason(cfg: ArchConfig, shape: str) -> str | None:
    if shape == "long_500k" and not cfg.subquadratic:
        return (
            "full quadratic attention: a 524288-token dense KV at batch 1 is "
            "outside this arch's operating envelope (see DESIGN.md "
            "§Arch-applicability); run for SSM/hybrid/SWA archs only"
        )
    return None


def _dp_size(mesh) -> int:
    return mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)


@contextlib.contextmanager
def _fake_world(mesh):
    """A ``RankMesh`` as rank 0 of ``mesh``, over torch's ``fake``
    process-group backend of the mesh's size (collectives return at
    once); the group is destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..parallel.sharding import RankMesh

    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without an "
                           "initialised torch.distributed group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield RankMesh(tuple(mesh.axes), tuple(mesh.sizes), 0,
                       torch.device("cpu"), dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _inputs(cfg: ArchConfig, batch: int, seq: int):
    if cfg.input_kind == "tokens":
        return torch.zeros((batch, seq), dtype=torch.int32)
    return torch.zeros((batch, seq, cfg.d_model), dtype=torch.bfloat16)


def build_cell(arch: str, shape: str, mesh, rules_name: str = "tp_fsdp",
               microbatches: int | None = None, backend: str = "ref",
               verbose: bool = False) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models.model import abstract_params, init_cache, tree_from_named
    from ..models.model import forward
    from ..models.moe import routed_over
    from ..models.tuning import TUNING, inert_knobs
    from ..train.optimizer import AdamW
    from ..train.train_loop import (
        ShardedParams, jit_train_step, make_train_step,
    )
    from .op_cost import OpCost

    cfg = get_arch(arch)
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape, "skipped": reason}
    info = SHAPES[shape]
    rules = RULES[rules_name]
    seq, batch = info["seq"], info["batch"]

    # per-cell tuning resolution, as the reference resolves it
    saved_seq_axis = TUNING.attn_seq_axis
    TUNING.batch_axes = tuple(
        a for a in ("pod", "data")
        if a in mesh.shape and batch % mesh.shape[a] == 0)
    if TUNING.attn_seq_axis is not None and \
            cfg.num_heads % mesh.shape.get("model", 1) == 0:
        TUNING.attn_seq_axis = None
    tuning = dataclasses.asdict(TUNING)
    inert = inert_knobs()

    t0 = time.time()
    meta = abstract_params(cfg)
    specs = param_shardings(meta, rules, mesh)
    tok_spec = token_sharding(mesh, batch)
    dp = tok_spec[0] if len(tok_spec) else None
    split = (() if dp is None else (dp,) if isinstance(dp, str)
             else tuple(dp))
    rows = batch // math.prod(mesh.shape[a] for a in split)
    chips = mesh.size
    cache_specs = None  # the plan's (the JAX package's) spec of each state
    if info["kind"] != "train":
        from ..models.model import abstract_cache

        plan = cache_sharding(cfg, mesh, batch, seq)(
            abstract_cache(cfg, batch, seq))
        cache_specs = sorted({f"{type(st).__name__}.{f}: {list(sp)}"
                              for st in plan for f, sp in zip(
                                  st._fields, st)})
    mem: dict = {}
    try:
        if expert_data_leaves(specs) and mesh.shape["data"] > 1 and \
                "data" not in split:
            return {"arch": arch, "shape": shape, "skipped": (
                f"experts on data take the batch rows split over data; a "
                f"batch of {batch} does not divide {mesh.shape['data']}")}
        with _fake_world(mesh) as rmesh:
            if info["kind"] == "train":
                dps = _dp_size(mesh)
                if microbatches is None:
                    mbr = MB_ROWS.get(arch, 2)
                    microbatches = max(1, batch // (dps * mbr))
                    while batch % microbatches or \
                            (batch // microbatches) % dps:
                        microbatches -= 1
                opt = AdamW(state_dtype="bfloat16" if arch in BF16_ADAM
                            else "float32")
                block = {n: s for n, s in specs.items()
                         if n.startswith("blocks.")}
                step = make_train_step(cfg, opt, microbatches=microbatches,
                                       backend=backend, grad_shardings=specs,
                                       block_param_specs=block)
                js = jit_train_step(step, rmesh, specs, tok_spec)
                lay = js.sharded.layouts
                lower_s = time.time() - t0
                t1 = time.time()
                with FakeTensorMode():
                    params = tree_from_named({
                        n: torch.empty(lay[n].local)
                        for n, _ in meta.named_parameters()})
                    params.requires_grad_(True)
                    state = opt.init(params)
                    tokens = _inputs(cfg, batch, seq)
                    labels = torch.zeros((batch, seq), dtype=torch.int32)
                    mem["param_bytes"] = _nbytes(params.parameters())
                    mem["moment_bytes"] = _nbytes([*state.m.values(),
                                                   *state.v.values()])
                    mem["cache_bytes"] = 0
                    mem["input_bytes"] = _nbytes([tokens, labels])
                    with OpCost(chips) as oc:
                        js(params, state, tokens, labels)
                    out_bytes = 0
                stats = js.stats
            else:
                sp = ShardedParams(cfg, rmesh, specs, split)
                lay = sp.layouts
                tp = sp.model_split()
                lower_s = time.time() - t0
                t1 = time.time()
                with FakeTensorMode(), torch.no_grad():
                    named = {n: torch.empty(lay[n].local)
                             for n, _ in meta.named_parameters()}
                    mem["param_bytes"] = _nbytes(named.values())
                    mem["moment_bytes"] = 0
                    if info["kind"] == "prefill":
                        inp = _inputs(cfg, rows, seq)
                        args = dict(mode="prefill", cache_len=seq,
                                    last_only=True)
                        mem["cache_bytes"] = 0  # made by the step
                    else:
                        inp = _inputs(cfg, rows, 1)
                        caches = init_cache(cfg, rows, seq, device="cpu",
                                            tp=tp)
                        mem["cache_bytes"] = _nbytes(
                            t for st in caches for t in st)
                        args = dict(mode="decode", caches=caches,
                                    pos=torch.zeros(rows, dtype=torch.int32),
                                    cache_len=seq)
                    mem["input_bytes"] = _nbytes([inp])
                    with OpCost(chips) as oc, routed_over(sp.route):
                        if info["kind"] == "prefill":  # made by the step
                            args["caches"] = init_cache(cfg, rows, seq,
                                                        device="cpu", tp=tp)
                        result = forward(sp.tree(named), cfg, inp,
                                         backend=backend, tp=tp, **args)
                        if info["kind"] == "decode":
                            result = result[0][:, -1].argmax(-1)
                    out_bytes = oc.live
                    del result
                stats = sp.stats
            trace_s = time.time() - t1
    finally:
        TUNING.attn_seq_axis = saved_seq_axis

    rec_c = oc.record()
    flops = rec_c["flops_per_device"]
    bytes_acc = rec_c["bytes_per_device"]
    terms = roofline_terms(flops, bytes_acc,
                           rec_c["coll_wire_bytes_per_device"], chips,
                           per_device=True, group=rec_c["coll_max_group"])
    tokens_n = seq * batch if info["kind"] in ("train", "prefill") else batch
    mf = model_flops(cfg, tokens_n,
                     "train" if info["kind"] == "train" else "infer")
    flops_all = flops * chips
    args_bytes = (mem["param_bytes"] + mem["moment_bytes"]
                  + mem["cache_bytes"] + mem["input_bytes"])
    rec = {
        "arch": arch,
        "shape": shape,
        "mesh": dict(mesh.shape),
        "chips": chips,
        "rules": rules_name,
        "microbatches": microbatches if info["kind"] == "train" else None,
        "params_active": active_param_count(cfg),
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": bytes_acc,
        "xla_cost_analysis": None,
        "collectives": {
            "wire_bytes_per_chip": rec_c["coll_wire_bytes_per_device"],
            "by_op": rec_c["coll_by_op"],
            "max_group": rec_c["coll_max_group"],
        },
        "terms": terms,
        "model_flops": mf,
        "useful_flops_ratio": (mf / flops_all) if flops_all else None,
        "memory": {
            **mem,
            "argument_bytes": args_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": rec_c["peak_live_bytes"],
            "alias_bytes": 0,
            "total_bytes": args_bytes + rec_c["peak_live_bytes"],
        },
        "op_cost": {k: rec_c[k] for k in ("ops", "repeats")},
        "rank_collectives": {k: v for k, v in sorted(stats.items())
                             if not k.endswith("_s")},
        "token_spec": list(tok_spec),
        "cache_specs": cache_specs,
        "rows_per_rank": rows,
        "tuning": tuning,
        "tuning_inert": inert,
        "lower_s": round(lower_s, 2),
        "trace_s": round(trace_s, 2),
    }
    if verbose:
        print(json.dumps(rec["memory"]))
        print(json.dumps({k: rec[k] for k in (
            "hlo_flops_per_device", "hlo_bytes_per_device", "collectives")}))
    return rec


def fmt_row(r: dict) -> str:
    if r.get("skipped"):
        return f"{r['arch']:>24s} {r['shape']:>12s}  SKIP ({r['skipped'][:60]}...)"
    t = r["terms"]
    return (
        f"{r['arch']:>24s} {r['shape']:>12s}  "
        f"comp={t['compute_s']:.3e}s mem={t['memory_s']:.3e}s "
        f"coll={t['collective_s']:.3e}s  dom={t['bottleneck'][:-2]:<10s} "
        f"ratio={r['useful_flops_ratio'] and round(r['useful_flops_ratio'], 3)} "
        f"dev_mem={(r['memory']['total_bytes'])/2**30:.1f}GiB "
        f"trace={r['trace_s']:.0f}s"
        + (f"  inert={','.join(r['tuning_inert'])}"
           if r.get("tuning_inert") else "")
    )


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    help='"single" (16 x 16), "multi" (2 x 16 x 16) or a '
                         '(data, model) mesh "DxM", e.g. "4x4"')
    ap.add_argument("--rules", default="tp_fsdp", choices=list(RULES))
    ap.add_argument("--mb", type=int, default=None, help="microbatch override")
    ap.add_argument("--all", action="store_true", help="every arch x shape")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument(
        "--tune", default="",
        help="comma presets: blocked_attn,bf16_reduce,dense_attn,f32_reduce",
    )
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    args = ap.parse_args(argv)
    if args.tune:
        from ..models.tuning import apply_preset

        apply_preset(args.tune)

    if args.mesh in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"))
    else:
        mesh = AbstractMesh(("data", "model"), tuple(
            int(n) for n in args.mesh.split("x")))
    archs = all_archs() if args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    if not args.all and args.arch is None:
        archs = archs[:1]

    os.makedirs(os.path.join(args.out, args.mesh), exist_ok=True)
    recs = []
    for arch in archs:
        for shape in shapes:
            try:
                rec = build_cell(arch, shape, mesh, args.rules, args.mb,
                                 verbose=not args.all)
            except Exception as e:  # a failure here is a sharding bug
                rec = {"arch": arch, "shape": shape,
                       "error": f"{type(e).__name__}: {e}"}
                print(f"{arch:>24s} {shape:>12s}  ERROR {rec['error'][:140]}",
                      flush=True)
            tag = f"{arch}__{shape}" + (
                "" if args.rules == "tp_fsdp" else f"__{args.rules}"
            ) + (f"__{args.tag}" if args.tag else "")
            path = os.path.join(args.out, args.mesh, tag + ".json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if not rec.get("error"):
                print(fmt_row(rec), flush=True)
            recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
