"""Sequence-parallel attention and the split decode cache on the CPU: three
gloo ranks (``tests/_torch_ranks.py``) as a ``(data 1, model 3)`` mesh
running the reduced qwen2-7b of ``tests/test_torch_tp_mesh.py`` (2 layers,
d 32, 4 q heads and 2 kv heads, neither dividing 3; vocab 64), from the
JAX init values, at f32 compute, beside one JAX subprocess with 3 host
devices.

  * (ii) The mesh train step under ``seq_parallel_attn`` (2 steps of 2
    microbatches, ``RULES_TP_FSDP``) at T = 18, split 6/6/6: against JAX's
    step jitted over a ``(1, 3)`` host mesh under the same preset, each
    step's loss within 2e-5 and grad norm within 1e-4 relative, every
    gradient leaf within 2e-5 relative L2.  At T = 16 (split 6/6/4, as
    GSPMD pads) against the port's step on one rank, with the same bars:
    the numbers do not depend on the split.  No parameter is gathered
    (the FSDP group has one rank) and the rows are all-gathered over
    ``model``.
  * (iii) A prefill of 9 tokens into a 12-slot cache and 3 decode steps
    under ``cache_seq_shard``, alone and with ``seq_parallel_attn``
    (``opt``'s pair): every step's logits within 1e-5 of max |logit| of
    JAX's unsharded ``forward``; each rank's KV caches hold 4 of the 12
    slots, the shape ``parallel.cache_sharding``'s spec gives.  Where the
    q heads split and the kv heads do not (6 and 2 heads on the three
    ranks), the q heads are gathered for the merge: the logits within
    1e-5 of max |logit| of JAX's unsharded forward of that config.
  * (iv) At T = 16 under ``seq_parallel_attn`` with the residual stream's
    sequence split over ``model`` too (``residual_spec = (None, "model",
    None)``, rows 6/6/4): the attention runs whole on the gathered rows,
    and the step matches the port's one-rank step with (ii)'s bars.
  * (v) An MoE leaf whose experts do not divide ``model`` and whose mlp
    does, under ``RULES_TP_FSDP``: Jamba's reduced step (one 8-layer
    unit, 16 experts of mlp 48, the rest whole over a 3-way ``model``)
    against JAX's ``(1, 3)`` step, from the same weights (the port's
    ``init_params``, seeded): one step at (ii)'s bars (after an update
    the Mamba leaves, whole over ``model`` here, sit 2-3e-5 from an f64
    step in either package); each rank runs its 16 of every expert's 48
    mlp columns.

JAX is imported inside the fixture and the subprocesses.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_ranks import _mesh_cfg, mesh_train, run_ranks, seq_parallel
from test_torch_train_mesh import _batch, _flat, rel_l2

HERE = Path(__file__).resolve().parent
STEPS = 2
SERVE = dict(prompt=9, cache_len=12, decode=3)
TUNES = ("cache_seq_shard", "seq_parallel_attn,cache_seq_shard")

JAX_SEQ = r"""
import functools, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.models.model as mm
from repro.configs import get_arch
from repro.models import init_params
from repro.models.layers import split_tree
from repro.models.tuning import apply_preset
from repro.parallel.logical import RULES_TP_FSDP, param_shardings
from repro.train import AdamW, make_train_step
from repro.train.optimizer import AdamWState

inp, outp, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
prompt, cache_len, decode = (int(a) for a in sys.argv[4:7])
data = np.load(inp)
def reduced(heads):
    return get_arch("qwen2-7b").reduced(
        num_layers=2, vocab_size=64, d_model=32, d_ff=64, num_heads=heads,
        num_kv_heads=2, head_dim=16)
cfg = reduced(4)
params = init_params(jax.random.PRNGKey(0), cfg)
values, _ = split_tree(params)
out = {}
# the unsharded serving forward, before any preset, at 4 and 6 q heads
tok = jnp.asarray(data["tokens"])
kw = dict(backend="ref", compute_dtype=jnp.float32, cache_len=cache_len)
for heads, tag in ((4, "serve"), (6, "serve6")):
    c = reduced(heads)
    vals, _ = split_tree(init_params(jax.random.PRNGKey(0), c))
    caches = mm.init_cache(c, tok.shape[0], cache_len, jnp.float32)
    lg, caches, _ = mm.forward(vals, c, tok[:, :prompt], mode="prefill",
                               caches=caches, last_only=True, **kw)
    out[f"{tag}/0"] = np.asarray(lg[:, -1])
    for i in range(decode):
        pos = jnp.full((tok.shape[0],), prompt + i, jnp.int32)
        lg, caches, _ = mm.forward(vals, c, tok[:, prompt + i:prompt + i + 1],
                                   mode="decode", caches=caches, pos=pos,
                                   **kw)
        out[f"{tag}/{i + 1}"] = np.asarray(lg[:, -1])

apply_preset("seq_parallel_attn")

class Cap(AdamW):
    def update(self, grads, state, params):
        v, s, om = AdamW.update(self, grads, state, params)
        return v, s, {**om, "grads": grads}

mesh = jax.make_mesh((1, 3), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
mm.forward = functools.partial(mm.forward, compute_dtype=jnp.float32)
_, shardings = param_shardings(params, RULES_TP_FSDP, mesh)
opt_sh = AdamWState(step=NamedSharding(mesh, P()), m=shardings, v=shardings)
tok_sh = NamedSharding(mesh, P("data"))
opt = Cap(lr=1e-3, warmup=0)
jstep = jax.jit(make_train_step(cfg, opt, microbatches=2),
                in_shardings=(shardings, opt_sh, tok_sh, tok_sh))
v, s = values, opt.init(values)
with jax.set_mesh(mesh):  # the preset's pins name the mesh's axes
    for i in range(steps):
        v, s = jax.device_put(v, shardings), jax.device_put(s, opt_sh)
        v, s, m = jstep(v, s, jnp.asarray(data["tokens"]),
                        jnp.asarray(data["labels"]))
        out[f"{i}/loss"] = np.asarray(m["loss"])
        out[f"{i}/grad_norm"] = np.asarray(m["grad_norm"])
        for path, g in jax.tree_util.tree_flatten_with_path(m["grads"])[0]:
            out[f"{i}/grads" + jax.tree_util.keystr(path)] = np.asarray(g)
np.savez(outp, **out)
print("OK jax (1, 3) seq-parallel steps and the unsharded forward")
"""


JAX_MOE = r"""
import dataclasses, functools, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.models.model as mm
from repro.configs import get_arch
from repro.models import init_params
from repro.parallel.logical import RULES_TP_FSDP, param_shardings
from repro.train import AdamW, make_train_step
from repro.train.optimizer import AdamWState

inp, outp, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
experts, mlp = int(sys.argv[4]), int(sys.argv[5])
data = np.load(inp)
cfg = get_arch("jamba-1.5-large-398b").reduced(
    num_layers=8, vocab_size=64, d_model=32, d_ff=64, num_heads=4,
    num_kv_heads=2, head_dim=16)
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, capacity_factor=1.0, num_experts=experts, d_ff_expert=mlp))
values = {}
for k in data.files:
    if k.startswith("values/"):
        node, parts = values, k.split("/")[1:]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(data[k])

class Cap(AdamW):
    def update(self, grads, state, params):
        v, s, om = AdamW.update(self, grads, state, params)
        return v, s, {**om, "grads": grads}

mesh = jax.make_mesh((1, 3), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
mm.forward = functools.partial(mm.forward, compute_dtype=jnp.float32)
params = jax.eval_shape(lambda k: init_params(k, cfg), jax.random.PRNGKey(0))
_, shardings = param_shardings(params, RULES_TP_FSDP, mesh)
opt_sh = AdamWState(step=NamedSharding(mesh, P()), m=shardings, v=shardings)
tok_sh = NamedSharding(mesh, P("data"))
opt = Cap(lr=1e-3, warmup=0)
jstep = jax.jit(make_train_step(cfg, opt, microbatches=2),
                in_shardings=(shardings, opt_sh, tok_sh, tok_sh))
v, s = values, opt.init(values)
out = {}
for i in range(steps):
    v, s = jax.device_put(v, shardings), jax.device_put(s, opt_sh)
    v, s, m = jstep(v, s, jnp.asarray(data["tokens"]),
                    jnp.asarray(data["labels"]))
    out[f"{i}/loss"] = np.asarray(m["loss"])
    out[f"{i}/grad_norm"] = np.asarray(m["grad_norm"])
    for path, g in jax.tree_util.tree_flatten_with_path(m["grads"])[0]:
        out[f"{i}/grads" + jax.tree_util.keystr(path)] = np.asarray(g)
np.savez(outp, **out)
print("OK jax (1, 3) Jamba steps")
"""
MOE = dict(num_experts=16, d_ff_expert=48)  # (v): experts whole, mlp split
# (v) takes one step: after an update, Jamba's Mamba leaves (whole over
# model here) lie 2-3e-5 from an f64 step in either package, at the bar
MOE_STEPS = 1


def _moe_inputs(path: Path) -> None:
    """(v)'s inputs: the reduced Jamba's weights (``_mesh_cfg`` with
    MOE; the port's ``init_params``, generator seed 0) in the JAX value
    tree's layout, and the batch at T = 18."""
    import torch

    from repro_torch.models import init_params, to_jax_values

    cfg = _mesh_cfg("jamba-1.5-large-398b", MOE)
    values = to_jax_values(cfg, init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    tok, lab = _batch(T=18)
    np.savez(path, tokens=tok, labels=lab, **{
        "values" + k.replace("']['", "/").replace("['", "/").replace(
            "']", ""): v for k, v in _flat(values).items()})


def _seq_inputs(path: Path) -> None:
    """The JAX init values of the reduced qwen2-7b (``values``) and of its
    6-q-head variant (``values6``), a batch at T = 18 and one at T = 16
    (``_b``)."""
    import jax

    from repro.configs import get_arch as jax_arch
    from repro.models import init_params as jax_init
    from repro.models.layers import split_tree

    arrays = {}
    for heads, tag in ((4, "values"), (6, "values6")):
        jcfg = jax_arch("qwen2-7b").reduced(
            num_layers=2, vocab_size=64, d_model=32, d_ff=64,
            num_heads=heads, num_kv_heads=2, head_dim=16)
        values, _ = split_tree(jax_init(jax.random.PRNGKey(0), jcfg))
        arrays.update({tag + k.replace("']['", "/").replace(
            "['", "/").replace("']", ""): v for k, v in _flat(jax.tree.map(
                np.asarray, values)).items()})
    tok, lab = _batch(T=18)
    tok_b, lab_b = _batch(seed=2, T=16)
    np.savez(path, tokens=tok, labels=lab, tokens_b=tok_b, labels_b=lab_b,
             **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the three ranks' results, JAX's arrays, the one-rank port step at
    T = 16)."""
    tmp = tmp_path_factory.mktemp("seq")
    inp, moe_inp = tmp / "inputs.npz", tmp / "moe.npz"
    _seq_inputs(inp)
    _moe_inputs(moe_inp)
    outp, moe_out = tmp / "jax.npz", tmp / "jax_moe.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=3", PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), str(HERE)]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, *args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for script, args in (
            (JAX_SEQ, [str(inp), str(outp), str(STEPS), *(
                str(SERVE[k]) for k in ("prompt", "cache_len", "decode"))]),
            (JAX_MOE, [str(moe_inp), str(moe_out), str(MOE_STEPS),
                       str(MOE["num_experts"]), str(MOE["d_ff_expert"])]))]
    try:
        ranks = run_ranks(seq_parallel, 3, tmp, str(inp),
                          str(tmp / "ckpt"), STEPS,
                          dict(SERVE, tunes=list(TUNES)), str(moe_inp), MOE,
                          MOE_STEPS)
        one = mesh_train(str(inp), str(tmp / "one"), (1, 1), STEPS,
                         "qwen2-7b", ("f32",), token_key="_b")["f32"]
        for proc in procs:
            so, se = proc.communicate(timeout=400)
            assert proc.returncode == 0, so + se
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    want = dict(np.load(outp))
    want.update({f"moe/{k}": v for k, v in np.load(moe_out).items()})
    return ranks, want, one


def _close(run: dict, want: dict) -> None:
    """A step run against ``want`` ({"{i}/loss", "{i}/grad_norm",
    "{i}/grads..."}): the 2 x 2 test's f32 bars."""
    for i, step in enumerate(run["runs"]):
        m = step["metrics"]
        assert abs(m["loss"] - float(want[f"{i}/loss"])) <= 2e-5, (i, m)
        wn = float(want[f"{i}/grad_norm"])
        assert abs(m["grad_norm"] - wn) / wn <= 1e-4, (i, m, wn)
        got = _flat(step["grads"])
        assert {f"{i}/grads{k}" for k in got} == {
            k for k in want if k.startswith(f"{i}/grads")}
        for k, g in got.items():
            assert rel_l2(want[f"{i}/grads{k}"], g) <= 2e-5, (i, k)


def _one_rank(one: dict) -> dict:
    """The one-rank step's runs as ``_close``'s ``want``."""
    want = {}
    for i, step in enumerate(one["runs"]):
        want[f"{i}/loss"] = step["metrics"]["loss"]
        want[f"{i}/grad_norm"] = step["metrics"]["grad_norm"]
        want.update({f"{i}/grads{k}": g
                     for k, g in _flat(step["grads"]).items()})
    return want


@pytest.mark.parametrize("key", ["", "_b"])
def test_1x3_seq_parallel_step(runs, key):
    """(ii): T = 18 against JAX's (1, 3) step under ``seq_parallel_attn``;
    T = 16 (a shorter last slice) against the port's one-rank step.  Every
    rank reports the same metrics, gathers no parameter and all-gathers
    the attention rows over ``model``."""
    ranks, jax_out, one = runs
    if key:
        want = _one_rank(one)
    else:
        want = {k: v for k, v in jax_out.items()
                if not k.startswith("moe/")}
    r0 = ranks[0]["train"][key]
    _close(r0, want)
    for r in ranks:
        run = r["train"][key]
        assert [x["metrics"] for x in run["runs"]] == \
            [x["metrics"] for x in r0["runs"]]
        for step in run["runs"]:
            st = step["stats"]
            assert st.get("gather_n", 0) == 0, st
            assert st["tp_gather_n"] > 0, st


def test_1x3_seq_parallel_with_residual_split(runs):
    """(iv): the step at T = 16 under ``seq_parallel_attn`` with the
    residual stream's sequence split over ``model`` against the port's
    one-rank step; every rank reports the same metrics and gathers the
    rows over ``model``."""
    ranks, _, one = runs
    r0 = ranks[0]["train"]["_b_rows"]
    _close(r0, _one_rank(one))
    for r in ranks:
        run = r["train"]["_b_rows"]
        assert [x["metrics"] for x in run["runs"]] == \
            [x["metrics"] for x in r0["runs"]]
        for step in run["runs"]:  # nothing else splits over 3: no
            assert step["stats"]["tp_gather_n"] > 0  # reduce-scatter


def test_1x3_moe_mlp_split_matches_jax(runs):
    """(v): the reduced Jamba with 16 experts, which do not divide 3,
    and their mlp of 48, which does: each rank's compute layout holds
    every expert's 16 mlp columns, and the step matches JAX's (1, 3)
    step with (ii)'s bars; every rank reports the same metrics."""
    assert len(runs[0][0]["moe"]["runs"]) == MOE_STEPS
    ranks, jax_out, _ = runs
    want = {k[len("moe/"):]: v for k, v in jax_out.items()
            if k.startswith("moe/")}
    r0 = ranks[0]["moe"]
    _close(r0, want)
    for r in ranks:
        assert [x["metrics"] for x in r["moe"]["runs"]] == \
            [x["metrics"] for x in r0["runs"]]
        shapes = {n: list(s) for n, s in r["moe"]["compute_shapes"].items()
                  if ".moe.w" in n}
        E, cols, d = MOE["num_experts"], MOE["d_ff_expert"] // 3, 32
        assert shapes and all(
            s == ([E, cols, d] if n.endswith(".wo") else [E, d, cols])
            for n, s in shapes.items()), shapes


@pytest.mark.parametrize("tune", TUNES)
def test_split_cache_decode_matches_jax(runs, tune):
    """(iii): the prefill's and each decode step's logits against JAX's
    unsharded forward; each rank's KV caches hold ``cache_len / 3`` slots,
    the local shape of ``cache_sharding``'s spec."""
    ranks, want, _ = runs
    S = SERVE["cache_len"]
    for r in ranks:
        got = r["serve"][tune]
        for i, lg in enumerate(got["logits"]):
            ref = want[f"serve/{i}"]
            scale = float(np.abs(ref).max())
            assert float(np.abs(lg - ref).max()) <= 1e-5 * scale, (tune, i)
        sizes = {"data": 1, "model": 3}
        for shape, spec in zip(got["cache_shapes"], got["cache_specs"]):
            assert spec[1] == "model", spec
            full = [shape[0], S, *shape[2:]]
            local = [n // math.prod(sizes[a] for a in (
                () if ax is None else (ax,) if isinstance(ax, str) else ax))
                for n, ax in zip(full, list(spec) + [None] * 4)]
            assert shape == local and shape[1] == S // 3, (shape, spec)
        assert got["stats"]["tp_all_reduce_max_n"] > 0, got["stats"]


def test_split_cache_with_q_heads_split(runs):
    """(iii) where the q heads split over ``model`` and the kv heads do not
    (module docstring): 4 of the 12 slots a rank, the logits of every
    step within 1e-5 of max |logit| of JAX's unsharded forward of the
    6-q-head config."""
    ranks, want, _ = runs
    for r in ranks:
        h = r["heads"]
        assert h["q_split"]
        assert all(s[1] == SERVE["cache_len"] // 3 for s in h["cache_shapes"])
        for i, lg in enumerate(h["logits"]):
            ref = want[f"serve6/{i}"]
            scale = float(np.abs(ref).max())
            assert float(np.abs(lg - ref).max()) <= 1e-5 * scale, i


CACHE_CELLS = [  # (arch, mesh sizes (data, model), batch, seq)
    ("qwen2-7b", (16, 16), 128, 32768),     # rows split: slots on model
    ("qwen2-7b", (2, 8), 3, 4096),          # rows whole: no split
    ("h2o-danube-3-4b", (16, 16), 1, 524288),   # a ring, rows whole
    ("h2o-danube-3-4b", (4, 16), 8, 32768),     # a ring split on model
    ("jamba-1.5-large-398b", (16, 16), 1, 524288),
    ("qwen3-14b", (16, 16), 128, 32768),    # kv heads divide model
]


@pytest.mark.parametrize("cache_seq_shard", [True, False])
@pytest.mark.parametrize("cell", CACHE_CELLS, ids=lambda c: f"{c[0]}-"
                         f"{c[1][0]}x{c[1][1]}-b{c[2]}")
def test_cache_split_follows_cache_sharding(cell, cache_seq_shard):
    """Each KV cache of ``init_cache(tp=)`` splits its slots and heads over
    ``model`` exactly where ``parallel.cache_sharding``'s spec puts
    ``model`` (rank 0 of the mesh on meta tensors, the rows its share of
    the batch).  The one listed departure: where the rows are not split
    (the batch does not divide ``data``), the spec may put the slots on
    ``data``, and the port keeps them whole on every rank."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.attention import KVCache
    from repro_torch.models.model import (
        abstract_cache, abstract_params, init_cache,
    )
    from repro_torch.models.tuning import TUNING
    from repro_torch.parallel import (
        RULES_TP_FSDP, cache_sharding, param_shardings, token_sharding,
    )
    from repro_torch.train.train_loop import ShardedParams

    arch, sizes, batch, seq = cell
    cfg = get_arch(arch)
    mesh = AbstractMesh(("data", "model"), sizes)
    dp = token_sharding(mesh, batch)[0]
    split = () if dp is None else (dp,) if isinstance(dp, str) else dp
    rows = batch // (sizes[0] if split else 1)
    saved = dataclasses.asdict(TUNING)
    TUNING.cache_seq_shard = cache_seq_shard
    try:
        specs = param_shardings(abstract_params(cfg), RULES_TP_FSDP, mesh)
        plan = cache_sharding(cfg, mesh, batch, seq)(
            abstract_cache(cfg, batch, seq))
        with dryrun._fake_world(mesh) as rmesh:
            tp = ShardedParams(cfg, rmesh, specs, split).model_split()
        caches = init_cache(cfg, rows, seq, torch.float32, device="meta",
                            tp=tp)
    finally:
        for k, v in saved.items():
            setattr(TUNING, k, v)
    kv = [(c, s) for c, s in zip(caches, plan) if isinstance(c, KVCache)]
    assert kv
    for cache, spec in kv:
        _, s_ax, h_ax, _ = spec.k
        full_s = min(seq, cfg.sliding_window or seq)
        on = [() if a is None else (a,) if isinstance(a, str) else a
              for a in (s_ax, h_ax)]
        want_s = full_s // (sizes[1] if "model" in on[0] else 1)
        want_h = cfg.num_kv_heads // (sizes[1] if "model" in on[1] else 1)
        assert tuple(cache.k.shape) == (rows, want_s, want_h,
                                        cfg.resolved_head_dim), (spec, cache)
        if "data" in on[0]:
            assert not split, spec
