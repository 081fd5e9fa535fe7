"""``residual_spec`` on the CPU: the residual stream split over ``model``
inside the layer stack (``models.model.forward``) on two gloo ranks
(``tests/_torch_ranks.py``) as a ``(data 1, model 2)`` mesh under
``RULES_TP_FSDP``, against JAX's step jitted over a ``(1, 2)`` host mesh
under ``set_tuning(residual_spec=...)`` (a subprocess with 2 host
devices, run beside the ranks; the pin needs ``jax.set_mesh``), both
from the same weights (the port's ``init_params``, seeded).

  * The reduced qwen2-7b, qwen2-moe-a2.7b, rwkv6-1.6b and Jamba (one
    8-layer unit) of ``tests/test_torch_tp_mesh.py`` under
    ``(("data", "model"), None, None)``: the 4 rows of a microbatch split
    2/2 over ``model``; qwen2-7b and rwkv6 under ``(None, "model",
    None)`` at T = 17, split 9/8, so RWKV's token shift reads a row of
    the other rank; qwen2-7b at a batch of 6, 3 rows a microbatch split
    2/1.  Each: 2 steps of 2 microbatches at f32 compute, each step's
    loss within 2e-5 and grad norm within 1e-4 relative of JAX's, every
    gradient leaf within 2e-5 relative L2 (the bars of
    ``test_1x2_ranks_match_jax_mesh_step``; where JAX's own leaf lies
    farther than that from the unsharded step at f64, the port's is held
    nearer the f64 step than JAX's).
  * A prefill of 9 tokens into a 12-slot cache and 3 decode steps of
    qwen2-7b under both specs (under the sequence split the prefill's
    rows split 5/4, and a decode's one row lies on rank 0 while rank 1
    holds none): every step's logits within 1e-5 of max |logit| of JAX's
    unsharded ``forward``.
  * The ``model`` group's wire bytes a rank (``MeshTrainStep.stats``,
    ``tp_*_wire``, the ring model) of qwen2-7b's step under the batch
    split: no more than without the knob plus what the split adds at
    f32 compute: the rematerialised forward's gather of a unit's rows
    (the untuned recompute's ``copy`` moves nothing) and the norm
    scales' gradient all-reduces (d f32 each), once a unit or norm and
    microbatch.

JAX is imported inside the fixture and the subprocess.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_ranks import _mesh_cfg, residual_split, run_ranks
from test_torch_train_mesh import _batch, _flat, rel_l2

HERE = Path(__file__).resolve().parent
STEPS = 2
JAMBA = "jamba-1.5-large-398b"
ROWS = (("data", "model"), None, None)
SEQ = (None, "model", None)
CASES = [  # tag, arch, residual_spec, batch key (T 16 x 8 rows)
    ("qwen2", "qwen2-7b", ROWS, ""),
    ("moe", "qwen2-moe-a2.7b", ROWS, ""),
    ("rwkv", "rwkv6-1.6b", ROWS, ""),
    ("jamba", JAMBA, ROWS, ""),
    ("qwen2_seq", "qwen2-7b", SEQ, "_t"),      # T 17
    ("rwkv_seq", "rwkv6-1.6b", SEQ, "_t"),
    ("qwen2_uneven", "qwen2-7b", ROWS, "_u"),  # 6 rows
]
SERVES = [("qwen2", "qwen2-7b", ROWS), ("qwen2_seq", "qwen2-7b", SEQ)]
SERVE = dict(prompt=9, cache_len=12, decode=3)

JAX_RES = r"""
import dataclasses, functools, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.models.model as mm
from repro.configs import get_arch
from repro.models import init_params
from repro.models.tuning import set_tuning
from repro.parallel.logical import RULES_TP_FSDP, param_shardings
from repro.train import AdamW, make_train_step
from repro.train.optimizer import AdamWState

outp, base = sys.argv[1], sys.argv[2]
cases, serves = json.loads(sys.argv[3]), json.loads(sys.argv[4])
prompt, cache_len, decode = (int(a) for a in sys.argv[5:8])

def spec_of(spec):
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)

def reduced(arch):
    cfg = get_arch(arch).reduced(
        num_layers=max(2, get_arch(arch).scan_unit), vocab_size=64,
        d_model=32, d_ff=64, num_heads=4, num_kv_heads=2, head_dim=16)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
    return cfg

def load_values(arch):
    data = np.load(f"{base}.{arch}.npz")
    tree = {}
    for k in data.files:
        if k.startswith("values/"):
            node, parts = tree, k.split("/")[1:]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(data[k])
    return tree

values = {arch: load_values(arch) for arch in dict.fromkeys(
    [c[1] for c in cases] + [s[1] for s in serves])}

out = {}
# the unsharded serving forward, before the knob
kw = dict(backend="ref", compute_dtype=jnp.float32, cache_len=cache_len)
for arch in dict.fromkeys(s[1] for s in serves):
    cfg = reduced(arch)
    tok = jnp.asarray(np.load(f"{base}.{arch}.npz")["tokens"])
    caches = mm.init_cache(cfg, tok.shape[0], cache_len, jnp.float32)
    lg, caches, _ = mm.forward(values[arch], cfg, tok[:, :prompt],
                               mode="prefill", caches=caches,
                               last_only=True, **kw)
    out[f"serve/{arch}/0"] = np.asarray(lg[:, -1])
    for i in range(decode):
        pos = jnp.full((tok.shape[0],), prompt + i, jnp.int32)
        lg, caches, _ = mm.forward(values[arch], cfg,
                                   tok[:, prompt + i:prompt + i + 1],
                                   mode="decode", caches=caches, pos=pos,
                                   **kw)
        out[f"serve/{arch}/{i + 1}"] = np.asarray(lg[:, -1])

class Cap(AdamW):
    def update(self, grads, state, params):
        v, s, om = AdamW.update(self, grads, state, params)
        return v, s, {**om, "grads": grads}

mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
mm.forward = functools.partial(mm.forward, compute_dtype=jnp.float32)
for tag, arch, spec, key in cases:
    set_tuning(residual_spec=spec_of(spec))
    data = np.load(f"{base}.{arch}.npz")
    cfg = reduced(arch)
    params = jax.eval_shape(lambda k: init_params(k, cfg),
                            jax.random.PRNGKey(0))
    _, shardings = param_shardings(params, RULES_TP_FSDP, mesh)
    opt_sh = AdamWState(step=NamedSharding(mesh, P()), m=shardings,
                        v=shardings)
    tok_sh = NamedSharding(mesh, P("data"))
    opt = Cap(lr=1e-3, warmup=0)
    jstep = jax.jit(make_train_step(cfg, opt, microbatches=2),
                    in_shardings=(shardings, opt_sh, tok_sh, tok_sh))
    v, s = values[arch], opt.init(values[arch])
    with jax.set_mesh(mesh):  # the pin names the mesh's axes
        for i in range(2):
            v, s = jax.device_put(v, shardings), jax.device_put(s, opt_sh)
            v, s, m = jstep(v, s, jnp.asarray(data[f"tokens{key}"]),
                            jnp.asarray(data[f"labels{key}"]))
            out[f"{tag}/{i}/loss"] = np.asarray(m["loss"])
            out[f"{tag}/{i}/grad_norm"] = np.asarray(m["grad_norm"])
            for path, g in jax.tree_util.tree_flatten_with_path(
                    m["grads"])[0]:
                out[f"{tag}/{i}/grads" + jax.tree_util.keystr(path)] = \
                    np.asarray(g)
np.savez(outp, **out)
print("OK jax (1, 2) steps under residual_spec, the unsharded forward")
"""


def _inputs(path: str, arch: str) -> None:
    """Both sides' inputs: the weights of ``arch``'s reduced config
    (``_mesh_cfg``; the port's ``init_params``, generator seed 0) in the
    JAX value tree's layout, and three seeded batches: 8 x 16 tokens,
    8 x 17 (``_t``) and 6 x 16 (``_u``)."""
    import torch

    from repro_torch.models import init_params, to_jax_values

    cfg = _mesh_cfg(arch)
    values = to_jax_values(cfg, init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    tok, lab = _batch(T=16)
    tok_t, lab_t = _batch(seed=3, T=17)
    tok_u, lab_u = (a[:6] for a in _batch(seed=4, T=16))
    np.savez(path, tokens=tok, labels=lab, tokens_t=tok_t, labels_t=lab_t,
             tokens_u=tok_u, labels_u=lab_u, **{
                 "values" + k.replace("']['", "/").replace("['", "/")
                 .replace("']", ""): v for k, v in _flat(values).items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, JAX's arrays, the inputs' paths).  Two JAX
    subprocesses (Jamba's step alone: its compile takes longest) run
    beside the ranks."""
    tmp = tmp_path_factory.mktemp("res")
    base = tmp / "inputs"
    paths = {}
    for arch in dict.fromkeys(c[1] for c in CASES):
        paths[arch] = f"{base}.{arch}.npz"
        _inputs(paths[arch], arch)
    cases = [(tag, arch, paths[arch], spec, key)
             for tag, arch, spec, key in CASES]
    cases.append(("qwen2_plain", "qwen2-7b", paths["qwen2-7b"], None, ""))
    serves = [(tag, arch, paths[arch], spec, SERVE["prompt"],
               SERVE["cache_len"], SERVE["decode"])
              for tag, arch, spec in SERVES]
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=2", PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), str(HERE)]))
    jobs = [([c for c in CASES if c[1] != JAMBA], SERVES),
            ([c for c in CASES if c[1] == JAMBA], [])]
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_RES, str(tmp / f"jax{i}.npz"), str(base),
         json.dumps(jc), json.dumps(js),
         *(str(SERVE[k]) for k in ("prompt", "cache_len", "decode"))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (jc, js) in enumerate(jobs)]
    try:
        ranks = run_ranks(residual_split, 2, tmp, cases, serves)
        for proc in procs:
            so, se = proc.communicate(timeout=400)
            assert proc.returncode == 0, so + se
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    want = {}
    for i in range(len(jobs)):
        arrays = np.load(tmp / f"jax{i}.npz")
        want.update({k: arrays[k] for k in arrays.files})
    return ranks, want, paths


def _f64_grads(path: str, arch: str, key: str = "",
               moe: dict | None = None) -> list:
    """The unsharded step at f64 in this process, from the weights and
    the batch ``tokens{key}`` in ``path`` (``_mesh_cfg(arch, moe)``, 2
    steps of 2 microbatches, the optimizer of the ranks' step): each
    step's gradient leaves in the JAX layout."""
    import functools

    import torch

    import repro_torch.models.model as mm
    from repro_torch.models import from_jax_params
    from repro_torch.train import AdamW, make_train_step

    data = np.load(path)
    values: dict = {}
    for k in data.files:
        if k.startswith("values/"):
            node = values
            parts = k.split("/")[1:]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[k]
    cfg = _mesh_cfg(arch, moe)
    seen = []

    class Capture(AdamW):
        def update(self, grads, state, params, decay, norm=None):
            seen.append(_flat(mm.to_jax_values(cfg, grads)))
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            return AdamW.update(self, grads, state, params, decay,
                                norm=norm)

    forward = mm.forward
    mm.forward = functools.partial(forward, compute_dtype=torch.float64)
    try:
        params = from_jax_params(cfg, values, device="cpu",
                                 dtype=torch.float64)
        params.requires_grad_(True)
        opt = Capture(lr=1e-3, warmup=0)
        state = opt.init(params)
        step = make_train_step(cfg, opt, microbatches=2)
        tokens, labels = (torch.from_numpy(data[f"{k}{key}"])
                          for k in ("tokens", "labels"))
        for _ in range(STEPS):
            params, state, _ = step(params, state, tokens, labels)
    finally:
        mm.forward = forward
    return seen


@pytest.mark.parametrize("tag", [c[0] for c in CASES])
def test_1x2_residual_split_matches_jax_mesh_step(runs, tag):
    """See the module docstring: each case's ``(1, 2)`` step under the
    knob against JAX's ``(1, 2)`` step under the same knob, at f32.  A
    leaf of JAX's step that lies more than the bar from the unsharded
    step at f64 (``_f64_grads``) strays by the reference's rounding
    (ROADMAP C6: rwkv6's step-2 leaves under the sequence split at T 17,
    where JAX's untuned step and the port's lie 2-3e-5 from it): the
    port's leaf must then lie nearer the f64 step than JAX's does."""
    ranks, want, paths = runs
    arch, key = {c[0]: (c[1], c[3]) for c in CASES}[tag]
    exact = None
    r0 = ranks[0]["train"][tag]
    for i, run in enumerate(r0):
        m = run["metrics"]
        assert abs(m["loss"] - float(want[f"{tag}/{i}/loss"])) <= 2e-5, \
            (i, m)
        wn = float(want[f"{tag}/{i}/grad_norm"])
        assert abs(m["grad_norm"] - wn) / wn <= 1e-4, (i, m, wn)
        got = _flat(run["grads"])
        assert {f"{tag}/{i}/grads{k}" for k in got} == {
            k for k in want if k.startswith(f"{tag}/{i}/grads")}
        for k, g in got.items():
            ref = want[f"{tag}/{i}/grads{k}"]
            if rel_l2(ref, g) <= 2e-5:
                continue
            exact = exact or _f64_grads(paths[arch], arch, key)
            strays = rel_l2(exact[i][k], ref)
            assert strays > 2e-5, (i, k, rel_l2(ref, g))
            assert rel_l2(exact[i][k], g) < strays, (i, k)
        st = run["stats"]
        assert st["tp_reduce_scatter_n"] > 0 and st["tp_gather_n"] > 0, st
    for r in ranks:  # both ranks report the same metrics
        assert [x["metrics"] for x in r["train"][tag]] == \
            [x["metrics"] for x in r0]


@pytest.mark.parametrize("tag", [s[0] for s in SERVES])
def test_residual_split_serving_matches_jax(runs, tag):
    """A prefill and 3 decode steps under the knob: every step's logits
    on both ranks within 1e-5 of max |logit| of JAX's unsharded
    forward."""
    ranks, want, _ = runs
    arch = dict((s[0], s[1]) for s in SERVES)[tag]
    for r in ranks:
        got = r["serve"][tag]
        assert len(got["logits"]) == SERVE["decode"] + 1
        for i, lg in enumerate(got["logits"]):
            ref = want[f"serve/{arch}/{i}"]
            scale = float(np.abs(ref).max())
            assert float(np.abs(lg - ref).max()) <= 1e-5 * scale, (tag, i)
        assert got["stats"]["tp_reduce_scatter_n"] > 0, got["stats"]


def test_residual_split_wire_bytes(runs):
    """qwen2-7b's step: the ``model`` group's ring-model wire bytes a
    rank under the batch split, against the untuned step's plus what
    the split adds at f32 compute (module docstring): per microbatch,
    one gather of a unit's rows for each scan unit and one all-reduce of
    d f32 for each norm scale.  The split is even, so no padding."""
    ranks, _, _ = runs
    cfg = _mesh_cfg("qwen2-7b")
    n, M, B, T, d = 2, 2, 8, 16, cfg.d_model
    units = cfg.num_layers // cfg.scan_unit
    norms = 2 * cfg.num_layers + 1
    rows = B // M * T * d * 4  # a microbatch's residual, f32
    extra = M * (units * rows * (n - 1) / n
                 + norms * d * 4 * 2 * (n - 1) / n)
    for r in ranks:
        for knob, plain in zip(r["train"]["qwen2"],
                               r["train"]["qwen2_plain"]):
            wire = [sum(v for k, v in run["stats"].items()
                        if k.startswith("tp_") and k.endswith("_wire"))
                    for run in (knob, plain)]
            assert wire[1] < wire[0] <= wire[1] + extra, (wire, extra)
            assert plain["stats"].get("tp_reduce_scatter_n", 0) == 0
