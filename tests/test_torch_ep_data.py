"""Expert parallelism over ``data`` in the mesh train step on the CPU: four
gloo ranks (``tests/_torch_ranks.py``) as a ``(data 2, model 2)`` mesh
under ``RULES_EP_DATA`` and the ``moe_ep_data`` preset, against JAX's
step jitted over a ``(2, 2)`` host mesh under the same rules and preset
(a subprocess with 4 host devices, run beside the ranks).

  * The reduced qwen2-moe-a2.7b of ``tests/test_torch_tp_mesh.py`` (2
    layers, d 32, 4 heads / 2 kv heads, vocab 64, capacity factor 1.0, so
    that busier experts drop tokens), from the JAX init values and one
    seeded batch, 2 steps of 2 microbatches at f32 compute: each step's
    loss within 2e-5 and grad norm within 1e-4 relative of JAX's, every
    gathered gradient leaf within 2e-5 relative L2 (the 2 x 2 test's
    bars).
  * An expert leaf's spec puts its experts on ``data`` and its mlp on
    ``model`` (``("data", None, "model")``, ``("data", "model")``); no
    expert leaf is in any rank's gather bucket, so none is gathered or
    reduce-scattered over ``data``; the step's stats count the
    all-to-alls over ``data`` (``ep_all_to_all``) and the gathers carry
    exactly the other leaves' bytes.
  * The gathered state (``full_state``) cross-loads: rank 0's
    ``jax_state`` checkpoint restores through the JAX checkpoint code to
    the gathered parameters, within 2e-5 of JAX's after the same steps.

JAX is imported inside the fixture and the subprocess.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_ranks import _mesh_cfg, ep_data_train, run_ranks
from test_torch_train_mesh import _flat, rel_l2
from test_torch_tp_mesh import _inputs

HERE = Path(__file__).resolve().parent
STEPS = 2
ARCH = "qwen2-moe-a2.7b"

JAX_EP_STEP = r"""
import dataclasses, functools, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.models.model as mm
from repro.configs import get_arch
from repro.models import init_params
from repro.models.layers import split_tree
from repro.models.tuning import apply_preset
from repro.parallel.logical import RULES_EP_DATA, param_shardings
from repro.train import AdamW, make_train_step
from repro.train.optimizer import AdamWState

inp, outp, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
data = np.load(inp)
cfg = get_arch("qwen2-moe-a2.7b").reduced(
    num_layers=2, vocab_size=64, d_model=32, d_ff=64, num_heads=4,
    num_kv_heads=2, head_dim=16)
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, capacity_factor=1.0))
apply_preset("moe_ep_data")

class Cap(AdamW):
    def update(self, grads, state, params):
        v, s, om = AdamW.update(self, grads, state, params)
        return v, s, {**om, "grads": grads}

mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
mm.forward = functools.partial(mm.forward, compute_dtype=jnp.float32)
params = init_params(jax.random.PRNGKey(0), cfg)
values, _ = split_tree(params)
_, shardings = param_shardings(params, RULES_EP_DATA, mesh)
opt_sh = AdamWState(step=NamedSharding(mesh, P()), m=shardings, v=shardings)
tok_sh = NamedSharding(mesh, P("data"))
opt = Cap(lr=1e-3, warmup=0)
jstep = jax.jit(make_train_step(cfg, opt, microbatches=2),
                in_shardings=(shardings, opt_sh, tok_sh, tok_sh))
v, s = values, opt.init(values)
out = {}
with jax.set_mesh(mesh):  # the preset's pins name the mesh's axes
    for i in range(steps):
        v, s = jax.device_put(v, shardings), jax.device_put(s, opt_sh)
        v, s, m = jstep(v, s, jnp.asarray(data["tokens"]),
                        jnp.asarray(data["labels"]))
        out[f"{i}/loss"] = np.asarray(m["loss"])
        out[f"{i}/grad_norm"] = np.asarray(m["grad_norm"])
        for path, g in jax.tree_util.tree_flatten_with_path(
                m["grads"])[0]:
            out[f"{i}/grads" + jax.tree_util.keystr(path)] = np.asarray(g)
for path, x in jax.tree_util.tree_flatten_with_path(v)[0]:
    out["values" + jax.tree_util.keystr(path)] = np.asarray(x)
np.savez(outp, **out)
print("OK jax (2, 2) EP-over-data steps")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the four ranks' results, JAX's arrays)."""
    tmp = tmp_path_factory.mktemp("ep")
    inp = tmp / "inputs.npz"
    _inputs(inp, ARCH)
    outp = tmp / "jax.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=4", PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), str(HERE)]))
    proc = subprocess.Popen([sys.executable, "-c", JAX_EP_STEP, str(inp),
                             str(outp), str(STEPS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ranks = run_ranks(ep_data_train, 4, tmp, str(inp),
                          str(tmp / "ckpt"), STEPS)
        so, se = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, so + se
    return [r["f32"] for r in ranks], np.load(outp), tmp / "ckpt"


def test_2x2_ep_data_ranks_match_jax_mesh_step(runs):
    """See the module docstring: the loss, the grad norm and every
    gradient leaf of both steps against JAX's (2, 2) step under the same
    rules and preset; every rank reports the same metrics and holds the
    specs' share."""
    ranks, want, _ = runs
    r0 = ranks[0]
    for i, run in enumerate(r0["runs"]):
        m = run["metrics"]
        assert abs(m["loss"] - float(want[f"{i}/loss"])) <= 2e-5, (i, m)
        wn = float(want[f"{i}/grad_norm"])
        assert abs(m["grad_norm"] - wn) / wn <= 1e-4, (i, m, wn)
        got = _flat(run["grads"])
        assert {f"{i}/grads{k}" for k in got} == {
            k for k in want.files if k.startswith(f"{i}/grads")}
        for k, g in got.items():
            assert rel_l2(want[f"{i}/grads{k}"], g) <= 2e-5, (i, k)
    for r in ranks:
        assert [x["metrics"] for x in r["runs"]] == \
            [x["metrics"] for x in r0["runs"]]
        assert r["resident"] == r["share"]


def test_2x2_ep_data_gathers_no_expert(runs):
    """Every expert leaf is on ``data`` and ``model`` (a quarter of it a
    rank), out of every gather bucket; the all-to-alls over ``data`` ran
    in both steps; the gathers sent exactly the other leaves' bytes: the
    top-level leaves once a step in f32, each layer's leaves in f32
    (these steps compute in f32) once a microbatch forward and again in
    its rematerialised backward."""
    import math

    from repro_torch.models.model import abstract_params

    ranks, _, _ = runs
    cfg = _mesh_cfg(ARCH)
    full = {n: tuple(t.shape)
            for n, t in abstract_params(cfg).named_parameters()}
    experts = {n for n in full if ".moe.w" in n}
    assert experts and len(experts) == 3 * sum(
        cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    E = cfg.moe.padded_experts
    for r in ranks:
        assert set(r["expert_leaves"]) == experts
        assert not experts & set(r["bucket_names"])
        for n in experts:
            assert r["local_shapes"][n][0] == E // 2, (n, r["local_shapes"])
            assert math.prod(r["local_shapes"][n]) * 4 == math.prod(full[n])
        shapes = r["compute_shapes"]
        top = sum(-(-math.prod(shapes[n]) // 2) for n in r["bucket_names"]
                  if not n.startswith("blocks."))
        layers = sum(-(-math.prod(shapes[n]) // 2)
                     for n in r["bucket_names"] if n.startswith("blocks."))
        want = 4 * (top + 2 * 2 * layers)
        for run in r["runs"]:
            st = run["stats"]
            assert st["ep_all_to_all_n"] > 0 and st["ep_gather_n"] > 0, st
            assert st["gather_bytes"] == want, (st, want)


def test_2x2_ep_data_state_cross_loads(runs):
    """The gathered state after both steps (``full_state``: each expert
    slice counted once) in the JAX package's checkpoint tree: restored by
    the JAX checkpoint code, equal to the ranks' gathered parameters and
    within 2e-5 of JAX's after the same steps."""
    import jax

    from repro.configs import get_arch as jax_arch
    from repro.models import init_params as jax_init
    from repro.models.layers import split_tree
    from repro.train import AdamW as JAdamW
    from repro.train import restore as jrestore

    ranks, want, ckpt = runs
    jcfg = jax_arch(ARCH).reduced(
        num_layers=2, vocab_size=64, d_model=32, d_ff=64, num_heads=4,
        num_kv_heads=2, head_dim=16)
    values, _ = split_tree(jax_init(jax.random.PRNGKey(0), jcfg))
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        {"params": values, "opt": JAdamW().init(values)})
    got = jrestore(str(ckpt), STEPS, like)
    assert int(got["opt"].step) == STEPS
    gp = _flat(jax.tree.map(np.asarray, got["params"]))
    mine = _flat(ranks[0]["values"])
    assert gp.keys() == mine.keys()
    for k, v in gp.items():
        np.testing.assert_array_equal(v, mine[k])
        np.testing.assert_allclose(v, want[f"values{k}"], rtol=0, atol=2e-5,
                                   err_msg=k)


def test_ep_data_refuses_rows_not_split_over_data():
    """Rows not split over ``data`` (a batch that it does not divide) sit
    whole on every ``data`` rank, and the all-to-all would count each copy
    as new tokens: the forward's split raises there, rows split over
    ``data`` carry the ``ExpertSplit``, and the dry run records jamba's
    ``long_500k`` cell (batch 1 on 16 x 16) under ``ep_data`` as skipped
    with the reason."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
    from repro_torch.models.model import abstract_params
    from repro_torch.parallel import (
        RULES_EP_DATA, param_shardings, token_sharding,
    )
    from repro_torch.train.train_loop import ShardedParams

    cfg = _mesh_cfg(ARCH)
    mesh = AbstractMesh(("data", "model"), (2, 2))
    assert tuple(token_sharding(mesh, 3)) == (None,)
    specs = param_shardings(abstract_params(cfg), RULES_EP_DATA, mesh)
    with dryrun._fake_world(mesh) as rmesh:
        with pytest.raises(ValueError, match="split over data"):
            ShardedParams(cfg, rmesh, specs, ()).model_split()
        tp = ShardedParams(cfg, rmesh, specs, ("data",)).model_split()
    assert tp.experts is not None and tp.experts.n == 2
    rec = dryrun.build_cell("jamba-1.5-large-398b", "long_500k",
                            make_production_mesh(), "ep_data")
    assert "split over data" in rec["skipped"], rec
