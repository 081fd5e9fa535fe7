"""The mesh train step's tensor and expert parallelism over ``model`` on
the CPU: two gloo ranks (``tests/_torch_ranks.py``) as a ``(data 1,
model 2)`` mesh under ``RULES_TP_FSDP``, against JAX's step jitted over
a ``(1, 2)`` host mesh (a subprocess with 2 host devices, run beside the
ranks).

  * The reduced qwen2-7b, qwen2-moe-a2.7b (capacity factor 1.0), rwkv6-1.6b
    and Jamba (one 8-layer unit) of ``tests/test_torch_train_mesh.py``
    (2 layers, d 32, 4 heads / 2 kv heads, vocab 64), from the JAX init
    values and one seeded batch, 2 steps of 2 microbatches at f32
    compute: each step's loss within 2e-5 and grad norm within 1e-4
    relative of JAX's, every gathered gradient leaf within 2e-5 relative
    L2 (the bars of the 2 x 2 test).  One rank spawn and one JAX
    subprocess serve the four archs.
  * No rank gathers a leaf over ``model``: the layouts a rank gathers
    (``ShardedParams.compute_layouts``) hold the rank's ``model`` part of
    every leaf the spec splits there (the MoE's experts: 2 of 4), and on
    a ``(1, 2)`` mesh the FSDP group has one rank, so the step runs no
    parameter gather at all (``MeshTrainStep.stats``), only the ``model``
    group's collectives.

JAX is imported inside the fixture and the subprocess.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_ranks import _mesh_cfg, run_ranks, tp_mesh_train
from test_torch_train_mesh import _batch, _flat, rel_l2

HERE = Path(__file__).resolve().parent
STEPS = 2
JAMBA = "jamba-1.5-large-398b"
ARCHS = ["qwen2-7b", "qwen2-moe-a2.7b", "rwkv6-1.6b", JAMBA]

JAX_TP_STEP = r"""
import dataclasses, functools, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.models.model as mm
from repro.configs import get_arch
from repro.models import init_params
from repro.models.layers import split_tree
from repro.parallel.logical import RULES_TP_FSDP, param_shardings
from repro.train import AdamW, make_train_step
from repro.train.optimizer import AdamWState

outp, base, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
archs = sys.argv[4:]

class Cap(AdamW):
    def update(self, grads, state, params):
        v, s, om = AdamW.update(self, grads, state, params)
        return v, s, {**om, "grads": grads}

mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
mm.forward = functools.partial(mm.forward, compute_dtype=jnp.float32)
out = {}
for arch in archs:
    data = np.load(f"{base}.{arch}.npz")
    cfg = get_arch(arch)
    cfg = cfg.reduced(num_layers=max(2, cfg.scan_unit), vocab_size=64,
                      d_model=32, d_ff=64, num_heads=4, num_kv_heads=2,
                      head_dim=16)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
    params = init_params(jax.random.PRNGKey(0), cfg)
    values, _ = split_tree(params)
    _, shardings = param_shardings(params, RULES_TP_FSDP, mesh)
    opt_sh = AdamWState(step=NamedSharding(mesh, P()), m=shardings,
                        v=shardings)
    tok_sh = NamedSharding(mesh, P("data"))
    opt = Cap(lr=1e-3, warmup=0)
    jstep = jax.jit(make_train_step(cfg, opt, microbatches=2),
                    in_shardings=(shardings, opt_sh, tok_sh, tok_sh))
    v, s = values, opt.init(values)
    for i in range(steps):
        # on a (1, 2) mesh XLA may hand back an equivalent sharding of
        # another spelling, which jit's in_shardings refuse
        v, s = jax.device_put(v, shardings), jax.device_put(s, opt_sh)
        v, s, m = jstep(v, s, jnp.asarray(data["tokens"]),
                        jnp.asarray(data["labels"]))
        out[f"{arch}/{i}/loss"] = np.asarray(m["loss"])
        out[f"{arch}/{i}/grad_norm"] = np.asarray(m["grad_norm"])
        for path, g in jax.tree_util.tree_flatten_with_path(m["grads"])[0]:
            out[f"{arch}/{i}/grads" + jax.tree_util.keystr(path)] = \
                np.asarray(g)
np.savez(outp, **out)
print("OK jax (1, 2) mesh steps")
"""


def _inputs(path: Path, arch: str) -> None:
    """The JAX init values of ``arch``'s reduced config and the seeded
    batch, saved for both sides."""
    import jax

    from repro.configs import get_arch as jax_arch
    from repro.models import init_params as jax_init
    from repro.models.layers import split_tree

    jcfg = jax_arch(arch)
    jcfg = jcfg.reduced(num_layers=max(2, jcfg.scan_unit), vocab_size=64,
                        d_model=32, d_ff=64, num_heads=4, num_kv_heads=2,
                        head_dim=16)
    values, _ = split_tree(jax_init(jax.random.PRNGKey(0), jcfg))
    tok, lab = _batch(T=16)
    np.savez(path, tokens=tok, labels=lab, **{
        "values" + k.replace("']['", "/").replace("['", "/").replace(
            "']", ""): v for k, v in _flat(jax.tree.map(np.asarray,
                                                        values)).items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides for every arch: (rank results, JAX's arrays)."""
    tmp = tmp_path_factory.mktemp("tp")
    base = tmp / "inputs"
    cases = []
    for arch in ARCHS:
        path = Path(f"{base}.{arch}.npz")
        _inputs(path, arch)
        cases.append((arch, str(path), str(tmp / f"ckpt-{arch}")))
    outp = tmp / "jax.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=2", PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), str(HERE)]))
    proc = subprocess.Popen([sys.executable, "-c", JAX_TP_STEP, str(outp),
                             str(base), str(STEPS), *ARCHS], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ranks = run_ranks(tp_mesh_train, 2, tmp, cases, (1, 2), STEPS)
        so, se = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, so + se
    return ranks, np.load(outp)


@pytest.mark.parametrize("arch", ARCHS)
def test_1x2_ranks_match_jax_mesh_step(runs, arch):
    """See the module docstring: the ``(1, 2)`` mesh step of each arch
    against JAX's ``(1, 2)`` mesh step at f32 compute."""
    ranks, want = runs
    r0 = ranks[0][arch]["f32"]
    for i, run in enumerate(r0["runs"]):
        m = run["metrics"]
        assert abs(m["loss"] - float(want[f"{arch}/{i}/loss"])) <= 2e-5, \
            (i, m)
        wn = float(want[f"{arch}/{i}/grad_norm"])
        assert abs(m["grad_norm"] - wn) / wn <= 1e-4, (i, m, wn)
        got = _flat(run["grads"])
        assert {f"{arch}/{i}/grads{k}" for k in got} == {
            k for k in want.files if k.startswith(f"{arch}/{i}/grads")}
        for k, g in got.items():
            assert rel_l2(want[f"{arch}/{i}/grads{k}"], g) <= 2e-5, (i, k)
    for r in ranks:  # both ranks report the same metrics
        assert [x["metrics"] for x in r[arch]["f32"]["runs"]] == \
            [x["metrics"] for x in r0["runs"]]
        assert r[arch]["f32"]["resident"] == r[arch]["f32"]["share"]


def test_1x2_moe_step_gathers_no_expert(runs):
    """The MoE arch's ``(1, 2)`` step: each rank's gathered layout of an
    expert leaf holds its 2 of the 4 experts, every leaf that the spec
    puts on ``model`` arrives as the rank's part, and the step's stats
    count no parameter gather (``gather``), only ``model`` collectives
    (``tp_*``) and the metrics' all-reduces."""
    from repro_torch.models.model import abstract_params
    from repro_torch.parallel import RULES_TP_FSDP, model_dim, spec_for
    from repro_torch.models.model import param_axes
    from repro_torch.launch.mesh import AbstractMesh

    ranks, _ = runs
    arch = "qwen2-moe-a2.7b"
    cfg = _mesh_cfg(arch)
    mesh = AbstractMesh(("data", "model"), (1, 2))
    experts = 0
    for name, t in abstract_params(cfg).named_parameters():
        spec = spec_for(tuple(t.shape), param_axes(name), RULES_TP_FSDP,
                        mesh)
        d = model_dim(spec)
        for r in ranks:
            got = r[arch]["f32"]["compute_shapes"][name]
            want = list(t.shape)
            if d is not None:
                want[d] //= 2
            assert list(got) == want, (name, got)
        if ".moe.w" in name:
            assert d == 0 and ranks[0][arch]["f32"]["compute_shapes"][
                name][0] == cfg.moe.padded_experts // 2
            experts += 1
    assert experts == 3 * sum(cfg.is_moe_layer(i)
                              for i in range(cfg.num_layers))
    for r in ranks:
        for run in r[arch]["f32"]["runs"]:
            st = run["stats"]
            assert st.get("gather_n", 0) == 0 and \
                st.get("reduce_scatter_n", 0) == 0, st
            assert st["tp_all_reduce_n"] > 0, st
