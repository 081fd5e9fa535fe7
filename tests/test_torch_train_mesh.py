"""The train step over a mesh of ranks (``jit_train_step``: ZeRO-3 by the
specs, per-layer all-gather and reduce-scatter) on the CPU.

  * At one rank the mesh step is bitwise ``make_train_step``'s step
    (per-layer and whole-model gathers, 1 and 2 microbatches, the TP/FSDP
    and the data-parallel rules).
  * On 2 x 2 ``(data, model)`` gloo ranks (``tests/_torch_ranks.py``)
    the reduced qwen2-7b of the JAX package's own sharded-step test is
    held against JAX's step jitted over a 2 x 2 host mesh (a subprocess
    with 4 host devices, run beside the ranks), from the same init values
    and batch, 2 steps of 2 microbatches:
      - f32 compute (both forwards given ``compute_dtype`` f32 by a
        partial): the loss within 2e-5, the grad norm within 1e-4
        relative, every gathered gradient leaf within 2e-5 relative L2
        (the f32 limit of ``test_torch_train_grads.py``);
      - bf16 compute (the default): the reference's own bars on its one
        step (``tests/test_sharding_distributed.py``): step 1's loss
        within 1e-3 and grad norm within 2e-2 relative; step 2, after an
        update from bf16 gradients that round elsewhere, within the bf16
        loss bar of ``test_torch_train_grads.py``, 5e-3 (measured
        1.02e-3), and the same 2e-2.
    Each rank's resident parameter and moment bytes equal the specs'
    share, and ``jax_state`` of the gathered state restores into the JAX
    package's checkpoint tree, equal to JAX's parameters after the same
    two steps within 2e-5.

JAX is imported inside the tests that need it (and in the subprocess),
so this file's CUDA case runs where JAX is not installed.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_ranks import _mesh_cfg, mesh_train, run_ranks
from repro_torch.models import init_params
from repro_torch.parallel import (
    RULES_DP_ONLY, RULES_TP_FSDP, param_shardings, serving_mesh,
    token_sharding,
)
from repro_torch.train import AdamW, jit_train_step, make_train_step

HERE = Path(__file__).resolve().parent
STEPS = 2

JAX_STEP = r"""
import functools, sys
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

inp, outp, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
arch, dts = sys.argv[4], sys.argv[5].split(",")
data = np.load(inp)
cfg = get_arch(arch).reduced(num_layers=2, vocab_size=64, d_model=32,
                             d_ff=64, num_heads=4, num_kv_heads=2,
                             head_dim=16)
if cfg.moe is not None:
    import dataclasses
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))
params = init_params(jax.random.PRNGKey(0), cfg)
values, _ = split_tree(params)
tokens, labels = jnp.asarray(data["tokens"]), jnp.asarray(data["labels"])

class Cap(AdamW):
    def update(self, grads, state, params):
        v, s, om = AdamW.update(self, grads, state, params)
        return v, s, {**om, "grads": grads}

mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
_, shardings = param_shardings(params, RULES_TP_FSDP, mesh)
opt_sh = AdamWState(step=NamedSharding(mesh, P()), m=shardings, v=shardings)
tok_sh = NamedSharding(mesh, P("data"))
forward = mm.forward
out = {}
for dt in dts:
    mm.forward = (functools.partial(forward, compute_dtype=jnp.float32)
                  if dt == "f32" else forward)
    opt = Cap(lr=1e-3, warmup=0)
    step = make_train_step(cfg, opt, microbatches=2)
    jstep = jax.jit(step, in_shardings=(shardings, opt_sh, tok_sh, tok_sh))
    v, s = values, opt.init(values)
    for i in range(steps):
        v, s, m = jstep(v, s, tokens, labels)
        out[f"{dt}/{i}/loss"] = np.asarray(m["loss"])
        out[f"{dt}/{i}/grad_norm"] = np.asarray(m["grad_norm"])
        for path, g in jax.tree_util.tree_flatten_with_path(m["grads"])[0]:
            out[f"{dt}/{i}/grads" + jax.tree_util.keystr(path)] = np.asarray(g)
    for path, x in jax.tree_util.tree_flatten_with_path(v)[0]:
        out[f"{dt}/values" + jax.tree_util.keystr(path)] = np.asarray(x)
np.savez(outp, **out)
print("OK jax mesh step")
"""


def _flat(tree, prefix=""):
    """{"['a']['b']": leaf} of a nested dict, as ``jax.tree_util.keystr``
    names the leaves."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _batch(seed: int = 1, T: int = 16):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, (8, T)).astype(np.int32),
            rng.integers(0, 64, (8, T)).astype(np.int32))


def _one_rank(per_layer: bool, microbatches: int, rules, device="cpu"):
    """Two steps of the unsharded step and of the mesh step at one rank,
    from the same weights -> (metrics, parameters, moments) of each."""
    cfg = _mesh_cfg()
    tok, lab = (torch.from_numpy(a).to(device) for a in _batch())
    outs = []
    for mesh_step in (False, True):
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device=device)
        params.requires_grad_(True)
        opt = AdamW(lr=1e-3, warmup=0)
        state = opt.init(params)
        if mesh_step:
            mesh = serving_mesh(1, 1, device=device)
            specs = param_shardings(params, rules, mesh)
            blocks = ({n: s for n, s in specs.items()
                       if n.startswith("blocks.")} if per_layer else None)
            step = jit_train_step(
                make_train_step(cfg, opt, microbatches=microbatches,
                                grad_shardings=specs,
                                block_param_specs=blocks),
                mesh, specs, token_sharding(mesh, tok.shape[0]))
        else:
            step = make_train_step(cfg, opt, microbatches=microbatches)
        ms = []
        for _ in range(STEPS):
            params, state, m = step(params, state, tok, lab)
            ms.append({k: v.item() for k, v in m.items()})
        outs.append((ms, {k: p.detach().clone() for k, p in
                          params.named_parameters()}, state))
    return outs


@pytest.mark.parametrize("rules", ["tp_fsdp", "dp_only"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("per_layer", [True, False],
                         ids=["per_layer", "whole"])
def test_one_rank_mesh_step_is_the_step_bitwise(per_layer, microbatches,
                                                rules):
    rules = {"tp_fsdp": RULES_TP_FSDP, "dp_only": RULES_DP_ONLY}[rules]
    (m0, p0, s0), (m1, p1, s1) = _one_rank(per_layer, microbatches, rules)
    assert m0 == m1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
        assert torch.equal(s0.m[k], s1.m[k]) and torch.equal(s0.v[k],
                                                             s1.v[k]), k


def test_mesh_step_checks_its_specs():
    """Gradient specs other than the parameters', or layer specs other
    than theirs, are refused; so is a batch that does not split."""
    cfg = _mesh_cfg()
    mesh = serving_mesh(1, 1, device="cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    specs = param_shardings(params, RULES_TP_FSDP, mesh)
    other = dict(specs, **{"embed": ("model",)})
    opt = AdamW()
    with pytest.raises(ValueError, match="grad_shardings"):
        jit_train_step(make_train_step(cfg, opt, grad_shardings=other), mesh,
                       specs, token_sharding(mesh, 8))
    blocks = {n: ("data",) for n in specs if n.startswith("blocks.")}
    with pytest.raises(ValueError, match="block_param_specs"):
        jit_train_step(make_train_step(cfg, opt, block_param_specs=blocks),
                       mesh, specs, token_sharding(mesh, 8))
    js = jit_train_step(make_train_step(cfg, opt, microbatches=3), mesh,
                        specs, token_sharding(mesh, 8))
    params.requires_grad_(True)
    tok, lab = (torch.from_numpy(a) for a in _batch())
    with pytest.raises(ValueError, match="microbatches"):
        js(params, opt.init(params), tok, lab)


def test_mesh_step_without_donation_leaves_its_inputs():
    """``donate=False`` steps on copies: the given parameters and moments
    keep their full shapes and values, and the result is the donating
    step's."""
    cfg = _mesh_cfg()
    mesh = serving_mesh(1, 1, device="cpu")
    tok, lab = (torch.from_numpy(a) for a in _batch())
    outs = []
    for donate in (False, True):
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        params.requires_grad_(True)
        before = {k: p.detach().clone() for k, p in params.named_parameters()}
        opt = AdamW(lr=1e-3, warmup=0)
        state = opt.init(params)
        specs = param_shardings(params, RULES_TP_FSDP, mesh)
        js = jit_train_step(make_train_step(cfg, opt), mesh, specs,
                            token_sharding(mesh, 8), donate=donate)
        new, new_state, m = js(params, state, tok, lab)
        kept = all(torch.equal(p, before[k])
                   for k, p in params.named_parameters())
        assert kept == (not donate)
        assert int(new_state.step) == 1
        assert all(not t.any() for t in state.m.values()) == (not donate)
        outs.append({k: p.detach() for k, p in new.named_parameters()})
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def test_2x2_ranks_match_jax_mesh_step(tmp_path):
    """See the module docstring: 4 gloo ranks on a 2 x 2 mesh against
    JAX's step jitted over a 2 x 2 mesh of host devices."""
    _check_2x2(tmp_path, "qwen2-7b", ("f32", "bf16"), T=16)


def test_2x2_moe_ranks_match_jax_mesh_step(tmp_path):
    """The same for the reduced qwen2-moe-a2.7b (4 experts, top 2, one
    shared; capacity factor 1.0) at f32 compute, 32 tokens a row: a
    microbatch's 128 tokens make 256 choices, 64 an expert on average
    against a capacity of 64, so the busier experts drop tokens, which
    rank's tokens they drop depends on the row slices before it, and the
    load-balance loss takes the whole microbatch's fractions.  Each rank
    routing its own 64 tokens alone (capacity 32) misses the loss bar."""
    _check_2x2(tmp_path, "qwen2-moe-a2.7b", ("f32",), T=32)


def _check_2x2(tmp_path, arch: str, dts: tuple, T: int) -> None:
    import jax

    from repro.configs import get_arch as jax_arch
    from repro.models import init_params as jax_init
    from repro.models.layers import split_tree
    from repro.train import AdamW as JAdamW
    from repro.train import restore as jrestore

    jcfg = jax_arch(arch).reduced(
        num_layers=2, vocab_size=64, d_model=32, d_ff=64, num_heads=4,
        num_kv_heads=2, head_dim=16)
    values, _ = split_tree(jax_init(jax.random.PRNGKey(0), jcfg))
    tok, lab = _batch(T=T)
    inp = tmp_path / "inputs.npz"
    np.savez(inp, tokens=tok, labels=lab, **{
        "values" + k.replace("']['", "/").replace("['", "/").replace(
            "']", ""): v for k, v in _flat(jax.tree.map(np.asarray,
                                                        values)).items()})
    outp = tmp_path / "jax.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=4", PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), str(HERE)]))
    proc = subprocess.Popen([sys.executable, "-c", JAX_STEP, str(inp),
                             str(outp), str(STEPS), arch, ",".join(dts)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    ckpt = str(tmp_path / "ckpt")
    try:
        ranks = run_ranks(mesh_train, 4, tmp_path, str(inp), ckpt, (2, 2),
                          STEPS, arch, dts)
        so, se = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, so + se
    want = np.load(outp)
    r0 = ranks[0]
    tols = {"f32": [(2e-5, 1e-4)] * STEPS,
            "bf16": [(1e-3, 2e-2)] + [(5e-3, 2e-2)] * (STEPS - 1)}
    for dt in dts:
        for i, run in enumerate(r0[dt]["runs"]):
            m = run["metrics"]
            loss_tol, norm_tol = tols[dt][i]
            assert abs(m["loss"] - float(want[f"{dt}/{i}/loss"])) <= \
                loss_tol, (dt, i, m)
            wn = float(want[f"{dt}/{i}/grad_norm"])
            assert abs(m["grad_norm"] - wn) / wn <= norm_tol, (dt, i, m, wn)
            if dt == "f32":
                got = _flat(run["grads"])
                assert {f"{dt}/{i}/grads{k}" for k in got} == {
                    k for k in want.files
                    if k.startswith(f"{dt}/{i}/grads")}
                for k, g in got.items():
                    assert rel_l2(want[f"{dt}/{i}/grads{k}"], g) <= 2e-5, k
        for r in ranks:  # every rank reports the same metrics
            assert [x["metrics"] for x in r[dt]["runs"]] == \
                [x["metrics"] for x in r0[dt]["runs"]]
            assert r[dt]["resident"] == r[dt]["share"]
        # 2 x 2 holds a quarter of the fully sharded leaves, half the rest
        assert r0[dt]["resident"] < 0.5 * 3 * 4 * sum(
            v.size for v in _flat(r0["f32"]["values"]).values())
    # the gathered state in the JAX package's checkpoint tree
    jopt = JAdamW()
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        {"params": values, "opt": jopt.init(values)})
    got = jrestore(ckpt, STEPS, like)
    assert int(got["opt"].step) == STEPS
    gp = _flat(jax.tree.map(np.asarray, got["params"]))
    assert gp.keys() == _flat(r0["f32"]["values"]).keys()
    for k, v in gp.items():
        np.testing.assert_array_equal(v, _flat(r0["f32"]["values"])[k])
        np.testing.assert_allclose(v, want[f"f32/values{k}"], rtol=0,
                                   atol=2e-5, err_msg=k)


def _moe_counts(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Each expert's count of the rows' top-k choices, as ``moe_apply``
    takes them."""
    probs = torch.softmax((x.reshape(-1, x.shape[-1]) @ p["router"]), -1)
    top = torch.topk(probs, cfg.top_k, dim=-1).indices.reshape(-1)
    return torch.bincount(top, minlength=cfg.padded_experts)


@pytest.mark.parametrize("dispatch", ["scatter", "2d"])
def test_moe_row_slices_route_as_the_whole_batch(dispatch):
    """Two row slices of a batch, each routed over the other by
    ``moe.routed_over`` with the counts that the mesh step all-gathers,
    give the whole batch's outputs and its load-balance loss as their
    mean within 1e-6 (f32; the experts' products run over other buffers),
    and its gradients within 2e-5 relative L2 (the f32 limit of
    ``test_torch_train_grads.py``: the sums over the tokens run in
    another order).  The capacity drops tokens here, and each slice
    routed alone gives other outputs."""
    from repro_torch.models import moe, tuning

    cfg = _mesh_cfg("qwen2-moe-a2.7b").moe
    gen = torch.Generator().manual_seed(0)
    leaves = moe.moe_init(gen, cfg, 32, 64)
    flat = [leaves[k] for k in ("router", "wi_gate", "wi_up", "wo")] + \
        list(leaves["shared"].values())
    for t in flat:
        t.requires_grad_(True)
    x = torch.randn((4, 32, 32), generator=gen)
    w = torch.randn((4, 32, 32), generator=gen)
    halves = x.chunk(2)
    counts = torch.stack([_moe_counts(leaves, cfg, h) for h in halves])
    assert counts.sum(0).max() > moe.capacity(cfg, 128)  # tokens drop
    saved = tuning.TUNING.moe_shard_dispatch
    tuning.TUNING.moe_shard_dispatch = dispatch == "2d"
    try:
        y, aux = moe.moe_apply(leaves, cfg, x)
        want = torch.autograd.grad((y * w).sum() + aux, flat)
        ys, auxs = [], []
        for r, h in enumerate(halves):
            def route(c, r=r):
                assert torch.equal(c, counts[r])
                return counts[:r].sum(0), counts.sum(0), 2

            with moe.routed_over(route):
                yr, ar = moe.moe_apply(leaves, cfg, h)
            ys.append(yr)
            auxs.append(ar)
        alone = moe.moe_apply(leaves, cfg, halves[1])[0]
    finally:
        tuning.TUNING.moe_shard_dispatch = saved
    got = torch.autograd.grad((torch.cat(ys) * w).sum()
                              + (auxs[0] + auxs[1]) / 2, flat)
    torch.testing.assert_close(torch.cat(ys), y, rtol=0, atol=1e-6)
    torch.testing.assert_close((auxs[0] + auxs[1]) / 2, aux, rtol=0,
                               atol=1e-6)
    for a, b in zip(got, want):
        assert rel_l2(b, a) <= 2e-5
    assert not torch.allclose(alone, y[2:], atol=1e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this mesh step runs on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_one_rank_mesh_step_is_the_step_bitwise(cuda_device):
    """On the card the one-rank mesh step is the unsharded step, bit for
    bit (per-layer gathers, 2 microbatches)."""
    (m0, p0, s0), (m1, p1, s1) = _one_rank(True, 2, RULES_TP_FSDP,
                                           device="cuda")
    assert m0 == m1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
        assert p1[k].is_cuda
