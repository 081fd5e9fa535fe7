"""repro_torch training vs the JAX package's, on the CPU: the optimizer,
the train step, data and elasticity, checkpoints both ways, the Trainer,
the launcher and the example (``test_torch_train_grads.py`` holds the
loss and gradient parity).

Weights are the JAX init's value tree with seeded numpy noise on every
leaf (``test_torch_models.noisy_values``), loaded into the port with
``from_jax_params``; tokens and labels are seeded numpy.

Tolerances:
  * AdamW (three steps): parameters and moments within 1e-6 relative
    plus 1e-6 of the tensor's largest entry (the f32 rounding of the
    update's terms); bf16 moments within one bf16 ulp (2^-7 relative),
    and then the parameters within 3 x lr x 2^-7 (a moment one ulp off
    moves an update, at most lr, by 2^-7 of itself); the step exact.
  * The port's Trainer resumed from a JAX Trainer's checkpoint: its
    losses within 2e-2 of the JAX run's (both compute in bf16).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import abstract_params as jax_abstract_params
from repro.models.layers import split_tree
from repro_torch.configs import get_arch
from repro_torch.models import (
    abstract_params, from_jax_params, param_count, to_jax_values,
)
from test_torch_models import noisy_values

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(num_layers=2, vocab_size=64, d_model=32, d_ff=64, num_heads=2,
            num_kv_heads=1, head_dim=16)  # tests/test_train.py's config


def leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# --------------------------------------------------------------- AdamW
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(state_dtype):
    """Three updates with seeded gradients (warmup, clipping active at the
    second step, weight decay) against the JAX optimizer."""
    from repro.train import AdamW as JAdamW
    from repro_torch.train import AdamW
    from repro_torch.train.optimizer import decay_mask

    jcfg, tcfg = jax_arch("qwen2-7b").reduced(), get_arch("qwen2-7b").reduced()
    vals = noisy_values(jcfg)
    kw = dict(lr=1e-2, warmup=2, total_steps=5, clip_norm=3.0,
              state_dtype=state_dtype)
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    jv, jst = vals, jopt.init(vals)
    params = from_jax_params(tcfg, vals, device="cpu")
    tst = topt.init(params)
    rng = np.random.default_rng(3)
    jupdate = jax.jit(jopt.update)
    for i in range(3):
        gscale = 0.5 if i != 1 else 4.0
        g = jax.tree.map(lambda a: gscale * rng.standard_normal(a.shape)
                         .astype(np.float32), vals)
        jv, jst, jm = jupdate(g, jst, jv)
        tg = {n: p for n, p in from_jax_params(
            tcfg, g, device="cpu").named_parameters()}
        _, tst, tm = topt.update(tg, tst, params, decay_mask(tcfg))
        assert abs(float(jm["grad_norm"]) - float(tm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        assert abs(float(jm["lr"]) - float(tm["lr"])) <= 1e-9
    assert int(tst.step) == int(jst.step) == 3
    bf16 = state_dtype == "bfloat16"
    for name, jtree, ttree in (("params", jv, params), ("m", jst.m, tst.m),
                               ("v", jst.v, tst.v)):
        jl, tl = leaves(jtree), leaves(to_jax_values(tcfg, ttree))
        for k in jl:
            a, b = jl[k].astype(np.float64), tl[k].astype(np.float64)
            atol = 1e-6 * np.abs(a).max()
            rtol = 2.0 ** -7 if bf16 and name != "params" else 1e-6
            if bf16 and name == "params":  # a moment one ulp off moves an
                atol = 3 * kw["lr"] * 2.0 ** -7  # update by 2^-7 of <= lr
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=f"{name} {k}")


def test_adamw_unit_grads_and_in_place():
    """tests/test_train.py's first step with unit gradients (update = lr),
    written into the same tensors."""
    from repro_torch.models import init_params
    from repro_torch.train import AdamW
    from repro_torch.train.optimizer import decay_mask

    cfg = get_arch("qwen2-7b").reduced(**TINY)

    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = AdamW(lr=1e-2, warmup=0, weight_decay=0.0, clip_norm=1e9,
                total_steps=100, min_lr_frac=1.0)
    st = opt.init(params)
    before = {n: p.clone() for n, p in params.named_parameters()}
    ptrs = {n: p.data_ptr() for n, p in params.named_parameters()}
    grads = {n: torch.ones_like(p) for n, p in params.named_parameters()}
    _, st2, m = opt.update(grads, st, params, decay_mask(cfg))
    for n, p in params.named_parameters():
        assert p.data_ptr() == ptrs[n]
        np.testing.assert_allclose((before[n] - p).numpy(), 1e-2, rtol=1e-4)
    assert float(m["grad_norm"]) > 0 and int(st2.step) == 1


# ------------------------------------------------------- the train step
def test_grad_accumulation_equivalence():
    """Mean of microbatch gradients == the full batch's (loss and grad
    norm, tests/test_train.py's tolerances); the step leaves no gradient
    behind."""
    from repro_torch.models import init_params
    from repro_torch.train import AdamW, make_train_step

    cfg = get_arch("qwen2-7b").reduced(**TINY)
    vals = noisy_values(jax_arch("qwen2-7b").reduced(**TINY))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16)))
    outs = {}
    for mb in (1, 4):
        params = from_jax_params(cfg, vals, device="cpu")
        params.requires_grad_(True)
        opt = AdamW(lr=1e-3, warmup=0)
        step = make_train_step(cfg, opt, microbatches=mb)
        _, st, m = step(params, opt.init(params), tokens, labels)
        outs[mb] = (float(m["loss"]), float(m["grad_norm"]))
        assert all(p.grad is None for p in params.parameters())
        assert int(st.step) == 1
    assert abs(outs[1][0] - outs[4][0]) < 2e-3, outs
    assert abs(outs[1][1] - outs[4][1]) / outs[1][1] < 2e-2, outs
    with pytest.raises(ValueError, match="requires_grad_"):
        p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        make_train_step(cfg, AdamW())(p, AdamW().init(p), tokens, labels)
    # sharding specs take effect on a mesh (jit_train_step), where the
    # gradients must land on the parameters' slices
    from repro_torch.parallel import (
        RULES_TP_FSDP, param_shardings, serving_mesh, token_sharding,
    )
    from repro_torch.train import jit_train_step

    mesh = serving_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="grad_shardings"):
        jit_train_step(make_train_step(cfg, AdamW(), grad_shardings={}),
                       mesh, param_shardings(p, RULES_TP_FSDP, mesh),
                       token_sharding(mesh, 8))


# ------------------------------------------------------ data, elasticity
@pytest.mark.parametrize("kind", ["markov", "random"])
def test_token_source_matches_jax(kind):
    from repro.train import DataConfig as JData
    from repro.train import TokenSource as JSource
    from repro_torch.train import DataConfig, TokenSource

    kw = dict(vocab_size=48, seq_len=20, global_batch=7, seed=3, kind=kind)
    a, b = JSource(JData(**kw)), TokenSource(DataConfig(**kw))
    assert a.entropy_rate() == b.entropy_rate()
    for step in (0, 1, 17):
        np.testing.assert_array_equal(a.global_batch(step),
                                      b.global_batch(step))
        for host, healthy in ((0, [0]), (1, [0, 1, 2]), (2, [0, 2])):
            for x, y in zip(a.host_batch(step, host, healthy),
                            b.host_batch(step, host, healthy)):
                np.testing.assert_array_equal(x, y)


def test_shard_rows_and_coordinator_match_jax():
    from repro.train import Coordinator as JCoord
    from repro.train import shard_rows as jshard
    from repro_torch.train import Coordinator, shard_rows

    for gb in (1, 7, 16, 33):
        for healthy in ([0], [0, 1], [3, 1, 2], [0, 2, 5, 6, 9]):
            for h in healthy:
                assert shard_rows(gb, h, healthy) == jshard(gb, h, healthy)
    a, b = JCoord([0, 1, 2, 3], heartbeat_timeout=5.0, patience=2), \
        Coordinator([0, 1, 2, 3], heartbeat_timeout=5.0, patience=2)
    events = [("hb", 0, 0.0), ("hb", 1, 0.0), ("hb", 2, 0.0), ("hb", 3, 0.0),
              ("lat", {0: 1.0, 1: 1.1, 2: 5.0, 3: 0.9}),
              ("lat", {0: 1.0, 1: 1.0, 2: 6.0, 3: 1.0}),
              ("hb", 0, 4.0), ("hb", 1, 4.0), ("to", 7.0), ("rejoin", 2),
              ("lat", {0: 1.0, 2: 1.0})]
    for ev in events:
        for c in (a, b):
            if ev[0] == "hb":
                c.heartbeat(ev[1], now=ev[2])
            elif ev[0] == "lat":
                c.report_step(ev[1])
            elif ev[0] == "to":
                c.check_timeouts(now=ev[1])
            else:
                c.rejoin(ev[1])
        assert a.healthy_hosts == b.healthy_hosts
        assert {h: dataclasses.astuple(s) for h, s in a.states.items()} == \
            {h: dataclasses.astuple(s) for h, s in b.states.items()}


# ------------------------------------------------------------ checkpoints
def _manifest_keys(d: str, step: int) -> list:
    import json

    with open(os.path.join(d, f"step_{step:09d}", "MANIFEST.json")) as f:
        return json.load(f)["keys"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_cross_load(writer, tmp_path):
    """A {"params", "opt"} checkpoint of either package restores in the
    other with the same keys, shapes and values (deepseek's leading dense
    layer under ``prefix/p0``)."""
    from repro.train import AdamW as JAdamW
    from repro.train import restore as jrestore
    from repro.train import save as jsave
    from repro_torch.train import AdamW, restore, save
    from repro_torch.train.train_loop import _jax_like, jax_state

    jcfg = jax_arch("deepseek-moe-16b").reduced()
    cfg = get_arch("deepseek-moe-16b").reduced()
    vals = noisy_values(jcfg)
    jopt = JAdamW()
    rng = np.random.default_rng(0)
    jst = jopt.init(vals)._replace(
        step=jnp.asarray(7, jnp.int32),
        m=jax.tree.map(lambda a: rng.standard_normal(a.shape)
                       .astype(np.float32), vals))
    jtree = {"params": vals, "opt": jst}
    params = from_jax_params(cfg, vals, device="cpu")
    opt = AdamW()
    tst = opt.init(params)
    tm = from_jax_params(cfg, jst.m, device="cpu")
    for n, p in tm.named_parameters():
        tst.m[n].copy_(p)
    tst.step.fill_(7)
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    jsave(dj, 7, jtree)
    save(dp, 7, jax_state(cfg, params, tst))
    assert _manifest_keys(dj, 7) == _manifest_keys(dp, 7)
    assert "params/prefix/p0/mlp/wo" in _manifest_keys(dp, 7)
    assert "opt/.m/blocks/l0/moe/router" in _manifest_keys(dp, 7)
    assert "opt/.step" in _manifest_keys(dp, 7)
    if writer == "port":
        like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            jtree)
        got, want = jrestore(dp, 7, like), jtree
    else:
        got = restore(dj, 7, _jax_like(cfg, opt))
        want = jax_state(cfg, params, tst)
    gl, wl = leaves(got), leaves(want)
    assert gl.keys() == wl.keys()
    for k in gl:
        np.testing.assert_array_equal(np.asarray(gl[k]), np.asarray(wl[k]),
                                      err_msg=k)


def test_port_trainer_resumes_jax_trainer(tmp_path):
    """A JAX ``Trainer`` checkpoints at step 2; the port's ``Trainer``
    resumes there and its next 3 losses track the JAX run's (bf16 compute
    in both: within 2e-2)."""
    from repro.train import AdamW as JAdamW
    from repro.train import DataConfig as JData
    from repro.train import TokenSource as JSource
    from repro.train import Trainer as JTrainer
    from repro_torch.train import AdamW, DataConfig, TokenSource, Trainer

    jcfg, cfg = jax_arch("qwen2-7b").reduced(**TINY), \
        get_arch("qwen2-7b").reduced(**TINY)
    kw = dict(vocab_size=64, seq_len=24, global_batch=8, kind="markov")
    okw = dict(lr=3e-3, warmup=2, total_steps=20)
    d = str(tmp_path)
    jtr = JTrainer(jcfg, JAdamW(**okw), JSource(JData(**kw)), ckpt_dir=d,
                   log_every=1, ckpt_every=2)
    jtr.run(2)
    jtr._ckpt.wait()
    want = jtr.run(3)
    tr = Trainer(cfg, AdamW(**okw), TokenSource(DataConfig(**kw)),
                 ckpt_dir=d, log_every=1, device="cpu")
    assert tr.step_idx == 2 and int(tr.opt_state.step) == 2
    got = tr.run(3)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [3, 4, 5]
    for a, b in zip(want, got):
        assert abs(a["loss"] - b["loss"]) < 2e-2, (want, got)
        assert abs(a["lr"] - b["lr"]) < 1e-9


def test_trainer_descends_and_resumes(tmp_path):
    """tests/test_train.py's trainer case on the port: the loss falls over
    30 steps and a new Trainer on the directory resumes at step 30 with
    equal parameters and moments.  Without CUDA, ``device=None`` (the
    card) raises."""
    from repro_torch.train import AdamW, DataConfig, TokenSource, Trainer

    cfg = get_arch("qwen2-7b").reduced(**TINY)
    data = TokenSource(DataConfig(vocab_size=64, seq_len=24, global_batch=8,
                                  kind="markov"))
    d = str(tmp_path)
    opt = AdamW(lr=3e-3, warmup=5, total_steps=60)
    if not torch.cuda.is_available():  # device=None is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(cfg, opt, data)
    tr = Trainer(cfg, opt, data, ckpt_dir=d, log_every=10, ckpt_every=15,
                 device="cpu")
    hist = tr.run(30)
    tr.finish()
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert set(hist[0]) == {"loss", "nll", "aux", "grad_norm", "lr", "step",
                            "sec_per_step"}
    tr2 = Trainer(cfg, opt, data, ckpt_dir=d, device="cpu")
    assert tr2.step_idx == 30
    for a, b in zip(tr.params.parameters(), tr2.params.parameters()):
        assert torch.equal(a, b)
    for k in tr.opt_state.m:
        assert torch.equal(tr.opt_state.m[k], tr2.opt_state.m[k])
        assert torch.equal(tr.opt_state.v[k], tr2.opt_state.v[k])


def test_checkpoint_roundtrip_atomicity_and_async(tmp_path):
    from repro_torch.train import (
        AsyncCheckpointer, latest_step, restore, save,
    )

    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(2, dtype=torch.bfloat16), np.int32(4)]}
    d = str(tmp_path / "c")
    save(d, 7, tree)
    save(d, 7, tree)  # idempotent double save
    assert latest_step(d) == 7
    got = restore(d, 7, tree)
    assert torch.equal(got["a"], tree["a"])
    assert got["b"][0].dtype == torch.bfloat16
    assert torch.equal(got["b"][0], tree["b"][0]) and got["b"][1] == 4
    os.makedirs(os.path.join(d, "step_000000009.tmp"))
    assert latest_step(d) == 7
    ck = AsyncCheckpointer(d, keep=2)
    for s in (8, 10, 12):
        ck.save(s, tree)
    ck.wait()
    assert latest_step(d) == 12
    assert sorted(n for n in os.listdir(d) if not n.endswith(".tmp")) == [
        "step_000000010", "step_000000012"]
    bad = AsyncCheckpointer(str(tmp_path / "f"))
    (tmp_path / "f").mkdir(exist_ok=True)
    (tmp_path / "f" / "step_000000001.tmp").write_text("a file, not a dir")
    bad.save(1, tree)
    with pytest.raises(Exception):
        bad.wait()


# ------------------------------------------------- the abstract tree, CLI
def test_abstract_params_and_to_jax_values():
    """``abstract_params`` holds no memory and counts what the JAX
    abstract tree counts at full width; ``to_jax_values`` inverts
    ``from_jax_params``."""
    for arch in ("qwen2-7b", "deepseek-moe-16b"):
        meta = abstract_params(get_arch(arch))
        assert all(p.is_meta for p in meta.parameters())
        jvals, _ = split_tree(jax_abstract_params(jax_arch(arch)))
        assert param_count(meta) == sum(int(np.prod(x.shape))
                                        for x in jax.tree.leaves(jvals))
    jcfg = jax_arch("deepseek-moe-16b").reduced()
    vals = noisy_values(jcfg)
    back = to_jax_values(get_arch("deepseek-moe-16b").reduced(),
                         from_jax_params(get_arch("deepseek-moe-16b")
                                         .reduced(), vals, device="cpu"))
    a, b = leaves(vals), leaves(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-moe-16b",
                                  "rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_decay_mask_is_the_jax_rule(arch):
    """``decay_mask`` decays a parameter where its leaf in the JAX value
    tree has ``ndim >= 2`` (the JAX optimizer's rule): the layers of the
    scan carry the unit axis there, deepseek's leading dense layer and
    the final norm do not."""
    from repro_torch.models.model import jax_path
    from repro_torch.train.optimizer import decay_mask

    cfg = get_arch(arch).reduced()
    jvals, _ = split_tree(jax_abstract_params(jax_arch(arch).reduced()))
    mask = decay_mask(cfg)
    assert mask.keys() == dict(abstract_params(cfg).named_parameters()).keys()
    for name, decayed in mask.items():
        leaf = jvals
        for k in jax_path(cfg, name)[0]:
            leaf = leaf[k]
        assert decayed == (leaf.ndim >= 2), name
    assert not mask["final_norm"] and mask["blocks.1.norm1"]
    if arch == "deepseek-moe-16b":
        assert not mask["blocks.0.norm1"]


def test_launch_train_and_example_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --reduced --device cpu`` for 10
    steps, resumed to 20 by ``main`` with the same checkpoint directory;
    and
    ``examples/train_lm_torch.py --device cpu``."""
    from repro_torch.launch.train import main

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ck = str(tmp_path / "ck")
    args = ["--reduced", "--seq", "16", "--global-batch", "4", "--ckpt", ck,
            "--device", "cpu"]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--steps", "10",
         *args], capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "resume_at=0" in res.stdout and "step     10" in res.stdout
    hist = main(["--steps", "20", *args])
    assert [h["step"] for h in hist] == [20]
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    hist = mod.main(["--device", "cpu", "--steps", "10", "--seq", "8",
                     "--batch", "2", "--layers", "1",
                     "--ckpt", str(tmp_path / "ex")])
    assert [h["step"] for h in hist] == [1, 10]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_launch_train_coordinator_two_hosts(tmp_path):
    """``--coordinator`` joins ``--hosts 2`` launcher processes in a gloo
    group over localhost TCP; each trains on its shard of every step and
    exits 0."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "10", "--seq", "16", "--global-batch", "4", "--device",
         "cpu", "--coordinator", f"localhost:{port}", "--hosts", "2",
         "--host", str(h)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for h in (0, 1)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
        assert "step     10" in out
    assert outs[0][0] != outs[1][0]  # two shards, two loss curves


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    """The card, or a skip with the reason (decided per test)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this train step runs on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_train_step_in_place(cuda_device):
    """One step of the reduced qwen2-7b on the card (``device=None``):
    parameters and moments are updated in the same storage, every
    parameter changed and received a gradient, and the step's loss is
    the CPU step's within 1e-2 (bf16 GEMMs that round elsewhere) from the same weights and batch."""
    from repro_torch.models import init_params
    from repro_torch.train import AdamW, make_train_step

    cfg = get_arch("qwen2-7b").reduced()
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)))
    losses = []
    for dev in ("cpu", None):
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        if dev is None:
            params = params.to("cuda")
        params.requires_grad_(True)
        opt = AdamW(lr=1e-3, warmup=0)
        st = opt.init(params)
        ptrs = [p.data_ptr() for p in params.parameters()]
        mptrs = [t.data_ptr() for t in st.m.values()]
        step = make_train_step(cfg, opt, microbatches=2)
        _, st, m = step(params, st, tokens.to(next(params.parameters())
                                              .device),
                        labels.to(next(params.parameters()).device))
        assert [p.data_ptr() for p in params.parameters()] == ptrs
        assert [t.data_ptr() for t in st.m.values()] == mptrs
        for (n, p), q in zip(params.named_parameters(), cpu.parameters()):
            assert not torch.equal(p.detach().cpu(), q), n
            assert bool((st.m[n] != 0).any()), n
        losses.append(float(m["loss"]))
    assert abs(losses[0] - losses[1]) < 1e-2, losses
