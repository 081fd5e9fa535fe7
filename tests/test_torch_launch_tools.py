"""The port's planning tools on the CPU: ``launch.op_cost`` (the
counterpart of ``hlo_cost``), ``roofline``, ``quant_roofline``,
``dryrun`` on the production mesh and ``report``.

  * ``op_cost`` counts a matmul, an einsum, an index gather and an
    all-gather under torch's ``fake`` process group as its rules say;
  * ``quant_roofline.verify`` passes the reference test's asserts
    (``tests/test_system.py``: flops equal in every storage mode, the AI
    bars, fewer bytes than f32, memory-bound on the H100's ridge), and
    ``--gate`` passes at the record's default shape;
  * the dry run's ``rwkv6-1.6b decode_32k`` cell on the 16 x 16
    production mesh (the reference's own test cell) and ``qwen2-7b
    decode_32k`` on a 4 x 4 mesh give records with no error, a compute
    term, a rank's total bytes under the card's 80 GB, and a rank's
    parameter bytes equal to what JAX's ``param_shardings`` shard shapes
    give; ``report`` renders them;
  * the tuned cells: ``qwen2-7b prefill_32k`` on 16 x 16 under ``opt``
    (28 heads on a 16-way ``model`` axis: sequence-parallel attention)
    attends over at most 1/8 of the untuned cell's query-key pairs a rank
    and its ``decode_32k`` cache holds 1/16 of the slots; ``qwen2-moe-
    a2.7b decode_32k`` under ``--rules ep_data --tune moe_ep_data``
    gathers exactly its non-expert leaves' bytes and sends the tokens to
    the experts by all-to-alls over ``data``; ``qwen2-7b train_4k`` on a
    1 x 2 mesh (one microbatch) under ``residual_spec = (("data",
    "model"), None, None)`` puts the untuned cell's ``model`` wire bytes
    on gathers and reduce-scatters, the same bytes but for the norm
    scales' gradient all-reduces, and keeps fewer live bytes.

JAX is imported inside the test that compares with it; the CUDA case
(``--measure``) runs where JAX is not installed.
"""
import dataclasses
import json
import math

import pytest
import torch

from repro_torch.launch import dryrun, op_cost, quant_roofline, report
from repro_torch.launch import roofline
from repro_torch.launch.mesh import (
    AbstractMesh, make_host_mesh, make_production_mesh,
)


def test_op_cost_counts_by_its_rules():
    meta = dict(device="meta")
    with op_cost.OpCost() as oc:
        torch.empty(4, 8, **meta) @ torch.empty(8, 3, **meta)
    assert oc.flops == 2 * 4 * 3 * 8 and oc.bytes == 4 * (32 + 24 + 12)
    with op_cost.OpCost() as oc:
        x = torch.empty(2, 5, 8, **meta)
        torch.einsum("btd,de->bte", x, torch.empty(8, 3, **meta))
    assert oc.flops == 2 * 2 * 5 * 3 * 8
    with op_cost.OpCost() as oc:  # a gather charges its whole source
        t = torch.empty(100, 8, **meta)
        t[torch.empty(4, 3, dtype=torch.long, **meta)]
    assert oc.flops == 0 and oc.bytes == 100 * 8 * 4 + 12 * 8 + 12 * 8 * 4
    with op_cost.OpCost() as oc:  # a row sum over a product: a contraction
        a = torch.empty(6, 16, **meta)
        (a * a).sum(-1)
        (a * 2.0).float()  # an elementwise product alone counts none
    assert oc.flops == 2 * 6 * 16
    with op_cost.OpCost() as oc:  # views are free
        a.view(16, 6).t().unsqueeze(0)[:, 1:].reshape(5, 16)[2]
    assert oc.bytes == 0 and oc.ops == 0


def test_op_cost_counts_collectives_on_the_fake_group():
    import torch.distributed as dist

    mesh = AbstractMesh(("data", "model"), (4, 2))
    with dryrun._fake_world(mesh) as rm:
        assert rm.size == 8 and dist.get_world_size() == 8
        src = torch.empty(1000)
        out = torch.empty(8000)
        with op_cost.OpCost(8) as oc:
            dist.all_gather_into_tensor(out, src, group=rm.group)
            dist.all_reduce(src, group=rm.group)
    assert not dist.is_initialized()
    s = 8000 * 4
    assert oc.coll.by_op["all-gather"] == s * 7 / 8
    assert oc.coll.by_op["all-reduce"] == 2 * 4000 * 7 / 8
    assert oc.record()["coll_max_group"] == 8


def test_roofline_h100_terms():
    assert roofline.link_bw(8) == roofline.NVLINK_BW == 450e9
    assert roofline.link_bw(16) == roofline.NET_BW == 50e9
    t = roofline.roofline_terms(989e12, 3.35e12, 450e9, 8, per_device=True)
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0
    assert roofline.wire_bytes("reduce-scatter", 10, 4) == 30


def test_quant_roofline_verify_matches_the_reference_asserts():
    recs = quant_roofline.verify(n=1 << 16, d=128, B=32, W=16)
    assert recs["int8"]["flops"] == recs["f32"]["flops"] == \
        recs["bf16"]["flops"] == 4 * 32 * 16 * 128
    for mode, bar in quant_roofline.AI_GATE.items():
        assert recs[mode]["ai_vs_f32"] >= bar, (mode, recs[mode])
        assert recs[mode]["bytes"] < recs["f32"]["bytes"], (mode, recs[mode])
    ridge = roofline.PEAK_FLOPS / roofline.HBM_BW
    for mode in recs:
        assert recs[mode]["terms"]["bottleneck"] == "memory_s", recs[mode]
        assert recs[mode]["ai"] < ridge
    out = quant_roofline.main(["--gate"])  # the record's default shape
    assert out["counted"]["int8"]["shape"] == {"n": 1 << 17, "d": 128,
                                               "B": 128, "W": 48}


def test_measure_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quant_roofline.measure(n=1024, d=16, B=2, W=4)


def _jax_param_bytes(arch: str, mesh) -> int:
    import jax

    from repro.configs import get_arch as jax_arch
    from repro.models.model import abstract_params
    from repro.parallel.logical import RULES_TP_FSDP, param_shardings

    jm = jax.sharding.AbstractMesh(tuple(mesh.sizes), tuple(mesh.axes))
    values, shardings = param_shardings(abstract_params(jax_arch(arch)),
                                        RULES_TP_FSDP, jm)
    return sum(4 * math.prod(s.shard_shape(v.shape)) for v, s in zip(
        jax.tree.leaves(values), jax.tree.leaves(shardings)))


@pytest.mark.parametrize("arch, mesh", [
    ("rwkv6-1.6b", make_production_mesh()),
    ("qwen2-7b", AbstractMesh(("data", "model"), (4, 4))),
], ids=["rwkv6-1.6b-16x16", "qwen2-7b-4x4"])
def test_dryrun_decode_cell(arch, mesh, tmp_path):
    rec = dryrun.build_cell(arch, "decode_32k", mesh)
    assert "error" not in rec and "skipped" not in rec
    assert rec["terms"]["compute_s"] > 0
    assert rec["memory"]["total_bytes"] < 80e9  # the H100's HBM
    assert rec["memory"]["param_bytes"] == _jax_param_bytes(arch, mesh)
    assert rec["chips"] == mesh.size and rec["mesh"] == mesh.shape
    assert rec["collectives"]["by_op"]["all-gather"] > 0
    assert set(rec["tuning"]) >= {"tp_reduce_dtype", "cache_seq_shard",
                                  "moe_expert_axis", "residual_spec"}
    assert rec["tuning_inert"] == []
    for key in ("hlo_flops_per_device", "hlo_bytes_per_device", "model_flops",
                "useful_flops_ratio", "params_active", "trace_s"):
        assert key in rec
    d = tmp_path / "single"
    d.mkdir()
    (d / f"{arch}__decode_32k.json").write_text(json.dumps(rec))
    recs = report.load(str(d))
    table = report.roofline_table(recs)
    assert arch in table and rec["terms"]["bottleneck"][:-2] in table
    assert report.summary(recs)["traced"] == 1
    assert arch in report.main(["--dir", str(tmp_path)])
    assert arch in dryrun.fmt_row(rec)


@pytest.fixture
def tuned():
    """Apply presets inside a test; every knob is restored after it."""
    from repro_torch.models import tuning

    saved = dataclasses.asdict(tuning.TUNING)
    yield tuning.apply_preset
    for k, v in saved.items():
        setattr(tuning.TUNING, k, v)


def test_dryrun_opt_splits_attention_and_cache(tuned, monkeypatch):
    """qwen2-7b on 16 x 16 (module docstring): rank 0's query-key pairs
    under ``opt`` against the untuned prefill's (the plain attention is
    wrapped to count them), both decode caches' bytes, and neither
    record names ``attn_seq_axis`` inert."""
    from repro_torch.kernels import ops

    pairs = []
    flash = ops.flash_attention

    def counted(q, k, v, *a, **kw):
        pairs.append(q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2])
        return flash(q, k, v, *a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counted)
    mesh = make_production_mesh()
    base = dryrun.build_cell("qwen2-7b", "prefill_32k", mesh)
    base_pairs = sum(pairs)
    dec = dryrun.build_cell("qwen2-7b", "decode_32k", mesh)
    pairs.clear()
    tuned("opt")
    rec = dryrun.build_cell("qwen2-7b", "prefill_32k", mesh)
    opt_dec = dryrun.build_cell("qwen2-7b", "decode_32k", mesh)
    for r in (base, dec, rec, opt_dec):
        assert "error" not in r, r
    assert 0 < sum(pairs) <= base_pairs / 8, (sum(pairs), base_pairs)
    assert rec["hlo_flops_per_device"] < base["hlo_flops_per_device"]
    assert rec["tuning"]["attn_seq_axis"] == "model"
    assert rec["tuning_inert"] == [] and opt_dec["tuning_inert"] == []
    assert rec["rank_collectives"]["tp_gather_n"] > 0
    assert opt_dec["memory"]["cache_bytes"] * 16 == \
        dec["memory"]["cache_bytes"]
    assert "KVCache.k: ['data', 'model', None, None]" in \
        opt_dec["cache_specs"]


def test_dryrun_ep_data_gathers_no_expert(tuned):
    """qwen2-moe-a2.7b decode_32k on 16 x 16 under ``--rules ep_data
    --tune moe_ep_data``: rank 0's gathers carry the top-level leaves in
    f32 and each layer's non-expert leaves in bf16, once each; the expert
    leaves (4 of the 64 padded experts a rank) are in no bucket; the
    all-to-alls ran; ``moe_expert_axis`` is named inert."""
    from repro_torch.models.model import abstract_params
    from repro_torch.parallel import RULES_EP_DATA, param_shardings
    from repro_torch.train.train_loop import ShardedParams

    tuned("moe_ep_data")
    mesh = make_production_mesh()
    rec = dryrun.build_cell("qwen2-moe-a2.7b", "decode_32k", mesh,
                            "ep_data")
    assert "error" not in rec, rec
    cfg = dryrun.get_arch("qwen2-moe-a2.7b")
    specs = param_shardings(abstract_params(cfg), RULES_EP_DATA, mesh)
    with dryrun._fake_world(mesh) as rmesh:
        sp = ShardedParams(cfg, rmesh, specs, ("data",))
    names = {n for b in [sp.top, *sp.layer_buckets] for n in b.names}
    assert sp.expert_leaves and not sp.expert_leaves & names
    assert all(sp.layouts[n].local[0] == 4 for n in sp.expert_leaves)
    lay = sp.compute_layouts
    want = sum(lay[n].chunk * 4 for n in sp.top.names) + sum(
        lay[n].chunk * 2 for b in sp.layer_buckets for n in b.names)
    st = rec["rank_collectives"]
    assert st["gather_bytes"] == want, (st, want)
    assert st["ep_all_to_all_n"] > 0 and st["ep_all_to_all_bytes"] > 0
    assert rec["tuning_inert"] == ["moe_expert_axis"]


def test_dryrun_cli_skips_and_writes(tmp_path):
    """``main`` writes a record per cell; a quadratic arch's long_500k is
    skipped with the reference's reason."""
    recs = dryrun.main(["--arch", "qwen2-7b", "--shape", "long_500k",
                        "--out", str(tmp_path)])
    assert recs[0]["skipped"].startswith("full quadratic attention")
    assert (tmp_path / "single" / "qwen2-7b__long_500k.json").exists()


@pytest.mark.parametrize("preset, inert", [
    ("moe_ep_data", ["moe_expert_axis"]),
    ("seq_parallel_attn,bf16_reduce", []),
    ("opt", []),
    ("blocked_attn,moe2d,cache_seq_shard", []),
    ({"residual_spec": (("data", "model"), None, None)}, []),
    ({"residual_spec": (("data",), None, "model")}, ["residual_spec"]),
])
def test_tuning_names_the_knobs_the_port_does_not_read(preset, inert):
    """A preset's sharding-only knobs (``tuning.SHARDING_ONLY``) are named
    in the dry-run record's ``tuning_inert``; the knobs that change the
    port's numbers or plan are not: ``attn_seq_axis`` is read since the
    port runs sequence-parallel attention, and ``residual_spec`` with
    ``model`` on the batch (the residual stream split over ``model``).
    With ``model`` on the embed dimension it stays inert: the port keeps
    the residual whole there.  ``residual_spec`` is set by no preset,
    only by ``set_tuning`` (the dict cases)."""
    from repro_torch.models import tuning

    saved = dataclasses.asdict(tuning.TUNING)
    try:
        if isinstance(preset, dict):
            tuning.set_tuning(**preset)
        else:
            tuning.apply_preset(preset)
        assert tuning.inert_knobs() == inert
    finally:
        for k, v in saved.items():
            setattr(tuning.TUNING, k, v)


def test_dryrun_residual_split_moves_the_same_bytes():
    """``qwen2-7b train_4k`` on a 1 x 2 mesh in one microbatch, untuned
    and under ``residual_spec = (("data", "model"), None, None)``: the
    knob is not inert; its ``model`` collectives are gathers and
    reduce-scatters where the untuned cell's are all-reduces, and their
    ring-model wire bytes a rank equal the untuned cell's plus the norm
    scales' gradient all-reduces (2 a layer and the final norm, d f32
    each; the bf16 gathers and the rematerialised forward's gathers
    make up the f32 half of each all-reduce); the peak of live bytes
    falls (each unit's saved input is the rank's rows)."""
    from repro_torch.models import tuning

    cfg = dryrun.get_arch("qwen2-7b")
    mesh = AbstractMesh(("data", "model"), (1, 2))
    saved = tuning.TUNING.residual_spec
    try:
        base = dryrun.build_cell("qwen2-7b", "train_4k", mesh,
                                 microbatches=1)
        tuning.set_tuning(residual_spec=(("data", "model"), None, None))
        rec = dryrun.build_cell("qwen2-7b", "train_4k", mesh,
                                microbatches=1)
    finally:
        tuning.TUNING.residual_spec = saved
    for r in (base, rec):
        assert "error" not in r, r
    assert rec["tuning_inert"] == [] and base["tuning_inert"] == []

    def wire(r):
        return sum(v for k, v in r["rank_collectives"].items()
                   if k.startswith("tp_") and k.endswith("_wire"))

    st, bt = rec["rank_collectives"], base["rank_collectives"]
    assert bt.get("tp_reduce_scatter_n", 0) == 0
    assert st["tp_reduce_scatter_n"] > 0 and st["tp_gather_n"] > 0
    norms = (2 * cfg.num_layers + 1) * cfg.d_model * 4  # 2 (n-1)/n = 1
    assert wire(rec) == wire(base) + norms, (wire(rec), wire(base), norms)
    assert rec["memory"]["temp_bytes"] < base["memory"]["temp_bytes"]


def test_host_mesh_one_rank_needs_no_group():
    m = make_host_mesh((1, 1), ("data", "model"), device="cpu")
    assert m.group is None and m.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="needs an initialised"):
        make_host_mesh((2, 1), ("data", "model"), device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: --measure times the kernel on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_measure_times_every_mode(cuda_device):
    out = quant_roofline.measure(n=1 << 17, d=128, B=128, W=48, reps=5,
                                 rounds=3)
    assert set(out["modes"]) == {"f32", "bf16", "int8"}
    for mode, r in out["modes"].items():
        assert r["launches"] >= 1 + 5 * 3, (mode, r)
        assert 0 < r["bound_ms"] < r["ms"] < r["call_ms"], (mode, r)
    assert out["modes"]["int8"]["bytes"] < out["modes"]["f32"]["bytes"]
