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
    give; ``report`` renders them.

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


def test_dryrun_cli_skips_and_writes(tmp_path):
    """``main`` writes a record per cell; a quadratic arch's long_500k is
    skipped with the reference's reason."""
    recs = dryrun.main(["--arch", "qwen2-7b", "--shape", "long_500k",
                        "--out", str(tmp_path)])
    assert recs[0]["skipped"].startswith("full quadratic attention")
    assert (tmp_path / "single" / "qwen2-7b__long_500k.json").exists()


@pytest.mark.parametrize("preset, inert", [
    ("moe_ep_data", ["moe_expert_axis"]),
    ("seq_parallel_attn,bf16_reduce", ["attn_seq_axis"]),
    ("opt", ["attn_seq_axis"]),
    ("blocked_attn,moe2d,cache_seq_shard", []),
])
def test_tuning_names_the_knobs_the_port_does_not_read(preset, inert):
    """A preset's sharding-only knobs (``tuning.SHARDING_ONLY``) are named
    in the dry-run record's ``tuning_inert``; the knobs that change the
    port's numbers or plan are not."""
    from repro_torch.models import tuning

    saved = dataclasses.asdict(tuning.TUNING)
    try:
        tuning.apply_preset(preset)
        assert tuning.inert_knobs() == inert
    finally:
        for k, v in saved.items():
            setattr(tuning.TUNING, k, v)


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
