"""The ``model`` split's plan, its cost and the launcher's ``--mesh``
with ``--ingest`` on the CPU:

  * ``logical.model_parts`` for every parameter of all ten archs at full
    size names the dimension that ``spec_for`` puts on ``model`` and the
    rank's range of it, on the 16 x 16, 2 x 16 x 16 and 4 x 4 meshes, and
    ``fsdp_spec`` keeps every other axis;
  * on a 2 x 2 mesh the layouts a rank gathers hold its ``model`` part
    of every leaf of the four reduced archs and are cut over ``data``
    alone (no leaf is gathered over ``model``), their slices the stored
    ones;
  * ``op_cost``'s matmul flops (``OpCost.matmul_flops``) of rank 0's
    ``(1 x 2)`` train step, walked on ``FakeTensor``s under the ``fake``
    group (2 microbatches of the reduced configs of
    ``tests/test_torch_train_mesh.py``), are half of the one-rank step's
    for qwen2-7b, where every product splits, and for qwen2-moe-a2.7b
    half plus half of what the whole router's products cost (every rank
    routes the whole microbatch: its forward, the remat's and the two
    gradient products).  The elementwise contractions that ``op_cost``
    also counts (the norms' backward, the MoE combine) run whole on every
    rank;
  * ``launch.serve --mesh 1x1 --ingest 64 --compact 8,8 --index-dir D``
    prints the JAX launcher's served, hop, ingested, re-served and
    checkpoint lines for the same arguments (times and paths aside);
  * a rank whose q heads split over ``model`` while the kv heads stay
    whole reads the kv heads GQA maps its q heads to: a slice when they
    group evenly, one kv head per q head when they straddle groups
    (qwen2-7b's 28 q / 4 kv heads on a 7-way ``model`` axis);
  * the dry run's ``qwen2-7b decode_32k`` cell on a 4 x 4 mesh computes
    rank 0's part over ``model``: its ``useful_flops_ratio`` is at least
    3x the 0.140 of the step that replicated the compute over ``model``
    (0.1395), its KV caches hold one of the 4 kv heads, and its
    collectives include the ``model`` all-reduces.

JAX is imported inside the launcher test.
"""
import contextlib
import io
import sys

import pytest
import torch

from _torch_ranks import _mesh_cfg
from repro_torch.configs import all_archs, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.models.model import abstract_params, param_axes
from repro_torch.parallel import (
    RULES_EP_DATA, RULES_TP_FSDP, fsdp_spec, model_parts, param_shardings,
    spec_for, token_sharding,
)

MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "4x4": AbstractMesh(("data", "model"), (4, 4))}
REPLICATED_RATIO = 0.140  # qwen2-7b decode_32k on 4 x 4, compute replicated


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rules", ["tp_fsdp", "ep_data"])
def test_model_parts_follow_spec_for(mesh, rules):
    mesh = MESHES[mesh]
    rules = {"tp_fsdp": RULES_TP_FSDP, "ep_data": RULES_EP_DATA}[rules]
    n = mesh.shape["model"]
    for arch in all_archs():
        meta = abstract_params(get_arch(arch))
        shapes = {k: tuple(t.shape) for k, t in meta.named_parameters()}
        specs = param_shardings(meta, rules, mesh)
        for coord in (0, n - 1):
            parts = model_parts(shapes, specs, mesh, coord)
            for name, shape in shapes.items():
                spec = spec_for(shape, param_axes(name), rules, mesh)
                assert specs[name] == spec
                on = [d for d, a in enumerate(spec) if a == "model"]
                if not on:
                    assert parts[name] is None, (arch, name)
                    continue
                d, = on
                local = shape[d] // n
                assert parts[name] == (d, coord * local,
                                       (coord + 1) * local), (arch, name)
                assert "model" not in fsdp_spec(spec)
                assert [a for a in fsdp_spec(spec) if a] == [
                    a for a in spec if a and a != "model"]


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-moe-a2.7b",
                                  "rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_2x2_step_gathers_over_data_only(arch):
    """On a 2 x 2 mesh (rank 0 under the ``fake`` group) the layouts the
    step gathers hold the rank's ``model`` part of every leaf and are cut
    over ``data`` alone: no leaf is gathered over ``model``."""
    from repro_torch.train.train_loop import ShardedParams

    cfg = _mesh_cfg(arch)
    mesh = AbstractMesh(("data", "model"), (2, 2))
    with dryrun._fake_world(mesh) as rm:
        meta = abstract_params(cfg)
        specs = param_shardings(meta, RULES_TP_FSDP, rm)
        sp = ShardedParams(cfg, rm, specs)
        assert sp.fsdp.axes == ("data",) and sp.model.axes == ("model",)
        for name, t in meta.named_parameters():
            want = list(t.shape)
            on = [d for d, a in enumerate(specs[name]) if a == "model"]
            for d in on:
                want[d] //= 2
            lay = sp.compute_layouts[name]
            assert list(lay.shape) == want, name
            assert "model" not in lay.kept
            assert lay.local == sp.layouts[name].local, name


def _step_flops(arch: str, shape: tuple) -> float:
    """Matmul-class flops of rank 0's train step on a ``shape`` ``(data,
    model)`` mesh, walked on fake tensors under the ``fake`` group."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import tree_from_named
    from repro_torch.train import AdamW, jit_train_step, make_train_step

    cfg = _mesh_cfg(arch)
    mesh = AbstractMesh(("data", "model"), shape)
    with dryrun._fake_world(mesh) as rm:
        meta = abstract_params(cfg)
        specs = param_shardings(meta, RULES_TP_FSDP, rm)
        blocks = {k: s for k, s in specs.items() if k.startswith("blocks.")}
        opt = AdamW()
        js = jit_train_step(make_train_step(
            cfg, opt, microbatches=2, grad_shardings=specs,
            block_param_specs=blocks), rm, specs, token_sharding(rm, 8))
        lay = js.sharded.layouts
        with FakeTensorMode():
            params = tree_from_named({k: torch.empty(lay[k].local)
                                      for k, _ in meta.named_parameters()})
            params.requires_grad_(True)
            state = opt.init(params)
            tok = torch.zeros((8, 16), dtype=torch.int32)
            with OpCost(mesh.size) as oc:
                js(params, state, tok, tok)
    return oc.matmul_flops


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-moe-a2.7b"])
def test_1x2_step_runs_half_the_products(arch):
    cfg = _mesh_cfg(arch)
    one, two = _step_flops(arch, (1, 1)), _step_flops(arch, (1, 2))
    whole = 0.0
    if cfg.moe is not None:  # the router's products, whole on every rank
        tokens = 8 // 2 * 16  # a microbatch's
        product = 2 * tokens * cfg.d_model * cfg.moe.num_experts
        layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
        # forward, its remat, two gradients; 2 microbatches
        whole = 4 * product * 2 * layers
    assert one > 0 and two == one / 2 + whole / 2, (one, two, whole)


def _lines(text: str) -> list[str]:
    keep = ("served ", "hops-to-termination", "re-served ")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def test_launcher_mesh_ingest_compact_prints_jax_lines(tmp_path, capsys):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    args = ["--n", "400", "--dim", "16", "--queries", "24", "--width", "32",
            "--m", "8", "--ef-construction", "32", "--mesh", "1x1",
            "--ingest", "64", "--compact", "8,8"]
    argv, buf = sys.argv, io.StringIO()
    sys.argv = ["serve", *args, "--index-dir", str(tmp_path / "jax")]
    try:
        with contextlib.redirect_stdout(buf):
            jserve.main()
    finally:
        sys.argv = argv
    want = buf.getvalue()
    out = serve.main([*args, "--index-dir", str(tmp_path / "port"),
                      "--device", "cpu"])
    got = capsys.readouterr().out
    assert len(_lines(want)) == 3 and _lines(got) == _lines(want), (got,
                                                                    want)
    for text in (got, want):
        ingested = [ln for ln in text.splitlines()
                    if ln.startswith("ingested 64 vectors in ")]
        assert len(ingested) == 1 and ingested[0].endswith("(464 live)")
        assert sum(ln.startswith("incremental checkpoint to ")
                   for ln in text.splitlines()) == 1, text
    assert out["mesh"]["shape"] == (1, 1)
    assert out["mesh_ingest"]["compact"] == (8, 8)
    assert len(out["index"]) == 464


def test_dryrun_decode_cell_computes_its_model_part():
    mesh = MESHES["4x4"]
    rec = dryrun.build_cell("qwen2-7b", "decode_32k", mesh)
    assert "error" not in rec
    assert rec["useful_flops_ratio"] >= 3 * REPLICATED_RATIO, rec
    cfg = get_arch("qwen2-7b")
    rows = rec["rows_per_rank"]
    assert rec["memory"]["cache_bytes"] == 2 * cfg.num_layers * rows * \
        32768 * (cfg.num_kv_heads // 4) * cfg.resolved_head_dim * 2
    assert rec["collectives"]["by_op"]["all-reduce"] > 0


@pytest.mark.parametrize("n, r, want", [
    (7, 0, [0, 0, 0, 0]), (7, 1, [0, 0, 0, 1]), (7, 6, [3, 3, 3, 3]),
    (2, 1, [2] * 7 + [3] * 7)])
def test_whole_kv_heads_follow_gqa(n, r, want):
    import dataclasses

    from repro_torch.models.attention import _kv_of_q
    from repro_torch.parallel import ModelSplit

    cfg = dataclasses.replace(get_arch("qwen2-7b"), num_kv_heads=4)
    tp = ModelSplit(n, r, {"wk": None}, None)
    hq = cfg.num_heads // n
    k = torch.arange(4.0).view(1, 1, 4, 1).expand(2, 3, 4, 5)
    kq, vq = _kv_of_q(cfg, tp, hq, k, -k)
    heads = kq[0, 0, :, 0].tolist()
    assert torch.equal(vq, -kq)
    # GQA reads kv head j // (hq / heads) for the rank's q head j
    assert [heads[j * len(heads) // hq] for j in range(hq)] == want
