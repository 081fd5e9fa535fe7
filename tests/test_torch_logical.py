"""repro_torch's sharding plan vs the JAX package's, on the CPU: the
logical rules (``spec_for``, ``param_shardings``), every parameter's
logical axes, the token and cache specs, and the tuning presets.

Meshes are the production 16 x 16 ``(data, model)`` and 2 x 16 x 16
``(pod, data, model)``: the port's ``launch.mesh.AbstractMesh`` against
JAX's ``AbstractMesh`` of the same sizes (no devices behind either).  A
port spec is a tuple and equals the JAX ``PartitionSpec``'s tuple; the
port stores a scanned layer unstacked, so its spec is the JAX spec
without the leading "layers" (parameters) or unit (caches) entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import all_archs as jax_all_archs
from repro.configs import get_arch as jax_arch
from repro.models import tuning as jtuning
from repro.models.layers import split_tree
from repro.models.model import abstract_params as jax_abstract_params
from repro.models.model import init_cache as jax_init_cache
from repro.parallel import logical as jlogical
from repro.parallel import sharding as jsharding
from repro_torch.configs import get_arch
from repro_torch.launch.dryrun import SHAPES
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import tuning
from repro_torch.models.model import (
    _prefix_len, abstract_cache, abstract_params, jax_path, logical_axes,
)
from repro_torch.parallel import logical
from repro_torch.parallel import sharding

ARCHS = jax_all_archs()
MESHES = {"single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True)}
RULES = ("RULES_TP_FSDP", "RULES_DP_ONLY", "RULES_EP_DATA")
PRESETS = ["blocked_attn", "bf16_reduce", "dense_attn", "f32_reduce",
           "seq_parallel_attn", "cache_seq_shard", "moe2d", "moe_ep_data",
           "mamba_chunk=64", "rwkv_chunk=32", "opt",
           "blocked_attn,bf16_reduce,moe2d", ""]


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _jax_mesh(mesh):
    return jax.sharding.AbstractMesh(tuple(mesh.sizes), tuple(mesh.axes))


@pytest.fixture(scope="module")
def jax_axes():
    """Every arch's JAX (values, axes) trees at full size (eval_shape)."""
    return {a: split_tree(jax_abstract_params(jax_arch(a))) for a in ARCHS}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture
def fresh_tuning():
    """Both packages' process-wide knobs at their defaults, restored."""
    saved = (dataclasses.asdict(jtuning.TUNING),
             dataclasses.asdict(tuning.TUNING))
    for obj in (jtuning.TUNING, tuning.TUNING):
        for f in dataclasses.fields(obj):
            setattr(obj, f.name, f.default)
    yield
    for obj, vals in zip((jtuning.TUNING, tuning.TUNING), saved):
        for k, v in vals.items():
            setattr(obj, k, v)


def test_spec_for_divisibility_fallback():
    """The reference's own cases (tests/test_sharding_distributed.py)."""
    mesh = _FakeMesh({"data": 16, "model": 16})
    P = logical.PartitionSpec
    s = logical.spec_for((2560, 20, 128), ("embed", "heads", "head_dim"),
                         logical.RULES_TP_FSDP, mesh)
    assert s == P("data") == tuple(jax.sharding.PartitionSpec("data"))
    s = logical.spec_for((2560, 32, 128), ("embed", "heads", "head_dim"),
                         logical.RULES_TP_FSDP, mesh)
    assert s == P("data", "model")
    s = logical.spec_for((64, 64), ("mlp", "mlp"), logical.RULES_TP_FSDP,
                         mesh)
    assert s == P("model")
    assert logical.batch_axes(MESHES["multi"]) == ("pod", "data")
    assert logical.mesh_axis_size(MESHES["multi"], ("pod", "data")) == 32


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_match_jax(arch, jax_axes):
    """``logical_axes(cfg)`` equals the JAX ``split_tree`` axes leaf for
    leaf (through ``jax_path``), and covers every JAX leaf."""
    cfg = get_arch(arch)
    _, axes = jax_axes[arch]
    ours = logical_axes(cfg)
    paths = set()
    for name, ax in ours.items():
        path, _ = jax_path(cfg, name)
        assert tuple(_leaf(axes, path)) == ax, name
        paths.add(path)
    n_jax = len(jax.tree.leaves(axes, is_leaf=lambda x: isinstance(x,
                                                                   tuple)))
    assert len(paths) == n_jax


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh, rules, jax_axes):
    """``param_shardings`` equals JAX's ``spec_for`` for every parameter
    at full size: a top-level or leading dense layer's spec as is, a
    scanned layer's as JAX's spec of one unit slice (its ``block_specs``)
    and as the stacked spec without its "layers" entry."""
    cfg = get_arch(arch)
    m = MESHES[mesh]
    values, axes = jax_axes[arch]
    specs = logical.param_shardings(abstract_params(cfg),
                                    getattr(logical, rules), m)
    jrules = getattr(jlogical, rules)
    assert len(specs) == len(logical_axes(cfg))
    for name, spec in specs.items():
        path, u = jax_path(cfg, name)
        shape, ax = tuple(_leaf(values, path).shape), _leaf(axes, path)
        full = tuple(jlogical.spec_for(shape, ax, jrules, m))
        if u is None:
            assert spec == full, name
        else:
            unit = tuple(jlogical.spec_for(shape[1:], ax[1:], jrules, m))
            assert spec == unit, name
            assert full == ((None, *spec) if spec else ()), name


@pytest.mark.parametrize("cache_seq_shard", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_token_and_cache_specs_match_jax(arch, mesh, cache_seq_shard,
                                         fresh_tuning):
    """``token_sharding``, ``seq_shard_axis`` and ``cache_sharding``
    equal JAX's for every ``SHAPES`` entry; a cache leaf's spec is the
    JAX spec of the same leaf of its layout (stacked ``[n_units, B,
    ...]``) without the unit entry."""
    m = MESHES[mesh]
    jm = _jax_mesh(m)
    jtuning.TUNING.cache_seq_shard = cache_seq_shard
    tuning.TUNING.cache_seq_shard = cache_seq_shard
    cfg, jcfg = get_arch(arch), jax_arch(arch)
    pk = _prefix_len(cfg)
    for shape in SHAPES.values():
        B, S = shape["batch"], shape["seq"]
        assert sharding.token_sharding(m, B) == tuple(
            jsharding.token_sharding(jm, B).spec)
        assert sharding.seq_shard_axis(m, B, S) == \
            jsharding.seq_shard_axis(jm, B, S)
        jc = jax.eval_shape(lambda: jax_init_cache(jcfg, B, S, jnp.bfloat16))
        jspecs = jsharding.cache_sharding(jcfg, jm, B, S)(jc)
        ours = sharding.cache_sharding(cfg, m, B, S)(
            abstract_cache(cfg, B, S))
        assert len(ours) == cfg.num_layers
        for i, st in enumerate(ours):
            if i < pk:
                want = jspecs["prefix"][f"p{i}"]
                for got, w in zip(st, want):
                    assert got == tuple(w.spec), (i, got, w.spec)
            else:
                want = jspecs["blocks"][f"l{(i - pk) % cfg.scan_unit}"]
                for got, w in zip(st, want):
                    assert ((None, *got) if got else ()) == tuple(w.spec), (
                        i, got, w.spec)


@pytest.mark.parametrize("preset", PRESETS)
def test_apply_preset_matches_jax(preset, fresh_tuning):
    """Every preset gives JAX's ``Tuning``, every field, and the same
    ``seq_spec``."""
    jtuning.apply_preset(preset)
    tuning.apply_preset(preset)
    assert dataclasses.asdict(tuning.TUNING) == dataclasses.asdict(
        jtuning.TUNING)
    for extra in (1, 2):
        j = jtuning.seq_spec(extra)
        got = tuning.seq_spec(extra)
        assert (got is None and j is None) or got == tuple(j)
    tuning.TUNING.batch_axes = jtuning.TUNING.batch_axes = ("data",)
    j = jtuning.seq_spec()
    assert (tuning.seq_spec() is None and j is None) or \
        tuning.seq_spec() == tuple(j)


def test_unknown_presets_and_knobs_raise(fresh_tuning):
    """As in JAX: an unknown preset is a ValueError, an unknown knob an
    AttributeError."""
    for mod in (jtuning, tuning):
        with pytest.raises(ValueError, match="unknown tuning preset"):
            mod.apply_preset("blocked_attn,no_such_preset")
        with pytest.raises(AttributeError, match="unknown tuning knob"):
            mod.set_tuning(no_such_knob=1)
    assert [f.name for f in dataclasses.fields(tuning.Tuning)] == [
        f.name for f in dataclasses.fields(jtuning.Tuning)]


def test_abstract_cache_is_init_cache_on_meta():
    cfg = get_arch("jamba-1.5-large-398b")
    caches = abstract_cache(cfg, 4, 1024)
    assert all(t.device.type == "meta" for st in caches for t in st)
    jc = jax.eval_shape(lambda: jax_init_cache(jax_arch(cfg.name), 4, 1024,
                                               jnp.bfloat16))
    pk = _prefix_len(cfg)
    for i, st in enumerate(caches):
        want = jc["blocks"][f"l{(i - pk) % cfg.scan_unit}"]
        for t, w in zip(st, want):
            assert tuple(t.shape) == tuple(w.shape[1:])
            assert t.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                               else torch.float32)


def test_small_mesh_and_rank_mesh_read_alike():
    """A ``RankMesh`` of one rank and an ``AbstractMesh`` give the same
    specs (``spec_for`` reads only ``.shape``)."""
    from repro_torch.launch.mesh import make_host_mesh

    rm = make_host_mesh((1, 1), ("data", "model"), device="cpu")
    am = AbstractMesh(("data", "model"), (1, 1))
    cfg = get_arch("qwen2-7b").reduced()
    meta = abstract_params(cfg)
    assert logical.param_shardings(meta, logical.RULES_TP_FSDP, rm) == \
        logical.param_shardings(meta, logical.RULES_TP_FSDP, am)
    assert rm.group is None and rm.size == 1
