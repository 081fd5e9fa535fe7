"""Train step and host-side Trainer (the port of ``repro.train.
train_loop``): checkpoint/restart, the deterministic data source, resume
by manifest, and the step sharded over a mesh of ranks.

``make_train_step`` returns the step that the JAX package jits:
microbatch gradient accumulation (an f32 sum over the microbatches, then
the mean, as the JAX scan), the gradients of ``models.loss_fn`` (each
scan unit rematerialised), and the AdamW update written in place.  No
kernel has a backward in either package: the step runs autograd through
the plain versions (``backend="ref"``, the JAX default).

``jit_train_step(step, mesh, param_shardings, batch_sharding)`` runs that
step over a ``parallel.RankMesh`` of ``torch.distributed`` ranks, one
process a rank, with axes ``(data, model)`` or ``(pod, data, model)``:
PyTorch's form of the reference's single-controller SPMD jit.  Every
rank calls it with the same global batch.  Each parameter's spec
(``parallel.logical.param_shardings``) decides what a rank stores and
what it computes:

  * each rank holds the slice of every parameter and of both AdamW
    moments that its coordinates on the spec's mesh axes select
    (``ShardedParams.shard`` cuts them, in place);
  * the dimension that the spec puts on ``model`` (heads, kv heads, mlp,
    experts, Mamba's inner channels, RWKV's heads x dim, the vocab) is
    never gathered over ``model``: the forward computes the rank's part
    of it (tensor and expert parallelism, ``parallel.tensor_parallel``),
    given as a ``ModelSplit`` (``ShardedParams.model_split``) from the
    step's hooks to ``models.loss_fn``.  A dimension that ``spec_for``
    leaves whole is computed whole, as in the reference;
  * only the spec's other axes, the FSDP axes (``data``, ``pod``), are
    gathered, over the FSDP group (the ranks with this rank's ``model``
    coordinate), so a layer arrives as the rank's ``model`` part.  The top
    level leaves (embedding, final norm, head) are gathered once a step in
    f32; with ``block_param_specs`` each layer's floating leaves are cast
    to the compute type first (the reference casts a unit while it is
    still sharded, so the FSDP all-gathers move bf16) and all-gathered
    inside its forward by an autograd function, again when the
    rematerialised unit runs in backward, and that function's backward
    reduce-scatters the gradient in the dtype autograd gives it there
    (the transpose of the bf16 gather) before the cast's backward lands
    it in the f32 accumulator; without it every layer is gathered once
    a forward, in f32.  The ranks that hold the same part (the spec
    leaves an FSDP axis whole) each send a piece of it, so every element
    crosses the wire once;
  * the collectives of a layer over ``model``, per microbatch forward
    (run again when the unit is rematerialised; the backward's are the
    transposes): attention, its q/k/v input's backward all-reduce and
    the row-parallel ``wo``'s all-reduce; an MLP (and a shared expert)
    the same pair; an MoE layer, the combine's all-reduce and its
    dispatch input's and gate weights' backward all-reduces; Mamba, the
    all-gather of the ``in_proj`` product (backward: reduce-scatter),
    the ``x_proj`` all-reduce (and its backward one) and ``out_proj``'s;
    RWKV's time mix, the input's backward all-reduce, the all-gathers
    before and after ``wo`` (backward: reduce-scatter and a slice), the
    channel mix an MLP's pair.  The lookup and the head are
    vocab-parallel: the lookup's rows and the logsumexp's maximum, sum
    and gold logit are all-reduced;
  * a gradient is summed over the ranks that hold distinct rows of the
    batch (``batch_sharding``'s axes, ``token_sharding``); every rank of
    a ``model`` group holds the same rows and each computes its part, and
    the whole leaves' gradients come out equal on all of them (every
    rank computes them from the same all-reduced activations and
    gradients).  A leaf that the spec leaves whole on an FSDP axis (a
    replica) is all-reduced over the FSDP group instead, so its replicas
    keep equal bits;
  * the global gradient norm is an all-reduce of each region's squared
    sum, counted once over the whole mesh (``model`` parts too);
    ``AdamW.update`` then runs on the local slices;
  * the microbatches accumulate in f32 as in the unsharded step, and the
    mean over the ``n`` row slices and ``M`` microbatches is one division
    by ``n * M``;
  * an MoE layer routes a rank's rows as part of the whole microbatch, as
    the reference's SPMD step routes them: each layer all-gathers the
    ranks' expert counts (``models.moe.routed_over``), so the capacity,
    the drops and the load-balance loss are the whole microbatch's;
  * under ``RULES_EP_DATA`` an expert leaf's experts lie on ``data``
    (``("data", None, "model")`` for ``wi_gate``/``wi_up``, ``("data",
    "model")`` for ``wo``): the leaf stays out of the FSDP buckets, its
    ``data`` part is what the rank computes with (never gathered) and its
    gradient is whole on its rank (never reduce-scattered); its ``model``
    part is split as any.  The tokens travel instead: an all-to-all over
    the ``data`` group a layer, each way (``parallel.tensor_parallel.
    ExpertSplit``, counted in ``stats`` under ``ep_``; ``models.moe``).
    Only a ``(data, model)`` mesh takes it: the rows of a ``pod`` axis
    would not reach the experts;
  * under ``TUNING.attn_seq_axis == "model"``, where the query heads do
    not divide ``model``, a rank attends for its slice of the query rows
    and all-gathers the rows over ``model`` (``models.attention``);
  * under ``TUNING.residual_spec`` with ``model`` on the batch or the
    sequence, the residual stream between the scan units is split over
    ``model`` (``models.model.forward``): each product's input
    all-reduce becomes an all-gather of the rows before it and a
    reduce-scatter of its gradient, each row-parallel output's
    all-reduce a reduce-scatter to the rank's rows (Megatron-style
    sequence parallelism), and the norm scales' gradients, partial sums
    over a rank's rows, are all-reduced over ``model``.  ``stats``
    counts the collectives by kind (``tp_gather_*``,
    ``tp_reduce_scatter_*``, ``tp_all_reduce_*``), with the ring
    model's wire bytes a rank under ``*_wire``.

There is one step loop: ``MeshTrainStep`` shards the state and runs
``make_train_step``'s step with itself as the step's hooks (the gathered
parameter tree, the ``model`` split, the rank's rows, the gradients'
reduction, the metrics' mean over the row slices, the global norm); the
step's own hooks on one process are the identity.  The collectives run
over gloo groups (NCCL refuses two ranks on one card): the mesh's, its
FSDP group's and its ``model`` group's (``RankMesh.sub``); CUDA tensors
are staged through the host.  A mesh whose ``model`` axis has one rank
runs no ``model`` collective (the forward is the unsharded one), and a
one-rank mesh runs no collective at all and is bitwise the unsharded
step.

The ``Trainer`` writes its checkpoints in the JAX package's layout and
key paths (``{"params": JAX value tree, "opt": AdamWState}``, the moments
restacked as the parameters), so either package resumes the other's run;
``MeshTrainStep.sharded.full_state`` gathers a mesh step's state for
``jax_state``.

Where the numbers differ from the reference's SPMD step by design: a
collective sums its ranks' values in gloo's order, not XLA's (the f32
CPU tests hold every gradient leaf within 2e-5 relative of JAX's); the
row-parallel partial sums travel in f32 unless ``tp_reduce_dtype`` asks
for the bf16 wire.
"""
from __future__ import annotations

import math
import time
import warnings

import torch

from ..configs.base import ArchConfig
from ..models.model import (
    _prefix_len, _put, abstract_params, init_params, jax_path, loss_fn,
    named_tensors, to_jax_values, tree_from_named,
)
from ..models.layers import cast
from ..models.moe import routed_over
from ..parallel.tensor_parallel import ExpertSplit, ModelSplit
from .optimizer import AdamW, AdamWState, decay_mask, global_norm

def make_train_step(cfg: ArchConfig, opt: AdamW, microbatches: int = 1,
                    backend: str = "ref", remat: bool = True,
                    grad_shardings=None, block_param_specs=None):
    """-> step(params, opt_state, tokens, labels) -> (params, opt_state,
    metrics), ``params`` (a ``ParamTree`` whose parameters require
    gradients) and the state updated in place; the metrics ("loss",
    "nll", "aux", "grad_norm", "lr") are 0-d tensors on the device.  With
    microbatches the JAX step reports the mean loss as "nll" and 0 as
    "aux"; so does this one.

    ``grad_shardings`` and ``block_param_specs`` (``{name:
    PartitionSpec}``, as ``parallel.param_shardings`` gives them) take
    effect when ``jit_train_step`` puts the step on a mesh: the gradients
    land on the parameters' slices, so ``grad_shardings`` must equal the
    parameters' specs; ``block_param_specs`` (the layers' specs) turns on
    the per-layer all-gather and reduce-scatter.  The mesh step runs this
    step with its ``hooks`` (a ``MeshTrainStep``): what the forward reads
    of the parameters, this rank's rows, the gradients' reduction onto
    the slices, the metrics' mean and the global norm."""
    decay = decay_mask(cfg)
    M = microbatches

    def step(params, opt_state, tokens, labels, hooks=None):
        on = _ONE_PROCESS if hooks is None else hooks
        named = named_tensors(params)
        _check_trainable(named)
        B, n = tokens.shape[0], M * on.ndp
        if B % n:
            raise ValueError(f"batch {B} is no multiple of {M} microbatches"
                             + (f" x {on.ndp} row slices" if on.ndp > 1
                                else ""))
        for p in named.values():
            p.grad = None
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        on.begin(named)
        with routed_over(on.route):
            for t, lab in zip(tokens.chunk(M), labels.chunk(M)):
                ls, metrics = loss_fn(on.tree(params, named), cfg,
                                      on.rows(t), on.rows(lab),
                                      backend=backend, remat=remat,
                                      tp=on.tp)
                ls.backward()
                # .grad sums the microbatches' gradients in f32
                loss = loss + ls.detach() if M > 1 else ls.detach()
        on.end(named)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in named.items()}
        if n > 1:
            for g in grads.values():
                g.div_(n)
        loss = on.mean(loss / M if M > 1 else loss)
        metrics = ({"nll": loss, "aux": torch.zeros_like(loss)} if M > 1
                   else {k: on.mean(v.detach()) for k, v in metrics.items()})
        params, opt_state, om = opt.update(grads, opt_state, params, decay,
                                           norm=on.norm(grads))
        del grads
        for p in named.values():
            p.grad = None
        return params, opt_state, {"loss": loss, **metrics, **om}

    step.cfg = cfg
    step.grad_shardings = grad_shardings
    step.block_param_specs = block_param_specs
    return step


class _OneProcess:
    """The step's hooks on one process: the whole batch, the parameters
    as they are (``MeshTrainStep`` is the mesh's)."""

    ndp = 1
    route = None
    tp = None

    def begin(self, named: dict) -> None:
        pass

    def tree(self, params, named: dict):
        return params

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def end(self, named: dict) -> None:
        pass

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def norm(self, grads: dict) -> None:
        return None  # AdamW.update takes global_norm(grads)


_ONE_PROCESS = _OneProcess()


def _check_trainable(named: dict) -> None:
    frozen = [k for k, p in named.items() if not p.requires_grad]
    if frozen:
        raise ValueError(f"parameters {frozen[:3]} do not require "
                         "gradients: call params.requires_grad_(True)")


def jit_train_step(step, mesh, param_shardings, batch_sharding,
                   donate: bool = True) -> "MeshTrainStep":
    """The step of ``make_train_step`` over ``mesh`` (a
    ``parallel.RankMesh``; every rank calls this and the returned step):
    parameters and moments sharded by ``param_shardings`` (``{name:
    PartitionSpec}``), the global batch split by ``batch_sharding`` (the
    ``PartitionSpec`` of ``parallel.token_sharding``).  ``donate``: the
    step shards the parameters and moments it is given in place (JAX's
    donated buffers); without it, it works on copies."""
    return MeshTrainStep(step, mesh, param_shardings, batch_sharding,
                         donate)


class _Layout:
    """How one parameter is cut over a mesh: its full and local shapes,
    the mesh axis of each dimension, and this rank's slice of it."""

    def __init__(self, shape, spec, mesh):
        from ..parallel.logical import mesh_axis_size

        self.shape = tuple(shape)
        parts = tuple(spec) + (None,) * (len(shape) - len(spec))
        if any(isinstance(a, tuple) for a in parts):
            raise ValueError(f"spec {spec}: a parameter dimension takes "
                             "one mesh axis")
        self.parts = parts
        self.local = tuple(n // mesh_axis_size(mesh, a)
                           for n, a in zip(self.shape, parts))
        self.numel = math.prod(self.local)
        used = {a for a in parts if a is not None}
        self.kept = [a for a in mesh.axes if a in used]
        # the ranks holding this rank's slice (the spec leaves the other
        # axes whole): each sends 1/replicas of it to a gather, so every
        # element crosses the wire once
        self.replicas = math.prod(s for a, s in zip(mesh.axes, mesh.sizes)
                                  if a not in used)
        self.chunk = -(-self.numel // self.replicas)
        self.rid = 0
        for a, n in zip(mesh.axes, mesh.sizes):
            if a not in used:
                self.rid = self.rid * n + mesh.coord(a)
        self.slices = tuple(
            slice(None) if a is None else
            slice(mesh.coord(a) * n, (mesh.coord(a) + 1) * n)
            for a, n in zip(parts, self.local))
        self.owner = self.rid == 0
        # pieces [*kept sizes, *local] -> full: each kept axis right
        # before the dimension it cuts
        k = len(self.kept)
        self.perm = [i for d, a in enumerate(parts) for i in (
            ([self.kept.index(a)] if a is not None else []) + [k + d])]
        self.inv = [self.perm.index(i) for i in range(len(self.perm))]
        self.order = ([i for i, a in enumerate(mesh.axes) if a in used]
                      + [i for i, a in enumerate(mesh.axes) if a not in used]
                      + [len(mesh.axes)])

    def contribution(self, shard: torch.Tensor) -> torch.Tensor:
        """This rank's part of its slice in a gather: chunk ``rid`` of the
        flat slice, zero-padded to ``chunk``."""
        part = shard.reshape(-1)[self.rid * self.chunk:
                                 (self.rid + 1) * self.chunk]
        if part.numel() < self.chunk:
            part = torch.cat([part, part.new_zeros(self.chunk
                                                   - part.numel())])
        return part

    def assemble(self, pieces: torch.Tensor, mesh) -> torch.Tensor:
        """[world, chunk] contributions of every rank -> the full tensor."""
        kept = [mesh.shape[a] for a in self.kept]
        t = pieces.reshape(*mesh.sizes, self.chunk).permute(self.order)
        t = t.reshape(*kept, self.replicas * self.chunk)[..., :self.numel]
        return t.reshape(*kept, *self.local).permute(self.perm).reshape(
            self.shape)

    def scatter(self, full: torch.Tensor, mesh) -> torch.Tensor:
        """The full tensor -> [world, numel]: every rank's slice."""
        interleaved = [n for d, a in enumerate(self.parts) for n in (
            ([mesh.shape[a]] if a is not None else []) + [self.local[d]])]
        t = full.reshape(interleaved).permute(self.inv)
        for i, a in enumerate(mesh.axes):
            if a not in self.kept:
                t = t.unsqueeze(i)
        return t.expand(*mesh.sizes, *self.local).reshape(mesh.size,
                                                          self.numel)


class _Bucket:
    """Parameters gathered and reduced together over ``mesh`` (the whole
    mesh, or the FSDP group): their layouts on it, offsets in a rank's
    flat buffer, and the leaves the spec leaves whole on one of its axes
    (all-reduced, not reduce-scattered).  ``rep``: this rank sends its
    gradients (the other ranks of its row slice send zeros)."""

    def __init__(self, names: list, layouts: dict, mesh, rep: bool,
                 owner: "ShardedParams"):
        self.names = names
        self.owner, self.mesh, self.rep = owner, mesh, rep
        self.layouts = [layouts[n] for n in names]
        self.offsets = [0]  # of each leaf's contribution to a gather
        for lay in self.layouts:
            self.offsets.append(self.offsets[-1] + lay.chunk)
        self.sharded = [i for i, lay in enumerate(self.layouts)
                        if lay.replicas == 1]
        self.replicated = [i for i, lay in enumerate(self.layouts)
                           if lay.replicas > 1]

    def _collective(self, kind: str, t: torch.Tensor) -> torch.Tensor:
        return self.owner._collective(kind, t, self.mesh)

    def gather(self, shards) -> list:
        """This rank's slices -> every leaf's tensor over the mesh."""
        mesh = self.mesh
        flat = torch.cat([lay.contribution(s) for lay, s in zip(
            self.layouts, shards)])
        pieces = self._collective("gather", flat).view(mesh.size, -1)
        return [lay.assemble(pieces[:, a:b], mesh) for lay, a, b in zip(
            self.layouts, self.offsets, self.offsets[1:])]

    def reduce(self, grads) -> list:
        """Every leaf's gradient over the mesh on this rank -> this rank's
        slice of the sum over the row slices (zeros sent by the other
        ranks)."""
        mesh = self.mesh
        out: list = [None] * len(grads)
        if mesh.size == 1:
            return [g.reshape(lay.local) for g, lay in zip(grads,
                                                           self.layouts)]
        if self.sharded:
            send = torch.zeros((mesh.size, sum(
                self.layouts[i].numel for i in self.sharded)),
                dtype=grads[0].dtype, device=grads[0].device)
            if self.rep:
                col = 0
                for i in self.sharded:
                    lay = self.layouts[i]
                    send[:, col:col + lay.numel] = lay.scatter(grads[i], mesh)
                    col += lay.numel
            mine = self._collective("reduce_scatter", send.view(-1))
            col = 0
            for i in self.sharded:
                lay = self.layouts[i]
                out[i] = mine[col:col + lay.numel].view(lay.local)
                col += lay.numel
        if self.replicated:
            flat = torch.cat([grads[i].reshape(-1) for i in self.replicated])
            if not self.rep:
                flat = torch.zeros_like(flat)
            summed = self._collective("all_reduce", flat)
            col = 0
            for i in self.replicated:
                lay = self.layouts[i]
                n = math.prod(lay.shape)
                out[i] = summed[col:col + n].view(lay.shape)[
                    lay.slices].contiguous()
                col += n
        return out


class _GatherFn(torch.autograd.Function):
    """All-gather a bucket's slices into full tensors; backward reduces
    the full gradients back onto the slices."""

    @staticmethod
    def forward(ctx, bucket: _Bucket, *shards):
        ctx.bucket = bucket
        return tuple(bucket.gather(shards))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.bucket.reduce(grads))


class _Gathered:
    """What ``models.forward`` reads of a parameter tree: the top-level
    leaves (gathered once a step) and ``["blocks"]``, whose ``[i]``
    gathers layer ``i`` when the forward reads it."""

    def __init__(self, top: dict, layer):
        self._top, self._layer = top, layer

    def __getitem__(self, key: str):
        return _Layers(self._layer) if key == "blocks" else self._top[key]


class _Layers:
    """The layers as ``models.forward`` reads them: ``at(i, dtype)`` is
    layer ``i`` with its floating leaves in ``dtype``."""

    def __init__(self, layer):
        self._layer = layer

    def __len__(self) -> int:
        return self._layer.n

    def __getitem__(self, i: int) -> dict:
        return self._layer(i)

    def at(self, i: int, dtype) -> dict:
        return self._layer(i, dtype)


class ShardedParams:
    """The parameters of ``cfg`` sharded over ``mesh`` by ``specs``
    (``{name: PartitionSpec}``): each leaf's layout over the whole mesh
    (what a rank stores; ``gather`` and ``full_state``), its ``model``
    part (``parts``: ``logical.model_parts``) and that part's layout over
    the FSDP group (``compute_layouts``: what the step gathers), the
    buckets the step gathers together (the top-level leaves; every layer,
    or all layers in one), and the collectives over the mesh's groups.
    ``split``: the mesh axes the batch rows are split over (one rank per
    row slice sends its gradient).  ``stats`` counts the collectives
    since its last reset: calls, seconds and the bytes a rank sent, by
    kind; the ``model`` group's are prefixed ``tp_`` and the MoE routing
    counts' ``route_``."""

    def __init__(self, cfg: ArchConfig, mesh, specs: dict, split=(),
                 per_layer: bool = True):
        from ..parallel.logical import (
            expert_data_leaves, fsdp_axes, fsdp_spec, model_parts,
        )

        meta = dict(abstract_params(cfg).named_parameters())
        if set(specs) != set(meta):
            raise ValueError("the specs must name every parameter")
        self.cfg, self.mesh, self.specs = cfg, mesh, dict(specs)
        # the MoE leaves with their experts on ``data``: never gathered
        self.expert_leaves = expert_data_leaves(self.specs)
        if self.expert_leaves and any(
                a not in ("data", "model") and mesh.shape[a] > 1
                for a in mesh.axes):
            raise ValueError("experts on data take a (data, model) mesh: "
                             "the batch rows of another axis would not "
                             "reach them")
        self.layouts = {n: _Layout(t.shape, self.specs[n], mesh)
                        for n, t in meta.items()}
        self.split = tuple(split)
        self.rep = all(mesh.coord(a) == 0 for a in mesh.axes
                       if a not in self.split)
        self.ndp = math.prod(mesh.shape[a] for a in self.split)
        self.row_slice = 0  # this rank's slice of the batch rows
        for a in self.split:
            self.row_slice = self.row_slice * mesh.shape[a] + mesh.coord(a)
        self.fsdp = mesh.sub(fsdp_axes(mesh))
        self.model = mesh.sub(("model",))
        self.parts = model_parts({n: tuple(t.shape) for n, t in meta.items()},
                                 self.specs, mesh, self.model.rank)
        self.compute_layouts = {}
        for n, t in meta.items():
            shape, part = list(t.shape), self.parts[n]
            if part is not None:
                shape[part.dim] = part.hi - part.lo
            self.compute_layouts[n] = _Layout(
                shape, fsdp_spec(self.specs[n]), self.fsdp)
        frep = all(self.fsdp.coord(a) == 0 for a in self.fsdp.axes
                   if a not in self.split)
        blocks = [n for n in meta if n.startswith("blocks.")]
        top = [n for n in meta if n not in blocks]
        layer_names = [[n for n in blocks if n.split(".")[1] == str(i)]
                       for i in range(cfg.num_layers)]

        def bucket(names, whole: bool) -> _Bucket:
            if whole:
                return _Bucket(names, self.layouts, mesh, self.rep, self)
            return _Bucket([n for n in names if n not in self.expert_leaves],
                           self.compute_layouts, self.fsdp, frep, self)

        self.top = bucket(top, False)
        self.layer_buckets = ([bucket(ns, False) for ns in layer_names]
                              if per_layer else [bucket(blocks, False)])
        self._whole = [bucket(top, True)] + [bucket(ns, True)
                                             for ns in layer_names]
        # the all-to-alls' group: the ranks with this rank's other coords
        self.data = mesh.sub(("data",)) if self.expert_leaves else None
        self.stats: dict = {}

    def _collective(self, kind: str, t: torch.Tensor, mesh=None,
                    label: str = "", splits=None) -> torch.Tensor:
        """``kind`` ("gather", "reduce_scatter", "all_reduce",
        "all_reduce_max" or "all_to_all", whose ``splits`` are the
        elements sent to and received from each rank) of the flat ``t``
        over ``mesh``'s group (default: the whole mesh), staged through
        the host for CUDA tensors (gloo); counted in ``stats`` under
        ``label + kind``: calls (``_n``), seconds (``_s``), the bytes
        given (``_bytes``) and the bytes the rank puts on the wire by the
        ring model (``_wire``, ``launch.roofline.wire_bytes``)."""
        import torch.distributed as dist

        from ..launch.roofline import wire_bytes

        mesh = self.mesh if mesh is None else mesh
        if mesh.size == 1:
            return t
        if t.is_cuda:
            torch.cuda.synchronize()  # the timer holds the collective only
        t0 = time.perf_counter()
        src = t.cpu() if t.is_cuda else t
        with warnings.catch_warnings():  # newer torch renames the two
            warnings.simplefilter("ignore", FutureWarning)
            if kind == "gather":
                out = src.new_empty(mesh.size * src.numel())
                dist.all_gather_into_tensor(out, src, group=mesh.group)
            elif kind == "reduce_scatter":
                out = src.new_empty(src.numel() // mesh.size)
                dist.reduce_scatter_tensor(out, src, group=mesh.group)
            elif kind == "all_to_all":
                send, recv = splits
                out = src.new_empty(sum(recv))
                dist.all_to_all_single(out, src, list(recv), list(send),
                                       group=mesh.group)
            else:
                out = src.clone()
                dist.all_reduce(out, op=dist.ReduceOp.MAX
                                if kind == "all_reduce_max"
                                else dist.ReduceOp.SUM, group=mesh.group)
        out = out.to(t.device)
        st, key = self.stats, label + kind
        st[f"{key}_n"] = st.get(f"{key}_n", 0) + 1
        st[f"{key}_s"] = st.get(f"{key}_s", 0.0) + time.perf_counter() - t0
        st[f"{key}_bytes"] = (st.get(f"{key}_bytes", 0)
                              + src.numel() * src.element_size())
        op = {"gather": "all-gather", "reduce_scatter": "reduce-scatter",
              "all_to_all": "all-to-all"}.get(kind, "all-reduce")
        st[f"{key}_wire"] = st.get(f"{key}_wire", 0) + wire_bytes(
            op, out.numel() * out.element_size(), mesh.size)
        return out

    def model_split(self):
        """The forward's ``parallel.tensor_parallel.ModelSplit`` over this
        rank's ``model`` group, carrying the ``ExpertSplit`` over its
        ``data`` group when experts lie on ``data`` (all-to-alls counted
        under ``ep_``); None when ``model`` has one rank and no expert
        lies on ``data``.  ``rows_split``: whether the batch rows are
        split (``attention.cache_split`` reads it).  Experts on ``data``
        take rows split over ``data``: every rank routes its own rows as
        a share of the batch, and rows repeated on the ranks of ``data``
        would be counted once a rank."""
        experts = None
        if self.expert_leaves:
            if self.data.size > 1 and "data" not in self.split:
                raise ValueError(
                    "experts on data take the batch rows split over data; "
                    f"they are split over {self.split or 'no axis'}")
            experts = ExpertSplit(
                self.data.size, self.data.rank, self.expert_leaves,
                lambda kind, t, splits: self._collective(
                    kind, t, self.data, "ep_", splits))
        elif self.model.size == 1:
            return None
        return ModelSplit(
            self.model.size, self.model.rank,
            {n: None if p is None else p.dim for n, p in self.parts.items()},
            lambda kind, t: self._collective(kind, t, self.model, "tp_"),
            experts=experts, rows_split=bool(self.split))

    @property
    def route(self):
        """The MoE layers' routing of this rank's rows as part of the
        whole batch (``models.moe.routed_over``), or None when the batch
        is not split."""
        return None if self.ndp == 1 else self._route

    def _route(self, counts: torch.Tensor):
        mesh = self.mesh
        every = self._collective("gather", counts, label="route_").view(
            *mesh.sizes, -1)
        # the ranks with this rank's coordinates off the split axes hold
        # every row slice once; order them as the rows are numbered
        per = every[tuple(slice(None) if a in self.split else mesh.coord(a)
                          for a in mesh.axes)]
        axes = [a for a in mesh.axes if a in self.split]
        per = per.permute(*[axes.index(a) for a in self.split],
                          len(axes)).reshape(self.ndp, -1)
        return per[:self.row_slice].sum(0), per.sum(0), self.ndp

    @torch.no_grad()
    def shard(self, params):
        """Cut every parameter of ``params`` (a ``ParamTree``) that still
        has its full shape down to this rank's slice, in place."""
        for name, p in named_tensors(params).items():
            lay = self.layouts[name]
            if tuple(p.shape) == lay.shape and lay.shape != lay.local:
                p.data = p.data[lay.slices].contiguous()
        return params

    @torch.no_grad()
    def shard_state(self, state: AdamWState) -> AdamWState:
        """The same for the moments (their dicts' entries replaced)."""
        for tree in (state.m, state.v):
            for name, t in tree.items():
                lay = self.layouts[name]
                if tuple(t.shape) == lay.shape and lay.shape != lay.local:
                    tree[name] = t[lay.slices].contiguous()
        return state

    @torch.no_grad()
    def gather(self, tree) -> dict:
        """``{name: full tensor}`` of a sharded ``ParamTree`` or moment
        mapping, gathered over the whole mesh (every rank calls it)."""
        named = named_tensors(tree)
        out = {}
        for bucket in self._whole:
            full = bucket.gather([named[n].detach() for n in bucket.names])
            out.update(zip(bucket.names, full))
        return {n: out[n] for n in named}

    def full_state(self, params, opt_state: AdamWState):
        """The gathered parameters and moments, for ``jax_state``."""
        return self.gather(params), AdamWState(
            step=opt_state.step, m=self.gather(opt_state.m),
            v=self.gather(opt_state.v))

    @staticmethod
    def resident_bytes(params, opt_state: AdamWState | None = None) -> int:
        """Bytes of a rank's parameter (and moment) slices."""
        trees = [named_tensors(params)]
        if opt_state is not None:
            trees += [opt_state.m, opt_state.v]
        return sum(t.numel() * t.element_size() for tree in trees
                   for t in tree.values())

    def gather_top(self, named: dict, grad: bool = False) -> dict:
        """The top-level leaves (embedding, final norm, head), the rank's
        ``model`` parts gathered over the FSDP group from this rank's
        slices ``named``, in f32, as leaves that take gradients with
        ``grad``."""
        return {n: t.detach().requires_grad_(grad) for n, t in zip(
            self.top.names, self.top.gather(
                [named[n].detach() for n in self.top.names]))}

    def layers(self, named: dict):
        """-> layer(i, dtype=None), layer ``i``'s tree of the rank's
        ``model`` parts: per-layer buckets cast their floating leaves to
        ``dtype`` and are gathered over the FSDP group when the forward
        reads the layer (again under remat, by ``_GatherFn``); one bucket
        of every layer is gathered here, once, in the stored dtype."""
        buckets = self.layer_buckets
        if len(buckets) == 1:
            whole = dict(zip(buckets[0].names, _GatherFn.apply(
                buckets[0], *(named[n] for n in buckets[0].names))))

        def layer(i: int, dtype=None) -> dict:
            pre = f"blocks.{i}."
            if len(buckets) > 1:
                b = buckets[i]
                shards = [named[n] for n in b.names]
                if dtype is not None:  # cast while still sharded
                    shards = [cast(t, dtype) if t.is_floating_point() else t
                              for t in shards]
                full = list(zip(b.names, _GatherFn.apply(b, *shards)))
            else:
                full = [(n, t) for n, t in whole.items()
                        if n.startswith(pre)]
            # experts on data: the rank's own slice is what it computes
            full += [(n, named[n] if dtype is None else cast(named[n], dtype))
                     for n in sorted(self.expert_leaves) if n.startswith(pre)]
            out: dict = {}
            for name, t in full:
                _put(out, tuple(name.split(".")[2:]), t)
            return out

        layer.n = self.cfg.num_layers
        return layer

    def tree(self, named: dict) -> "_Gathered":
        """What ``models.forward`` reads, over this rank's slices (a
        serving forward: no gradients); give the forward
        ``tp=model_split()``."""
        return _Gathered(self.gather_top(named), self.layers(named))


class MeshTrainStep:
    """``make_train_step``'s step over a ``RankMesh`` (see the module
    docstring; made by ``jit_train_step``): it shards the state and runs
    the step with itself as the step's hooks.  ``sharded`` is its
    ``ShardedParams``; ``stats`` the last call's collectives."""

    def __init__(self, step, mesh, param_shardings, batch_sharding,
                 donate: bool = True):
        for a in ("data", "model"):
            if a not in mesh.shape:
                raise ValueError(f"a train mesh has axes (data, model) or "
                                 f"(pod, data, model), not {mesh.axes}")
        if step.grad_shardings is not None and \
                dict(step.grad_shardings) != dict(param_shardings):
            raise ValueError("grad_shardings must equal the parameters' "
                             "specs: the gradients land on their slices")
        bps = step.block_param_specs
        if bps is not None and any(bps.get(n) != spec for n, spec in
                                   param_shardings.items()
                                   if n.startswith("blocks.")):
            raise ValueError("block_param_specs must be the layers' specs")
        split = batch_sharding[0] if len(batch_sharding) else None
        split = (() if split is None else
                 (split,) if isinstance(split, str) else tuple(split))
        self.sharded = ShardedParams(step.cfg, mesh, param_shardings, split,
                                     per_layer=bps is not None)
        self.tp = self.sharded.model_split()
        self.step, self.mesh, self.donate = step, mesh, donate
        self.split = split
        self.ndp, self.row_slice = self.sharded.ndp, self.sharded.row_slice
        self._top = None

    @property
    def stats(self) -> dict:
        return self.sharded.stats

    def __call__(self, params, opt_state: AdamWState, tokens, labels):
        if not self.donate:
            given = named_tensors(params)
            params = tree_from_named({k: p.detach().clone()
                                      for k, p in given.items()})
            for k, p in params.named_parameters():
                p.requires_grad_(given[k].requires_grad)
            opt_state = AdamWState(
                step=opt_state.step.clone(),
                m={k: t.clone() for k, t in opt_state.m.items()},
                v={k: t.clone() for k, t in opt_state.v.items()})
        self.sharded.shard(params)
        opt_state = self.sharded.shard_state(opt_state)
        self.sharded.stats = {}
        return self.step(params, opt_state, tokens, labels, hooks=self)

    # ---- the step's hooks
    def begin(self, named: dict) -> None:
        self._top = self.sharded.gather_top(named, grad=True)  # once a step

    def tree(self, params, named: dict) -> "_Gathered":
        return _Gathered(self._top, self.sharded.layers(named))

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        n = t.shape[0] // self.ndp
        return t[self.row_slice * n:(self.row_slice + 1) * n]

    def end(self, named: dict) -> None:
        """The top-level leaves' gradients onto their slices (reduced
        over the FSDP group)."""
        sp, top = self.sharded, self._top
        for n, g in zip(sp.top.names, sp.top.reduce(
                [top[n].grad if top[n].grad is not None
                 else torch.zeros_like(top[n]) for n in sp.top.names])):
            named[n].grad = g
        self._top = None

    @property
    def route(self):
        """The MoE layers' routing over the row slices (``models.moe.
        routed_over``), or None when the batch is not split."""
        return self.sharded.route

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """A metric's mean over the row slices."""
        if self.mesh.size == 1:
            return x
        x = x if self.sharded.rep else torch.zeros_like(x)
        return self.sharded._collective("all_reduce", x) / self.ndp

    def norm(self, grads: dict) -> torch.Tensor:
        """The global norm of the gradients' slices: each slice's squared
        sum counted once, all-reduced."""
        if self.mesh.size == 1:
            return global_norm(grads)
        lay = self.sharded.layouts
        sq = torch.stack([
            torch.linalg.vector_norm(g, dtype=torch.float32) ** 2
            if lay[k].owner else g.new_zeros((), dtype=torch.float32)
            for k, g in grads.items()]).sum()
        return torch.sqrt(self.sharded._collective("all_reduce", sq))


def jax_state(cfg: ArchConfig, params, opt_state: AdamWState) -> dict:
    """The checkpoint tree in the JAX package's layout: ``{"params": value
    tree, "opt": AdamWState(step, m, v)}`` of host arrays."""
    return {"params": to_jax_values(cfg, params),
            "opt": AdamWState(step=opt_state.step.detach().to(
                "cpu", copy=True).numpy(),
                              m=to_jax_values(cfg, opt_state.m),
                              v=to_jax_values(cfg, opt_state.v))}


def _jax_like(cfg: ArchConfig, opt: AdamW) -> dict:
    """``jax_state``'s structure, shapes and dtypes, from the ``meta``
    device (no memory)."""
    meta = abstract_params(cfg)
    like = {"params": _meta_tree(cfg, meta, torch.float32)}
    dt = opt._dtype
    like["opt"] = AdamWState(step=torch.zeros((), dtype=torch.int32,
                                              device="meta"),
                             m=_meta_tree(cfg, meta, dt),
                             v=_meta_tree(cfg, meta, dt))
    return like


def _meta_tree(cfg: ArchConfig, meta, dtype) -> dict:
    n_units = (cfg.num_layers - _prefix_len(cfg)) // cfg.scan_unit
    out: dict = {}
    for name, p in meta.named_parameters():
        path, u = jax_path(cfg, name)
        shape = p.shape if u is None else (n_units, *p.shape)
        _put(out, path, torch.empty(shape, dtype=dtype, device="meta"))
    return out


@torch.no_grad()
def load_jax_state(cfg: ArchConfig, params, opt_state: AdamWState,
                   state: dict) -> None:
    """Copy a restored ``jax_state`` tree into ``params`` and
    ``opt_state`` in place (the inverse of ``jax_state``)."""
    opt_state.step.copy_(torch.as_tensor(state["opt"].step))
    for tree, src in ((named_tensors(params), state["params"]),
                      (opt_state.m, state["opt"].m),
                      (opt_state.v, state["opt"].v)):
        for name, t in tree.items():
            path, u = jax_path(cfg, name)
            leaf = src
            for k in path:
                leaf = leaf[k]
            t.copy_(leaf if u is None else leaf[u])


class Trainer:
    """Single-host end-to-end loop (``examples/train_lm_torch.py``).
    ``device=None`` means the card (it raises without CUDA); the weights
    come from ``init_params`` with a ``torch.Generator`` seeded ``seed``
    on that device, and a run resumes from the newest complete checkpoint
    in ``ckpt_dir``."""

    def __init__(self, cfg: ArchConfig, opt: AdamW, data,
                 ckpt_dir: str | None = None, seed: int = 0,
                 microbatches: int = 1, log_every: int = 10,
                 ckpt_every: int = 100, device=None):
        from .. import resolve_device

        self.cfg, self.opt, self.data = cfg, opt, data
        self.ckpt_dir = ckpt_dir
        self.log_every, self.ckpt_every = log_every, ckpt_every
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(cfg, gen, device=self.device)
        self.params.requires_grad_(True)
        self.opt_state = opt.init(self.params)
        self.step_idx = 0
        self._step = make_train_step(cfg, opt, microbatches=microbatches)
        self._ckpt = None
        if ckpt_dir:
            from .checkpoint import AsyncCheckpointer, latest_step, restore

            last = latest_step(ckpt_dir)
            if last is not None:
                state = restore(ckpt_dir, last, _jax_like(cfg, opt))
                load_jax_state(cfg, self.params, self.opt_state, state)
                self.step_idx = last
            self._ckpt = AsyncCheckpointer(ckpt_dir)

    def _state(self) -> dict:
        return jax_state(self.cfg, self.params, self.opt_state)

    def run(self, num_steps: int, host: int = 0, healthy=None) -> list[dict]:
        healthy = healthy if healthy is not None else [0]
        history = []
        for _ in range(num_steps):
            t0 = time.time()
            tokens, labels = self.data.host_batch(self.step_idx, host,
                                                  healthy)
            _, self.opt_state, metrics = self._step(
                self.params, self.opt_state,
                torch.as_tensor(tokens, device=self.device),
                torch.as_tensor(labels, device=self.device))
            self.step_idx += 1
            if self.step_idx % self.log_every == 0 or self.step_idx == 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = self.step_idx
                m["sec_per_step"] = time.time() - t0
                history.append(m)
            if self._ckpt and self.step_idx % self.ckpt_every == 0:
                self._ckpt.save(self.step_idx, self._state())
        return history

    def finish(self):
        if self._ckpt:
            self._ckpt.save(self.step_idx, self._state())
            self._ckpt.wait()
