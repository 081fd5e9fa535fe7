"""Tensor and expert parallelism of the LM forward over a mesh's
``model`` axis: what the reference's SPMD partitioner does to a step
whose heads, kv heads, mlp, experts, Mamba inner channels, RWKV heads x
dim and vocab are sharded over ``model`` (``parallel.logical``'s
``RULES_TP_FSDP``), written as Megatron-style pairs of autograd
functions over the ``model`` group.

A ``ModelSplit`` is what ``models.forward`` reads of that axis: its size
``n``, this rank's coordinate ``r``, the per-parameter plan (which
dimension of a parameter is split over ``model``; ``logical.
model_parts``), and four collectives that autograd differentiates:

  * ``copy(x)``: identity forward, all-reduce backward.  A tensor every
    rank holds whole (the residual stream, a parameter the spec leaves
    whole) entering a product that each rank computes on its own part:
    each rank's gradient of it is a partial sum.
  * ``reduce(x)``: all-reduce forward, identity backward.  The partial
    sums of a row-parallel product (the contraction over the rank's
    part), summed over ``model`` (the reference's ``rp_einsum``); after it
    every rank holds the whole result.
  * ``gather(x, dim, partial)``: all-gather along ``dim``.  Its backward
    takes this rank's part of the gradient when every rank goes on
    computing the same thing from the whole tensor, and reduce-scatters
    it (``partial=True``) when they go on computing different parts.
  * ``max(x)``: an all-reduce of the maximum, outside autograd (the
    vocab-parallel logsumexp's shift).

Collectives run in the tensor's dtype (bf16 at the default compute type:
the wire carries bf16, as JAX's psum of bf16 partial products does).  A
forward given no ``ModelSplit`` (``tp=None``) runs none of this: it is
the unsharded forward, bit for bit.

Sequence-parallel attention (``TUNING.attn_seq_axis == "model"``, where
the query heads do not divide ``model``) reads the same split: a rank
attends for its slice of the query rows (``seq_range``: the even split,
ceil-sized, the last rank shorter, as GSPMD pads it) and ``gather_rows``
all-gathers the rows over ``model``; ``cache_seq_shard``'s decode cache
holds ``S / n`` slots a rank and its softmax is merged across ``model``
(``max`` and two all-reduces, flash-decoding).  ``models.attention``
computes both.

Under ``TUNING.residual_spec`` with ``model`` on the batch or the
sequence dimension (``models.tuning.residual_dim``), the residual stream
between the layers of the JAX scan units is split over ``model`` as the
reference's pin puts it: ``residual(dim, size)`` is this split with
``rows = (dim, size)``, and a rank holds ``seq_range(size)`` of that
dimension (the ceil split, as GSPMD pads an uneven one).  Three more
autograd pairs carry it, Megatron-style sequence parallelism:

  * ``take_rows(x)``: this rank's rows of a tensor every rank holds
    whole; backward all-gathers the rows' gradients.
  * ``rows_gather(x, partial)``: every rank's rows -> the whole tensor;
    backward reduce-scatters (``partial=True``, the ranks go on
    computing different parts) or takes this rank's rows.
  * ``reduce_rows(x)``: a row-parallel product's partial sums,
    reduce-scattered over the rows; backward all-gathers.

``enter``/``leave`` are what a split product's input and output use:
under the row split a gather and a reduce-scatter (the all-reduce split
in two), else ``copy`` and ``reduce``.  ``row_param(w)`` is a whole
parameter that only this rank's rows read (a norm's scale): ``copy`` in
f32, so its gradient, a partial sum over the rank's rows, is summed over
``model`` in f32.  ``whole()`` drops the row split, for a module that
runs whole on every rank (``models.model._block_apply``).

An ``ExpertSplit`` is the expert dimension on ``data`` (``logical.
RULES_EP_DATA``): the MoE leaves whose spec puts ``expert`` on ``data``
(``logical.expert_data_leaves``), this rank's ``data`` coordinate ``r``
of ``n`` (its experts are ``[r * E / n, (r + 1) * E / n)``), and an
all-to-all over the ``data`` group (the ranks with this rank's other
coordinates, in ``data`` order).  ``all_to_all(x, send, recv)`` is an
autograd pair whose backward is the reverse all-to-all.  A
``ModelSplit`` carries it as ``experts`` (``sub`` keeps it), so that
``models.moe`` finds it beside the ``model`` split; the collectives run
in the tensor's dtype over gloo, and a sum crosses the ranks in gloo's
order, not XLA's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


class ModelSplit:
    """The ``model`` axis as a forward reads it.  ``plan``: ``{parameter
    name: the dimension split over model, or None}``; ``collective(kind,
    flat tensor)`` runs "all_reduce", "all_reduce_max", "gather" (->
    every rank's tensor, concatenated) or "reduce_scatter" (-> this
    rank's chunk of the sum) over the ``model`` group.  ``sub(key)``
    scopes the plan's names to a module (``blocks.3``, then ``attn``).
    ``rows_split``: whether the batch rows are split over the mesh's
    (pod, data) axes (the reference's ``dp``); a decode cache's slots
    split over ``model`` only then, as ``parallel.cache_sharding`` lays
    them out.  ``rows``: ``(dim, size)`` when the residual stream's
    dimension ``dim`` of ``size`` is split over ``model`` (module
    docstring), else None."""

    def __init__(self, n: int, r: int, plan: dict, collective,
                 prefix: str = "", experts: "ExpertSplit | None" = None,
                 rows_split: bool = True, rows: tuple | None = None):
        self.n, self.r = n, r
        self.plan = plan
        self.collective = collective
        self.prefix = prefix
        self.experts = experts
        self.rows_split = rows_split
        self.rows = rows

    def _with(self, prefix: str, rows) -> "ModelSplit":
        return ModelSplit(self.n, self.r, self.plan, self.collective,
                          prefix, self.experts, self.rows_split, rows)

    def sub(self, key: str) -> "ModelSplit":
        return self._with(f"{self.prefix}{key}.", self.rows)

    def residual(self, dim: int, size: int) -> "ModelSplit":
        """This split with the residual stream's ``dim`` (of ``size``)
        split over ``model``."""
        return self._with(self.prefix, (dim, size))

    def whole(self) -> "ModelSplit":
        """This split without the row split."""
        return self._with(self.prefix, None)

    def experts_on_data(self, key: str) -> "ExpertSplit | None":
        """The ``ExpertSplit`` when parameter ``key`` (in this scope) has
        its experts on ``data``, else None."""
        xs = self.experts
        return xs if xs is not None and self.prefix + key in xs.leaves \
            else None

    def dim(self, key: str) -> int | None:
        """The dimension of parameter ``key`` (in this scope) split over
        ``model``; None when it is whole or absent."""
        return self.plan.get(self.prefix + key)

    def on(self, key: str) -> "ModelSplit | None":
        """This split when parameter ``key`` is split over ``model``,
        else None: what reads it is computed whole on every rank."""
        return self if self.dim(key) is not None else None

    def range(self, local: int) -> tuple[int, int]:
        """This rank's ``[lo, hi)`` of a dimension held ``local`` a
        rank."""
        return self.r * local, (self.r + 1) * local

    def seq_range(self, T: int) -> tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``T`` query rows under
        sequence-parallel attention: slices of ``ceil(T / n)`` rows, the
        last ones shorter (empty when ``T`` is short)."""
        size = -(-T // self.n)
        return min(T, self.r * size), min(T, (self.r + 1) * size)

    def gather_rows(self, x: torch.Tensor, T: int, dim: int = 1,
                    partial: bool = False) -> torch.Tensor:
        """Every rank's ``seq_range(T)`` rows (``x``: this rank's, along
        ``dim``) -> all ``T`` rows on every rank; backward: this rank's
        rows of the gradient (every rank goes on computing the same thing
        from the whole tensor), or with ``partial`` the reduce-scatter of
        the ranks' gradients.  A shorter slice is padded to the ceil size
        for the gather; autograd drops the padding."""
        dim %= x.dim()
        short = -(-T // self.n) - x.shape[dim]
        if short:
            x = F.pad(x, [0, 0] * (x.dim() - 1 - dim) + [0, short])
        return self.gather(x, dim, partial).narrow(dim, 0, T)

    # ---- the residual stream's rows (``rows``)
    def take_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x``, whole on every rank; backward: the
        rows' gradients all-gathered."""
        return _TakeRows.apply(self, x, self.rows[0])

    def rows_gather(self, x: torch.Tensor,
                    partial: bool = False) -> torch.Tensor:
        """This rank's rows -> the whole tensor (``gather_rows``)."""
        dim, size = self.rows
        return self.gather_rows(x, size, dim, partial)

    def reduce_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The partial sums ``x`` (whole rows) -> this rank's rows of
        their sum over ``model``: padded to ``n`` ceil-sized slices and
        reduce-scattered; backward: all-gathered."""
        dim, size = self.rows
        lo, hi = self.seq_range(size)
        short = -(-size // self.n) * self.n - size
        if short:
            x = F.pad(x, [0, 0] * (x.dim() - 1 - dim) + [0, short])
        return _ReduceScatter.apply(self, x, dim).narrow(dim, 0, hi - lo)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The input of products that each rank computes on its part:
        ``copy``, or under the row split the rows gathered (backward: the
        ranks' partial gradients reduce-scattered)."""
        return self.copy(x) if self.rows is None else \
            self.rows_gather(x, partial=True)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial sums: ``reduce``, or under the
        row split this rank's rows of the sum (``reduce_rows``)."""
        return self.reduce(x) if self.rows is None else self.reduce_rows(x)

    def row_param(self, w: torch.Tensor) -> torch.Tensor:
        """A whole parameter read by this rank's rows alone, in f32: its
        gradient is summed over ``model`` in f32."""
        return self.copy(w.float())

    # ---- the autograd pairs
    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(self, x)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(self, x)

    def gather(self, x: torch.Tensor, dim: int,
               partial: bool = False) -> torch.Tensor:
        return _Gather.apply(self, x, dim % x.dim(), partial)

    @torch.no_grad()
    def max(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.detach().contiguous().view(-1)
        return self.collective("all_reduce_max", flat).view(x.shape)

    # ---- the collectives on plain tensors
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.collective("all_reduce",
                               t.contiguous().view(-1)).view(t.shape)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        every = self.collective("gather", t.contiguous().view(-1))
        return torch.cat(every.view(self.n, *t.shape).unbind(0), dim=dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        parts = torch.stack(t.chunk(self.n, dim=dim))  # [n, *local]
        mine = self.collective("reduce_scatter", parts.view(-1))
        return mine.view(parts.shape[1:])


class ExpertSplit:
    """The expert dimension on ``data`` as ``models.moe`` reads it:
    ``leaves``, the names of the parameters whose experts lie on
    ``data``; ``n`` ranks in the ``data`` group and this rank's
    coordinate ``r``; ``collective(kind, flat tensor, extra)`` runs
    "gather" (every rank's tensor, concatenated) or "all_to_all" (extra:
    the rows sent to and received from each rank) over that group."""

    def __init__(self, n: int, r: int, leaves, collective):
        self.n, self.r = n, r
        self.leaves = frozenset(leaves)
        self.collective = collective

    def range(self, local: int) -> tuple[int, int]:
        """This rank's ``[lo, hi)`` of the experts, ``local`` a rank."""
        return self.r * local, (self.r + 1) * local

    @torch.no_grad()
    def counts(self, c: torch.Tensor) -> torch.Tensor:
        """This rank's expert counts ``[E]`` -> every rank's ``[n, E]``,
        in ``data`` order."""
        every = self.collective("gather", c.contiguous().view(-1), None)
        return every.view(self.n, *c.shape)

    def sizes(self, kd: torch.Tensor, assignments: int
              ) -> tuple[list, list]:
        """``kd [n, n]``, the rows rank s sends rank q -> (this rank's
        sends, its receives) as ints.  On the dry run's ``FakeTensor``s
        the counts are unknown: ``assignments`` (this rank's expanded
        tokens) spread evenly, the balanced load the capacity is sized
        for."""
        from torch._subclasses.fake_tensor import is_fake

        if is_fake(kd):
            even = assignments // self.n
            return [even] * self.n, [even] * self.n
        rows = kd.tolist()
        return rows[self.r], [row[self.r] for row in rows]

    def all_to_all(self, x: torch.Tensor, send: list,
                   recv: list) -> torch.Tensor:
        """Rows ``x [sum(send), ...]``, ``send[q]`` of them for rank q in
        order -> ``[sum(recv), ...]``, ``recv[q]`` from rank q in order.
        Backward: the reverse all-to-all."""
        return _AllToAll.apply(self, x, tuple(send), tuple(recv))

    def exchange(self, x: torch.Tensor, send, recv) -> torch.Tensor:
        """The all-to-all itself, outside autograd."""
        rest = x.shape[1:]
        width = rest.numel()
        out = self.collective("all_to_all", x.contiguous().view(-1), (
            [s * width for s in send], [r * width for r in recv]))
        return out.view(sum(recv), *rest)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split: ExpertSplit, x, send, recv):
        ctx.split, ctx.send, ctx.recv = split, send, recv
        return split.exchange(x, send, recv)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.split.exchange(g, ctx.recv, ctx.send), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split: ModelSplit, x):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.split.all_reduce(g)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split: ModelSplit, x):
        return split.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split: ModelSplit, x, dim: int):
        ctx.split, ctx.dim = split, dim
        lo, hi = split.seq_range(split.rows[1])
        return x.narrow(dim, lo, hi - lo)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.split
        return None, sp.gather_rows(g, sp.rows[1], ctx.dim), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split: ModelSplit, x, dim: int):
        ctx.split, ctx.dim = split, dim
        return split.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.split.all_gather(g, ctx.dim), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split: ModelSplit, x, dim: int, partial: bool):
        ctx.split, ctx.dim, ctx.partial = split, dim, partial
        ctx.size = x.shape[dim]
        return split.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.split
        if ctx.partial:
            part = sp.reduce_scatter(g, ctx.dim)
        else:
            part = g.narrow(ctx.dim, sp.r * ctx.size, ctx.size)
        return None, part, None, None
