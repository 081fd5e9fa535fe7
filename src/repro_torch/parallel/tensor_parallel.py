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
"""
from __future__ import annotations

import torch


class ModelSplit:
    """The ``model`` axis as a forward reads it.  ``plan``: ``{parameter
    name: the dimension split over model, or None}``; ``collective(kind,
    flat tensor)`` runs "all_reduce", "all_reduce_max", "gather" (->
    every rank's tensor, concatenated) or "reduce_scatter" (-> this
    rank's chunk of the sum) over the ``model`` group.  ``sub(key)``
    scopes the plan's names to a module (``blocks.3``, then ``attn``)."""

    def __init__(self, n: int, r: int, plan: dict, collective,
                 prefix: str = ""):
        self.n, self.r = n, r
        self.plan = plan
        self.collective = collective
        self.prefix = prefix

    def sub(self, key: str) -> "ModelSplit":
        return ModelSplit(self.n, self.r, self.plan, self.collective,
                          f"{self.prefix}{key}.")

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
