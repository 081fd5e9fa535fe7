"""Gradient compression for slow links: int8 quantized reduction with
error feedback (the port of ``repro.train.compress``).

Quantization: per-tensor symmetric int8 with the scale ``max|g| / 127``;
the quantization residual is carried in an error-feedback buffer (Seide
et al. / EF-SGD), so the compression bias vanishes over steps.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
payloads are the JAX package's bit for bit.

  * ``quantize``/``dequantize`` (and the tree forms) — the primitive.
  * ``compressed_psum`` — the mean over a ``torch.distributed`` group: one
    ``all_reduce(MAX)`` makes the scale shared, then the int8 payloads are
    summed as int32 with ``all_reduce(SUM)`` (exact up to the group size).
    The JAX version does the same with ``pmax``/``psum`` over a mesh axis
    inside ``shard_map``.

Trees are nested dicts and lists of tensors (a ``ParamTree`` is taken as
the mapping of its parameter names).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.model import ParamTree, named_tensors


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts and lists are nodes) and
    the matching leaves of ``rest``."""
    if isinstance(tree, ParamTree):
        tree = named_tensors(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _split(tree, n: int) -> tuple:
    """A tree of n-tuples -> n trees."""
    return tuple(_tree_map(lambda t, i=i: t[i], tree) for i in range(n))


def _scale(g32: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0


def _encode(g32: torch.Tensor, scale: torch.Tensor) -> tuple:
    """-> (q int8, the residual g32 - q * scale)."""
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, g32 - q.float() * scale


def quantize(g: torch.Tensor, err: torch.Tensor) -> tuple:
    """-> (q int8, scale f32 scalar, new_err)."""
    g32 = g.float() + err
    scale = _scale(g32)
    q, new_err = _encode(g32, scale)
    return q, scale, new_err


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, err_tree) -> tuple:
    """Tree-wise quantize with error feedback -> (q, scales, new_err)."""
    return _split(_tree_map(quantize, grads, err_tree), 3)


def decompress_tree(q_tree, scale_tree):
    return _tree_map(dequantize, q_tree, scale_tree)


def init_error_feedback(params):
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)


def shared_quantize(g: torch.Tensor, err: torch.Tensor,
                    group=None) -> tuple:
    """Quantize against the scale shared by every rank of ``group`` (the
    largest) -> (q int8, scale, new_err): the payload that
    ``compressed_psum`` sums."""
    g32 = g.float() + err
    scale = _scale(g32).reshape(1)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    scale = scale.reshape(())
    q, new_err = _encode(g32, scale)
    return q, scale, new_err


def compressed_psum(grads, err_tree, group=None) -> tuple:
    """Error-feedback int8 mean over the ranks of ``group`` (default: the
    world) -> (mean tree in the gradients' dtypes, new error tree).
    Payload on the wire: the int8 tensor (summed as int32) and one f32
    scale per tensor."""
    n = dist.get_world_size(group)

    def one(g, e):
        q, scale, new_e = shared_quantize(g, e, group)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return (total.float() * scale / n).to(g.dtype), new_e

    return _split(_tree_map(one, grads, err_tree), 2)
