"""Operation-count cost walk of a PyTorch step: the port's counterpart of
``repro.launch.hlo_cost`` (there is no HLO to read).

``OpCost`` is a ``TorchDispatchMode``: every ATen operation the step
dispatches passes through it, on real tensors, on ``meta`` tensors or on
``FakeTensor``s (nothing computed, nothing allocated), and it counts:

  * flops: matmul-class ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    ``addbmm``, ``convolution``) at 2·M·N·K, as ``hlo_cost`` counts dots
    and convolutions; and a ``sum`` over the output of an elementwise
    ``mul`` as the contraction it is, 2 flops an element of the product
    (a multiply and an add, as a dot's 2·M·N·K): the plain
    ``gather_norm_dot`` writes its dot and its norm that way.  Every
    other elementwise op, cast or dequantising multiply counts none
    (``hlo_cost`` counts only dots; the omission is conservative for the
    compute term);
  * bytes: the operand plus result bytes of every op that moves data
    (a gather charges its whole source, as HLO operand bytes do); views,
    allocations without a write (``empty``) and metadata queries are
    free;
  * collectives: the ``c10d`` ops the step issues (real, or under the
    ``fake`` process-group backend), by the ring model of
    ``launch.roofline`` with the group's size;
  * the peak of live bytes the step allocated (outputs of data-moving ops
    not yet freed), for the dry run's ``temp_bytes``.

Nothing repeats: every microbatch and every layer is walked, so there is
no trip count to multiply (the record's ``repeats``).

``fused=True`` counts bytes as one fused program would move them (XLA
fuses the reference's plain ``gather_norm_dot`` into one such program,
and the CUDA kernel is one): each tensor the walk did not make, once, at
its first read, plus the tensors the walk made that are still alive when
the record is taken (the results); values made and consumed inside stay
on the chip.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .roofline import CollectiveStats

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "convolution"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "detach", "alias",
         "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size", "device", "layout"}
_C10D = {  # c10d op -> (ring-model collective, the arg holding its result)
    "_allgather_base_": ("all-gather", 0),
    "allgather_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "alltoall_base_": ("all-to-all", 0),
    "alltoall_": ("all-to-all", 0),
    "broadcast_": ("collective-permute", 0),
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _matmul_flops(name: str, args) -> float:
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm", "addbmm") \
        else (args[0], args[1])
    batch = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2], a.shape[-1]
    return 2.0 * batch * m * b.shape[-1] * k


class OpCost(TorchDispatchMode):
    """Count the step run inside ``with OpCost(devices) as oc:``;
    ``oc.record()`` gives ``hlo_cost.analyze``'s keys.  ``devices``: the
    group size of a collective whose group cannot be read."""

    def __init__(self, total_devices: int = 1, fused: bool = False):
        super().__init__()
        self.total_devices = total_devices
        self.fused = fused
        self._made = weakref.WeakValueDictionary()  # id -> made here
        self._read: dict = {}  # id -> input read (kept alive)
        self.flops = 0.0
        self.matmul_flops = 0.0  # the matmul-class ops' share of flops
        self.bytes = 0.0
        self.coll = CollectiveStats()
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._products = weakref.WeakValueDictionary()  # id -> mul output

    def _free(self, n: int) -> None:
        self.live -= n

    def _alloc(self, out) -> None:
        for t in _tensors(out):
            n = t.numel() * t.element_size()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)

    def _group(self, args) -> int:
        for a in args:
            size = getattr(a, "size", None)
            if not isinstance(a, torch.Tensor) and callable(size):
                try:
                    return int(size())
                except (TypeError, RuntimeError):
                    continue
        return self.total_devices

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "c10d" and name in _C10D:
            op, i = _C10D[name]
            rb = _nbytes(args[i])
            self.coll.add(op, rb, self._group(args))
            self.bytes += rb
            return out
        if ns in ("prim", "c10d", "_c10d_functional") or name in _FREE \
                or _is_view(func):
            if self.fused and any(id(t) in self._made for t in _tensors(
                    list(args))):
                for t in _tensors(out):  # a view of a value made here
                    self._made[id(t)] = t
            return out
        self.ops += 1
        if name in _MATMUL:
            f = self.conv_flops(args, out) if name == "convolution" \
                else _matmul_flops(name, args)
            self.flops += f
            self.matmul_flops += f
        elif name == "mul" and isinstance(out, torch.Tensor):
            self._products[id(out)] = out
        elif name == "sum" and args and isinstance(args[0], torch.Tensor) \
                and self._products.get(id(args[0])) is args[0]:
            self.flops += 2.0 * args[0].numel()
        ins = list(_tensors(list(args) + list(kwargs.values())))
        if self.fused:
            for t in ins:
                if id(t) not in self._made and id(t) not in self._read:
                    self._read[id(t)] = t
                    self.bytes += t.numel() * t.element_size()
        else:
            self.bytes += _nbytes(ins) + _nbytes(out)
        rets = func._schema.returns
        if not any(r.alias_info is not None for r in rets):
            self._alloc(out)
        for t in _tensors(out):
            self._made[id(t)] = t
        return out

    @staticmethod
    def conv_flops(args, out) -> float:
        """2 * output elements * (input channels / groups * kernel
        elements): the weight's elements over its output channels."""
        w = args[1]
        return 2.0 * out.numel() * w[0].numel()

    def record(self) -> dict:
        """The counts so far (``fused``: the results alive now count as
        written)."""
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes + (self.live if self.fused
                                              else 0),
            "coll_wire_bytes_per_device": self.coll.wire_bytes,
            "coll_by_op": dict(self.coll.by_op),
            "coll_count": self.coll.count,
            "coll_max_group": self.coll.max_group,
            "ops": self.ops,
            "peak_live_bytes": self.peak,
            "repeats": "none: every microbatch and layer was walked",
        }


def analyze(fn, *args, total_devices: int = 1, fused: bool = False,
            **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under ``OpCost`` -> its record (taken
    while ``fn``'s results are alive)."""
    with OpCost(total_devices, fused=fused) as oc:
        result = fn(*args, **kwargs)
    rec = oc.record()
    del result
    return rec
