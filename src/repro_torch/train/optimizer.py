"""AdamW with global-norm clipping (the port of ``repro.train.optimizer``).

The state mirrors the parameters: ``m`` and ``v`` map each parameter's
name (``ParamTree.named_parameters``) to a tensor of its shape in
``state_dtype``.  Master parameters are f32; the model casts them to the
compute type where it uses them.  The same hyperparameters and defaults
as the JAX optimizer: linear warmup, then a cosine decay to
``min_lr_frac`` of ``lr``; clipping by the global norm; weight decay only
where ``ndim >= 2``, counted as the JAX optimizer counts it, on the leaves
of its value tree: a layer inside the JAX scan is stacked on the unit
axis there, so its norm scales and biases (1-D here) are decayed too.
``decay_mask(cfg)`` works this out once from the config, and ``update``
takes it.

``update`` writes the parameters and the moments in place under
``torch.no_grad()`` (torch's form of the JAX step's ``donate_argnums=(0,
1)``: at full width an out-of-place update would need a second copy of
the state).  It walks each tensor in slices of ``_CHUNK`` elements, so its
temporaries stay small beside a 152,064 x 3,584 embedding.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..configs.base import ArchConfig
from ..models.model import abstract_params, jax_path, named_tensors

_CHUNK = 1 << 26  # elements a slice of the in-place update


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: dict
    v: dict


class AdamW(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # bf16 moments for memory-bound giants: 8 B/param of optimizer and
    # master state instead of 12
    state_dtype: str = "float32"

    @property
    def _dtype(self) -> torch.dtype:
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.state_dtype]

    def init(self, params) -> AdamWState:
        named = named_tensors(params)
        dev = next(iter(named.values())).device

        def zeros():
            return {k: torch.zeros(p.shape, dtype=self._dtype,
                                   device=p.device)
                    for k, p in named.items()}

        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=dev),
                          m=zeros(), v=zeros())

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = torch.clamp(step / max(self.warmup, 1), max=1.0)
        prog = torch.clamp((step - self.warmup)
                           / max(self.total_steps - self.warmup, 1), 0.0,
                           1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        frac = self.min_lr_frac + (1 - self.min_lr_frac) * cos
        return self.lr * warm * frac

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, decay: dict,
               norm: torch.Tensor | None = None):
        """-> (params, state, {"grad_norm", "lr"}), the parameters and
        moments written in place; ``grads`` maps parameter names to
        gradients (left as they are), ``decay`` maps them to whether
        weight decay applies (``decay_mask``).  ``norm``: the global
        gradient norm when the caller reduced it over ranks (the mesh
        step, whose ``grads`` are a rank's shards); default
        ``global_norm(grads)``."""
        grads = named_tensors(grads)
        named = named_tensors(params)
        gnorm = global_norm(grads) if norm is None else norm
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = state.step + 1
        lr = self.schedule(step)
        sf = step.float()
        b1c = 1 - torch.pow(self.b1, sf)
        b2c = 1 - torch.pow(self.b2, sf)
        for name, p in named.items():
            wd = self.weight_decay if decay[name] else 0.0
            parts = (t.view(-1).split(_CHUNK) for t in (
                p, grads[name], state.m[name], state.v[name]))
            for pc, gc, mc, vc in zip(*parts):
                self._slice(pc, gc, mc, vc, scale, lr, b1c, b2c, wd)
        return params, AdamWState(step=step, m=state.m, v=state.v), {
            "grad_norm": gnorm, "lr": lr}

    def _slice(self, p, g, m, v, scale, lr, b1c, b2c, wd: float) -> None:
        """One slice of a parameter: the JAX update's arithmetic, in its
        order, with the moments rounded to ``state_dtype`` before use."""
        g = g.float() * scale
        m32 = self.b1 * m.float() + (1 - self.b1) * g
        v32 = self.b2 * v.float() + (1 - self.b2) * g * g
        m.copy_(m32)
        v.copy_(v32)
        if m.dtype != torch.float32:  # the rounded moments, as in JAX
            m32, v32 = m.float(), v.float()
        u = (m32 / b1c) / (torch.sqrt(v32 / b2c) + self.eps)
        pf = p.float()
        if wd:
            u = u + wd * pf
        p.copy_(pf - lr * u)


def decay_mask(cfg: ArchConfig) -> dict[str, bool]:
    """{parameter name: decayed}: the JAX rule, ``ndim >= 2`` on the
    leaves of the JAX value tree, where the layers inside the scan carry
    the unit axis too."""
    return {name: p.ndim + (jax_path(cfg, name)[1] is not None) >= 2
            for name, p in abstract_params(cfg).named_parameters()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor of ``tree`` (a
    ``ParamTree``, or a mapping of names to tensors), in f32."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in named_tensors(tree).values()]
    return torch.linalg.vector_norm(torch.stack(norms))
