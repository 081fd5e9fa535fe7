"""Train step and host-side Trainer (the port of ``repro.train.
train_loop``): checkpoint/restart, the deterministic data source, resume
by manifest.

``make_train_step`` returns the step that the JAX package jits:
microbatch gradient accumulation (an f32 sum over the microbatches, then
the mean, as the JAX scan), the gradients of ``models.loss_fn`` (each
scan unit rematerialised), and the AdamW update written in place.  No
kernel has a backward in either package: the step runs autograd through
the plain versions (``backend="ref"``, the JAX default).  The JAX
``jit_train_step`` and ``make_train_step``'s ``grad_shardings`` and
``block_param_specs`` shard the step over a mesh (FSDP); they are not
ported yet.

The ``Trainer`` writes its checkpoints in the JAX package's layout and
key paths (``{"params": JAX value tree, "opt": AdamWState}``, the moments
restacked as the parameters), so either package resumes the other's run.
"""
from __future__ import annotations

import time

import torch

from ..configs.base import ArchConfig
from ..models.model import (
    _prefix_len, _put, abstract_params, init_params, jax_path, loss_fn,
    named_tensors, to_jax_values,
)
from .optimizer import AdamW, AdamWState, decay_mask

_SHARDED = ("not ported yet: sharding the train step over a mesh (FSDP "
            "grad_shardings / block_param_specs) is the second half of "
            "ROADMAP A11c")


def make_train_step(cfg: ArchConfig, opt: AdamW, microbatches: int = 1,
                    backend: str = "ref", remat: bool = True,
                    grad_shardings=None, block_param_specs=None):
    """-> step(params, opt_state, tokens, labels) -> (params, opt_state,
    metrics), ``params`` (a ``ParamTree`` whose parameters require
    gradients) and the state updated in place; the metrics ("loss",
    "nll", "aux", "grad_norm", "lr") are 0-d tensors on the device.  With
    microbatches the JAX step reports the mean loss as "nll" and 0 as
    "aux"; so does this one."""
    if grad_shardings is not None or block_param_specs is not None:
        raise NotImplementedError(_SHARDED)
    decay = decay_mask(cfg)

    def grads_of(params, tokens, labels):
        loss, metrics = loss_fn(params, cfg, tokens, labels,
                                backend=backend, remat=remat)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def step(params, opt_state, tokens, labels):
        named = named_tensors(params)
        frozen = [k for k, p in named.items() if not p.requires_grad]
        if frozen:
            raise ValueError(f"parameters {frozen[:3]} do not require "
                             "gradients: call params.requires_grad_(True)")
        for p in named.values():
            p.grad = None
        if microbatches == 1:
            loss, metrics = grads_of(params, tokens, labels)
        else:
            B = tokens.shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} is no multiple of "
                                 f"{microbatches} microbatches")
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for t, lab in zip(tokens.chunk(microbatches),
                              labels.chunk(microbatches)):
                # .grad sums the microbatches' gradients in f32
                loss = loss + grads_of(params, t, lab)[0]
            for p in named.values():
                if p.grad is not None:
                    p.grad.div_(microbatches)
            loss = loss / microbatches
            metrics = {"nll": loss, "aux": torch.zeros_like(loss)}
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in named.items()}
        params, opt_state, om = opt.update(grads, opt_state, params,
                                           decay)
        del grads
        for p in named.values():
            p.grad = None
        return params, opt_state, {"loss": loss, **metrics, **om}

    return step


def jit_train_step(step, mesh, param_shardings, batch_sharding,
                   donate: bool = True):
    """The JAX package's sharded jit of the step (FSDP over a mesh)."""
    raise NotImplementedError(_SHARDED)


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
