"""Mixture-of-Experts FFN: shared + routed experts, top-k routing,
capacity-based sort dispatch (the port of ``repro.models.moe``: the
scatter dispatch, and the 2-D gather dispatch under
``TUNING.moe_shard_dispatch``).

The expanded token->expert assignment is sorted by expert (stable), each
token gets its position within its expert's segment, and tokens beyond
the capacity ``C = max(1, int(Tt*k/E * capacity_factor), min(Tt*k, 32))``
are dropped: they are written to a dump row of the [E*C + 1, d] dispatch
buffer and gather from a zero row.  Expert compute is one batched matrix
product per weight over [E, C, d] (plain products outside any kernel, as
in the JAX package).

Expert counts that do not divide a mesh axis (qwen2-moe's 60) are padded
to ``pad_to`` with dead experts the router never selects (its logits
cover the real experts only).

When the mesh train step splits a microbatch's rows over ranks, each rank
routes its rows as part of the whole microbatch, as the reference's SPMD
step routes them (``routed_over``): the capacity is the whole
microbatch's, a token's position in its expert's segment counts the
tokens of the row slices before it, and the load-balance loss takes the
whole microbatch's expert fractions.

With ``tp`` (a ``parallel.tensor_parallel.ModelSplit`` scoped to the
layer's ``moe``) and the experts split over ``model`` (expert
parallelism), every rank routes the whole microbatch (the router is
whole, ``expert_unsharded``), runs only its experts' capacity slots in
either dispatch, and the combine's partial sums (zeros for the other
ranks' experts) are all-reduced over ``model``: an expert's weights are
never gathered over ``model``.  When the experts do not divide ``model``
and their mlp does, each rank runs its mlp columns of every expert and
the combine is all-reduced the same way.  The shared experts are a
tensor-parallel MLP.  Under the residual row split (``tp.rows``) ``x`` is
the rank's rows: the router runs on them (its gradient summed over
``model``, ``ModelSplit.row_param``) and its logits are gathered, so
every rank routes every row as without the split; the dispatch input is
the rows gathered (``tp.enter``) and the combine's partial sums are
reduce-scattered to the rank's rows (``tp.leave``).

With the experts on ``data`` (``tp.experts``, a ``tensor_parallel.
ExpertSplit``: ``RULES_EP_DATA``, the reference's ``moe_ep_data``
deployment) and the batch rows split over ``data``, every rank routes its
rows as part of the whole microbatch (every ``data`` rank's counts
gathered: the capacity, positions and aux loss of ``routed_over``), sends
each expert's kept tokens to the rank that holds the expert (an
all-to-all over ``data``; ``_expert_parallel``), runs its experts over
every rank's tokens, which fill the slots ``0 ..`` of the reference's
``disp [Ep, C, d]`` in the whole batch's order, by either dispatch (their
``model`` part reduced as above), and gets the outputs back by the
reverse all-to-all; it combines its rows with ``topw``.  Dropped tokens
never travel and gather zeros; dead padded experts get no token; the
dump row stays on the rank that runs the dispatch.

``lax.top_k`` breaks ties toward the lower index; ``torch.topk`` does not
promise to.  Router probabilities from real inputs do not tie.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..configs.base import MoECfg
from .layers import (
    dense, mlp_apply, mlp_init, normal, split_on, sub, whole_rows,
)
from .tuning import TUNING


def _experts(shape, gen: torch.Generator, *, device=None,
             dtype=torch.float32) -> torch.Tensor:
    """A dense [E, fan, out] weight (fan-in ``E * fan``, as JAX counts
    it), drawn one expert at a time: ``normal`` draws in f32, so a whole
    [16, 8192, 24576] tensor would need a 12.9 GB temporary."""
    out = torch.empty(shape, device=device, dtype=dtype)
    scale = 1.0 / math.prod(shape[:-1]) ** 0.5
    for e in range(shape[0]):
        out[e] = normal(shape[1:], gen, scale, device=device, dtype=dtype)
    return out


def moe_init(gen: torch.Generator, cfg: MoECfg, d_model: int,
             d_ff_dense: int, *, device=None, dtype=torch.float32) -> dict:
    e = cfg.padded_experts
    dff = cfg.d_ff_expert or d_ff_dense
    kw = dict(device=device, dtype=dtype)
    p = {
        "router": dense((d_model, cfg.num_experts), gen, **kw),
        "wi_gate": _experts((e, d_model, dff), gen, **kw),
        "wi_up": _experts((e, d_model, dff), gen, **kw),
        "wo": _experts((e, dff, d_model), gen, **kw),
    }
    if cfg.num_shared:
        p["shared"] = mlp_init(gen, d_model, cfg.num_shared * dff, **kw)
    return p


_ROUTE = None  # set by ``routed_over``


@contextlib.contextmanager
def routed_over(route):
    """Route every MoE layer run inside this block over row slices of a
    larger batch: ``route(counts)`` takes this rank's token count of each
    expert ([Ep] int64, its rows' top-k choices) and returns ``(before,
    total, n)``: the counts of the row slices before this rank's, the
    counts of all ``n`` slices (every rank holds the same number of
    rows).  ``route=None``: the rows are the whole batch."""
    global _ROUTE
    prev, _ROUTE = _ROUTE, route
    try:
        yield
    finally:
        _ROUTE = prev


def capacity(cfg: MoECfg, tokens: int) -> int:
    """Slots per expert: the capacity-factor bound, floored at
    ``min(tokens * k, 32)`` so a hot expert can take every token of a
    decode step."""
    k, E = cfg.top_k, cfg.num_experts
    return max(1, int((tokens * k / E) * cfg.capacity_factor),
               min(tokens * k, 32))


def _experts_apply(p, h: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over the [E, C, d] dispatch buffer."""
    a = F.silu(torch.bmm(h, p["wi_gate"])) * torch.bmm(h, p["wi_up"])
    return torch.bmm(a, p["wo"])


def _dispatch_scatter(p, xf, sorted_e, order, pos_sorted, C: int, cap,
                      e_lo: int = 0) -> torch.Tensor:
    """The flat dispatch (the JAX default): tokens scattered into an
    [E*C + 1, d] buffer (dropped ones, at or past ``cap``, into the last
    row), the experts run, each expanded token gathered back -> [Tt*k,
    d].  ``p`` holds experts ``e_lo ..`` (all of them, or a rank's share
    under expert parallelism): the other experts' tokens go to the dump
    row too, and gather zeros."""
    k = order.numel() // xf.shape[0]
    d = xf.shape[1]
    E = p["wi_gate"].shape[0]
    lim = cap if isinstance(cap, int) else cap[sorted_e]
    le = sorted_e - e_lo
    keep = (pos_sorted < lim) & (le >= 0) & (le < E)
    slot_sorted = torch.where(keep, le * C + pos_sorted,
                              E * C)  # dropped -> the dump row
    disp = xf.new_zeros((E * C + 1, d))
    disp[slot_sorted] = xf[order // k]
    ye = _experts_apply(p, disp[:E * C].view(E, C, d)).view(E * C, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])  # dropped <- zeros
    slots = torch.empty_like(slot_sorted)
    slots[order] = slot_sorted
    return ye[slots]


def _dispatch_2d(p, xf, sorted_e, flat_e, order, pos_sorted, counts,
                 starts, C: int, cap, e_lo: int = 0) -> torch.Tensor:
    """The 2-D dispatch (``TUNING.moe_shard_dispatch``, the JAX ``moe2d``
    path): a gather from each expert's side, ``disp[e, c] = x[order[
    starts[e] + c]]`` for ``c < min(counts[e], cap[e])`` (else a zero
    row), the experts, then ``ye[e, pos]`` with the dropped tokens (and
    those of experts outside ``p``'s ``e_lo ..``) at ``pos = C``, a zero
    column -> [Tt*k, d].  The same numbers as the scatter."""
    n = order.numel()
    Tt, d = xf.shape
    E = p["wi_gate"].shape[0]
    dev = xf.device
    ar = torch.arange(C, device=dev)
    slot_idx = starts[e_lo:e_lo + E, None] + ar[None, :]
    cap_e = cap if isinstance(cap, int) else cap[e_lo:e_lo + E]
    valid = ar[None, :] < torch.clamp(counts[e_lo:e_lo + E],
                                      max=cap_e)[:, None]
    k = n // Tt if Tt else 1
    order_z = torch.cat([order, order.new_zeros(1)])  # n may be 0
    src = torch.where(valid, order_z[torch.clamp(slot_idx, 0, n)], n)
    tok_of = torch.where(src < n, src // k, Tt)
    disp = torch.cat([xf, xf.new_zeros((1, d))])[tok_of]  # [E, C, d]
    ye = _experts_apply(p, disp)
    ye = torch.cat([ye, ye.new_zeros((E, 1, d))], dim=1)  # [E, C+1, d]
    lim = cap if isinstance(cap, int) else cap[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = torch.where(pos_sorted < lim, pos_sorted, C)
    le = flat_e - e_lo
    mine = (le >= 0) & (le < E)
    return ye[torch.where(mine, le, 0), torch.where(mine, pos, C)]


def _run_received(p, rows, le, C: int) -> torch.Tensor:
    """Rows that arrived at the rank holding their experts (``le``: the
    local expert of each; an expert's rows in slot order) through
    ``p``'s experts by the dispatch ``TUNING`` picks -> [rows, d]."""
    order = torch.argsort(le, stable=True)
    sorted_e = le[order]
    counts = torch.zeros(p["wi_gate"].shape[0], dtype=torch.long,
                         device=le.device).index_add_(0, le,
                                                      torch.ones_like(le))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(le.numel(), device=le.device) - \
        starts[sorted_e]
    if TUNING.moe_shard_dispatch:
        return _dispatch_2d(p, rows, sorted_e, le, order, pos_sorted,
                            counts, starts, C, C)
    return _dispatch_scatter(p, rows, sorted_e, order, pos_sorted, C, C)


def _expert_parallel(p, xs, xd, flat_e, order, pos_sorted, sorted_e,
                     per, C: int, k: int) -> torch.Tensor:
    """Experts on ``data`` (``xs``, a ``tensor_parallel.ExpertSplit``):
    ``per`` [n, Ep] is every rank's expert counts in ``data`` order.  A
    source rank s keeps ``min(per[s, e], C - before)`` of expert e's
    tokens, ``before`` the counts of the ranks ahead of it, so the kept
    tokens of an expert hold its slots ``0 ..`` in rank order, as the
    whole batch's sort puts them (the reference's ``disp [Ep, C, d]``).
    This rank sends each kept token to the rank that holds its expert
    (all-to-all), runs its experts over every rank's tokens by the
    dispatch ``TUNING`` picks, and the outputs come back by the reverse
    all-to-all -> [Tt*k, d], zeros for dropped tokens."""
    n, r = xs.n, xs.r
    El = p["wi_gate"].shape[0]
    d = xd.shape[1]
    before = torch.cumsum(per, 0) - per
    kept = torch.clamp(torch.minimum(per, C - before), min=0)  # [n, Ep]
    lo, hi = xs.range(El)
    mine = kept[:, lo:hi]  # [n, El]: the tokens of this rank's experts
    send, recv = xs.sizes(kept.view(n, n, El).sum(2), flat_e.numel())
    # this rank's kept assignments, in sorted (expert) order: grouped by
    # the rank that holds the expert
    keep = pos_sorted < kept[r][sorted_e]
    idx = order[torch.argsort((~keep).to(torch.int8), stable=True)[
        :sum(send)]]
    rows = xs.all_to_all(xd[idx // k], send, recv)
    # the received rows: expert e's, rank by rank, fill its slots 0 ..
    le = torch.arange(El, device=xd.device).repeat(n).repeat_interleave(
        mine.reshape(-1), output_size=sum(recv))
    out = _run_received(p, rows, le, C)
    back = xs.all_to_all(out, recv, send)
    return back.new_zeros((flat_e.numel(), d)).index_put((idx,), back)


def moe_apply(p, cfg: MoECfg, x: torch.Tensor, tp=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> (y [B, T, d], the load-balance aux loss f32).
    ``tp``: expert or tensor parallelism over ``model``, and the experts
    on ``data`` (module docstring)."""
    # over model: the experts (dim 0) or each expert's mlp (dim 2)
    mp = split_on(tp, "wi_gate")
    if mp is None and tp is not None and tp.rows is not None:
        return whole_rows(tp, lambda h, t: moe_apply(p, cfg, h, t), x)
    rows = mp is not None and mp.rows is not None
    x_in = x
    if rows:  # the router on this rank's rows, the routing on all rows
        logits = mp.rows_gather((x @ mp.row_param(p["router"]).to(
            x.dtype)).float())
        x = mp.enter(x)
    B, T, d = x.shape
    xf = x.reshape(-1, d)
    Tt = B * T
    E, Ep, k = cfg.num_experts, cfg.padded_experts, cfg.top_k
    dev = x.device

    if not rows:
        logits = (xf @ p["router"]).float()
    probs = torch.softmax(logits.reshape(Tt, -1), dim=-1)  # [Tt, E]
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = (topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)).to(x.dtype)

    # ---- position-in-expert via a stable sort ----
    flat_e = topi.reshape(-1)  # [Tt*k]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(Ep, dtype=torch.long, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))  # no host sync, unlike bincount
    starts = torch.cumsum(counts, 0) - counts  # exclusive
    pos_sorted = torch.arange(Tt * k, device=dev) - starts[sorted_e]
    xs = None if tp is None else tp.experts_on_data("wi_gate")
    if xs is not None:  # every data rank's counts: they decide the sends
        per = xs.counts(counts)
        total, n = per.sum(0), xs.n
        C = capacity(cfg, Tt * n)
    elif _ROUTE is None:
        total, n = counts, 1
        C = cap = capacity(cfg, Tt)
    else:  # the slots that the row slices before this one left
        before, total, n = _ROUTE(counts)
        C = capacity(cfg, Tt * n)
        cap = torch.clamp(C - before, min=0)
    e_lo, xd = 0, xf
    if mp is not None:  # the products' gradients are partial sums
        topw = mp.copy(topw)
        if not rows:  # else x entered the split above
            xd = mp.copy(xf)
        if mp.dim("wi_gate") == 0:  # this rank's experts
            e_lo = mp.range(p["wi_gate"].shape[0])[0]
    if xs is not None:
        gathered = _expert_parallel(p, xs, xd, flat_e, order, pos_sorted,
                                    sorted_e, per, C, k)
    elif TUNING.moe_shard_dispatch:
        gathered = _dispatch_2d(p, xd, sorted_e, flat_e, order, pos_sorted,
                                counts, starts, C, cap, e_lo)
    else:
        gathered = _dispatch_scatter(p, xd, sorted_e, order, pos_sorted, C,
                                     cap, e_lo)
    y = (gathered.view(Tt, k, d) * topw[..., None]).sum(dim=1).view(
        B, T, d)
    if mp is not None:
        y = mp.leave(y)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x_in, sub(tp, "shared"))

    # switch-style load-balance loss; over row slices, each takes the
    # whole batch's fractions and its own rows' mean probabilities, so the
    # mean over the slices (and its gradient) is the whole batch's loss
    frac_tokens = total[:E].float() / max(Tt * n * k, 1)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    return y, aux
