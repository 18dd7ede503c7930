"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch.

The reference's ``repro.models.moe`` on one device: the router runs in
f32, each token's top-k gates are renormalised, the Switch load-balance
loss is returned beside the output, and position-in-expert comes from a
stable sort over the token-major ``(T*k,)`` assignment list.  An
assignment whose position reaches the capacity ``C`` drops
(``ceil(T*k/E * capacity_factor)`` in train mode; ``dropless`` sets
``C = T``, the exact bound, for serving).  The expert FFNs run as three
batched products over the expert axis (``torch.bmm``), as the
reference's einsums over its ``(E, C, D)`` buffer do.

One departure in size, not in value: the buffer holds
``min(C, max tokens of any expert)`` rows (one host read per dispatch
group; ``C`` rows on the ``meta`` device, which has no values to read).
A row past an expert's count is zero in the reference and never
gathered, so the output is the same; dropless serving would otherwise
build ``(E, T, D)`` and do ``E/k`` times the useful expert work.

Expert parallelism, the reference's ``shard_map`` branch: under an
active mesh (``sharding.rules.activate``) whose ``model`` extent ``tp``
divides ``num_experts``, the group's tokens are routed once (the
reference routes the same tokens the same way on every slot) and model
slot ``m`` runs experts ``[m E/tp, (m+1) E/tp)`` on its own device
(``rules.model_devices()[m]``): the tokens and the routing go there, its
experts' weights are that range of the parameters (a view where the slot
shares the group's device, a copy otherwise), its buffer is sized by its
own experts' largest count, and its partial output comes back to the
group's device, where the slots' partials are summed in f32, as the
reference's ``psum``.  The aux loss is the global routing's, the same on
every slot.  Otherwise (no mesh, or Granite's 40 experts on a ``model``
extent of 16) the dense path runs.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.runtime import trace
from repro_torch.sharding.rules import (axis_size, current_mesh,
                                        model_devices, shard)

__all__ = ["MoEOut", "Routing", "init_moe", "moe_ffn", "route",
           "DISPATCH_OBSERVERS"]

#: callables ``f(counts, dropped)``, each told every dispatch group's
#: tokens per expert (an ``(E,)`` tensor) and its dropped assignments (a
#: 0-d tensor); whoever appends one removes it after
DISPATCH_OBSERVERS: list = []


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


class Routing(NamedTuple):
    """One dispatch group's routing, in the reference's token-major
    ``(T*k,)`` assignment order (assignment ``t*k + j`` is token ``t``'s
    ``j``-th choice)."""
    probs: torch.Tensor      # (T, E) f32
    gates: torch.Tensor      # (T, k) f32, renormalised
    experts: torch.Tensor    # (T, k) int64
    pos: torch.Tensor        # (T*k,) position in its expert's queue
    keep: torch.Tensor       # (T*k,) bool: pos < cap
    counts: torch.Tensor     # (E,) assignments per expert
    cap: int


def init_moe(gen: torch.Generator, d: int, mcfg, device) -> dict:
    """The reference's initial distributions, drawn from ``gen`` (f32)."""
    e, dff = mcfg.num_experts, mcfg.d_ff_expert

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * scale
    return {"router": dense_init(gen, d, e, device),
            "wi_gate": normal((e, d, dff), 1.0 / math.sqrt(d)),
            "wi_up": normal((e, d, dff), 1.0 / math.sqrt(d)),
            "wo": normal((e, dff, d), 1.0 / math.sqrt(dff))}


def _capacity(t: int, mcfg, dropless: bool) -> int:
    if dropless:
        return t        # exact bound: a token's top-k experts are distinct
    cap = math.ceil(t * mcfg.top_k / mcfg.num_experts * mcfg.capacity_factor)
    return max(min(cap, t * mcfg.top_k), 1)


def route(xt: torch.Tensor, router: torch.Tensor, mcfg,
          dropless: bool) -> Routing:
    """Top-k routing of one group's tokens ``xt`` (T, D) and each
    assignment's position in its expert's queue."""
    t = xt.shape[0]
    e, k = mcfg.num_experts, mcfg.top_k
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    cap = _capacity(t, mcfg, dropless)
    flat_expert = experts.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    # scatter_add_ gives bincount's integers and, unlike it, runs on meta
    counts = torch.zeros(e, dtype=torch.int64, device=xt.device).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(t * k, device=xt.device) - \
        starts[flat_expert[order]]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return Routing(probs=probs, gates=gates, experts=experts, pos=pos,
                   keep=pos < cap, counts=counts, cap=cap)


def _on(r: Routing, device) -> Routing:
    """The routing fields :func:`_experts` reads, on ``device``."""
    return r._replace(gates=r.gates.to(device), experts=r.experts.to(device),
                      pos=r.pos.to(device))


def _moe_group(xt: torch.Tensor, p, mcfg, act: str, dropless: bool,
               slots=None):
    """One dispatch group: (T, D) -> ((T, D), aux).  ``slots``: the
    expert-parallel branch's ``model`` slot devices."""
    t, d = xt.shape
    e = mcfg.num_experts
    with trace.span("moe_dispatch"):
        r = route(xt, p["router"], mcfg, dropless)
        # load-balance aux loss (Switch): E * sum_e f_e * p_e
        density = torch.mean(F.one_hot(r.experts[:, 0], e).to(torch.float32),
                             dim=0)
        aux = e * torch.sum(density * torch.mean(r.probs, dim=0)) \
            * mcfg.aux_loss_weight
        for observe in DISPATCH_OBSERVERS:
            observe(r.counts, torch.sum(~r.keep))
    # one host read sizes every buffer; on meta, where nothing can be read,
    # the static capacity (the reference's own (E, C, D) buffer)
    on_meta = xt.device.type == "meta"
    if slots is None:
        rows = r.cap if on_meta else min(r.cap, int(r.counts.max()))
        return _experts(xt, r, p, 0, r.keep, rows, act), aux.to(torch.float32)
    with trace.span("moe_dispatch"):
        counts = [r.cap] * e if on_meta else r.counts.tolist()
        flat_expert = r.experts.reshape(-1)
    n = e // len(slots)
    y = torch.zeros((t, d), dtype=torch.float32, device=xt.device)
    for m, dev in enumerate(slots):         # slot m: experts [lo, lo + n)
        lo = m * n
        with trace.span("moe_dispatch"):
            mine = r.keep & (flat_expert >= lo) & (flat_expert < lo + n)
            w = {k: p[k][lo:lo + n].to(dev)
                 for k in ("wi_gate", "wi_up", "wo")}
            rows = min(r.cap, max(counts[lo:lo + n]))
        part = _experts(xt.to(dev), _on(r, dev), w, lo, mine.to(dev), rows,
                        act)
        y = y + part.to(xt.device, torch.float32)
    return y.to(xt.dtype), aux.to(torch.float32)


def _experts(xt: torch.Tensor, r: Routing, w, lo: int, keep: torch.Tensor,
             rows: int, act: str) -> torch.Tensor:
    """The experts ``[lo, lo + n)``, whose weights ``w`` holds, on the
    assignments ``keep`` selects, each expert's buffer ``rows`` deep;
    gated and summed per token: (T, D) on ``xt``'s device."""
    t, d = xt.shape
    n = w["wo"].shape[0]
    k = r.experts.shape[1]
    if rows == 0:                       # no token chose these experts
        return xt.new_zeros((t, d))
    with trace.span("moe_dispatch"):
        expert = torch.clamp(r.experts.reshape(-1) - lo, 0, n - 1)
        # an assignment not kept writes the spare row ``rows``, never read
        slot = torch.where(keep, r.pos, rows)
        buf = xt.new_zeros((n, rows + 1, d))
        buf = buf.index_put((expert, slot),
                            xt.repeat_interleave(k, dim=0))[:, :rows]
    dtype = xt.dtype
    with trace.span("moe_experts"):
        g = torch.bmm(buf, w["wi_gate"].to(dtype))
        u = torch.bmm(buf, w["wi_up"].to(dtype))
        a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
        eo = torch.bmm(a * u, w["wo"].to(dtype))   # (n, rows, D)
    with trace.span("moe_dispatch"):
        out = eo[expert, torch.clamp(slot, max=rows - 1)]   # (T*k, D)
        out = torch.where(keep[:, None], out, 0.0) \
            * r.gates.reshape(-1, 1).to(dtype)
        return torch.sum(out.reshape(t, k, d), dim=1)


def moe_ffn(p, x: torch.Tensor, mcfg, act: str = "silu",
            dropless: bool = False) -> MoEOut:
    """x: (B, S, D) -> (B, S, D). Top-k routed expert SwiGLU (GeGLU with
    ``act="gelu"``).

    ``dropless=True`` sets capacity to the exact upper bound (the serving
    path: decode agrees with prefill when nothing drops there either).
    ``mcfg.groups > 1`` dispatches per token group (when it divides
    ``B*S``); the aux loss is the groups' mean.
    """
    b, s, d = x.shape
    t_all = b * s
    g = mcfg.groups if (mcfg.groups and t_all % mcfg.groups == 0) else 1
    xg = shard(x.reshape(g, t_all // g, d), "dp", None, None)
    tp = axis_size("tp")
    slots = model_devices() if (current_mesh() is not None and tp > 1 and
                                mcfg.num_experts % tp == 0) else None
    ys, auxs = zip(*(_moe_group(xg[i], p, mcfg, act, dropless, slots)
                     for i in range(g)))
    y = shard(torch.stack(ys), "dp", None, None)
    return MoEOut(y=y.reshape(b, s, d),
                  aux_loss=torch.mean(torch.stack(auxs)))
