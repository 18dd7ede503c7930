"""AdamW with global-norm clipping, schedules, and gradient accumulation.

The reference's arithmetic (``repro.optim.adamw``) over trees of tensors
(dicts, lists and tuples, dict keys in sorted order as ``jax.tree``
flattens them): f32 moments whatever the parameter dtype, weight decay on
matrices (``ndim >= 2``) only, the clip scale ``min(1, max/(norm+1e-9))``
and ``lr(step)`` at ``step = state.step + 1``.  Not ``torch.optim.AdamW``,
which decays every leaf unless grouped and orders its update otherwise.

PyTorch has no buffer donation, so :meth:`adamw.update` writes the new
parameters and moments into the tensors it is given, in place, and
returns them: a 1.66 B-parameter model keeps one copy of its f32 state.

A tree may hold leaves on several devices (a mesh state's blocks); no
operation mixes two devices.  The global norm sums each device's leaves
there and sends each device's partial to the first leaf's device once;
the clip scale, ``lr`` and the bias corrections go once to each device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

__all__ = ["AdamWState", "adamw", "cosine_schedule", "linear_warmup",
           "global_norm", "clip_by_global_norm", "GradAccumulator",
           "tree_leaves", "tree_map"]


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, dict keys sorted
    (``jax.tree.leaves``'s order); ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in :func:`tree_leaves`'s
    order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: dict
    nu: dict


def global_norm(tree) -> torch.Tensor:
    """The f32 norm of every leaf, on the first leaf's device."""
    leaves = tree_leaves(tree)
    partial: dict = {}
    for l in leaves:
        d = l.device
        if d not in partial:
            partial[d] = torch.zeros((), dtype=torch.float32, device=d)
        partial[d] = partial[d] + torch.sum(torch.square(l.to(torch.float32)))
    lead = leaves[0].device
    total = partial.pop(lead)
    for t in partial.values():
        total = total + t.to(lead)
    return torch.sqrt(total)


def _per_device(x: torch.Tensor) -> Callable:
    """``fn(device)``: ``x`` there, copied once a device."""
    copies = {x.device: x}

    def on(device):
        if device not in copies:
            copies[device] = x.to(device)
        return copies[device]
    return on


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = _per_device(torch.clamp(max_norm / (norm + 1e-9), max=1.0))
    return tree_map(
        lambda g: (g.to(torch.float32) * scale(g.device)).to(g.dtype),
        tree), norm


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return fn


def linear_warmup(base_lr: float, warmup: int):
    return lambda step: base_lr * torch.clamp(
        (step.to(torch.float32) + 1) / warmup, max=1.0)


@dataclasses.dataclass(frozen=True)
class adamw:
    """AdamW transform: ``opt.init(params)``, ``opt.update(grads, state,
    params)``."""

    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            mu=zeros, nu=tree_map(torch.clone, zeros))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, decay=None):
        """One AdamW step.  Writes the new parameters into ``params`` and
        the new moments into ``state.mu``/``state.nu`` in place; returns
        ``(params, AdamWState(step + 1, mu, nu), {"grad_norm", "lr"})``.
        ``decay``: a tree of bools beside ``params`` naming the leaves
        that take weight decay (default: ``ndim >= 2``, the matrices)."""
        step = state.step + 1
        if self.clip_norm:
            grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        else:
            gnorm = global_norm(grads)
        stepf = step.to(torch.float32)
        lr = self.lr(step) if callable(self.lr) else torch.tensor(
            self.lr, dtype=torch.float32, device=stepf.device)
        lr_on = _per_device(lr)
        bias1 = _per_device(1 - self.b1 ** stepf)
        bias2 = _per_device(1 - self.b2 ** stepf)

        if decay is None:
            decay = tree_map(lambda p: p.ndim >= 2, params)

        def upd(g, m, v, p, decayed):
            g = g.to(torch.float32)
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            delta = (m / bias1(m.device)) / (torch.sqrt(v / bias2(v.device))
                                             + self.eps)
            if self.weight_decay and decayed:
                delta = delta + self.weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr_on(p.device) * delta)

        tree_map(upd, grads, state.mu, state.nu, params, decay)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), \
            metrics


class GradAccumulator:
    """Micro-batch gradient accumulation."""

    @staticmethod
    def accumulate(loss_fn, params, batches):
        """``loss_fn(params, batch) -> (loss, aux)``; ``params`` a tree of
        tensors that require grad; ``batches`` a tree with a leading
        microbatch axis.  Returns (mean_loss, mean_grads, mean_aux): the
        f32 grads summed over the microbatches, then scaled by 1/n."""
        leaves = tree_leaves(params)
        n = tree_leaves(batches)[0].shape[0]
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        loss = aux = torch.zeros((), dtype=torch.float32,
                                 device=leaves[0].device)
        for i in range(n):
            l, a = loss_fn(params, tree_map(lambda x: x[i], batches))
            gs = torch.autograd.grad(l, leaves)
            acc = [s + g for s, g in zip(acc, gs)]
            loss, aux = loss + l.detach(), aux + a.detach()
        inv = 1.0 / n
        it = iter([g * inv for g in acc])
        return loss * inv, tree_map(lambda _: next(it), params), aux * inv
