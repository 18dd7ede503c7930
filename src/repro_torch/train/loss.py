"""Chunked cross-entropy: the (tokens x vocab) logits tensor is never
materialized at full sequence length.

The reference's ``repro.train.loss``: a loop over sequence chunks whose
body — one chunk's logits and log-sum-exp — runs under
``torch.utils.checkpoint`` (the reference's ``@jax.checkpoint one``), so
the forward keeps one chunk of logits live (B x C x V) and the backward
recomputes it.  Each chunk's logits carry the reference's
``shard(logits, "dp", None, "tp")`` constraint (``sharding.rules``).

Where the vocabulary splits over the active group's ``model`` slots
(``rules.tp_slots``, site ``"cross_entropy"``), slot ``m`` computes the
logits of its vocabulary range on its own device (its rows of a tied
``(V, D)`` head, its columns of a ``(D, V)`` one) and sends back their
log-sum-exp and its share of the label's logit (0 where the label lies
outside its range); the group's device forms the log-sum-exp over the
slots and the sum of the shares, in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.runtime import trace
from repro_torch.sharding.rules import shard, tp_slots

__all__ = ["chunked_cross_entropy", "cross_entropy_dense"]


def cross_entropy_dense(logits, labels, mask=None):
    """Reference CE (small shapes / tests). logits: (..., V), labels int."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logits.device)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _logits(h, w, transpose_head: bool):
    w = w.to(h.dtype)
    return (h @ w.T if transpose_head else h @ w).to(torch.float32)


def _chunk_nll(h, w, lbl, m, transpose_head: bool):
    """(sum of the chunk's masked NLL, sum of its mask)."""
    with trace.span("cross_entropy"):
        slots = tp_slots("cross_entropy", w.shape[0 if transpose_head else 1],
                         h.numel() * h.element_size()
                         + lbl.numel() * lbl.element_size(),
                         2 * lbl.numel() * 4)
        if slots is None:
            logits = shard(_logits(h, w, transpose_head), "dp", None, "tp")
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, lbl[..., None])[..., 0]
        else:
            lses, lls = [], []
            # one chunk of the head a slot: one gradient write of it
            heads = w.chunk(len(slots), 0 if transpose_head else 1)
            for (dev, lo, hi), head in zip(slots, heads):
                logits = _logits(h.to(dev), head.to(dev), transpose_head)
                mine = lbl.to(dev) - lo
                inside = (mine >= 0) & (mine < hi - lo)
                share = torch.gather(logits, -1, torch.clamp(
                    mine, 0, hi - lo - 1)[..., None])[..., 0]
                lses.append(torch.logsumexp(logits, dim=-1).to(h.device))
                lls.append(torch.where(inside, share, 0.0).to(h.device))
            lse = torch.logsumexp(torch.stack(lses), dim=0)
            ll = torch.sum(torch.stack(lls), dim=0)
        m = m.to(torch.float32)
        return torch.sum((lse - ll) * m), torch.sum(m)


def chunked_cross_entropy(hidden, head_w, labels, *, mask=None,
                          chunk: int = 512, transpose_head: bool = False):
    """CE of ``hidden @ head_w`` against labels, chunked over sequence.

    hidden: (B, S, D); head_w: (D, V) (or (V, D) with transpose_head, for
    tied embeddings); labels: (B, S).  Returns (mean_nll, token_count).
    """
    b, s, _ = hidden.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)
    labels = labels.long()
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    grad = torch.is_grad_enabled()
    nlls, counts = [], []
    for c0 in range(0, hidden.shape[1], chunk):
        args = (hidden[:, c0:c0 + chunk], head_w, labels[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk], transpose_head)
        nll, count = checkpoint(_chunk_nll, *args, use_reentrant=False,
                                preserve_rng_state=False) if grad \
            else _chunk_nll(*args)
        nlls.append(nll)
        counts.append(count)
    total = torch.sum(torch.stack(nlls))
    count = torch.clamp(torch.sum(torch.stack(counts)), min=1.0)
    return total / count, count
