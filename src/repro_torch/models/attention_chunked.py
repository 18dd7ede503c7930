"""Memory-bounded attention in plain PyTorch: the reference's
``repro.models.attention_chunked``, path for path.

  * ``_attn_block``: one dense block — decode (against the possibly ring
    cache) and any ``Sq <= q_chunk``.
  * ``_banded_window``: sliding-window prefill; each query chunk attends
    one statically sized (window + chunk) KV slab.
  * ``_dense_chunks``: global prefill, one (chunk x Skv) score tile per
    query chunk.
  * ``_flash``: ``kv_scan=True``, an online softmax over KV blocks.

Scores are f32; masked entries take ``NEG``; the probabilities are cast
to ``v.dtype`` before the PV product, as the reference does (bf16 in the
published configs).  The reference's ``lax.map`` over query chunks is a
Python loop here.  This module is jnp in the reference, not a TPU kernel,
so plain tensor products are its counterpart — not
``F.scaled_dot_product_attention``, which would skip the bf16 cast.

Tensor parallelism over heads (:func:`head_slots`): under
``sharding.rules.activate`` each ``model`` slot runs
:func:`chunked_attention` on its contiguous block of heads.  A GQA group
never straddles two slots: the KV heads split where KVH divides the
``model`` extent; otherwise, where H divides it and a group is at most
4 heads, K/V repeat to H first — the reference's repeat for head
sharding (its ``_dense_chunks``), here done by the split — and the heads
split; otherwise attention runs whole.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import axis_size, tp_slots

__all__ = ["chunked_attention", "head_slots", "NEG"]

NEG = -1e30


def head_slots(h: int, kvh: int, sent: int = 0,
               returned: int = 0) -> Optional[list]:
    """The attention heads' split over the active group's ``model`` slots
    (counted as ``rules.tp_slots`` site ``"attention"``):
    ``[(device, (q_lo, q_hi), (kv_lo, kv_hi), repeat)]``, slot ``m``'s
    query heads and the KV heads they read, ``repeat`` where the slot's
    K/V repeat to one head per query head first; ``None`` where
    attention runs whole."""
    tp = axis_size("tp")
    group = h // kvh
    if kvh % tp == 0:
        slots = tp_slots("attention", kvh, sent, returned)
        return None if slots is None else [
            (d, (lo * group, hi * group), (lo, hi), False)
            for d, lo, hi in slots]
    slots = tp_slots("attention", h if group <= 4 else None, sent, returned)
    return None if slots is None else [
        (d, (lo, hi), (lo // group, -(-hi // group)), True)
        for d, lo, hi in slots]


def chunked_attention(q, k, v, *, q_positions, k_positions, causal=True,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None, kv_valid_len=None,
                      kv_mask=None, q_chunk: int = 128, kv_block: int = 128,
                      kv_scan: bool = False):
    """q: (B, Sq, H, Dh); k/v: (B, Skv, KVH, Dh). Returns (B, Sq, H, Dh).

    ``q_positions``/``k_positions``: absolute positions, (Sq,)/(Skv,).
    ``kv_mask``: optional (Skv,) validity mask (ring caches, decode only).
    """
    b, sq, h, dh = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = 1.0 / math.sqrt(dh)

    if sq <= q_chunk:
        return _attn_block(q, k, v, q_positions, k_positions, causal, window,
                           softcap, kv_valid_len, kv_mask, group, scale)

    if kv_valid_len is not None or kv_mask is not None:
        raise ValueError("cache masks are decode-only; train/prefill pass "
                         "fresh K/V")

    pad = (-sq) % q_chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_positions = torch.cat([q_positions,
                                 q_positions[-1:].expand(pad)])
    nq = q.shape[1] // q_chunk
    qs = [q[:, i * q_chunk:(i + 1) * q_chunk] for i in range(nq)]
    qpos = q_positions.reshape(nq, q_chunk)

    if window is not None and causal and window < skv:
        outs = _banded_window(qs, qpos, k, v, k_positions, window, softcap,
                              group, scale, q_chunk)
    elif kv_scan:
        outs = _flash(qs, qpos, k, v, k_positions, causal, window, softcap,
                      group, scale, kv_block)
    else:
        outs = _dense_chunks(qs, qpos, k, v, k_positions, causal, window,
                             softcap, group, scale)
    return torch.cat(outs, dim=1)[:, :sq]


def _window_mask(q_pos, k_pos, causal, window):
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def _grouped_scores(qc, k, group, scale, softcap):
    """(B, KVH, G, Lq, Skv) f32 scores of a query chunk."""
    b, lq, _, dh = qc.shape
    kvh = k.shape[2]
    qg = qc.reshape(b, lq, kvh, group, dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    return s


# ---------------------------------------------------------------------------
# dense q-chunk blocks (global causal train/prefill)
# ---------------------------------------------------------------------------

def _dense_chunks(qs, qpos, k, v, k_pos, causal, window, softcap, group,
                  scale):
    """One (Lq x Skv) score tile per q chunk (the reference's repeat of
    K/V for head sharding is :func:`head_slots`'s)."""
    b, _, kvh, dh = k.shape
    outs = []
    for qc, qp in zip(qs, qpos):
        lq = qc.shape[1]
        s = _grouped_scores(qc, k, group, scale, softcap)
        s = torch.where(_window_mask(qp, k_pos, causal, window), s, NEG)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        out = torch.einsum("bkgqt,btkd->bqkgd", p, v).reshape(
            b, lq, kvh * group, dh)
        outs.append(out.to(qc.dtype))
    return outs


# ---------------------------------------------------------------------------
# banded-slab window attention (stencil-blocked)
# ---------------------------------------------------------------------------

def _banded_window(qs, qpos, k, v, k_pos, window, softcap, group, scale,
                   q_chunk):
    # slab length: window + chunk, rounded to the chunk grid
    slab = math.ceil((window + q_chunk) / q_chunk) * q_chunk
    kp = F.pad(k, (0, 0, 0, 0, slab, 0))
    vp = F.pad(v, (0, 0, 0, 0, slab, 0))
    kpp = F.pad(k_pos, (slab, 0), value=-(10 ** 9))
    outs = []
    for i, (qc, qp) in enumerate(zip(qs, qpos)):
        # slab covering positions [chunk_end - slab + 1, chunk_end]; the
        # start is clamped into the padded K/V as lax.dynamic_slice does
        start = min(i * q_chunk + q_chunk, kp.shape[1] - slab)
        outs.append(_attn_block(qc, kp[:, start:start + slab],
                                vp[:, start:start + slab], qp,
                                kpp[start:start + slab], True, window,
                                softcap, None, None, group, scale))
    return outs


# ---------------------------------------------------------------------------
# flash-style online softmax over KV blocks
# ---------------------------------------------------------------------------

def _flash(qs, qpos, k, v, k_pos, causal, window, softcap, group, scale,
           kv_block):
    b, skv, kvh, dh = k.shape
    pad = (-skv) % kv_block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=10 ** 9)
    nk = k.shape[1] // kv_block
    outs = []
    for qc, qp in zip(qs, qpos):
        lq = qc.shape[1]
        m = torch.full((b, kvh, group, lq), NEG, dtype=torch.float32,
                       device=qc.device)
        l = torch.zeros((b, kvh, group, lq), dtype=torch.float32,
                        device=qc.device)
        acc = torch.zeros((b, kvh, group, lq, dh), dtype=torch.float32,
                          device=qc.device)
        for j in range(nk):
            blk = slice(j * kv_block, (j + 1) * kv_block)
            s = _grouped_scores(qc, k[:, blk], group, scale, softcap)
            s = torch.where(_window_mask(qp, k_pos[blk], causal, window),
                            s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p, v[:, blk].to(torch.float32))
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        # (B, KVH, G, Lq, Dh) -> (B, Lq, H, Dh)
        out = out.permute(0, 3, 1, 2, 4).reshape(b, lq, kvh * group, dh)
        outs.append(out.to(qc.dtype))
    return outs


# ---------------------------------------------------------------------------
# dense single block (decode + window slabs)
# ---------------------------------------------------------------------------

def _attn_block(q, k, v, q_pos, k_pos, causal, window, softcap, kv_valid_len,
                kv_mask, group, scale):
    b, sq, h, dh = q.shape
    scores = _grouped_scores(q, k, group, scale, softcap)
    m = _window_mask(q_pos, k_pos, causal, window)
    if kv_valid_len is not None:
        m &= (torch.arange(k.shape[1], device=q.device) < kv_valid_len)[None, :]
    if kv_mask is not None:
        m &= kv_mask[None, :]
    scores = torch.where(m, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, sq, h, dh)
