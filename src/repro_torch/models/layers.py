"""Shared neural building blocks of the LM stack.

Functions on tensors, as the reference's ``repro.models.layers``:
``dense`` weights are ``(d_in, d_out)`` and apply as ``x @ w``; parameter
dicts hold the reference's leaf names.  The ``*_init`` functions draw the
reference's distributions from an explicit ``torch.Generator`` (the
values differ from JAX's; parity tests carry JAX's weights across with
``transformer.params_from_numpy``).

``dense`` casts its weight to the input's dtype at each call, as the
reference does: a trainable model holds f32 parameters and computes in
bf16; the serving model holds each weight in the dtype it is read in
(cast once when the model is built), where the cast is a no-op.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import shard, tp_slots

__all__ = ["dense_init", "dense", "rms_norm_init", "rms_norm", "rope",
           "mlp_init", "mlp", "embed_init", "init_attention"]


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, device,
               scale: float | None = None) -> torch.Tensor:
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _normal(gen, (d_in, d_out), device) * s


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def rms_norm_init(d: int, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)  # (1 + w)


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """Gemma-style RMS norm: f32 inside, scale ``1 + w``, output in
    ``x.dtype``."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """Rotary embedding. x: (..., S, H, Dh); positions: (..., S).  Angles
    in f32, output in ``x.dtype``."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq    # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def init_attention(gen: torch.Generator, cfg, device,
                   cross: bool = False) -> dict:
    """Self-attention weights; with ``cross``, ``wk``/``wv`` read the
    conditioning (``cfg.cond_dim`` wide when set)."""
    d, h, kvh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv_in = cfg.cond_dim if cross and cfg.cond_dim else d
    p = {"wq": dense_init(gen, d, h * dh, device),
         "wk": dense_init(gen, kv_in, kvh * dh, device),
         "wv": dense_init(gen, kv_in, kvh * dh, device),
         "wo": dense_init(gen, h * dh, d, device,
                          scale=1.0 / math.sqrt(h * dh))}
    if cfg.qk_norm:
        p["q_norm"] = rms_norm_init(dh, device)
        p["k_norm"] = rms_norm_init(dh, device)
    return p


def mlp_init(gen: torch.Generator, d: int, d_ff: int, device) -> dict:
    return {"wi_gate": dense_init(gen, d, d_ff, device),
            "wi_up": dense_init(gen, d, d_ff, device),
            "wo": dense_init(gen, d_ff, d, device)}


def _gated(g: torch.Tensor, u: torch.Tensor, act: str) -> torch.Tensor:
    return (F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")) * u


def mlp(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP: SwiGLU (``silu``) or GeGLU (tanh-approximate ``gelu``).

    Tensor parallel where ``d_ff`` splits over the active group's
    ``model`` slots (``rules.tp_slots``): slot ``m`` computes its columns
    of ``wi_gate`` and ``wi_up`` and its partial product with its rows of
    ``wo`` on its own device, from that range of the weights (a view on
    ``x``'s device, a copy elsewhere); the partials are summed in f32 on
    ``x``'s device and cast back to ``x.dtype``.  The ranges are one
    ``chunk`` of each weight, so the backward writes each weight's
    gradient once (a slice's backward would fill a whole zero gradient
    a slot)."""
    nbytes = x.numel() * x.element_size()
    slots = tp_slots("mlp", p["wi_gate"].shape[-1], nbytes, nbytes)
    if slots is None:
        g = shard(dense(p["wi_gate"], x), "dp", None, "tp")
        u = shard(dense(p["wi_up"], x), "dp", None, "tp")
        return dense(p["wo"], _gated(g, u, act))
    tp = len(slots)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for (dev, _, _), wg, wu, wo in zip(slots, p["wi_gate"].chunk(tp, -1),
                                      p["wi_up"].chunk(tp, -1),
                                      p["wo"].chunk(tp, 0)):
        xm = x.to(dev)
        part = dense(wo.to(dev), _gated(dense(wg.to(dev), xm),
                                        dense(wu.to(dev), xm), act))
        y = y + part.to(x.device, torch.float32)
    return y.to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, device):
    return _normal(gen, (vocab, d), device) * 0.02
