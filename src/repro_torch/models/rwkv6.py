"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time mixing with
data-dependent per-channel decay.

The reference's ``repro.models.rwkv6``.  Training and prefill use the
chunkwise-parallel form: a loop over chunks of ``CHUNK`` tokens (the
reference's ``lax.scan``) carrying the f32 ``(B, H, C, V)`` state; within
a chunk the decay-weighted attention matrix is built in log-space with
every exponent argument <= 0, so it cannot overflow.  Decode is the O(1)
recurrence on the state.

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense, dense_init, rms_norm,
                                       rms_norm_init)
from repro_torch.runtime import trace

__all__ = ["init_rwkv_layer", "rwkv_time_mix", "rwkv_channel_mix",
           "RWKVState", "init_rwkv_state", "rwkv_time_mix_step", "CHUNK"]

CHUNK = 16
LORA = 32


class RWKVState(NamedTuple):
    s: torch.Tensor        # (B, H, C, V) f32 wkv state
    x_tm: torch.Tensor     # (B, D) previous normed token (time-mix shift)
    x_cm: torch.Tensor     # (B, D) previous normed token (channel-mix shift)


def init_rwkv_state(batch: int, cfg, dtype=torch.float32, *,
                    device) -> RWKVState:
    h, c = cfg.num_heads, cfg.head_dim
    return RWKVState(
        s=torch.zeros((batch, h, c, c), dtype=torch.float32, device=device),
        x_tm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        x_cm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device))


def init_rwkv_layer(gen: torch.Generator, cfg, device) -> dict:
    """The reference's initial distributions, drawn from ``gen`` (f32)."""
    d = cfg.d_model
    h, c = cfg.num_heads, cfg.head_dim

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * scale
    return {
        "mu_x": full((d,), 0.5),
        "mu_rwkvg": full((5, d), 0.5),
        "lora_a": dense_init(gen, d, LORA * 5, device, scale=0.01),
        "lora_b": normal((5, LORA, d), 0.01),
        "w_base": full((d,), -4.0),
        "w_lora_a": dense_init(gen, d, LORA, device, scale=0.01),
        "w_lora_b": dense_init(gen, LORA, d, device, scale=0.01),
        "u": normal((h, c), 0.1),
        "wr": dense_init(gen, d, h * c, device),
        "wk": dense_init(gen, d, h * c, device),
        "wv": dense_init(gen, d, h * c, device),
        "wg": dense_init(gen, d, h * c, device),
        "wo": dense_init(gen, h * c, d, device),
        "ln_out": rms_norm_init(h * c, device),
        # channel mix
        "cm_mu_k": full((d,), 0.5),
        "cm_mu_r": full((d,), 0.5),
        "cm_wk": dense_init(gen, d, cfg.d_ff, device),
        "cm_wv": dense_init(gen, cfg.d_ff, d, device),
        "cm_wr": dense_init(gen, d, d, device),
    }


def _ddlerp(p, x, x_shift):
    """Data-dependent token-shift interpolation (5 heads: r, w, k, v, g)."""
    xx = x_shift - x
    xxx = x + xx * p["mu_x"].to(x.dtype)
    lo = torch.tanh(dense(p["lora_a"], xxx))                    # (..., 5*LORA)
    lo = lo.reshape(lo.shape[:-1] + (5, LORA))
    mods = torch.einsum("...nl,nld->...nd", lo, p["lora_b"].to(x.dtype))
    mu = p["mu_rwkvg"].to(x.dtype)                              # (5, D)
    mixed = x[..., None, :] + xx[..., None, :] * (mu + mods)    # (..., 5, D)
    return mixed.unbind(-2)


def _rkvwg(p, x, x_shift, cfg):
    b = x.shape[0]
    h, c = cfg.num_heads, cfg.head_dim
    xr, xw, xk, xv, xg = _ddlerp(p, x, x_shift)
    r = dense(p["wr"], xr).reshape(b, -1, h, c)
    k = dense(p["wk"], xk).reshape(b, -1, h, c)
    v = dense(p["wv"], xv).reshape(b, -1, h, c)
    g = F.silu(dense(p["wg"], xg))
    # data-dependent decay, log-space, clamped for the chunked form
    w_in = p["w_base"].to(x.dtype) + dense(
        p["w_lora_b"], torch.tanh(dense(p["w_lora_a"], xw)))
    logw = -torch.exp(torch.clamp(w_in.to(torch.float32), -10.0, 3.0))  # < 0
    return r, k, v, g, logw.reshape(b, -1, h, c)


def rwkv_time_mix(p, x, cfg, state: RWKVState | None = None):
    """Chunked-parallel time mixing. x: (B, T, D), any T (the tail chunk is
    padded with steps that neither contribute nor decay).  ``state``
    carries the wkv state and the time-mix shift in.  Returns (y, final
    wkv state)."""
    b, t, _ = x.shape
    h, c = cfg.num_heads, cfg.head_dim
    pad = (-t) % CHUNK
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    tt = x.shape[1]

    prev = state.x_tm[:, None, :] if state is not None else \
        torch.zeros_like(x[:, :1])
    x_shift = torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)
    r, k, v, g, logw = _rkvwg(p, x, x_shift, cfg)
    if pad:
        # padded steps must neither contribute (k, v = 0) nor decay (logw = 0)
        valid = (torch.arange(tt, device=x.device) < t)[None, :, None, None]
        k = torch.where(valid, k, 0.0)
        v = torch.where(valid, v, 0.0)
        logw = torch.where(valid, logw, 0.0)
    u = p["u"].to(torch.float32)

    def to_chunks(a):          # (B, T, H, C) -> (nchunk, B, H, L, C)
        return a.reshape(b, tt // CHUNK, CHUNK, h, -1).permute(1, 0, 3, 2, 4)
    f32 = torch.float32
    rc, kc, vc, lwc = (to_chunks(a) for a in (r.to(f32), k.to(f32),
                                              v.to(f32), logw))
    s = state.s if state is not None else \
        torch.zeros((b, h, c, c), dtype=f32, device=x.device)
    lower = torch.tril(torch.ones((CHUNK, CHUNK), dtype=f32,
                                  device=x.device), diagonal=-1)
    eye = torch.eye(CHUNK, dtype=f32, device=x.device)
    ys = []
    with trace.span("rwkv_chunks"):
        for rr, kk, vv, lw in zip(rc, kc, vc, lwc):     # (B, H, L, C/V)
            lp = torch.cumsum(lw, dim=2)                # inclusive logs, <= 0
            lp_prev = lp - lw                           # exp(lp[t-1])
            y_inter = (rr * torch.exp(lp_prev)) @ s
            # intra-chunk decay: exp(lp_prev[t] - lp[tau]) masked tau < t
            diff = lp_prev[:, :, :, None, :] - lp[:, :, None, :, :]
            dmat = torch.exp(torch.clamp(diff, max=0.0)) \
                * lower[None, None, :, :, None]         # (B, H, L, L, C)
            a = torch.sum(rr[:, :, :, None, :] * kk[:, :, None, :, :] * dmat,
                          dim=-1)
            # diagonal (current token, bonus u)
            diag = torch.sum(rr * kk * u[None, :, None, :], dim=-1)
            a = a + diag[..., None] * eye
            ys.append(y_inter + a @ vv)
            # state to the next chunk
            k_scaled = kk * torch.exp(lp[:, :, -1:, :] - lp)   # <= 1 factors
            s = s * torch.exp(lp[:, :, -1, :])[..., None] + \
                k_scaled.transpose(-1, -2) @ vv
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, tt, h * c)[:, :t]
    y = rms_norm(p["ln_out"], y.to(x.dtype), cfg.norm_eps) * g[:, :t]
    return dense(p["wo"], y), s


def rwkv_time_mix_step(p, x, cfg, state: RWKVState):
    """Single-token decode: the exact recurrence. x: (B, D).  Returns (y,
    new wkv state)."""
    b, _ = x.shape
    h, c = cfg.num_heads, cfg.head_dim
    r, k, v, g, logw = _rkvwg(p, x[:, None, :],
                              state.x_tm[:, None, :].to(x.dtype), cfg)
    r, k, v = (a.reshape(b, h, c).to(torch.float32) for a in (r, k, v))
    w = torch.exp(logw.reshape(b, h, c))
    u = p["u"].to(torch.float32)
    kv = k[..., :, None] * v[..., None, :]                       # (B, H, C, V)
    y = (r[..., None, :] @ (state.s + u[None, :, :, None] * kv))[..., 0, :]
    s_new = state.s * w[..., None] + kv
    y = rms_norm(p["ln_out"], y.reshape(b, h * c).to(x.dtype),
                 cfg.norm_eps) * g.reshape(b, h * c)
    return dense(p["wo"], y), s_new


def rwkv_channel_mix(p, x, cfg, x_prev=None):
    """RWKV-6 channel mix (squared-ReLU FFN with token shift).

    x: (B, T, D); x_prev: (B, D) carry for decode/chunk continuation.
    Returns (y, last_x) so callers can carry the shift state.
    """
    prev = x_prev[:, None, :].to(x.dtype) if x_prev is not None else \
        torch.zeros_like(x[:, :1])
    x_shift = torch.cat([prev, x[:, :-1]], dim=1)
    xk = x + (x_shift - x) * p["cm_mu_k"].to(x.dtype)
    xr = x + (x_shift - x) * p["cm_mu_r"].to(x.dtype)
    k = torch.square(F.relu(dense(p["cm_wk"], xk)))
    y = torch.sigmoid(dense(p["cm_wr"], xr)) * dense(p["cm_wv"], k)
    return y, x[:, -1]
