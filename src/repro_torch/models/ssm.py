"""Selective SSM (Mamba-style) branch used by the Hymba hybrid.

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t        (per channel, N states)
    y_t = C_t . h_t + D * x_t

Prefill/train: a loop over time in chunks of ``CHUNK`` steps; decode: one
step.  The short causal conv in front is the stencil-matrixization
integration point: with ``kernel_impl == "cuda"`` it runs through
``kernels.ops.banded_mix`` (the banded-mixer kernel on a card, its plain
version on the CPU), with ``"ref"`` through ``kernels.ref.banded_mixer_ref``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.kernels.ops import banded_mix
from repro_torch.kernels.ref import banded_mixer_ref
from repro_torch.models.layers import dense, dense_init

__all__ = ["init_ssm", "ssm_forward", "ssm_step", "SSMState",
           "init_ssm_state", "CHUNK"]

CHUNK = 32


class SSMState(NamedTuple):
    h: torch.Tensor          # (B, DI, N) f32
    conv_tail: torch.Tensor  # (B, W-1, DI) trailing inputs for the conv


def init_ssm_state(batch: int, cfg, dtype=torch.float32, *,
                   device) -> SSMState:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return SSMState(
        h=torch.zeros((batch, di, s.state_dim), dtype=torch.float32,
                      device=device),
        conv_tail=torch.zeros((batch, s.conv_width - 1, di), dtype=dtype,
                              device=device))


def _dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank or math.ceil(cfg.d_model / 16)


def init_ssm(gen: torch.Generator, cfg, device) -> dict:
    """The reference's initial distributions, drawn from ``gen`` (f32)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    n = s.state_dim
    dt_rank = _dt_rank(cfg)
    band_shape = (s.conv_width,) + (() if s.conv_shared else (di,))
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)[None, :]
    u = torch.rand((di,), generator=gen, device=device) * (0.1 - 1e-3) + 1e-3
    return {
        "in_proj": dense_init(gen, d, 2 * di, device),
        "conv_band": torch.randn(band_shape, generator=gen, device=device)
        * (1.0 / s.conv_width),
        "x_proj": dense_init(gen, di, dt_rank + 2 * n, device),
        "dt_proj": dense_init(gen, dt_rank, di, device,
                              scale=dt_rank ** -0.5),
        "dt_bias": torch.log(torch.exp(torch.clamp(u, min=1e-4)) - 1.0),
        "a_log": torch.log(a.expand(di, n)).contiguous(),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, di, d, device),
    }


def _conv_act(p, xz, cfg, conv_tail=None):
    """Causal short conv (+silu) via the banded mixer; returns also the
    new tail for decode continuation."""
    s = cfg.ssm
    x, z = torch.chunk(xz, 2, dim=-1)
    if conv_tail is not None:
        x_ext = torch.cat([conv_tail.to(x.dtype), x], dim=1)
    else:
        x_ext = x
    band = p["conv_band"].to(torch.float32)
    if cfg.kernel_impl == "cuda":
        # (W,) shared or (W, DI) depthwise band, f32 in and out
        y = banded_mix(x_ext.to(torch.float32), band)
    else:
        y = banded_mixer_ref(x_ext.to(torch.float32), band)
    y = y[:, -x.shape[1]:, :].to(x.dtype)
    # a copy, not a view that keeps the whole (B, T, DI) input alive
    new_tail = x_ext[:, x_ext.shape[1] - (s.conv_width - 1):, :].clone()
    return F.silu(y), z, new_tail


def _dt_b_c(p, x, cfg):
    n = cfg.ssm.state_dim
    dt_rank = _dt_rank(cfg)
    dbc = dense(p["x_proj"], x)
    dt_lr, b, c = torch.split(dbc, [dt_rank, n, n], dim=-1)
    dt = F.softplus(dense(p["dt_proj"], dt_lr) + p["dt_bias"])
    return dt, b, c


def ssm_forward(p, xin, cfg, state: SSMState | None = None):
    """x: (B, T, D) -> (B, T, D); returns (y, new_state).

    The (B, DI, N) state stays resident across the loop over time; per
    chunk of ``CHUNK`` steps the decay ``exp(dt*A)`` and the rank-1 input
    ``dt*x*B`` are formed for that chunk only (never for all T), and each
    step is one fused multiply-add into the chunk's buffer.  The in-place
    steps make this an inference path: it is not differentiated."""
    b, t, d = xin.shape
    xz = dense(p["in_proj"], xin)
    x, z, new_tail = _conv_act(
        p, xz, cfg, conv_tail=state.conv_tail if state is not None else None)
    dt, bb, cc = _dt_b_c(p, x, cfg)

    with record_function("ssm_scan"):
        a = -torch.exp(p["a_log"].to(torch.float32))            # (DI, N) < 0
        dtx = (dt * x).to(torch.float32)
        dtf = dt.to(torch.float32)
        bbf = bb.to(torch.float32)
        ccf = cc.to(torch.float32)
        h = state.h if state is not None else torch.zeros(
            (b, a.shape[0], a.shape[1]), dtype=torch.float32,
            device=xin.device)
        ys = []
        for c0 in range(0, t, CHUNK):
            sl = slice(c0, min(c0 + CHUNK, t))
            # (L, B, DI, N): step i of the chunk at [i]
            decay = torch.exp(dtf[:, sl].transpose(0, 1)[..., None] * a)
            hs = dtx[:, sl].transpose(0, 1)[..., None] \
                * bbf[:, sl].transpose(0, 1)[:, :, None, :]
            for i in range(hs.shape[0]):
                h = hs[i].addcmul_(h, decay[i])   # h_t = h*exp(dt*A) + u_t
            ys.append(torch.einsum("lbdn,lbn->bld", hs,
                                   ccf[:, sl].transpose(0, 1)))
        y = torch.cat(ys, dim=1)
        h = h.clone()    # not a view that keeps the last chunk's buffer
    y = y.to(xin.dtype) + p["d_skip"] * x
    y = y * F.silu(z)
    out = dense(p["out_proj"], y)
    return out, SSMState(h=h, conv_tail=new_tail)


def ssm_step(p, xin, cfg, state: SSMState):
    """Single-token decode. xin: (B, D)."""
    xz = dense(p["in_proj"], xin[:, None, :])
    x, z, new_tail = _conv_act(p, xz, cfg, conv_tail=state.conv_tail)
    x, z = x[:, 0], z[:, 0]
    dt, bb, cc = _dt_b_c(p, x, cfg)
    with record_function("ssm_scan"):
        a = -torch.exp(p["a_log"].to(torch.float32))
        la = dt.to(torch.float32)[..., None] * a[None]
        u = (dt * x).to(torch.float32)[..., None] \
            * bb.to(torch.float32)[:, None, :]
        h = state.h * torch.exp(la) + u
        y = torch.einsum("bdn,bn->bd", h, cc.to(torch.float32)).to(xin.dtype)
    y = y + p["d_skip"] * x
    y = y * F.silu(z)
    return dense(p["out_proj"], y), SSMState(h=h, conv_tail=new_tail)
