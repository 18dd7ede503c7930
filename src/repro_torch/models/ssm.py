"""Selective SSM (Mamba-style) branch used by the Hymba hybrid.

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t        (per channel, N states)
    y_t = C_t . h_t + D * x_t

Prefill/train: a loop over time in chunks of ``CHUNK`` steps, with a
hand-written backward (:class:`_SelectiveScan`); decode: one step.  The
short causal conv in front is the stencil-matrixization integration
point: with ``kernel_impl == "cuda"`` it runs through
``kernels.ops.banded_mix`` (the banded-mixer kernel on a card, its plain
version on the CPU), with ``"ref"`` through ``kernels.ref.banded_mixer_ref``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import banded_mix
from repro_torch.kernels.ref import banded_mixer_ref
from repro_torch.models.layers import dense, dense_init
from repro_torch.runtime import trace

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
    dt = F.softplus(dense(p["dt_proj"], dt_lr) + p["dt_bias"].to(x.dtype))
    return dt, b, c


def _scan(dtf, dtx, bbf, ccf, a, h, starts: list | None = None):
    """The recurrence over time: ``dtf``/``dtx`` (B, T, DI), ``bbf``/``ccf``
    (B, T, N), ``a`` (DI, N), ``h`` (B, DI, N), all f32.  Returns
    (y (B, T, DI), final h).

    The (B, DI, N) state stays resident across the loop; per chunk of
    ``CHUNK`` steps the decay ``exp(dt*A)`` and the rank-1 input ``dt*x*B``
    are formed for that chunk only (never for all T), and each step is one
    fused multiply-add into the chunk's buffer.  ``starts``, when given,
    receives a copy of the state at the start of each chunk."""
    t = dtf.shape[1]
    ys = []
    for c0 in range(0, t, CHUNK):
        sl = slice(c0, min(c0 + CHUNK, t))
        if starts is not None:
            starts.append(h.clone())
        # (L, B, DI, N): step i of the chunk at [i]
        decay = torch.exp(dtf[:, sl].transpose(0, 1)[..., None] * a)
        hs = dtx[:, sl].transpose(0, 1)[..., None] \
            * bbf[:, sl].transpose(0, 1)[:, :, None, :]
        for i in range(hs.shape[0]):
            h = hs[i].addcmul_(h, decay[i])   # h_t = h*exp(dt*A) + u_t
        ys.append(torch.einsum("lbdn,lbn->bld", hs,
                               ccf[:, sl].transpose(0, 1)))
    return torch.cat(ys, dim=1), h.clone()   # h: not a view of a buffer


class _SelectiveScan(torch.autograd.Function):
    """:func:`_scan` with a gradient, the reference's ``@jax.checkpoint
    chunk_body`` done by hand.  The forward is :func:`_scan` itself and
    keeps the state at each chunk's start.  The backward walks the chunks
    in reverse: it recomputes a chunk's states from its start, runs the
    adjoint recurrence ``g_i = dy_i C_i + g_{i+1} exp(dt_{i+1} A)`` one
    fused multiply-add a step, and forms every other gradient of the chunk
    in a few batched products."""

    @staticmethod
    def forward(ctx, dtf, dtx, bbf, ccf, a, h0):
        starts: list = []
        y, h = _scan(dtf, dtx, bbf, ccf, a, h0, starts)
        ctx.save_for_backward(dtf, dtx, bbf, ccf, a, *starts)
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        with trace.span("ssm_scan_backward"):
            return _SelectiveScan._backward(ctx, gy, gh)

    @staticmethod
    def _backward(ctx, gy, gh):
        dtf, dtx, bbf, ccf, a, *starts = ctx.saved_tensors
        t = dtf.shape[1]
        ddt, ddtx = torch.empty_like(dtf), torch.empty_like(dtx)
        dbb, dcc = torch.empty_like(bbf), torch.empty_like(ccf)
        da = torch.zeros_like(a)
        # grad into the state at the end of the current chunk from later
        # steps (the final state's own grad for the last chunk)
        carry = torch.zeros_like(starts[0]) if gh is None else gh
        if gy is None:
            gy = torch.zeros_like(dtf)
        for k in range(len(starts) - 1, -1, -1):
            sl = slice(k * CHUNK, min((k + 1) * CHUNK, t))
            dtc = dtf[:, sl].transpose(0, 1)                 # (L, B, DI)
            dtxc = dtx[:, sl].transpose(0, 1)
            bc = bbf[:, sl].transpose(0, 1)                  # (L, B, N)
            cc = ccf[:, sl].transpose(0, 1)
            gyc = gy[:, sl].transpose(0, 1)
            decay = torch.exp(dtc[..., None] * a)            # (L, B, DI, N)
            hs = dtxc[..., None] * bc[:, :, None, :]
            h = starts[k]
            for i in range(hs.shape[0]):
                h = hs[i].addcmul_(h, decay[i])
            prev = torch.cat([starts[k][None], hs[:-1]])     # h_{i-1}
            gs = gyc[..., None] * cc[:, :, None, :]          # dy_i C_i
            gs[-1] += carry
            for i in range(hs.shape[0] - 2, -1, -1):
                gs[i].addcmul_(gs[i + 1], decay[i + 1])
            carry = gs[0] * decay[0]
            dcc[:, sl] = torch.einsum("lbd,lbdn->bln", gyc, hs)
            ddtx[:, sl] = torch.einsum("lbdn,lbn->bld", gs, bc)
            dbb[:, sl] = torch.einsum("lbdn,lbd->bln", gs, dtxc)
            dla = gs * prev * decay                          # d(dt A)
            ddt[:, sl] = torch.einsum("lbdn,dn->bld", dla, a)
            da += torch.einsum("lbdn,lbd->dn", dla, dtc)
        return ddt, ddtx, dbb, dcc, da, carry


def ssm_forward(p, xin, cfg, state: SSMState | None = None):
    """x: (B, T, D) -> (B, T, D); returns (y, new_state).

    The scan is :func:`_scan` (one fused step per token, chunks of
    ``CHUNK``); where a gradient is wanted it runs inside
    :class:`_SelectiveScan`, whose forward is the same loop."""
    b, t, d = xin.shape
    xz = dense(p["in_proj"], xin)
    x, z, new_tail = _conv_act(
        p, xz, cfg, conv_tail=state.conv_tail if state is not None else None)
    dt, bb, cc = _dt_b_c(p, x, cfg)

    with trace.span("ssm_scan"):
        a = -torch.exp(p["a_log"].to(torch.float32))            # (DI, N) < 0
        args = ((dt * x).to(torch.float32), bb.to(torch.float32),
                cc.to(torch.float32), a)
        dtf = dt.to(torch.float32)
        h = state.h if state is not None else torch.zeros(
            (b, a.shape[0], a.shape[1]), dtype=torch.float32,
            device=xin.device)
        if torch.is_grad_enabled() and any(
                v.requires_grad for v in (dtf, h) + args):
            y, h = _SelectiveScan.apply(dtf, *args, h)
        else:
            y, h = _scan(dtf, *args, h)
    y = y.to(xin.dtype) + p["d_skip"].to(x.dtype) * x
    y = y * F.silu(z)
    out = dense(p["out_proj"], y)
    return out, SSMState(h=h, conv_tail=new_tail)


def ssm_step(p, xin, cfg, state: SSMState):
    """Single-token decode. xin: (B, D)."""
    xz = dense(p["in_proj"], xin[:, None, :])
    x, z, new_tail = _conv_act(p, xz, cfg, conv_tail=state.conv_tail)
    x, z = x[:, 0], z[:, 0]
    dt, bb, cc = _dt_b_c(p, x, cfg)
    with trace.span("ssm_scan"):
        a = -torch.exp(p["a_log"].to(torch.float32))
        la = dt.to(torch.float32)[..., None] * a[None]
        u = (dt * x).to(torch.float32)[..., None] \
            * bb.to(torch.float32)[:, None, :]
        h = state.h * torch.exp(la) + u
        y = torch.einsum("bdn,bn->bd", h, cc.to(torch.float32)).to(xin.dtype)
    y = y + p["d_skip"].to(x.dtype) * x
    y = y * F.silu(z)
    return dense(p["out_proj"], y), SSMState(h=h, conv_tail=new_tail)
