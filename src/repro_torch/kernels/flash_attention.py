"""Hopper kernel: fused causal flash attention (forward), with its plain
version and a differentiable entry point.

:func:`flash_attention_cuda` launches ``csrc/flash_attention.cu`` (built
for ``sm_90a`` by :mod:`cuda_build`), which replaces the JAX package's
Pallas TPU kernel ``repro.kernels.flash_attention.flash_attention_pallas``:
one CUDA block per (batch*head, query block), K/V tiles streamed through
shared memory, the online-softmax update in f32 in the order of the
reference kernel, scores never written to device memory.

:func:`flash_attention` is the differentiable wrapper: the kernel forward
and the reference's dense-recompute backward (``_bwd``), in plain torch
as the reference's is jnp.  No model calls it, in the reference or here;
the models use ``models.attention_chunked``.

Routing: a CPU tensor runs :func:`flash_attention_plain` (the dense
oracle); a CUDA tensor launches the kernel or raises — there is no
fallback and no silently shrunk tile.  The wrapper counts its launches in
``flash_attention_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.matrixization import SMEM_BYTES
from repro_torch.kernels import cuda_build

__all__ = ["flash_attention_cuda", "flash_attention_plain",
           "flash_attention", "HEAD_DIMS", "NEG"]

NEG = -1e30

#: head widths the kernel is compiled for
HEAD_DIMS = (8, 16, 64, 128)
MAX_THREADS = 256
MAX_GRID_Y = 65535


def _dense(q, k, v, causal: bool):
    """(probabilities, output), both f32: the reference's dense oracle."""
    dh = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(dh)
    if causal:
        n = q.shape[2]
        keep = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(keep, s, NEG)
    p = torch.softmax(s, dim=-1)
    return p, torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))


def flash_attention_plain(q, k, v, causal: bool = True) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_attention_cuda`: dense f32
    softmax attention, cast to ``q.dtype``."""
    return _dense(q, k, v, causal)[1].to(q.dtype)


def _threads_per_row(dh: int) -> int:
    return max(1, dh // 64)


def flash_attention_cuda(q, k, v, *, block_q: int = 128, block_k: int = 128,
                         causal: bool = True) -> torch.Tensor:
    """q/k/v: (B, H, S, Dh) with S a multiple of the blocks (each block is
    ``min(block, S)``). Returns (B, H, S, Dh) in ``q.dtype``.

    A CPU tensor runs :func:`flash_attention_plain`; a CUDA tensor launches
    ``csrc/flash_attention.cu`` or raises.
    """
    b, h, s, dh = q.shape
    block_q = min(block_q, s)
    block_k = min(block_k, s)
    if s % block_q or s % block_k:
        raise ValueError(f"S={s} must be a multiple of the blocks")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"kernel wrappers take CPU (plain version) or CUDA "
                         f"tensors on one device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16 q, k, v of one "
                         f"type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not supported (kernel built for "
                         f"{HEAD_DIMS})")
    g = _threads_per_row(dh)
    threads = block_q * g
    if threads > MAX_THREADS or (g > 1 and threads % 32):
        raise ValueError(f"block_q={block_q} at Dh={dh} needs {threads} "
                         f"threads (at most {MAX_THREADS}, a multiple of 32 "
                         f"when a row spans {g} threads)")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"B*H={b * h} exceeds the grid limit {MAX_GRID_Y}")
    stride = dh + (g if g > 1 else 0)
    smem = 4 * 2 * block_k * stride
    if smem > SMEM_BYTES:
        raise ValueError(f"block_k={block_k} at Dh={dh} needs {smem} B of "
                         f"shared memory (limit {SMEM_BYTES})")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = cuda_build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             int(q.dtype == torch.bfloat16), b * h, s, dh, block_q, block_k,
             1.0 / math.sqrt(dh), int(causal),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Kernel forward, dense-recompute backward (the reference's ``_bwd``:
    one S x S probability tile per (b, h), f32)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention_cuda(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        p, _ = _dense(q, k, v, ctx.causal)
        g = g.to(torch.float32)
        dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
        dp = torch.einsum("bhqd,bhkd->bhqk", g, v.to(torch.float32))
        delta = torch.sum(dp * p, dim=-1, keepdim=True)
        ds = p * (dp - delta) / math.sqrt(q.shape[-1])
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(torch.float32))
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(torch.float32))
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Differentiable flash attention: kernel forward, dense-oracle
    backward.  q/k/v: (B, H, S, Dh), S a multiple of 128 or at most 128."""
    return _FlashAttention.apply(q, k, v, causal)
