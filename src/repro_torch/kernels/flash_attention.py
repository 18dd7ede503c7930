"""Hopper kernel: fused causal flash attention (forward), with its plain
version and a differentiable entry point.

:func:`flash_attention_cuda` launches ``csrc/flash_attention.cu`` (built
for ``sm_90a`` by :mod:`cuda_build`), which replaces the JAX package's
Pallas TPU kernel ``repro.kernels.flash_attention.flash_attention_pallas``:
FlashAttention-2's forward on the tensor cores with ``mma.sync`` — one
CUDA block of :data:`THREADS` threads per (batch*head, :data:`BLOCK_ROWS`
query rows), K/V tiles streamed through a cp.async ring of :data:`STAGES`
buffers in shared memory, the online softmax once per tile in registers,
bf16 products in bf16 and f32 products in 3xTF32, scores never written to
device memory.  ``block_q`` and ``block_k`` keep the reference's contract
(S a multiple of each, after ``min(block, S)``); the kernel's own tiles
are fixed and it masks a ragged end itself.

:func:`flash_attention` is the differentiable wrapper: the kernel forward
and the reference's dense-recompute backward (``_bwd``), in plain torch
as the reference's is jnp.  No model calls it, in the reference or here;
the models use ``models.attention_chunked``.

Routing: a CPU tensor runs :func:`flash_attention_plain` (the dense
oracle); a CUDA tensor launches the kernel or raises — there is no
fallback.  The wrapper counts its launches in
``flash_attention_cuda.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.matrixization import SMEM_BYTES
from repro_torch.kernels import cuda_build

__all__ = ["flash_attention_cuda", "flash_attention_plain",
           "flash_attention", "smem_bytes", "HEAD_DIMS", "NEG"]

NEG = -1e30

#: head widths the kernel is compiled for
HEAD_DIMS = (8, 16, 64, 128)
MAX_GRID_Y = 65535
# The kernel's shape (csrc/flash_attention.cu defines the same numbers):
# THREADS threads (4 warps) own BLOCK_ROWS query rows; K and V stream in
# tiles of KV_TILE rows (KV_TILE_NARROW for f32 at Dh = 128) through a ring
# of STAGES shared-memory buffers, rows padded by PAD elements.
THREADS = 128
BLOCK_ROWS = 64
STAGES = 2
KV_TILE = 64
KV_TILE_NARROW = 32
PAD = {torch.float32: 4, torch.bfloat16: 8}


def smem_bytes(dh: int, dtype: torch.dtype) -> int:
    """Shared memory of one kernel block: the ring of K and V tiles (the k
    extent of K padded to 16 in bf16) and, for f32 at Dh = 128, the Q
    block; elsewhere Q is staged in the ring's last K buffer."""
    f32 = dtype == torch.float32
    bk = KV_TILE_NARROW if f32 and dh == 128 else KV_TILE
    dk = dh if f32 else max(dh, 16)
    ks, vs = dk + PAD[dtype], dh + PAD[dtype]
    q_rows = BLOCK_ROWS if f32 and dh == 128 else 0
    return (STAGES * bk * (ks + vs) + q_rows * ks) * (4 if f32 else 2)


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
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("kernel inputs must start on a 16-byte boundary "
                         "(its loads are 16-byte copies)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not supported (kernel built for "
                         f"{HEAD_DIMS})")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"B*H={b * h} exceeds the grid limit {MAX_GRID_Y}")
    smem = smem_bytes(dh, q.dtype)
    if smem > SMEM_BYTES:
        raise ValueError(f"Dh={dh} needs {smem} B of shared memory (limit "
                         f"{SMEM_BYTES})")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), int(q.dtype == torch.bfloat16), b * h,
                      s, dh, 1.0 / math.sqrt(dh), int(causal),
                      torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernel library's C launcher, with its argument types set once."""
    fn = cuda_build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
