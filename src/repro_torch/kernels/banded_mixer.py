"""Hopper kernel: causal banded sequence mixer, with its plain version.

The LM-stack instantiation of stencil matrixization: a 1-D causal
constant-band stencil over a (T, D) slab per sequence,

    y[t, :] = sum_{s<W} band[s] * x[t-s, :]     (zero history),

with the band shared by all channels, ``(W,)``, or per channel,
``(W, D)``.  :func:`banded_mixer_cuda_call` launches
``csrc/banded_mixer.cu`` (built for ``sm_90a`` by :mod:`cuda_build`),
which replaces the JAX package's Pallas TPU kernel
``repro.kernels.banded_mixer.banded_mixer_pallas_call``: one CUDA block per
(time tile, channel tile, sequence), the slab with its W - 1 history rows
in shared memory, f32 accumulation, ragged T and D masked in the kernel.

Routing: a CPU tensor runs :func:`banded_mixer_plain`; a CUDA tensor
launches the kernel or raises — there is no fallback.  The wrapper counts
its launches in ``banded_mixer_cuda_call.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.matrixization import SMEM_BYTES
from repro_torch.kernels import cuda_build
from repro_torch.kernels.ref import banded_mixer_ref

__all__ = ["banded_mixer_cuda_call", "banded_mixer_plain", "smem_bytes",
           "MAX_BATCH"]

#: The batch rides the kernel's third grid dimension (at most 65535).
MAX_BATCH = 65535


def smem_bytes(w: int, block_t: int, block_d: int) -> int:
    """Shared memory of one block: the f32 slab and the band's taps."""
    return 4 * ((block_t + w - 1) * block_d + w * block_d)


def _check(x: torch.Tensor, band: torch.Tensor) -> None:
    if x.ndim != 3:
        raise ValueError(f"kernel expects x of shape (B, T, D), got "
                         f"{tuple(x.shape)}")
    if band.ndim not in (1, 2) or band.shape[0] < 1 or (
            band.ndim == 2 and band.shape[1] != x.shape[2]):
        raise ValueError(f"band must be (W,) or (W, D={x.shape[2]}), got "
                         f"{tuple(band.shape)}")


def banded_mixer_plain(x: torch.Tensor, band: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`banded_mixer_cuda_call`: the
    shifted adds of the oracle in f32, in the kernel's order (s = 0 first),
    cast to ``x.dtype``."""
    _check(x, band)
    return banded_mixer_ref(x.to(torch.float32),
                            band.to(torch.float32)).to(x.dtype)


def banded_mixer_cuda_call(x: torch.Tensor, band: torch.Tensor,
                           block_t: int = 128,
                           block_d: int = 128) -> torch.Tensor:
    """Causal banded mix of each (T, D) sequence of ``x`` (B, T, D).

    ``band``: (W,) shared or (W, D) depthwise, read as f32.  Returns
    (B, T, D) in ``x.dtype``.  T and D need not be multiples of the tile
    (``block_t`` x ``block_d``); the kernel masks the ragged edges.

    A CPU tensor runs :func:`banded_mixer_plain`; a CUDA tensor launches
    ``csrc/banded_mixer.cu`` or raises.
    """
    _check(x, band)
    if x.device.type == "cpu":
        return banded_mixer_plain(x, band)
    if x.device.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU (plain version) or CUDA "
                         f"tensors, got device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    batch, t_len, d = x.shape
    if batch > MAX_BATCH:
        raise ValueError(f"batch {batch} exceeds the grid limit {MAX_BATCH}")
    if block_t < 1 or block_d < 1:
        raise ValueError(f"tile ({block_t}, {block_d}) must be positive")
    w = band.shape[0]
    smem = smem_bytes(w, block_t, block_d)
    if smem > SMEM_BYTES:
        raise ValueError(f"tile ({block_t}, {block_d}) at W={w} needs {smem} B "
                         f"of shared memory (limit {SMEM_BYTES})")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    taps = band.to(device=x.device, dtype=torch.float32).contiguous()
    fn = cuda_build.load("banded_mixer").banded_mixer_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), out.data_ptr(), taps.data_ptr(),
             int(band.ndim == 2), w, int(x.dtype == torch.bfloat16), batch,
             t_len, d, block_t, block_d,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"banded_mixer kernel launch failed with CUDA "
                           f"error {err}")
    banded_mixer_cuda_call.launches += 1
    return out


banded_mixer_cuda_call.launches = 0
