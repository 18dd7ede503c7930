"""Hopper kernel: causal banded sequence mixer, with its plain version.

The LM-stack instantiation of stencil matrixization: a 1-D causal
constant-band stencil over a (T, D) slab per sequence,

    y[t, :] = sum_{s<W} band[s] * x[t-s, :]     (zero history),

with the band shared by all channels, ``(W,)``, or per channel,
``(W, D)``.  :func:`banded_mixer_cuda_call` launches
``csrc/banded_mixer.cu`` (built for ``sm_90a`` by :mod:`cuda_build`),
which replaces the JAX package's Pallas TPU kernel
``repro.kernels.banded_mixer.banded_mixer_pallas_call``.  It streams: one
thread owns 16 bytes of consecutive channels (:func:`group` of them) of
one sequence and walks a run of ``block_t`` time steps with the band and
the W - 1 previous rows in registers, loading and storing 16 bytes at a
time where D allows; a block holds ``block_d`` channels.  No shared
memory, f32 accumulation, ragged T and D masked in the kernel.

Routing: a CPU tensor runs :func:`banded_mixer_plain`; a CUDA tensor
launches the kernel or raises — there is no fallback.  The wrapper counts
its launches in ``banded_mixer_cuda_call.launches``, and those made for a
gradient (``backward=True``: ``ops.banded_mix``'s ``dx``) also in
``banded_mixer_cuda_call.backward_launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.ref import banded_mixer_ref

__all__ = ["banded_mixer_cuda_call", "banded_mixer_plain", "smem_bytes",
           "group", "MAX_BATCH", "MAX_THREADS", "MAX_REGISTER_W",
           "BLOCK_T", "BLOCK_D"]

#: The batch rides the kernel's second grid dimension (at most 65535).
MAX_BATCH = 65535
#: Threads a block at most (the kernel's launch bound): ``block_d`` is at
#: most this many channel groups.
MAX_THREADS = 256
#: Band widths up to this keep the band and the history in registers; a
#: wider band reads its window from device memory.
MAX_REGISTER_W = 8
#: The default tile: time steps a thread walks, channels a block holds.
#: The run re-reads W - 1 rows of history, so longer runs read less twice;
#: 8 rows x 512 channels keeps every SM busy at the prefill's shape and a
#: decode call (T = W rows) to one thread per channel group.
BLOCK_T = 8
BLOCK_D = 512


def group(dtype: torch.dtype) -> int:
    """Channels a thread owns: 16 bytes of ``dtype`` (4 f32, 8 bf16)."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def smem_bytes(w: int, block_t: int, block_d: int) -> int:
    """Shared memory of one block: none — the band and the history live in
    registers, and no block stages a slab."""
    return 0


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


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernel library's C launcher, with its argument types set once."""
    fn = cuda_build.load("banded_mixer").banded_mixer_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def banded_mixer_cuda_call(x: torch.Tensor, band: torch.Tensor,
                           block_t: int = BLOCK_T, block_d: int = BLOCK_D,
                           *, backward: bool = False) -> torch.Tensor:
    """Causal banded mix of each (T, D) sequence of ``x`` (B, T, D).

    ``band``: (W,) shared or (W, D) depthwise, read as f32.  Returns
    (B, T, D) in ``x.dtype``.  The tile: ``block_t`` time steps a thread,
    ``block_d`` channels a block (a multiple of :func:`group`, at most
    ``MAX_THREADS`` groups).  T and D need not be multiples of the tile;
    the kernel masks the ragged edges.

    A CPU tensor runs :func:`banded_mixer_plain`; a CUDA tensor launches
    ``csrc/banded_mixer.cu`` or raises.  ``backward`` marks a launch made
    for a gradient: it is counted in ``backward_launches`` as well.
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
    g = group(x.dtype)
    if block_t < 1 or block_d < g or block_d % g or block_d // g > MAX_THREADS:
        raise ValueError(f"tile ({block_t}, {block_d}): block_t must be "
                         f"positive and block_d a multiple of {g} channels, "
                         f"at most {MAX_THREADS * g}")
    w = band.shape[0]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    taps = band.to(device=x.device, dtype=torch.float32).contiguous()
    err = _launcher()(x.data_ptr(), out.data_ptr(), taps.data_ptr(),
             int(band.ndim == 2), w, int(x.dtype == torch.bfloat16), batch,
             t_len, d, block_t, block_d,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"banded_mixer kernel launch failed with CUDA "
                           f"error {err}")
    banded_mixer_cuda_call.launches += 1
    if backward:
        banded_mixer_cuda_call.backward_launches += 1
    return out


banded_mixer_cuda_call.launches = 0
banded_mixer_cuda_call.backward_launches = 0
