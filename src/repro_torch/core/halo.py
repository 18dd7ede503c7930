"""Shared halo/padding layer: one definition of boundary semantics.

Every execution path — the engine, the kernel wrappers, the reference
oracles, the time stepper — needs the same three boundary conditions:

  * ``valid``    — no padding; each application shrinks the domain by the
    stencil order per side (paper Eq. 1 semantics).
  * ``zero``     — Dirichlet-0: the field is clamped to zero outside the
    domain *at every step*.
  * ``periodic`` — wrap-around (circular correlation).

Tensors keep the reference layout: leading batch axes, then the spatial
axes.  The periodic pad is an index gather per spatial axis, so it takes
any number of leading axes and any halo width (``F.pad(mode="circular")``
wants an ``(N, C, ...)`` layout and caps the pad at the extent).

Every copy a pad makes (a gather an axis, or one zero pad) is a
``halo.pad`` span (:mod:`repro_torch.runtime.trace`) of its input's and
output's bytes, each counted once, timed on the card.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.runtime import trace

__all__ = ["BOUNDARIES", "pad_mode", "pad_halo", "pad_trailing",
           "wrap_boundary", "halo_width", "check_boundary"]

BOUNDARIES = ("valid", "zero", "periodic")

_PAD_MODE = {"zero": "constant", "periodic": "wrap"}

#: the span of each copy a pad makes
PAD_SPAN = "halo.pad"


def check_boundary(boundary: str) -> str:
    if boundary not in BOUNDARIES:
        raise ValueError(f"boundary {boundary!r} not in {BOUNDARIES}")
    return boundary


def halo_width(order: int, steps: int = 1) -> int:
    """Halo each side needed to advance ``steps`` applications of a stencil
    of radius ``order`` — the fused operator's radius."""
    return order * steps


def pad_mode(boundary: str) -> str | None:
    """Pad mode implementing ``boundary`` ("constant" | "wrap"; None for
    'valid')."""
    check_boundary(boundary)
    return _PAD_MODE.get(boundary)


def _wrap_pad(x: torch.Tensor, pads) -> torch.Tensor:
    """Periodic pad of the trailing ``len(pads)`` axes by ``(before,
    after)`` each — index slices modulo the extent, any width."""
    lead = x.ndim - len(pads)
    for i, (lo, hi) in enumerate(pads):
        if lo == 0 and hi == 0:
            continue
        axis = lead + i
        n = x.shape[axis]
        idx = torch.arange(-lo, n + hi, device=x.device) % n
        with trace.span(PAD_SPAN, _copy_bytes, x.device, x, pads, i):
            x = x.index_select(axis, idx)
    return x


def _copy_bytes(x: torch.Tensor, pads, axis: int | None = None) -> int:
    """Bytes a pad of ``x``'s trailing axes by ``pads`` reads and writes
    (only axis ``axis`` of them, where given): its input and its output,
    each once."""
    lead = x.ndim - len(pads)
    shape = list(x.shape)
    for i, (lo, hi) in enumerate(pads):
        if axis is None or i == axis:
            shape[lead + i] += lo + hi
    return (x.numel() + math.prod(shape)) * x.element_size()


def pad_trailing(x: torch.Tensor, pads, boundary: str) -> torch.Tensor:
    """Pad the trailing ``len(pads)`` axes by ``(before, after)`` each:
    wrap-around for 'periodic', zeros for 'zero' and 'valid'."""
    if not any(lo or hi for lo, hi in pads):
        return x
    if pad_mode(boundary) == "wrap":
        return _wrap_pad(x, pads)
    # F.pad lists (before, after) pairs from the LAST axis backwards
    with trace.span(PAD_SPAN, _copy_bytes, x.device, x, pads):
        return F.pad(x, [p for pair in reversed(pads) for p in pair])


def pad_halo(x: torch.Tensor, r: int, ndim: int,
             boundary: str) -> torch.Tensor:
    """Pad the trailing ``ndim`` spatial axes by ``r`` per side.

    Leading axes are batch axes and are never padded.  'valid' returns the
    input unchanged.
    """
    if pad_mode(boundary) is None:
        return x
    return pad_trailing(x, [(r, r)] * ndim, boundary)


def wrap_boundary(core: Callable[[torch.Tensor], torch.Tensor], r: int,
                  ndim: int, boundary: str
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Lift a valid-mode update into a shape-preserving boundary update."""
    if check_boundary(boundary) == "valid":
        return core

    def padded(x):
        return core(pad_halo(x, r, ndim, boundary))

    return padded
