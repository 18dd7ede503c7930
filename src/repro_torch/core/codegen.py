"""Automatic code generator (paper §4.4).

The paper's generator takes (stencil type, coefficient-line option, unroll
factors) and emits fully unrolled SME assembly-level C, keeping only the
j-plane and i-row loops.  Ours takes a :class:`StencilPlan` and emits Python
source in which every line/offset loop is unrolled into straight-line
Toeplitz-product statements over torch tensors — the loops that survive
in the generated text are exactly the ones PyTorch dispatches.  The source
is ``exec``'d and returned alongside the callable, so tests can both
inspect and run it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

import torch

from repro_torch.core import matrixization as mx
from repro_torch.core.engine import StencilPlan

__all__ = ["GeneratedUpdate", "generate_update"]


@dataclasses.dataclass(frozen=True)
class GeneratedUpdate:
    source: str
    fn: Callable
    bands: dict[str, np.ndarray]


def generate_update(plan: StencilPlan) -> GeneratedUpdate:
    spec = plan.spec
    r, nd = spec.order, spec.ndim
    lines_src: list[str] = []
    bands: dict[str, np.ndarray] = {}
    lines_src.append("def stencil_update(x):")
    lines_src.append(f"    # generated: {spec.describe()}, cover={plan.cover.name}")
    lines_src.append("    lead = x.ndim - ND")
    lines_src.append("    out = None")
    for li, line in enumerate(plan.cover.lines):
        if line.is_diagonal:
            # unrolled per-tap shifted adds (Eq. 16 path)
            e = spec.extent
            for o, c in enumerate(np.asarray(line.coeffs)):
                if c == 0.0:
                    continue
                offs = {a: (o if d > 0 else e - 1 - o) for a, d in line.axis}
                for a, v in line.fixed:
                    offs[a] = v
                gather = [(e - 1) - offs[a] for a in range(nd)]
                sl = ", ".join(
                    f"slice(g{li}_{o}_{a}, g{li}_{o}_{a} + x.shape[lead + {a}] - {2*r})"
                    for a in range(nd))
                for a, g in enumerate(gather):
                    lines_src.append(f"    g{li}_{o}_{a} = {g}")
                lines_src.append(
                    f"    term = {float(np.float32(c))!r} * x[(slice(None),) * lead + ({sl},)].to(torch.float32)")
                lines_src.append("    out = term if out is None else out + term")
            continue
        band, fixed = mx.line_to_gather_band(line, spec)
        key = f"band_{li}"
        bands[key] = np.asarray(band)
        ax = line.axis
        idx_parts = []
        for a in range(nd):
            if a == ax:
                idx_parts.append("slice(None)")
            else:
                off = fixed.get(a, 0)
                idx_parts.append(f"slice({off}, {off} + x.shape[lead + {a}] - {2*r})")
        lines_src.append(f"    # line {li}: {line.describe()} along axis {ax}")
        lines_src.append(
            f"    slab = x[(slice(None),) * lead + ({', '.join(idx_parts)},)]")
        lines_src.append(
            f"    t = mx.toeplitz_band({key}, x.shape[lead + {ax}] - {2*r}, "
            f"dtype=torch.float32, device=x.device)")
        lines_src.append(
            f"    term = torch.movedim(torch.tensordot(t, slab.to(torch.float32), "
            f"dims=([1], [lead + {ax}])), 0, lead + {ax})")
        lines_src.append("    out = term if out is None else out + term")
    lines_src.append("    return out.to(x.dtype)")
    source = "\n".join(lines_src)
    namespace = {"torch": torch, "mx": mx, "ND": nd, **bands}
    exec(compile(source, f"<stencil-codegen:{spec.describe()}>", "exec"), namespace)
    return GeneratedUpdate(source=source, fn=namespace["stencil_update"], bands=bands)
