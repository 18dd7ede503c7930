"""Public wrappers around the Hopper kernels.

Handles the boundary pad, padding to block multiples, the scenario
operands and batch axes.  Leading axes beyond ``spec.ndim`` are folded
into ONE kernel batch dimension (the kernels' second grid dimension): the
whole batch rides one launch and one tap table, and every state is
computed by exactly the code a single state runs, so batched output is
bit-exact against per-state output.

A CPU tensor goes through the kernels' plain versions; a CUDA tensor
launches the kernels (see :mod:`repro_torch.kernels.stencil_mxu`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import coefficient_lines as cl
from repro_torch.core import halo
from repro_torch.core.matrixization import center_slice
from repro_torch.core.stencil_spec import StencilSpec
from repro_torch.kernels import stencil_mxu

__all__ = ["stencil_matrixized", "stencil_sweep_matrixized",
           "cuda_backend_core", "cuda_sweep_core"]


def cuda_backend_core(plan):
    """Valid-mode core for the engine/planner backend registry.

    ``plan`` is a :class:`repro_torch.core.engine.StencilPlan`; the
    returned callable is the registry contract (shrinks each spatial axis
    by ``2 * spec.order``) backed by the step kernel.  The core keeps its
    scenario operands, built on the device once per input shape, for every
    later call.
    """
    return functools.partial(stencil_matrixized, spec=plan.spec,
                             cover=plan.cover, block=plan.block,
                             aux_cache={})


def cuda_sweep_core(plan, steps: int, *, scratch: str = "pingpong"):
    """Valid-mode T-step core (the registry's ``sweep_builder`` contract).

    Advances ``steps`` applications of ``plan.spec`` per call via the
    sweep kernel — shrinks each spatial axis by ``2 * steps * spec.order``,
    exactly like the ``steps``-fused operator's core, so the halo layer
    drives either.  ``scratch`` picks the shared-memory policy.

    The engine hands this core pre-padded tensors and drives it at
    ``boundary="valid"``, so for varying/masked specs the TRUE boundary is
    forwarded as ``aux_boundary`` — the coefficient field must be extended
    into the halo ring the same way the state was.  As the step core does,
    it builds those operands once per input shape and keeps them.
    """
    return functools.partial(stencil_sweep_matrixized, spec=plan.spec,
                             steps=steps, cover=plan.cover, block=plan.block,
                             scratch=scratch, aux_boundary=plan.boundary,
                             aux_cache={})


def _cached(cache: dict | None, key, build):
    """``build()``, kept in ``cache`` under ``key`` when there is one."""
    if cache is None:
        return build()
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _scenario_fields(spec: StencilSpec, device):
    """The spec's coefficient field, then its mask, as f32 device tensors."""
    return [torch.as_tensor(np.asarray(f, np.float32), device=device)
            for f in (spec.coeff_field, spec.domain_mask) if f is not None]


def _scenario_aux_single(spec: StencilSpec, out_sizes, block,
                         device) -> tuple[torch.Tensor, ...]:
    """OUTPUT-aligned aux operands for the step kernel.

    Field then mask, each center-sliced to the valid output extent and
    zero-padded on the trailing edge to tile multiples (the padded rows are
    cropped with the output).
    """
    if spec.is_constant_dense:
        return ()
    tile = [(0, (-s) % b) for s, b in zip(out_sizes, block)]
    return tuple(
        halo.pad_trailing(center_slice(a, out_sizes), tile, "zero")
        .contiguous() for a in _scenario_fields(spec, device))


def _scenario_aux_sweep(spec: StencilSpec, out_sizes, w: int, block,
                        aux_boundary: str,
                        device) -> tuple[torch.Tensor, ...]:
    """SLAB-aligned aux operands for the sweep kernel.

    Each field is extended centered from its grid extent to the haloed slab
    extent (``out + 2w`` per axis) with the TRUE boundary's pad — wrap for
    periodic, zeros otherwise — so every step's sub-slice sees the same
    extension the state does, then zero-padded to tile multiples.
    """
    if spec.is_constant_dense:
        return ()
    target = tuple(s + 2 * w for s in out_sizes)
    tile = [(0, (-s) % b) for s, b in zip(out_sizes, block)]
    aux = []
    for a in _scenario_fields(spec, device):
        # a valid-mode chain whose state already shrank needs the centered
        # SLICE on axes where the grid field exceeds the slab
        a = center_slice(a, tuple(min(s, t) for s, t in zip(a.shape, target)))
        pads = [((t - s) // 2, t - s - (t - s) // 2)
                for s, t in zip(a.shape, target)]
        a = halo.pad_trailing(a, pads, aux_boundary)
        aux.append(halo.pad_trailing(a, tile, "zero").contiguous())
    return tuple(aux)


def _pad_to_multiple(x: torch.Tensor, block, w: int,
                     ndim: int) -> torch.Tensor:
    """Zero-pad the ``w``-haloed trailing ``ndim`` spatial axes so the
    valid output tiles evenly (leading batch axes are never padded)."""
    extra = [(0, (-(s - 2 * w)) % b)
             for s, b in zip(x.shape[x.ndim - ndim:], block)]
    return halo.pad_trailing(x, extra, "zero").contiguous()


def _feasible_fold(batch: int) -> int:
    """Largest per-launch sub-batch: the batch rides the kernels' second
    grid dimension, so a launch takes at most ``MAX_BATCH`` states.
    Shared memory does not bound it — each CUDA block holds one state's
    tile."""
    return max(1, min(batch, stencil_mxu.MAX_BATCH))


def _fold_call(xb: torch.Tensor, batch: int, chunk: int, call):
    """Run ``call`` over ``xb`` in lead-axis chunks of ``chunk`` states."""
    if chunk >= batch:
        return call(xb, batch)
    outs = [call(xb[i:i + chunk], min(chunk, batch - i))
            for i in range(0, batch, chunk)]
    return torch.cat(outs, dim=0)


def _default_block(spec: StencilSpec, out_sizes, halo_width: int,
                   batch: int | None = None):
    """The planner's best-ranked tile for this spatial shape (deferred
    import: the planner imports the engine, which builds its cores
    through this module)."""
    from repro_torch.core.planner import best_block
    return best_block(spec, tuple(out_sizes), halo_width=halo_width,
                      batch=batch or 1)


def _run_batched(x, spec, w, block, out_sizes, call):
    """Fold the leading axes into the kernel batch, pad to tiles, run,
    crop and restore the leading axes."""
    nd = spec.ndim
    lead = tuple(x.shape[: x.ndim - nd])
    if not lead:
        xs = _pad_to_multiple(x, block, w, nd)
        out = call(xs, None)
        return out[tuple(slice(0, s) for s in out_sizes)]
    batch = int(np.prod(lead))
    if batch == 0:
        return torch.zeros(lead + out_sizes, dtype=x.dtype, device=x.device)
    xb = _pad_to_multiple(x.reshape((batch,) + tuple(x.shape[len(lead):])),
                          block, w, nd)
    out = _fold_call(xb, batch, _feasible_fold(batch), call)
    out = out[(slice(None),) + tuple(slice(0, s) for s in out_sizes)]
    return out.reshape(lead + out_sizes)


def stencil_matrixized(x: torch.Tensor, *, spec: StencilSpec,
                       cover: cl.LineCover | None = None,
                       block: tuple[int, ...] | None = None,
                       option: str = "parallel",
                       boundary: str = "valid",
                       aux_cache: dict | None = None) -> torch.Tensor:
    """Stencil via the step kernel. Batch axes lead.

    ``boundary`` uses the shared halo layer: 'valid' (default) shrinks the
    spatial extent by ``spec.order`` per side; 'zero'/'periodic' pad first
    and preserve shape.  ``aux_cache``, when given, keeps the scenario
    operands built for one input shape for the next call with it.
    """
    x = halo.pad_halo(x, spec.order, spec.ndim, boundary)
    nd, r = spec.ndim, spec.order
    out_sizes = tuple(int(x.shape[x.ndim - nd + a]) - 2 * r
                      for a in range(nd))
    if any(s <= 0 for s in out_sizes):
        raise ValueError(f"input {tuple(x.shape)} too small for order {r}")
    if cover is None:
        cover = cl.make_cover(spec, option)
    lead = x.shape[: x.ndim - nd]
    batch = int(np.prod(lead)) if len(lead) else None
    if block is None:
        block = _default_block(spec, out_sizes, r, batch)
    block = tuple(min(b, s) for b, s in zip(block, out_sizes))
    aux = _cached(aux_cache, (out_sizes, block, x.device),
                  lambda: _scenario_aux_single(spec, out_sizes, block,
                                               x.device))

    def call(xc, b):
        plan = stencil_mxu.build_kernel_plan(spec, cover, block, batch=b)
        return stencil_mxu.stencil_cuda_call(xc, plan, aux=aux)

    return _run_batched(x, spec, r, block, out_sizes, call)


def stencil_sweep_matrixized(x: torch.Tensor, *, spec: StencilSpec,
                             steps: int,
                             cover: cl.LineCover | None = None,
                             block: tuple[int, ...] | None = None,
                             option: str = "parallel",
                             boundary: str = "valid",
                             scratch: str = "pingpong",
                             aux_boundary: str | None = None,
                             aux_cache: dict | None = None) -> torch.Tensor:
    """``steps`` stencil applications in ONE in-kernel temporally-blocked
    pass (paper §6 x §4.3).  Batch axes lead (folded into the kernel batch
    — one launch, one tap table).

    Boundary semantics mirror a ``steps``-fused operator: 'valid' shrinks
    the spatial extent by ``steps * spec.order`` per side; 'zero'/'periodic'
    pad the deep halo once and preserve shape ('zero' is the zero-EXTENDED
    evolution — the engine splices per-step-exact strips on top).
    ``scratch`` picks the shared-memory policy.

    Varying/masked specs re-read their fields at every in-kernel step; the
    field is extended to the deep-halo slab with ``aux_boundary`` (defaults
    to ``boundary``).  The zero-extended multi-step evolution is NOT
    per-step exact for scenario specs, so 'zero' at ``steps > 1`` is
    rejected.  ``aux_cache`` as in :func:`stencil_matrixized`.
    """
    if steps < 1:
        raise ValueError("steps >= 1")
    if aux_boundary is None:
        aux_boundary = boundary
    if steps > 1 and aux_boundary == "zero" and not spec.is_constant_dense:
        raise ValueError(
            "in-kernel sweep with steps > 1 is not exact for varying/"
            "masked specs at boundary='zero' (fall back to depth 1)")
    nd = spec.ndim
    w = steps * spec.order
    x = halo.pad_halo(x, w, nd, boundary)
    out_sizes = tuple(int(x.shape[x.ndim - nd + a]) - 2 * w
                      for a in range(nd))
    if any(s <= 0 for s in out_sizes):
        raise ValueError(f"input {tuple(x.shape)} too small for {steps} "
                         f"in-kernel steps of order {spec.order}")
    if cover is None:
        cover = cl.make_cover(spec, option)
    lead = x.shape[: x.ndim - nd]
    batch = int(np.prod(lead)) if len(lead) else None
    if block is None:
        block = _default_block(spec, out_sizes, w, batch)
    block = tuple(min(b, s) for b, s in zip(block, out_sizes))
    aux = _cached(aux_cache, (out_sizes, block, w, aux_boundary, x.device),
                  lambda: _scenario_aux_sweep(spec, out_sizes, w, block,
                                              aux_boundary, x.device))

    def call(xc, b):
        plan = stencil_mxu.build_sweep_kernel_plan(
            spec, cover, block, steps, batch=b, scratch=scratch)
        return stencil_mxu.sweep_cuda_call(xc, plan, aux=aux)

    return _run_batched(x, spec, w, block, out_sizes, call)
