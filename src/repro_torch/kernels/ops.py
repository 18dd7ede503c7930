"""Public wrappers around the Hopper kernels.

Handles the boundary pad (none at 'periodic': both kernels read the
periodic halo of the unpadded state through wrapped indices), padding to
block multiples, the scenario operands and batch axes.  Leading axes
beyond ``spec.ndim`` are folded into ONE kernel batch dimension (the
kernels' second grid dimension): the whole batch rides one launch and one
tap table, and every state is computed by exactly the code a single state
runs, so batched output is bit-exact against per-state output.

A CPU tensor goes through the kernels' plain versions; a CUDA tensor
launches the kernels (see :mod:`repro_torch.kernels.stencil_mxu`).

:func:`banded_mix` is the LM stack's causal banded mixer over
``(..., T, D)`` (kernel in :mod:`repro_torch.kernels.banded_mixer`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import coefficient_lines as cl
from repro_torch.core import halo
from repro_torch.core.matrixization import center_slice
from repro_torch.core.stencil_spec import StencilSpec, from_gather_coeffs
from repro_torch.kernels import banded_mixer, stencil_mxu
from repro_torch.runtime import trace

__all__ = ["stencil_matrixized", "stencil_sweep_matrixized",
           "cuda_backend_core", "cuda_sweep_core", "stencil_apply_vjp",
           "banded_mix"]


def cuda_backend_core(plan, boundary: str = "valid"):
    """Step-kernel core for the engine/planner backend registry.

    ``plan`` is a :class:`repro_torch.core.engine.StencilPlan`.  At
    ``boundary="valid"`` the returned callable is the registry contract
    (shrinks each spatial axis by ``2 * spec.order``); at
    ``boundary="periodic"`` it keeps the shape, and the kernel reads the
    periodic halo of the unpadded state itself.  The core keeps its
    scenario operands, built on the device once per input shape, for every
    later call.
    """
    return functools.partial(stencil_matrixized, spec=plan.spec,
                             cover=plan.cover, block=plan.block,
                             boundary=boundary, aux_cache={}, plan_cache={})


def cuda_sweep_core(plan, steps: int, *, scratch: str = "pingpong",
                    boundary: str = "valid"):
    """T-step core (the registry's ``sweep_builder`` contract).

    Advances ``steps`` applications of ``plan.spec`` per call via the
    sweep kernel.  At ``boundary="valid"`` it shrinks each spatial axis by
    ``2 * steps * spec.order``, exactly like the ``steps``-fused
    operator's core, so the halo layer drives either; at
    ``boundary="periodic"`` it keeps the shape, and the kernel reads the
    periodic halo of the unpadded state itself.  ``scratch`` picks the
    shared-memory policy.

    For varying/masked specs the TRUE boundary is forwarded as
    ``aux_boundary`` — the coefficient field must be extended into the
    halo ring the same way the state was.  As the step core does, it
    builds those operands once per input shape and keeps them.
    """
    return functools.partial(stencil_sweep_matrixized, spec=plan.spec,
                             steps=steps, cover=plan.cover, block=plan.block,
                             boundary=boundary, scratch=scratch,
                             aux_boundary=plan.boundary,
                             aux_cache={}, plan_cache={})


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
                         device, tiled: bool = True
                         ) -> tuple[torch.Tensor, ...]:
    """OUTPUT-aligned aux operands for the step kernel.

    Field then mask, each center-sliced to the valid output extent and
    zero-padded on the trailing edge to tile multiples (the padded rows are
    cropped with the output) — unless ``tiled`` is False, for a wrap-mode
    launch, whose kernel masks the ragged tiles.
    """
    if spec.is_constant_dense:
        return ()
    tile = [(0, (-s) % b if tiled else 0)
            for s, b in zip(out_sizes, block)]
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


def _run_batched(x, spec, w, block, out_sizes, call, pad: bool = True):
    """Fold the leading axes into the kernel batch, pad to tiles (unless
    the kernel masks ragged tiles itself: ``pad=False``), run, crop and
    restore the leading axes."""
    nd = spec.ndim

    def tiled(xs):
        return _pad_to_multiple(xs, block, w, nd) if pad else xs.contiguous()

    lead = tuple(x.shape[: x.ndim - nd])
    if not lead:
        out = call(tiled(x), None)
        return out[tuple(slice(0, s) for s in out_sizes)]
    batch = int(np.prod(lead))
    if batch == 0:
        return torch.zeros(lead + out_sizes, dtype=x.dtype, device=x.device)
    xb = tiled(x.reshape((batch,) + tuple(x.shape[len(lead):])))
    out = _fold_call(xb, batch, _feasible_fold(batch), call)
    out = out[(slice(None),) + tuple(slice(0, s) for s in out_sizes)]
    return out.reshape(lead + out_sizes)


def stencil_matrixized(x: torch.Tensor, *, spec: StencilSpec,
                       cover: cl.LineCover | None = None,
                       block: tuple[int, ...] | None = None,
                       option: str = "parallel",
                       boundary: str = "valid",
                       aux_cache: dict | None = None,
                       plan_cache: dict | None = None) -> torch.Tensor:
    """Stencil via the step kernel. Batch axes lead.

    'valid' (default) shrinks the spatial extent by ``spec.order`` per
    side; 'zero' pads first through the shared halo layer and preserves
    shape; 'periodic' preserves shape and pads nothing: the kernel takes
    the unpadded state, reads its halo through wrapped indices and masks
    the ragged tiles.  ``aux_cache``, when given, keeps the scenario
    operands built for one input shape for the next call with it;
    ``plan_cache`` keeps the kernel plan (and so its tap table) of each
    tile, batch and input contract.
    """
    nd, r = spec.ndim, spec.order
    wrap = halo.check_boundary(boundary) == "periodic"
    if not wrap:
        x = halo.pad_halo(x, r, nd, boundary)
    out_sizes = tuple(int(x.shape[x.ndim - nd + a]) - (0 if wrap else 2 * r)
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
    aux = _cached(aux_cache, (out_sizes, block, wrap, x.device),
                  lambda: _scenario_aux_single(spec, out_sizes, block,
                                               x.device, tiled=not wrap))

    def call(xc, b):
        plan = _cached(plan_cache, (block, b, wrap),
                       lambda: stencil_mxu.build_kernel_plan(
                           spec, cover, block, batch=b, wrap=wrap))
        return stencil_mxu.stencil_cuda_call(xc, plan, aux=aux)

    return _run_batched(x, spec, r, block, out_sizes, call, pad=not wrap)


def stencil_sweep_matrixized(x: torch.Tensor, *, spec: StencilSpec,
                             steps: int,
                             cover: cl.LineCover | None = None,
                             block: tuple[int, ...] | None = None,
                             option: str = "parallel",
                             boundary: str = "valid",
                             scratch: str = "pingpong",
                             aux_boundary: str | None = None,
                             aux_cache: dict | None = None,
                             plan_cache: dict | None = None
                             ) -> torch.Tensor:
    """``steps`` stencil applications in ONE in-kernel temporally-blocked
    pass (paper §6 x §4.3).  Batch axes lead (folded into the kernel batch
    — one launch, one tap table).

    Boundary semantics mirror a ``steps``-fused operator: 'valid' shrinks
    the spatial extent by ``steps * spec.order`` per side; 'zero' pads the
    deep halo once and preserves shape (the zero-EXTENDED evolution — the
    engine splices per-step-exact strips on top); 'periodic' preserves
    shape and pads nothing: the kernel takes the unpadded state, reads its
    halo through wrapped indices and masks the ragged tiles.  ``scratch``
    picks the shared-memory policy.

    Varying/masked specs re-read their fields at every in-kernel step; the
    field is extended to the deep-halo slab with ``aux_boundary`` (defaults
    to ``boundary``).  The zero-extended multi-step evolution is NOT
    per-step exact for scenario specs, so 'zero' at ``steps > 1`` is
    rejected.  ``aux_cache`` and ``plan_cache`` as in
    :func:`stencil_matrixized`.
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
    wrap = halo.check_boundary(boundary) == "periodic"
    if not wrap:
        x = halo.pad_halo(x, w, nd, boundary)
    out_sizes = tuple(int(x.shape[x.ndim - nd + a]) - (0 if wrap else 2 * w)
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
        plan = _cached(plan_cache, (block, b, wrap),
                       lambda: stencil_mxu.build_sweep_kernel_plan(
                           spec, cover, block, steps, batch=b,
                           scratch=scratch, wrap=wrap))
        return stencil_mxu.sweep_cuda_call(xc, plan, aux=aux)

    return _run_batched(x, spec, w, block, out_sizes, call, pad=not wrap)


# ---------------------------------------------------------------------------
# Differentiable stencil (learnable coefficients, adjoint tests)
# ---------------------------------------------------------------------------

class _StencilApply(torch.autograd.Function):
    """Valid stencil with gradients for the input and the coefficients.

    The forward and the input gradient both run the step kernel: the
    adjoint of a valid correlation is the zero-padded correlation with the
    scatter coefficients (gather/scatter duality, Eq. 5).  The coefficient
    gradient is one reduction a tap, ``dC[o] = sum_p g[p] * x[p + o]``.
    """

    @staticmethod
    def forward(ctx, x, coeffs):
        # the kernel plan needs concrete taps: read them to the host once
        spec = from_gather_coeffs(coeffs.detach().cpu().numpy())
        ctx.spec = spec
        ctx.save_for_backward(x, coeffs)
        return stencil_matrixized(x, spec=spec)

    @staticmethod
    def backward(ctx, g):
        x, coeffs = ctx.saved_tensors
        spec = ctx.spec
        r, nd = spec.order, spec.ndim
        lead = x.ndim - nd
        dx = dc = None
        if ctx.needs_input_grad[0]:
            adjoint = from_gather_coeffs(np.asarray(spec.scatter_coeffs))
            gp = halo.pad_trailing(g, [(2 * r, 2 * r)] * nd, "zero")
            dx = stencil_matrixized(gp, spec=adjoint).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gf = g.to(torch.float32)
            out = g.shape[lead:]
            grads = [
                (gf * x[(Ellipsis,) + tuple(slice(o, o + n) for o, n in
                                            zip(off, out))]
                 .to(torch.float32)).sum()
                for off in np.ndindex(*coeffs.shape)]
            dc = torch.stack(grads).reshape(coeffs.shape).to(coeffs.dtype)
        return dx, dc


def stencil_apply_vjp(x: torch.Tensor, gather_coeffs: torch.Tensor
                      ) -> torch.Tensor:
    """Valid stencil of ``x`` (batch axes lead) with the odd-cubic gather
    coefficients ``gather_coeffs``, differentiable in both.

    Forward: :func:`stencil_matrixized` (the step kernel on a CUDA tensor).
    Backward: ``dx`` is the adjoint stencil — the scatter coefficients
    (``from_gather_coeffs(spec.scatter_coeffs)``) over ``g`` zero-padded
    by ``2r`` — through the same kernel; ``dC`` a reduction a tap.  A CPU
    tensor runs the step kernel's plain version on both sides.
    """
    return _StencilApply.apply(x, gather_coeffs)


# ---------------------------------------------------------------------------
# Causal banded mixer (LM integration)
# ---------------------------------------------------------------------------

def _mix(x: torch.Tensor, band: torch.Tensor, block_t: int, block_d: int,
         backward: bool = False) -> torch.Tensor:
    """The banded mixer over ``(..., T, D)``: leading axes folded into the
    kernel's batch, ``MAX_BATCH`` sequences a launch."""
    if x.ndim < 2:
        raise ValueError(f"x must be (..., T, D), got {tuple(x.shape)}")
    t_len, d = x.shape[-2], x.shape[-1]
    xb = x.reshape((-1, t_len, d)).contiguous()
    bt = min(block_t, max(t_len, 1))
    chunk = banded_mixer.MAX_BATCH
    outs = [banded_mixer.banded_mixer_cuda_call(
        xb[i:i + chunk], band, bt, block_d, backward=backward)
        for i in range(0, max(xb.shape[0], 1), chunk)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.reshape(x.shape)


def _band_grad(x: torch.Tensor, g: torch.Tensor, band: torch.Tensor
               ) -> torch.Tensor:
    """``dband[s] = sum_t g[t] * x[t-s]`` in f32, summed over every axis but
    the channels (a (W, D) band) or over all axes (a (W,) band), one shift
    at a time (the (W, ..., T, D) stack of shifted inputs is never built)."""
    t_len, d = x.shape[-2], x.shape[-1]
    gf, xf = g.to(torch.float32), x.to(torch.float32)
    rows = []
    for s in range(band.shape[0]):
        if s >= t_len:
            rows.append(torch.zeros(d, dtype=torch.float32, device=x.device))
            continue
        prod = gf[..., s:, :] * xf[..., :t_len - s, :]
        rows.append(prod.reshape(-1, d).sum(dim=0))
    dband = torch.stack(rows)
    return (dband.sum(dim=-1) if band.ndim == 1 else dband).to(band.dtype)


class _BandedMix(torch.autograd.Function):
    """The reference's ``custom_vjp`` of ``banded_mix``: the anti-causal
    ``dx`` is flip-mix-flip along T through the same kernel, ``dband`` a
    reduction a tap (plain torch, as the reference's einsum)."""

    @staticmethod
    def forward(ctx, x, band, block_t, block_d):
        ctx.save_for_backward(x, band)
        ctx.tile = (block_t, block_d)
        return _mix(x, band, block_t, block_d)

    @staticmethod
    def backward(ctx, g):
        x, band = ctx.saved_tensors
        dx = dband = None
        with trace.span("banded_mix_backward"):
            if ctx.needs_input_grad[0]:
                gf = torch.flip(g, dims=(-2,))
                dx = torch.flip(_mix(gf, band, *ctx.tile, backward=True),
                                dims=(-2,)).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dband = _band_grad(x, g, band)
        return dx, dband, None, None


def banded_mix(x: torch.Tensor, band: torch.Tensor,
               block_t: int = banded_mixer.BLOCK_T,
               block_d: int = banded_mixer.BLOCK_D) -> torch.Tensor:
    """Causal banded mix: ``y[t] = sum_s band[s] * x[t-s]``, zero history,
    differentiable in ``x`` and ``band``.

    ``x``: (..., T, D); ``band``: (W,) shared or (W, D) depthwise.  The
    leading axes fold into the kernel's batch (grid) dimension; the tile
    is ``min(block_t, T)`` time steps a thread and ``block_d`` channels a
    block (``banded_mixer.BLOCK_T`` x ``BLOCK_D`` by default, so a decode
    call of T = W rows launches one thread per channel group); ragged T
    and D are masked in the kernel, so nothing is padded.  A CPU tensor
    runs the plain version, a CUDA tensor launches the kernel or raises.

    The backward is the reference's ``custom_vjp``: ``dx`` is the mix of
    ``g`` flipped along T, flipped back — one more launch of the same
    kernel (counted in ``banded_mixer_cuda_call.backward_launches``) —
    and ``dband`` the f32 reduction ``sum_t g[t] * x[t-s]`` a tap.
    """
    return _BandedMix.apply(x, band, block_t, block_d)
