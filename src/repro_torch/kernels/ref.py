"""Gather-mode stencil oracles (independent of the matrixized path).

These are the reference semantics every kernel and every matrixized
evaluation of the port is checked against: the textbook Eq. 1 gather
loop, written as shifted-slab accumulation over whole tensors.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import halo
from repro_torch.core.matrixization import center_slice
from repro_torch.core.stencil_spec import StencilSpec

__all__ = ["stencil_ref", "stencil_ref_conv", "scenario_scale"]


def scenario_scale(acc: torch.Tensor, spec: StencilSpec, ndim: int,
                   accum_dtype=torch.float32) -> torch.Tensor:
    """Apply a spec's scenario fields to a valid-mode f32 accumulator.

    ``y = M * (a * acc)`` with the coefficient field ``a`` and domain mask
    ``M`` CENTER-sliced to the accumulator's spatial extent (offset
    ``(field_extent - out_extent) // 2`` per axis).  No-op for constant
    unmasked specs.
    """
    out_spatial = acc.shape[acc.ndim - ndim:]
    for field, on in ((spec.coeff_field, spec.is_varying),
                      (spec.domain_mask, spec.is_masked)):
        if on:
            acc = acc * torch.as_tensor(
                center_slice(np.asarray(field, np.float32), out_spatial),
                dtype=accum_dtype, device=acc.device)
    return acc


def stencil_ref(x: torch.Tensor, spec: StencilSpec,
                accum_dtype=torch.float32,
                boundary: str = "valid") -> torch.Tensor:
    """Gather stencil oracle: ``B[p] = sum_o Cg[o] * A[p + o]``.

    Leading axes beyond ``spec.ndim`` are batch axes.  ``boundary`` follows
    the shared halo layer: 'valid' shrinks by ``spec.order`` per side;
    'zero'/'periodic' are shape-preserving.  Varying-coefficient and masked
    specs scale the accumulated sum per point (``y = M * (a * sum)``, f32,
    before the output cast).
    """
    ndim, r = spec.ndim, spec.order
    x = halo.pad_halo(x, r, ndim, boundary)
    lead_n = x.ndim - ndim
    cg = np.asarray(spec.gather_coeffs)
    xf = x.to(accum_dtype)
    out = None
    for off in np.ndindex(*cg.shape):
        c = cg[off]
        if c == 0.0:
            continue
        index = [slice(None)] * x.ndim
        for a_sp, o in enumerate(off):
            a = a_sp + lead_n
            index[a] = slice(o, o + x.shape[a] - 2 * r)
        term = float(np.float32(c)) * xf[tuple(index)]
        out = term if out is None else out + term
    out = scenario_scale(out, spec, ndim, accum_dtype)
    return out.to(x.dtype)


def stencil_ref_conv(x: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """Same semantics (valid mode) via ``F.conv2d`` / ``F.conv3d``.

    A second independent oracle and the library yardstick: PyTorch's
    convolution computes a cross-correlation, which is the gather form
    with the taps as given.  2-D / 3-D, one channel, batch axes leading.
    On a card it goes through cuDNN, which defaults to TF32 for float32 —
    callers that compare at 1e-4 set ``torch.backends.cudnn.allow_tf32 =
    False`` first.
    """
    ndim = spec.ndim
    lead = x.shape[: x.ndim - ndim]
    spatial = x.shape[x.ndim - ndim:]
    xb = x.reshape((-1, 1) + tuple(spatial))
    k = torch.as_tensor(spec.gather_coeffs, dtype=x.dtype,
                        device=x.device).reshape(
        (1, 1) + spec.gather_coeffs.shape)
    conv = F.conv2d if ndim == 2 else F.conv3d
    out = conv(xb, k)
    return out.reshape(tuple(lead) + tuple(out.shape[2:])).to(x.dtype)
