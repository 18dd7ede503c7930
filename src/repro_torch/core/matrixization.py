"""Stencil matrixization: outer-product sums as banded-Toeplitz products.

Paper Eq. 12 expresses one coefficient line's contribution to an n-row
output block as ``2r+n`` vector outer products.  Their accumulated sum is
a product with a banded Toeplitz operator:

    sum_i  (slice_i of C° column) ⊗ A[i, :]   ==   T @ A_slab

where ``T`` is the ``n x (n+2r)`` banded Toeplitz operator carrying the
line's taps on its diagonals and ``A_slab`` the haloed input window.  This
module builds those operators and evaluates stencils with them (the
port's ``"torch"`` and ``"separable"`` backends, whose full-grid products
are plain ``torch.tensordot`` calls), and holds the cost and residency
models the planner prices Hopper candidates with.

Gather/scatter bookkeeping: a scatter line (slice of Cs) along axis ``a``
with fixed scatter offsets ``f_d`` equals the gather band
``line.coeffs[::-1]`` applied at gather offsets ``(E-1) - f_d`` on the other
axes (Cs = Cg reversed on every axis, Eq. 5).

The Hopper kernels (:mod:`repro_torch.kernels.stencil_mxu`) apply the same
bands with their zero entries skipped, which is the Toeplitz product's
arithmetic without its structural zeros: :func:`tap_flops` prices that,
and :func:`step_smem_bytes` / :func:`sweep_smem_bytes` price what those
kernels keep in a block's shared memory.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.coefficient_lines import CoefficientLine, LineCover
from repro_torch.core.stencil_spec import StencilSpec

__all__ = [
    "toeplitz_band",
    "toeplitz_band_np",
    "line_to_gather_band",
    "matrixized_apply",
    "scenario_scale",
    "aux_hbm_bytes",
    "n_aux_operands",
    "active_block_fraction",
    "separable_factors",
    "separable_apply",
    "matmul_count",
    "toeplitz_flops",
    "separable_flops",
    "tap_flops",
    "inkernel_flops",
    "inkernel_hbm_bytes",
    "block_hbm_bytes",
    "step_smem_bytes",
    "sweep_smem_bytes",
    "sweep_feasible",
    "SMEM_BYTES",
    "TILE_SMEM_BUDGET",
    "SWEEP_THREADS",
    "SINGLE_SLOTS",
    "SCRATCH_MODES",
    "check_scratch",
]

#: Shared-memory policies of the in-kernel sweep: "pingpong" keeps two
#: slab buffers (step s reads one and writes the other); "single" keeps
#: ONE — every thread computes its outputs of a step into registers, the
#: block synchronizes, then writes them back in place — at half the
#: shared memory.  Defined here (the lowest layer that models the
#: residency) and re-exported by ``temporal``.
SCRATCH_MODES = ("pingpong", "single")


def check_scratch(scratch: str) -> str:
    if scratch not in SCRATCH_MODES:
        raise ValueError(f"unknown scratch mode {scratch!r}; choose from "
                         f"{SCRATCH_MODES}")
    return scratch


# Hopper residency constants (NVIDIA H100 data sheet and Hopper
# architecture white paper): one thread block may claim at most 227 KB of
# dynamic shared memory.  The sweep kernel runs SWEEP_THREADS threads a block and, under
# scratch="single", parks at most SINGLE_SLOTS outputs per thread in
# registers between a step's reads and its write-back.  The CUDA sources
# (kernels/csrc/stencil_sweep.cu) define the same two numbers.  The kernel
# wrappers gate on the hard launch limit SMEM_BYTES; the planner's block
# search, its fused-operator and in-kernel candidates and the fuse-depth
# chooser all gate on the one residency budget TILE_SMEM_BUDGET, so a plan
# never picks a tile the kernels cannot launch, nor one that leaves a
# single block on an SM.
SMEM_BYTES = 232448
SWEEP_THREADS = 512
SINGLE_SLOTS = 32

#: Shared memory a plan lets one block claim: an SM holds 228 KB, of which
#: each resident block reserves 1 KB, so two blocks of this size share an
#: SM and one block's loads overlap the other's arithmetic.
TILE_SMEM_BUDGET = 233472 // 2 - 1024


def step_smem_bytes(block: tuple[int, ...], halo_width: int) -> int:
    """Shared memory of one step-kernel block: the f32 haloed slab of one
    state (the batch is a grid dimension, so it does not scale this)."""
    return 4 * int(np.prod([b + 2 * halo_width for b in block]))


def sweep_smem_bytes(block: tuple[int, ...], steps: int, order: int,
                     scratch: str = "pingpong") -> int:
    """Shared memory of one sweep-kernel block: the ``steps*order``-deep
    f32 slab, twice for ``"pingpong"`` (the slab buffer is one of the
    pair), once for ``"single"``."""
    if steps < 1:
        raise ValueError("steps >= 1")
    n_bufs = 1 if check_scratch(scratch) == "single" else 2
    return n_bufs * step_smem_bytes(block, steps * order)


def sweep_feasible(block: tuple[int, ...], steps: int, order: int,
                   scratch: str = "pingpong",
                   limit: int = SMEM_BYTES) -> bool:
    """Whether the sweep kernel can run this tile: its shared memory fits
    ``limit`` (the launch limit by default; plans pass
    :data:`TILE_SMEM_BUDGET`), and under ``"single"`` the deepest
    intermediate's outputs fit the block's register slots."""
    if sweep_smem_bytes(block, steps, order, scratch) > limit:
        return False
    if scratch == "single":
        live = int(np.prod([b + 2 * (steps - 1) * order for b in block]))
        return live <= SWEEP_THREADS * SINGLE_SLOTS
    return True


def toeplitz_band_np(band: np.ndarray, n_out: int) -> np.ndarray:
    """Numpy-side banded Toeplitz operator (n_out, n_out + len(band) - 1)."""
    band = np.asarray(band)
    w = band.shape[0]
    t = np.zeros((n_out, n_out + w - 1), dtype=np.float64)
    rows = np.arange(n_out)
    for s in range(w):
        t[rows, rows + s] = band[s]
    return t


def toeplitz_band(band: np.ndarray, n_out: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Banded Toeplitz operator T of shape (n_out, n_out + len(band) - 1).

    ``T[k, k+s] = band[s]`` — contracting T against a haloed slab applies
    the 1-D gather stencil ``band`` along the contracted axis.
    """
    return torch.as_tensor(toeplitz_band_np(band, n_out), dtype=dtype,
                           device=device)


def center_slice(f: np.ndarray, out_sizes) -> np.ndarray:
    """Center a grid-resident scenario field on a smaller output extent
    (offset ``(field_extent - out_extent) // 2`` per axis) — the positional
    convention every execution path and the gather oracle share: after s
    valid steps the offset is ``s*r``."""
    idx = []
    for s, m in zip(f.shape, out_sizes):
        off = (s - m) // 2
        if off < 0:
            raise ValueError(f"scenario field extent {f.shape} smaller than "
                             f"output extent {tuple(out_sizes)}")
        idx.append(slice(off, off + m))
    return f[tuple(idx)]


def scenario_scale(acc: torch.Tensor, spec: StencilSpec,
                   accum_dtype=torch.float32) -> torch.Tensor:
    """Scale a valid-mode accumulator by a spec's scenario fields.

    ``y = M * (a * acc)`` with the coefficient field and the domain mask
    CENTER-sliced to the accumulator's spatial extent, applied after the
    banded accumulation in f32 (the ``diag(a) @ T`` factorization).  No-op
    for constant unmasked specs.
    """
    if spec.is_constant_dense:
        return acc
    out_spatial = acc.shape[acc.ndim - spec.ndim:]
    for field in (spec.coeff_field, spec.domain_mask):
        if field is not None:
            acc = acc * torch.as_tensor(
                center_slice(np.asarray(field, np.float32), out_spatial),
                dtype=accum_dtype, device=acc.device)
    return acc


def line_to_gather_band(line: CoefficientLine, spec: StencilSpec):
    """(gather band, gather fixed offsets) for an axis-parallel scatter line."""
    if line.is_diagonal:
        raise ValueError("diagonal lines use skewed evaluation, not bands")
    e = spec.extent
    band = np.asarray(line.coeffs)[::-1]
    fixed = {a: (e - 1) - v for a, v in line.fixed}
    return band, fixed


def _valid_shape(x_shape, ndim, r):
    lead = tuple(x_shape[: len(x_shape) - ndim])
    spatial = tuple(s - 2 * r for s in x_shape[len(x_shape) - ndim:])
    if any(s <= 0 for s in spatial):
        raise ValueError(f"input {tuple(x_shape)} too small for order {r}")
    return lead, spatial


def _line_contribution(x: torch.Tensor, spec: StencilSpec,
                       line: CoefficientLine, dtype) -> torch.Tensor:
    """One line's contribution to the valid-mode output, as a product."""
    r = spec.order
    lead_n = x.ndim - spec.ndim
    band, fixed = line_to_gather_band(line, spec)
    axis = line.axis + lead_n
    # Slice the slab: full halo along the line axis, pinned offset elsewhere.
    index = [slice(None)] * x.ndim
    for a_sp, off in fixed.items():
        a = a_sp + lead_n
        index[a] = slice(off, off + x.shape[a] - 2 * r)
    slab = x[tuple(index)].to(dtype)
    t = toeplitz_band(band, x.shape[axis] - 2 * r, dtype=dtype,
                      device=x.device)
    # Contract T's halo axis against the slab's line axis, then put the
    # contracted result axis back in place.
    out = torch.tensordot(t, slab, dims=([1], [axis]))
    return torch.movedim(out, 0, axis)


def _diagonal_contribution(x: torch.Tensor, spec: StencilSpec,
                           line: CoefficientLine, dtype) -> torch.Tensor:
    """Diagonal line: per-tap shifted accumulation (Eq. 16 family)."""
    ndim, r, e = spec.ndim, spec.order, spec.extent
    lead_n = x.ndim - ndim
    out = None
    for o, c in enumerate(np.asarray(line.coeffs)):
        if c == 0.0:
            continue
        index = [slice(None)] * x.ndim
        # scatter index o along each (axis, dir); convert to gather offset.
        offs = {a: (o if d > 0 else e - 1 - o) for a, d in line.axis}
        for a, v in line.fixed:
            offs[a] = v
        for a_sp in range(ndim):
            g = (e - 1) - offs[a_sp]
            a = a_sp + lead_n
            index[a] = slice(g, g + x.shape[a] - 2 * r)
        term = float(np.float32(c)) * x[tuple(index)].to(dtype)
        out = term if out is None else out + term
    return out


def matrixized_apply(x: torch.Tensor, spec: StencilSpec, cover: LineCover,
                     accum_dtype=torch.float32) -> torch.Tensor:
    """Valid-mode stencil via the cover's banded-Toeplitz products.

    Leading axes of ``x`` beyond ``spec.ndim`` are batch axes.
    """
    lead, spatial = _valid_shape(x.shape, spec.ndim, spec.order)
    out = torch.zeros(lead + spatial, dtype=accum_dtype, device=x.device)
    for line in cover.lines:
        if line.is_diagonal:
            out = out + _diagonal_contribution(x, spec, line, accum_dtype)
        else:
            out = out + _line_contribution(x, spec, line, accum_dtype)
    out = scenario_scale(out, spec, accum_dtype)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Beyond-paper: separable (SVD) factorization, 2-D
# ---------------------------------------------------------------------------

def separable_factors(spec: StencilSpec, tol: float = 1e-12):
    """SVD of the 2-D gather tap matrix: list of (sigma*u, v) band pairs."""
    if spec.ndim != 2:
        raise ValueError("separable factorization implemented for 2-D")
    u, s, vt = np.linalg.svd(spec.gather_coeffs)
    keep = s > tol * s[0] if s[0] > 0 else s > 0
    return [(u[:, p] * s[p], vt[p, :]) for p in np.nonzero(keep)[0]]


def separable_apply(x: torch.Tensor, spec: StencilSpec,
                    accum_dtype=torch.float32,
                    tol: float = 1e-12) -> torch.Tensor:
    """2-D stencil as ``sum_p T_{u_p} @ A @ T_{v_p}^T`` (rank(Cg) slab pairs)."""
    factors = separable_factors(spec, tol)
    r = spec.order
    lead_n = x.ndim - 2
    n_i = x.shape[lead_n] - 2 * r
    n_j = x.shape[lead_n + 1] - 2 * r
    xf = x.to(accum_dtype)
    out = None
    for ub, vb in factors:
        ti = toeplitz_band(ub, n_i, dtype=accum_dtype, device=x.device)
        tj = toeplitz_band(vb, n_j, dtype=accum_dtype, device=x.device)
        # (..., i+2r, j+2r) -> contract i then j
        tmp = torch.movedim(torch.tensordot(ti, xf, dims=([1], [lead_n])),
                            0, lead_n)
        tmp = torch.tensordot(tmp, tj, dims=([lead_n + 1], [1]))
        out = tmp if out is None else out + tmp
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Analysis (§3.4): operator counts, flops and bytes
# ---------------------------------------------------------------------------

def matmul_count(cover: LineCover) -> int:
    """Slab products per output block = number of multi-tap lines
    (single-tap lines degrade to scaled shifts)."""
    return sum(1 for line in cover.lines if line.nnz > 1)


def toeplitz_flops(cover: LineCover, block: tuple[int, ...]) -> int:
    """Flops to produce one output block as dense banded-Toeplitz products.

    Each multi-tap line contracts an (n, n+2r) Toeplitz against the slab:
    2 * n * (n+2r) * prod(other block dims) flops (the structural zeros
    included — what a dense product executes).  Single-tap and diagonal
    lines are scaled shifts, counted as 2 * prod(block) per tap.
    """
    r = cover.spec.order
    total = 0
    for line in cover.lines:
        if line.is_diagonal or line.nnz <= 1:
            total += 2 * int(np.prod(block)) * max(line.nnz, 1)
            continue
        ax = line.axis
        n = block[ax]
        rest = int(np.prod([b for a, b in enumerate(block) if a != ax]))
        total += 2 * n * (n + 2 * r) * rest
    return total


def separable_flops(spec: StencilSpec, block: tuple[int, ...]) -> int:
    """Flops of the SVD-separable path on one 2-D output block: two slab
    products per rank-1 factor (see :func:`separable_apply`)."""
    r = spec.order
    n_i, n_j = block[-2], block[-1]
    rank = len(separable_factors(spec))
    per_factor = (2 * n_i * (n_i + 2 * r) * (n_j + 2 * r)
                  + 2 * n_i * (n_j + 2 * r) * n_j)
    return rank * per_factor


def tap_flops(spec: StencilSpec, block: tuple[int, ...]) -> int:
    """Flops the Hopper kernels execute for one output block: one f32
    multiply-add per non-zero tap per output point.  Every cover claims
    each non-zero tap exactly once and the kernels skip the bands' zeros,
    so this is independent of the cover."""
    return 2 * spec.taps * int(np.prod(block))


def inkernel_flops(step_flops: Callable[[tuple[int, ...]], float],
                   block: tuple[int, ...], steps: int, order: int) -> float:
    """Flops of ``steps`` in-kernel base steps producing one output block:
    step ``s`` computes the live extent ``block + 2*(steps-1-s)*order`` (the
    halo shrinks by ``order`` per side per step), priced by ``step_flops``
    — linear in T plus the shrinking-halo overhead, against the
    operator-fused ``(2Tr+1)``-dense growth."""
    if steps < 1:
        raise ValueError("steps >= 1")
    return float(sum(step_flops(tuple(b + 2 * (steps - 1 - s) * order
                                      for b in block))
                     for s in range(steps)))


def block_hbm_bytes(block: tuple[int, ...], halo_width: int,
                    dtype_bytes: int = 4) -> float:
    """Device-memory bytes to update one block: haloed read + write-back.

    The shared traffic term of the fuse-depth chooser and the planner's
    roofline model (halo_width = fused order ``T*r``).
    """
    read = float(np.prod([b + 2 * halo_width for b in block]))
    write = float(np.prod(block))
    return dtype_bytes * (read + write)


def inkernel_hbm_bytes(block: tuple[int, ...], steps: int, order: int,
                       dtype_bytes: int = 4) -> float:
    """Device-memory bytes for one in-kernel T-step chunk of one block:
    the ``T*r``-haloed read plus one write-back — intermediates stay in
    shared memory, so this equals the operator-fused chunk's traffic."""
    return block_hbm_bytes(block, steps * order, dtype_bytes)


def aux_hbm_bytes(block: tuple[int, ...], halo_width: int, n_aux: int,
                  dtype_bytes: int = 4) -> float:
    """Extra device-memory bytes per block update for the scenario
    operands: one streamed f32 read per auxiliary array per chunk (the
    output-aligned tile for a single step, the ``T*r``-haloed window for
    an in-kernel chunk).  Shared across the batch — it does not scale
    with B."""
    if n_aux <= 0:
        return 0.0
    return n_aux * dtype_bytes * float(
        np.prod([b + 2 * halo_width for b in block]))


def n_aux_operands(spec: StencilSpec) -> int:
    """How many scenario operands (field, mask) a spec streams per chunk."""
    return int(spec.is_varying) + int(spec.is_masked)


def active_block_fraction(mask: np.ndarray | None,
                          block: tuple[int, ...]) -> float:
    """Fraction of output tiles with at least one active (unmasked) point.

    A fully-masked tile's output is identically zero whatever the operator
    does, so the planner scales the compute and traffic terms by this
    fraction (pricing only — execution is exact either way).  1.0 for
    unmasked specs.
    """
    if mask is None:
        return 1.0
    m = np.asarray(mask).astype(bool)
    block = tuple(block[-m.ndim:])
    # pad to whole tiles (padding is inactive), then reduce each tile
    m = np.pad(m, [(0, (-s) % b) for s, b in zip(m.shape, block)])
    tiled = m.reshape([d for s, b in zip(m.shape, block)
                       for d in (s // b, b)])
    active = tiled.any(axis=tuple(range(1, tiled.ndim, 2)))
    return float(active.mean()) if active.size else 1.0
