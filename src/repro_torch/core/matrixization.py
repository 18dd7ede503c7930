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
    "step_slab_pitch",
    "step_smem_bytes",
    "step_walk_planes",
    "step_ring_smem_bytes",
    "step_walk",
    "sweep_slab_pitch",
    "sweep_items",
    "sweep_smem_bytes",
    "sweep_feasible",
    "sweep_walk_rings",
    "sweep_ring_smem_bytes",
    "sweep_walk",
    "SMEM_BYTES",
    "TILE_SMEM_BUDGET",
    "SWEEP_THREADS",
    "SINGLE_SLOTS",
    "SWEEP_ITEM_ROWS",
    "SWEEP_ITEM_CHUNKS",
    "STEP_THREADS",
    "STEP_V",
    "STEP_MAX_RUN",
    "STEP_ROWS",
    "STEP_WALKS",
    "H100_SMS",
    "STEP_WALK_REREAD",
    "STEP_WALK_BLOCKS",
    "SWEEP_WALK_ROWS",
    "SWEEP_WALK_AHEAD",
    "SWEEP_WALK_MAX_ORDER",
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
# dynamic shared memory.  The kernel wrappers gate on that hard launch
# limit, SMEM_BYTES; the planner's block search, its fused-operator and
# in-kernel candidates and the fuse-depth chooser all gate on the one
# residency budget TILE_SMEM_BUDGET, so a plan never picks a tile the
# kernels cannot launch, nor one that leaves a single block on an SM.
SMEM_BYTES = 232448

# The step kernel (kernels/csrc/stencil_step.cu, which defines the same three
# numbers) runs STEP_THREADS threads a block; each thread computes STEP_V
# consecutive outputs along the last axis and applies the taps as runs of at
# most STEP_MAX_RUN consecutive taps along that axis.
STEP_THREADS = 256
STEP_V = 8
STEP_MAX_RUN = 9
#: Tile rows one pass of a step-kernel block covers: a warp is 32 / STEP_V
#: threads along a row times STEP_V rows (the kernel's kTy).
STEP_ROWS = STEP_THREADS // (32 // STEP_V)
#: Tiles a 3-D step launch may walk along axis 0 (:func:`step_walk`).
STEP_WALKS = (1, 2, 4, 8, 16)
#: Streaming multiprocessors of the card the port is built for (H100 SXM):
#: :func:`step_walk` reads the card's own count, and this one where no card
#: is at hand (pricing a launch on the CPU).
H100_SMS = 132

# The sweep kernel (kernels/csrc/stencil_sweep.cu, which defines the same
# numbers) runs SWEEP_THREADS threads a block and computes STEP_V outputs a
# thread in runs of at most STEP_MAX_RUN taps, as the step kernel does.  Its
# work item is one warp: SWEEP_ITEM_ROWS rows of SWEEP_ITEM_CHUNKS chunks of
# STEP_V outputs; items are dealt to the block's warps in turn.  Under
# scratch="single" a warp parks at most SINGLE_SLOTS items of a step in
# registers between the step's reads and its write-back.
SWEEP_THREADS = 256
SWEEP_ITEM_ROWS = 8
SWEEP_ITEM_CHUNKS = 4
SINGLE_SLOTS = 6
#: The sweep kernel's axis-0 walk (:func:`sweep_walk_rings`): rows each
#: level computes a step of the walk, and groups of that many input rows
#: loading while a step computes.
SWEEP_WALK_ROWS = 16
SWEEP_WALK_AHEAD = 1
#: The walk's kernels are compiled for orders 1 to SWEEP_WALK_MAX_ORDER.
SWEEP_WALK_MAX_ORDER = 4

#: :func:`step_walk`: a walk re-reads at most 1/STEP_WALK_REREAD of its
#: planes, and a walking launch keeps STEP_WALK_BLOCKS blocks for each
#: multiprocessor (about four waves of the four blocks an SM holds).
STEP_WALK_REREAD = 16
STEP_WALK_BLOCKS = 16

#: Shared memory a plan lets one block claim: an SM holds 228 KB, of which
#: each resident block reserves 1 KB, so two blocks of this size share an
#: SM and one block's loads overlap the other's arithmetic.
TILE_SMEM_BUDGET = 233472 // 2 - 1024


def step_slab_pitch(block: tuple[int, ...], halo_width: int) -> int:
    """Row pitch (f32 words) of the step kernel's slab: the haloed row
    rounded up to 16 bytes, plus ``STEP_V`` words of over-read room when
    the tile's last extent is not a multiple of ``STEP_V``, then rounded
    up to 4 (mod 8).  Rows stay 16-byte aligned for the kernel's copies
    and vector loads, and the two rows a quarter-warp reads at once fall
    on different banks."""
    pitch = -(-(block[-1] + 2 * halo_width) // 4) * 4
    if block[-1] % STEP_V:
        pitch += STEP_V
    return pitch + 4 if pitch % 8 == 0 else pitch


def step_smem_bytes(block: tuple[int, ...], halo_width: int,
                    table_words: int | None = None) -> int:
    """Shared memory of one step-kernel block: the f32 slab of one state at
    :func:`step_slab_pitch`, rounded up to 16 bytes (the batch is a grid
    dimension, so it does not scale this), and the tap table of
    ``table_words`` 32-bit words — by default its bound for a full
    ``(2*halo_width + 1)``-box of taps, one 4-word run header and one
    coefficient per tap."""
    lead = int(np.prod([b + 2 * halo_width for b in block[:-1]]))
    slab = -(-lead * step_slab_pitch(block, halo_width) // 4) * 4
    if table_words is None:
        table_words = 5 * (2 * halo_width + 1) ** len(block)
    return 4 * (slab + table_words)


def step_walk_planes(block: tuple[int, ...], halo_width: int
                     ) -> tuple[int, int, int]:
    """``(q, ahead, ring)`` of the step kernel's axis-0 walk over a 3-D
    tile: a step computes ``q`` output planes, enough rows that every
    thread row of the block has one (``q * b1 >= STEP_ROWS``) but at most
    half the tile's planes, while ``ahead`` groups of ``q`` planes load
    (two where the ring then holds no more planes than the tile's slab,
    ``3q <= b0``, else one), and the ring holds the ``2*halo_width + q``
    planes a step reads and those loading.  ``q = 0`` (a tile one plane
    deep) does not walk."""
    q = min(-(-STEP_ROWS // block[1]), block[0] // 2)
    ahead = 2 if block[0] >= 3 * q else 1
    return q, ahead, 2 * halo_width + (1 + ahead) * q


def step_ring_smem_bytes(block: tuple[int, ...], halo_width: int,
                         table_words: int | None = None) -> int:
    """Shared memory of one walking step-kernel block: the ring of
    :func:`step_walk_planes` slab planes at :func:`step_slab_pitch`,
    rounded up to 16 bytes, and the tap table as in
    :func:`step_smem_bytes`."""
    ring = step_walk_planes(block, halo_width)[2]
    rows = ring * (block[1] + 2 * halo_width)
    slab = -(-rows * step_slab_pitch(block, halo_width) // 4) * 4
    if table_words is None:
        table_words = 5 * (2 * halo_width + 1) ** len(block)
    return 4 * (slab + table_words)


def step_walk(out_shape: tuple[int, ...], block: tuple[int, ...],
              halo_width: int, batch: int, sms: int) -> int:
    """Tiles each block of a step launch walks along axis 0 (0: one tile a
    block, the slab path).

    Only a 3-D launch with a halo on axis 0 walks (a 2-D one is 3-D with a
    leading extent of 1 and no halo there), and only a tile at least two
    planes deep (:func:`step_walk_planes`); a walk of one tile reads what
    one tile a block does, and was measured faster (PERF.md §6).
    The walk is the shallowest of :data:`STEP_WALKS` whose ``2*halo_width``
    re-read planes are at most ``1/STEP_WALK_REREAD`` of its ``k*b0``
    output planes (deeper walks save little more), no deeper than the
    tiles along axis 0, and halved while the launch would have fewer than
    ``STEP_WALK_BLOCKS`` blocks for each of the card's ``sms``
    multiprocessors (its ``multi_processor_count``): fewer, longer blocks
    leave more of the card idle in the launch's last wave."""
    if len(block) < 3 or halo_width == 0 \
            or step_walk_planes(block, halo_width)[0] < 1:
        return 0
    tiles = [-(-int(o) // int(b)) for o, b in zip(out_shape, block)]
    walk = next((k for k in STEP_WALKS
                 if 2 * halo_width * STEP_WALK_REREAD <= k * block[0]),
                STEP_WALKS[-1])
    while walk > 1 and (walk > tiles[0] or batch * tiles[1] * tiles[2]
                        * -(-tiles[0] // walk) < STEP_WALK_BLOCKS * sms):
        walk //= 2
    return walk


def sweep_slab_pitch(block: tuple[int, ...], steps: int, order: int) -> int:
    """Row pitch (f32 words) of the sweep kernel's slab: the
    ``steps*order``-haloed row, up to 3 words of lead (the kernel stores a
    row so that its columns agree with the input's modulo 4, for 16-byte
    copies), and the over-read of a step's last chunk (``STEP_V`` outputs
    past the live row's last full chunk, the radius and a 16-byte load's
    rounding), rounded up to 4 (mod 8) as :func:`step_slab_pitch` is."""
    need = block[-1] + 2 * steps * order + 3 + STEP_V + 2
    pitch = -(-need // 4) * 4
    return pitch + 4 if pitch % 8 == 0 else pitch


def sweep_items(block: tuple[int, ...], steps: int, order: int) -> int:
    """Work items of the sweep kernel's first step (its widest live extent,
    ``block + 2*(steps-1)*order``): planes of the leading axes x blocks of
    ``SWEEP_ITEM_ROWS`` rows x groups of ``SWEEP_ITEM_CHUNKS`` chunks of
    ``STEP_V`` outputs along the last axis."""
    live = [b + 2 * (steps - 1) * order for b in block]
    planes = int(np.prod(live[:-2]))
    rows = -(-live[-2] // SWEEP_ITEM_ROWS) if len(live) > 1 else 1
    chunks = -(-live[-1] // STEP_V)
    return planes * rows * -(-chunks // SWEEP_ITEM_CHUNKS)


def sweep_smem_bytes(block: tuple[int, ...], steps: int, order: int,
                     scratch: str = "pingpong",
                     table_words: int | None = None) -> int:
    """Shared memory of one sweep-kernel block: the ``steps*order``-deep f32
    slab at :func:`sweep_slab_pitch`, rounded up to 16 bytes, twice for
    ``"pingpong"`` and once for ``"single"``, and the tap table of
    ``table_words`` 32-bit words — by default its bound for a full
    ``(2*order + 1)``-box of base taps, one 4-word run header and one
    coefficient per tap."""
    if steps < 1:
        raise ValueError("steps >= 1")
    n_bufs = 1 if check_scratch(scratch) == "single" else 2
    lead = int(np.prod([b + 2 * steps * order for b in block[:-1]]))
    slab = -(-lead * sweep_slab_pitch(block, steps, order) // 4) * 4
    if table_words is None:
        table_words = 5 * (2 * order + 1) ** len(block)
    return 4 * (n_bufs * slab + table_words)


def sweep_feasible(block: tuple[int, ...], steps: int, order: int,
                   scratch: str = "pingpong",
                   limit: int = SMEM_BYTES) -> bool:
    """Whether the sweep kernel can run this tile: its shared memory fits
    ``limit`` (the launch limit by default; plans pass
    :data:`TILE_SMEM_BUDGET`), and under ``"single"`` the widest
    intermediate's items fit the warps' register slots
    (``SWEEP_THREADS // 32 * SINGLE_SLOTS`` items; the last step stores to
    device memory and parks nothing)."""
    if sweep_smem_bytes(block, steps, order, scratch) > limit:
        return False
    if scratch == "single" and steps > 1:
        return sweep_items(block, steps, order) <= \
            SWEEP_THREADS // 32 * SINGLE_SLOTS
    return True


def sweep_walk_rings(steps: int, order: int) -> tuple[int, int, int, int]:
    """``(q, ahead, ring0, ring1)`` of the sweep kernel's axis-0 walk over
    a 2-D state: each level computes ``q`` rows a step of the walk while
    ``ahead`` groups of ``q`` input rows load; the input ring holds the
    ``2*order + q`` rows a step reads and those loading, and each of the
    ``steps - 1`` intermediate levels a ring of the ``2*order + q`` rows
    the next level reads and the ``q`` rows it writes at the same step."""
    q, ahead = SWEEP_WALK_ROWS, SWEEP_WALK_AHEAD
    return q, ahead, 2 * order + (1 + ahead) * q, 2 * order + 2 * q


def sweep_ring_smem_bytes(block: tuple[int, ...], steps: int, order: int,
                          table_words: int | None = None) -> int:
    """Shared memory of one walking sweep-kernel block: the input ring and
    the ``steps - 1`` step rings of :func:`sweep_walk_rings`, each row at
    :func:`sweep_slab_pitch`, rounded up to 16 bytes, and ``table_words``
    32-bit words for the taps (a mask a row and a coefficient a position
    of the ``(2*order + 1)``-square, the kernel's layout) — by default the
    bound of :func:`sweep_smem_bytes`."""
    if steps < 1:
        raise ValueError("steps >= 1")
    _, _, ring0, ring1 = sweep_walk_rings(steps, order)
    rows = ring0 + (steps - 1) * ring1
    words = -(-rows * sweep_slab_pitch(block, steps, order) // 4) * 4
    if table_words is None:
        table_words = 5 * (2 * order + 1) ** len(block)
    return 4 * (words + table_words)


def sweep_walk(out_shape: tuple[int, ...], block: tuple[int, ...],
               steps: int, order: int, batch: int, sms: int) -> int:
    """Tiles each block of a sweep launch walks along axis 0 (0: one tile
    a block, the slab path).

    Only a 2-D launch of order 1 to :data:`SWEEP_WALK_MAX_ORDER` walks,
    and only where its rings (:func:`sweep_ring_smem_bytes`) fit the
    launch limit.  As
    :func:`step_walk`: the shallowest of :data:`STEP_WALKS` whose
    ``2*steps*order`` re-read rows are at most ``1/STEP_WALK_REREAD`` of
    its ``k*b0`` output rows, no deeper than the tiles along axis 0, and
    halved while the launch would have fewer than ``STEP_WALK_BLOCKS``
    blocks for each of the card's ``sms`` multiprocessors.  A walk of one
    tile reads and computes what one tile a block does."""
    if len(block) != 2 or not 1 <= order <= SWEEP_WALK_MAX_ORDER \
            or sweep_ring_smem_bytes(block, steps, order) > SMEM_BYTES:
        return 0
    tiles = [-(-int(o) // int(b)) for o, b in zip(out_shape, block)]
    halo = 2 * steps * order
    walk = next((k for k in STEP_WALKS
                 if halo * STEP_WALK_REREAD <= k * block[0]),
                STEP_WALKS[-1])
    while walk > 1 and (walk > tiles[0] or batch * tiles[1]
                        * -(-tiles[0] // walk) < STEP_WALK_BLOCKS * sms):
        walk //= 2
    return walk


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
