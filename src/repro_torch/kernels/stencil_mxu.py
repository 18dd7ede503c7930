"""Hopper kernels for stencil matrixization (paper §3-§4, §6), with their
plain PyTorch versions.

Two hand-written CUDA kernels (``csrc/stencil_step.cu``,
``csrc/stencil_sweep.cu``, built for ``sm_90a`` by :mod:`cuda_build`)
replace the JAX package's two Pallas TPU kernels:

* :func:`stencil_cuda_call` — one valid-mode step (replaces
  ``repro.kernels.stencil_mxu.stencil_pallas_call``);
* :func:`sweep_cuda_call` — T base steps in one kernel with shared-memory
  intermediates, ``fuse_strategy="inkernel"`` (replaces
  ``sweep_pallas_call``).

One CUDA block owns one output tile of one state and keeps the haloed slab
in shared memory.  Every coefficient line of the cover is applied as its
gather band with the zero entries skipped — the arithmetic of the Pallas
kernel's banded-Toeplitz contraction (the accumulated ``2r+n`` outer
products of Eq. 12) without the Toeplitz operator's structural zeros —
then the degenerate lines as point taps (§3.3), accumulated in f32.  The
host-side plans flatten that into one tap list (:attr:`KernelPlan.taps`),
which the kernels and the plain versions consume in the same order.

Routing: a wrapper given a CPU tensor runs its plain version (whole-tensor
shifted adds, the same taps in the same order); given a CUDA tensor it
launches its kernel or raises — there is no fallback.  Each wrapper counts
its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import matrixization as mx
from repro_torch.core.coefficient_lines import LineCover
from repro_torch.core.matrixization import SCRATCH_MODES, check_scratch
from repro_torch.core.stencil_spec import StencilSpec
from repro_torch.kernels import cuda_build

__all__ = ["KernelPlan", "build_kernel_plan", "stencil_cuda_call",
           "stencil_step_plain", "SweepKernelPlan",
           "build_sweep_kernel_plan", "sweep_cuda_call", "sweep_plain",
           "SCRATCH_MODES", "MAX_BATCH"]

#: The batch rides the kernels' second grid dimension (at most 65535).
MAX_BATCH = 65535

Tap = tuple[float, tuple[int, ...]]   # (f32 coefficient, gather offsets)


def _plan_lines(spec: StencilSpec, cover: LineCover):
    """(band_lines, point_taps) shared by both kernels.

    ``band_lines`` carry the RAW gather band per multi-tap line —
    ``(axis, (2r+1,) band, fixed gather offsets)``; single-tap and
    diagonal lines decompose into ``point_taps`` — ``(coeff, gather
    offsets per axis)`` (paper §3.3 degenerate case).
    """
    e = spec.extent
    band_lines = []
    point_taps = []
    for line in cover.lines:
        if line.is_diagonal or line.nnz <= 1:
            for o, c in enumerate(np.asarray(line.coeffs)):
                if c == 0.0:
                    continue
                if line.is_diagonal:
                    offs = {a: (o if d > 0 else e - 1 - o) for a, d in line.axis}
                else:
                    offs = {line.axis: o}
                for a, v in line.fixed:
                    offs[a] = v
                gather = tuple((e - 1) - offs[a] for a in range(spec.ndim))
                point_taps.append((float(c), gather))
            continue
        band, fixed = mx.line_to_gather_band(line, spec)
        band_lines.append((line.axis, np.asarray(band, np.float64),
                           tuple(sorted(fixed.items()))))
    return tuple(band_lines), tuple(point_taps)


def _flat_taps(spec: StencilSpec, band_lines, point_taps) -> tuple[Tap, ...]:
    """The kernels' tap list: lines grouped by axis (ascending, lines in
    cover order within an axis — the reference's per-axis contraction
    order), each band's non-zero entries in band order, then the point
    taps.  Coefficients are rounded to f32 as the reference's f32
    Toeplitz operators and point-tap scalars are."""
    taps: list[Tap] = []
    for axis in sorted({a for a, _, _ in band_lines}):
        for a, band, fixed in band_lines:
            if a != axis:
                continue
            fixed_d = dict(fixed)
            for s, c in enumerate(band):
                if c == 0.0:
                    continue
                offs = [fixed_d.get(d, 0) for d in range(spec.ndim)]
                offs[axis] = s
                taps.append((float(np.float32(c)), tuple(offs)))
    taps.extend((float(np.float32(c)), tuple(g)) for c, g in point_taps)
    return tuple(taps)


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Host-side compilation of (spec, cover, block) into kernel constants.

    ``batch`` is None for a rank-``ndim`` spatial input; an int B makes the
    wrapper expect a leading batch axis of that extent (one grid row of
    blocks per state).  ``n_aux`` scenario operands (field, then mask) are
    OUTPUT-aligned f32 inputs multiplied into the accumulator before the
    cast, shared across the batch.
    """

    spec: StencilSpec
    block: tuple[int, ...]
    band_lines: tuple[tuple[int, np.ndarray, tuple[tuple[int, int], ...]], ...]
    point_taps: tuple[tuple[float, tuple[int, ...]], ...]
    batch: int | None = None
    n_aux: int = 0

    @property
    def taps(self) -> tuple[Tap, ...]:
        return _flat_taps(self.spec, self.band_lines, self.point_taps)


def build_kernel_plan(spec: StencilSpec, cover: LineCover,
                      block: tuple[int, ...],
                      batch: int | None = None) -> KernelPlan:
    if len(block) != spec.ndim:
        raise ValueError(f"block rank {len(block)} != stencil ndim {spec.ndim}")
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    band_lines, point_taps = _plan_lines(spec, cover)
    return KernelPlan(spec=spec, block=tuple(int(b) for b in block),
                      band_lines=band_lines, point_taps=point_taps,
                      batch=None if batch is None else int(batch),
                      n_aux=mx.n_aux_operands(spec))


@dataclasses.dataclass(frozen=True)
class SweepKernelPlan:
    """Host-side compilation of (spec, cover, block, steps).

    ``step_exts[s]`` is the live output extent after step ``s``: the slab
    starts ``steps*r`` deep and every step consumes ``r`` of halo per side,
    so ``step_exts[s][a] = block[a] + 2*(steps-1-s)*r`` and
    ``step_exts[-1] == block``.  The same BASE taps apply at every step.
    ``batch`` follows :class:`KernelPlan`; ``scratch`` picks the
    shared-memory policy (see :data:`SCRATCH_MODES`).  ``n_aux`` scenario
    operands are SLAB-aligned f32 inputs (the haloed input's spatial
    shape, no batch axis); step ``s`` scales by the sub-slice at offset
    ``(s+1)*r``, so every intermediate is scaled/masked exactly as a
    sequence of single steps would be.
    """

    spec: StencilSpec
    block: tuple[int, ...]
    steps: int
    band_lines: tuple[tuple[int, np.ndarray, tuple[tuple[int, int], ...]], ...]
    point_taps: tuple[tuple[float, tuple[int, ...]], ...]
    batch: int | None = None
    scratch: str = "pingpong"
    n_aux: int = 0

    @property
    def taps(self) -> tuple[Tap, ...]:
        return _flat_taps(self.spec, self.band_lines, self.point_taps)

    @property
    def step_exts(self) -> tuple[tuple[int, ...], ...]:
        r = self.spec.order
        return tuple(
            tuple(b + 2 * (self.steps - 1 - s) * r for b in self.block)
            for s in range(self.steps))


def build_sweep_kernel_plan(spec: StencilSpec, cover: LineCover,
                            block: tuple[int, ...],
                            steps: int, batch: int | None = None,
                            scratch: str = "pingpong") -> SweepKernelPlan:
    if len(block) != spec.ndim:
        raise ValueError(f"block rank {len(block)} != stencil ndim {spec.ndim}")
    if steps < 1:
        raise ValueError("steps >= 1")
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    band_lines, point_taps = _plan_lines(spec, cover)
    return SweepKernelPlan(spec=spec, block=tuple(int(b) for b in block),
                           steps=int(steps), band_lines=band_lines,
                           point_taps=point_taps,
                           batch=None if batch is None else int(batch),
                           scratch=check_scratch(scratch),
                           n_aux=mx.n_aux_operands(spec))


# ---------------------------------------------------------------------------
# Shared input checks and launch arguments
# ---------------------------------------------------------------------------

def _check_input(x: torch.Tensor, plan, halo_width: int):
    """Validate the (optionally batched) haloed input; returns the spatial
    output shape."""
    nd = plan.spec.ndim
    lead = 0 if plan.batch is None else 1
    if x.ndim != nd + lead:
        kind = f"rank-{nd} spatial" if not lead else \
            f"({plan.batch}, spatial...) batched"
        raise ValueError(f"kernel expects {kind} input, got {tuple(x.shape)}")
    if lead and x.shape[0] != plan.batch:
        raise ValueError(f"batch extent {x.shape[0]} != planned batch "
                         f"{plan.batch}")
    out_shape = tuple(s - 2 * halo_width for s in x.shape[lead:])
    for s, b in zip(out_shape, plan.block):
        if s <= 0 or s % b:
            raise ValueError(f"spatial size {s} not a positive multiple of "
                             f"block {b}")
    return out_shape


def _check_aux(aux: Sequence[torch.Tensor], plan, shape, what: str):
    if len(aux) != plan.n_aux:
        raise ValueError(f"plan expects {plan.n_aux} aux operand(s), "
                         f"got {len(aux)}")
    for a in aux:
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"aux operand shape {tuple(a.shape)} != "
                             f"{what} {tuple(shape)}")


def _as3(v: Sequence[int], fill: int) -> tuple[int, int, int]:
    """A 2-D extent as 3-D with a leading ``fill`` (the kernels are 3-D)."""
    v = tuple(int(a) for a in v)
    return (fill,) * (3 - len(v)) + v


def _packed_taps(taps: Sequence[Tap], slab: Sequence[int],
                 device) -> torch.Tensor:
    """The kernels' tap table: the f32 coefficients' bits, then each tap's
    linear offset into the shared-memory slab of extents ``slab``."""
    s = _as3(slab, 1)
    strides = (s[1] * s[2], s[2], 1)
    coef = np.array([c for c, _ in taps], np.float32)
    offs = np.array([sum(g * st for g, st in zip(_as3(o, 0), strides))
                     for _, o in taps], np.int32)
    packed = np.concatenate([coef.view(np.int32), offs])
    return torch.from_numpy(packed).to(device)


def _check_cuda_operands(x: torch.Tensor, aux, batch: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU (plain version) or CUDA "
                         f"tensors, got device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    for a in aux:
        if a.device != x.device or a.dtype != torch.float32 \
                or not a.is_contiguous():
            raise ValueError("aux operands must be contiguous float32 "
                             "tensors on the input's device")
    if batch > MAX_BATCH:
        raise ValueError(f"batch {batch} exceeds the grid limit {MAX_BATCH}")


_C_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_int, ctypes.c_int] + [ctypes.c_int] * 9


def _launcher(name: str, symbol: str, extra_args: list):
    lib = cuda_build.load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = _C_ARGS + extra_args + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(fn, kernel: str, x, out, aux, taps, n_taps, batch, out_shape,
            block, halo, *extra) -> None:
    ptrs = [a.data_ptr() for a in aux] + [None] * (2 - len(aux))
    err = fn(x.data_ptr(), out.data_ptr(), ptrs[0], ptrs[1], len(aux),
             taps.data_ptr(), n_taps, int(x.dtype == torch.bfloat16), batch,
             *_as3(out_shape, 1), *_as3(block, 1), *halo, *extra,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error "
                           f"{err}")


# ---------------------------------------------------------------------------
# Kernel 1: one valid-mode step
# ---------------------------------------------------------------------------

def _accumulate(xf: torch.Tensor, taps: Sequence[Tap], origin: Sequence[int],
                out_ext: Sequence[int]) -> torch.Tensor:
    """f32 sum of ``c * xf[window + gather]`` over the taps, the windows of
    extent ``out_ext`` starting at ``origin`` on the trailing axes."""
    lead = xf.ndim - len(out_ext)
    acc = torch.zeros(tuple(xf.shape[:lead]) + tuple(out_ext),
                      dtype=torch.float32, device=xf.device)
    for c, g in taps:
        index = (slice(None),) * lead + tuple(
            slice(o + gi, o + gi + n) for o, gi, n in zip(origin, g, out_ext))
        acc = acc + c * xf[index]
    return acc


def stencil_step_plain(x: torch.Tensor, plan: KernelPlan,
                       aux: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """The plain PyTorch version of :func:`stencil_cuda_call`: the same
    taps in the same order over the whole haloed tensor, f32
    accumulation, field then mask, cast to ``x.dtype``."""
    out_shape = _check_input(x, plan, plan.spec.order)
    _check_aux(aux, plan, out_shape, "output spatial shape")
    acc = _accumulate(x.to(torch.float32), plan.taps,
                      (0,) * plan.spec.ndim, out_shape)
    for a in aux:
        acc = acc * a.to(torch.float32)
    return acc.to(x.dtype)


def stencil_cuda_call(x: torch.Tensor, plan: KernelPlan,
                      aux: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Run the matrixized stencil step over a haloed spatial tensor.

    ``x``: ``([B,] S_0 + 2r, ..., S_{d-1} + 2r)`` haloed input with every
    ``S_a`` a multiple of ``plan.block[a]`` (``kernels.ops`` pads);
    returns ``([B,] S_0, ..., S_{d-1})`` in ``x.dtype``.  ``aux``:
    ``plan.n_aux`` output-aligned f32 operands (field, then mask).

    A CPU tensor runs :func:`stencil_step_plain`; a CUDA tensor launches
    ``csrc/stencil_step.cu`` or raises.
    """
    if x.device.type == "cpu":
        return stencil_step_plain(x, plan, aux)
    r = plan.spec.order
    out_shape = _check_input(x, plan, r)
    _check_aux(aux, plan, out_shape, "output spatial shape")
    batch = plan.batch or 1
    _check_cuda_operands(x, aux, batch)
    smem = mx.step_smem_bytes(plan.block, r)
    if smem > mx.SMEM_BYTES:
        raise ValueError(f"block {plan.block} at halo {r} needs {smem} B of "
                         f"shared memory (limit {mx.SMEM_BYTES})")
    taps = plan.taps
    table = _packed_taps(taps, [b + 2 * r for b in plan.block], x.device)
    out = torch.empty(tuple(x.shape[:x.ndim - plan.spec.ndim]) + out_shape,
                      dtype=x.dtype, device=x.device)
    fn = _launcher("stencil_step", "stencil_step_launch", [])
    _launch(fn, "stencil_step", x, out, aux, table, len(taps), batch,
            out_shape, plan.block, _as3((r,) * plan.spec.ndim, 0))
    stencil_cuda_call.launches += 1
    return out


stencil_cuda_call.launches = 0


# ---------------------------------------------------------------------------
# Kernel 2: T base steps in one kernel (fuse_strategy="inkernel")
# ---------------------------------------------------------------------------

def sweep_plain(x: torch.Tensor, plan: SweepKernelPlan,
                aux: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """The plain PyTorch version of :func:`sweep_cuda_call`: ``steps``
    whole-tensor applications of the same taps, f32 intermediates, each
    step scaled by the aux sub-slice at offset ``(s+1)*r``, one cast at
    the end."""
    r, steps = plan.spec.order, plan.steps
    out_shape = _check_input(x, plan, steps * r)
    slab_shape = tuple(x.shape[x.ndim - plan.spec.ndim:])
    _check_aux(aux, plan, slab_shape, "haloed slab shape")
    taps = plan.taps
    cur = x.to(torch.float32)
    for s in range(steps):
        ext = tuple(n + 2 * (steps - 1 - s) * r for n in out_shape)
        cur = _accumulate(cur, taps, (0,) * plan.spec.ndim, ext)
        for a in aux:
            cur = cur * a[tuple(slice((s + 1) * r, (s + 1) * r + n)
                                for n in ext)].to(torch.float32)
    return cur.to(x.dtype)


def sweep_cuda_call(x: torch.Tensor, plan: SweepKernelPlan,
                    aux: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Advance a haloed spatial tensor by ``plan.steps`` base steps in one
    kernel.

    ``x``: ``([B,] S_0 + 2Tr, ...)`` haloed input, ``S_a`` multiples of
    the block; returns ``([B,] S_0, ...)`` — the state after T valid-mode
    applications.  ``aux``: ``plan.n_aux`` slab-aligned f32 operands with
    ``x``'s spatial shape (no batch axis).

    A CPU tensor runs :func:`sweep_plain`; a CUDA tensor launches
    ``csrc/stencil_sweep.cu`` or raises.
    """
    if x.device.type == "cpu":
        return sweep_plain(x, plan, aux)
    r, steps = plan.spec.order, plan.steps
    out_shape = _check_input(x, plan, steps * r)
    _check_aux(aux, plan, tuple(x.shape[x.ndim - plan.spec.ndim:]),
               "haloed slab shape")
    batch = plan.batch or 1
    _check_cuda_operands(x, aux, batch)
    if not mx.sweep_feasible(plan.block, steps, r, plan.scratch):
        raise ValueError(
            f"block {plan.block} at {steps} steps of order {r} does not fit "
            f"the sweep kernel under scratch={plan.scratch!r} "
            f"({mx.sweep_smem_bytes(plan.block, steps, r, plan.scratch)} B "
            f"of shared memory, limit {mx.SMEM_BYTES})")
    taps = plan.taps
    table = _packed_taps(taps, [b + 2 * steps * r for b in plan.block],
                         x.device)
    out = torch.empty(tuple(x.shape[:x.ndim - plan.spec.ndim]) + out_shape,
                      dtype=x.dtype, device=x.device)
    fn = _launcher("stencil_sweep", "stencil_sweep_launch",
                   [ctypes.c_int, ctypes.c_int])
    _launch(fn, "stencil_sweep", x, out, aux, table, len(taps), batch,
            out_shape, plan.block, _as3((r,) * plan.spec.ndim, 0), steps,
            int(plan.scratch == "single"))
    sweep_cuda_call.launches += 1
    return out


sweep_cuda_call.launches = 0
