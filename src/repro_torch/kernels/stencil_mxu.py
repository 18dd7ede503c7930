"""Hopper kernels for stencil matrixization (paper §3-§4, §6), with their
plain PyTorch versions.

Two hand-written CUDA kernels (``csrc/stencil_step.cu``,
``csrc/stencil_sweep.cu``, built for ``sm_90a`` by :mod:`cuda_build`)
replace the JAX package's two Pallas TPU kernels:

* :func:`stencil_cuda_call` — one step (replaces
  ``repro.kernels.stencil_mxu.stencil_pallas_call``);
* :func:`sweep_cuda_call` — T base steps in one kernel with shared-memory
  intermediates, ``fuse_strategy="inkernel"`` (replaces
  ``sweep_pallas_call``).

Each takes a haloed input (valid mode) or, in wrap mode, the unpadded
periodic state, whose halo it reads through wrapped indices.

One CUDA block owns one output tile of one state and keeps the haloed slab
in shared memory.  Every coefficient line of the cover is applied as its
gather band with the zero entries skipped — the arithmetic of the Pallas
kernel's banded-Toeplitz contraction (the accumulated ``2r+n`` outer
products of Eq. 12) without the Toeplitz operator's structural zeros —
then the degenerate lines as point taps (§3.3), accumulated in f32.  The
host-side plans flatten that into one tap list in row order
(:attr:`KernelPlan.taps`: grouped by the leading-axis offsets, sorted
along the last axis), which the kernels and the plain versions consume in
the same order; both kernels apply it as runs of consecutive taps along
the last axis held in registers (:func:`tap_runs`).  Each plan's tap
table is built on a device once (:func:`tap_table`) and reused by every
launch.

A 3-D step launch walks axis 0 instead (:func:`step_kernel`): one block
streams a column of tiles through a ring of slab planes, so the axis-0
halo is read once a walk, not once a tile.  A 2-D sweep launch walks axis
0 too (:func:`sweep_kernel`): one block streams a strip of tiles through a
ring of input rows and one ring of rows a step, so the axis-0 halo is
neither re-read nor recomputed along the walk.

Routing: a wrapper given a CPU tensor runs its plain version (whole-tensor
shifted adds, the same taps in the same order); given a CUDA tensor it
launches its kernel or raises — there is no fallback.  Each wrapper counts
its launches in ``<wrapper>.launches``, its wrap-mode launches also in
``<wrapper>.wrap_launches``, and each kernel's walking launches in
``<wrapper>.walk_launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import halo
from repro_torch.core import matrixization as mx
from repro_torch.core.coefficient_lines import LineCover
from repro_torch.core.matrixization import SCRATCH_MODES, check_scratch
from repro_torch.core.stencil_spec import StencilSpec
from repro_torch.kernels import cuda_build, launch_cost
from repro_torch.kernels.launch_cost import LaunchCost

__all__ = ["KernelPlan", "build_kernel_plan", "stencil_cuda_call",
           "stencil_step_plain", "SweepKernelPlan",
           "build_sweep_kernel_plan", "sweep_cuda_call", "sweep_plain",
           "sweep_aux_shape", "step_launch_cost", "sweep_launch_cost",
           "step_lead", "step_kernel", "step_walk_of", "sweep_kernel",
           "sweep_walk_of", "sm_count", "tap_runs",
           "tap_table", "SCRATCH_MODES", "MAX_BATCH"]

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
    """The kernels' tap list in row order: every band's non-zero entries
    and every point tap, grouped into rows — taps with the same offsets on
    the leading axes, rows in ascending order of those offsets — and
    sorted along the last axis within a row (a stable sort, so taps at
    one offset keep their cover order).  The step kernel applies each row
    as runs of consecutive taps held in registers; both kernels and both
    plain versions sum in this order.  Coefficients are rounded to f32 as
    the reference's f32 Toeplitz operators and point-tap scalars are."""
    taps: list[Tap] = []
    for a, band, fixed in band_lines:
        fixed_d = dict(fixed)
        for s, c in enumerate(band):
            if c == 0.0:
                continue
            offs = [fixed_d.get(d, 0) for d in range(spec.ndim)]
            offs[a] = s
            taps.append((float(np.float32(c)), tuple(offs)))
    taps.extend((float(np.float32(c)), tuple(g)) for c, g in point_taps)
    return tuple(sorted(taps, key=lambda t: (t[1][:-1], t[1][-1])))


def tap_runs(taps: Sequence[Tap], max_run: int = mx.STEP_MAX_RUN):
    """The step kernel's runs: maximal groups of consecutive taps (in
    ``taps`` order) with the same leading offsets and last-axis offsets
    that step by one, at most ``max_run`` long.  Returns ``(leading
    offsets, first last-axis offset, coefficients)`` per run."""
    runs: list[tuple[tuple[int, ...], int, list[float]]] = []
    for c, g in taps:
        if runs:
            lead, start, coefs = runs[-1]
            if lead == g[:-1] and start + len(coefs) == g[-1] \
                    and len(coefs) < max_run:
                coefs.append(c)
                continue
        runs.append((g[:-1], g[-1], [c]))
    return [(lead, start, tuple(coefs)) for lead, start, coefs in runs]


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Host-side compilation of (spec, cover, block) into kernel constants.

    ``batch`` is None for a rank-``ndim`` spatial input; an int B makes the
    wrapper expect a leading batch axis of that extent (one grid row of
    blocks per state).  ``n_aux`` scenario operands (field, then mask) are
    OUTPUT-aligned f32 inputs multiplied into the accumulator before the
    cast, shared across the batch.  ``wrap`` is the input contract, as
    :class:`SweepKernelPlan`'s: False takes the ``r``-haloed input with
    tile-multiple outputs (boundaries 'valid' and 'zero'), True the
    unpadded periodic state of any extents, whose halo the kernel reads
    through wrapped indices (boundary 'periodic').
    """

    spec: StencilSpec
    block: tuple[int, ...]
    band_lines: tuple[tuple[int, np.ndarray, tuple[tuple[int, int], ...]], ...]
    point_taps: tuple[tuple[float, tuple[int, ...]], ...]
    batch: int | None = None
    n_aux: int = 0
    wrap: bool = False

    @functools.cached_property
    def taps(self) -> tuple[Tap, ...]:
        return _flat_taps(self.spec, self.band_lines, self.point_taps)


def build_kernel_plan(spec: StencilSpec, cover: LineCover,
                      block: tuple[int, ...],
                      batch: int | None = None,
                      wrap: bool = False) -> KernelPlan:
    if len(block) != spec.ndim:
        raise ValueError(f"block rank {len(block)} != stencil ndim {spec.ndim}")
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    band_lines, point_taps = _plan_lines(spec, cover)
    return KernelPlan(spec=spec, block=tuple(int(b) for b in block),
                      band_lines=band_lines, point_taps=point_taps,
                      batch=None if batch is None else int(batch),
                      n_aux=mx.n_aux_operands(spec), wrap=bool(wrap))


@dataclasses.dataclass(frozen=True)
class SweepKernelPlan:
    """Host-side compilation of (spec, cover, block, steps).

    ``step_exts[s]`` is the live output extent after step ``s``: the slab
    starts ``steps*r`` deep and every step consumes ``r`` of halo per side,
    so ``step_exts[s][a] = block[a] + 2*(steps-1-s)*r`` and
    ``step_exts[-1] == block``.  The same BASE taps apply at every step.
    ``batch`` follows :class:`KernelPlan`; ``scratch`` picks the
    shared-memory policy (see :data:`SCRATCH_MODES`).  ``wrap`` is the
    input contract: False takes the ``steps*r``-haloed input (boundaries
    'valid' and 'zero'), True the unpadded periodic state, whose halo the
    kernel reads through wrapped indices (boundary 'periodic').  ``n_aux``
    scenario operands are SLAB-aligned f32 inputs of
    :func:`sweep_aux_shape` (no batch axis); step ``s`` scales by the
    sub-slice at offset ``(s+1)*r``, so every intermediate is
    scaled/masked exactly as a sequence of single steps would be.
    """

    spec: StencilSpec
    block: tuple[int, ...]
    steps: int
    band_lines: tuple[tuple[int, np.ndarray, tuple[tuple[int, int], ...]], ...]
    point_taps: tuple[tuple[float, tuple[int, ...]], ...]
    batch: int | None = None
    scratch: str = "pingpong"
    n_aux: int = 0
    wrap: bool = False

    @functools.cached_property
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
                            scratch: str = "pingpong",
                            wrap: bool = False) -> SweepKernelPlan:
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
                           n_aux=mx.n_aux_operands(spec), wrap=bool(wrap))


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


def _check_state(x: torch.Tensor, plan, what: str):
    """Validate the (optionally batched) unpadded state a wrap-mode plan
    takes; returns its spatial shape, which is the output's."""
    nd = plan.spec.ndim
    lead = 0 if plan.batch is None else 1
    if x.ndim != nd + lead or (lead and x.shape[0] != plan.batch):
        raise ValueError(f"wrap-mode {what} expects a ([{plan.batch}], "
                         f"spatial...) state, got {tuple(x.shape)}")
    out_shape = tuple(x.shape[lead:])
    if any(s <= 0 for s in out_shape):
        raise ValueError(f"empty state {tuple(x.shape)}")
    return out_shape


def _step_shape(x: torch.Tensor, plan: KernelPlan):
    """The step kernel's spatial output shape, under the plan's input
    contract."""
    if plan.wrap:
        return _check_state(x, plan, "step")
    return _check_input(x, plan, plan.spec.order)


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


def _slab_strides(slab: Sequence[int], pitch: int) -> tuple[int, int, int]:
    """Strides (f32 words) of a slab of extents ``slab`` whose rows have
    ``pitch`` words, as 3-D."""
    s = _as3(slab, 1)
    return (s[1] * pitch, pitch, 1)


def _run_table(taps: Sequence[Tap], strides: Sequence[int],
               origin: Sequence[int]) -> tuple[np.ndarray, int]:
    """A tap table of runs and its run count: one 4-word header per run
    (slab offset of its first tap relative to ``origin``, width, index of
    its first coefficient, that offset modulo 4), then the f32
    coefficients' bits in run order."""
    runs = tap_runs(taps)
    head, coefs = [], []
    for lead, start, cs in runs:
        off = sum((g - o) * st for g, o, st in
                  zip(_as3(lead + (start,), 0), origin, strides))
        head.append((off, len(cs), len(coefs), off % 4))
        coefs.extend(cs)
    return np.concatenate([np.array(head, np.int32).reshape(-1),
                           np.array(coefs, np.float32).view(np.int32)]), \
        len(runs)


def step_lead(plan: KernelPlan) -> int:
    """Storage column of slab column 0 in the step kernel's slab rows: 0
    on a haloed input; in wrap mode ``-r`` modulo 4, since the slab then
    starts ``r`` columns before a tile origin and the kernel stores its
    rows so that storage and input columns agree modulo 4 (16-byte
    copies)."""
    return (-plan.spec.order) % 4 if plan.wrap else 0


def _step_table(taps: Sequence[Tap], block: Sequence[int],
                halo_width: int, lead: int = 0) -> tuple[np.ndarray, int]:
    """The step kernel's tap table (:func:`_run_table`): offsets from the
    slab origin, at the step kernel's row pitch, each ``lead`` words
    further (:func:`step_lead`)."""
    slab = [b + 2 * halo_width for b in block]
    strides = _slab_strides(slab, mx.step_slab_pitch(tuple(block),
                                                      halo_width))
    return _run_table(taps, strides, (0, 0, -lead))


def _sweep_table(taps: Sequence[Tap], block: Sequence[int], steps: int,
                 order: int) -> tuple[np.ndarray, int]:
    """The sweep kernel's tap table (:func:`_run_table`): offsets from the
    output's own slab position, at the sweep kernel's row pitch, so one
    table serves every step of the shrinking live window."""
    slab = [b + 2 * steps * order for b in block]
    strides = _slab_strides(slab, mx.sweep_slab_pitch(tuple(block), steps,
                                                       order))
    return _run_table(taps, strides, _as3((order,) * len(block), 0))


@functools.lru_cache(maxsize=256)
def _device_table(kind: str, taps: tuple[Tap, ...], block: tuple[int, ...],
                  order: int, steps: int, lead: int, device: torch.device):
    """A kernel's tap table on ``device`` and its run count, built and
    copied once per (kernel, taps, tile, order, steps, lead, device) —
    that is, once per plan and device — and reused by every later
    launch."""
    if kind == "step":
        table, n_runs = _step_table(taps, block, order, lead)
    else:
        table, n_runs = _sweep_table(taps, block, steps, order)
    return torch.from_numpy(table).to(device), n_runs


def tap_table(plan, device) -> tuple[torch.Tensor, int]:
    """The tap table of ``plan``'s kernel (the step kernel for a
    :class:`KernelPlan`, the sweep kernel for a
    :class:`SweepKernelPlan`) on ``device``, with its run count: the same
    tensor on every call for the same plan and device."""
    device = torch.device(device)
    if isinstance(plan, SweepKernelPlan):
        return _device_table("sweep", plan.taps, plan.block,
                             plan.spec.order, plan.steps, 0, device)
    return _device_table("step", plan.taps, plan.block, plan.spec.order, 1,
                         step_lead(plan), device)


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


@functools.lru_cache(maxsize=None)
def _launcher(name: str, symbol: str, n_extra: int):
    """The kernel library's C launcher, with its argument types set once:
    the common arguments, ``n_extra`` ints, the stream."""
    lib = cuda_build.load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = _C_ARGS + [ctypes.c_int] * n_extra + [ctypes.c_void_p]
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
# What a launch executes (launch_cost)
# ---------------------------------------------------------------------------

def _table_words(plan) -> int:
    """Words of a plan's tap table: a 4-word header per run, then the
    coefficients (:func:`_run_table`)."""
    return 4 * len(tap_runs(plan.taps)) + len(plan.taps)


def _launch_blocks(plan, out_shape) -> int:
    """CUDA blocks of a launch: one per output tile of one state."""
    tiles = int(np.prod([-(-o // b) for o, b in zip(out_shape, plan.block)]))
    return (plan.batch or 1) * tiles


def step_launch_cost(plan: KernelPlan, x_shape: Sequence[int],
                     itemsize: int, sms: int = mx.H100_SMS) -> LaunchCost:
    """One :func:`stencil_cuda_call` on an input of ``x_shape`` (haloed,
    or the state itself in wrap mode) on a card of ``sms``
    multiprocessors.  One tile a block: every block reads its
    ``r``-haloed slab (wrapped or haloed alike), its tile of each aux
    operand and the tap table, and does one FMA per tap per tile output.
    Walking ``k`` tiles a block (:func:`step_walk_of`): every block reads
    the ``len + 2r`` slab planes of its walk's ``len`` planes of whole
    tiles (``k*b0``, fewer at the state's end), and otherwise as one tile
    a block.  The output is written once."""
    nd, r = plan.spec.ndim, plan.spec.order
    out = [int(s) - (0 if plan.wrap else 2 * r)
           for s in x_shape[len(x_shape) - nd:]]
    blocks = _launch_blocks(plan, out)
    tile = int(np.prod(plan.block))
    slab = int(np.prod([b + 2 * r for b in plan.block]))
    table = _table_words(plan) * 4
    written = (plan.batch or 1) * int(np.prod(out)) * itemsize
    walk = step_walk_of(plan, out, sms)
    if walk:
        b0 = plan.block[0]
        tiles0 = -(-out[0] // b0)
        reads = sum(min(walk, tiles0 - t0) * b0 + 2 * r
                    for t0 in range(0, tiles0, walk))
        columns = blocks // tiles0
        return LaunchCost(
            fmas=len(plan.taps) * tile * blocks,
            bytes=columns * (reads * slab // (b0 + 2 * r) * itemsize
                             + -(-tiles0 // walk) * table)
            + blocks * plan.n_aux * tile * 4 + written)
    per_block = slab * itemsize + plan.n_aux * tile * 4 + table
    return LaunchCost(fmas=len(plan.taps) * tile * blocks,
                      bytes=blocks * per_block + written)


def sweep_launch_cost(plan: SweepKernelPlan, x_shape: Sequence[int],
                      itemsize: int, sms: int = mx.H100_SMS) -> LaunchCost:
    """One :func:`sweep_cuda_call` on a card of ``sms`` multiprocessors.
    One tile a block: every block reads its ``T*r``-haloed slab (wrapped
    or haloed alike) and the tap table, and at each step ``s`` computes —
    and scales by each aux operand — the live extent ``step_exts[s]``, so
    the halo rings it recomputes are counted.  Walking ``k`` tiles a block
    (:func:`sweep_walk_of`): every block reads the ``len + 2Tr`` haloed
    rows of its walk's ``len`` rows of whole tiles (``k*b0``, fewer at the
    state's end) and the table, and at step ``s`` computes the
    ``len + 2(T-1-s)r`` rows of the live width once.  The output is
    written once."""
    nd, r, steps = plan.spec.ndim, plan.spec.order, plan.steps
    w = steps * r
    out = [int(s) - (0 if plan.wrap else 2 * w)
           for s in x_shape[len(x_shape) - nd:]]
    blocks = _launch_blocks(plan, out)
    slab = [b + 2 * w for b in plan.block]
    table = _table_words(plan) * 4
    written = (plan.batch or 1) * int(np.prod(out)) * itemsize
    walk = sweep_walk_of(plan, out, sms)
    if walk:
        b0 = plan.block[0]
        tiles0 = -(-out[0] // b0)
        lens = [min(walk, tiles0 - t0) * b0 for t0 in range(0, tiles0, walk)]
        live = sum((n + 2 * (steps - 1 - s) * r) * e[-1]
                   for n in lens for s, e in enumerate(plan.step_exts))
        strips = blocks // tiles0
        reads = sum(n + 2 * w for n in lens) * slab[-1] * itemsize
        return LaunchCost(
            fmas=len(plan.taps) * live * strips,
            bytes=strips * (reads + len(lens) * table
                            + plan.n_aux * live * 4) + written)
    live = sum(int(np.prod(e)) for e in plan.step_exts)
    per_block = (int(np.prod(slab)) * itemsize + plan.n_aux * live * 4
                 + table)
    return LaunchCost(fmas=len(plan.taps) * live * blocks,
                      bytes=blocks * per_block + written)


def _priced(name: str, cost):
    """Report a wrapper's :class:`LaunchCost` (``cost(plan, x)``) to the
    thread's recorders around every call, kernel or plain version."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(x, plan, aux=()):
            with launch_cost.kernel_region(name, lambda: cost(plan, x)):
                return fn(x, plan, aux)
        return call
    return wrap


@functools.lru_cache(maxsize=None)
def _cuda_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Multiprocessors of ``device``'s card; :data:`mx.H100_SMS` for a
    device that is not a card (the plain versions price the card's
    launch)."""
    device = torch.device(device)
    if device.type != "cuda":
        return mx.H100_SMS
    return _cuda_sms(torch.cuda.current_device() if device.index is None
                     else device.index)


def step_walk_of(plan: KernelPlan, out_shape: Sequence[int],
                 sms: int) -> int:
    """The walk :func:`stencil_cuda_call` launches ``plan`` with on an
    output of spatial ``out_shape`` and a card of ``sms`` multiprocessors
    (:func:`mx.step_walk`; 0: one tile a block)."""
    return mx.step_walk(_as3(out_shape, 1), _as3(plan.block, 1),
                        plan.spec.order if plan.spec.ndim == 3 else 0,
                        plan.batch or 1, sms)


def sweep_walk_of(plan: SweepKernelPlan, out_shape: Sequence[int],
                  sms: int) -> int:
    """The walk :func:`sweep_cuda_call` launches ``plan`` with on an output
    of spatial ``out_shape`` and a card of ``sms`` multiprocessors
    (:func:`mx.sweep_walk`; 0: one tile a block).  The walking kernel
    keeps one tap a position, so a plan whose cover puts two taps at one
    offset keeps the slab."""
    if len({g for _, g in plan.taps}) < len(plan.taps):
        return 0
    return mx.sweep_walk(tuple(int(o) for o in out_shape), plan.block,
                         plan.steps, plan.spec.order, plan.batch or 1, sms)


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
    """The plain PyTorch version of :func:`stencil_cuda_call`, on the same
    input contract: in wrap mode it pads the periodic halo first.  Then
    the same taps in the same order over the whole haloed tensor, f32
    accumulation, field then mask, cast to ``x.dtype``."""
    out_shape = _step_shape(x, plan)
    _check_aux(aux, plan, out_shape, "output spatial shape")
    if plan.wrap:
        x = halo.pad_halo(x, plan.spec.order, plan.spec.ndim, "periodic")
    acc = _accumulate(x.to(torch.float32), plan.taps,
                      (0,) * plan.spec.ndim, out_shape)
    for a in aux:
        acc = acc * a.to(torch.float32)
    return acc.to(x.dtype)


@_priced("stencil_step", lambda plan, x: step_launch_cost(
    plan, tuple(x.shape), x.element_size(), sm_count(x.device)))
def stencil_cuda_call(x: torch.Tensor, plan: KernelPlan,
                      aux: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Run the matrixized stencil step over a spatial tensor.

    ``x``: with ``plan.wrap`` the unpadded periodic state ``([B,] S_0,
    ...)``, any extents; else the haloed input ``([B,] S_0 + 2r, ...,
    S_{d-1} + 2r)`` with every ``S_a`` a multiple of ``plan.block[a]``
    (``kernels.ops`` pads).  Returns ``([B,] S_0, ..., S_{d-1})`` in
    ``x.dtype``.  ``aux``: ``plan.n_aux`` output-aligned f32 operands
    (field, then mask) of the output's spatial shape.

    A CPU tensor runs :func:`stencil_step_plain`; a CUDA tensor launches
    ``csrc/stencil_step.cu`` or raises, walking axis 0 where
    :func:`step_walk_of` says so (the outputs are the same bits either
    way).
    """
    if x.device.type == "cpu":
        return stencil_step_plain(x, plan, aux)
    walk = step_walk_of(plan, _step_shape(x, plan), sm_count(x.device))
    out = step_kernel(x, plan, aux, walk)
    stencil_cuda_call.launches += 1
    stencil_cuda_call.wrap_launches += plan.wrap
    stencil_cuda_call.walk_launches += walk > 0
    return out


def step_kernel(x: torch.Tensor, plan: KernelPlan,
                aux: Sequence[torch.Tensor], walk: int) -> torch.Tensor:
    """One launch of ``csrc/stencil_step.cu`` on a CUDA tensor, each block
    walking ``walk`` tiles along axis 0 (0: one tile a block, the slab
    path), uncounted and unpriced: :func:`stencil_cuda_call` picks the
    walk; the card's checks hold one walk against another here."""
    r = plan.spec.order
    out_shape = _step_shape(x, plan)
    _check_aux(aux, plan, out_shape, "output spatial shape")
    batch = plan.batch or 1
    _check_cuda_operands(x, aux, batch)
    table, n_runs = tap_table(plan, x.device)
    # wrap mode: one 16-byte unit more, for the last slab row's lead
    smem = (mx.step_ring_smem_bytes if walk else mx.step_smem_bytes)(
        plan.block, r, table_words=table.numel()) \
        + (16 if step_lead(plan) else 0)
    if smem > mx.SMEM_BYTES:
        raise ValueError(f"block {plan.block} at halo {r} needs {smem} B of "
                         f"shared memory (limit {mx.SMEM_BYTES})")
    out = torch.empty(tuple(x.shape[:x.ndim - plan.spec.ndim]) + out_shape,
                      dtype=x.dtype, device=x.device)
    # whole-chunk vector loads and stores need 16-byte aligned rows of
    # STEP_V outputs; 16-byte slab copies need 16-byte aligned input rows
    # (in wrap mode the kernel stores each slab row step_lead words in, so
    # that its columns agree with the input's modulo 4)
    vec = int(out_shape[-1] % mx.STEP_V == 0
              and plan.block[-1] % mx.STEP_V == 0
              and all(t.data_ptr() % 16 == 0 for t in (out, *aux)))
    aligned = int(x.shape[-1] % 4 == 0 and plan.block[-1] % 4 == 0
                  and x.data_ptr() % 16 == 0)
    fn = _launcher("stencil_step", "stencil_step_launch", 7)
    _launch(fn, "stencil_step", x, out, aux, table, len(plan.taps), batch,
            out_shape, plan.block, _as3((r,) * plan.spec.ndim, 0), n_runs,
            mx.step_slab_pitch(plan.block, r), vec, aligned, int(plan.wrap),
            step_lead(plan), int(walk))
    return out


stencil_cuda_call.launches = 0
stencil_cuda_call.wrap_launches = 0
stencil_cuda_call.walk_launches = 0


# ---------------------------------------------------------------------------
# Kernel 2: T base steps in one kernel (fuse_strategy="inkernel")
# ---------------------------------------------------------------------------

def sweep_aux_shape(out_shape: Sequence[int], plan: SweepKernelPlan
                    ) -> tuple[int, ...]:
    """Spatial shape of the sweep's slab-aligned aux operands for an output
    of ``out_shape``: the output rounded up to whole tiles, plus the
    ``steps*r`` halo per side."""
    w = plan.steps * plan.spec.order
    return tuple(-(-o // b) * b + 2 * w
                 for o, b in zip(out_shape, plan.block))


def _sweep_shapes(x: torch.Tensor, plan: SweepKernelPlan, aux):
    """Validate a sweep's input and aux operands against the plan's input
    contract; returns the spatial output shape."""
    w = plan.steps * plan.spec.order
    if plan.wrap:
        out_shape = _check_state(x, plan, "sweep")
    else:
        out_shape = _check_input(x, plan, w)
    _check_aux(aux, plan, sweep_aux_shape(out_shape, plan),
               "slab-aligned aux shape")
    return out_shape


def sweep_plain(x: torch.Tensor, plan: SweepKernelPlan,
                aux: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """The plain PyTorch version of :func:`sweep_cuda_call`, on the same
    input contract: in wrap mode it pads the periodic halo first.  Then
    ``steps`` whole-tensor applications of the same taps, f32
    intermediates, each step scaled by the aux sub-slice at offset
    ``(s+1)*r``, one cast at the end."""
    r, steps = plan.spec.order, plan.steps
    out_shape = _sweep_shapes(x, plan, aux)
    if plan.wrap:
        x = halo.pad_halo(x, steps * r, plan.spec.ndim, "periodic")
    taps = plan.taps
    cur = x.to(torch.float32)
    for s in range(steps):
        ext = tuple(n + 2 * (steps - 1 - s) * r for n in out_shape)
        cur = _accumulate(cur, taps, (0,) * plan.spec.ndim, ext)
        for a in aux:
            cur = cur * a[tuple(slice((s + 1) * r, (s + 1) * r + n)
                                for n in ext)].to(torch.float32)
    return cur.to(x.dtype)


@_priced("stencil_sweep", lambda plan, x: sweep_launch_cost(
    plan, tuple(x.shape), x.element_size(), sm_count(x.device)))
def sweep_cuda_call(x: torch.Tensor, plan: SweepKernelPlan,
                    aux: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Advance a spatial tensor by ``plan.steps`` base steps in one kernel.

    ``x``: with ``plan.wrap`` the unpadded periodic state ``([B,] S_0,
    ...)``, any extents; else the haloed input ``([B,] S_0 + 2Tr, ...)``
    with ``S_a`` multiples of the block.  Returns ``([B,] S_0, ...)`` —
    the state after T valid-mode applications.  ``aux``: ``plan.n_aux``
    slab-aligned f32 operands of :func:`sweep_aux_shape` (no batch axis).

    A CPU tensor runs :func:`sweep_plain`; a CUDA tensor launches
    ``csrc/stencil_sweep.cu`` or raises.  A 2-D launch walks axis 0 where
    :func:`sweep_walk_of` says so (orders 1 to 4, rings that fit; the
    outputs are the same bits either way): a block streams its strip of
    tiles through rings of rows, so each row of each step is loaded or
    computed once along the walk, and its loads run under the taps.
    """
    if x.device.type == "cpu":
        return sweep_plain(x, plan, aux)
    walk = sweep_walk_of(plan, _sweep_shapes(x, plan, aux),
                         sm_count(x.device))
    out = sweep_kernel(x, plan, aux, walk)
    sweep_cuda_call.launches += 1
    sweep_cuda_call.walk_launches += walk > 0
    return out


def sweep_kernel(x: torch.Tensor, plan: SweepKernelPlan,
                 aux: Sequence[torch.Tensor], walk: int) -> torch.Tensor:
    """One launch of ``csrc/stencil_sweep.cu`` on a CUDA tensor, each block
    walking ``walk`` tiles along axis 0 of a 2-D state (0: one tile a
    block, the slab path), uncounted and unpriced: :func:`sweep_cuda_call`
    picks the walk; the card's checks hold one walk against another
    here."""
    r, steps = plan.spec.order, plan.steps
    out_shape = _sweep_shapes(x, plan, aux)
    batch = plan.batch or 1
    _check_cuda_operands(x, aux, batch)
    if walk:
        smem = mx.sweep_ring_smem_bytes(plan.block, steps, r)
        if plan.spec.ndim != 2 or not 1 <= r <= mx.SWEEP_WALK_MAX_ORDER \
                or smem > mx.SMEM_BYTES:
            raise ValueError(f"block {plan.block} at {steps} steps of order "
                             f"{r} cannot walk ({plan.spec.ndim}-D, {smem} B"
                             f" of rings, limit {mx.SMEM_BYTES})")
    elif not mx.sweep_feasible(plan.block, steps, r, plan.scratch):
        raise ValueError(
            f"block {plan.block} at {steps} steps of order {r} does not fit "
            f"the sweep kernel under scratch={plan.scratch!r} "
            f"({mx.sweep_smem_bytes(plan.block, steps, r, plan.scratch)} B "
            f"of shared memory, limit {mx.SMEM_BYTES}; "
            f"{mx.sweep_items(plan.block, steps, r)} work items)")
    table, n_runs = tap_table(plan, x.device)
    out = torch.empty(tuple(x.shape[:x.ndim - plan.spec.ndim]) + out_shape,
                      dtype=x.dtype, device=x.device)
    w2 = steps * r
    # 16-byte slab copies need 16-byte aligned input rows and tiles; the
    # kernel then stores each slab row `lead` words in, so that its columns
    # agree with the input's modulo 4
    aligned = int(x.dtype == torch.float32 and x.shape[-1] % 4 == 0
                  and plan.block[-1] % 4 == 0 and x.data_ptr() % 16 == 0)
    lead = (-w2) % 4 if plan.wrap and aligned else 0
    vec = int(out_shape[-1] % mx.STEP_V == 0
              and plan.block[-1] % mx.STEP_V == 0 and out.data_ptr() % 16 == 0)
    fn = _launcher("stencil_sweep", "stencil_sweep_launch", 9)
    _launch(fn, "stencil_sweep", x, out, aux, table, len(plan.taps), batch,
            out_shape, plan.block, _as3((r,) * plan.spec.ndim, 0), n_runs,
            steps, int(plan.scratch == "single"), int(plan.wrap),
            mx.sweep_slab_pitch(plan.block, steps, r), lead, vec, aligned,
            int(walk))
    return out


sweep_cuda_call.launches = 0
sweep_cuda_call.walk_launches = 0
