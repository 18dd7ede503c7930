"""Distributed stencil execution: domain decomposition + halo exchange.

The paper's in-core scheduling (§4.3: fix the output block, stream inputs)
scales out unchanged: each mesh slot owns a block of the grid, halos are
the inter-slot analogue of the overlapping tile windows, and the exchange
moves two strips per sharded axis between mesh neighbours.

The port of the JAX package's ``core/distributed.py`` keeps its
execution model: ONE process drives a :class:`~repro_torch.launch.mesh
.DeviceMesh` of device slots (a slot may repeat a device), a global state
lives as a :class:`ShardedState` of blocks indexed by mesh coordinate
(the stand-in for a ``NamedSharding``-placed array), and a strip moves by
a tensor copy where the reference's ``lax.ppermute`` moves it — between
two cards a peer-to-peer transfer, on one card a device-to-device copy.

Fused distributed sweeps: a chunk of ``T`` steps exchanges ONE
``T*r``-deep halo and then runs the chunk's valid-mode core (the T-fold
fused operator through the step kernel, or T base steps through the sweep
kernel in explicit-halo mode) on each slot's deep-haloed block —
communication drops T-fold alongside the device-memory traffic.  The
haloed block is a buffer allocated once per stepper and slot at the
schedule's deepest halo; every chunk writes the block into its centre and
the strips into its frames in place.  Strips of the second sharded axis
are cut from buffers whose first-axis frames are already filled, so the
corners arrive without diagonal messages.  For Dirichlet-0 boundaries
the fused chunk is exact only at distance >= ``T*r`` from the *global*
boundary, so edge strips are re-evolved by ``T`` unfused base steps over
the already-exchanged deep halo, each step clamped through a
global-position mask (the mask is all ones away from the global edge, so
every slot runs the same code).

``overlap=True`` overlaps the exchange with compute on the card: every
slot's buffer fill and strip copies are issued first, on one copy stream
per slot, and each slot's chunk launch on the compute stream waits only
on the event of its own strips — slot *k*'s kernel runs while slot
*k+1*'s strips move.  The work is the same as ``overlap=False`` (no
second interior launch), so the two are bit-identical.

:data:`exchange_counts` is the exchange census, the counterpart of the
reference's ``ppermute`` count in a jaxpr: per fused chunk and named
mesh axis one ``exchange`` of two ``permutes`` (forward and backward),
plus the strips written and their bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import temporal
from repro_torch.core.engine import StencilEngine
from repro_torch.core.stencil_spec import StencilSpec
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.runtime import chaos
from repro_torch.runtime.chaos import FaultError

__all__ = ["ShardedState", "MeshSharding", "shard", "unshard", "reshard",
           "halo_exchange", "distributed_stencil_step",
           "distributed_fused_chunk", "make_distributed_stepper",
           "make_fused_distributed_stepper", "DistributedStepper",
           "exchange_counts", "reset_exchange_counts"]

Tensor = torch.Tensor

#: The exchange census (see the module docstring); zero it with
#: :func:`reset_exchange_counts`.
exchange_counts = {"exchanges": 0, "permutes": 0, "strips": 0, "bytes": 0}


def reset_exchange_counts() -> None:
    for k in exchange_counts:
        exchange_counts[k] = 0


# ---------------------------------------------------------------------------
# Sharded states
# ---------------------------------------------------------------------------

def _mesh_axis_index(mesh: DeviceMesh, name: str) -> int:
    if name not in mesh.axis_names:
        raise ValueError(f"grid axis {name!r} is not a mesh axis "
                         f"{mesh.axis_names}")
    return mesh.axis_names.index(name)


def _block_index(coord: tuple[int, ...], mesh: DeviceMesh,
                 grid_axes: tuple[str, ...], local: Sequence[int],
                 lead: int) -> tuple:
    """The global slices one mesh coordinate's block covers."""
    idx = [slice(None)] * lead
    for ax, n in zip(grid_axes, local):
        j = _mesh_axis_index(mesh, ax) if ax else None
        k = coord[j] if j is not None else 0
        idx.append(slice(k * n, (k + 1) * n))
    return tuple(idx)


@dataclasses.dataclass(eq=False)
class ShardedState:
    """A global state as blocks on a mesh's slots.

    ``blocks[coord]`` is the block of mesh coordinate ``coord`` on
    ``mesh.devices[coord]``; spatial axis ``a`` is split over the mesh
    axis ``grid_axes[a]`` (``''``: unsplit), and a leading batch axis
    (``batch``) is replicated — every block carries all states.  Mesh
    axes no grid axis names hold replicas.
    """
    blocks: np.ndarray
    mesh: DeviceMesh
    grid_axes: tuple[str, ...]
    batch: bool = False

    @property
    def local_shape(self) -> tuple[int, ...]:
        return tuple(self.blocks.flat[0].shape)

    @property
    def shape(self) -> tuple[int, ...]:
        """The global shape."""
        local = self.local_shape
        lead = len(local) - len(self.grid_axes)
        sizes = self.mesh.axis_sizes()
        return local[:lead] + tuple(
            n * (sizes[ax] if ax else 1)
            for n, ax in zip(local[lead:], self.grid_axes))

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.flat[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.local_shape)

    def map(self, fn: Callable[[Tensor], Tensor]) -> "ShardedState":
        """The state with ``fn`` applied to every block."""
        out = np.empty(self.blocks.shape, dtype=object)
        for c in np.ndindex(self.blocks.shape):
            out[c] = fn(self.blocks[c])
        return dataclasses.replace(self, blocks=out)

    def to(self, device) -> "ShardedState":
        """The same layout with every block moved to ``device`` (the
        mesh's slots keep their ids)."""
        dev = torch.device(device)
        devs = np.empty(self.mesh.devices.shape, dtype=object)
        devs[...] = dev
        mesh = DeviceMesh(devs, self.mesh.axis_names, self.mesh.slots)
        out = self.map(lambda b: b.to(dev))
        return dataclasses.replace(out, mesh=mesh)

    def unique_blocks(self):
        """``(coord, global slices, block)`` of every block once: replicas
        (mesh axes no grid axis names) at coordinate 0 only."""
        named = {_mesh_axis_index(self.mesh, ax)
                 for ax in self.grid_axes if ax}
        local = self.local_shape
        lead = len(local) - len(self.grid_axes)
        for c in np.ndindex(self.blocks.shape):
            if any(k and j not in named for j, k in enumerate(c)):
                continue
            yield c, _block_index(c, self.mesh, self.grid_axes,
                                  local[lead:], lead), self.blocks[c]


@dataclasses.dataclass(frozen=True, eq=False)
class MeshSharding:
    """Where a state lives on a mesh — the stand-in for a
    ``NamedSharding``: :meth:`place` shards a tensor (or re-shards a
    :class:`ShardedState`) onto it."""
    mesh: DeviceMesh
    grid_axes: tuple[str, ...]

    def place(self, x) -> ShardedState:
        if isinstance(x, ShardedState):
            return reshard(x, self.mesh)
        return shard(x, self.mesh, self.grid_axes)


def shard(x: Tensor, mesh: DeviceMesh, grid_axes: Sequence[str],
          batch: bool | None = None) -> ShardedState:
    """Split a global tensor into the blocks of ``mesh`` (copies, one a
    slot).  ``batch`` marks a leading batch axis; by default it is
    inferred from the rank (one more axis than ``grid_axes``)."""
    grid_axes = tuple(grid_axes)
    nd = len(grid_axes)
    lead = x.ndim - nd
    if batch is None:
        batch = lead == 1
    if lead != int(bool(batch)):
        extra = " and a batch axis" if batch else ""
        raise ValueError(f"a state of shape {tuple(x.shape)} does not fit "
                         f"{nd} grid axes{extra}")
    sizes = mesh.axis_sizes()
    local = []
    for n, ax in zip(x.shape[lead:], grid_axes):
        d = sizes[ax] if ax else 1
        if ax and ax not in sizes:
            raise ValueError(f"grid axis {ax!r} is not a mesh axis "
                             f"{mesh.axis_names}")
        if n % d:
            raise ValueError(f"grid extent {n} not divisible by mesh axis "
                             f"{ax!r} of size {d}")
        local.append(n // d)
    blocks = np.empty(mesh.shape, dtype=object)
    for c in np.ndindex(mesh.shape):
        idx = _block_index(c, mesh, grid_axes, local, lead)
        part = x[idx]
        b = torch.empty(part.shape, dtype=x.dtype, device=mesh.devices[c])
        b.copy_(part)
        blocks[c] = b
    return ShardedState(blocks, mesh, grid_axes, bool(batch))


def unshard(state: ShardedState, device=None) -> Tensor:
    """The global tensor of a sharded state, on ``device`` (by default
    the lead slot's device)."""
    dev = torch.device(device) if device is not None else \
        state.mesh.devices.flat[0]
    out = torch.empty(state.shape, dtype=state.dtype, device=dev)
    for _, idx, b in state.unique_blocks():
        out[idx].copy_(b)
    return out


def reshard(state: ShardedState, mesh: DeviceMesh) -> ShardedState:
    """The state re-split over another mesh with the same axis names
    (elastic re-mesh: a shrunk mesh, bigger blocks)."""
    if tuple(mesh.axis_names) == tuple(state.mesh.axis_names) and \
            mesh.shape == state.mesh.shape and \
            list(mesh.devices.flat) == list(state.mesh.devices.flat):
        return state
    return shard(unshard(state), mesh, state.grid_axes, state.batch)


# ---------------------------------------------------------------------------
# The halo layer on a mesh
# ---------------------------------------------------------------------------

def _frame(nd: int, axis: int, lo: int, hi: int) -> list:
    idx = [slice(None)] * nd
    idx[axis] = slice(lo, hi)
    return idx


class _Halo:
    """The deep-haloed buffers of one stepper: one flat tensor a mesh
    coordinate, sized at the schedule's deepest halo, viewed at each
    chunk's width (a contiguous prefix, so a kernel reads it in place)."""

    def __init__(self, mesh: DeviceMesh, mesh_axes: dict[int, str],
                 spec_ndim: int, periodic: bool, max_width: int):
        self.mesh = mesh
        self.mesh_axes = dict(sorted(mesh_axes.items()))
        self.spec_ndim = spec_ndim
        self.periodic = periodic
        self.max_width = max_width
        self._flat: dict[tuple, Tensor] = {}
        self._key = None
        self._copy_streams: dict[tuple, torch.cuda.Stream] = {}
        #: per coordinate, the event its chunk launch waits on (the
        #: streamed exchange's last phase)
        self.ready: dict[tuple, torch.cuda.Event] = {}

    def buffers(self, blocks: np.ndarray, w: int) -> dict[tuple, Tensor]:
        b0 = blocks.flat[0]
        key = (tuple(b0.shape), b0.dtype)
        if key != self._key:
            self._flat.clear()
            self._key = key
        nd = b0.ndim
        lead = nd - self.spec_ndim
        full = list(b0.shape[:lead]) + [
            n + 2 * self.max_width for n in b0.shape[lead:]]
        shape = tuple(b0.shape[:lead]) + tuple(
            n + 2 * w for n in b0.shape[lead:])
        numel = int(np.prod(shape))
        out = {}
        for c in np.ndindex(blocks.shape):
            flat = self._flat.get(c)
            if flat is None:
                flat = self._flat[c] = torch.empty(
                    int(np.prod(full)), dtype=b0.dtype,
                    device=blocks[c].device)
                if flat.device.type == "cuda":
                    # written on the slot's copy stream: freeing it (a new
                    # block shape) must wait for that stream's work too
                    flat.record_stream(self.copy_stream(c, flat.device))
            out[c] = flat[:numel].view(shape)
        return out

    def copy_stream(self, c, device) -> torch.cuda.Stream:
        s = self._copy_streams.get(c)
        if s is None:
            s = self._copy_streams[c] = torch.cuda.Stream(device=device)
        return s


def _fill_centre(h: Tensor, block: Tensor, w: int, spec_ndim: int,
                 mesh_axes: dict[int, str], periodic: bool) -> None:
    """Write ``block`` into the buffer's centre and pad the spatial axes
    that are NOT sharded locally (wrap for periodic, zeros for
    Dirichlet-0 — the semantics the exchange gives sharded axes): an
    unsharded axis lives entirely in every block."""
    nd = h.ndim
    lead = nd - spec_ndim
    centre = [slice(None)] * nd
    for a in range(lead, nd):
        centre[a] = slice(w, w + block.shape[a])
    h[tuple(centre)].copy_(block)
    if w == 0:
        return
    rng = list(centre)
    for a in range(lead, nd):
        if a in mesh_axes:
            continue
        n = block.shape[a]
        lo, hi = list(rng), list(rng)
        lo[a], hi[a] = slice(0, w), slice(n + w, n + 2 * w)
        if periodic:
            src_lo, src_hi = list(rng), list(rng)
            src_lo[a], src_hi[a] = slice(n, n + w), slice(w, 2 * w)
            h[tuple(lo)].copy_(h[tuple(src_lo)])
            h[tuple(hi)].copy_(h[tuple(src_hi)])
        else:
            h[tuple(lo)].zero_()
            h[tuple(hi)].zero_()
        rng[a] = slice(None)      # later local pads carry this axis's pad


def _exchange_axis(bufs: dict[tuple, Tensor], mesh: DeviceMesh, axis: int,
                   mesh_axis: str, w: int, done_axes: Sequence[int],
                   sharded: Sequence[int], periodic: bool,
                   interior: Sequence[int], coords=None) -> None:
    """Fill every buffer's two ``w``-deep frames of array axis ``axis``
    from its mesh neighbours along ``mesh_axis``: the low frame from the
    previous coordinate's high strip and the high frame from the next
    one's low strip (``lax.ppermute``'s ``fwd``/``bwd`` pairs).  A
    size-1 axis exchanges with itself; with Dirichlet-0 the global edges
    receive zeros.  The strips span the full haloed extent of every other
    axis except the ``sharded`` ones not yet exchanged (not in
    ``done_axes``), so corners travel with the second axis's strips."""
    j = _mesh_axis_index(mesh, mesh_axis)
    n_dev = mesh.shape[j]
    nd = len(interior)
    rng = [slice(None)] * nd
    for a in sharded:
        if a != axis and a not in done_axes:
            rng[a] = slice(w, w + interior[a])
    n = interior[axis]
    for c in (coords if coords is not None else bufs):
        h = bufs[c]
        lo, hi = list(rng), list(rng)
        lo[axis], hi[axis] = slice(0, w), slice(n + w, n + 2 * w)
        prev = list(c)
        prev[j] = (c[j] - 1) % n_dev
        nxt = list(c)
        nxt[j] = (c[j] + 1) % n_dev
        src_hi, src_lo = list(rng), list(rng)
        src_hi[axis], src_lo[axis] = slice(n, n + w), slice(w, 2 * w)
        if periodic or c[j] > 0:
            h[tuple(lo)].copy_(bufs[tuple(prev)][tuple(src_hi)])
        else:
            h[tuple(lo)].zero_()
        if periodic or c[j] < n_dev - 1:
            h[tuple(hi)].copy_(bufs[tuple(nxt)][tuple(src_lo)])
        else:
            h[tuple(hi)].zero_()
        exchange_counts["strips"] += 2
        exchange_counts["bytes"] += 2 * h[tuple(lo)].numel() * h.element_size()


def halo_exchange(state: ShardedState, r: int, *,
                  periodic: bool = True) -> ShardedState:
    """Every block padded with width-``r`` halos: fetched from mesh
    neighbours on sharded axes, applied locally on the others."""
    spec_ndim = len(state.grid_axes)
    lead = state.ndim - spec_ndim
    mesh_axes = {i + lead: ax for i, ax in enumerate(state.grid_axes) if ax}
    halo = _Halo(state.mesh, mesh_axes, spec_ndim, periodic, r)
    bufs = _haloed_input(state.blocks, r, halo)
    out = np.empty(state.blocks.shape, dtype=object)
    for c, h in bufs.items():
        out[c] = h.clone()
    return dataclasses.replace(state, blocks=out)


def _haloed_input(blocks: np.ndarray, w: int, halo: _Halo
                  ) -> dict[tuple, Tensor]:
    """The blocks extended by ``w`` on every spatial axis (in ``halo``'s
    buffers): local pads on unsharded axes, neighbour exchange on sharded
    axes, in array-axis order."""
    bufs = halo.buffers(blocks, w)
    b0 = blocks.flat[0]
    with record_function("dist.halo_fill"):
        for c, h in bufs.items():
            _fill_centre(h, blocks[c], w, halo.spec_ndim, halo.mesh_axes,
                         halo.periodic)
    interior = dict(enumerate(b0.shape))
    done: list[int] = []
    with record_function("dist.exchange"):
        for axis, mesh_axis in halo.mesh_axes.items():
            _exchange_axis(bufs, halo.mesh, axis, mesh_axis, w, done,
                           list(halo.mesh_axes), halo.periodic, interior)
            exchange_counts["exchanges"] += 1
            exchange_counts["permutes"] += 2
            done.append(axis)
    return bufs


def _mask_outside_domain(s: Tensor, start_off: dict[int, int],
                         axinfo: dict[int, tuple]) -> Tensor:
    """Zero every position of ``s`` that lies outside the GLOBAL domain.

    ``start_off[axis]`` is the global offset of s's local index 0 relative
    to this block's owned start; ``axinfo[axis] = (shard index, n_owned,
    n_global)``.  Multiplying by the mask before each unfused step is
    exactly per-step Dirichlet-0 clamping (the mask is all ones on blocks
    away from the global edge)."""
    out = s
    for axis, (idx, n_owned, n_global) in axinfo.items():
        g0 = idx * n_owned + start_off[axis]
        pos = g0 + torch.arange(s.shape[axis], device=s.device)
        mask = (pos >= 0) & (pos < n_global)
        shape = [1] * s.ndim
        shape[axis] = s.shape[axis]
        out = out * mask.reshape(shape).to(s.dtype)
    return out


def _axis_info(block_shape: Sequence[int], coord: tuple[int, ...],
               mesh: DeviceMesh, spec_ndim: int,
               mesh_axes: dict[int, str]) -> dict[int, tuple]:
    nd = len(block_shape)
    info = {}
    for axis in range(nd - spec_ndim, nd):
        n_owned = block_shape[axis]
        if axis in mesh_axes:
            j = _mesh_axis_index(mesh, mesh_axes[axis])
            n_dev, idx = mesh.shape[j], coord[j]
        else:
            n_dev, idx = 1, 0
        info[axis] = (idx, n_owned, n_owned * n_dev)
    return info


def _zero_boundary_strips(y: Tensor, haloed: Tensor, *, t: int, r: int,
                          base_core: Callable, spec_ndim: int,
                          axinfo: dict[int, tuple]) -> Tensor:
    """Splice per-step-clamped edge strips over the fused Dirichlet-0
    output.

    Each spatial axis and side re-evolves a ``3*t*r``-deep slab of the
    deep-haloed block by ``t`` unfused valid steps, consuming the
    already-exchanged ``t*r`` halo on the other axes and clamping
    out-of-domain positions to zero before every step.  The resulting
    ``t*r``-wide strip is exact on EVERY block (away from the global edge
    the mask is a no-op and the trapezoid reproduces the fused values),
    so the splice needs no per-block branching."""
    nd = y.ndim
    lead = nd - spec_ndim
    w = t * r
    for axis in range(lead, nd):
        n_own = y.shape[axis]
        h_ext = haloed.shape[axis]
        for side in (0, 1):
            s = haloed[tuple(_frame(nd, axis, 0, 3 * w) if side == 0 else
                             _frame(nd, axis, h_ext - 3 * w, h_ext))]
            start = {a: -w for a in axinfo}
            start[axis] = -w if side == 0 else n_own - 2 * w
            for _ in range(t):
                s = base_core(_mask_outside_domain(s, start, axinfo))
                for a in start:
                    start[a] += r
            y[tuple(_frame(nd, axis, 0, w) if side == 0 else
                    _frame(nd, axis, n_own - w, n_own))].copy_(s)
    return y


def _check_depth(block_shape: Sequence[int], w: int, spec_ndim: int) -> None:
    nd = len(block_shape)
    for axis in range(nd - spec_ndim, nd):
        if block_shape[axis] < w:
            raise ValueError(
                f"local block extent {block_shape[axis]} on axis {axis} is "
                f"smaller than the fused halo {w}; lower the fuse depth")


def distributed_fused_chunk(state: ShardedState, *, t: int,
                            base_core: Callable, fused_core: Callable,
                            spec: StencilSpec, periodic: bool = True,
                            overlap: bool = True,
                            halo: "_Halo | None" = None) -> ShardedState:
    """Advance every block by ``t`` steps with ONE ``t*r`` halo exchange.

    ``fused_core`` (the T-fold operator's or the sweep kernel's
    valid-mode core, order ``t*r``) runs on each deep-haloed block;
    Dirichlet-0 edge strips are fixed up per-step-exactly (``t > 1`` only
    — for a single step zero-extension IS per-step clamping).  ``halo``
    carries the buffers across chunks (a stepper passes its own).

    Requires every local spatial extent ``>= t * spec.order``.
    """
    r = spec.order
    w = t * r
    blocks = state.blocks
    b0 = blocks.flat[0]
    _check_depth(b0.shape, w, spec.ndim)
    lead = b0.ndim - spec.ndim
    mesh_axes = {i + lead: ax for i, ax in enumerate(state.grid_axes) if ax}
    if halo is None:
        halo = _Halo(state.mesh, mesh_axes, spec.ndim, periodic, w)
    streamed = overlap and b0.device.type == "cuda"
    if streamed:
        bufs = _haloed_input_streamed(blocks, w, halo)
    else:
        bufs = _haloed_input(blocks, w, halo)
    out = np.empty(blocks.shape, dtype=object)
    for c, h in bufs.items():
        if streamed:
            torch.cuda.current_stream(h.device).wait_event(halo.ready[c])
        y = fused_core(h)
        if not periodic and t > 1:
            with record_function("dist.zero_strips"):
                y = _zero_boundary_strips(
                    y.clone(), h, t=t, r=r, base_core=base_core,
                    spec_ndim=spec.ndim,
                    axinfo=_axis_info(b0.shape, c, state.mesh, spec.ndim,
                                      mesh_axes))
        out[c] = y
    return dataclasses.replace(state, blocks=out)


def _haloed_input_streamed(blocks: np.ndarray, w: int, halo: _Halo
                           ) -> dict[tuple, Tensor]:
    """:func:`_haloed_input` on one copy stream per slot: each slot's
    fill waits for the compute stream's previous work, each axis's strips
    wait for the neighbours' previous phase, and ``halo.ready[c]`` is the
    event the slot's chunk launch waits on."""
    bufs = halo.buffers(blocks, w)
    b0 = blocks.flat[0]
    coords = list(bufs)
    start = {}
    for c in coords:
        dev = blocks[c].device
        if dev not in start:
            start[dev] = torch.cuda.current_stream(dev).record_event()
    phase = {}
    with record_function("dist.halo_fill"):
        for c in coords:
            s = halo.copy_stream(c, blocks[c].device)
            s.wait_event(start[blocks[c].device])
            with torch.cuda.stream(s):
                blocks[c].record_stream(s)
                _fill_centre(bufs[c], blocks[c], w, halo.spec_ndim,
                             halo.mesh_axes, halo.periodic)
                phase[c] = s.record_event()
    interior = dict(enumerate(b0.shape))
    done: list[int] = []
    mesh = halo.mesh
    with record_function("dist.exchange"):
        for axis, mesh_axis in halo.mesh_axes.items():
            j = _mesh_axis_index(mesh, mesh_axis)
            n_dev = mesh.shape[j]
            nxt_phase = {}
            for c in coords:
                s = halo.copy_stream(c, blocks[c].device)
                for dk in (-1, 1):
                    nb = list(c)
                    nb[j] = (c[j] + dk) % n_dev
                    s.wait_event(phase[tuple(nb)])
                with torch.cuda.stream(s):
                    _exchange_axis(bufs, mesh, axis, mesh_axis, w, done,
                                   list(halo.mesh_axes), halo.periodic,
                                   interior, coords=[c])
                    nxt_phase[c] = s.record_event()
            phase = nxt_phase
            exchange_counts["exchanges"] += 1
            exchange_counts["permutes"] += 2
            done.append(axis)
    halo.ready = phase
    return bufs


def distributed_stencil_step(state: ShardedState, *, engine: StencilEngine,
                             periodic: bool = True,
                             overlap: bool = True) -> ShardedState:
    """One sharded stencil step: the single-step case of
    :func:`distributed_fused_chunk`; spatial axes no mesh axis splits get
    their boundary applied locally."""
    if engine.plan.boundary != "valid":
        raise ValueError("distributed stepper needs a 'valid'-mode engine")
    core = engine._core
    return distributed_fused_chunk(state, t=1, base_core=core,
                                   fused_core=core, spec=engine.plan.spec,
                                   periodic=periodic, overlap=overlap)


# ---------------------------------------------------------------------------
# The stepper
# ---------------------------------------------------------------------------

class DistributedStepper:
    """A multi-slot stepper: ``schedule`` is the static chunk schedule one
    call advances through, one deep exchange a chunk.

    ``fn(x)`` runs it: a :class:`ShardedState` on the stepper's mesh comes
    back as one; a global tensor is sharded first and the result gathered
    back onto the input's device.

    Calling the stepper routes through the HOST-side chaos wrapper: with
    a :class:`repro_torch.runtime.chaos.FaultPlan` active, every call
    fires ``dist.device`` once and ``dist.chunk`` / ``dist.exchange``
    once per fused chunk (firing indices are per-rule call counts — exact
    and replayable), then runs the SAME stepper.  With no plan active the
    wrapper is one global read; either way the work of a call (and its
    exchange census) is untouched.
    """

    def __init__(self, chunk_fn: Callable, schedule: tuple[int, ...],
                 mesh: DeviceMesh, grid_axes: tuple[str, ...],
                 radius: int = 1, batch: int | None = None):
        self._chunk_fn = chunk_fn
        self.schedule = tuple(schedule)
        self.mesh = mesh
        self.grid_axes = tuple(grid_axes)
        self.radius = int(radius)
        self.batch = batch

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def sharding(self) -> MeshSharding:
        return MeshSharding(self.mesh, self.grid_axes)

    def run(self, state: ShardedState) -> ShardedState:
        """Advance a sharded state through the schedule."""
        if state.mesh.shape != self.mesh.shape or \
                state.mesh.axis_names != self.mesh.axis_names or \
                state.grid_axes != self.grid_axes:
            raise ValueError(
                f"state sharded over {state.mesh.describe()}"
                f"{state.mesh.axis_names} as {state.grid_axes}, stepper "
                f"runs on {self.mesh.describe()}{self.mesh.axis_names} as "
                f"{self.grid_axes}")
        for k, t in enumerate(self.schedule):
            state = self._chunk_fn(state, t)
        return state

    def fn(self, x):
        if isinstance(x, ShardedState):
            return self.run(x)
        st = shard(x, self.mesh, self.grid_axes, self.batch is not None)
        return unshard(self.run(st), x.device)

    def __call__(self, x):
        if chaos.active() is None:
            return self.fn(x)
        return self._chaos_call(x)

    def _chaos_call(self, x):
        """One stepper call with the mesh fault surface instrumented.

        ``raise`` kills the call before dispatch (a lost slot / failed
        chunk launch); ``delay`` models a slow exchange or straggling
        slot; ``corrupt`` (meaningful on ``dist.exchange``) models strips
        corrupted on the wire: the sweep runs to completion on a
        perturbed input — latency paid, result poisoned — then the
        transport checksum catches it and the call raises into the
        supervised retry path, discarding the poisoned result.
        """
        ctx = {"devices": self.n_devices, "mesh": self.mesh.describe()}
        corrupted: tuple[str, int] | None = None
        if chaos.fire("dist.device", **ctx) == "corrupt":
            corrupted = ("dist.device", 0)
        for k, t in enumerate(self.schedule):
            if chaos.fire("dist.chunk", chunk=k, depth=int(t),
                          **ctx) == "corrupt" and corrupted is None:
                corrupted = ("dist.chunk", k)
            if chaos.fire("dist.exchange", chunk=k,
                          width=int(t * self.radius),
                          **ctx) == "corrupt" and corrupted is None:
                corrupted = ("dist.exchange", k)
        if corrupted is not None:
            site, k = corrupted
            poisoned = (x.map(lambda b: b + 1) if isinstance(x, ShardedState)
                        else x + 1)
            y = self.fn(poisoned)
            for b in (y.blocks.flat if isinstance(y, ShardedState) else [y]):
                if b.device.type == "cuda":
                    torch.cuda.current_stream(b.device).synchronize()
            raise FaultError(site, k, "corrupted halo strips detected "
                                      "(transport checksum)")
        return self.fn(x)


def _engine_device(mesh: DeviceMesh) -> torch.device:
    return mesh.devices.flat[0]


def make_fused_distributed_stepper(spec: StencilSpec, mesh: DeviceMesh,
                                   grid_axes: Sequence[str], *,
                                   schedule: Sequence[int],
                                   option: str = "auto",
                                   fused_option: str = "auto",
                                   backend: str = "cuda",
                                   boundary: str = "periodic",
                                   block: tuple[int, ...] | None = None,
                                   fuse_strategy: str = "operator",
                                   batch: int | None = None,
                                   overlap: bool = True
                                   ) -> DistributedStepper:
    """Build the fused multi-slot sweep: one ``t*r`` exchange per chunk.

    ``schedule`` is the static list of chunk depths (e.g. ``[4, 4, 2]``
    for 10 steps at fuse depth 4) — the planner's
    ``ExecutionPlan.fuse_schedule`` feeds straight in.  ``fused_option``
    pins the cover of the deepest fused operator (remainder chunks
    re-cover automatically).

    ``fuse_strategy="inkernel"`` swaps every depth-t chunk core for the
    backend's in-kernel sweep in explicit-halo (valid) mode: it consumes
    exactly the deep-haloed block the fused operator would, so it still
    costs ONE exchange per chunk, and the Dirichlet-0 strips re-evolve
    through the same unfused base core.

    ``batch`` adds a leading replicated batch axis of that extent: every
    chunk still issues exactly ONE ``t*r``-deep exchange (the strips
    carry the batch axis), and the chunk cores fold the batch into one
    launch.  The cores run on each block's device; a block on a card
    launches the kernels or raises.
    """
    if boundary not in ("periodic", "zero"):
        raise ValueError("distributed sweeps need boundary='periodic'|'zero'")
    if fuse_strategy not in temporal.FUSE_STRATEGIES:
        raise ValueError(f"unknown fuse strategy {fuse_strategy!r}; choose "
                         f"from {temporal.FUSE_STRATEGIES}")
    schedule = tuple(int(t) for t in schedule)
    if any(t < 1 for t in schedule):
        raise ValueError(f"chunk depths must be >= 1, got {schedule}")
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    grid_axes = tuple(grid_axes)
    if len(grid_axes) != spec.ndim:
        raise ValueError("grid_axes needs one entry per spatial axis")
    for ax in grid_axes:
        if ax:
            _mesh_axis_index(mesh, ax)
    periodic = boundary == "periodic"

    dev = _engine_device(mesh)
    base = StencilEngine(spec, option=option, backend=backend, block=block,
                         boundary="valid", device=dev)
    depth_max = max(schedule) if schedule else 1
    cores: dict[int, Callable] = {1: base._core}
    for t in sorted(set(schedule)):
        if t > 1:
            if fuse_strategy == "inkernel":
                cores[t] = base.inkernel_core(t)
                continue
            opt = fused_option if t == depth_max else "auto"
            fused = StencilEngine(temporal.fuse_steps(spec, t), option=opt,
                                  backend=backend, block=base.plan.block,
                                  boundary="valid", device=dev)
            cores[t] = fused._core

    lead = 0 if batch is None else 1
    # mesh_axes keys are ARRAY axes: spatial index + the batch lead offset
    mesh_axes = {i + lead: ax for i, ax in enumerate(grid_axes) if ax}
    halo = _Halo(mesh, mesh_axes, spec.ndim, periodic,
                 depth_max * spec.order)

    def chunk(state: ShardedState, t: int) -> ShardedState:
        return distributed_fused_chunk(state, t=t, base_core=cores[1],
                                       fused_core=cores[t], spec=spec,
                                       periodic=periodic, overlap=overlap,
                                       halo=halo)

    return DistributedStepper(chunk, schedule, mesh, grid_axes,
                              radius=spec.order, batch=batch)


def make_distributed_stepper(spec: StencilSpec, mesh: DeviceMesh,
                             grid_axes: Sequence[str],
                             option: str = "auto", backend: str = "cuda",
                             periodic: bool = True, overlap: bool = True,
                             steps: int = 1) -> DistributedStepper:
    """A multi-slot stepper with a width-r exchange per step.

    ``grid_axes``: mesh axis name for each spatial array axis (``''``
    leaves an axis unsharded — its boundary is then applied locally).
    Kept as the simple per-step API; fused multi-step sweeps go through
    :func:`make_fused_distributed_stepper` / ``repro_torch.api``.
    """
    return make_fused_distributed_stepper(
        spec, mesh, grid_axes, schedule=(1,) * int(steps), option=option,
        backend=backend, boundary="periodic" if periodic else "zero",
        overlap=overlap)
