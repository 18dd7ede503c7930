"""Placement of a tensor on a slot mesh: one spec entry a dimension.

The port's counterpart of a ``NamedSharding``-placed ``jax.Array``.  A
:class:`P` names, for each dimension of a tensor, the mesh axes it is
split over: ``None`` (not split), one axis, or a tuple of axes (the
first the major one, as in JAX: ``("pod", "data")`` splits a dimension
``pod * data`` ways, the pod coordinate outermost).  A mesh axis the spec
does not name holds replicas.

:class:`Placed` holds the blocks, one per mesh coordinate; replicas on one
device share one tensor, so every distinct device holds one copy of the
tensor in total however many slots name it.  :class:`NamedPlacement` is
where a tensor goes — its :meth:`~NamedPlacement.place` is what
``checkpoint.restore_checkpoint(..., shardings=)`` calls.  The stencil
path's ``core.distributed.ShardedState`` is the special case of one
mesh axis per spatial dimension and a replicated leading batch axis.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch.mesh import DeviceMesh

__all__ = ["P", "Placed", "NamedPlacement", "place", "place_views", "zeros",
           "unshard", "reshard", "spec_axes", "block_index", "unique_coords",
           "as_tensor"]

Tensor = torch.Tensor


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "model"))``.  It is a
    tuple, so it compares equal to another spec — the port's or
    ``jax.sharding.PartitionSpec`` converted with ``tuple()`` — entry by
    entry, as ``PartitionSpec`` does (``P("data", None) != P("data")``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else \
            f"P({self[0]!r})"


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check(mesh: DeviceMesh, spec: Sequence, shape: Sequence[int]) -> None:
    sizes = mesh.axis_sizes()
    used: set = set()
    for entry, n in zip(spec, shape):
        split = 1
        for ax in spec_axes(entry):
            if ax not in sizes:
                raise ValueError(f"spec axis {ax!r} is not a mesh axis "
                                 f"{mesh.axis_names}")
            if ax in used:
                raise ValueError(f"mesh axis {ax!r} used twice in {spec}")
            used.add(ax)
            split *= sizes[ax]
        if n % split:
            raise ValueError(f"extent {n} not divisible by the {split} "
                             f"blocks of {entry!r}")


def block_index(coord: Sequence[int], mesh: DeviceMesh, spec: Sequence,
                shape: Sequence[int]) -> tuple[slice, ...]:
    """The global slices the block of mesh coordinate ``coord`` covers."""
    sizes = mesh.axis_sizes()
    idx = []
    for entry, n in zip(spec, shape):
        k, split = 0, 1
        for ax in spec_axes(entry):
            j = mesh.axis_names.index(ax)
            k = k * sizes[ax] + coord[j]
            split *= sizes[ax]
        if split == 1:
            idx.append(slice(None))
        else:
            w = n // split
            idx.append(slice(k * w, (k + 1) * w))
    return tuple(idx)


def unique_coords(mesh: DeviceMesh, spec: Sequence) -> Iterator[tuple]:
    """Every mesh coordinate that holds a distinct block once: replicas
    (mesh axes the spec does not name) at coordinate 0 only."""
    named = {mesh.axis_names.index(ax) for e in spec for ax in spec_axes(e)}
    for c in np.ndindex(mesh.shape):
        if not any(k and j not in named for j, k in enumerate(c)):
            yield c


def _canonical(coord: tuple, mesh: DeviceMesh, spec: Sequence) -> tuple:
    named = {mesh.axis_names.index(ax) for e in spec for ax in spec_axes(e)}
    return tuple(k if j in named else 0 for j, k in enumerate(coord))


@dataclasses.dataclass(eq=False)
class Placed:
    """A global tensor as blocks on a mesh's slots.  ``blocks[coord]`` is
    the block of mesh coordinate ``coord``, on ``mesh.devices[coord]``;
    replicas on one device are one tensor."""
    blocks: np.ndarray
    mesh: DeviceMesh
    spec: P
    shape: tuple[int, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.flat[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        """The lead slot's device."""
        return self.blocks.flat[0].device

    @property
    def local_shape(self) -> tuple[int, ...]:
        return tuple(self.blocks.flat[0].shape)

    def index(self, coord) -> tuple[slice, ...]:
        return block_index(coord, self.mesh, self.spec, self.shape)

    def unique_blocks(self):
        """``(coord, global slices, block)`` of every block once."""
        for c in unique_coords(self.mesh, self.spec):
            yield c, self.index(c), self.blocks[c]

    def sync_replicas(self) -> int:
        """Copy each unique block into its replicas on other devices (after
        an in-place update of the unique blocks); returns the copies."""
        n = 0
        for c in np.ndindex(self.blocks.shape):
            src = self.blocks[_canonical(c, self.mesh, self.spec)]
            if self.blocks[c] is not src:
                self.blocks[c].copy_(src)
                n += 1
        return n

    def unshard(self, device=None) -> Tensor:
        return unshard(self, device)

    def __repr__(self) -> str:
        return (f"Placed({tuple(self.shape)}, {self.dtype}, spec="
                f"{self.spec!r}, mesh={self.mesh.describe()})")


def _build(mesh: DeviceMesh, spec: Sequence, shape: Sequence[int],
           make: Callable[[tuple, torch.device], Tensor]) -> Placed:
    """Blocks from ``make(global slices, device)``, one per distinct
    (slices, device): replicas on one device share it."""
    shape = tuple(int(n) for n in shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {tuple(spec)} has {len(spec)} entries for "
                         f"a tensor of rank {len(shape)}")
    # as in JAX, a shorter spec leaves the trailing dimensions whole
    spec = P(*spec, *(None,) * (len(shape) - len(spec)))
    _check(mesh, spec, shape)
    made: dict = {}
    blocks = np.empty(mesh.shape, dtype=object)
    for c in np.ndindex(mesh.shape):
        idx = block_index(c, mesh, spec, shape)
        dev = torch.device(mesh.devices[c])
        key = (tuple((s.start, s.stop) for s in idx), str(dev))
        if key not in made:
            made[key] = make(idx, dev)
        blocks[c] = made[key]
    return Placed(blocks, mesh, spec, shape)


def place(x: Tensor, mesh: DeviceMesh, spec: Sequence) -> Placed:
    """Split a global tensor into the blocks of ``mesh`` (copies)."""
    def make(idx, dev):
        part = x[idx]
        b = torch.empty(part.shape, dtype=x.dtype, device=dev)
        b.copy_(part)
        return b
    return _build(mesh, spec, x.shape, make)


def place_views(x: Tensor, mesh: DeviceMesh, spec: Sequence) -> Placed:
    """``x``'s blocks on ``mesh`` as views of ``x``, which must lie on
    every slot's device already: a placement that moves nothing (the dry
    run's ``meta`` tensors, as arguments arrive placed)."""
    def make(idx, dev):
        if dev != x.device:
            raise ValueError(f"a view placement needs every slot on "
                             f"{x.device}, not {dev}")
        return x[idx]
    return _build(mesh, spec, x.shape, make)


def zeros(shape: Sequence[int], mesh: DeviceMesh, spec: Sequence,
          dtype=torch.float32) -> Placed:
    """A placed tensor of zeros, made block by block (never whole)."""
    def make(idx, dev):
        local = [len(range(*s.indices(n))) for s, n in zip(idx, shape)]
        return torch.zeros(local, dtype=dtype, device=dev)
    return _build(mesh, spec, shape, make)


def unshard(x: Placed, device=None) -> Tensor:
    """The global tensor, on ``device`` (by default the lead slot's)."""
    dev = torch.device(device) if device is not None else x.device
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    for _, idx, b in x.unique_blocks():
        out[idx].copy_(b)
    return out


def _same_mesh(a: DeviceMesh, b: DeviceMesh) -> bool:
    return a.axis_names == b.axis_names and a.shape == b.shape and \
        [str(d) for d in a.devices.flat] == [str(d) for d in b.devices.flat]


def reshard(x: Placed, mesh: DeviceMesh, spec: Sequence) -> Placed:
    """The tensor placed on another mesh or spec (elastic re-mesh)."""
    full = tuple(spec) + (None,) * (x.ndim - len(spec))
    if _same_mesh(x.mesh, mesh) and tuple(x.spec) == full:
        return x
    return place(unshard(x), mesh, spec)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedPlacement:
    """Where a tensor lives: ``spec`` over ``mesh`` (the stand-in for a
    ``NamedSharding``).  :meth:`place` places a tensor, or re-places a
    :class:`Placed` one."""
    mesh: DeviceMesh
    spec: P

    def place(self, x) -> Placed:
        if isinstance(x, Placed):
            return reshard(x, self.mesh, self.spec)
        return place(torch.as_tensor(x), self.mesh, self.spec)

    def zeros(self, shape, dtype=torch.float32) -> Placed:
        return zeros(shape, self.mesh, self.spec, dtype)

    def __repr__(self) -> str:
        return f"NamedPlacement({self.mesh.describe()}, {self.spec!r})"


def as_tensor(x, device=None) -> Optional[Tensor]:
    """A placed leaf's global tensor; any other leaf as it is (moved to
    ``device`` when one is given)."""
    if isinstance(x, Placed):
        return unshard(x, device)
    return x if device is None else x.to(device)

