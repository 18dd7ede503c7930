"""Roofline constants of the card the port targets, and the device mesh.

:class:`DeviceMesh` is the port's counterpart of ``jax.sharding.Mesh``
for the distributed stencil path: a named n-d array of device SLOTS.
One process drives every slot (the reference's single-controller model),
and a slot may repeat a device — four slots of one card stand in for a
2x2 mesh exactly as the reference's tests use fake CPU devices.  A
slot's identity is its index (``slots``), never the device object, so
one eviction takes out one slot even when every slot names the same
card.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

__all__ = ["HardwareSpec", "H100_SXM", "HARDWARE", "get_hardware",
           "DeviceMesh", "make_mesh", "shrunk_shape"]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants for the target card."""
    name: str
    peak_flops: float           # FLOP/s of the arithmetic the kernels use
    hbm_bw: float               # device-memory bytes/s
    ici_bw: float               # inter-card link bytes/s, each way
    hbm_bytes: float            # device-memory capacity


# NVIDIA H100 SXM5 data sheet (dense rates, 700 W): 67 TFLOP/s FP32 on the
# CUDA cores — the port's stencil kernels are f32 FMAs outside the tensor
# cores, without TF32, so that is their compute peak (not the 989 TFLOP/s
# bf16 tensor-core rate); 3.35 TB/s HBM3 over 80 GB; NVLink 4 at 900 GB/s
# total, 450 GB/s each way.  A card set below 700 W runs below these.
H100_SXM = HardwareSpec(name="h100_sxm", peak_flops=67e12, hbm_bw=3.35e12,
                        ici_bw=450e9, hbm_bytes=80e9)

HARDWARE = {hw.name: hw for hw in (H100_SXM,)}


def get_hardware(name: str) -> HardwareSpec:
    """Look up roofline constants by card name (plan JSON)."""
    if name not in HARDWARE:
        raise KeyError(f"unknown hardware {name!r}; known: {sorted(HARDWARE)}")
    return HARDWARE[name]


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """A named mesh of device slots.

    ``devices`` is a numpy object array of ``torch.device`` of the mesh's
    shape; ``slots`` holds each position's slot id (by default its flat
    index), which a server that carves meshes out of its own slot list
    sets to those slots' indices.  ``axis_names`` names the mesh axes.
    """
    devices: np.ndarray
    axis_names: tuple[str, ...]
    slots: np.ndarray | None = None

    def __post_init__(self):
        devs = np.asarray(self.devices, dtype=object)
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if len(self.axis_names) != devs.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{devs.ndim}-axis mesh")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate mesh axis names {self.axis_names}")
        slots = (np.arange(devs.size) if self.slots is None
                 else np.asarray(self.slots, dtype=np.int64))
        object.__setattr__(self, "slots", slots.reshape(devs.shape))

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(int(n) for n in self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_sizes(self) -> dict[str, int]:
        """``{axis name: extent}``."""
        return dict(zip(self.axis_names, self.shape))

    def describe(self) -> str:
        return "x".join(str(n) for n in self.shape)

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return (f"DeviceMesh({self.describe()}, axes={self.axis_names}, "
                f"devices={devs})")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices=None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` (tests, elastic re-mesh).

    ``devices``: one device for every slot (a sequence of ``prod(shape)``
    devices, or a single device repeated); by default every slot is the
    card, ``"cuda"``.  The CPU tests pass ``"cpu"``.
    """
    shape = tuple(int(n) for n in shape)
    if any(n < 1 for n in shape):
        raise ValueError(f"mesh extents must be >= 1, got {shape}")
    n = int(np.prod(shape))
    if devices is None or isinstance(devices, (str, torch.device)):
        devs = [torch.device("cuda" if devices is None else devices)] * n
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"mesh {shape} needs {n} devices, got "
                             f"{len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return DeviceMesh(arr.reshape(shape), tuple(axes))


def shrunk_shape(shape: Sequence[int]) -> tuple[int, ...] | None:
    """One rung down the mesh-shrink ladder after losing slots: halve the
    largest axis (an odd one collapses to 1), so any grid an N-way axis
    divided, the new axis divides too.  ``None`` when the mesh is already
    a single slot."""
    sizes = [(n, j) for j, n in enumerate(shape) if n > 1]
    if not sizes:
        return None
    _, j = max(sizes)
    out = [int(n) for n in shape]
    out[j] = out[j] // 2 if out[j] % 2 == 0 else 1
    return tuple(out)
