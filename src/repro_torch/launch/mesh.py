"""Roofline constants of the card the port targets.

Only the hardware record is ported here; the device-mesh builders come
with the distributed slice.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HardwareSpec", "H100_SXM", "HARDWARE", "get_hardware"]


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
