"""What one kernel launch executes, reported by the kernel wrappers.

A wrapper prices its launch from the launch geometry (blocks, haloed slab
read, tile written, aux operands, tap table; FMAs of every output it
computes) and hands the price to whatever is recording on this thread —
:class:`repro_torch.launch.op_analysis.OpCounter`, which counts a
calibration chunk.  The price is the same whether the wrapper launches
its kernel (a CUDA tensor) or runs its plain version (a CPU tensor), and
the recorder does not count the plain version's own PyTorch ops, so a
count does not depend on the device.  While tracing is on
(:mod:`repro_torch.runtime.trace`) the launch is also a ``kernel.<name>``
span of the price's bytes.  Nothing is priced while no recorder is active
and tracing is off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Iterator

from repro_torch.runtime import trace

__all__ = ["LaunchCost", "recording", "kernel_region"]


@dataclasses.dataclass(frozen=True)
class LaunchCost:
    """One launch: f32 FMAs executed and device-memory bytes moved
    (every global load and store the launch geometry implies)."""
    fmas: int
    bytes: int


_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


@contextlib.contextmanager
def recording(recorder) -> Iterator[None]:
    """Make ``recorder`` (``kernel_begin(name, cost)`` / ``kernel_end()``)
    receive this thread's kernel launches while the block runs."""
    stack = _stack()
    stack.append(recorder)
    try:
        yield
    finally:
        stack.remove(recorder)


@contextlib.contextmanager
def kernel_region(name: str,
                  price: Callable[[], LaunchCost]) -> Iterator[None]:
    """A wrapper's launch (or plain version): reports ``price()`` to the
    active recorders, which ignore the ops run inside the block, and to
    the trace as a ``kernel.<name>`` span."""
    stack = tuple(_stack())
    if not stack and not trace.enabled():
        yield
        return
    cost = price()
    for rec in stack:
        rec.kernel_begin(name, cost)
    try:
        with trace.span(trace.KERNEL_PREFIX + name, cost.bytes):
            yield
    finally:
        for rec in stack:
            rec.kernel_end()
