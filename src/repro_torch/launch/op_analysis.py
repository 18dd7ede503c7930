"""Counted cost of one executed chunk: the port's counterpart of the JAX
package's HLO cost analysis, for what calibration reads from it.

There is no compiled module to read here, so the executed program is
counted instead.  :func:`analyze_ops` runs a callable under
:class:`OpCounter`, a ``TorchDispatchMode``:

  * every PyTorch op the chunk runs outside the kernels is counted by the
    bytes it reads and writes — each tensor operand once, each tensor
    result once (the periodic pad's ``index_select``, tile pads, copies,
    batch stacking, the eager backends' products and adds).  Views and
    allocations move nothing and are not counted;
  * convolutions and matrix products add their flops, by
    ``torch.utils.flop_counter``'s formulas;
  * each kernel wrapper reports its own launch (``kernels.launch_cost``):
    FMAs and device-memory bytes from its launch geometry, on the card or
    through its plain version on the CPU alike, and the plain version's
    own ops are not counted.  So a count does not depend on the device.

``dot_flops`` (2 per FMA or multiply-add, the planner's unit) and
``traffic_bytes`` keep the JAX analysis' field names.

    result, cost = analyze_ops(run, x)
    cost.traffic_bytes, cost.ops["aten.index_select"]
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import launch_cost

__all__ = ["OpCost", "OpCounter", "analyze_ops"]

# ops that allocate or re-describe storage without reading or writing it
# (besides the view ops, which ``OpOverload.is_view`` names)
_NO_TRAFFIC = frozenset({"aten.empty", "aten.empty_strided",
                         "aten.empty_like", "aten._unsafe_view"})


@dataclasses.dataclass(frozen=True)
class OpCost:
    """What one run executed.  ``dot_flops``: the kernels' 2 flops per FMA
    plus the convolutions' and matrix products'; ``traffic_bytes``: the
    kernels' device-memory bytes plus every other op's operands and
    results.  ``ops`` splits the second part by op, ``kernels`` counts the
    kernel calls by wrapper."""
    dot_flops: float
    traffic_bytes: float
    kernel_fmas: int
    kernel_bytes: int
    op_flops: float
    op_bytes: int
    ops: dict[str, int]
    kernels: dict[str, int]


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active and the kernel
    launches reported to it (:func:`analyze_ops` arranges both)."""

    def __init__(self):
        super().__init__()
        self._inside = 0
        self._ops: Counter = Counter()
        self._op_flops = 0.0
        self._kernels: Counter = Counter()
        self._fmas = 0
        self._kernel_bytes = 0

    # -- the kernel wrappers' reports (launch_cost.kernel_region) ----------
    def kernel_begin(self, name: str, cost: launch_cost.LaunchCost) -> None:
        if self._inside == 0:
            self._kernels[name] += 1
            self._fmas += cost.fmas
            self._kernel_bytes += cost.bytes
        self._inside += 1

    def kernel_end(self) -> None:
        self._inside -= 1

    # -- every other op -----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
        name = str(func.overloadpacket)
        if func.is_view or name in _NO_TRAFFIC:
            return out
        self._ops[name] += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self._op_flops += float(formula(*args, **kwargs, out_val=out))
        return out

    def cost(self) -> OpCost:
        op_bytes = int(sum(self._ops.values()))
        return OpCost(
            dot_flops=2.0 * self._fmas + self._op_flops,
            traffic_bytes=float(self._kernel_bytes + op_bytes),
            kernel_fmas=int(self._fmas), kernel_bytes=int(self._kernel_bytes),
            op_flops=float(self._op_flops), op_bytes=op_bytes,
            ops=dict(sorted(self._ops.items())),
            kernels=dict(sorted(self._kernels.items())))


def analyze_ops(fn: Callable, *args: Any, **kwargs: Any
                ) -> tuple[Any, OpCost]:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter`;
    returns its result and the counted cost."""
    counter = OpCounter()
    with launch_cost.recording(counter), counter:
        result = fn(*args, **kwargs)
    return result, counter.cost()
