"""Temporal evolution driver (paper §2.2: alternate A/B copies along time).

PyTorch runs eagerly, so the evolutions are plain Python loops over step
functions; every result carries the final state, the step count and the
relative change ``|final - x| / |x|``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import halo

__all__ = ["EvolveResult", "boundary_step", "evolve", "evolve_until",
           "evolve_fused", "evolve_compiled", "reference_step",
           "reference_evolve"]


class EvolveResult(NamedTuple):
    state: torch.Tensor
    steps_run: int
    residual: torch.Tensor


def _residual(final: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm((final - x).float()) / (
        torch.linalg.vector_norm(x.float()) + 1e-30)


def boundary_step(core: Callable, order: int, ndim: int,
                  boundary: str) -> Callable:
    """Shape-preserving step from a valid-mode update via the halo layer.

    The same wrapper the engine uses — given any valid-mode core (oracle,
    matrixized, kernel) this produces the step function ``evolve`` needs.
    """
    return halo.wrap_boundary(core, order, ndim, boundary)


def reference_step(spec, boundary: str) -> Callable:
    """Gather-mode reference step for any spec kind (the parity oracle).

    One application of the naive gather oracle (:func:`kernels.ref
    .stencil_ref`) at the given boundary — including the varying-
    coefficient scale and domain-mask projection when the spec carries
    them.  It never touches the matrixized path.
    """
    from repro_torch.kernels.ref import stencil_ref

    def step(x):
        return stencil_ref(x, spec, boundary=boundary)

    return step


def reference_evolve(spec, x: torch.Tensor, steps: int,
                     boundary: str) -> torch.Tensor:
    """``steps`` applications of :func:`reference_step`."""
    step = reference_step(spec, boundary)
    for _ in range(steps):
        x = step(x)
    return x


def evolve(step_fn: Callable, x: torch.Tensor, steps: int,
           record_every: int = 0
           ) -> EvolveResult | tuple[EvolveResult, torch.Tensor]:
    """Run ``steps`` applications of ``step_fn``.

    record_every > 0 additionally returns stacked snapshots taken every
    that many steps.
    """
    state, recs = x, []
    for i in range(1, steps + 1):
        state = step_fn(state)
        if record_every and i % record_every == 0:
            recs.append(state)
    result = EvolveResult(state, steps, _residual(state, x))
    if record_every:
        stacked = (torch.stack(recs) if recs else
                   x.new_zeros((0,) + tuple(x.shape)))
        return result, stacked
    return result


def evolve_until(step_fn: Callable, x: torch.Tensor, tol: float,
                 max_steps: int) -> EvolveResult:
    """Evolve until the per-step relative residual ``|b - a| / |a|`` drops
    to ``tol`` or below, or ``max_steps`` steps ran.

    The JAX package runs this as one ``lax.while_loop`` on the device;
    here it is a host loop that reads each step's residual back to decide
    whether to go on — one device synchronisation per step.  The result's
    ``residual`` is the last step's (``inf`` when no step ran).
    """
    state = x
    res = torch.tensor(float("inf"))
    steps = 0
    while steps < max_steps and float(res) > tol:
        nxt = step_fn(state)
        res = _residual(nxt, state)
        state = nxt
        steps += 1
    return EvolveResult(state, steps, res)


def evolve_fused(engine, x: torch.Tensor, steps: int,
                 fuse: int | str = "auto") -> EvolveResult:
    """Evolve via the engine's fused multi-step sweep (temporal blocking).

    Equivalent to ``evolve(engine.step_fn(), x, steps)`` but each fused
    chunk reads/writes device memory once instead of ``fuse`` times (paper
    §6).  Requires a shape-preserving boundary.
    """
    final = engine.sweep(x, steps, fuse=fuse)
    return EvolveResult(final, steps, _residual(final, x))


def evolve_compiled(compiled, x: torch.Tensor) -> EvolveResult:
    """Evolve via a planner executable (``repro_torch.api.compile``'s
    output); the step count is the plan's own ``steps``."""
    final = compiled(x)
    return EvolveResult(final, compiled.plan.steps, _residual(final, x))
