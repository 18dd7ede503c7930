"""Rollout program spec: segments of fused sweeps + registered update ops.

A :class:`RolloutProgram` is the declarative statement of an
assimilation-style rollout: a :class:`~repro_torch.core.planner.StencilProblem`
(operator, grid, dtype, boundary, batch) plus an ordered list of
:class:`Segment`\\ s.  Each segment advances the state ``steps`` stencil
applications as ONE fused sweep (preserving the paper's matrixized-sweep
traffic win *between* update points) and then applies an optional
:class:`UpdateOp` — a registered pointwise operator (source/forcing term,
observation-style linear correction, amplitude scaling, or a user
callable).  ``emit=True`` marks the segment's post-update state as a
streamed intermediate result.

Update operators are a registry (like the engine's backends): an op is a
``(name, params)`` pair where ``params`` is JSON-native, and the
registered builder ``(params, problem, out_grid) -> fn`` materializes the
state update.  The pair's content digest (:attr:`UpdateOp.update_id`)
is the op's *executable identity* — it joins the plan-cache key, so two
programs differing only in an update parameter can never alias one
compiled executable.

Programs are JSON-round-trippable (``to_dict``/``from_dict``) except for
user-registered callables, which serialize by registry name and must be
re-registered by the loading process.

The port's copy of the JAX package's ``rollout/program.py``: the same
registry, identities and digests — a program's :meth:`RolloutProgram
.digest` equals the JAX package's for the same program, so a checkpoint
either package wrote resumes in the other — with updates as torch
functions.  A ``seed`` field is drawn with numpy exactly as the JAX
package draws it, kept on the host in the problem's dtype, and copied to
each device the update runs on once.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.planner import StencilProblem, _json_default

__all__ = ["UpdateOp", "Segment", "RolloutProgram", "as_segments",
           "register_update_op", "update_op_names", "get_update_builder",
           "build_update"]


# ---------------------------------------------------------------------------
# Update-op registry
# ---------------------------------------------------------------------------

#: name -> builder(params, problem, out_grid) -> (state -> state).  The
#: returned fn must be pointwise/shape-preserving and batch-polymorphic
#: (states arrive as ``(*lead, *out_grid)``; constant fields of shape
#: ``out_grid`` broadcast against any leading axes).
_UPDATE_OPS: dict[str, Callable] = {}


def register_update_op(name: str, builder: Callable, *,
                       overwrite: bool = False) -> None:
    """Register a rollout update operator.

    ``builder(params, problem, out_grid)`` receives the op's JSON-native
    params, the segment's :class:`StencilProblem` and the spatial shape
    the update will see (equal to the problem grid except under
    ``boundary="valid"``, where the sweep shrank it), and returns a
    shape-preserving ``state -> state`` callable.  The registry is the
    extension point user forcing/correction terms plug in through — a
    registered op is planned, cached (by name + params digest) and
    executed exactly like the built-ins.
    """
    if name in _UPDATE_OPS and not overwrite:
        raise ValueError(f"update op {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _UPDATE_OPS[name] = builder


def update_op_names() -> list[str]:
    return sorted(_UPDATE_OPS)


def get_update_builder(name: str) -> Callable:
    if name not in _UPDATE_OPS:
        raise ValueError(f"unknown update op {name!r}; registered: "
                         f"{update_op_names()} (see register_update_op)")
    return _UPDATE_OPS[name]


@dataclasses.dataclass(frozen=True)
class UpdateOp:
    """One registered update operator instance: ``(op name, params)``.

    ``params`` must be JSON-serializable — it IS the op's identity:
    :attr:`update_id` digests the canonical JSON and joins the plan-cache
    key, so a changed gain/seed/field is a different executable.
    """

    op: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        get_update_builder(self.op)   # fail at construction, not mid-run
        object.__setattr__(self, "params", dict(self.params))
        try:
            json.dumps(self.params, sort_keys=True)
        except TypeError as e:
            raise ValueError(
                f"update op {self.op!r} params must be JSON-native "
                f"(got {self.params!r}): {e}") from e

    @property
    def update_id(self) -> str:
        """Content identity: registry name + params digest."""
        blob = json.dumps(self.params, sort_keys=True).encode()
        return f"{self.op}:{hashlib.sha1(blob).hexdigest()[:12]}"

    def to_dict(self) -> dict:
        return {"op": self.op, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "UpdateOp":
        return cls(op=d["op"], params=d.get("params", {}))


class _Field:
    """A constant field held on the host, copied once to each device an
    update runs on (``field.on(x.device)``)."""

    def __init__(self, host: torch.Tensor):
        self.host = host
        self._on: dict[torch.device, torch.Tensor] = {
            host.device: host}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = self.host.to(device)
        return t


def _field_from_params(params: Mapping, out_grid: tuple[int, ...],
                       dtype: str) -> _Field:
    """Deterministic constant field: ``value`` (uniform) or ``seed``
    (standard-normal, reproducible: the JAX package's numpy draw) — the
    two ways a JSON-native op carries a spatial operand."""
    dt = getattr(torch, dtype)
    if "value" in params:
        return _Field(torch.full(out_grid, float(params["value"]), dtype=dt))
    seed = int(params.get("seed", 0))
    f = np.random.default_rng(seed).standard_normal(out_grid)
    return _Field(torch.from_numpy(f).to(dt))


def _source_builder(params: Mapping, problem: StencilProblem,
                    out_grid: tuple[int, ...]) -> Callable:
    """Pointwise source/forcing term: ``x + scale * f`` where ``f`` is a
    constant field from ``value``/``seed``."""
    scale = float(params.get("scale", 1.0))
    f = _field_from_params(params, out_grid, problem.dtype)
    return lambda x: x + scale * f.on(x.device)


def _nudge_builder(params: Mapping, problem: StencilProblem,
                   out_grid: tuple[int, ...]) -> Callable:
    """Observation-style linear correction (the scalar-gain limit of a
    Kalman/nudging analysis step): ``x + gain * (obs - x)``."""
    gain = float(params.get("gain", 0.1))
    obs = _field_from_params(params, out_grid, problem.dtype)
    return lambda x: x + gain * (obs.on(x.device) - x)


def _scale_builder(params: Mapping, problem: StencilProblem,
                   out_grid: tuple[int, ...]) -> Callable:
    """Amplitude scaling (damping / normalization): ``factor * x``."""
    factor = float(params.get("factor", 1.0))
    return lambda x: factor * x


register_update_op("source", _source_builder)
register_update_op("nudge", _nudge_builder)
register_update_op("scale", _scale_builder)


def build_update(op: UpdateOp, problem: StencilProblem,
                 out_grid: tuple[int, ...] | None = None) -> Callable:
    """Materialize one update op for a segment's output shape."""
    if out_grid is None:
        out_grid = segment_out_grid(problem)
    return get_update_builder(op.op)(op.params, problem, tuple(out_grid))


def segment_out_grid(problem: StencilProblem) -> tuple[int, ...]:
    """Spatial shape a segment's update sees: the problem grid, shrunk by
    ``2*r*steps`` per axis under the 'valid' boundary."""
    if problem.boundary != "valid":
        return problem.grid
    shrink = 2 * problem.spec.order * problem.steps
    out = tuple(n - shrink for n in problem.grid)
    if min(out) < 1:
        raise ValueError(f"valid-mode segment of {problem.steps} steps "
                         f"shrinks grid {problem.grid} to {out}")
    return out


# ---------------------------------------------------------------------------
# Segments and programs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    """One program segment: a fused ``sweep(steps)`` then an optional
    update, with ``emit=True`` streaming the post-update state."""

    steps: int
    update: UpdateOp | None = None
    emit: bool = False

    def __post_init__(self):
        object.__setattr__(self, "steps", int(self.steps))
        if self.steps < 1:
            raise ValueError("segment steps >= 1")
        if self.update is not None and not isinstance(self.update, UpdateOp):
            object.__setattr__(self, "update", UpdateOp(*self.update)
                               if isinstance(self.update, (tuple, list))
                               else UpdateOp(**dict(self.update)))
        object.__setattr__(self, "emit", bool(self.emit))

    def to_dict(self) -> dict:
        return {"steps": self.steps,
                "update": self.update.to_dict() if self.update else None,
                "emit": self.emit}

    @classmethod
    def from_dict(cls, d: Mapping) -> "Segment":
        up = d.get("update")
        return cls(steps=d["steps"],
                   update=UpdateOp.from_dict(up) if up else None,
                   emit=d.get("emit", False))


def as_segments(segments: Sequence) -> tuple[Segment, ...]:
    """Normalize a segment sequence: each entry a :class:`Segment`, a
    bare step count, or a ``(steps, update[, emit])`` tuple."""
    out = []
    for s in segments:
        if isinstance(s, Segment):
            out.append(s)
        elif isinstance(s, int):
            out.append(Segment(steps=s))
        elif isinstance(s, (tuple, list)):
            out.append(Segment(*s))
        elif isinstance(s, Mapping):
            out.append(Segment.from_dict(s))
        else:
            raise TypeError(f"cannot interpret segment {s!r}")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class RolloutProgram:
    """A :class:`StencilProblem` plus an ordered list of segments.

    The problem's own ``steps`` field is ignored — every segment carries
    its own count and :meth:`segment_problem` rebuilds the per-segment
    problem the planner scores (threading the 'valid' boundary's grid
    shrink through consecutive segments).  ``identity()`` is the
    program's cache-key contribution: segment lengths, update-op content
    ids and emit points — everything the compiled executable depends on
    beyond the problem itself.
    """

    problem: StencilProblem
    segments: tuple[Segment, ...]

    def __post_init__(self):
        object.__setattr__(self, "segments", as_segments(self.segments))
        if not self.segments:
            raise ValueError("a rollout program needs >= 1 segment")
        for i in range(len(self.segments)):
            # fail at construction, not mid-flight: every segment's grid
            # must stay feasible (only 'valid' actually shrinks)
            segment_out_grid(self.segment_problem(i))

    @property
    def total_steps(self) -> int:
        return sum(s.steps for s in self.segments)

    def segment_grid(self, i: int) -> tuple[int, ...]:
        """Grid the i-th segment STARTS from."""
        grid = self.problem.grid
        if self.problem.boundary == "valid":
            done = sum(s.steps for s in self.segments[:i])
            shrink = 2 * self.problem.spec.order * done
            grid = tuple(n - shrink for n in grid)
        return grid

    def segment_problem(self, i: int) -> StencilProblem:
        """The planner-visible problem of the i-th segment."""
        return dataclasses.replace(self.problem,
                                   grid=self.segment_grid(i),
                                   steps=self.segments[i].steps)

    def emit_steps(self) -> list[int]:
        """Cumulative step counts at which states are emitted."""
        out, t = [], 0
        for s in self.segments:
            t += s.steps
            if s.emit:
                out.append(t)
        return out

    def identity(self) -> tuple:
        """Executable identity beyond the problem: (steps, update id,
        emit) per segment — the plan-cache key contribution."""
        return tuple((s.steps,
                      s.update.update_id if s.update else None,
                      s.emit) for s in self.segments)

    def digest(self) -> str:
        """Content digest of problem + segments (checkpoint guard)."""
        h = hashlib.sha1()
        # scenario fields ride to_dict() as arrays; JSON writes them as
        # the same lists the JAX package's to_dict() holds
        h.update(json.dumps(self.problem.to_dict(), sort_keys=True,
                            default=_json_default).encode())
        h.update(repr(self.identity()).encode())
        return h.hexdigest()[:16]

    def to_dict(self) -> dict:
        return {"problem": self.problem.to_dict(),
                "segments": [s.to_dict() for s in self.segments]}

    @classmethod
    def from_dict(cls, d: Mapping) -> "RolloutProgram":
        """The program of a ``to_dict()`` — this package's or the JAX
        package's."""
        return cls(problem=StencilProblem.from_dict(d["problem"]),
                   segments=tuple(Segment.from_dict(s)
                                  for s in d["segments"]))
