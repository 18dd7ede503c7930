"""Keyed plan + executable cache: plan once, compile once, serve forever.

Serving traffic repeats: the same (operator, grid shape, dtype, step
count, batch bucket) arrives over and over, and re-running ``plan()``
(cost-table enumeration) plus ``compile_plan()`` (engine construction,
covers, kernel plans) per request would dwarf the sweep itself.  This
module provides the memoization layer the serving loop
(:mod:`repro_torch.launch.serve_stencil`) sits on:

  * :func:`cache_key` — ONE definition of executable identity: the spec's
    coefficient bytes, grid shape, dtype, boundary, steps, batch, the
    hardware model, the calibration record (by digest) and every planner
    pin.  Anything that can change the compiled core is in the key; two
    problems with equal keys are interchangeable executables.
  * :class:`PlanCache` — a bounded LRU mapping keys to
    :class:`CachedExecutable` (the frozen plan and the compiled stencil
    on the cache's device), with hit/miss/eviction counters.  A second
    identical request is a counter-visible hit that re-plans nothing and
    compiles nothing.

The port of the JAX package's ``core/plan_cache.py``.  The JAX package's
``interpret=`` knob is the port's ``device=`` (the card by default; the
CPU runs the kernels' plain versions).  PyTorch runs eagerly, so there
is no ``jit`` around the executable, and readiness — JAX's
``block_until_ready`` — is a CUDA event recorded after the launch and
synchronised by whoever settles it (a no-op on the CPU).

The cache is a plain in-process object — share one per server (per
device slot); create fresh ones in tests.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from collections import OrderedDict
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.planner import (CompiledStencil, ExecutionPlan,
                                      PLAN_VERSION, StencilProblem,
                                      _calibration_dict, compile_plan,
                                      max_profitable_batch, plan)
from repro_torch.runtime import chaos

__all__ = ["PlanCache", "CachedExecutable", "cache_key", "ready_event",
           "wait_ready"]


def _spec_digest(spec) -> str:
    """Stable identity of a stencil operator: coefficient bytes + tag,
    plus the content-addressed scenario digest — two specs differing only
    in coefficient field or domain mask miss the cache separately."""
    c = np.ascontiguousarray(np.asarray(spec.gather_coeffs, np.float64))
    h = hashlib.sha1(c.tobytes())
    h.update(str(c.shape).encode())
    h.update(spec.shape.encode())
    h.update(spec.scenario_digest().encode())
    return h.hexdigest()[:16]


def _calibration_digest(calibration) -> str:
    if calibration is None:
        return "-"
    d = _calibration_dict(calibration)
    return hashlib.sha1(
        json.dumps(d, sort_keys=True).encode()).hexdigest()[:16]


def _freeze(v: Any):
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, Mapping):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


# Last-resort field list for hardware objects that expose neither
# dataclass fields nor a __dict__ (e.g. __slots__ shims); real specs are
# introspected so a newly added roofline field changes the key by itself.
_HW_FIELDS = ("name", "peak_flops", "hbm_bw", "ici_bw", "hbm_bytes",
              "launch_overhead_s")


def _hw_key(hw) -> tuple | None:
    """Hardware identity by PARAMETERS, not just name: two specs sharing a
    name but differing in any roofline constant must not alias
    executables.  The fields come from the object itself (dataclass
    fields, else ``vars()``), so a hardware model that GROWS a roofline
    field is a new identity without this module knowing its name."""
    if hw is None:
        return None
    if dataclasses.is_dataclass(hw) and not isinstance(hw, type):
        fields = tuple(f.name for f in dataclasses.fields(hw))
    else:
        d = getattr(hw, "__dict__", None)
        fields = tuple(sorted(d)) if d else _HW_FIELDS
    return tuple((f, getattr(hw, f, None)) for f in fields)


def _program_key(program) -> tuple | None:
    """Rollout-program identity slot of :func:`cache_key`.

    Accepts a :class:`repro_torch.rollout.program.RolloutProgram`
    (duck-typed by its ``identity()``) or a pre-extracted identity tuple;
    ``None`` (a plain sweep) stays ``None`` — so a rollout program and a
    plain sweep over the same :class:`StencilProblem` can NEVER collide,
    and two programs differing in any segment length, update-op content
    id or emit point key separately.
    """
    if program is None:
        return None
    ident = program.identity() if hasattr(program, "identity") else program
    return _freeze(ident)


def cache_key(problem: StencilProblem, *, hw=None, calibration=None,
              program=None, **plan_kwargs) -> tuple:
    """Executable identity of a problem + planning context.

    Everything that changes what ``compile_plan(plan(problem, ...))``
    builds is keyed: the operator (by coefficient digest), grid, dtype,
    boundary, steps, batch, the mesh decomposition (shape, axis names,
    grid axes, and the slots and devices the executable is bound to), the
    hardware model (by its roofline parameters, not just its name), the
    calibration record (by content digest), the rollout program identity
    (``program=``; ``None`` for plain sweeps) and every planner pin
    (``fuse=``, ``backends=``, ``block=``, ``fuse_strategy=``, ...).
    PLAN_VERSION leads the tuple so a cache can never serve a
    stale-format plan across an upgrade.
    """
    sharding = None
    if problem.mesh is not None:
        mesh = problem.mesh
        sharding = (mesh.shape, tuple(mesh.axis_names),
                    tuple(problem.grid_axes),
                    tuple(int(k) for k in mesh.slots.flat),
                    tuple(str(d) for d in mesh.devices.flat))
    return (
        PLAN_VERSION,
        _spec_digest(problem.spec),
        problem.grid,
        str(problem.dtype),
        problem.boundary,
        int(problem.steps),
        int(problem.batch),
        sharding,
        _program_key(program),
        _hw_key(hw),
        _calibration_digest(calibration),
        _freeze(plan_kwargs),
    )


def _tensors(out) -> list[torch.Tensor]:
    """The tensors of an executable's output: a tensor, or a rollout
    program's ``(final, emits)``."""
    if isinstance(out, torch.Tensor):
        return [out]
    final, emits = out
    return [final, *emits]


def ready_event(out) -> torch.cuda.Event | None:
    """A CUDA event recorded on the current stream after the launches
    that produce ``out`` (``None`` on the CPU, where work is already
    done when the call returns)."""
    t = _tensors(out)[0]
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def wait_ready(event: torch.cuda.Event | None) -> None:
    """Block the host until ``event`` (from :func:`ready_event`) has
    passed — only this work, not the whole device.  A device fault in
    the launches surfaces here."""
    if event is not None:
        event.synchronize()


@dataclasses.dataclass
class CachedExecutable:
    """One cache entry: the frozen decision record plus its executable.

    ``fn`` is the compiled entry point.  ``hits`` counts how many cache
    lookups this entry served after the compiling miss; ``calls`` counts
    SUCCESSFUL executions (the serving loop uses it to separate each
    executable's first call — which also builds the kernels and their
    tap tables — from warm sweeps in its timing); ``dispatches`` counts
    every launch that returned, including those whose work later failed
    before readiness.

    Success accounting happens strictly AFTER device readiness: an async
    server launches with :meth:`dispatch` (which books nothing) and calls
    :meth:`mark_ready` once the launch's event was synchronised without
    raising — so a failure between dispatch and readiness leaves the
    entry cold and the NEXT first call's time is still booked as compile,
    not warm, wall clock.  ``__call__`` is the synchronous convenience
    wrapping exactly that sequence.

    Per-entry timing hooks: ``compile_s`` accumulates the first
    successful call, ``wall_s`` every warm successful call.
    """

    key: tuple
    plan: Any                 # ExecutionPlan, or a RolloutPlan
    compiled: Any             # CompiledStencil, or a CompiledRollout
    fn: Callable
    hits: int = 0
    calls: int = 0
    dispatches: int = 0
    compile_s: float = 0.0   # first successful call
    wall_s: float = 0.0      # warm successful calls

    @property
    def warm(self) -> bool:
        """Whether this executable has at least one SUCCESSFUL call."""
        return self.calls > 0

    def dispatch(self, x):
        """Launch without waiting or accounting (launches are
        asynchronous on the current stream): the caller owns readiness
        and must :meth:`mark_ready` on success."""
        out = self.fn(x)
        self.dispatches += 1
        return out

    def mark_ready(self, wall_s: float = 0.0) -> bool:
        """Book one successful execution of ``wall_s`` seconds; returns
        whether the entry was already warm BEFORE this call (i.e. whether
        ``wall_s`` was booked as warm rather than compile time)."""
        warm = self.calls > 0
        if warm:
            self.wall_s += wall_s
        else:
            self.compile_s += wall_s
        self.calls += 1
        return warm

    def __call__(self, x):
        t0 = time.perf_counter()
        out = self.dispatch(x)
        wait_ready(ready_event(out))
        self.mark_ready(time.perf_counter() - t0)
        return out


class PlanCache:
    """Bounded LRU of compiled stencil executables with observable counters.

    ``get(problem, **plan_kwargs)`` returns a :class:`CachedExecutable`,
    planning + compiling only on a miss, on the cache's ``device`` (the
    card unless the caller asks for ``"cpu"``; without a card the default
    raises).  ``maxsize`` bounds the entry count (least-recently-used
    executables are evicted, so a bounded serving process cannot
    accumulate executables without bound).
    """

    def __init__(self, maxsize: int = 32, hw=None, device="cuda"):
        if maxsize < 1:
            raise ValueError("maxsize >= 1")
        self.maxsize = int(maxsize)
        self._hw = hw
        self._device = resolve_device(device)
        self._entries: OrderedDict[tuple, CachedExecutable] = OrderedDict()
        # plan-without-compile memo (admission-control queries): bounded
        # separately — plans are small frozen records, executables are not
        self._plans: OrderedDict[tuple, ExecutionPlan] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        return key in self._entries

    @property
    def hw(self):
        """The hardware model every lookup plans against (None = default)."""
        return self._hw

    @property
    def device(self) -> torch.device:
        """The device compiled executables run on."""
        return self._device

    def plan_only(self, problem: StencilProblem, *, calibration=None,
                  **plan_kwargs) -> ExecutionPlan:
        """The frozen plan for ``problem`` WITHOUT compiling anything.

        Memoized under the same :func:`cache_key` as :meth:`get` and
        reused by it, so a model-only query (the admission-control
        bucket-cliff walk) is never planning work thrown away: if the
        server later compiles the same problem, the miss skips straight
        to compile.  Does not touch the executable hit/miss counters.
        """
        key = cache_key(problem, hw=self._hw, calibration=calibration,
                        **plan_kwargs)
        entry = self._entries.get(key)
        if entry is not None:
            return entry.plan
        p = self._plans.get(key)
        if p is None:
            p = plan(problem, self._hw, calibration=calibration,
                     **plan_kwargs)
            self._plans[key] = p
            while len(self._plans) > 4 * self.maxsize:
                self._plans.popitem(last=False)
        else:
            self._plans.move_to_end(key)
        return p

    def bucket_cap(self, problem: StencilProblem, max_batch: int, *,
                   calibration=None, rtol: float = 0.0,
                   **plan_kwargs) -> int:
        """:func:`repro_torch.core.planner.max_profitable_batch` through
        this cache's plan memo: the largest serving bucket whose modelled
        per-state cost is within ``rtol`` of the best for ``problem``'s
        shape group (its ``batch`` is ignored), with every walked plan
        retained for later compiles."""
        return max_profitable_batch(
            problem, max_batch, self._hw, rtol=rtol,
            plan_fn=lambda pb: self.plan_only(pb, calibration=calibration,
                                              **plan_kwargs))

    def _insert(self, key: tuple, entry: CachedExecutable) -> None:
        self._entries[key] = entry
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
            self.evictions += 1

    def _lookup(self, key: tuple) -> CachedExecutable | None:
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            entry.hits += 1
        else:
            self.misses += 1
        return entry

    def get(self, problem: StencilProblem, *, calibration=None,
            mesh=None, **plan_kwargs) -> CachedExecutable:
        """The compiled executable for ``problem``, memoized.

        ``plan_kwargs`` pass through to :func:`repro_torch.core.planner
        .plan` (and join the key).  A problem with a mesh compiles to the
        distributed stepper on ``mesh`` (by default the problem's own);
        the mesh decomposition is part of the key through the problem.
        """
        key = cache_key(problem, hw=self._hw, calibration=calibration,
                        **plan_kwargs)
        entry = self._lookup(key)
        if entry is not None:
            return entry
        # a prior plan_only() query (admission control) already planned
        # this exact key: reuse its frozen record, compile only
        p = self._plans.pop(key, None)
        if p is None:
            p = plan(problem, self._hw, calibration=calibration,
                     **plan_kwargs)
        # fault site: an injected compile failure leaves no cache entry
        # behind (the miss was already counted — honest accounting)
        chaos.fire("cache.compile", backend=p.backend,
                   batch=int(problem.batch))
        compiled: CompiledStencil = compile_plan(
            p, mesh=mesh if mesh is not None else problem.mesh,
            device=self._device)
        entry = CachedExecutable(key=key, plan=p, compiled=compiled,
                                 fn=compiled.fn)
        self._insert(key, entry)
        return entry

    def get_program(self, program, *, calibration=None, mesh=None,
                    **plan_kwargs) -> CachedExecutable:
        """The compiled executable for a whole rollout program, memoized
        as ONE entry.

        ``program`` is a :class:`repro_torch.rollout.program
        .RolloutProgram`; the entry's ``fn(x)`` runs every segment and
        returns ``(final state, tuple of emitted states)``.  Keyed by the
        problem (at the program's total step count) PLUS the program
        identity (:func:`_program_key`), so it can never alias a plain
        sweep; per-segment planning routes through :meth:`plan_only`'s
        memo, so programs sharing segment shapes share cost tables.  The
        entry's ``plan`` is the :class:`repro_torch.rollout.planning
        .RolloutPlan`.

        Mesh-sharded programs key like distributed sweeps — the mesh is
        part of :func:`cache_key` via the problem (a reshard is a
        different executable), while ``mesh`` (by default the problem's
        own) materializes the steppers, exactly as in :meth:`get`.
        """
        from repro_torch.rollout.executor import compile_program
        from repro_torch.rollout.planning import plan_program
        key = cache_key(dataclasses.replace(program.problem,
                                            steps=program.total_steps),
                        hw=self._hw, calibration=calibration,
                        program=program, **plan_kwargs)
        entry = self._lookup(key)
        if entry is not None:
            return entry
        rplan = plan_program(program, self._hw, cache=self,
                             calibration=calibration, **plan_kwargs)
        chaos.fire("cache.compile",
                   backend=rplan.segment_plans[0].backend,
                   batch=int(program.problem.batch))
        compiled = compile_program(
            rplan, device=self._device,
            mesh=mesh if mesh is not None else program.problem.mesh)

        def fn(x):
            res = compiled.run(x)
            return res.final, tuple(a for _, a in res.emits)

        entry = CachedExecutable(key=key, plan=rplan, compiled=compiled,
                                 fn=fn)
        self._insert(key, entry)
        return entry

    def stats(self) -> dict:
        return {"size": len(self._entries), "maxsize": self.maxsize,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "plans": len(self._plans)}

    def clear(self) -> None:
        self._entries.clear()
        self._plans.clear()
