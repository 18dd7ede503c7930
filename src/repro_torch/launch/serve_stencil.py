"""Async continuous-batching stencil server over the plan/executable cache.

A request stream of independent user states (arbitrary arrival order,
mixed grid shapes) is advanced ``steps`` applications each, at per-state
cost amortized four ways:

  1. **plan/compile amortization** — executables come from a
     :class:`repro_torch.core.plan_cache.PlanCache`; a repeated (shape,
     dtype, batch bucket) is a counter-visible cache hit with zero
     re-planning and zero re-compiling.
  2. **batched execution** — requests with the same spatial shape are
     stacked into power-of-two batch buckets (padded with zero states up
     to the bucket) and advanced by ONE batched executable: the batch
     rides the kernels' second grid dimension, one launch and one tap
     table per chunk for the whole bucket.
  3. **launch amortization** — one kernel launch per chunk serves the
     whole bucket (the planner's ``LAUNCH_OVERHEAD_S / (depth * batch)``
     term).
  4. **dispatch overlap** — the scheduler is ``step()``-driven
     continuous batching: every turn admits whatever is pending RIGHT
     NOW into freshly dispatched buckets and only then settles the
     buckets dispatched on earlier turns, so host-side staging of bucket
     N+1 overlaps device execution of bucket N.

The port of the JAX package's ``launch/serve_stencil.py``, on one or more
device SLOTS (``devices=``; the card by default).  How JAX's semantics
carry over:

  * **Dispatch and settle.**  Launches are asynchronous on a CUDA stream.
    Each slot owns one stream; every dispatch — from the caller's thread
    or the background stepper's, whose current stream is its own —
    stages and launches inside ``torch.cuda.stream(slot stream)``.  An
    in-flight bucket carries a CUDA event recorded after its launches;
    settling synchronises that event (this bucket's work), never the
    device.  On the CPU the work is done when the launch returns.
  * **Host copies.**  ``submit`` takes numpy arrays (or CPU tensors) and
    CUDA tensors.  A CUDA tensor is used in place (a bucket of one) or
    copied on the device into its bucket; the slot's stream waits for
    the event recorded at submit, and ``record_stream`` keeps the
    allocator from reusing its memory while the slot's kernels read it.
    Host data is copied once to the device through pinned memory with
    ``non_blocking=True`` at dispatch, so the copy overlaps the previous
    bucket's kernels.  Padding states are zeros made on the device.
    Results are tensors on the bucket's device; their memory is recorded
    on the device's default stream, where callers read them.
  * **Device slots.**  Shape groups route by slot INDEX (``torch.device``
    compares by value), so two slots may name one device (the CPU tests
    run two CPU slots).
  * **Faults that are not recoverable.**  The retry / fallback / evict
    ladder recovers only injected faults (:class:`chaos.FaultError`).
    Any other error raises at once and never degrades the group: moving
    it to the ``torch`` backend would hide the kernel behind its plain
    version.  An error at dispatch (a planner error, a kernel wrapper's
    launch-time ``ValueError``, a ``torch.cuda.OutOfMemoryError``) recurs
    on a retry, so the bucket fails fast and its requests stay queued
    for the caller to cancel.  An error of the bucket's device work (a
    CUDA error, such as an illegal address seen at the event sync) is
    sticky — the context is unusable after it — so the bucket's tickets
    fail with it and it propagates; nothing is requeued onto that
    context.
  * **Mesh serving** (``mesh_shape=``, with ``devices=`` listing at
    least that many slots): each shape group's states are sharded over
    a :class:`repro_torch.launch.mesh.DeviceMesh` of that shape carved
    from the active slots, sticky per group and homed on its lead slot
    (whose cache and stream serve it); the executable is the fused
    distributed stepper.  Slots are named by index, so four slots of
    one card form a 2x2 mesh and an eviction takes out one of them.

Buckets are powers of two so a variable-size stream maps onto a tiny,
highly-reusable set of compiled batch shapes; the padding waste is
bounded by 2x and reported.  **Admission control** caps each shape
group's bucket at :func:`repro_torch.core.planner.max_profitable_batch`
(through the slot cache's plan memo): the largest bucket the port's
Hopper cost model still prices as a per-state win.

**Rollout serving**: ``submit_rollout(state, segments)`` enqueues a whole
sweep+update program; the scheduler drives it one segment per turn
through the same buckets — requests whose next hop shares a (shape,
segment-identity) signature batch into ONE cached one-segment program
executable (``PlanCache.get_program``), emitted intermediates stream via
``rollout_results(ticket)``, and the final state settles like any plain
result.

Per-request latency (submit -> settled result) is tracked next to the
throughput counters — p50/p95/mean in ``stats()["latency"]`` — and
``submit(state, deadline_s=...)`` counts deadline misses.

**Fault handling** is a graded ladder, driven by the shared supervision
primitives in :mod:`repro_torch.runtime.fault_tolerance` and exercisable
deterministically through :mod:`repro_torch.runtime.chaos`:

  retry      a failed bucket requeues under a per-shape-group
             :class:`RestartPolicy` clone — exponential backoff, bounded
             budget; its executable stays cold (success accounting sits
             after readiness).
  fallback   after ``fallback_after`` injected failures a shape group
             degrades to the ``fallback_backends`` pin (``"torch"``, the
             eager matrixized backend, on the bucket's device) through
             the backend registry; ``stats()["degraded"]`` and
             ``faults.fallbacks`` record it.  It is the documented
             degradation, never a way around a kernel: fault-free
             serving keeps ``degraded == {}``.
  evict      a slot failing ``evict_after`` consecutive buckets leaves
             the round-robin rotation; its sticky shape groups remap to
             surviving slots.  A MESH-sharded group takes the
             partial-mesh rung instead: the eviction SHRINKS the group's
             mesh over the surviving slots (same halving rule as
             ``rollout.executor.shrink_mesh`` — same global grid, fewer
             slots), re-homes it on the shrunk mesh's lead slot, and
             counts ``stats()["faults"]["mesh_shrinks"]``.  After
             ``evict_cooldown_s`` a slot rejoins on probation (one
             strike re-evicts with doubled cooldown) and takes one
             remapped group back as the probe.
  shed       when the deadline-miss rate over the last ``shed_window``
             deadline-carrying requests crosses ``shed_miss_rate``, the
             lowest-priority class of PENDING requests is shed (their
             tickets fail with :class:`RequestShed`).

**Concurrency**: every public method is thread-safe (one state lock
guards the queues, one step lock serializes scheduler turns; device
waits happen OUTSIDE the state lock so ``submit()``/``results()`` never
block on a sweep).  ``start()`` runs the scheduler on a background
thread; ``results(ticket, timeout_s=...)`` then blocks until the ticket
settles.

    PYTHONPATH=src python -m repro_torch.launch.serve_stencil \\
        --cell star2d_r2 --grid 4096 --steps 16 --max-batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve_stencil \\
        --device cpu --backends torch --grid 48
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.plan_cache import PlanCache, ready_event, wait_ready
from repro_torch.core.planner import StencilProblem
from repro_torch.core.stencil_spec import PAPER_SUITE, StencilSpec
from repro_torch.launch.mesh import DeviceMesh, shrunk_shape
from repro_torch.rollout.program import RolloutProgram, Segment, as_segments
from repro_torch.runtime import chaos
from repro_torch.runtime.fault_tolerance import RestartPolicy

__all__ = ["StencilServer", "ServeStats", "RequestShed"]


class RequestShed(RuntimeError):
    """A pending request shed under deadline pressure; claiming its
    ticket raises this (the state was never advanced)."""


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


def _shape_str(shape: tuple[int, ...]) -> str:
    return "x".join(str(n) for n in shape)


def _slot_device(device) -> torch.device:
    """A slot's device, with the card's index made explicit (``"cuda"``
    -> ``cuda:<current>``) so it compares equal to its tensors'."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _recoverable(err: BaseException) -> bool:
    """Whether the fault ladder may requeue (and at last degrade) work
    after ``err``: only after an injected fault (module docstring)."""
    return isinstance(err, chaos.FaultError)


def _queued_failure(shape: tuple[int, ...], requests, err) -> ValueError:
    """The error a bucket that failed fast raises; its requests stay
    queued."""
    return ValueError(
        f"serving bucket of shape {shape} failed for tickets "
        f"{[r.ticket for r in requests]}: {err}; the failed requests stay "
        f"queued and completed results are returned by the next flush()")


@dataclasses.dataclass(eq=False)
class _RolloutTask:
    """Scheduler-side progress of one submitted rollout: which segment
    runs next, how many steps completed, and the emitted intermediates
    not yet drained by ``rollout_results``."""
    segments: tuple[Segment, ...]
    seg: int = 0
    done_steps: int = 0
    emits: list = dataclasses.field(default_factory=list)

    @property
    def current(self) -> Segment:
        return self.segments[self.seg]

    @property
    def done(self) -> bool:
        return self.seg >= len(self.segments)

    def signature(self) -> tuple:
        """Bucket-grouping identity of the NEXT segment: requests whose
        next hop is the same (steps, update id, emit) share an
        executable regardless of what the rest of their programs do."""
        s = self.current
        return (s.steps, s.update.update_id if s.update else "", s.emit)


@dataclasses.dataclass(eq=False)
class _Request:
    """One submitted state awaiting its bucket: a CPU tensor (host data,
    possibly sharing memory with the caller's numpy array) or a CUDA
    tensor with the event its producer's stream recorded at submit."""
    ticket: int
    state: torch.Tensor
    submit_t: float
    deadline_s: float | None = None
    rollout: _RolloutTask | None = None
    priority: int = 0
    attempts: int = 0        # dispatch attempts of the CURRENT hop
    ready: torch.cuda.Event | None = None


@dataclasses.dataclass(eq=False)
class _InFlight:
    """One dispatched-but-unsettled bucket (its device work may still be
    running until ``event`` has passed)."""
    shape: tuple[int, ...]
    requests: list[_Request]
    bucket: int
    entry: object            # CachedExecutable
    out: object              # tensor, or (final, emits) for rollout buckets
    event: torch.cuda.Event | None
    t0: float                # dispatch time (perf_counter)
    device: int              # slot index into the server's device list
    segment: Segment | None = None   # the rollout hop this bucket ran


@dataclasses.dataclass
class ServeStats:
    """Aggregate serving counters (see :meth:`StencilServer.stats`).

    ``wall_s``/``warm_states`` cover only batches whose executable had
    already completed at least once, so ``per_state_s`` is the
    steady-state wall clock; each executable's FIRST call (which also
    builds its kernels' tap tables and scenario operands) is accounted
    separately in ``compile_wall_s``.  Under overlapped dispatch a
    bucket's wall clock spans dispatch -> settled, which includes any
    time it queued behind earlier buckets on the device.

    ``latencies_s`` records every request's submit -> settled latency;
    ``deadline_misses`` counts requests whose latency exceeded the
    ``deadline_s`` they were submitted with.

    Fault-ladder counters: ``bucket_failures`` (dispatch or settle
    failures, including injected ones), ``retries`` (failed buckets
    requeued under a retry budget), ``fallbacks`` (shape groups degraded
    to the fallback backend), ``evictions`` (slots removed from the
    rotation), ``mesh_shrinks`` (mesh-sharded groups whose mesh shrank
    over surviving slots) and ``shed`` (pending requests dropped under
    deadline pressure).
    ``rollout_attempts``/``rollout_recovered``: total dispatch attempts
    of rollout segment buckets, and rollout requests whose segment
    settled only after at least one retry.
    """

    requests: int = 0
    batches: int = 0
    padded_states: int = 0
    wall_s: float = 0.0          # warm-executable seconds
    warm_states: int = 0         # states served by warm executables
    compile_wall_s: float = 0.0  # first-call seconds
    deadline_misses: int = 0
    bucket_failures: int = 0
    retries: int = 0
    fallbacks: int = 0
    evictions: int = 0
    mesh_shrinks: int = 0
    rollout_attempts: int = 0
    rollout_recovered: int = 0
    shed: int = 0
    latencies_s: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def per_state_s(self) -> float:
        """Warm seconds per state (0 until any warm batch ran)."""
        return self.wall_s / self.warm_states if self.warm_states else 0.0

    @property
    def throughput(self) -> float:
        """Warm-served states per second of bucket wall clock."""
        return self.warm_states / self.wall_s if self.wall_s else 0.0

    def latency_percentile(self, q: float) -> float:
        """Latency percentile in seconds (0.0 with no settled requests)."""
        if not self.latencies_s:
            return 0.0
        return float(np.percentile(self.latencies_s, q))

    @property
    def p50_latency_s(self) -> float:
        return self.latency_percentile(50)

    @property
    def p95_latency_s(self) -> float:
        return self.latency_percentile(95)


class StencilServer:
    """Continuous-batching request scheduler for one stencil operator.

    One server owns one operator + evolution contract (``spec``,
    ``steps``, ``boundary``, ``dtype``) and serves any stream of states
    of any spatial shape matching ``spec.ndim``:

      * ``submit(state, deadline_s=..., priority=...)`` enqueues a
        state, returns a ticket;
      * ``step()`` runs one scheduler turn — admit every pending request
        into freshly dispatched buckets, then settle the buckets
        dispatched on EARLIER turns;
      * ``start()`` / ``stop()`` run those turns on a background thread
        instead, making ``submit()`` fire-and-forget;
      * ``results(ticket)`` claims one settled result (``timeout_s=``
        blocks until it settles); ``ready(ticket)`` peeks;
      * ``flush()`` steps until nothing is pending or in flight and
        returns every unclaimed ``{ticket: result}``;
      * ``serve(states)`` is the submit-all-then-flush convenience,
        preserving order (it claims only its own tickets).

    ``async_dispatch=False`` settles each bucket immediately after its
    dispatch — the reference the async path is bit-exact against.
    ``admission=False`` disables the bucket cap.  ``devices`` lists the
    device slots (``None``: one slot on the card, ``"cuda"``; the CPU
    tests pass ``["cpu"]`` or ``["cpu", "cpu"]``); shape groups route
    round-robin over them, one ``PlanCache`` and one stream per slot.
    ``mesh_shape=(2, 2)`` (with ``devices=`` of at least 4 slots) shards
    every shape group over a mesh of that shape instead (axis names
    ``mesh_axes``, by default ``gx, gy, ...``; ``grid_axes`` maps each
    spatial axis to one, by default the mesh axes in order then ``''``).

    Fault handling (module docstring): ``restart`` is the per-shape-group
    retry-budget TEMPLATE (cloned per group; ``None`` gives the default
    3-strike/50 ms-backoff policy), ``fallback_after``/
    ``fallback_backends`` configure the backend degradation
    (``fallback_after=None`` disables), ``evict_after``/
    ``evict_cooldown_s`` the slot eviction ladder, and
    ``shed_miss_rate``/``shed_window`` the load shedder (``None``
    disables — the default).

    The plan/executable cache is injectable (it then serves slot 0, and
    ``devices=None`` means its device); by default each slot owns a fresh
    :class:`PlanCache`.
    """

    def __init__(self, spec: StencilSpec, steps: int, *,
                 boundary: str = "periodic", dtype: str = "float32",
                 max_batch: int = 8, cache: PlanCache | None = None,
                 backends: Sequence[str] | None = None,
                 hw=None,
                 async_dispatch: bool = True,
                 admission: bool = True, admission_rtol: float = 0.0,
                 devices: Sequence | None = None,
                 mesh_shape: Sequence[int] | None = None,
                 mesh_axes: Sequence[str] | None = None,
                 grid_axes: Sequence[str] | None = None,
                 restart: RestartPolicy | None = None,
                 fallback_after: int | None = 2,
                 fallback_backends: Sequence[str] = ("torch",),
                 evict_after: int = 3, evict_cooldown_s: float = 2.0,
                 shed_miss_rate: float | None = None,
                 shed_window: int = 16):
        if steps < 0:
            raise ValueError("steps >= 0")
        if max_batch < 1:
            raise ValueError("max_batch >= 1")
        if evict_after < 1:
            raise ValueError("evict_after >= 1")
        if shed_miss_rate is not None and not 0.0 <= shed_miss_rate <= 1.0:
            raise ValueError("shed_miss_rate in [0, 1]")
        self.spec = spec
        self.steps = int(steps)
        self.boundary = boundary
        self.dtype = dtype
        self._torch_dtype = getattr(torch, dtype)
        self.max_batch = int(max_batch)
        self.backends = None if backends is None else list(backends)
        self.async_dispatch = bool(async_dispatch)
        self.admission = bool(admission)
        self.admission_rtol = float(admission_rtol)
        self.restart = restart if restart is not None else RestartPolicy(
            max_failures=3, backoff_s=0.05)
        self.fallback_after = fallback_after
        self.fallback_backends = list(fallback_backends)
        self.evict_after = int(evict_after)
        self.evict_cooldown_s = float(evict_cooldown_s)
        self.shed_miss_rate = shed_miss_rate
        self.shed_window = int(shed_window)
        if devices is not None and not list(devices):
            raise ValueError("devices must be non-empty when given")
        if devices is None:
            devices = [cache.device if cache is not None else "cuda"]
        self._devices = [_slot_device(d) for d in devices]
        # mesh-sharded serving: each shape group's states are sharded
        # over a mesh of this shape carved from the server's slots; an
        # eviction SHRINKS a group's mesh instead of remapping it
        if mesh_shape is not None:
            self.mesh_shape = tuple(int(n) for n in mesh_shape)
            if int(np.prod(self.mesh_shape)) > len(self._devices):
                raise ValueError(f"mesh_shape {self.mesh_shape} needs "
                                 f"{int(np.prod(self.mesh_shape))} slots, "
                                 f"got {len(self._devices)} (pass "
                                 f"devices=)")
            naxes = len(self.mesh_shape)
            self.mesh_axes = (tuple(mesh_axes) if mesh_axes is not None
                              else ("gx", "gy", "gz", "gw")[:naxes])
            if len(self.mesh_axes) != naxes:
                raise ValueError("one mesh axis name per mesh_shape axis")
            self.grid_axes = (tuple(grid_axes) if grid_axes is not None
                              else self.mesh_axes
                              + ("",) * (spec.ndim - naxes))
            if len(self.grid_axes) != spec.ndim:
                raise ValueError(f"grid_axes needs {spec.ndim} entries "
                                 f"('' = unsharded axis)")
        else:
            if mesh_axes is not None or grid_axes is not None:
                raise ValueError("mesh_axes/grid_axes need mesh_shape")
            self.mesh_shape = None
            self.mesh_axes = self.grid_axes = ()
        if cache is not None and _slot_device(cache.device) \
                != self._devices[0]:
            raise ValueError(f"cache runs on {cache.device}, slot 0 on "
                             f"{self._devices[0]}")
        base = cache if cache is not None else PlanCache(
            hw=hw, device=self._devices[0])
        #: one PlanCache per slot — each slot's executables and their
        #: warm/compile accounting are its own
        self.caches: list[PlanCache] = [base] + [
            PlanCache(maxsize=base.maxsize, hw=base.hw, device=d)
            for d in self._devices[1:]]
        self.cache = self.caches[0]
        #: one stream per slot, owned by the server (None on the CPU)
        self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                         else None for d in self._devices]
        self._pending: list[_Request] = []
        self._inflight: list[_InFlight] = []
        self._rollouts: dict[int, _RolloutTask] = {}
        self._done: dict[int, torch.Tensor] = {}
        self._failed: dict[int, Exception] = {}
        self._cancelled: set[int] = set()
        self._next_ticket = 0
        self._caps: dict[tuple[int, ...], int] = {}
        self._group_dev: dict[tuple[int, ...], int] = {}
        self._group_mesh: dict[tuple[int, ...], DeviceMesh] = {}
        self._rr = 0                    # round-robin cursor (active slots)
        # degradation-ladder state -----------------------------------------
        self._retry: dict[tuple[int, ...], RestartPolicy] = {}
        self._group_failures: dict[tuple[int, ...], int] = {}
        self._group_backends: dict[tuple[int, ...], list[str]] = {}
        n_dev = len(self._devices)
        self._dev_fail = [0] * n_dev            # consecutive failures
        self._evicted_until = [None] * n_dev    # monotonic deadline or None
        self._probation = [False] * n_dev
        self._dev_cooldown = [self.evict_cooldown_s] * n_dev
        self._remapped: dict[int, list[tuple[int, ...]]] = {}
        self._deadline_window: deque = deque(maxlen=self.shed_window)
        # concurrency ------------------------------------------------------
        self._lock = threading.RLock()          # queues / results / stats
        self._cv = threading.Condition(self._lock)
        self._step_lock = threading.RLock()     # serializes scheduler turns
        self._work = threading.Event()
        self._stop_event = threading.Event()
        self._stepper: threading.Thread | None = None
        self._stepper_error: Exception | None = None
        self._device_stats = [
            {"device": str(d), "batches": 0, "states": 0, "shapes": [],
             "failures": 0, "evictions": 0, "evicted": False}
            for d in self._devices]
        self.stats_ = ServeStats()

    # -- request intake ----------------------------------------------------
    def _intake(self, state) -> tuple[torch.Tensor, torch.cuda.Event | None]:
        """The request's tensor in the server's dtype: a CUDA tensor as
        given (with an event on the caller's current stream), anything
        else as a CPU tensor, sharing memory with a numpy array where the
        dtype already matches."""
        if isinstance(state, torch.Tensor):
            t = state.detach()
        else:
            t = torch.from_numpy(np.ascontiguousarray(state))
        t = t.to(self._torch_dtype)
        if t.ndim != self.spec.ndim:
            raise ValueError(f"state rank {t.ndim} != spec ndim "
                             f"{self.spec.ndim} (submit one state at a "
                             f"time; the server does the batching)")
        ev = None
        if t.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
        return t, ev

    def submit(self, state, *, deadline_s: float | None = None,
               priority: int = 0) -> int:
        """Enqueue one state; returns the ticket results are keyed by.

        ``state`` is a numpy array (or CPU tensor) — not to be modified
        until its result settles, since it is read at dispatch — or a
        CUDA tensor.  ``deadline_s`` is a per-request latency budget in
        seconds from now; a request settling later still returns its
        result but increments ``stats()["deadline_misses"]``.
        ``priority`` orders load shedding only (HIGHER survives longer;
        scheduling itself stays FIFO-per-shape).  Thread-safe,
        non-blocking.
        """
        t, ev = self._intake(state)
        with self._lock:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._pending.append(_Request(ticket, t, time.perf_counter(),
                                          deadline_s, priority=priority,
                                          ready=ev))
            self._stepper_error = None     # new work resumes the stepper
        self._work.set()
        return ticket

    def submit_rollout(self, state, segments, *,
                       deadline_s: float | None = None,
                       priority: int = 0) -> int:
        """Enqueue one state for a ROLLOUT program; returns its ticket.

        ``segments`` is anything :func:`repro_torch.rollout.program
        .as_segments` accepts.  The scheduler drives the program one
        segment per turn through the SAME bucket machinery as plain
        requests, batching requests whose next hop shares a (shape,
        segment-identity) signature into one cached program executable.
        Emitted intermediates accumulate per ticket and are drained with
        :meth:`rollout_results`; the FINAL state is claimed like any
        result, and latency/deadline accounting spans submit -> final
        settle.
        """
        t, ev = self._intake(state)
        segs = as_segments(segments)
        if not segs:
            raise ValueError("a rollout needs >= 1 segment")
        if self.boundary == "valid":
            raise ValueError("rollout serving needs a shape-preserving "
                             "boundary (valid-mode grids shrink per "
                             "segment, breaking bucket shape grouping)")
        task = _RolloutTask(segments=segs)
        with self._lock:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._rollouts[ticket] = task
            self._pending.append(_Request(ticket, t, time.perf_counter(),
                                          deadline_s, rollout=task,
                                          priority=priority, ready=ev))
            self._stepper_error = None
        self._work.set()
        return ticket

    def rollout_results(self, ticket: int) -> list[tuple[int, torch.Tensor]]:
        """Drain the emitted intermediates of one rollout so far.

        Returns ``[(cumulative step, state), ...]`` for every emit point
        settled since the last drain (possibly empty).  The ticket stays
        drainable until the rollout is done AND its stream is empty; the
        final state is claimed separately via :meth:`results`.
        """
        with self._lock:
            task = self._rollouts.get(ticket)
            if task is None:
                raise KeyError(f"ticket {ticket} is not a known rollout "
                               f"(plain submit, never submitted, cancelled, "
                               f"or already fully drained)")
            out, task.emits = list(task.emits), []
            if task.done and not task.emits:
                del self._rollouts[ticket]
            return out

    def rollout_done(self, ticket: int) -> bool:
        """Whether a rollout finished its last segment (final result may
        still be unclaimed)."""
        with self._lock:
            task = self._rollouts.get(ticket)
            return task is None or task.done

    def cancel(self, ticket: int):
        """Cancel one request (pending, failed, or mid-rollout).

        Plain tickets: returns ``True`` if anything was dropped.  Rollout
        tickets: the queued program is abandoned and the PARTIAL emits
        settled so far are returned (a ``list``, possibly empty).  A
        ticket whose bucket is already IN FLIGHT is settle-then-drop: the
        dispatched device work completes, then the cancelled ticket's
        result is discarded instead of booked.  Already-settled results
        are NOT cancelled — claim them with :meth:`results`.
        """
        with self._lock:
            task = self._rollouts.pop(ticket, None)
            before = len(self._pending)
            self._pending = [r for r in self._pending if r.ticket != ticket]
            removed = len(self._pending) < before
            in_flight = any(r.ticket == ticket
                            for fb in self._inflight for r in fb.requests)
            if in_flight:
                self._cancelled.add(ticket)
            self._failed.pop(ticket, None)
            if removed:
                self._stepper_error = None   # the poison pill may be gone
                self._work.set()
            if task is not None:
                emits, task.emits = list(task.emits), []
                return emits
            return removed or in_flight

    def pending_tickets(self) -> list[int]:
        """Tickets still waiting for a bucket, in submission order."""
        with self._lock:
            return [r.ticket for r in self._pending]

    # -- results -----------------------------------------------------------
    def ready(self, ticket: int) -> bool:
        """Whether ``results(ticket)`` would return without stepping."""
        with self._lock:
            return ticket in self._done

    def _known_unsettled(self, ticket: int) -> bool:
        return (any(r.ticket == ticket for r in self._pending)
                or any(r.ticket == ticket
                       for fb in self._inflight for r in fb.requests)
                or ticket in self._rollouts)

    def results(self, ticket: int, *,
                timeout_s: float | None = None) -> torch.Tensor:
        """Claim one settled result (removing it from the server).

        Unclaimed results are retained across any number of ``flush()`` /
        ``serve()`` calls until this accessor (or a ``flush()`` return)
        hands them out.

        ``timeout_s`` turns this into the BLOCKING accessor for
        background-stepper mode: wait until the ticket settles (or was
        shed/failed — the recorded error re-raises here), raising
        ``TimeoutError`` after ``timeout_s`` seconds.  If the background
        stepper died on an unrecoverable error while the ticket was
        outstanding, that error surfaces here instead of hanging.
        """
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        with self._cv:
            while True:
                if ticket in self._done:
                    return self._done.pop(ticket)
                err = self._failed.pop(ticket, None)
                if err is not None:
                    raise err
                if not self._known_unsettled(ticket):
                    raise KeyError(
                        f"ticket {ticket} has no claimable result (unknown, "
                        f"cancelled, or already claimed); run step() or "
                        f"flush() to settle pending work") from None
                if timeout_s is None:
                    raise KeyError(
                        f"ticket {ticket} has no claimable result (still "
                        f"pending or in flight); run step() or flush() to "
                        f"settle pending work, or pass timeout_s= to block")
                if self._stepper_error is not None:
                    raise RuntimeError(
                        f"background stepper failed while ticket {ticket} "
                        f"was outstanding: {self._stepper_error}"
                    ) from self._stepper_error
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"ticket {ticket} did not settle within "
                        f"{timeout_s}s")
                self._cv.wait(remaining)

    # -- background stepper ------------------------------------------------
    def start(self, poll_s: float = 0.005) -> "StencilServer":
        """Run the scheduler on a daemon thread until :meth:`stop`.

        Each loop iteration is one ordinary :meth:`step` (the step lock
        keeps it safe to ALSO call ``step()``/``flush()`` from other
        threads).  On an unrecoverable turn error (a retry budget
        exhausted) the stepper parks, the error surfaces through blocked
        ``results(timeout_s=...)`` callers, and any ``submit()`` or
        ``cancel()`` resumes stepping.  Idempotent; returns self.
        """
        if poll_s <= 0:
            raise ValueError("poll_s > 0")
        with self._lock:
            if self._stepper is not None and self._stepper.is_alive():
                return self
            self._stop_event = threading.Event()
            self._stepper_error = None
            t = threading.Thread(target=self._stepper_loop, args=(poll_s,),
                                 name="stencil-stepper", daemon=True)
            self._stepper = t
        t.start()
        return self

    def stop(self, timeout_s: float | None = 10.0) -> None:
        """Stop the background stepper (queued work stays queued; a
        later ``flush()``/``start()`` picks it up).  Idempotent."""
        with self._lock:
            t = self._stepper
            self._stepper = None
        if t is None or not t.is_alive():
            return
        self._stop_event.set()
        self._work.set()
        t.join(timeout_s)

    @property
    def running(self) -> bool:
        """Whether the background stepper thread is alive."""
        t = self._stepper
        return t is not None and t.is_alive()

    def _stepper_loop(self, poll_s: float) -> None:
        while not self._stop_event.is_set():
            with self._lock:
                has_work = ((self._pending or self._inflight)
                            and self._stepper_error is None)
            if not has_work:
                self._work.wait(timeout=poll_s)
                self._work.clear()
                continue
            try:
                self.step()
            except Exception as e:       # park; submit()/cancel() resume
                with self._cv:
                    self._stepper_error = e
                    self._cv.notify_all()

    # -- execution ---------------------------------------------------------
    def _problem(self, shape: tuple[int, ...], batch: int,
                 steps: int | None = None,
                 mesh: DeviceMesh | None = None) -> StencilProblem:
        kw = ({"mesh": mesh, "grid_axes": self.grid_axes}
              if mesh is not None else {})
        return StencilProblem(self.spec, shape, dtype=self.dtype,
                              boundary=self.boundary,
                              steps=self.steps if steps is None else steps,
                              batch=batch, **kw)

    def _plan_kwargs(self, shape: tuple[int, ...] | None = None) -> dict:
        """Planner pins for one shape group — the DEGRADED pin once the
        fault ladder demoted the group to the fallback backend."""
        backends = self.backends
        if shape is not None:
            backends = self._group_backends.get(shape, backends)
        return {} if backends is None else {"backends": backends}

    # -- slot routing + eviction -------------------------------------------
    def _active_devices(self) -> list[int]:
        return [i for i in range(len(self._devices))
                if self._evicted_until[i] is None]

    def _device_of(self, shape: tuple[int, ...]) -> int:
        """Round-robin shape-group -> slot assignment (sticky, so a
        group's buckets always hit the same cache and stream; evicted
        slots are skipped).  Under mesh serving the group's home is its
        mesh's LEAD slot — failure attribution and cache selection follow
        the mesh, not the round-robin cursor."""
        with self._lock:
            if self.mesh_shape is not None:
                di = int(self._group_mesh_for(shape).slots.flat[0])
                if self._group_dev.get(shape) != di:
                    self._group_dev[shape] = di
                    name = _shape_str(shape)
                    if name not in self._device_stats[di]["shapes"]:
                        self._device_stats[di]["shapes"].append(name)
                return di
            di = self._group_dev.get(shape)
            if di is None or self._evicted_until[di] is not None:
                active = self._active_devices() or [0]
                di = active[self._rr % len(active)]
                self._rr += 1
                self._group_dev[shape] = di
                name = _shape_str(shape)
                if name not in self._device_stats[di]["shapes"]:
                    self._device_stats[di]["shapes"].append(name)
            return di

    def _slot_mesh(self, slots: Sequence[int],
                   shape: tuple[int, ...]) -> DeviceMesh:
        devs = np.empty(len(slots), dtype=object)
        devs[:] = [self._devices[i] for i in slots]
        return DeviceMesh(devs.reshape(shape), self.mesh_axes,
                          np.asarray(slots, dtype=np.int64))

    def _group_mesh_for(self, shape: tuple[int, ...]) -> DeviceMesh:
        """The shape group's serving mesh, built lazily over the ACTIVE
        slots at the configured ``mesh_shape`` (shrunk down the same
        halving ladder if evictions already thinned the rotation below
        it).  Once built the mesh is sticky — it changes only through
        :meth:`_evict_device`'s shrink rung (lock held)."""
        mesh = self._group_mesh.get(shape)
        if mesh is None:
            active = self._active_devices()
            mshape: tuple[int, ...] | None = self.mesh_shape
            while int(np.prod(mshape)) > len(active):
                mshape = shrunk_shape(mshape)
                if mshape is None:   # unreachable: the last slot stays
                    raise RuntimeError("no active slots left for a mesh")
            n = int(np.prod(mshape))
            mesh = self._group_mesh[shape] = self._slot_mesh(active[:n],
                                                             mshape)
        return mesh

    def _shrink_group_mesh(self, mesh: DeviceMesh) -> DeviceMesh | None:
        """The largest halving of ``mesh`` that fits on its surviving
        (non-evicted) slots, preserving their order — ``None`` when a
        single-slot mesh cannot shrink further (lock held).  Slots are
        told apart by index: every slot may name the same device."""
        survivors = [int(k) for k in mesh.slots.flat
                     if self._evicted_until[int(k)] is None]
        shape: tuple[int, ...] | None = mesh.shape
        while True:
            shape = shrunk_shape(shape)
            if shape is None:
                return None
            n = int(np.prod(shape))
            if n <= len(survivors):
                return self._slot_mesh(survivors[:n], shape)

    def _evict_device(self, di: int, now: float) -> None:
        """Remove one slot from the rotation and remap its sticky groups
        to survivors (lock held).  A MESH-sharded group whose mesh
        contains the evicted slot takes the partial-mesh rung instead:
        its mesh SHRINKS over the surviving slots (same grid, fewer
        slots — the serving mirror of the rollout executor's
        reshard-on-failure) and the group re-homes on the shrunk mesh's
        lead slot; only a mesh that cannot shrink falls back to the plain
        rebuild-over-survivors remap."""
        if len(self._active_devices()) <= 1:
            return                        # never evict the last slot
        self._evicted_until[di] = now + self._dev_cooldown[di]
        if self._probation[di]:
            self._dev_cooldown[di] *= 2.0  # probation strike: back off more
        self._probation[di] = False
        self._dev_fail[di] = 0
        self._device_stats[di]["evictions"] += 1
        self._device_stats[di]["evicted"] = True
        self.stats_.evictions += 1
        shrunk: set[tuple[int, ...]] = set()
        for shape, mesh in list(self._group_mesh.items()):
            if di not in {int(k) for k in mesh.slots.flat}:
                continue
            new_mesh = self._shrink_group_mesh(mesh)
            if new_mesh is None:
                # a 1-slot mesh lost its slot: rebuild lazily over
                # whatever survives, via the normal remap path
                del self._group_mesh[shape]
                continue
            self._group_mesh[shape] = new_mesh
            self._group_dev[shape] = int(new_mesh.slots.flat[0])
            self._caps.pop(shape, None)   # new mesh -> new cache key/cap
            self.stats_.mesh_shrinks += 1
            shrunk.add(shape)
        moved = [s for s, d in self._group_dev.items()
                 if d == di and s not in shrunk]
        for shape in moved:
            del self._group_dev[shape]    # next _device_of reassigns
            self._remapped.setdefault(di, []).append(shape)

    def _readmit_devices(self) -> None:
        """Cooldown probe: an evicted slot whose cooldown expired rejoins
        the rotation on probation, taking back ONE of its remapped groups
        so the probe actually runs traffic."""
        now = time.monotonic()
        with self._lock:
            for di, until in enumerate(self._evicted_until):
                if until is None or now < until:
                    continue
                self._evicted_until[di] = None
                self._probation[di] = True
                self._dev_fail[di] = 0
                self._device_stats[di]["evicted"] = False
                for shape in self._remapped.pop(di, []):
                    self._group_dev[shape] = di   # the probe group
                    break

    def bucket_cap(self, shape: tuple[int, ...]) -> int:
        """Admission-control bucket cap for one shape group, memoized.

        With ``admission`` on, the planner's bucket-cliff query walks the
        modelled per-state cost over the serving buckets (through the
        slot's plan memo, so the walk's plans are reused by the later
        compiling miss) and the group is capped at the largest bucket
        still priced as a win.
        """
        cap = self._caps.get(shape)
        if cap is None:
            # mesh serving skips the cliff walk: the admission model
            # prices single-device plans, not per-slot distributed ones
            if self.mesh_shape is not None:
                cap = self.max_batch
            elif self.admission and self.max_batch > 1:
                di = self._device_of(shape)
                cap = self.caches[di].bucket_cap(
                    self._problem(shape, 1), self.max_batch,
                    rtol=self.admission_rtol, **self._plan_kwargs(shape))
            else:
                cap = self.max_batch
            self._caps[shape] = cap
        return cap

    def _stage(self, chunk: list[_Request], b: int, shape: tuple[int, ...],
               dev: torch.device, stream) -> torch.Tensor:
        """The bucket's input on ``dev``, built on the slot's stream (the
        caller holds ``torch.cuda.stream(stream)``): a lone CUDA state in
        place, else a ``(b, *shape)`` tensor with host states copied in
        through pinned memory, device states copied on the device and the
        padding slots zeroed."""
        for r in chunk:
            if r.state.device.type == "cuda":
                if stream is not None and r.ready is not None:
                    stream.wait_event(r.ready)
                if stream is not None:
                    r.state.record_stream(stream)
        first = chunk[0].state
        if b == 1 and first.device == dev and first.is_contiguous():
            return first
        arg = torch.empty((b,) + shape, dtype=self._torch_dtype, device=dev)
        for i, r in enumerate(chunk):
            src = r.state
            if dev.type == "cuda" and src.device.type == "cpu":
                pinned = torch.empty(shape, dtype=src.dtype,
                                     pin_memory=True)
                pinned.copy_(src)
                arg[i].copy_(pinned, non_blocking=True)
            else:
                arg[i].copy_(src)
        if b > len(chunk):
            arg[len(chunk):].zero_()
        return arg[0] if b == 1 else arg

    def _dispatch_bucket(self, shape: tuple[int, ...], cap: int,
                         chunk: list[_Request]) -> _InFlight:
        """Stage one <= cap group on the slot's stream and launch it.

        Plain requests run the server's ``steps``-sweep executable; a
        rollout group (all members share the next-segment signature, by
        ``_admit``'s grouping) runs a ONE-segment program executable from
        ``PlanCache.get_program`` — keyed by the segment identity, so it
        can never alias the plain sweep.
        """
        b = _bucket(len(chunk), cap)
        di = self._device_of(shape)
        dev, stream = self._devices[di], self._streams[di]
        with self._lock:
            mesh = (self._group_mesh_for(shape)
                    if self.mesh_shape is not None else None)
            seg = chunk[0].rollout.current if chunk[0].rollout else None
            for r in chunk:
                r.attempts += 1
            if seg is not None:
                self.stats_.rollout_attempts += len(chunk)
        if seg is not None:
            program = RolloutProgram(
                self._problem(shape, b, steps=seg.steps, mesh=mesh), (seg,))
            entry = self.caches[di].get_program(program, mesh=mesh,
                                                **self._plan_kwargs(shape))
        else:
            entry = self.caches[di].get(self._problem(shape, b, mesh=mesh),
                                        mesh=mesh,
                                        **self._plan_kwargs(shape))
        chaos.fire("serve.dispatch", shape=_shape_str(shape), device=di,
                   bucket=b)
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            arg = self._stage(chunk, b, shape, dev, stream)
            # dispatch only — readiness (and the entry's success
            # accounting) waits for _settle, so a failed first call stays
            # cold and host staging of the next bucket overlaps this work
            out = entry.dispatch(arg)
            event = ready_event(out)
        return _InFlight(shape=shape, requests=list(chunk), bucket=b,
                         entry=entry, out=out, event=event, t0=t0,
                         device=di, segment=seg)

    def _wait_ready(self, fb: _InFlight) -> None:
        """Block until the bucket's device work is done."""
        wait_ready(fb.event)

    def _salvage(self) -> None:
        """Settle whatever is in flight before propagating a primary
        error; a secondary settle failure already requeued its requests,
        so it is deliberately swallowed here."""
        try:
            self._settle(list(self._inflight))
        except Exception:
            pass

    def _fail_tickets(self, requests: list[_Request],
                      err: Exception) -> None:
        """Unrecoverable failure: the tickets fail with ``err`` (claimed
        through :meth:`results`) instead of going back to the queue."""
        with self._cv:
            for r in requests:
                self._rollouts.pop(r.ticket, None)
                self._cancelled.discard(r.ticket)
                self._failed[r.ticket] = err
            self._cv.notify_all()

    # -- the fault ladder --------------------------------------------------
    def _bucket_failure(self, shape: tuple[int, ...], device: int,
                        err: Exception,
                        tickets: list[int]) -> Exception | None:
        """One failed bucket through the degradation ladder.

        Books the failure, advances the backend-fallback and slot-
        eviction counters, then charges the shape group's retry budget:
        returns ``None`` when a retry is scheduled (after sleeping the
        backoff) or the terminal error once the budget is exhausted (the
        caller raises; the requests are back in the queue either way).
        """
        now = time.monotonic()
        with self._lock:
            self.stats_.bucket_failures += 1
            self._device_stats[device]["failures"] += 1
            self._dev_fail[device] += 1
            self._group_failures[shape] = self._group_failures.get(
                shape, 0) + 1
            # ladder rung 2: persistent faults -> degrade the group to the
            # fallback backend pin (a NEW cache key, so the faulty
            # executable is simply never asked again)
            if (self.fallback_after is not None
                    and self._group_failures[shape] >= self.fallback_after
                    and self._group_backends.get(shape)
                    != self.fallback_backends
                    and self.backends != self.fallback_backends):
                self._group_backends[shape] = list(self.fallback_backends)
                self._caps.pop(shape, None)   # re-walk the cap if needed
                self.stats_.fallbacks += 1
            # ladder rung 3: a persistently failing SLOT leaves the
            # rotation (probation slots get one strike)
            strikes = 1 if self._probation[device] else self.evict_after
            if self._dev_fail[device] >= strikes:
                self._evict_device(device, now)
            pol = self._retry.get(shape)
            if pol is None:
                pol = self._retry[shape] = self.restart.clone()
        try:
            delay = pol.on_failure(err)
        except RuntimeError:
            return ValueError(
                f"serving bucket of shape {shape} failed for tickets "
                f"{tickets}: {err} (retry budget exhausted after "
                f"{pol.max_failures} retries); the failed requests stay "
                f"queued and completed results are returned by the next "
                f"flush()")
        with self._lock:
            self.stats_.retries += 1
        time.sleep(delay)
        return None

    def _maybe_shed(self) -> None:
        """Ladder rung 4: deadline pressure sheds the lowest-priority
        PENDING class (requests already dispatched always settle)."""
        if self.shed_miss_rate is None:
            return
        with self._cv:
            win = self._deadline_window
            if len(win) < self.shed_window:
                return
            if sum(win) / len(win) <= self.shed_miss_rate:
                return
            prios = {r.priority for r in self._pending}
            if len(prios) < 2:
                return     # nothing is "lowest" in a uniform queue
            low = min(prios)
            shed = [r for r in self._pending if r.priority == low]
            self._pending = [r for r in self._pending if r.priority != low]
            for r in shed:
                self._rollouts.pop(r.ticket, None)
                self._failed[r.ticket] = RequestShed(
                    f"ticket {r.ticket} (priority {r.priority}) shed: "
                    f"deadline-miss rate over the last {len(win)} "
                    f"deadline-carrying requests exceeded "
                    f"{self.shed_miss_rate}")
            self.stats_.shed += len(shed)
            win.clear()     # fresh window before the next shed decision
            self._cv.notify_all()

    def _admit(self) -> None:
        """Admit every pending request into dispatched buckets NOW.

        Continuous batching: buckets form from whatever has been
        submitted by this turn (grouped by shape, capped by admission
        control) — a late submit rides the next turn's buckets instead of
        waiting for this group to fill.  A request leaves the queue the
        moment its bucket dispatches; a bucket that fails to plan or
        launch fails fast (planner errors and launch checks are
        deterministic), while an injected dispatch fault goes through the
        retry ladder like a settle failure.  Either way failed requests
        stay queued and the raised error names the shape and tickets.
        """
        self._readmit_devices()
        self._maybe_shed()
        with self._lock:
            if not self._pending:
                return
            # group by (shape, next-hop signature): plain requests carry
            # the empty signature, a rollout the identity of its NEXT
            # segment
            by_shape: dict[tuple, list[_Request]] = {}
            for r in self._pending:
                sig = r.rollout.signature() if r.rollout else ()
                by_shape.setdefault((tuple(r.state.shape), sig),
                                    []).append(r)
        for shape, _sig in sorted(by_shape):
            group = by_shape[(shape, _sig)]
            try:
                cap = self.bucket_cap(shape)
            except Exception as e:
                self._salvage()
                raise _queued_failure(shape, group, e) from e
            for i in range(0, len(group), cap):
                with self._lock:
                    # revalidate against concurrent cancel()
                    chunk = [r for r in group[i:i + cap]
                             if r in self._pending]
                if not chunk:
                    continue
                try:
                    fb = self._dispatch_bucket(shape, cap, chunk)
                except Exception as e:
                    if not _recoverable(e):
                        self._salvage()
                        raise _queued_failure(shape, chunk, e) from e
                    di = self._device_of(shape)
                    terminal = self._bucket_failure(
                        shape, di, e, [r.ticket for r in chunk])
                    if terminal is None:
                        continue          # requests stay queued; next turn
                    self._salvage()
                    raise terminal from e
                with self._lock:
                    ids = {r.ticket for r in chunk}
                    still = {r.ticket for r in self._pending
                             if r.ticket in ids}
                    # a ticket cancelled DURING the dispatch window is
                    # settle-then-drop like any in-flight cancel
                    self._cancelled.update(ids - still)
                    self._pending = [r for r in self._pending
                                     if r.ticket not in ids]
                    self._inflight.append(fb)
                if not self.async_dispatch:
                    self._settle([fb])

    def _settle(self, buckets: list[_InFlight]) -> int:
        """Wait for the given in-flight buckets, book stats + latencies,
        move results to ``_done``.  A bucket whose device work failed
        with a recoverable error goes through the fault ladder
        (:meth:`_bucket_failure`): its requests requeue under the shape
        group's retry budget, its executable stays COLD, and only an
        exhausted budget raises — after the rest of the buckets settled.
        Any other error fails the bucket's tickets and propagates at
        once."""
        settled = 0
        failure: Exception | None = None
        for fb in buckets:
            # the bucket stays in _inflight THROUGH the device wait so a
            # concurrent results()/cancel() always sees its tickets; it
            # leaves only under the lock, at booking or requeue
            with self._lock:
                if fb not in self._inflight:
                    continue  # already settled by an earlier salvage pass
            try:
                chaos.fire("serve.settle", shape=_shape_str(fb.shape),
                           device=fb.device)
                self._wait_ready(fb)
            except Exception as e:
                with self._lock:
                    self._inflight.remove(fb)
                    keep = [r for r in fb.requests
                            if r.ticket not in self._cancelled]
                    for r in fb.requests:
                        if r.ticket in self._cancelled:
                            self._cancelled.discard(r.ticket)
                            self._rollouts.pop(r.ticket, None)
                    if _recoverable(e):
                        self._pending.extend(keep)
                if not _recoverable(e):
                    self._fail_tickets(keep, e)
                    raise
                terminal = self._bucket_failure(
                    fb.shape, fb.device, e, [r.ticket for r in keep])
                if terminal is not None and failure is None:
                    failure = terminal
                    failure.__cause__ = e
                continue
            now = time.perf_counter()
            dt = now - fb.t0
            final = fb.out[0] if fb.segment is not None else fb.out
            dev = self._devices[fb.device]
            if dev.type == "cuda":
                # results are read on the default stream: keep their
                # memory from the slot stream's reuse until that is done
                outs = [final] + (list(fb.out[1]) if fb.segment is not None
                                  else [])
                for t in outs:
                    t.record_stream(torch.cuda.default_stream(dev))
            with self._cv:
                self._inflight.remove(fb)
                warm = fb.entry.mark_ready(dt)
                st = self.stats_
                if warm:
                    st.wall_s += dt
                    st.warm_states += len(fb.requests)
                else:
                    st.compile_wall_s += dt
                st.batches += 1
                st.padded_states += fb.bucket - len(fb.requests)
                ds = self._device_stats[fb.device]
                ds["batches"] += 1
                ds["states"] += len(fb.requests)
                # success resets the ladder counters for this group/slot
                self._dev_fail[fb.device] = 0
                self._probation[fb.device] = False
                self._dev_cooldown[fb.device] = self.evict_cooldown_s
                self._group_failures[fb.shape] = 0
                pol = self._retry.get(fb.shape)
                if pol is not None:
                    pol.on_success()
                for i, r in enumerate(fb.requests):
                    res = final if fb.bucket == 1 else final[i]
                    if r.ticket in self._cancelled:
                        # settle-then-drop: the bucket ran, the
                        # cancelled ticket's share is discarded
                        self._cancelled.discard(r.ticket)
                        self._rollouts.pop(r.ticket, None)
                        continue
                    if r.rollout is not None:
                        task = r.rollout
                        if r.attempts > 1:
                            st.rollout_recovered += 1
                        task.seg += 1
                        task.done_steps += fb.segment.steps
                        if fb.segment.emit:
                            # one-segment program: at most one emit, == res
                            task.emits.append((task.done_steps, res))
                        if not task.done:
                            # requeue for the next segment, preserving the
                            # submit clock but with a fresh attempt count;
                            # a slot's stream orders itself, the event
                            # orders any other slot after this bucket
                            self._pending.append(dataclasses.replace(
                                r, state=res, attempts=0, ready=fb.event))
                            continue
                    self._done[r.ticket] = res
                    st.requests += 1
                    lat = now - r.submit_t
                    st.latencies_s.append(lat)
                    if r.deadline_s is not None:
                        miss = lat > r.deadline_s
                        st.deadline_misses += miss
                        self._deadline_window.append(int(miss))
                    settled += 1
                self._cv.notify_all()
        if failure is not None:
            raise failure
        return settled

    def step(self) -> int:
        """One scheduler turn; returns how many requests settled.

        Admits every pending request into freshly dispatched buckets,
        then settles the buckets dispatched on EARLIER turns — while the
        device works on last turn's buckets, this turn's staging and
        launches happen on the host, and only then does the host block.
        Turns serialize on the step lock (safe alongside the background
        stepper); device waits happen outside the state lock, so
        concurrent ``submit()`` never waits on a sweep.
        """
        with self._step_lock:
            with self._lock:
                before = self.stats_.requests
                prior = list(self._inflight)
            self._admit()
            if self.async_dispatch:
                self._settle(prior)
            with self._lock:
                return self.stats_.requests - before

    def flush(self) -> dict[int, torch.Tensor]:
        """Step until nothing is pending or in flight; return every
        unclaimed ``{ticket: evolved state}`` (the claim).

        If a bucket fails, its requests retry under the shape group's
        budget; once the budget exhausts the error names the offending
        shape/tickets, the failed bucket's requests stay queued (cancel
        or resubmit them), already-completed buckets are neither
        recomputed nor double-counted, and their results are returned by
        the next successful ``flush()`` — or individually by
        :meth:`results`.
        """
        while True:
            with self._lock:
                if not (self._pending or self._inflight):
                    break
            self.step()
        with self._lock:
            results, self._done = self._done, {}
            return results

    def serve(self, states: Sequence) -> list[torch.Tensor]:
        """Submit every state, flush, return results in submission order.

        Claims ONLY its own tickets: results the flush recovered for
        tickets submitted elsewhere go back to the server, still
        claimable via :meth:`results` or the next ``flush()``.
        """
        tickets = [self.submit(s) for s in states]
        results = self.flush()
        out = [results.pop(t) for t in tickets]
        with self._lock:
            self._done.update(results)
        return out

    __call__ = serve

    # -- reporting ---------------------------------------------------------
    def reset_stats(self) -> None:
        """Zero the serving counters (cache counters are left alone) —
        e.g. between a warm-up pass and a measured pass."""
        with self._lock:
            self.stats_ = ServeStats()

    def stats(self) -> dict:
        """Serving counters + latency percentiles + admission caps +
        fault-ladder state + per-slot columns, merged with the plan-cache
        stats (summed across slots; each slot row carries its own)."""
        with self._lock:
            st = self.stats_
            s = dataclasses.asdict(st)
            lat = s.pop("latencies_s")
            s["per_state_s"] = st.per_state_s
            s["throughput_states_per_s"] = st.throughput
            s["latency"] = {
                "count": len(lat),
                "p50_s": st.p50_latency_s,
                "p95_s": st.p95_latency_s,
                "mean_s": float(np.mean(lat)) if lat else 0.0,
                "max_s": float(np.max(lat)) if lat else 0.0,
            }
            s["admission"] = {_shape_str(shape): cap
                              for shape, cap in sorted(self._caps.items())}
            s["faults"] = {
                "bucket_failures": st.bucket_failures,
                "retries": st.retries,
                "fallbacks": st.fallbacks,
                "evictions": st.evictions,
                "mesh_shrinks": st.mesh_shrinks,
                "rollout_attempts": st.rollout_attempts,
                "rollout_recovered": st.rollout_recovered,
                "shed": st.shed,
            }
            s["degraded"] = {_shape_str(shape): list(b) for shape, b
                             in sorted(self._group_backends.items())}
            if self.mesh_shape is not None:
                s["meshes"] = {
                    _shape_str(shape): m.describe()
                    for shape, m in sorted(self._group_mesh.items())}
            s["stepper"] = {"running": self.running,
                            "error": str(self._stepper_error)
                            if self._stepper_error else None}
            per_dev = []
            for ds, cache in zip(self._device_stats, self.caches):
                row = dict(ds)
                row["plan_cache"] = cache.stats()
                per_dev.append(row)
            s["devices"] = per_dev
            if len(self.caches) == 1:
                s["plan_cache"] = self.cache.stats()
            else:
                merged: dict[str, int] = {}
                for cache in self.caches:
                    for k, v in cache.stats().items():
                        merged[k] = merged.get(k, 0) + v
                s["plan_cache"] = merged
            return s


# ---------------------------------------------------------------------------
# CLI: synthesize a mixed request stream and report throughput + latency
# ---------------------------------------------------------------------------

def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="star2d_r2",
                    help="PAPER_SUITE cell to serve")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--grid", type=int, default=48,
                    help="base spatial extent (a second shape at 2/3 of it "
                         "is mixed in to exercise shape grouping)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--boundary", default="periodic")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card; raises without one) or 'cpu'")
    ap.add_argument("--backends", default="cuda",
                    help="comma-separated backend pin ('' = full search)")
    ap.add_argument("--sync", action="store_true",
                    help="synchronous dispatch (settle each bucket "
                         "immediately) instead of overlapped")
    ap.add_argument("--no-admission", action="store_true",
                    help="disable the bucket-cliff admission cap")
    ap.add_argument("--all-devices", action="store_true",
                    help="route shape groups round-robin over every "
                         "visible card (one slot each)")
    ap.add_argument("--background", action="store_true",
                    help="drive the scheduler from the background stepper "
                         "thread (submit + blocking results) instead of "
                         "serve()")
    ap.add_argument("--chaos-settle", type=float, default=0.0,
                    help="inject seeded settle faults at this rate (the "
                         "retry ladder must recover; see "
                         "repro_torch.runtime.chaos)")
    args = ap.parse_args()

    spec = PAPER_SUITE()[args.cell]
    backends = [b for b in args.backends.split(",") if b] or None
    devices = [args.device]
    if args.all_devices:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    server = StencilServer(spec, args.steps, boundary=args.boundary,
                           max_batch=args.max_batch, backends=backends,
                           async_dispatch=not args.sync,
                           admission=not args.no_admission,
                           devices=devices)
    rng = np.random.default_rng(0)
    shapes = [(args.grid,) * spec.ndim,
              (max(2 * args.grid // 3, 8),) * spec.ndim]
    states = [rng.normal(size=shapes[i % len(shapes)]).astype(np.float32)
              for i in range(args.requests)]

    def run_pass():
        if args.background:
            server.start()
            try:
                tickets = [server.submit(s) for s in states]
                return [server.results(t, timeout_s=300.0) for t in tickets]
            finally:
                server.stop()
        return server.serve(states)

    plan = chaos.FaultPlan(seed=0)
    if args.chaos_settle > 0:
        plan.rule("serve.settle", rate=args.chaos_settle)
    with plan:
        t0 = time.perf_counter()
        run_pass()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_pass()
        warm = time.perf_counter() - t0

    s = server.stats()
    mode = "sync" if args.sync else "async"
    if args.background:
        mode += "+background"
    print(f"served {s['requests']} states of {args.cell} x {args.steps} "
          f"steps in {s['batches']} batches on {', '.join(map(str, devices))}"
          f" ({mode} dispatch, {s['padded_states']} padded slots)")
    print(f"cold pass {cold * 1e3:.1f} ms (plans + first calls: "
          f"{s['compile_wall_s'] * 1e3:.1f} ms), warm pass "
          f"{warm * 1e3:.1f} ms -> "
          f"{args.requests / warm:.1f} states/s warm")
    print(f"warm wall per state {s['per_state_s'] * 1e6:.0f} us; "
          f"latency p50 {s['latency']['p50_s'] * 1e3:.1f} ms / "
          f"p95 {s['latency']['p95_s'] * 1e3:.1f} ms; "
          f"plan cache: {s['plan_cache']['hits']} hits / "
          f"{s['plan_cache']['misses']} misses "
          f"(size {s['plan_cache']['size']})")
    caps = ", ".join(f"{k}<={v}" for k, v in s["admission"].items())
    print(f"admission caps: {caps or '-'}")
    if args.chaos_settle > 0:
        f = s["faults"]
        print(f"chaos: {plan.fired()} injected faults -> "
              f"{f['bucket_failures']} bucket failures, {f['retries']} "
              f"retries, {f['fallbacks']} fallbacks (all recovered)")
    if len(s["devices"]) > 1:
        print("device        batches  states  fails  shapes")
        for row in s["devices"]:
            print(f"{row['device']:<13s} {row['batches']:7d} "
                  f"{row['states']:7d} {row['failures']:6d}  "
                  f"{','.join(row['shapes']) or '-'}")


if __name__ == "__main__":
    main()
