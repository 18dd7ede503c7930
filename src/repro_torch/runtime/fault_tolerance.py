"""Fault-tolerance runtime: step heartbeats, straggler detection, restart
policy, elastic re-mesh planning.

The port's copy of the JAX package's ``runtime/fault_tolerance.py`` (pure
Python).  Single-controller view: in a real multi-host deployment each
host runs this monitor and publishes heartbeats; here the same objects
instrument the rollout executor (:func:`repro_torch.rollout.executor
.run_checkpointed`) and the serving scheduler
(:class:`repro_torch.launch.serve_stencil.StencilServer`), and are
unit-tested with injected failures/stragglers
(:mod:`repro_torch.runtime.chaos`).

Both :class:`HeartbeatMonitor` and :class:`RestartPolicy` are plain
dataclasses: construct once as a *template*, hand copies out per
supervised unit with :meth:`clone` (a server clones one policy per
shape group; the rollout executor takes one per program), and override
per call where a single step needs a different budget
(``end_step(hard_timeout_s=...)``, ``on_failure(err, backoff_s=...)``).
:func:`supervised` is the shared retry loop both executors drive.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Callable, Optional

__all__ = ["HeartbeatMonitor", "RestartPolicy", "plan_elastic_mesh",
           "StepTimeout", "supervised"]


class StepTimeout(RuntimeError):
    pass


@dataclasses.dataclass
class HeartbeatMonitor:
    """EWMA step-time tracker with straggler flagging.

    A step counts as a straggler when it exceeds ``threshold`` x the EWMA.
    The trainer logs them and (configurably) aborts the step so the restart
    policy can kick in — the moral equivalent of preemption handling.

    Configuration is dataclass fields (``threshold``, ``ewma``, ``window``,
    ``hard_timeout_s``); runtime state (``mean``, ``history``,
    ``stragglers``) initializes empty and is excluded from ``clone()``.
    """

    threshold: float = 3.0
    ewma: float = 0.9
    window: int = 50
    hard_timeout_s: Optional[float] = None

    mean: Optional[float] = dataclasses.field(default=None, init=False)
    history: deque = dataclasses.field(default=None, init=False, repr=False)
    stragglers: list = dataclasses.field(default_factory=list, init=False,
                                         repr=False)

    def __post_init__(self):
        self.history = deque(maxlen=self.window)
        self._t0: Optional[float] = None
        self._step = 0

    # historical alias (pre-dataclass constructor arg was ``ewma`` but the
    # attribute was ``ewma_coef``; both names keep working)
    @property
    def ewma_coef(self) -> float:
        return self.ewma

    def clone(self, **overrides) -> "HeartbeatMonitor":
        """A FRESH monitor with this one's configuration (state zeroed),
        optionally overriding any config field."""
        cfg = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self) if f.init}
        cfg.update(overrides)
        return HeartbeatMonitor(**cfg)

    def start_step(self, step: int):
        self._step = step
        self._t0 = time.monotonic()

    def end_step(self, hard_timeout_s: Optional[float] = ...) -> float:
        """Close the bracketed step; ``hard_timeout_s`` overrides the
        configured hard timeout for THIS step only (``None`` disables)."""
        timeout = self.hard_timeout_s if hard_timeout_s is ... \
            else hard_timeout_s
        dt = time.monotonic() - self._t0
        self.history.append(dt)
        is_straggler = self.mean is not None and dt > self.threshold * self.mean
        if is_straggler:
            self.stragglers.append((self._step, dt, self.mean))
        else:
            self.mean = dt if self.mean is None else (
                self.ewma * self.mean + (1 - self.ewma) * dt)
        if timeout is not None and dt > timeout:
            raise StepTimeout(f"step {self._step} took {dt:.2f}s "
                              f"(> {timeout}s)")
        return dt

    def record(self, step: int, dt: float):
        """Offline variant for injected tests."""
        self._step, self._t0 = step, time.monotonic() - dt
        self.history.append(dt)
        if self.mean is not None and dt > self.threshold * self.mean:
            self.stragglers.append((step, dt, self.mean))
        else:
            self.mean = dt if self.mean is None else (
                self.ewma * self.mean + (1 - self.ewma) * dt)


@dataclasses.dataclass
class RestartPolicy:
    """Bounded-retry restart with exponential backoff."""

    max_failures: int = 3
    backoff_s: float = 0.1
    backoff_factor: float = 2.0
    failures: int = 0

    def clone(self, **overrides) -> "RestartPolicy":
        """A fresh zero-failure policy with this one's budget/backoff
        (the template pattern: one configured policy, one live copy per
        supervised unit), optionally overriding any field."""
        cfg = dict(max_failures=self.max_failures, backoff_s=self.backoff_s,
                   backoff_factor=self.backoff_factor)
        cfg.update(overrides)
        return RestartPolicy(**cfg)

    def on_failure(self, err: BaseException, *,
                   backoff_s: Optional[float] = None) -> float:
        """Record a failure; returns the backoff to sleep, raises if the
        budget is exhausted (resetting the counter so the caller can
        intervene and retry from a clean budget).  ``backoff_s``
        overrides the base backoff for this failure only."""
        self.failures += 1
        if self.failures > self.max_failures:
            self.failures = 0
            raise RuntimeError(
                f"restart budget exhausted ({self.max_failures})") from err
        base = self.backoff_s if backoff_s is None else backoff_s
        return base * self.backoff_factor ** (self.failures - 1)

    def on_success(self):
        self.failures = 0

    @property
    def remaining(self) -> int:
        return max(0, self.max_failures - self.failures)


def supervised(fn: Callable[[int], "object"], *,
               restart: Optional[RestartPolicy] = None,
               monitor: Optional[HeartbeatMonitor] = None,
               step: int = 0,
               on_retry: Optional[Callable] = None):
    """Run ``fn(attempt)`` under heartbeat + restart supervision.

    The ONE retry loop shared by the rollout executor (per segment) and
    available to any other driver: ``monitor`` brackets each attempt as
    a heartbeat step (a ``hard_timeout_s`` overrun raises
    :class:`StepTimeout` into the retry path), ``restart`` converts a
    failed attempt into sleep-backoff-and-retry until its budget
    exhausts (without one, the first failure propagates).  ``on_retry``
    observes ``(attempt, error, backoff_s)`` before each sleep.

    Returns ``fn``'s value from the first successful attempt; resets the
    policy's failure counter on success.
    """
    attempt = 0
    while True:
        attempt += 1
        try:
            if monitor is not None:
                monitor.start_step(step)
            out = fn(attempt)
            if monitor is not None:
                monitor.end_step()
        except Exception as e:
            if restart is None:
                raise
            delay = restart.on_failure(e)   # raises past the budget
            if on_retry is not None:
                on_retry(attempt, e, delay)
            time.sleep(delay)
            continue
        if restart is not None:
            restart.on_success()
        return out


def plan_elastic_mesh(available_devices: int, model_parallel: int,
                      pods: int = 1) -> tuple[int, ...]:
    """Largest (pods, data, model) mesh that fits the surviving devices.

    Keeps model-parallel intact (parameter shards must stay complete) and
    shrinks data-parallel — the standard elastic-degradation direction.
    """
    if available_devices < model_parallel:
        raise ValueError("cannot keep a model replica alive: "
                         f"{available_devices} < MP {model_parallel}")
    per_pod = available_devices // pods
    data = per_pod // model_parallel
    if data < 1:
        raise ValueError("no full data-parallel replica fits")
    # keep power-of-two data-parallel for collective efficiency
    data = 2 ** int(math.log2(data))
    if pods > 1:
        return (pods, data, model_parallel)
    return (data, model_parallel)
