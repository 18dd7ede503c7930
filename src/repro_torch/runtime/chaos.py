"""Deterministic, seeded fault injection for the serving runtime.

The port's copy of the JAX package's ``runtime/chaos.py`` (pure Python
and numpy): the same sites, rules and seeded streams, so a plan fires at
the same call indices in both packages.

Every recovery path in the stack (bucket requeue, per-group retry
budgets, backend fallback, device eviction, checkpoint resume) is only
trustworthy if it can be EXERCISED on demand, reproducibly.  This module
is that harness: a :class:`FaultPlan` binds named *fault sites* — fixed
strings the runtime fires at well-known points — to seeded rules that
raise, delay, or corrupt on chosen calls.  Activating a plan is a
context manager; with no plan active every hook is a no-op costing one
global read.

Fault sites (the instrumented points):

    ``cache.compile``     PlanCache.get/get_program, before compiling a
                          missing executable (ctx: ``backend``, ``batch``)
    ``serve.dispatch``    StencilServer bucket launch, before the
                          executable is dispatched (ctx: ``shape``,
                          ``device``, ``bucket``)
    ``serve.settle``      StencilServer settle, before the bucket's
                          CUDA event is synchronised — the deferred-
                          device-error shape under asynchronous launches
                          (ctx: ``shape``, ``device``)
    ``checkpoint.write``  save_checkpoint, before the atomic rename
                          (``action="raise"`` = crash mid-write leaving
                          a ``.tmp``; ``action="corrupt"`` = torn write:
                          the rename happens but the manifest is
                          truncated) (ctx: ``step``)
    ``checkpoint.read``   restore_checkpoint entry (ctx: ``step``)
    ``rollout.segment``   run_checkpointed, after a segment's dispatch
                          and before its readiness wait (ctx:
                          ``segment``, ``attempt``)
    ``rollout.update``    CompiledRollout.run_segment, after the
                          update op applied (ctx: ``segment``)
    ``dist.device``       DistributedStepper call entry, once a call
                          (ctx: ``devices``, ``mesh``)
    ``dist.chunk``        once per fused chunk (ctx: + ``chunk``,
                          ``depth``)
    ``dist.exchange``     once per fused chunk's deep halo exchange
                          (ctx: + ``chunk``, ``width``); ``corrupt``
                          runs the call on a perturbed input, then
                          raises (transport checksum)

Determinism: each rule owns an independent ``numpy`` Generator seeded
from ``(plan seed, rule index)`` plus a per-rule call counter, so a
given plan fires at the same call indices on every run regardless of
wall clock; ``at=(i, ...)`` pins exact call indices with no randomness
at all.  ``plan.log`` records every fired fault for assertions.

    plan = (FaultPlan(seed=7)
            .rule("serve.settle", rate=0.3, times=4)
            .rule("cache.compile", at=(1,)))
    with plan:
        server.serve(states)        # recovery paths actually run
    assert plan.fired("serve.settle") >= 1
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Iterator, Mapping

import numpy as np

__all__ = ["FaultError", "FaultRule", "FaultPlan", "FAULT_SITES",
           "fire", "active"]

#: the instrumented sites, for typo-guarding rule construction
FAULT_SITES = (
    "cache.compile",
    "serve.dispatch",
    "serve.settle",
    "checkpoint.write",
    "checkpoint.read",
    "rollout.segment",
    "rollout.update",
    "dist.device",
    "dist.chunk",
    "dist.exchange",
)

_ACTIONS = ("raise", "delay", "corrupt")


class FaultError(RuntimeError):
    """An injected fault (never raised by real code paths, so tests can
    assert a failure came from the harness)."""

    def __init__(self, site: str, index: int, message: str = ""):
        self.site = site
        self.index = index
        super().__init__(
            f"injected fault at {site}[{index}]"
            + (f": {message}" if message else ""))


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One site's injection schedule.

    A rule matches a :func:`fire` call when the site equals ``site`` and
    every ``match`` entry equals the call's context value.  Matching
    calls are numbered 0, 1, 2, ... per rule; the rule fires on call
    ``i`` when ``i in at`` or (independently per call) with probability
    ``rate`` from the rule's own seeded stream, at most ``times`` times
    total (``None`` = unbounded).

    ``action``: ``"raise"`` raises :class:`FaultError`; ``"delay"``
    sleeps ``delay_s`` and returns; ``"corrupt"`` returns the string
    ``"corrupt"`` for the call site to implement (e.g. a torn
    checkpoint write).
    """

    site: str
    rate: float = 0.0
    at: tuple[int, ...] = ()
    times: int | None = None
    action: str = "raise"
    delay_s: float = 0.0
    match: Mapping[str, Any] | None = None
    message: str = ""

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {FAULT_SITES}")
        if self.action not in _ACTIONS:
            raise ValueError(f"action must be one of {_ACTIONS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError("rate in [0, 1]")
        object.__setattr__(self, "at", tuple(int(i) for i in self.at))
        if self.match is not None:
            object.__setattr__(self, "match", dict(self.match))


class FaultPlan:
    """A seeded set of :class:`FaultRule` s, activatable as a context.

    Thread-safe: the server's background stepper and concurrent
    submitters fire through the same plan; per-rule counters are guarded
    by one lock.  Only one plan can be active at a time (nesting plans
    would make "which rule fired" ambiguous).
    """

    def __init__(self, seed: int = 0,
                 rules: Iterator[FaultRule] | None = None):
        self.seed = int(seed)
        self._rules: list[FaultRule] = []
        self._rngs: list[np.random.Generator] = []
        self._calls: list[int] = []
        self._fires: list[int] = []
        #: every fired fault: (site, per-rule call index, action, ctx)
        self.log: list[tuple[str, int, str, dict]] = []
        #: parallel record of WHICH rule fired each log entry:
        #: (rule index, per-rule call index) — replay()'s raw material
        self._rule_log: list[tuple[int, int]] = []
        self._lock = threading.Lock()
        for r in rules or ():
            self._append(r if isinstance(r, FaultRule) else FaultRule(**r))

    # -- construction ------------------------------------------------------
    def rule(self, site: str, **kw) -> "FaultPlan":
        """Append one rule (builder style; returns self)."""
        self._append(FaultRule(site, **kw))
        return self

    def _append(self, r: FaultRule) -> None:
        self._rules.append(r)
        self._rngs.append(np.random.default_rng([self.seed,
                                                 len(self._rules) - 1]))
        self._calls.append(0)
        self._fires.append(0)

    # -- introspection -----------------------------------------------------
    def fired(self, site: str | None = None) -> int:
        """How many faults fired (at one site, or overall)."""
        with self._lock:
            return len([1 for s, *_ in self.log
                        if site is None or s == site])

    def calls(self, site: str) -> int:
        """How many :func:`fire` calls matched any rule at ``site``."""
        with self._lock:
            return max((self._calls[i]
                        for i, r in enumerate(self._rules)
                        if r.site == site), default=0)

    def stats(self) -> dict:
        with self._lock:
            return {"rules": len(self._rules),
                    "fired": len(self.log),
                    "by_site": {s: len([1 for t, *_ in self.log if t == s])
                                for s in {r.site for r in self._rules}}}

    def replay(self) -> "FaultPlan":
        """Export the faults that FIRED as a new plan pinned to exact
        ``at=`` call indices — no randomness left.

        One rule per original rule (same site / match / action, so the
        per-rule matching-call numbering is identical), with ``rate=0``
        and ``at=`` the per-rule indices that actually fired.  Running
        the replayed plan against the same call pattern reproduces the
        original run's faults exactly — the debug handle for a failure
        that looks nondeterministic but was seeded.
        """
        with self._lock:
            fired: dict[int, list[int]] = {}
            for ri, idx in self._rule_log:
                fired.setdefault(ri, []).append(idx)
            rules = [dataclasses.replace(
                r, rate=0.0, times=None,
                at=tuple(sorted(set(fired.get(i, ())))))
                for i, r in enumerate(self._rules)]
        return FaultPlan(seed=self.seed, rules=rules)

    # -- the hook ----------------------------------------------------------
    def fire(self, site: str, **ctx) -> str | None:
        """Evaluate the plan at one site visit; raise / delay / return.

        Returns ``None`` (no fault), or a non-raising action string the
        call site implements (currently only ``"corrupt"``).
        """
        delay = None
        outcome: str | None = None
        err: FaultError | None = None
        with self._lock:
            for i, r in enumerate(self._rules):
                if r.site != site:
                    continue
                if r.match is not None and any(
                        ctx.get(k) != v for k, v in r.match.items()):
                    continue
                idx = self._calls[i]
                self._calls[i] += 1
                if r.times is not None and self._fires[i] >= r.times:
                    continue
                hit = idx in r.at or (
                    r.rate > 0.0 and self._rngs[i].random() < r.rate)
                if not hit:
                    continue
                self._fires[i] += 1
                self.log.append((site, idx, r.action, dict(ctx)))
                self._rule_log.append((i, idx))
                if r.action == "raise":
                    err = FaultError(site, idx, r.message)
                elif r.action == "delay":
                    delay = r.delay_s
                else:
                    outcome = r.action
                break
        if err is not None:
            raise err
        if delay is not None:
            time.sleep(delay)
        return outcome

    # -- activation --------------------------------------------------------
    def __enter__(self) -> "FaultPlan":
        global _ACTIVE
        with _GLOBAL_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("a FaultPlan is already active")
            _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        with _GLOBAL_LOCK:
            _ACTIVE = None


_GLOBAL_LOCK = threading.Lock()
_ACTIVE: FaultPlan | None = None


def active() -> FaultPlan | None:
    """The currently installed plan (None almost always)."""
    return _ACTIVE


def fire(site: str, **ctx) -> str | None:
    """The runtime-side hook: no-op unless a plan is active.

    Call sites pass a small JSON-ish context (``shape="16x16"``,
    ``device=1``, ...) that rules can filter on with ``match=``.
    """
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.fire(site, **ctx)
