"""Spans of the port's layers, and their totals over one profiling session.

Tracing is on exactly while a ``torch.profiler`` session is active, in
every thread of the process (:func:`enabled`); there is no other switch.

* Off, :func:`span` returns one shared no-op context: no
  ``record_function`` is entered, no byte count is computed and no CUDA
  call is made.
* On, a span enters ``record_function(name)``, so it sits on the
  profiler's timeline beside the device ops it launches, its parent given
  by nesting.  It also adds to the session's totals for ``name``: its
  count and its bytes.  A span given a CUDA ``device`` also records its
  device time with a pair of CUDA events on that device's current stream,
  resolved when the session is read.

A span entered with tracing on after one entered with tracing off starts a
new session: the totals are cleared.  Spans of every thread (the stencil
server's stepper too) add to the same totals.  No span is entered inside a
``kernel.*`` span: a kernel's plain version (a CPU tensor) is the kernel's
own work, as :class:`repro_torch.launch.op_analysis.OpCounter` counts it.

    with trace.span("halo.pad", copy_bytes, x.device, x, pads):
        y = x.index_select(axis, idx)
    trace.session()["halo.pad"]["bytes"]
"""
from __future__ import annotations

import threading

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

__all__ = ["span", "enabled", "session"]

#: spans of this prefix are kernel launches; nothing is traced inside one
KERNEL_PREFIX = "kernel."

#: timed spans whose events are left unread before the finished ones are
#: resolved, so a session nobody reads holds a bounded number of events
_SETTLE_AT = 256


class _Off:
    """The span of untraced code."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()

_lock = threading.Lock()
_totals: dict[str, dict] = {}
_pending: list[tuple[int, str, object, object]] = []  # (gen, name, start, end)
_gen = 0             # the session's number
_fresh = True        # a span ran untraced since the last traced one
_local = threading.local()   # .open: this thread's open traced spans


def enabled() -> bool:
    """Whether spans are traced now: a profiler session is active.  Every
    profiler's start and stop sets this flag for the whole process;
    ``torch.autograd._profiler_enabled()`` answers for the calling thread
    only, and so would miss the stencil server's stepper thread."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, nbytes=0, device: torch.device | None = None, *args):
    """A context around one piece of a layer's work.

    ``nbytes``: the bytes it moves, or a function that returns them from
    ``args`` (called only when tracing is on, so no closure is built at
    the call site).  ``device``: where its work runs; on a CUDA device the
    span's device time is recorded."""
    global _fresh
    if not enabled():
        _fresh = True
        return _OFF
    if callable(nbytes):
        nbytes = nbytes(*args)
    return _On(name, nbytes, device)


def _open() -> list:
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


class _On:
    """The span of traced code (:func:`span`)."""

    __slots__ = ("name", "nbytes", "device", "rf", "start", "stream", "skip")

    def __init__(self, name, nbytes, device):
        self.name, self.nbytes, self.device = name, nbytes, device

    def __enter__(self):
        global _fresh
        stack = _open()
        self.skip = any(s.startswith(KERNEL_PREFIX) for s in stack)
        if self.skip:
            return self
        if _fresh:
            with _lock:
                _clear()
                _fresh = False
        stack.append(self.name)
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.start = None
        if self.device is not None and self.device.type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.skip:
            return False
        end = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
        self.rf.__exit__(*exc)
        _open().pop()
        with _lock:
            e = _totals.setdefault(self.name, {"count": 0, "bytes": 0,
                                               "device_s": None})
            e["count"] += 1
            e["bytes"] += int(self.nbytes)
            if end is not None:
                _pending.append((_gen, self.name, self.start, end))
            settle = len(_pending) >= _SETTLE_AT
        if settle:
            _settle(wait=False)
        return False


def _clear() -> None:
    """Start a new session (under ``_lock``)."""
    global _gen
    _totals.clear()
    _pending.clear()
    _gen += 1


def _settle(wait: bool) -> None:
    """Add the device time of the pending timed spans to their totals:
    all of them (waiting for their events), or the leading ones already
    done.  The events are waited on outside the lock, so spans of other
    threads do not wait with them."""
    with _lock:
        pend = list(_pending)
        _pending.clear()
    n = len(pend)
    if wait:
        for *_, end in pend:
            end.synchronize()
    else:
        n = next((i for i, (*_, end) in enumerate(pend) if not end.query()),
                 n)
    times = [(gen, name, start.elapsed_time(end) * 1e-3)
             for gen, name, start, end in pend[:n]]
    with _lock:
        _pending[:0] = [p for p in pend[n:] if p[0] == _gen]
        for gen, name, s in times:
            e = _totals.get(name)
            if gen == _gen and e is not None:
                e["device_s"] = (e["device_s"] or 0.0) + s


def session() -> dict:
    """Take the session's totals, ``{name: {"count", "bytes",
    "device_s"}}``, and clear them; ``device_s`` is None for an untimed
    span (or one whose work ran on the CPU).  Waits for the pending device
    times."""
    _settle(wait=True)
    with _lock:
        out = {k: dict(v) for k, v in _totals.items()}
        _clear()
    return out
