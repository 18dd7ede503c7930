"""Device timelines from ``torch.profiler``, reduced to what the per-layer
metrics and the result's ``breakdown`` read.

:func:`profiler_events` turns a stopped profiler into plain
``(name, start_us, end_us)`` tuples, device and host apart;
:func:`summarize` reduces them over the benchmark's window span.  The
reduction takes tuples only, so it is tested without a card.
"""
from __future__ import annotations

import dataclasses

__all__ = ["DeviceTrace", "profiler_events", "summarize", "union_s",
           "WINDOW_SPAN"]

#: the benchmark's span around a profiled sub-window
WINDOW_SPAN = "portbench.window"
TOP = 10
#: a device op's name in the breakdown is cut to this many characters
NAME_CHARS = 160


@dataclasses.dataclass
class DeviceTrace:
    """One profiled sub-window: its length, the device's activity in it,
    and the host's activity during the device's idle gaps."""

    window_s: float
    busy_s: float                 # union of device activity
    device_s: float               # summed device op time
    kernel_s: float               # summed time of the listed kernels
    h2d_s: float                  # summed host-to-device copy time
    ops: list                     # [[name, seconds]], most time first
    gaps: list                    # [[host activity, seconds]], most first
    n_device_ops: int


def profiler_events(prof) -> tuple[list, list]:
    """(device events, host events) of a stopped profiler, each a list of
    ``(name, start_us, end_us)``."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        (device if e.device_type == DeviceType.CUDA else host).append(item)
    return device, host


def union_s(intervals) -> float:
    """Seconds covered by the union of ``(start_us, end_us)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def _gaps(intervals, w0: float, w1: float) -> list[tuple[float, float]]:
    gaps, t = [], w0
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def _name_gaps(gaps, host, span) -> list:
    """Each gap named by the innermost host event covering its midpoint,
    summed by name: ``[[f"{name} x{count}", seconds]]``, most first."""
    events = sorted((s, e, n) for n, s, e in host if (n, s, e) != span)
    totals: dict[str, list] = {}
    active, i = [], 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        m = (a + b) / 2
        while i < len(events) and events[i][0] <= m:
            active.append(events[i])
            i += 1
        active = [ev for ev in active if ev[1] >= m]
        name = (min(active, key=lambda ev: ev[1] - ev[0])[2] if active
                else "(no host op)")
        t = totals.setdefault(name, [0.0, 0])
        t[0] += (b - a) * 1e-6
        t[1] += 1
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])[:TOP]
    return [[f"{name} x{n}", s] for name, (s, n) in ranked]


def summarize(device, host, kernel_symbols,
              span_name: str = WINDOW_SPAN) -> DeviceTrace | None:
    """Reduce one profiled sub-window, bounded by the host span
    ``span_name``; None where the span is missing."""
    spans = [ev for ev in host if ev[0] == span_name]
    if not spans:
        return None
    span = spans[0]
    w0, w1 = span[1], span[2]
    # a host span that launched device work also shows on the device's
    # timeline (a user annotation, named as on the host): it is no op
    spans_on_host = {n for n, _, _ in host}
    clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in device
               if min(e, w1) > max(s, w0) and n not in spans_on_host]
    by_name: dict[str, float] = {}
    kernel = h2d = 0.0
    for n, s, e in clipped:
        dt = (e - s) * 1e-6
        by_name[n] = by_name.get(n, 0.0) + dt
        low = n.lower()
        if any(k in n for k in kernel_symbols):
            kernel += dt
        elif "memcpy" in low and "htod" in low:
            h2d += dt
    intervals = [(s, e) for _, s, e in clipped]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    ops = [[n[:NAME_CHARS], s] for n, s in ops]
    return DeviceTrace(
        window_s=(w1 - w0) * 1e-6,
        busy_s=union_s(intervals),
        device_s=sum(by_name.values()),
        kernel_s=kernel,
        h2d_s=h2d,
        ops=ops,
        gaps=_name_gaps(_gaps(intervals, w0, w1), host, span),
        n_device_ops=len(clipped))
