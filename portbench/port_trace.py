"""The port's own trace as the per-layer metrics read it.

``repro_torch.runtime.trace`` keeps, while a profiler runs, the totals of
the spans the port enters at its layer boundaries: ``stencil.call`` (one
a compiled call), ``engine.chunk``, ``halo.pad`` (each pad's copy, its
bytes, its device time) and ``kernel.<name>`` (each launch, the bytes its
geometry implies).  The profiled sub-window of a traced run is such a
session.  :func:`session` takes it once a run, clearing it in the port,
and keeps it on the run's record (``run.port_trace``), so no later run in
the process reads it again.

It finds nothing (None) where the run was not traced, where the port has
no such trace, or where the session's ``stencil.call`` count is not the
sub-window's own count of calls (``run.sub["calls"]``).
"""
from __future__ import annotations

CALL = "stencil.call"
PAD = "halo.pad"
KERNEL = "kernel."

__all__ = ["session", "per_call_gb"]


def session(run):
    """The port's span totals over the run's profiled sub-window, or
    None where there is nothing to read."""
    if run.trace is None:
        return None
    if not hasattr(run, "port_trace"):
        try:
            from repro_torch.runtime import trace
        except ImportError:
            run.port_trace = None
        else:
            run.port_trace = trace.session()
    s = run.port_trace
    calls = run.sub.get("calls", 0)
    if not s or not calls or s.get(CALL, {}).get("count") != calls:
        return None
    return s


def per_call_gb(run, prefix: str):
    """Bytes a compiled call of the spans named ``prefix`` or, for a
    prefix ending in ``.``, of every span under it, in GB."""
    s = session(run)
    if s is None:
        return None
    nbytes = sum(v["bytes"] for k, v in s.items()
                 if k == prefix or (prefix.endswith(".")
                                    and k.startswith(prefix)))
    return nbytes / s[CALL]["count"] / 1e9
