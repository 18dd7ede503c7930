"""Stencil kernel launches a compiled call makes: the wrappers' launch
counters over the profiled sub-window, divided by its calls."""


def read(run):
    calls = run.sub.get("calls", 0)
    if not calls or "launches" not in run.sub:
        return None
    return run.sub["launches"] / calls
