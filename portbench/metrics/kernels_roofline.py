"""The stencil kernels' share of the calls' roofline: the least time of
the profiled sub-window's calls over the device time spent in the listed
stencil kernels (kernels/*.json)."""


def read(run):
    t, calls = run.trace, run.sub.get("calls", 0)
    if t is None or run.bound_s is None or not calls or t.kernel_s <= 0:
        return None
    return 100.0 * run.bound_s * calls / t.kernel_s
