"""Share of the profiled sub-window in which no operation ran on the
device (one minus the union of device activity over the window).  The
reader of ``device_idle_pct.<kind>``, one name for each end-to-end metric
it moves."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.n_device_ops == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
