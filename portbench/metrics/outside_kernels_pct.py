"""Share of the device's time spent outside the listed stencil kernels
(pads, copies, the chunk glue), over all device op time in the profiled
sub-window."""


def read(run):
    t = run.trace
    if t is None or t.device_s <= 0:
        return None
    return 100.0 * (t.device_s - t.kernel_s) / t.device_s
