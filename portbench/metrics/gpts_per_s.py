"""Grid-point updates completed in the window, in billions a second:
points x steps of every call the window's closing synchronise covers,
over the window's seconds on the host clock (GStencil/s)."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return run.updates / run.window_s / 1e9
