"""The compiled call's share of its roofline: the least time the card
could take for the calls of the profiled sub-window (the state read and
written once a call; bytes at HBM bandwidth against flops at 3xTF32)
over the sub-window's length."""


def read(run):
    t, calls = run.trace, run.sub.get("calls", 0)
    if t is None or run.bound_s is None or not calls or t.window_s <= 0:
        return None
    return 100.0 * run.bound_s * calls / t.window_s
