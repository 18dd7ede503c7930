"""Device operations a prompt token: the operations on the device's
timeline in the profiled sub-window over the prompt tokens of the calls
in it.  The sub-window opens and closes on a synchronise, so its
operations are its calls' own."""


def read(run):
    t, tokens = run.trace, run.sub.get("tokens", 0)
    if t is None or not tokens or t.n_device_ops == 0:
        return None
    return t.n_device_ops / tokens
