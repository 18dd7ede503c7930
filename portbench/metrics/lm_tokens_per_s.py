"""Prompt tokens prefilled in the window, a second: the prompt tokens of
every call the window's closing synchronise covers, over the window's
seconds on the host clock (the window rule of ``gpts_per_s``)."""


def read(run):
    tokens = getattr(run, "tokens", 0)
    if not run.calls or not tokens or run.window_s <= 0:
        return None
    return tokens / run.window_s
