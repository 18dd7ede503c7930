"""The prefills' share of the card's dense bf16 peak: the model flops of
the window's calls (``lm_work.prefill_flops``, counted from each call's
shape) over the window's seconds on the host clock, against
``peaks.json``'s ``bf16_dense_flops_per_s``.  Read in the traced run,
over the flops and seconds of its window outside the profiled
sub-window, where the profiler does not slow the host."""


def read(run):
    flops = getattr(run, "unprofiled_flops", 0.0)
    seconds = getattr(run, "unprofiled_s", 0.0)
    peak = getattr(run, "flops_peak", None)
    if peak is None or not flops or seconds <= 0:
        return None
    return 100.0 * flops / peak / seconds
