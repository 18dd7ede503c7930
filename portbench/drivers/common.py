"""What the drivers share: seeds, synchronisation, the kernels' launch
counters, the card's peaks and the profiled sub-window."""
from __future__ import annotations

import importlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import timeline, yardstick

#: the profiled sub-window of a traced run: it starts at this share of the
#: window and lasts the smaller of MAX_S and SHARE of the window
START_SHARE, SHARE, MAX_S = 0.3, 0.25, 2.0


def torch_seed(seed: int) -> int:
    """Any whole number as a seed both torch and numpy take."""
    return int(seed) % (1 << 63)


def port_spec(config: dict):
    """The port's operator of the configuration, built by the
    ``specs/<spec>.py`` its ``"spec"`` key names."""
    return importlib.import_module(
        f"portbench.specs.{config['spec']}").build(config)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def counters(names) -> list:
    """The wrapper objects whose ``.launches`` count kernel launches,
    from ``module:attribute`` names."""
    out = []
    for name in names:
        module, attr = name.split(":")
        out.append(getattr(importlib.import_module(module), attr))
    return out


def launches(objs) -> int:
    return sum(int(o.launches) for o in objs)


def peaks(device):
    if device.type != "cuda":
        return None
    return yardstick.card_peaks(torch.cuda.get_device_name(device))


def prime_profiler(device) -> None:
    """Start and stop the profiler once, so that its first start (which
    loads and initialises the tracer) falls into set-up."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.ones(1, device=device).add_(1)
        sync(device)


class SubWindow:
    """The profiled part of a traced run's window, bounded by the
    ``portbench.window`` span: it opens at a share of the window and lasts
    its length from the moment it opened.  ``open``/``close`` take the
    counts whose differences the per-layer metrics read."""

    def __init__(self, device, seconds: float, *, synchronise: bool = True):
        self.device = device
        self.start = START_SHARE * seconds
        self.length = min(MAX_S, SHARE * seconds)
        self.opened_at = None
        self.synchronise = synchronise
        self.state = 0
        self.prof = self.span = None
        self.counts0 = self.counts1 = None

    def due(self, now: float) -> bool:
        return self.state == 0 and now >= self.start

    def over(self, now: float) -> bool:
        return self.state == 1 and now >= self.opened_at + self.length

    @property
    def is_open(self) -> bool:
        return self.state == 1

    def open(self, counts: dict, now: float) -> None:
        """Open at ``now`` (seconds into the window); a synchronise first
        moves the opening on by the time it takes."""
        t = time.perf_counter()
        if self.synchronise:
            sync(self.device)
        now += time.perf_counter() - t
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.span = record_function(timeline.WINDOW_SPAN)
        self.span.__enter__()
        self.counts0 = dict(counts)
        self.opened_at = now
        self.state = 1

    def close(self, counts: dict) -> None:
        if self.state != 1:
            return
        if self.synchronise:
            sync(self.device)
        self.counts1 = dict(counts)
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.state = 2

    def result(self, symbols) -> tuple:
        """(DeviceTrace or None, count differences over the sub-window)."""
        if self.state != 2:
            return None, {}
        device, host = timeline.profiler_events(self.prof)
        self.prof = None
        sub = {k: self.counts1[k] - self.counts0[k] for k in self.counts0}
        return timeline.summarize(device, host, symbols), sub
