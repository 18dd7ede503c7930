"""Closed loop over one compiled call: ``api.compile(api.plan(problem))``
for the configuration's grid and ``steps_per_call``, each call's output
the next call's input, as a simulation advances its state.

The window issues calls until ``seconds`` have passed on the host clock,
then synchronises; every call that synchronise covers counts.  At most
the mix's ``in_flight`` calls are queued on the card ahead of the host,
so the card never waits for a launch and the window ends within a call
or two of ``seconds``.  It keeps
the input and output of the window's first and last call and of
``check.sampled`` more, drawn from the seed by reservoir sampling, by
reference (the program makes a new output each call, so nothing is
copied inside the window).
"""
from __future__ import annotations

import math
import random
import time
from collections import deque

import torch
from torch.profiler import record_function

from portbench import yardstick
from portbench.drivers import common


class System:
    def __init__(self, cell, device):
        from repro_torch import api
        self.cell, self.device = cell, device
        cfg = cell.config
        self.grid = tuple(int(g) for g in cfg["grid"])
        self.steps = int(cfg["steps_per_call"])
        self.problem = api.StencilProblem(
            common.port_spec(cfg), self.grid, dtype=cfg["dtype"],
            boundary=cfg["boundary"], steps=self.steps)
        self.plan = api.plan(self.problem, backends=cfg["backends"])
        self.call = api.compile(self.plan, device=device)
        self.counters = common.counters(cell.kernels["counters"])
        self.kept: dict[int, tuple] = {}

    def describe(self) -> list[str]:
        p = self.plan
        return [f"plan: backend {p.backend}, strategy {p.fuse_strategy}, "
                f"depth {p.fuse_depth}, schedule {p.schedule_str()}, tile "
                f"{'x'.join(map(str, p.block))}, cover {p.option}"]

    def inputs(self, seed: int) -> None:
        g = torch.Generator(device=self.device)
        g.manual_seed(common.torch_seed(seed))
        self.x0 = torch.randn(self.grid, generator=g, device=self.device,
                              dtype=getattr(torch, self.cell.config["dtype"]))

    def warm(self) -> None:
        y = self.x0
        for _ in range(3):
            y = self.call(y)
        common.sync(self.device)
        del y

    def window(self, record, seconds: float, trace: bool, seed: int,
               t0: float) -> None:
        check = self.cell.mix["check"]
        rng = random.Random(common.torch_seed(seed))
        sampled: list[tuple] = []
        profiled = common.SubWindow(self.device, seconds) if trace else None
        x, calls = self.x0, 0
        kept_first = last = None
        in_flight = int(self.cell.mix["in_flight"])
        queued: deque = deque()
        cuda = self.device.type == "cuda"
        common.sync(self.device)
        t_start = time.perf_counter()
        while True:
            now = time.perf_counter() - t_start
            if profiled is not None and profiled.due(now):
                profiled.open(self._counts(calls), now)
            with record_function("portbench.call"):
                y = self.call(x)
            if cuda:
                queued.append(torch.cuda.Event())
                queued[-1].record()
                if len(queued) > in_flight:
                    queued.popleft().synchronize()
            item = (calls, x, y)
            if calls == 0:
                kept_first = item
            elif len(sampled) < check["sampled"]:
                sampled.append(item)
            else:
                j = rng.randrange(calls)
                if j < check["sampled"]:
                    sampled[j] = item
            last = item
            calls += 1
            x = y
            now = time.perf_counter() - t_start
            if profiled is not None and profiled.over(now):
                profiled.close(self._counts(calls))
            if now >= seconds and not (profiled and profiled.is_open):
                break
        common.sync(self.device)
        t_end = time.perf_counter()
        if profiled is not None:
            profiled.close(self._counts(calls))
        kept = ([kept_first] if check["first"] else []) + sampled + (
            [last] if check["last"] else [])
        self.kept = {i: (xi, yi) for i, xi, yi in kept}
        del x, y, item, sampled, kept_first, last, kept
        record.setup_s = t_start - t0
        record.window_s = t_end - t_start
        record.calls = calls
        record.updates = float(math.prod(self.grid)) * self.steps * calls
        record.attempted = calls
        record.failed = 0
        cfg = self.cell.config
        peaks = common.peaks(self.device)
        if peaks is not None:
            nbytes, flops = yardstick.stencil_call_work(
                self.grid, len(cfg["taps"]), self.steps,
                torch.tensor([], dtype=getattr(torch, cfg["dtype"]))
                .element_size())
            record.bound_s = yardstick.bound_s(nbytes, flops, peaks)
        record.info.update(calls=calls, checked_calls=sorted(self.kept))
        if profiled is not None:
            record.trace, record.sub = profiled.result(
                self.cell.kernels["symbols"])

    def _counts(self, calls: int) -> dict:
        return {"calls": calls, "launches": common.launches(self.counters)}

    def answers(self) -> list[tuple]:
        return [(f"call {i}", x, y, self.steps)
                for i, (x, y) in sorted(self.kept.items())]

    def release(self) -> None:
        self.kept = {}
        self.call = self.x0 = None
