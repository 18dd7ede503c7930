"""The port's spans (``repro_torch.runtime.trace``) on the CPU: the gate,
the spans of one compiled call (``stencil.call``, ``engine.chunk``,
``halo.pad``, ``kernel.*``) against the closed form of its pads and
launches and against ``launch/op_analysis``'s count, the sessions, and
the benchmark's readers of them (``portbench/port_trace.py``)."""
import sys
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import api
from repro_torch.core import engine as eng_mod
from repro_torch.core import halo
from repro_torch.core.stencil_spec import PAPER_SUITE
from repro_torch.kernels import stencil_mxu as sm
from repro_torch.launch.op_analysis import analyze_ops
from repro_torch.runtime import trace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, timeline  # noqa: E402

torch.set_num_threads(2)

# (suite name, grid, plan pins): each benchmark cell's problem at a small
# grid, as the planner picks it there, and pinned to the schedule and tile
# it picks at the cell's full size (3x5+1 in-kernel on 64x128 at 32768^2,
# 1x8 on 16x32x32 at 1024^3), whose tiles do not divide the small grids
CASES = {
    "star2d_r2 96x80": ("star2d_r2", (96, 80), {}),
    "star3d_r2 24x20x16": ("star3d_r2", (24, 20, 16), {}),
    "star2d_r2 96x80 3x5+1": ("star2d_r2", (96, 80), {
        "fuse": 3, "fuse_strategy": "inkernel", "block": (64, 128)}),
    "star3d_r2 24x20x16 1x8": ("star3d_r2", (24, 20, 16), {
        "fuse": 1, "block": (16, 32, 32)}),
}
STEPS = {"star2d_r2": 16, "star3d_r2": 8}


def compiled(name, grid, pins):
    problem = api.StencilProblem(PAPER_SUITE()[name], grid,
                                 boundary="periodic", steps=STEPS[name])
    return api.compile(api.plan(problem, backends=["cuda"], **pins),
                       device="cpu")


def closed_form(call, itemsize=4):
    """Kernel bytes of one call, from the plan's shapes: every chunk of a
    periodic call hands its kernel the unpadded state (the step kernel
    and the sweep kernel read the periodic halo through wrapped indices
    and mask ragged tiles), so no chunk pads; a launch moves what its
    geometry prices."""
    p, eng = call.plan, call.engine
    grid = p.grid
    block = tuple(min(b, g) for b, g in zip(p.block, grid))
    kern = 0
    for t in p.fuse_schedule:
        if p.fuse_strategy == "inkernel" and t > 1:
            kp = sm.build_sweep_kernel_plan(eng.plan.spec, eng.plan.cover,
                                            block, t, wrap=True)
            kern += sm.sweep_launch_cost(kp, grid, itemsize).bytes
            continue
        e = eng if t == 1 else eng.fused_engine(t)
        kp = sm.build_kernel_plan(e.plan.spec, e.plan.cover, block,
                                  wrap=True)
        kern += sm.step_launch_cost(kp, grid, itemsize).bytes
    return kern


def traced(fn, *args):
    """``fn(*args)`` under a CPU profiler, after one untraced span (so it
    starts a session of its own); returns (result, session)."""
    with trace.span("untraced"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn(*args)
    return out, trace.session()


def test_the_gate_follows_the_profiler():
    """The profiler flips ``torch.autograd._profiler_enabled()`` and the
    gate, which holds in every thread while it runs."""
    seen = []
    assert not torch.autograd._profiler_enabled() and not trace.enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled() and trace.enabled()
        th = threading.Thread(target=lambda: seen.append(trace.enabled()))
        th.start()
        th.join(timeout=30)
    assert not th.is_alive() and seen == [True]
    assert not torch.autograd._profiler_enabled() and not trace.enabled()


def test_with_the_profiler_off_no_span_is_entered(monkeypatch):
    entered = []

    class Spy:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trace, "record_function", Spy)
    call = compiled(*CASES["star3d_r2 24x20x16 1x8"])
    x = torch.randn(24, 20, 16, generator=torch.Generator().manual_seed(0))
    trace.session()
    assert trace.span("a") is trace.span("b", 8, x.device)
    call(x)
    assert entered == [] and trace.session() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        call(x)
    assert entered.count("stencil.call") == 1
    assert trace.session()["stencil.call"]["count"] == 1


@pytest.mark.parametrize("case", CASES)
def test_one_call_records_its_layers(case):
    """One compiled call: one ``stencil.call``, an ``engine.chunk`` a
    chunk of the schedule, no pad (neither a span nor a copy that
    ``analyze_ops`` counts) and the launches' bytes of the closed form,
    equal to ``analyze_ops``' count of the same call."""
    name, grid, pins = CASES[case]
    call = compiled(name, grid, pins)
    if pins:
        full = {"star2d_r2": (3, 3, 3, 3, 3, 1), "star3d_r2": (1,) * 8}
        assert call.plan.fuse_schedule == full[name]
    x = torch.randn(grid, generator=torch.Generator().manual_seed(1))
    (_, cost), s = traced(analyze_ops, call, x)
    kern = closed_form(call)
    assert s["stencil.call"]["count"] == 1
    chunk = s["engine.chunk"]
    assert chunk["count"] == len(call.plan.fuse_schedule)
    assert chunk["bytes"] == 0
    assert "halo.pad" not in s
    assert cost.ops.get("aten.index_select", 0) == 0
    assert cost.ops.get("aten.constant_pad_nd", 0) == 0
    kernels = {k: v for k, v in s.items() if k.startswith("kernel.")}
    assert sum(v["bytes"] for v in kernels.values()) == kern
    assert sum(v["bytes"] for v in kernels.values()) == cost.kernel_bytes
    assert {k[len("kernel."):]: v["count"] for k, v in kernels.items()} \
        == cost.kernels


@pytest.mark.parametrize("case", ["star2d_r2 96x80 3x5+1",
                                  "star3d_r2 24x20x16 1x8"])
def test_the_pinned_cases_gather_and_zero_pad(case):
    """The full-size schedules' step chunks read the periodic halos in the
    kernel, so they gather nothing; and though the full-size tiles do not
    divide the small grids, the kernel masks the ragged tiles, so nothing
    is zero-padded to whole tiles either."""
    name, grid, pins = CASES[case]
    _, cost = analyze_ops(compiled(name, grid, pins), torch.randn(grid))
    assert cost.ops.get("aten.index_select", 0) == 0
    assert cost.ops.get("aten.constant_pad_nd", 0) == 0
    assert cost.kernels["stencil_step"] >= 1


def test_the_plain_sweeps_own_wrap_pad_is_not_counted():
    """On the CPU the sweep wrapper runs its plain version, which pads the
    periodic halo itself inside the launch: no ``halo.pad`` is counted,
    as on the card, where the kernel reads the halo."""
    spec = PAPER_SUITE()["star2d_r2"]
    plan = eng_mod.StencilEngine(spec, backend="cuda", block=(16, 16),
                                 boundary="periodic", device="cpu").plan
    kp = sm.build_sweep_kernel_plan(spec, plan.cover, (16, 16), 3,
                                    wrap=True)
    x = torch.randn(40, 48)
    _, s = traced(sm.sweep_cuda_call, x, kp)
    assert "halo.pad" not in s
    assert s["kernel.stencil_sweep"]["count"] == 1
    assert s["kernel.stencil_sweep"]["bytes"] == \
        sm.sweep_launch_cost(kp, x.shape, 4).bytes


def test_pad_spans_count_each_copy():
    x = torch.randn(3, 5, 7)
    _, s = traced(halo.pad_trailing, x, [(1, 2), (0, 0)], "periodic")
    assert s["halo.pad"]["count"] == 1
    assert s["halo.pad"]["bytes"] == (105 + 3 * 8 * 7) * 4
    _, s = traced(halo.pad_trailing, x, [(1, 2), (2, 0)], "zero")
    assert s["halo.pad"]["count"] == 1
    assert s["halo.pad"]["bytes"] == (105 + 3 * 8 * 9) * 4
    _, s = traced(halo.pad_trailing, x, [(0, 0), (0, 0)], "periodic")
    assert s == {}


def test_sessions_reset_and_reading_takes():
    call = compiled(*CASES["star2d_r2 96x80"])
    x = torch.randn(96, 80)
    trace.session()
    with profile(activities=[ProfilerActivity.CPU]):
        call(x)
    with profile(activities=[ProfilerActivity.CPU]):
        call(x)
    # no untraced span between the two: one session
    assert trace.session()["stencil.call"]["count"] == 2
    assert trace.session() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        call(x)
    call(x)          # untraced
    with profile(activities=[ProfilerActivity.CPU]):
        call(x)
    assert trace.session()["stencil.call"]["count"] == 1
    assert trace.session() == {}


class _Event:
    """A stand-in for a CUDA event that ends ``ms`` after its start."""

    def __init__(self, ms=0.0, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.ms


def test_device_times_resolve_in_order_and_only_in_their_session():
    """Pending device times resolve outside the lock: without waiting only
    the leading finished ones, waiting all; a time of an earlier session
    is dropped."""
    trace.session()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("timed"):
            pass
    gen = trace._gen
    trace._pending.extend([(gen, "timed", _Event(), _Event(2.0)),
                           (gen - 1, "timed", _Event(), _Event(7.0)),
                           (gen, "timed", _Event(), _Event(3.0, done=False)),
                           (gen, "timed", _Event(), _Event(5.0))])
    trace._settle(wait=False)
    assert trace._totals["timed"]["device_s"] == pytest.approx(2e-3)
    assert len(trace._pending) == 2         # the stale one is dropped
    s = trace.session()
    assert s["timed"]["device_s"] == pytest.approx(10e-3)
    assert trace._pending == []


def test_spans_of_another_thread_are_counted():
    def work():
        with trace.span("worker", 3):
            pass

    trace.session()
    with profile(activities=[ProfilerActivity.CPU]):
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    assert trace.session()["worker"]["bytes"] == 3


def test_no_record_function_outside_the_trace_module():
    port = ROOT / "src" / "repro_torch"
    users = sorted(str(p.relative_to(port)) for p in port.rglob("*.py")
                   if "record_function" in p.read_text())
    assert users == ["runtime/trace.py"]


# -- the benchmark's readers (portbench/metrics, portbench/port_trace.py) --

READERS = ("pad_gb_per_call", "pad_bw_pct", "kernel_gb_per_call")


def _record(calls, session, traced_run=True):
    cell = harness.load_cell("star3d_r2.rollout")
    record = harness.RunRecord(cell=cell)
    record.sub = {"calls": calls}
    if traced_run:
        record.trace = timeline.DeviceTrace(
            window_s=1.0, busy_s=1.0, device_s=1.0, kernel_s=0.5, h2d_s=0.0,
            ops=[], gaps=[], n_device_ops=1)
    record.port_trace = session
    return record, [m for m in cell.per_layer if m["name"] in READERS]


def _entry(count, nbytes, device_s=None):
    return {"count": count, "bytes": nbytes, "device_s": device_s}


def test_readers_read_the_session_per_call():
    session = {"stencil.call": _entry(4, 0),
               "halo.pad": _entry(96, 8e9, device_s=0.5),
               "kernel.stencil_step": _entry(32, 3e9),
               "kernel.stencil_sweep": _entry(4, 1e9)}
    record, metrics = _record(4, session)
    got = harness.read_metrics(record, metrics)
    assert got == {"pad_gb_per_call": {"value": 2.0, "unit": "GB"},
                   "kernel_gb_per_call": {"value": 1.0, "unit": "GB"}}


@pytest.mark.parametrize("calls, traced_run", [(5, True), (0, True),
                                               (4, False)])
def test_readers_find_nothing_on_a_mismatch_or_no_trace(calls, traced_run):
    session = {"stencil.call": _entry(4, 0), "halo.pad": _entry(8, 8e9),
               "kernel.stencil_step": _entry(8, 3e9)}
    record, metrics = _record(calls, session, traced_run)
    assert harness.read_metrics(record, metrics) == {}


def test_the_session_is_taken_once_a_run():
    from portbench import port_trace
    call = compiled(*CASES["star2d_r2 96x80"])
    _, s = traced(call, torch.randn(96, 80))
    with profile(activities=[ProfilerActivity.CPU]):
        call(torch.randn(96, 80))
    record, _ = _record(1, None)
    del record.port_trace
    assert port_trace.session(record)["stencil.call"]["count"] == 1
    assert trace.session() == {}
    assert port_trace.session(record)["stencil.call"]["count"] == 1


SMALL = {"star2d_r2.rollout": (96, 80), "star3d_r2.rollout": (24, 20, 16)}


@pytest.mark.parametrize("name", SMALL)
def test_traced_cell_reports_the_closed_form(name):
    cell = harness.load_cell(name, overrides={
        "config": {"grid": list(SMALL[name])}})
    r = harness.run_cell(cell, 2 ** 40 + 3, 0.4, True,
                         device=torch.device("cpu"), t0=time.perf_counter())
    assert r["correct"] is True
    call = compiled(cell.config["name"], SMALL[name], {})
    kern = closed_form(call)
    m = r["metrics"]
    assert m["pad_gb_per_call"]["value"] == 0
    assert m["kernel_gb_per_call"]["value"] == pytest.approx(kern / 1e9,
                                                             rel=1e-12)
    assert "pad_bw_pct" not in m          # untimed off the card
