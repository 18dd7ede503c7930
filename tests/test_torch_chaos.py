"""Chaos-hardened serving and rollouts in the port: the seeded fault
harness fires at the JAX package's call indices, the supervision
primitives match, and the retry / fallback / evict / shed ladder and the
background stepper recover bit-exactly (faulted server == fault-free
sync server) on CPU slots.  Mirrors ``tests/test_chaos.py`` case by
case; the two-device eviction case runs two CPU slots instead of fake
XLA devices.  The site x rate x seed matrix is slow-marked, as there."""
import re
import threading
import time

import numpy as np
import pytest
import torch

from repro.runtime import chaos as ref_chaos
from repro.runtime import fault_tolerance as ref_ft

from repro_torch import api
from repro_torch.checkpoint.checkpointer import (restore_checkpoint,
                                                 retained_steps)
from repro_torch.core import stencil_spec as ss
from repro_torch.core.time_stepper import reference_evolve
from repro_torch.runtime import chaos
from repro_torch.runtime import fault_tolerance as ft

torch.set_num_threads(2)

CPU = ["cpu"]
TIMEOUT_S = 60.0


def _ref(state, spec, steps, boundary="periodic"):
    return reference_evolve(spec, torch.as_tensor(state), steps,
                            boundary).numpy()


def _quick_restart(**kw):
    cfg = dict(max_failures=8, backoff_s=0.005)
    cfg.update(kw)
    return api.RestartPolicy(**cfg)


def _server(spec, steps, **kw):
    kw.setdefault("backends", ["cuda"])
    kw.setdefault("devices", CPU)
    kw.setdefault("max_batch", 4)
    return api.StencilServer(spec, steps, **kw)


def _assert_bits(outs, baseline):
    for a, b in zip(outs, baseline):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The harness against the JAX package's
# ---------------------------------------------------------------------------

_PLANS = {
    "rate": [("serve.settle", dict(rate=0.4))],
    "two_rules": [("serve.settle", dict(rate=0.3, match={"device": 0})),
                  ("serve.dispatch", dict(rate=0.5, times=3,
                                          action="corrupt"))],
    "at_and_rate": [("cache.compile", dict(at=(1, 4))),
                    ("cache.compile", dict(rate=0.25)),
                    ("checkpoint.write", dict(rate=0.5, action="corrupt"))],
    "dist_sites": [("dist.exchange", dict(rate=0.3, action="corrupt")),
                   ("dist.chunk", dict(at=(2,)))],
}
_CALLS = [("serve.settle", {"shape": "16x16", "device": 0}),
          ("serve.dispatch", {"shape": "16x16", "device": 1, "bucket": 4}),
          ("cache.compile", {"backend": "cuda", "batch": 4}),
          ("serve.settle", {"shape": "24x24", "device": 1}),
          ("checkpoint.write", {"step": 3}),
          ("dist.exchange", {"chunk": 0}),
          ("dist.chunk", {"chunk": 1})]


def _drive(module, plan, n=40):
    outcomes = []
    with plan:
        for i in range(n):
            site, ctx = _CALLS[i % len(_CALLS)]
            try:
                outcomes.append(module.fire(site, **ctx))
            except module.FaultError as e:
                outcomes.append(("raise", e.site, e.index))
    return outcomes


@pytest.mark.parametrize("seed", [0, 3, 7])
@pytest.mark.parametrize("name", sorted(_PLANS))
def test_fault_plan_fires_at_the_reference_indices(name, seed):
    def build(module):
        plan = module.FaultPlan(seed=seed)
        for site, kw in _PLANS[name]:
            plan.rule(site, **kw)
        return plan

    ref, port = build(ref_chaos), build(chaos)
    assert _drive(chaos, port) == _drive(ref_chaos, ref)
    assert port.log == ref.log
    assert port.stats() == ref.stats()
    assert [r.at for r in port.replay()._rules] == \
        [r.at for r in ref.replay()._rules]


def test_fault_sites_are_the_reference_sites():
    assert chaos.FAULT_SITES == ref_chaos.FAULT_SITES
    assert api.FAULT_SITES == chaos.FAULT_SITES


def test_fault_plan_fires_deterministically_per_seed():
    def pattern(seed):
        plan = chaos.FaultPlan(seed=seed).rule("serve.settle", rate=0.4)
        out = []
        with plan:
            for _ in range(32):
                try:
                    chaos.fire("serve.settle", shape="16x16", device=0)
                    out.append(0)
                except chaos.FaultError:
                    out.append(1)
        return out, plan

    p7a, plan = pattern(7)
    p7b, _ = pattern(7)
    assert p7a == p7b
    assert p7a != pattern(8)[0]
    assert 0 < sum(p7a) < 32
    assert plan.fired() == sum(p7a) == plan.fired("serve.settle")
    assert plan.calls("serve.settle") == 32
    site, idx, action, ctx = plan.log[0]
    assert site == "serve.settle" and action == "raise"
    assert ctx == {"shape": "16x16", "device": 0}


def test_fault_rule_at_times_match_and_actions():
    plan = (chaos.FaultPlan(seed=0)
            .rule("serve.dispatch", at=(1, 3), match={"device": 1})
            .rule("cache.compile", rate=1.0, times=2)
            .rule("checkpoint.write", at=(0,), action="corrupt")
            .rule("serve.settle", at=(0,), action="delay", delay_s=0.01))
    with plan:
        for _ in range(5):
            chaos.fire("serve.dispatch", device=0)
        hits = 0
        for i in range(5):
            try:
                chaos.fire("serve.dispatch", device=1)
            except chaos.FaultError as e:
                assert e.site == "serve.dispatch" and e.index == i
                hits += 1
        assert hits == 2
        fired = 0
        for _ in range(5):
            try:
                chaos.fire("cache.compile", backend="cuda")
            except chaos.FaultError:
                fired += 1
        assert fired == 2
        assert chaos.fire("checkpoint.write", step=1) == "corrupt"
        assert chaos.fire("checkpoint.write", step=2) is None
        t0 = time.perf_counter()
        assert chaos.fire("serve.settle") is None
        assert time.perf_counter() - t0 >= 0.01


def test_fault_plan_validation_and_activation():
    with pytest.raises(ValueError, match="unknown fault site"):
        chaos.FaultPlan().rule("serve.nonsense")
    with pytest.raises(ValueError, match="action"):
        chaos.FaultPlan().rule("serve.settle", action="explode")
    with pytest.raises(ValueError, match="rate"):
        chaos.FaultPlan().rule("serve.settle", rate=1.5)
    assert chaos.active() is None
    assert chaos.fire("serve.settle", device=0) is None
    plan = chaos.FaultPlan().rule("serve.settle", rate=1.0)
    with plan:
        assert chaos.active() is plan
        with pytest.raises(RuntimeError, match="already active"):
            with chaos.FaultPlan():
                pass
    assert chaos.active() is None
    p2 = chaos.FaultPlan(seed=3, rules=[{"site": "serve.settle",
                                         "at": (0,)}])
    with p2, pytest.raises(chaos.FaultError):
        chaos.fire("serve.settle")


def test_fault_plan_replay_round_trip():
    plan = (chaos.FaultPlan(seed=11)
            .rule("serve.settle", rate=0.4, match={"device": 0})
            .rule("serve.dispatch", rate=0.3, action="corrupt"))

    def drive(p):
        outcomes = []
        with p:
            for i in range(24):
                for site in ("serve.dispatch", "serve.settle"):
                    try:
                        out = chaos.fire(site, shape="16x16", device=i % 2)
                        outcomes.append((site, i, out))
                    except chaos.FaultError:
                        outcomes.append((site, i, "raise"))
        return outcomes

    o1 = drive(plan)
    assert plan.fired("serve.settle") > 0
    assert plan.fired("serve.dispatch") > 0
    rp = plan.replay()
    assert all(r.rate == 0.0 and r.times is None for r in rp._rules)
    assert drive(rp) == o1
    assert rp.log == plan.log
    assert [r.at for r in rp.replay()._rules] == [r.at for r in rp._rules]


# ---------------------------------------------------------------------------
# Supervision primitives against the JAX package's
# ---------------------------------------------------------------------------

def test_restart_policy_and_supervised_match_the_reference():
    for module in (ft, ref_ft):
        pol = module.RestartPolicy(max_failures=3, backoff_s=0.5,
                                   backoff_factor=3.0)
        delays = [pol.on_failure(RuntimeError("x")) for _ in range(3)]
        assert delays == [0.5, 1.5, 4.5]
        with pytest.raises(RuntimeError, match="restart budget exhausted"):
            pol.on_failure(RuntimeError("x"))
        assert pol.failures == 0 and pol.remaining == 3
        assert pol.clone(max_failures=1).max_failures == 1
    calls = []

    def flaky(attempt):
        calls.append(attempt)
        if attempt < 3:
            raise ValueError(attempt)
        return attempt

    retries = []
    pol = ft.RestartPolicy(max_failures=3, backoff_s=0.0)
    assert ft.supervised(flaky, restart=pol, monitor=ft.HeartbeatMonitor(),
                         on_retry=lambda a, e, d: retries.append(a)) == 3
    assert calls == [1, 2, 3] and retries == [1, 2] and pol.failures == 0
    with pytest.raises(ValueError):
        ft.supervised(lambda a: flaky(1))


def test_heartbeat_monitor_matches_the_reference():
    dts = [0.1, 0.11, 0.09, 0.5, 0.1, 0.12, 0.05, 0.9]
    port, ref = ft.HeartbeatMonitor(threshold=2.0), \
        ref_ft.HeartbeatMonitor(threshold=2.0)
    for i, dt in enumerate(dts):
        port.record(i, dt)
        ref.record(i, dt)
    assert port.stragglers == ref.stragglers and port.mean == ref.mean
    mon = ft.HeartbeatMonitor(hard_timeout_s=0.001)
    mon.start_step(0)
    time.sleep(0.01)
    with pytest.raises(ft.StepTimeout):
        mon.end_step()
    assert mon.clone().history is not mon.history


@pytest.mark.parametrize("devices,mp,pods", [(8, 1, 1), (8, 2, 1), (7, 2, 1),
                                             (16, 2, 2), (3, 4, 1),
                                             (5, 1, 1)])
def test_plan_elastic_mesh_matches_the_reference(devices, mp, pods):
    try:
        want = ref_ft.plan_elastic_mesh(devices, mp, pods)
    except ValueError:
        with pytest.raises(ValueError):
            ft.plan_elastic_mesh(devices, mp, pods)
        return
    assert ft.plan_elastic_mesh(devices, mp, pods) == want


# ---------------------------------------------------------------------------
# Acceptance: bit-exact recovery under seeded dispatch/compile/settle faults
# ---------------------------------------------------------------------------

def _mixed_stream(rng, n=7):
    shapes = [(32, 32), (24, 24)]
    return [rng.normal(size=shapes[i % 2]).astype(np.float32)
            for i in range(n)]


def test_serve_bit_exact_under_seeded_fault_plan():
    """The retry rung alone (``fallback_after=None``): in the JAX package
    the server is pinned to its fallback backend, so the fallback rung
    cannot fire there either."""
    spec = ss.star(2, 2, seed=1)
    states = _mixed_stream(np.random.default_rng(11))
    baseline = _server(spec, 3, async_dispatch=False).serve(states)
    server = _server(spec, 3, restart=_quick_restart(), fallback_after=None)
    plan = (api.FaultPlan(seed=2)
            .rule("serve.dispatch", rate=0.3)
            .rule("serve.settle", rate=0.3)
            .rule("cache.compile", rate=0.5, times=2))
    with plan:
        outs = server.serve(states)
    assert plan.fired() > 0
    _assert_bits(outs, baseline)
    s = server.stats()
    assert s["faults"]["bucket_failures"] == plan.fired()
    assert s["faults"]["retries"] == s["faults"]["bucket_failures"]
    assert s["requests"] == len(states)
    assert s["degraded"] == {}


def test_backend_fallback_degrades_group_bit_exact():
    """Persistent kernel faults demote the shape group to the eager
    ``torch`` backend on the same device; results match the
    torch-pinned fault-free server bit-exactly."""
    spec = ss.box(2, 1, seed=0)
    rng = np.random.default_rng(12)
    states = [rng.normal(size=(32, 32)).astype(np.float32)
              for _ in range(3)]
    baseline = _server(spec, 2, backends=["torch"], async_dispatch=False,
                       admission=False).serve(states)
    server = _server(spec, 2, admission=False, restart=_quick_restart(),
                     fallback_after=2)
    plan = api.FaultPlan(seed=0).rule("cache.compile", rate=1.0,
                                      match={"backend": "cuda"})
    with plan:
        outs = server.serve(states)
    assert plan.fired() >= 2
    _assert_bits(outs, baseline)
    s = server.stats()
    assert s["degraded"] == {"32x32": ["torch"]}
    assert s["faults"]["fallbacks"] == 1
    assert s["requests"] == 3


def test_device_eviction_remaps_groups_and_readmits_on_probation():
    """Two CPU slots stand in for the JAX package's two fake devices."""
    spec = ss.box(2, 1, seed=0)
    server = _server(
        spec, 2, devices=["cpu", "cpu"],
        restart=api.RestartPolicy(max_failures=6, backoff_s=0.005),
        evict_after=2, evict_cooldown_s=0.2)
    assert len(server.caches) == 2
    rng = np.random.default_rng(0)
    shapes = [(16, 16), (24, 24)]   # two groups -> slots 0 and 1
    states = [rng.normal(size=shapes[i % 2]).astype(np.float32)
              for i in range(4)]
    plan = api.FaultPlan(seed=0).rule("serve.settle", rate=1.0,
                                      match={"device": 1})
    with plan:
        outs = server.serve(states)
        for state, out in zip(states, outs):
            np.testing.assert_allclose(out.numpy(), _ref(state, spec, 2),
                                       atol=1e-4)
        s = server.stats()
        assert s["faults"]["evictions"] == 1
        assert s["devices"][1]["evicted"]
        assert s["devices"][1]["failures"] == 2
        assert s["devices"][0]["batches"] >= 2
        time.sleep(0.3)
        more = [rng.normal(size=(24, 24)).astype(np.float32)
                for _ in range(2)]
        outs2 = server.serve(more)
        for state, out in zip(more, outs2):
            np.testing.assert_allclose(out.numpy(), _ref(state, spec, 2),
                                       atol=1e-4)
        s2 = server.stats()
        assert s2["faults"]["evictions"] == 2
        assert s2["devices"][1]["evicted"]


def test_cuda_error_is_not_requeued(monkeypatch):
    """A CUDA error at the readiness wait is sticky: the bucket's tickets
    fail with it and it propagates, with no retry on the same context."""
    spec = ss.box(2, 1, seed=0)
    server = _server(spec, 2, restart=_quick_restart())
    x = np.random.default_rng(1).normal(size=(16, 16)).astype(np.float32)
    t = server.submit(x)

    def sticky(fb):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(server, "_wait_ready", sticky)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        server.flush()
    s = server.stats()
    assert s["faults"]["bucket_failures"] == 0
    assert s["faults"]["retries"] == 0
    assert server.pending_tickets() == []
    with pytest.raises(RuntimeError, match="illegal memory access"):
        server.results(t)


@pytest.mark.parametrize("error", [ValueError, torch.cuda.OutOfMemoryError])
def test_kernel_wrapper_error_raises_instead_of_degrading(monkeypatch, error):
    """A kernel wrapper's own error (a launch check's ``ValueError``, an
    out-of-memory) is no injected fault: every flush raises it, naming the
    tickets, with no retry, and the group is never moved to the ``torch``
    backend, however low ``fallback_after`` is; the requests stay queued
    until cancelled."""
    from repro_torch.kernels import stencil_mxu

    def refuse(*args, **kwargs):
        raise error("launch check refused the bucket")

    monkeypatch.setattr(stencil_mxu, "stencil_cuda_call", refuse)
    monkeypatch.setattr(stencil_mxu, "sweep_cuda_call", refuse)
    spec = ss.box(2, 1, seed=0)
    server = _server(spec, 2, restart=_quick_restart(), fallback_after=1)
    rng = np.random.default_rng(2)
    tickets = [server.submit(rng.normal(size=(16, 16)).astype(np.float32))
               for _ in range(2)]
    for _ in range(3):
        with pytest.raises(ValueError,
                           match=re.escape(str(tickets))) as info:
            server.flush()
        assert isinstance(info.value.__cause__, error)
        assert "launch check" in str(info.value)
    s = server.stats()
    assert s["degraded"] == {}
    assert s["faults"]["fallbacks"] == 0
    assert s["faults"]["bucket_failures"] == 0
    assert s["faults"]["retries"] == 0
    assert sorted(server.pending_tickets()) == tickets
    assert all(server.cancel(t) for t in tickets)
    assert server.flush() == {}


# ---------------------------------------------------------------------------
# Background stepper: thread-safe submit/results under faults
# ---------------------------------------------------------------------------

def test_background_stepper_serves_concurrent_submitters_bit_exact():
    spec = ss.box(2, 1, seed=0)
    rng = np.random.default_rng(13)
    per_thread = [[rng.normal(size=(24, 24)).astype(np.float32)
                   for _ in range(4)] for _ in range(3)]
    flat = [s for group in per_thread for s in group]
    baseline = _server(spec, 2, async_dispatch=False).serve(flat)
    expect = {id(s): b for s, b in zip(flat, baseline)}
    server = _server(spec, 2, restart=_quick_restart(max_failures=12),
                     fallback_after=None)
    got, errors = {}, []

    def submitter(states):
        try:
            tickets = [(server.submit(s), s) for s in states]
            for t, s in tickets:
                got[id(s)] = server.results(t, timeout_s=TIMEOUT_S)
        except Exception as e:              # pragma: no cover - fail loud
            errors.append(e)

    plan = (api.FaultPlan(seed=5)
            .rule("serve.settle", at=(0,))
            .rule("serve.settle", rate=0.25))
    server.start()
    try:
        with plan:
            threads = [threading.Thread(target=submitter, args=(g,))
                       for g in per_thread]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT_S)
            assert not any(t.is_alive() for t in threads)
    finally:
        server.stop()
    assert not errors, errors
    assert not server.running
    assert plan.fired() > 0
    assert len(got) == len(flat)
    for key, out in got.items():
        assert torch.equal(out, expect[key])
    assert server.stats()["faults"]["retries"] > 0


def test_background_stepper_blocking_results_and_restart():
    spec = ss.box(2, 1, seed=0)
    server = _server(spec, 2)
    x = np.random.default_rng(1).normal(size=(16, 16)).astype(np.float32)
    server.start()
    assert server.start() is server
    try:
        t = server.submit(x)
        out = server.results(t, timeout_s=TIMEOUT_S)
        np.testing.assert_allclose(out.numpy(), _ref(x, spec, 2), atol=1e-4)
        with pytest.raises(TimeoutError):
            t2 = server.submit(np.zeros((640, 640), np.float32))
            server.results(t2, timeout_s=1e-4)
        server.results(t2, timeout_s=TIMEOUT_S)
    finally:
        server.stop()
    server.stop()
    assert len(server.serve([x])) == 1


# ---------------------------------------------------------------------------
# Deadline clock across requeue + load shedding
# ---------------------------------------------------------------------------

def test_requeued_bucket_keeps_original_submit_clock():
    spec = ss.box(2, 1, seed=0)
    rng = np.random.default_rng(14)
    server = _server(spec, 2,
                     restart=api.RestartPolicy(max_failures=3, backoff_s=0.4))
    server.serve([rng.normal(size=(16, 16)).astype(np.float32)])  # warm
    server.reset_stats()
    x = rng.normal(size=(16, 16)).astype(np.float32)
    t = server.submit(x, deadline_s=0.15)
    plan = api.FaultPlan(seed=0).rule("serve.settle", at=(0,))
    with plan:
        out = server.flush()
    assert plan.fired() == 1
    np.testing.assert_allclose(out[t].numpy(), _ref(x, spec, 2), atol=1e-4)
    s = server.stats()
    assert s["deadline_misses"] == 1
    assert s["latency"]["max_s"] >= 0.4


def test_shed_drops_lowest_priority_class_under_deadline_pressure():
    spec = ss.box(2, 1, seed=0)
    rng = np.random.default_rng(15)

    def mk():
        return rng.normal(size=(16, 16)).astype(np.float32)

    server = _server(spec, 2, shed_miss_rate=0.4, shed_window=2)
    server.serve([mk()])
    server.submit(mk(), deadline_s=0.0)
    server.submit(mk(), deadline_s=0.0)
    server.flush()
    assert server.stats()["deadline_misses"] == 2
    low = [server.submit(mk(), priority=0) for _ in range(2)]
    high_states = [mk(), mk()]
    high = [server.submit(s, priority=1) for s in high_states]
    out = server.flush()
    assert sorted(out) == high
    for t, s in zip(high, high_states):
        np.testing.assert_allclose(out[t].numpy(), _ref(s, spec, 2),
                                   atol=1e-4)
    for t in low:
        with pytest.raises(api.RequestShed, match="shed"):
            server.results(t)
    assert server.stats()["faults"]["shed"] == 2
    server.submit(mk(), deadline_s=0.0)
    server.submit(mk(), deadline_s=0.0)
    server.flush()
    only = [server.submit(mk()) for _ in range(2)]
    assert sorted(server.flush()) == only
    assert server.stats()["faults"]["shed"] == 2


# ---------------------------------------------------------------------------
# cancel() across rollout tickets
# ---------------------------------------------------------------------------

def test_cancel_covers_rollout_tickets_with_partial_emits():
    spec = ss.box(2, 1, seed=0)
    server = _server(spec, 2)
    x = np.random.default_rng(16).normal(size=(16, 16)).astype(np.float32)
    segs = [api.Segment(2, emit=True), api.Segment(2, emit=True),
            api.Segment(2)]
    t = server.submit_rollout(x, segs)
    server.step()
    server.step()
    part = server.cancel(t)
    assert isinstance(part, list)
    assert [s for s, _ in part] == [2]
    np.testing.assert_allclose(part[0][1].numpy(), _ref(x, spec, 2),
                               atol=1e-4)
    with pytest.raises(KeyError):
        server.rollout_results(t)
    assert server.pending_tickets() == []
    assert server.flush() == {}
    assert server.cancel(t) is False
    t2 = server.submit_rollout(x, [api.Segment(2, emit=True)])
    server.step()
    assert server.cancel(t2) == []
    assert server.flush() == {}
    assert server.stats()["faults"]["bucket_failures"] == 0


# ---------------------------------------------------------------------------
# Corrupt-latest checkpoint resume; rollout faults through supervision
# ---------------------------------------------------------------------------

def _rollout_fixture():
    prob = api.StencilProblem(api.PAPER_SUITE()["box2d_r1"], (24, 24),
                              boundary="periodic", steps=2)
    program = api.RolloutProgram(prob, [api.Segment(2, emit=True),
                                        api.Segment(2), api.Segment(2)])
    compiled = api.compile_program(
        api.plan_program(program, backends=["cuda"]), device="cpu")
    x = torch.from_numpy(np.random.default_rng(17).normal(size=(24, 24))
                         .astype(np.float32))
    return compiled, x


def test_resume_skips_torn_latest_checkpoint(tmp_path):
    compiled, x = _rollout_fixture()
    clean = compiled.run(x)
    d = str(tmp_path / "ckpt")
    plan = api.FaultPlan(seed=0).rule("checkpoint.write", at=(2,),
                                      action="corrupt")
    with plan:
        api.run_checkpointed(compiled, x, directory=d)
    assert plan.fired("checkpoint.write") == 1
    assert retained_steps(d) == [2, 4, 6]
    with pytest.raises(Exception):
        restore_checkpoint(d, 6, {"state": torch.zeros((24, 24))})
    out = api.run_checkpointed(compiled, x, directory=d)
    assert out.attempts == (0, 0, 1)
    assert torch.equal(out.final, clean.final)
    assert [s for s, _ in out.emits] == [s for s, _ in clean.emits]
    for (_, a), (_, b) in zip(out.emits, clean.emits):
        assert torch.equal(a, b)


def test_rollout_segment_faults_retry_through_shared_supervision(tmp_path):
    compiled, x = _rollout_fixture()
    clean = compiled.run(x)
    d = str(tmp_path / "ckpt")
    plan = api.FaultPlan(seed=0).rule("rollout.segment", at=(0, 2))
    with plan:
        out = api.run_checkpointed(
            compiled, x, directory=d,
            restart=api.RestartPolicy(max_failures=3, backoff_s=0.005),
            monitor=api.HeartbeatMonitor())
    assert plan.fired("rollout.segment") == 2
    assert torch.equal(out.final, clean.final)
    assert sum(out.recovered) == 2
    plan2 = api.FaultPlan(seed=0).rule("rollout.segment", rate=1.0)
    with plan2, pytest.raises(RuntimeError, match="restart budget"):
        api.run_checkpointed(
            compiled, x, directory=str(tmp_path / "ckpt2"),
            restart=api.RestartPolicy(max_failures=2, backoff_s=0.001))


# ---------------------------------------------------------------------------
# The slow fault matrix
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("site", ["serve.dispatch", "serve.settle",
                                  "cache.compile"])
@pytest.mark.parametrize("rate", [0.2, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_fault_matrix_bit_exact(site, rate, seed):
    spec = ss.box(2, 1, seed=0)
    states = _mixed_stream(np.random.default_rng(100 + seed), n=6)
    baseline = _server(spec, 2, async_dispatch=False).serve(states)
    server = _server(spec, 2, restart=_quick_restart(max_failures=20),
                     fallback_after=None)
    plan = api.FaultPlan(seed=seed).rule(site, rate=rate)
    with plan:
        outs = server.serve(states)
    _assert_bits(outs, baseline)
    s = server.stats()
    assert s["requests"] == len(states)
    assert s["faults"]["bucket_failures"] == plan.fired()
