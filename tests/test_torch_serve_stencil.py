"""The port's continuous-batching ``StencilServer`` on CPU slots: within
1e-4 of the JAX package's ``jnp``-pinned server on mixed 2-D and 3-D
streams (periodic and zero) with the same buckets and cache traffic;
inside the port, mirroring ``tests/test_serve_async.py`` and the serving
cases of ``tests/test_plan_cache.py``: sync/async bit-exactness,
step()-driven bucket formation, latency and deadlines, admission caps,
failures that lose nothing, slot routing (two CPU slots in place of the
reference's fake devices), the blocking accessor and cancel races."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import api as ref_api

from repro_torch import api
from repro_torch.core import stencil_spec as ss
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.time_stepper import reference_evolve
from repro_torch.runtime import chaos

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 60.0


def _ref(state, spec, steps, boundary="periodic"):
    return reference_evolve(spec, torch.as_tensor(state), steps,
                            boundary).numpy()


def _server(spec, steps, **kw):
    kw.setdefault("backends", ["cuda"])
    kw.setdefault("devices", ["cpu"])
    return api.StencilServer(spec, steps, **kw)


# ---------------------------------------------------------------------------
# Against the JAX package's server
# ---------------------------------------------------------------------------

_STREAMS = [("star2d_r2", [(32, 32), (24, 24)], "periodic", 3),
            ("box2d_r1", [(28, 36), (16, 16)], "zero", 2),
            ("star3d_r1", [(16, 16, 16), (12, 12, 12)], "periodic", 2),
            ("box3d_r1", [(16, 16, 16)], "zero", 2)]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("case", _STREAMS, ids=lambda c: f"{c[0]}-{c[2]}")
def test_serve_matches_the_reference_server(case, backend):
    name, shapes, boundary, steps = case
    rng = np.random.default_rng(5)
    order = [0, 1, 0, 0, 1, 0, 0] if len(shapes) > 1 else [0] * 5
    states = [rng.normal(size=shapes[i]).astype(np.float32) for i in order]
    kw = dict(boundary=boundary, max_batch=4, admission=False)
    port = _server(ss.PAPER_SUITE()[name], steps, backends=[backend], **kw)
    ref = ref_api.StencilServer(ref_api.PAPER_SUITE()[name], steps,
                                backends=["jnp"], **kw)
    outs = port.serve(states)
    ref_outs = ref.serve([jnp.asarray(s) for s in states])
    for a, b in zip(outs, ref_outs):
        assert a.shape == tuple(b.shape) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    got, want = port.stats(), ref.stats()
    for k in ("requests", "batches", "padded_states"):
        assert got[k] == want[k], k
    for k in ("size", "hits", "misses"):
        assert got["plan_cache"][k] == want["plan_cache"][k], k
    port.serve(states)
    ref.serve([jnp.asarray(s) for s in states])
    assert port.stats()["plan_cache"]["hits"] == \
        ref.stats()["plan_cache"]["hits"]


# ---------------------------------------------------------------------------
# Dispatch-mode equivalence, continuous batching
# ---------------------------------------------------------------------------

def _mixed(seed=5):
    rng = np.random.default_rng(seed)
    shapes = [(32, 32), (24, 24), (32, 32), (32, 32), (24, 24), (32, 32),
              (32, 32)]
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def test_async_dispatch_bit_exact_vs_sync_on_mixed_stream():
    spec = ss.star(2, 2, seed=1)
    states = _mixed()
    a = _server(spec, 3, max_batch=4, async_dispatch=True)
    s_ = _server(spec, 3, max_batch=4, async_dispatch=False)
    outs_a, outs_s = a.serve(states), s_.serve(states)
    for state, oa, os_ in zip(states, outs_a, outs_s):
        assert torch.equal(oa, os_)
        np.testing.assert_allclose(oa.numpy(), _ref(state, spec, 3),
                                   atol=1e-4)
    for srv in (a, s_):
        st = srv.stats()
        assert st["requests"] == 7 and st["batches"] == 3
        assert st["padded_states"] == 0
        assert st["plan_cache"]["misses"] == 3
        assert st["latency"]["count"] == 7
        assert st["degraded"] == {}


def test_tensor_and_numpy_requests_give_the_same_bits():
    spec = ss.star(2, 2, seed=1)
    states = _mixed(7)
    server = _server(spec, 3, max_batch=4)
    from_numpy = server.serve(states)
    from_tensors = server.serve([torch.from_numpy(s) for s in states])
    for a, b in zip(from_numpy, from_tensors):
        assert torch.equal(a, b)
    f64 = server.serve([s.astype(np.float64) for s in states[:2]])
    assert f64[0].dtype == torch.float32
    assert torch.equal(f64[0], from_numpy[0])


def test_step_admits_newly_submitted_states_between_turns():
    spec = ss.box(2, 1, seed=0)
    server = _server(spec, 2, max_batch=4)
    rng = np.random.default_rng(4)
    s0 = rng.normal(size=(16, 16)).astype(np.float32)
    s1 = rng.normal(size=(16, 16)).astype(np.float32)
    t0 = server.submit(s0)
    assert server.step() == 0
    t1 = server.submit(s1)
    assert server.step() == 1
    assert server.ready(t0) and not server.ready(t1)
    assert server.step() == 1
    np.testing.assert_allclose(server.results(t0).numpy(),
                               _ref(s0, spec, 2), atol=1e-4)
    np.testing.assert_allclose(server.results(t1).numpy(),
                               _ref(s1, spec, 2), atol=1e-4)
    assert server.stats()["batches"] == 2
    with pytest.raises(KeyError, match="no claimable result"):
        server.results(t0)
    with pytest.raises(KeyError):
        server.results(999)


def test_latency_and_deadline_tracking():
    spec = ss.box(2, 1, seed=0)
    server = _server(spec, 2, max_batch=4)
    rng = np.random.default_rng(2)
    states = [rng.normal(size=(16, 16)).astype(np.float32)
              for _ in range(3)]
    server.submit(states[0], deadline_s=0.0)
    server.submit(states[1], deadline_s=1e6)
    server.submit(states[2])
    server.flush()
    s = server.stats()
    assert s["deadline_misses"] == 1
    lat = s["latency"]
    assert lat["count"] == 3
    assert 0 < lat["p50_s"] <= lat["p95_s"] <= lat["max_s"]
    assert lat["mean_s"] > 0
    server.reset_stats()
    assert server.stats()["latency"]["count"] == 0


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------

def test_planner_bucket_cliff_query():
    assert api.serving_buckets(8) == [1, 2, 4, 8]
    assert api.serving_buckets(6) == [1, 2, 4, 6]
    assert api.serving_buckets(1) == [1]
    star = api.StencilProblem(api.PAPER_SUITE()["star3d_r2"], (64, 64, 64),
                              boundary="periodic", steps=16)
    curve = api.batch_cost_curve(star, 8, backends=["cuda"])
    assert set(curve) == {1, 2, 4, 8}
    cap = api.max_profitable_batch(star, 8, backends=["cuda"])
    assert curve[cap] == min(curve.values())
    assert api.max_profitable_batch(star, 8, rtol=1e9,
                                    backends=["cuda"]) == 8


def test_server_admission_caps_bucket_formation(monkeypatch):
    monkeypatch.setattr(PlanCache, "bucket_cap",
                        lambda self, problem, max_batch, **kw: 2)
    spec = ss.box(2, 1, seed=0)
    rng = np.random.default_rng(6)
    states = [rng.normal(size=(16, 16)).astype(np.float32)
              for _ in range(5)]
    capped = _server(spec, 2, max_batch=8)
    outs = capped.serve(states)
    s = capped.stats()
    assert s["admission"] == {"16x16": 2}
    assert s["batches"] == 3 and s["padded_states"] == 0
    assert s["plan_cache"]["misses"] == 2
    free = _server(spec, 2, max_batch=8, admission=False)
    outs_free = free.serve(states)
    assert free.stats()["batches"] == 1
    assert free.stats()["padded_states"] == 3
    assert free.stats()["admission"] == {"16x16": 8}
    for a, b in zip(outs, outs_free):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Serving loop: variable streams, repeat traffic, padding
# ---------------------------------------------------------------------------

def test_serve_variable_size_stream_matches_reference():
    spec = ss.star(2, 2, seed=1)
    server = _server(spec, 3, max_batch=4)
    states = _mixed()
    outs = server.serve(states)
    for state, out in zip(states, outs):
        np.testing.assert_allclose(out.numpy(), _ref(state, spec, 3),
                                   atol=1e-4)
    s = server.stats()
    assert s["requests"] == 7 and s["batches"] == 3
    assert s["padded_states"] == 0
    assert s["plan_cache"]["misses"] == 3
    assert s["compile_wall_s"] > 0 and s["throughput_states_per_s"] == 0
    server.serve(states)
    s = server.stats()
    assert s["warm_states"] == 7
    assert s["per_state_s"] > 0 and s["throughput_states_per_s"] > 0


def test_serve_repeat_traffic_is_all_cache_hits():
    spec = ss.box(2, 1, seed=0)
    server = _server(spec, 2, max_batch=4)
    rng = np.random.default_rng(9)
    states = [rng.normal(size=(24, 24)).astype(np.float32)
              for _ in range(4)]
    server.serve(states)
    misses_after_cold = server.cache.misses
    server.serve(states)
    server.serve(states)
    assert server.cache.misses == misses_after_cold
    assert server.cache.hits == 2
    server.serve(states[:3])
    assert server.stats()["padded_states"] == 1
    assert server.cache.misses == misses_after_cold


def test_serve_bucket_padding_never_leaks_into_results():
    spec = ss.box(2, 1, seed=0)
    server = _server(spec, 2, max_batch=8)
    rng = np.random.default_rng(3)
    states = [rng.normal(size=(24, 24)).astype(np.float32)
              for _ in range(5)]
    outs = server.serve(states)
    solo = _server(spec, 2, max_batch=1)
    for a, b in zip(outs, solo.serve(states)):
        assert torch.equal(a, b)


def test_flush_failure_loses_no_requests_and_no_results():
    spec = ss.box(2, 1, seed=0)
    server = _server(spec, 4, boundary="valid", max_batch=4)
    rng = np.random.default_rng(7)
    good = [server.submit(rng.normal(size=(32, 32)).astype(np.float32))
            for _ in range(3)]
    bad = server.submit(np.ones((33, 1), np.float32))
    with pytest.raises(ValueError, match=str(bad)):
        server.flush()
    assert server.pending_tickets() == [bad]
    batches_after_fail = server.stats_.batches
    assert server.cancel(bad) and not server.cancel(bad)
    results = server.flush()
    assert sorted(results) == good
    assert server.stats_.batches == batches_after_fail
    assert server.stats_.requests == 3


def test_serve_does_not_drop_recovered_results_of_other_tickets():
    spec = ss.box(2, 1, seed=0)
    server = _server(spec, 4, boundary="valid", max_batch=4)
    rng = np.random.default_rng(7)
    good_states = [rng.normal(size=(32, 32)).astype(np.float32)
                   for _ in range(2)]
    good = [server.submit(s) for s in good_states]
    bad = server.submit(np.ones((33, 1), np.float32))
    with pytest.raises(ValueError, match=str(bad)):
        server.flush()
    assert server.ready(good[0]) and server.ready(good[1])
    server.cancel(bad)
    outs = server.serve([rng.normal(size=(32, 32)).astype(np.float32)])
    assert len(outs) == 1
    assert server.ready(good[0]) and server.ready(good[1])
    np.testing.assert_allclose(server.results(good[0]).numpy(),
                               _ref(good_states[0], spec, 4, "valid"),
                               atol=1e-4)
    assert list(server.flush()) == [good[1]]
    assert not server.ready(good[1])


def test_settle_failure_keeps_executable_cold_and_requeues():
    """A bucket failing between dispatch and readiness (the deferred
    device error; here every settle while the plan is active): its
    requests requeue, nothing is double-counted, and the executable books
    no success, so the recovery call is compile-accounted."""
    spec = ss.box(2, 1, seed=0)
    server = _server(spec, 2, max_batch=4, admission=False,
                     restart=api.RestartPolicy(max_failures=2,
                                               backoff_s=0.001),
                     fallback_after=None)
    rng = np.random.default_rng(8)
    states = [rng.normal(size=(16, 16)).astype(np.float32)
              for _ in range(4)]
    tickets = [server.submit(s) for s in states]
    with chaos.FaultPlan(seed=0).rule("serve.settle", rate=1.0):
        with pytest.raises(ValueError, match="stay queued"):
            server.flush()
    entry = server.cache.get(server._problem((16, 16), 4),
                             backends=["cuda"])
    assert entry.calls == 0 and entry.compile_s == 0.0 and not entry.warm
    # every failed settle had launched its bucket
    assert entry.dispatches == server.stats_.bucket_failures > 0
    assert sorted(server.pending_tickets()) == tickets
    assert server.stats_.batches == 0 and server.stats_.requests == 0
    outs = server.flush()
    assert sorted(outs) == tickets
    for t, state in zip(tickets, states):
        np.testing.assert_allclose(outs[t].numpy(), _ref(state, spec, 2),
                                   atol=1e-4)
    assert entry.calls == 1 and entry.compile_s > 0 and entry.wall_s == 0.0
    assert entry.dispatches == server.stats_.bucket_failures + 1
    assert server.stats_.warm_states == 0


# ---------------------------------------------------------------------------
# Device slots
# ---------------------------------------------------------------------------

def test_slots_round_robin_shape_groups():
    spec = ss.box(2, 1, seed=0)
    server = _server(spec, 2, max_batch=4, devices=["cpu"] * 4)
    assert len(server.caches) == 4
    rng = np.random.default_rng(0)
    shapes = [(16, 16), (24, 24), (32, 32)]
    states = [rng.normal(size=shapes[i % 3]).astype(np.float32)
              for i in range(9)]
    outs = server.serve(states)
    for state, out in zip(states, outs):
        np.testing.assert_allclose(out.numpy(), _ref(state, spec, 2),
                                   atol=1e-4)
    s = server.stats()
    used = [d for d in s["devices"] if d["batches"]]
    assert len(used) == 3
    for d in used:
        assert d["batches"] == 1 and d["states"] == 3
        assert d["plan_cache"]["misses"] == 1
        assert d["device"] == "cpu"
    assert s["plan_cache"]["misses"] == 3
    server.serve(states)
    s2 = server.stats()
    assert s2["plan_cache"]["misses"] == 3
    assert s2["plan_cache"]["hits"] == 3


# ---------------------------------------------------------------------------
# Accessor/scheduler races
# ---------------------------------------------------------------------------

def test_results_timeout_expires_mid_settle_then_claims():
    spec = ss.box(2, 1, seed=0)
    server = _server(spec, 2, max_batch=2)
    state = np.random.default_rng(0).normal(size=(16, 16)) \
        .astype(np.float32)
    server.serve([state])
    plan = chaos.FaultPlan(seed=0).rule("serve.settle", action="delay",
                                        delay_s=0.6, at=(0,))
    server.start(poll_s=0.01)
    try:
        with plan:
            t = server.submit(state)
            with pytest.raises(TimeoutError):
                server.results(t, timeout_s=0.05)
            out = server.results(t, timeout_s=TIMEOUT_S)
    finally:
        server.stop()
    assert plan.fired("serve.settle") == 1
    np.testing.assert_allclose(out.numpy(), _ref(state, spec, 2), atol=1e-4)
    with pytest.raises(KeyError):
        server.results(t)


def test_cancel_races_requeued_bucket():
    spec = ss.box(2, 1, seed=0)
    server = _server(spec, 2, max_batch=4, admission=False,
                     async_dispatch=False,
                     restart=api.RestartPolicy(max_failures=3, backoff_s=0.0))
    rng = np.random.default_rng(3)
    states = [rng.normal(size=(16, 16)).astype(np.float32)
              for _ in range(3)]
    tickets = [server.submit(s) for s in states]
    plan = chaos.FaultPlan(seed=0).rule("serve.settle", at=(0,))
    with plan:
        server.step()
        assert sorted(server.pending_tickets()) == sorted(tickets)
        assert server.cancel(tickets[1]) is True
        outs = server.flush()
    assert sorted(outs) == sorted([tickets[0], tickets[2]])
    for t, state in ((tickets[0], states[0]), (tickets[2], states[2])):
        np.testing.assert_allclose(outs[t].numpy(), _ref(state, spec, 2),
                                   atol=1e-4)
    with pytest.raises(KeyError):
        server.results(tickets[1])
    st = server.stats()
    assert st["faults"]["bucket_failures"] == 1
    assert st["faults"]["retries"] == 1
    assert st["requests"] == 2


# ---------------------------------------------------------------------------
# Validation, defaults and the CLI
# ---------------------------------------------------------------------------

def test_server_validates_input_rank_and_steps():
    spec = ss.box(2, 1, seed=0)
    with pytest.raises(ValueError):
        _server(spec, -1)
    server = _server(spec, 2)
    with pytest.raises(ValueError):
        server.submit(np.zeros((2, 16, 16), np.float32))
    # mesh serving is ported: it needs as many slots as the mesh
    with pytest.raises(ValueError, match="slots"):
        _server(spec, 2, mesh_shape=(2,))
    x = np.random.default_rng(0).standard_normal((16, 16)).astype(np.float32)
    mesh_server = _server(spec, 2, mesh_shape=(2,), devices=["cpu"] * 2)
    np.testing.assert_allclose(mesh_server.serve([x])[0].numpy(),
                               _ref(x, spec, 2), atol=1e-4)
    assert mesh_server.stats()["meshes"] == {"16x16": "2"}


def test_server_defaults_to_the_card():
    spec = ss.box(2, 1, seed=0)
    if torch.cuda.is_available():
        assert api.StencilServer(spec, 2).stats()["devices"][0][
            "device"].startswith("cuda")
        return
    with pytest.raises(RuntimeError, match="cuda"):
        api.StencilServer(spec, 2)
    server = api.StencilServer(spec, 2, cache=PlanCache(device="cpu"))
    assert server.stats()["devices"][0]["device"] == "cpu"


def test_cli_serves_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_stencil",
         "--device", "cpu", "--backends", "torch", "--grid", "24",
         "--requests", "6", "--steps", "2", "--max-batch", "4"],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"},
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "served 12 states of star2d_r2" in out.stdout
    assert "plan cache: 2 hits / 2 misses" in out.stdout
