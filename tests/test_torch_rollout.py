"""Rollout programs in the port against the JAX package's: equal program
digests (the checkpoint guard), the same field draws, reference plans
that load with the same per-segment decisions, compiled programs within
1e-4 of the reference's (2-D and 3-D, periodic and zero), and a
reference checkpoint that resumes here.  Inside the port, mirroring
``tests/test_rollout.py``: bit-exact vs a stepwise run, kill/resume
bit-exact, the digest guard, ``keep_last``, restart and timeout budgets,
program cache entries and rollout serving.  Also ``evolve_until``."""
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import api as ref_api
from repro.core import time_stepper as ref_ts
from repro.rollout import (RolloutProgram as RefRolloutProgram,
                           Segment as RefSegment, UpdateOp as RefUpdateOp,
                           build_update as ref_build_update,
                           compile_program as ref_compile_program,
                           plan_program as ref_plan_program,
                           run_checkpointed as ref_run_checkpointed)

from repro_torch import api
from repro_torch.core import evolve_until
from repro_torch.core import stencil_spec as ss
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.planner import PLAN_VERSION, StencilProblem
from repro_torch.core.time_stepper import reference_evolve
from repro_torch.launch.serve_stencil import StencilServer
from repro_torch.rollout import (RolloutPlan, RolloutProgram, Segment,
                                 UpdateOp, as_segments, build_update,
                                 compile_program, plan_program,
                                 register_update_op, run_checkpointed,
                                 update_op_names)
from repro_torch.launch.mesh import make_mesh
from repro_torch.rollout.executor import shrink_mesh
from repro_torch.rollout.program import segment_out_grid
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                 RestartPolicy, StepTimeout)

torch.set_num_threads(2)

SUITE = ss.PAPER_SUITE()

# the acceptance program: 3 segments, 2 distinct update ops, emit points
SEG_ARGS = ((3, ("source", {"scale": 0.1, "seed": 1}), True),
            (2, ("nudge", {"gain": 0.25, "seed": 2}), False),
            (4, None, True))


def _segments(seg_cls=Segment, op_cls=UpdateOp, args=SEG_ARGS):
    return tuple(seg_cls(n, op_cls(*u) if u else None, emit=e)
                 for n, u, e in args)


SEGMENTS = _segments()


def _program(spec=None, grid=(32, 32), boundary="periodic", batch=2,
             segments=SEGMENTS):
    spec = spec if spec is not None else SUITE["box2d_r1"]
    prob = StencilProblem(spec, grid, boundary=boundary, steps=1,
                          batch=batch)
    return RolloutProgram(prob, segments)


def _ref_program(name="box2d_r1", grid=(32, 32), boundary="periodic",
                 batch=2, args=SEG_ARGS):
    prob = ref_api.StencilProblem(ref_api.PAPER_SUITE()[name], grid,
                                  boundary=boundary, steps=1, batch=batch)
    return RefRolloutProgram(prob, _segments(RefSegment, RefUpdateOp, args))


def _np_state(program, seed=0):
    shape = ((program.problem.batch,) if program.problem.batch > 1
             else ()) + program.problem.grid
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _state(program, seed=0):
    return torch.from_numpy(_np_state(program, seed))


def _compile(prog, **kw):
    kw.setdefault("backends", ["cuda"])
    return compile_program(plan_program(prog, **kw), device="cpu")


def _assert_result_equal(a, b):
    assert torch.equal(a.final, b.final)
    assert [t for t, _ in a.emits] == [t for t, _ in b.emits]
    for (_, x), (_, y) in zip(a.emits, b.emits):
        assert torch.equal(x, y)


def _stepwise_reference(program, rplan, x):
    """Per segment, ``steps`` applications of a depth-1 plan pinned to the
    segment plan's (backend, block, base cover), then the update."""
    y = x
    for i, seg in enumerate(program.segments):
        p = rplan.segment_plans[i]
        pb1 = dataclasses.replace(program.segment_problem(i), steps=1)
        one = None
        for _ in range(seg.steps):
            if program.problem.boundary == "valid" or one is None:
                grid = tuple(y.shape[y.ndim - len(pb1.grid):])
                one = api.compile(api.plan(
                    dataclasses.replace(pb1, grid=grid),
                    backends=[p.backend], option=p.base_option,
                    block=tuple(min(b, g) for b, g in zip(p.block, grid))),
                    device="cpu")
            y = one.fn(y)
        if seg.update is not None:
            y = build_update(seg.update, program.segment_problem(i))(y)
    return y


# ---------------------------------------------------------------------------
# Program spec, identity and the reference's digests
# ---------------------------------------------------------------------------

def test_program_spec_validation_and_identity():
    prog = _program()
    assert prog.total_steps == 9
    assert prog.emit_steps() == [3, 9]
    ident = prog.identity()
    assert len(ident) == 3
    assert ident[0][0] == 3 and ident[0][2] is True
    assert ident[2] == (4, None, True)
    assert _program(segments=(Segment(3), Segment(2), Segment(4))
                    ).identity() != ident
    changed = (SEGMENTS[0], Segment(2, UpdateOp("nudge", {"gain": 0.5,
                                                          "seed": 2})),
               SEGMENTS[2])
    assert _program(segments=changed).identity() != ident
    assert _program(segments=changed).digest() != prog.digest()
    with pytest.raises(ValueError, match="segment"):
        RolloutProgram(prog.problem, ())
    with pytest.raises(ValueError):
        Segment(0)


_DIGEST_CASES = [("box2d_r1", (32, 32), "periodic", 2, SEG_ARGS),
                 ("star2d_r2", (40, 36), "zero", 1, SEG_ARGS),
                 ("star3d_r1", (16, 16, 16), "periodic", 1,
                  ((2, None, True), (1, ("scale", {"factor": 0.5}), False))),
                 ("diag2d_r1", (40, 40), "valid", 3, SEG_ARGS)]


@pytest.mark.parametrize("case", _DIGEST_CASES, ids=lambda c: c[0])
def test_digest_and_identity_equal_the_reference(case):
    name, grid, boundary, batch, args = case
    ref = _ref_program(name, grid, boundary, batch, args)
    port = RolloutProgram(
        StencilProblem(SUITE[name], grid, boundary=boundary, steps=1,
                       batch=batch), _segments(args=args))
    assert port.identity() == ref.identity()
    assert port.digest() == ref.digest()
    assert RolloutProgram.from_dict(ref.to_dict()).digest() == ref.digest()


def test_scenario_program_digest_equals_the_reference():
    grid = (24, 24)
    field = ss.random_coeff_field(grid, seed=5)
    mask = ss.random_domain_mask(grid, seed=6)
    ref_spec = ref_api.PAPER_SUITE()["star2d_r1"].with_field(
        field, domain_mask=mask)
    port_spec = SUITE["star2d_r1"].with_field(field, domain_mask=mask)
    ref = RefRolloutProgram(ref_api.StencilProblem(ref_spec, grid, steps=1),
                            _segments(RefSegment, RefUpdateOp))
    port = RolloutProgram(StencilProblem(port_spec, grid, steps=1), SEGMENTS)
    assert port.digest() == ref.digest()


def test_program_round_trip_and_normalization():
    prog = _program()
    back = RolloutProgram.from_dict(json.loads(json.dumps(prog.to_dict())))
    assert back.identity() == prog.identity()
    assert back.digest() == prog.digest()
    segs = as_segments([4, (2, UpdateOp("scale", {"factor": 0.5})),
                        {"steps": 3, "emit": True}])
    assert segs[0] == Segment(4)
    assert segs[1].update.op == "scale"
    assert segs[2].emit


def test_update_op_registry_and_identity():
    assert {"source", "nudge", "scale"} <= set(update_op_names())
    a = UpdateOp("source", {"scale": 0.1, "seed": 3})
    b = UpdateOp("source", {"seed": 3, "scale": 0.1})
    assert a.update_id == b.update_id
    assert a.update_id == RefUpdateOp("source", {"scale": 0.1,
                                                 "seed": 3}).update_id
    with pytest.raises(ValueError, match="JSON-native"):
        UpdateOp("source", {"field": np.zeros(3)})
    with pytest.raises(ValueError, match="unknown update op"):
        build_update(UpdateOp("no_such_op"), _program().problem, (8, 8))
    register_update_op("test_clip",
                       lambda params, pb, grid:
                       lambda x: torch.clamp(x, -params["lim"],
                                             params["lim"]),
                       overwrite=True)
    fn = build_update(UpdateOp("test_clip", {"lim": 0.5}),
                      _program().problem, (8, 8))
    assert torch.equal(fn(torch.full((8, 8), 3.0)), torch.full((8, 8), 0.5))
    with pytest.raises(ValueError, match="already registered"):
        register_update_op("test_clip", lambda *a: None)


@pytest.mark.parametrize("op", [("source", {"scale": 0.1, "seed": 1}),
                                ("source", {"value": 2.0}),
                                ("nudge", {"gain": 0.25, "seed": 2}),
                                ("scale", {"factor": 0.5})])
def test_update_ops_draw_the_reference_fields(op):
    grid = (12, 10)
    x = np.random.default_rng(9).standard_normal((2,) + grid) \
        .astype(np.float32)
    prob = StencilProblem(SUITE["box2d_r1"], grid, steps=1)
    ref_prob = ref_api.StencilProblem(ref_api.PAPER_SUITE()["box2d_r1"],
                                      grid, steps=1)
    got = build_update(UpdateOp(*op), prob)(torch.from_numpy(x))
    want = ref_build_update(RefUpdateOp(*op), ref_prob)(jnp.asarray(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_valid_boundary_grid_threading():
    prog = _program(grid=(40, 40), boundary="valid", batch=1)
    assert prog.segment_grid(0) == (40, 40)
    assert prog.segment_grid(1) == (34, 34)
    assert prog.segment_grid(2) == (30, 30)
    assert segment_out_grid(prog.segment_problem(2)) == (22, 22)
    with pytest.raises(ValueError, match="shrinks"):
        _program(grid=(12, 12), boundary="valid", batch=1)


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------

def test_plan_program_per_segment_decisions_and_round_trip():
    prog = _program()
    rp = plan_program(prog, backends=["cuda"])
    assert rp.version == PLAN_VERSION
    assert len(rp.segment_plans) == 3
    for seg, p in zip(prog.segments, rp.segment_plans):
        assert p.steps == seg.steps
    assert rp.segment_plans[2].fuse_depth <= 4
    assert rp.segment_plans[1].fuse_depth <= 2
    back = RolloutPlan.from_json(rp.to_json())
    assert back.to_json() == rp.to_json()
    text = rp.explain()
    assert "RolloutPlan v" in text and "3 segments" in text
    assert "source" in text and "nudge" in text
    t = rp.traffic()
    assert t["fused_bytes_per_state"] > 0
    assert t["traffic_ratio"] >= 1.0
    with pytest.raises(ValueError, match="version"):
        RolloutPlan.from_json(json.dumps(
            dict(json.loads(rp.to_json()), version=PLAN_VERSION - 1)))


@pytest.mark.parametrize("strategy,depth", [("inkernel", 2),
                                            ("operator", 2),
                                            ("inkernel", 1)])
def test_reference_plan_loads_with_the_same_decisions(strategy, depth):
    ref_rp = ref_plan_program(_ref_program(), backends=["pallas"],
                              fuse=depth, fuse_strategy=strategy)
    loaded = RolloutPlan.from_json(ref_rp.to_json())
    mine = plan_program(_program(), backends=["cuda"], fuse=depth,
                        fuse_strategy=strategy)
    assert loaded.program_obj().digest() == _program().digest()
    for a, b, r in zip(loaded.segment_plans, mine.segment_plans,
                       ref_rp.segment_plans):
        assert a.backend == "cuda"
        assert a.fuse_schedule == b.fuse_schedule == r.fuse_schedule
        assert a.fuse_strategy == b.fuse_strategy == r.fuse_strategy
        assert a.halo_strategy == b.halo_strategy
    x = _np_state(_program())
    got = compile_program(loaded, device="cpu").run(torch.from_numpy(x))
    want = ref_compile_program(ref_rp).run(jnp.asarray(x))
    np.testing.assert_allclose(got.final.numpy(), np.asarray(want.final),
                               atol=1e-4)


def test_plan_program_through_cache_memo():
    cache = PlanCache(device="cpu")
    prog = _program()
    rp1 = plan_program(prog, cache=cache, backends=["torch"])
    n_plans = cache.stats()["plans"]
    assert n_plans >= 1
    rp2 = plan_program(prog, cache=cache, backends=["torch"])
    assert cache.stats()["plans"] == n_plans
    assert rp2 == rp1


# ---------------------------------------------------------------------------
# Execution: inside the port, and against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("boundary", ["periodic", "zero", "valid"])
def test_program_bit_exact_vs_stepwise(boundary):
    grid = (40, 40) if boundary == "valid" else (32, 32)
    prog = _program(grid=grid, boundary=boundary)
    rp = plan_program(prog, backends=["cuda"], fuse_strategy="inkernel")
    compiled = compile_program(rp, device="cpu")
    x = _state(prog)
    res = compiled.run(x)
    ref = _stepwise_reference(prog, rp, x)
    assert torch.equal(res.final, ref)
    assert [t for t, _ in res.emits] == prog.emit_steps()
    assert res.emits[-1][1].shape == res.final.shape


_PARITY = [("box2d_r1", (32, 32), "periodic", 2),
           ("star2d_r2", (36, 40), "zero", 1),
           ("star3d_r1", (16, 16, 16), "periodic", 1),
           ("box3d_r1", (16, 16, 16), "zero", 2)]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("case", _PARITY, ids=lambda c: f"{c[0]}-{c[2]}")
def test_compiled_program_matches_the_reference(case, backend):
    name, grid, boundary, batch = case
    prog = RolloutProgram(StencilProblem(SUITE[name], grid,
                                         boundary=boundary, steps=1,
                                         batch=batch), SEGMENTS)
    ref_prog = _ref_program(name, grid, boundary, batch)
    x = _np_state(prog, seed=4)
    got = _compile(prog, backends=[backend]).run(torch.from_numpy(x))
    want = ref_compile_program(ref_prog, backends=["jnp"]).run(
        jnp.asarray(x))
    np.testing.assert_allclose(got.final.numpy(), np.asarray(want.final),
                               atol=1e-4)
    assert [t for t, _ in got.emits] == [t for t, _ in want.emits]
    for (_, a), (_, b) in zip(got.emits, want.emits):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_program_matches_the_gather_oracle():
    prog = _program(batch=1)
    res = _compile(prog).run(_state(prog))
    y = _state(prog)
    for i, seg in enumerate(prog.segments):
        y = reference_evolve(prog.problem.spec, y, seg.steps, "periodic")
        if seg.update is not None:
            y = build_update(seg.update, prog.segment_problem(i))(y)
    np.testing.assert_allclose(res.final.numpy(), y.numpy(), atol=1e-4)


def test_compiled_rollout_stream_and_segment_dedup():
    segs = (Segment(2, UpdateOp("source", {"scale": 0.1})),
            Segment(2, UpdateOp("source", {"scale": 0.1})),
            Segment(2))
    prog = _program(segments=segs)
    compiled = _compile(prog, backends=["torch"])
    assert len({id(f) for f in compiled.sweeps}) == 1
    ups = [u for u in compiled.updates if u is not None]
    assert len({id(u) for u in ups}) == 1
    x = _state(prog)
    seen = list(compiled.stream(x))
    assert [t for _, t, _ in seen] == [2, 4, 6]
    assert torch.equal(seen[-1][2], compiled.run(x).final)


def test_compile_program_defaults_to_the_card():
    prog = _program()
    if torch.cuda.is_available():
        assert compile_program(prog, backends=["cuda"]).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        compile_program(prog, backends=["cuda"])
    # a mesh program compiles (the mesh branch is ported) and runs the
    # same rollout within 1e-4 of the single-device one
    mesh = make_mesh((2,), ("x",), devices="cpu")
    mprog = RolloutProgram(dataclasses.replace(
        prog.problem, mesh=mesh, grid_axes=("x", "")), prog.segments)
    compiled = compile_program(mprog, device="cpu", backends=["cuda"])
    assert compiled.mesh is mesh
    x = _state(prog)
    got, want = compiled.run(x), _compile(prog).run(x)
    torch.testing.assert_close(got.final, want.final, atol=1e-4, rtol=0)
    assert shrink_mesh(mesh).shape == (1,)


# ---------------------------------------------------------------------------
# Checkpointed, fault-tolerant driving
# ---------------------------------------------------------------------------

class Kill(RuntimeError):
    pass


def test_kill_and_resume_bit_exact(tmp_path):
    prog = _program()
    compiled = _compile(prog)
    x = _state(prog)
    uninterrupted = run_checkpointed(compiled, x)
    d = str(tmp_path / "ckpt")

    def die_in_segment_2(seg, attempt):
        if seg == 2:
            raise Kill("injected mid-program kill")

    with pytest.raises(Kill):
        run_checkpointed(compiled, x, directory=d,
                         fault_injector=die_in_segment_2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000005"]
    resumed = run_checkpointed(compiled, x, directory=d)
    assert resumed.attempts == (0, 0, 1)
    _assert_result_equal(resumed, uninterrupted)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """A run of the JAX package killed after segment 1 resumes here: the
    digest guard accepts it, and the result is the port's own from the
    restored state, within 1e-4 of the reference's uninterrupted run."""
    ref_prog, prog = _ref_program(), _program()
    x = _np_state(prog, seed=6)
    ref_compiled = ref_compile_program(ref_prog, backends=["jnp"])
    clean = ref_compiled.run(jnp.asarray(x))
    d = str(tmp_path / "ckpt")

    def kill_after_first(seg, attempt):
        if seg == 1:
            raise Kill("killed")

    with pytest.raises(Kill):
        ref_run_checkpointed(ref_compiled, jnp.asarray(x), directory=d,
                             fault_injector=kill_after_first)
    resumed = run_checkpointed(_compile(prog), torch.from_numpy(x),
                               directory=d)
    assert resumed.attempts == (0, 1, 1)
    np.testing.assert_allclose(resumed.final.numpy(),
                               np.asarray(clean.final), atol=1e-4)
    assert [t for t, _ in resumed.emits] == [3, 9]
    np.testing.assert_array_equal(resumed.emits[0][1].numpy(),
                                  np.asarray(clean.emits[0][1]))


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    ref_prog, prog = _ref_program(), _program()
    x = _np_state(prog, seed=7)
    d = str(tmp_path / "ckpt")

    def kill_after_first(seg, attempt):
        if seg == 1:
            raise Kill("killed")

    with pytest.raises(Kill):
        run_checkpointed(_compile(prog), torch.from_numpy(x), directory=d,
                         fault_injector=kill_after_first)
    ref_compiled = ref_compile_program(ref_prog, backends=["jnp"])
    resumed = ref_run_checkpointed(ref_compiled, jnp.asarray(x), directory=d)
    assert resumed.attempts == (0, 1, 1)
    clean = ref_compiled.run(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(resumed.final),
                               np.asarray(clean.final), atol=1e-4)


def test_resume_guards_program_digest(tmp_path):
    prog = _program()
    d = str(tmp_path / "ckpt")
    run_checkpointed(_compile(prog, backends=["torch"]), _state(prog),
                     directory=d)
    other = _program(segments=(Segment(3), Segment(2), Segment(4)))
    with pytest.raises(ValueError, match="different rollout program"):
        run_checkpointed(_compile(other, backends=["torch"]), _state(other),
                         directory=d)


def test_keep_last_retention(tmp_path):
    prog = _program(segments=(Segment(1), Segment(1), Segment(1),
                              Segment(1, emit=True)))
    compiled = _compile(prog, backends=["torch"], fuse=1)
    d = str(tmp_path / "ckpt")
    run_checkpointed(compiled, _state(prog), directory=d, keep_last=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]


def test_restart_policy_retries_transient_segment_failures():
    prog = _program()
    compiled = _compile(prog)
    x = _state(prog)
    clean = run_checkpointed(compiled, x)
    fails = {"n": 0}

    def flaky(seg, attempt):
        if seg == 1 and attempt <= 2:
            fails["n"] += 1
            raise RuntimeError(f"transient failure {attempt}")

    policy = RestartPolicy(max_failures=3, backoff_s=0.001)
    out = run_checkpointed(compiled, x, restart=policy, fault_injector=flaky)
    assert fails["n"] == 2
    assert policy.failures == 0
    assert out.attempts == (1, 3, 1) and out.recovered == (0, 1, 0)
    assert torch.equal(out.final, clean.final)
    fails["n"] = 0
    with pytest.raises(RuntimeError, match="transient"):
        run_checkpointed(compiled, x, fault_injector=flaky)
    assert fails["n"] == 1


def test_restart_budget_exhaustion_propagates():
    prog = _program(segments=(Segment(2),))
    compiled = _compile(prog, backends=["torch"])

    def always_fail(seg, attempt):
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        run_checkpointed(compiled, _state(prog),
                         restart=RestartPolicy(max_failures=2,
                                               backoff_s=0.001),
                         fault_injector=always_fail)


def test_hard_timeout_feeds_restart_path():
    prog = _program(segments=(Segment(2),), batch=1)
    compiled = _compile(prog, backends=["torch"])
    slow = {"n": 0}

    def straggle(seg, attempt):
        slow["n"] += 1
        time.sleep(0.03)

    with pytest.raises(StepTimeout):
        run_checkpointed(compiled, _state(prog),
                         monitor=HeartbeatMonitor(hard_timeout_s=0.01),
                         fault_injector=straggle)
    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        run_checkpointed(compiled, _state(prog),
                         monitor=HeartbeatMonitor(hard_timeout_s=0.01),
                         restart=RestartPolicy(max_failures=1,
                                               backoff_s=0.001),
                         fault_injector=straggle)
    assert slow["n"] == 3


# ---------------------------------------------------------------------------
# Plan-cache program entries and rollout serving
# ---------------------------------------------------------------------------

def test_get_program_one_entry_hit_and_separation():
    cache = PlanCache(device="cpu")
    prog = _program()
    e1 = cache.get_program(prog, backends=["cuda"])
    assert cache.stats()["misses"] == 1 and len(cache) == 1
    e2 = cache.get_program(prog, backends=["cuda"])
    assert e2 is e1 and cache.stats()["hits"] == 1
    x = _state(prog)
    final, emits = e1(x)
    assert len(emits) == 2
    assert torch.equal(final, _compile(prog).run(x).final)
    plain = dataclasses.replace(prog.problem, steps=prog.total_steps)
    e3 = cache.get(plain, backends=["cuda"])
    assert e3 is not e1 and len(cache) == 2
    changed = RolloutProgram(prog.problem, (
        Segment(3, UpdateOp("source", {"scale": 0.9, "seed": 1}),
                emit=True),) + prog.segments[1:])
    assert cache.get_program(changed, backends=["cuda"]) is not e1
    assert len(cache) == 3


def _cpu_server(spec, steps, **kw):
    return StencilServer(spec, steps=steps, backends=["cuda"],
                         devices=["cpu"], **kw)


def test_server_rollout_streaming_and_batching():
    spec = SUITE["box2d_r1"]
    server = _cpu_server(spec, 4, max_batch=4)
    rng = np.random.default_rng(3)
    states = [rng.standard_normal((24, 24)).astype(np.float32)
              for _ in range(4)]
    tickets = [server.submit_rollout(s, SEGMENTS) for s in states]
    out = server.flush()
    assert sorted(out) == tickets
    st = server.stats()
    assert st["batches"] == 3
    assert st["requests"] == 4
    assert st["latency"]["count"] == 4
    prob = StencilProblem(spec, (24, 24), boundary="periodic", steps=1,
                          batch=4)
    compiled = compile_program(RolloutProgram(prob, SEGMENTS),
                               backends=["cuda"], device="cpu")
    ref = compiled.run(torch.from_numpy(np.stack(states)))
    for i, t in enumerate(tickets):
        assert torch.equal(out[t], ref.final[i])
        ems = server.rollout_results(t)
        assert [s for s, _ in ems] == [3, 9]
        for (s, a), (rs, rb) in zip(ems, ref.emits):
            assert s == rs
            assert torch.equal(a, rb[i])
        assert server.rollout_done(t)
    with pytest.raises(KeyError):
        server.rollout_results(tickets[0])


def test_server_rollout_incremental_drain_and_plain_coexistence():
    spec = SUITE["box2d_r1"]
    server = _cpu_server(spec, 2, max_batch=4)
    x = np.random.default_rng(4).standard_normal((16, 16)).astype(np.float32)
    t_roll = server.submit_rollout(
        x, [Segment(2, emit=True), Segment(2, emit=True)])
    t_plain = server.submit(x)
    server.step()
    server.step()
    ems = server.rollout_results(t_roll)
    assert [s for s, _ in ems] == [2]
    assert not server.rollout_done(t_roll)
    assert server.ready(t_plain)
    assert torch.equal(server.results(t_plain), ems[0][1])
    server.flush()
    assert server.rollout_done(t_roll)
    assert [s for s, _ in server.rollout_results(t_roll)] == [4]
    misses0 = server.cache.stats()["misses"]
    t2 = server.submit_rollout(
        x, [Segment(2, emit=True), Segment(2, emit=True)])
    server.flush()
    assert server.cache.stats()["misses"] == misses0
    assert server.rollout_done(t2)


def test_server_rollout_rejects_bad_input():
    server = _cpu_server(SUITE["box2d_r1"], 2)
    with pytest.raises(ValueError, match="rank"):
        server.submit_rollout(np.zeros((2, 8, 8), np.float32), [Segment(1)])
    with pytest.raises(ValueError, match="segment"):
        server.submit_rollout(np.zeros((8, 8), np.float32), [])
    vs = _cpu_server(SUITE["box2d_r1"], 2, boundary="valid")
    with pytest.raises(ValueError, match="shape-preserving"):
        vs.submit_rollout(np.zeros((16, 16), np.float32), [Segment(1)])


# ---------------------------------------------------------------------------
# evolve_until
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tol,max_steps", [(0.05, 50), (1e-9, 7), (10.0, 5)])
def test_evolve_until_matches_the_reference(tol, max_steps):
    spec = SUITE["box2d_r1"]
    x = np.random.default_rng(2).standard_normal((16, 16)).astype(np.float32)
    port_step = api.compile(api.plan(api.StencilProblem(
        spec, (16, 16), steps=1), backends=["torch"]), device="cpu").fn
    ref_step = ref_api.compile(ref_api.plan(ref_api.StencilProblem(
        ref_api.PAPER_SUITE()["box2d_r1"], (16, 16), steps=1),
        backends=["jnp"])).fn
    got = evolve_until(port_step, torch.from_numpy(x), tol, max_steps)
    want = ref_ts.evolve_until(ref_step, jnp.asarray(x), tol, max_steps)
    assert got.steps_run == int(want.steps_run)
    np.testing.assert_allclose(float(got.residual), float(want.residual),
                               rtol=1e-4)
    np.testing.assert_allclose(got.state.numpy(), np.asarray(want.state),
                               atol=1e-4)
