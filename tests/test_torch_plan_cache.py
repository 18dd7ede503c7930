"""The port's plan/executable cache: the same key separation as the JAX
package's ``core/plan_cache.py``, the same hits, misses and evictions on
the same request sequence, a second identical request that re-plans and
re-compiles nothing (counted ``compile_plan`` calls stand in for the
reference's ``fn._cache_size()``), success accounting after readiness,
and cached executables within 1e-4 of the JAX package's."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import api as ref_api
from repro.core.plan_cache import PlanCache as RefPlanCache

from repro_torch import api
from repro_torch.core import plan_cache as pc_mod
from repro_torch.core import stencil_spec as ss
from repro_torch.core.plan_cache import PlanCache, cache_key
from repro_torch.core.time_stepper import reference_evolve
from repro_torch.launch.mesh import H100_SXM, make_mesh

torch.set_num_threads(2)


def _problem(grid=(32, 32), steps=3, batch=1, **kw):
    return api.StencilProblem(ss.box(2, 1, seed=0), grid,
                              boundary="periodic", steps=steps,
                              batch=batch, **kw)


def _cache(**kw):
    return PlanCache(device="cpu", **kw)


# ---------------------------------------------------------------------------
# Cache keying
# ---------------------------------------------------------------------------

def test_cache_key_separates_everything_that_changes_the_executable():
    base = cache_key(_problem())
    assert cache_key(_problem()) == base
    assert cache_key(_problem(grid=(48, 48))) != base
    assert cache_key(_problem(steps=5)) != base
    assert cache_key(_problem(batch=4)) != base
    assert cache_key(_problem(dtype="bfloat16")) != base
    assert cache_key(_problem(), fuse=2) != base
    assert cache_key(_problem(), backends=["torch"]) != base
    assert cache_key(_problem(), fuse_strategy="inkernel") != base
    other_spec = api.StencilProblem(ss.star(2, 1, seed=0), (32, 32),
                                    boundary="periodic", steps=3)
    assert cache_key(other_spec) != base
    rec = {"hw": "x", "compute": {"torch": 2.0}, "traffic": {}}
    assert cache_key(_problem(), calibration=rec) != base
    assert cache_key(_problem(), calibration=rec) == \
        cache_key(_problem(), calibration=dict(rec))
    assert cache_key(_problem(), hw=H100_SXM) != base
    tweaked = dataclasses.replace(H100_SXM, hbm_bw=H100_SXM.hbm_bw / 2)
    assert tweaked.name == H100_SXM.name
    assert cache_key(_problem(), hw=tweaked) != \
        cache_key(_problem(), hw=H100_SXM)
    field = ss.random_coeff_field((32, 32), seed=1)
    scen = api.StencilProblem(ss.box(2, 1, seed=0).with_field(field),
                              (32, 32), boundary="periodic", steps=3)
    assert cache_key(scen) != base


def test_cache_key_separates_rollout_program_identity():
    from repro_torch.rollout.program import RolloutProgram, Segment, UpdateOp

    def key(segments=None):
        prog = (RolloutProgram(_problem(steps=1), segments)
                if segments is not None else None)
        total = sum(s.steps for s in segments) if segments else 5
        return cache_key(_problem(steps=total), program=prog)

    base = key([Segment(2, UpdateOp("source", {"scale": 0.1})), Segment(3)])
    assert key([Segment(2, UpdateOp("source", {"scale": 0.1})),
                Segment(3)]) == base
    assert key() != base
    assert key([Segment(3, UpdateOp("source", {"scale": 0.1})),
                Segment(2)]) != base
    assert key([Segment(2, UpdateOp("source", {"scale": 0.2})),
                Segment(3)]) != base
    assert key([Segment(2, UpdateOp("nudge", {"gain": 0.1})),
                Segment(3)]) != base
    assert key([Segment(2, UpdateOp("source", {"scale": 0.1})),
                Segment(3, emit=True)]) != base
    prog = RolloutProgram(_problem(steps=1),
                          [Segment(2, UpdateOp("source", {"scale": 0.1})),
                           Segment(3)])
    assert cache_key(_problem(steps=5), program=prog.identity()) == base


def test_hw_key_fields_come_from_the_object_itself():
    @dataclasses.dataclass(frozen=True)
    class ExtendedHW(type(H100_SXM)):
        derate: float = 1.0

    base_kw = dataclasses.asdict(H100_SXM)
    full = ExtendedHW(**base_kw, derate=1.0)
    derated = ExtendedHW(**base_kw, derate=0.5)
    assert cache_key(_problem(), hw=full) != cache_key(_problem(), hw=derated)
    assert cache_key(_problem(), hw=full) == cache_key(_problem(), hw=full)

    class DuckHW:
        def __init__(self, extra):
            self.name = "duck"
            self.peak_flops = 1e12
            self.hbm_bw = 1e9
            self.extra = extra

    assert cache_key(_problem(), hw=DuckHW(1)) != \
        cache_key(_problem(), hw=DuckHW(2))


# ---------------------------------------------------------------------------
# Hits and misses against the JAX package's cache
# ---------------------------------------------------------------------------

_SEQUENCE = [((32, 32), 3, 1), ((32, 32), 3, 1), ((24, 24), 3, 1),
             ((32, 32), 3, 4), ((32, 32), 5, 1), ((32, 32), 3, 1),
             ((24, 24), 3, 1), ((16, 16), 2, 2), ((32, 32), 3, 4),
             ((24, 24), 2, 1), ((32, 32), 3, 1), ((16, 16), 2, 2)]


@pytest.mark.parametrize("maxsize", [2, 3, 32])
def test_hits_and_misses_equal_the_reference_cache(maxsize):
    port, ref = _cache(maxsize=maxsize), RefPlanCache(maxsize=maxsize)
    spec, ref_spec = ss.box(2, 1, seed=0), ref_api.box(2, 1, seed=0)
    for grid, steps, batch in _SEQUENCE:
        kw = dict(boundary="periodic", steps=steps, batch=batch)
        port.get(api.StencilProblem(spec, grid, **kw), backends=["torch"])
        ref.get(ref_api.StencilProblem(ref_spec, grid, **kw),
                backends=["jnp"])
        got, want = port.stats(), ref.stats()
        for k in ("size", "hits", "misses", "evictions"):
            assert got[k] == want[k], (k, grid, steps, batch)


# ---------------------------------------------------------------------------
# Accounting and memoization inside the port
# ---------------------------------------------------------------------------

def test_entry_accounting_sits_after_readiness():
    cache = _cache()
    entry = cache.get(_problem(steps=1), backends=["torch"])
    assert entry.calls == 0 and not entry.warm
    x = torch.ones((32, 32))
    entry(x)
    assert entry.calls == 1 and entry.warm
    assert entry.compile_s > 0 and entry.wall_s == 0.0
    entry(x)
    assert entry.calls == 2 and entry.wall_s > 0
    wall_before = entry.wall_s
    out = entry.dispatch(x)
    assert entry.calls == 2 and entry.wall_s == wall_before
    pc_mod.wait_ready(pc_mod.ready_event(out))
    assert entry.mark_ready(0.25) is True
    assert entry.calls == 3 and entry.wall_s >= wall_before + 0.25


def test_ready_event_is_a_no_op_on_the_cpu():
    assert pc_mod.ready_event(torch.ones(2)) is None
    assert pc_mod.ready_event((torch.ones(2), ())) is None
    pc_mod.wait_ready(None)


def test_plan_only_memo_is_reused_by_get(monkeypatch):
    cache = _cache()
    plans = []
    real_plan = pc_mod.plan
    monkeypatch.setattr(pc_mod, "plan",
                        lambda *a, **k: plans.append(1) or real_plan(*a, **k))
    p2 = cache.plan_only(_problem(batch=2), backends=["torch"])
    assert len(plans) == 1
    assert cache.plan_only(_problem(batch=2), backends=["torch"]) is p2
    assert len(plans) == 1
    assert cache.stats()["plans"] == 1
    entry = cache.get(_problem(batch=2), backends=["torch"])
    assert entry.plan is p2 and len(plans) == 1
    assert cache.misses == 1 and cache.hits == 0
    assert cache.stats()["plans"] == 0
    cap = cache.bucket_cap(_problem(), 4, backends=["torch"])
    assert 1 <= cap <= 4
    n = len(plans)
    assert cache.bucket_cap(_problem(), 4, backends=["torch"]) == cap
    assert len(plans) == n
    assert cache.plan_only(_problem(batch=2), backends=["torch"]) is p2
    assert len(plans) == n


def test_second_identical_request_hits_no_replan_no_recompile(monkeypatch):
    cache = _cache()
    plans, compiles = [], []
    real_plan, real_compile = pc_mod.plan, pc_mod.compile_plan
    monkeypatch.setattr(pc_mod, "plan",
                        lambda *a, **k: plans.append(1) or real_plan(*a, **k))
    monkeypatch.setattr(
        pc_mod, "compile_plan",
        lambda *a, **k: compiles.append(1) or real_compile(*a, **k))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(32, 32))
                         .astype(np.float32))
    e1 = cache.get(_problem(), backends=["cuda"])
    out1 = e1.fn(x)
    e2 = cache.get(_problem(), backends=["cuda"])
    out2 = e2.fn(x)
    assert e2 is e1
    assert cache.hits == 1 and cache.misses == 1
    assert len(plans) == 1, "second identical request re-planned"
    assert len(compiles) == 1, "second identical request re-compiled"
    assert torch.equal(out1, out2)
    assert e1.hits == 1


def test_cache_lru_eviction_is_bounded():
    cache = _cache(maxsize=2)
    p1, p2, p3 = _problem(), _problem(steps=4), _problem(steps=5)
    e1 = cache.get(p1, backends=["torch"])
    cache.get(p2, backends=["torch"])
    cache.get(p3, backends=["torch"])
    assert len(cache) == 2 and cache.evictions == 1
    assert e1.key not in cache
    cache.get(p2, backends=["torch"])
    assert cache.hits == 1
    cache.get(p1, backends=["torch"])
    assert cache.misses == 4
    cache.clear()
    assert len(cache) == 0 and cache.stats()["plans"] == 0


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_cached_executables_match_the_reference(backend):
    x = np.random.default_rng(1).normal(size=(4, 32, 32)).astype(np.float32)
    entry = _cache().get(_problem(batch=4), backends=[backend])
    got = entry(torch.from_numpy(x)).numpy()
    ref_entry = RefPlanCache().get(
        ref_api.StencilProblem(ref_api.box(2, 1, seed=0), (32, 32),
                               boundary="periodic", steps=3, batch=4),
        backends=["jnp"])
    np.testing.assert_allclose(got, np.asarray(ref_entry(jnp.asarray(x))),
                               atol=1e-4)
    want = reference_evolve(ss.box(2, 1, seed=0), torch.from_numpy(x), 3,
                            "periodic")
    np.testing.assert_allclose(got, want.numpy(), atol=1e-4)


def test_cache_defaults_to_the_card_and_mesh_waits():
    if torch.cuda.is_available():
        assert PlanCache().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            PlanCache()
    # the mesh branch is ported: a mesh problem keys by its mesh and
    # compiles to the distributed stepper (the reference's get(mesh=))
    mesh = make_mesh((2,), ("x",), devices="cpu")
    prob = _problem(mesh=mesh, grid_axes=("x", ""))
    entry = _cache().get(prob, mesh=mesh, backends=["torch"])
    assert entry.compiled.stepper is not None
    assert cache_key(prob) != cache_key(_problem())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((32, 32))
                         .astype(np.float32))
    want = reference_evolve(ss.box(2, 1, seed=0), x, 3, "periodic")
    np.testing.assert_allclose(entry(x).numpy(), want.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="maxsize"):
        _cache(maxsize=0)
