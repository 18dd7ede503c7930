"""The port's planner and compile path against the JAX package.

Cost-dependent choices (backend, cover, block) are the port's own — its
model prices the Hopper kernels — but every decision made without
reference to hardware must agree with the reference: legal covers, fusion
legality, the fuse schedule of a pinned depth and the halo strategy.
Compiled plans run on the CPU here (``device="cpu"``) and must match the
JAX package's compiled plans within 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import api as ref_api
from repro.core import stencil_spec as ref_ss

from repro_torch import api
from repro_torch.core import matrixization as mx
from repro_torch.core import planner
from repro_torch.core import stencil_spec as ss

torch.set_num_threads(2)


def _scenario(pair, grid, seed=5):
    field = ss.random_coeff_field(grid, seed=seed)
    mask = ss.random_domain_mask(grid, seed=seed + 1)
    ref, port = pair
    return (ref.with_field(field, domain_mask=mask),
            port.with_field(field, domain_mask=mask))


def _pair(name, grid=None, scenario=False):
    pair = ref_ss.PAPER_SUITE()[name], ss.PAPER_SUITE()[name]
    return _scenario(pair, grid) if scenario else pair


# (suite name, grid, boundary, steps, batch, scenario)
PROBLEMS = [
    ("star2d_r2", (40, 40), "periodic", 6, 1, False),
    ("box2d_r1", (36, 28), "zero", 5, 2, False),
    ("star3d_r1", (20, 20, 20), "zero", 3, 1, False),
    ("star2d_r1", (32, 32), "periodic", 4, 1, True),
    ("diag2d_r1", (30, 30), "valid", 3, 1, False),
]


def _problems(row):
    name, grid, boundary, steps, batch, scen = row
    ref, port = _pair(name, grid, scen)
    kw = dict(grid=grid, boundary=boundary, steps=steps, batch=batch)
    return ref_api.StencilProblem(ref, **kw), api.StencilProblem(port, **kw)


def _input(row, seed=0):
    name, grid, boundary, steps, batch, scen = row
    shape = ((batch,) if batch > 1 else ()) + grid
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("row", PROBLEMS, ids=[p[0] for p in PROBLEMS])
def test_plan_json_round_trip(row):
    _, prob = _problems(row)
    p = api.plan(prob)
    text = p.to_json()
    q = api.ExecutionPlan.from_json(text)
    assert q.to_json() == text
    assert q.chosen() == p.chosen()
    if prob.spec.is_constant_dense:
        assert q == p
    assert "chosen:" in q.explain()


@pytest.mark.parametrize("strategy", ["operator", "inkernel"])
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("row", PROBLEMS, ids=[p[0] for p in PROBLEMS])
def test_hardware_independent_decisions_match(row, depth, strategy):
    ref_prob, prob = _problems(row)
    pins = dict(fuse=depth, fuse_strategy=strategy)
    outcomes = []
    for fn, kw in ((lambda: ref_api.plan(ref_prob, backends=["pallas"],
                                         **pins), None),
                   (lambda: api.plan(prob, backends=["cuda"], **pins), None)):
        try:
            outcomes.append(fn())
        except ValueError:
            outcomes.append(None)
    ref_p, p = outcomes
    assert (ref_p is None) == (p is None), "legality differs"
    if p is None:
        return
    for field in ("fuse_depth", "fuse_schedule", "fuse_strategy",
                  "halo_strategy", "halo_width"):
        assert getattr(p, field) == getattr(ref_p, field), field
    # the same legal covers are enumerated for the base operator
    assert {c.option for c in p.candidates if c.depth == 1} == \
        {c.option for c in ref_p.candidates if c.depth == 1}


@pytest.mark.parametrize("row", PROBLEMS, ids=[p[0] for p in PROBLEMS])
def test_compiled_plan_matches_reference_compile(row):
    ref_prob, prob = _problems(row)
    x = _input(row)
    want = ref_api.compile(ref_api.plan(ref_prob))(jnp.asarray(x))
    got = api.compile(api.plan(prob), device="cpu")(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("row", [PROBLEMS[1], PROBLEMS[3]],
                         ids=["batched", "varying+masked"])
def test_reference_problem_and_plan_carry_across(row):
    ref_prob, _ = _problems(row)
    prob = api.StencilProblem.from_dict(ref_prob.to_dict())
    d, ref_d = prob.to_dict(), ref_prob.to_dict()
    assert {k: v for k, v in d.items() if k != "spec"} == \
        {k: v for k, v in ref_d.items() if k != "spec"}
    for key in ref_d["spec"]:
        np.testing.assert_array_equal(np.asarray(d["spec"][key]),
                                      np.asarray(ref_d["spec"][key]))
    ref_plan = ref_api.plan(ref_prob)
    loaded = api.ExecutionPlan.from_json(ref_plan.to_json())
    assert loaded.backend == api.REFERENCE_BACKENDS.get(ref_plan.backend,
                                                        ref_plan.backend)
    assert loaded.fuse_schedule == ref_plan.fuse_schedule
    assert "chosen:" in loaded.explain()
    x = _input(row, seed=1)
    want = ref_api.compile(ref_plan)(jnp.asarray(x))
    got = api.compile(loaded, device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("name,grid,steps", [
    ("star2d_r2", (8192, 8192), 16), ("box2d_r3", (4096, 4096), 8),
    ("star3d_r2", (512, 512, 512), 8), ("box3d_r2", (256, 256, 256), 8),
    ("star3d_r3", (100, 120, 140), 6)])
def test_plans_only_pick_launchable_tiles(name, grid, steps):
    spec = ss.PAPER_SUITE()[name]
    for strategy in (None, "operator", "inkernel"):
        p = api.plan(api.StencilProblem(spec, grid=grid, steps=steps),
                     backends=["cuda"], fuse_strategy=strategy)
        # one residency budget (two blocks per SM) for both strategies
        for c in p.candidates:
            if c.strategy == "inkernel":
                assert mx.sweep_feasible(c.block, c.depth, spec.order,
                                         limit=mx.TILE_SMEM_BUDGET)
            else:
                assert mx.step_smem_bytes(c.block, c.depth * spec.order) \
                    <= mx.TILE_SMEM_BUDGET
        assert all(b <= g for b, g in zip(p.block, grid))


def test_mesh_waits_for_the_distributed_slice():
    """The mesh branch is ported: a mesh problem plans its local block
    and records the exchange, and the reference's pairing rule holds."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2,), ("x",), devices="cpu")
    with pytest.raises(ValueError, match="together"):
        api.StencilProblem(ss.box(2, 1), grid=(16, 16), mesh=mesh)
    prob = api.StencilProblem(ss.box(2, 1), grid=(16, 16), mesh=mesh,
                              grid_axes=("x", ""), steps=2)
    assert prob.local_grid() == (8, 16)
    p = api.plan(prob, backends=["cuda"])
    assert p.halo_strategy == "exchange"
    assert p.sharding == {"mesh_shape": [2], "mesh_axes": ["x"],
                          "grid_axes": ["x", ""]}


def test_calibration_mapping_reranks():
    prob = api.StencilProblem(ss.star(2, 1), grid=(64, 64), steps=4)
    base = api.plan(prob)
    cal = {"hw": "h100_sxm", "compute": {"cuda": 4.0}, "traffic": {}}
    p = api.plan(prob, calibration=cal)
    assert p.calibration["compute"] == {"cuda": 4.0}
    row = next(c for c in p.candidates if c.key == base.chosen().key)
    assert row.t_model == pytest.approx(base.chosen().t_model)
    assert "calibrated" in p.explain()
    with pytest.raises(TypeError):
        api.plan(prob, calibration=[("cuda", 2.0)])


def test_candidate_cost_matches_plan_table():
    prob = api.StencilProblem(ss.box(2, 1), grid=(64, 48), boundary="zero",
                              steps=6)
    p = api.plan(prob)
    for c in p.candidates[:6]:
        again = api.candidate_cost(prob, c.depth, c.option, c.backend,
                                   block=c.block, strategy=c.strategy,
                                   base_option=None)
        assert dataclasses.replace(again) == c


def test_serving_curve_helpers():
    assert api.serving_buckets(12) == ref_api.serving_buckets(12)
    prob = api.StencilProblem(ss.star(2, 1), grid=(64, 64), steps=4)
    curve = api.batch_cost_curve(prob, 8, backends=["cuda"])
    assert sorted(curve) == api.serving_buckets(8)
    assert api.max_profitable_batch(prob, 8, backends=["cuda"]) in curve


def test_compile_rejects_other_devices():
    prob = api.StencilProblem(ss.star(2, 1), grid=(16, 16), steps=2)
    run = api.compile(api.plan(prob), device="cpu")
    with pytest.raises(ValueError, match="grid"):
        run(torch.zeros(8, 8))
    with pytest.raises(ValueError, match="device"):
        run(torch.zeros(16, 16, device="meta"))
    assert planner.PLAN_VERSION == ref_api.PLAN_VERSION
