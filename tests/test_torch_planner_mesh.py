"""The port's planner on a mesh against the JAX package's: everything
decided without hardware agrees — the fuse schedule at a pinned depth,
the halo strategy and width, the ``sharding`` record, the local block the
depth is capped by — and both reject the same malformed problems.

The reference planner reads only a mesh's axis names and shape, so it
gets a stand-in with those two (no JAX devices are needed to plan).
"""
import types

import numpy as np
import pytest
import torch

from repro import api as ref_api

from repro_torch import api
from repro_torch.launch.mesh import make_mesh

torch.set_num_threads(2)


def _ref_mesh(shape, axes):
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 devices=np.empty(shape, dtype=object))


# (suite spec, grid, mesh shape, grid axes, boundary, steps, fuse, batch)
CASES = [
    ("star2d_r2", (64, 48), (2, 2), ("x", "y"), "periodic", 7, 3, 1),
    ("box2d_r1", (64, 32), (4, 1), ("x", "y"), "zero", 8, 3, 1),
    ("star3d_r1", (16, 16, 12), (2, 2), ("x", "y", ""), "periodic", 5, 2, 1),
    ("box2d_r2", (48, 48), (4,), ("", "x"), "zero", 9, 2, 2),
    ("star2d_r1", (32, 32), (1, 1), ("x", "y"), "periodic", 4, 4, 1),
]


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{c[4]}-"
                                             + "x".join(map(str, c[2]))
                                             for c in CASES])
def test_mesh_decisions_match_reference(case):
    name, grid, shape, gaxes, boundary, steps, fuse, batch = case
    axes = ("x", "y")[:len(shape)]
    mesh = make_mesh(shape, axes, devices="cpu")
    prob = api.StencilProblem(api.PAPER_SUITE()[name], grid,
                              boundary=boundary, steps=steps, batch=batch,
                              mesh=mesh, grid_axes=gaxes)
    ref = ref_api.StencilProblem(ref_api.PAPER_SUITE()[name], grid,
                                 boundary=boundary, steps=steps, batch=batch,
                                 mesh=_ref_mesh(shape, axes),
                                 grid_axes=gaxes)
    assert prob.local_grid() == ref.local_grid()
    assert prob.mesh_axis_sizes() == ref.mesh_axis_sizes()
    p = api.plan(prob, fuse=fuse)
    rp = ref_api.plan(ref, fuse=fuse)
    assert p.fuse_schedule == rp.fuse_schedule
    assert p.fuse_depth == rp.fuse_depth
    assert p.halo_strategy == rp.halo_strategy == "exchange"
    assert p.halo_width == rp.halo_width
    assert p.sharding == rp.sharding
    assert f"mesh={'x'.join(map(str, shape))}(" in p.explain()
    # the link term prices the sharded axes only: none on a 1x1 mesh
    ch = p.chosen()
    sharded = [i for i, a in enumerate(gaxes)
               if a and dict(zip(axes, shape))[a] > 1]
    assert (ch.t_comm > 0) == bool(sharded)
    local = prob.local_grid()
    want = sum(2 * ch.depth * prob.spec.order
               * np.prod([g for i, g in enumerate(local) if i != a])
               * prob.dtype_bytes * batch for a in sharded)
    assert ch.ici_bytes == pytest.approx(want)


def test_mesh_depth_cap_matches_reference():
    mesh = make_mesh((4,), ("x",), devices="cpu")
    prob = api.StencilProblem(api.box(2, 1), (16, 64), boundary="periodic",
                              steps=8, mesh=mesh, grid_axes=("x", ""))
    ref = ref_api.StencilProblem(ref_api.box(2, 1), (16, 64),
                                 boundary="periodic", steps=8,
                                 mesh=_ref_mesh((4,), ("x",)),
                                 grid_axes=("x", ""))
    for fuse in (4, 5):
        got = _outcome(lambda: api.plan(prob, fuse=fuse).fuse_schedule)
        want = _outcome(lambda: ref_api.plan(ref, fuse=fuse).fuse_schedule)
        assert got == want


def _outcome(fn):
    try:
        return fn()
    except ValueError:
        return ValueError


def _bad_problems(pkg, mesh_of):
    m2 = mesh_of((2,), ("x",))
    field = np.ones((16, 16), np.float32)
    return [
        # mesh and grid_axes must come together
        lambda: pkg.StencilProblem(pkg.box(2, 1), (16, 16), mesh=m2),
        lambda: pkg.StencilProblem(pkg.box(2, 1), (16, 16),
                                   grid_axes=("x", "")),
        # constant dense specs only
        lambda: pkg.StencilProblem(pkg.box(2, 1).with_field(field), (16, 16),
                                   mesh=m2, grid_axes=("x", "")),
        # one axis name per spatial axis
        lambda: pkg.StencilProblem(pkg.box(2, 1), (16, 16), mesh=m2,
                                   grid_axes=("x",)),
        # no valid boundary
        lambda: pkg.StencilProblem(pkg.box(2, 1), (16, 16), mesh=m2,
                                   grid_axes=("x", ""), boundary="valid"),
        # divisibility
        lambda: pkg.StencilProblem(pkg.box(2, 1), (15, 16), mesh=m2,
                                   grid_axes=("x", "")).local_grid(),
    ]


def test_mesh_problem_errors_match_reference():
    ours = _bad_problems(api, lambda s, a: make_mesh(s, a, devices="cpu"))
    theirs = _bad_problems(ref_api, _ref_mesh)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        with pytest.raises(ValueError):
            a()
        with pytest.raises(ValueError):
            b()


def test_compile_checks_the_mesh_against_the_plan():
    mesh = make_mesh((2, 2), ("x", "y"), devices="cpu")
    prob = api.StencilProblem(api.star(2, 1), (32, 32), steps=4,
                              mesh=mesh, grid_axes=("x", "y"))
    p = api.plan(prob, backends=["torch"])
    with pytest.raises(ValueError, match="does not match"):
        api.compile(p, mesh=make_mesh((4, 1), ("x", "y"), devices="cpu"))
    with pytest.raises(ValueError, match="does not match"):
        api.compile(p, mesh=make_mesh((2, 2), ("a", "b"), devices="cpu"))
    # no mesh: the recorded shape is rebuilt with every slot on `device`
    run = api.compile(p, device="cpu")
    assert run.stepper.mesh.shape == (2, 2)
    assert {str(d) for d in run.stepper.mesh.devices.flat} == {"cpu"}
    # the plan round-trips through JSON with its sharding
    q = api.ExecutionPlan.from_json(p.to_json())
    assert q.sharding == p.sharding and q.to_json() == p.to_json()
    # input-shape errors as on one device, plus the exact rank
    with pytest.raises(ValueError, match="spatial shape"):
        run(torch.zeros(16, 32))
    with pytest.raises(ValueError, match="without a batch axis"):
        run(torch.zeros(2, 32, 32))
