"""The port's distributed stencil path on CPU slots: a mesh plan compiled
through ``api.plan``/``api.compile`` runs the step and sweep kernels'
plain versions on every block, one deep halo exchange per fused chunk.

Each case holds the sharded run against the JAX package's oracle
``reference_evolve`` and against the port's single-device compile of the
same problem at 1e-4 (the ROADMAP's parity bar).  The exchange census is
held against the JAX package's ``ppermute`` count for the same schedule,
read from the jaxpr in a subprocess with four fake CPU devices (as the
JAX package's own multi-device tests run).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import stencil_spec as ref_ss
from repro.core import time_stepper as ref_ts

from repro_torch import api
from repro_torch.core import distributed as dist
from repro_torch.core import stencil_spec as ss
from repro_torch.core.engine import StencilEngine
from repro_torch.launch.mesh import make_mesh

torch.set_num_threads(2)

ATOL = 1e-4
_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")

# (id, suite spec, grid, batch, mesh shape, grid axes, boundary, strategy,
#  fuse depth, steps)
CASES = [
    ("2d-periodic-inkernel-2x2", "star2d_r2", (48, 32), 1, (2, 2),
     ("x", "y"), "periodic", "inkernel", 3, 7),
    ("2d-periodic-operator-4", "box2d_r1", (64, 24), 1, (4,),
     ("x", ""), "periodic", "operator", 3, 7),
    ("2d-zero-operator-4x1", "box2d_r1", (64, 32), 1, (4, 1),
     ("x", "y"), "zero", "operator", 3, 8),
    ("2d-zero-inkernel-2x2", "star2d_r1", (48, 48), 1, (2, 2),
     ("x", "y"), "zero", "inkernel", 4, 9),
    ("3d-periodic-operator-2x2", "star3d_r1", (16, 16, 12), 1, (2, 2),
     ("x", "y", ""), "periodic", "operator", 2, 5),
    ("3d-zero-inkernel-2x2", "box3d_r1", (16, 16, 12), 1, (2, 2),
     ("x", "y", ""), "zero", "inkernel", 2, 4),
    ("2d-batch3-periodic-inkernel-2x2", "star2d_r2", (32, 32), 3, (2, 2),
     ("x", "y"), "periodic", "inkernel", 2, 5),
    ("2d-batch2-zero-operator-2", "box2d_r1", (32, 32), 2, (2,),
     ("", "x"), "zero", "operator", 2, 4),
    ("2d-periodic-1x1", "box2d_r1", (32, 32), 1, (1, 1),
     ("x", "y"), "periodic", "operator", 2, 4),
]


def _state(grid, batch, seed=0):
    shape = ((batch,) if batch > 1 else ()) + tuple(grid)
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _problem(name, grid, batch, boundary, steps, mesh=None, grid_axes=None):
    return api.StencilProblem(api.PAPER_SUITE()[name], grid,
                              boundary=boundary, steps=steps, batch=batch,
                              mesh=mesh, grid_axes=grid_axes)


def _oracle(name, x, steps, boundary):
    spec = ref_ss.PAPER_SUITE()[name]
    return np.asarray(ref_ts.reference_evolve(spec, jnp.asarray(x), steps,
                                              boundary))


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "serial"])
@pytest.mark.parametrize(
    "case", CASES, ids=[c[0] for c in CASES])
def test_sharded_run_matches_oracle_and_single_device(case, overlap):
    _, name, grid, batch, mshape, gaxes, boundary, strategy, fuse, steps = \
        case
    mesh = make_mesh(mshape, ("x", "y")[:len(mshape)], devices="cpu")
    prob = _problem(name, grid, batch, boundary, steps, mesh, gaxes)
    p = api.plan(prob, backends=["cuda"], fuse=fuse, fuse_strategy=strategy)
    assert p.halo_strategy == "exchange"
    assert p.fuse_strategy == strategy
    run = api.compile(p, mesh=mesh, overlap=overlap)
    x = _state(grid, batch)
    xt = torch.from_numpy(x)
    dist.reset_exchange_counts()
    y = run(xt)
    assert y.shape == xt.shape and y.dtype == xt.dtype
    named = sum(1 for a in gaxes if a)
    assert dist.exchange_counts["exchanges"] == \
        len(p.fuse_schedule) * named
    np.testing.assert_allclose(y.numpy(), _oracle(name, x, steps, boundary),
                               atol=ATOL)
    # the same plan on one device (the decisions of the sharded plan)
    single = api.compile(api.plan(_problem(name, grid, batch, boundary,
                                           steps),
                                  backends=["cuda"], fuse=fuse,
                                  fuse_strategy=strategy, block=p.block),
                         device="cpu")
    torch.testing.assert_close(y, single(xt), atol=ATOL, rtol=0)
    # a ShardedState goes in and comes out on the mesh
    st = dist.shard(xt, mesh, gaxes)
    out = run(st)
    assert isinstance(out, dist.ShardedState) and out.mesh is mesh
    assert torch.equal(dist.unshard(out), y)


def test_local_extent_below_fused_halo_raises():
    spec = ss.box(2, 1, seed=0)
    mesh = make_mesh((4,), ("x",), devices="cpu")
    st = dist.shard(torch.zeros(16, 16), mesh, ("x", ""))
    eng = StencilEngine(spec, backend="torch", device="cpu")
    with pytest.raises(ValueError, match="fused halo"):
        dist.distributed_fused_chunk(st, t=5, base_core=eng._core,
                                     fused_core=eng._core, spec=spec)
    # the planner caps the depth by the LOCAL block, not the grid
    prob = api.StencilProblem(spec, (16, 16), boundary="periodic", steps=8,
                              mesh=mesh, grid_axes=("x", ""))
    with pytest.raises(ValueError, match="exceeds"):
        api.plan(prob, fuse=5)
    assert api.plan(prob, fuse=4).fuse_depth == 4


@pytest.mark.parametrize("periodic", [True, False])
def test_halo_exchange_equals_the_global_pad(periodic):
    """Every haloed block is the matching window of the globally padded
    state: corners arrive through the axis order, a size-1 axis
    exchanges with itself, an unsharded axis pads locally."""
    from repro_torch.core import halo
    x = torch.from_numpy(_state((12, 10, 8), 1))
    mesh = make_mesh((3, 1), ("x", "y"), devices="cpu")
    st = dist.shard(x, mesh, ("x", "y", ""))
    r = 2
    hal = dist.halo_exchange(st, r, periodic=periodic)
    padded = halo.pad_halo(x, r, 3, "periodic" if periodic else "zero")
    for c in np.ndindex(mesh.shape):
        lo = c[0] * 4
        want = padded[lo:lo + 4 + 2 * r]
        assert torch.equal(hal.blocks[c], want), c


@pytest.mark.parametrize("periodic", [True, False])
def test_per_step_stepper_matches_oracle(periodic):
    """``make_distributed_stepper``: one width-r exchange a step (the
    reference's simple per-step API), on an unsharded second axis."""
    x = _state((24, 20), 1, seed=2)
    mesh = make_mesh((3,), ("x",), devices="cpu")
    step = dist.make_distributed_stepper(api.PAPER_SUITE()["box2d_r1"], mesh,
                                         ("x", ""), backend="cuda",
                                         periodic=periodic, steps=3)
    assert step.schedule == (1, 1, 1)
    got = step(torch.from_numpy(x)).numpy()
    want = _oracle("box2d_r1", x, 3, "periodic" if periodic else "zero")
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_shard_unshard_round_trip_and_replicas():
    x = torch.from_numpy(_state((8, 6), 1, seed=3))
    mesh = make_mesh((2, 2), ("x", "y"), devices="cpu")
    st = dist.shard(x, mesh, ("x", ""), batch=False)
    assert st.shape == (8, 6) and st.local_shape == (4, 6)
    # mesh axis y names no grid axis: its blocks are replicas
    assert torch.equal(st.blocks[0, 0], st.blocks[0, 1])
    assert len(list(st.unique_blocks())) == 2
    assert torch.equal(dist.unshard(st), x)
    moved = st.to("cpu")
    assert moved.mesh.shape == (2, 2) and list(moved.mesh.slots.flat) == \
        [0, 1, 2, 3]
    assert torch.equal(dist.unshard(moved), x)
    small = make_mesh((2, 1), ("x", "y"), devices="cpu")
    back = dist.reshard(dist.shard(x, mesh, ("x", "y")), small)
    assert back.mesh is small and back.local_shape == (4, 6)
    assert torch.equal(dist.unshard(back), x)
    with pytest.raises(ValueError, match="divisible"):
        dist.shard(torch.zeros(7, 6), mesh, ("x", ""))


_CENSUS = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.core import stencil_spec as ss
from repro.core.distributed import make_fused_distributed_stepper
from repro.launch.mesh import make_mesh
out = []
for shape, gaxes, grid, sched, boundary, batch in CASES:
    mesh = make_mesh(shape, ("x", "y")[:len(shape)])
    step = make_fused_distributed_stepper(
        ss.box(len(grid), 1, seed=0), mesh, gaxes, schedule=sched,
        backend="jnp", boundary=boundary, batch=batch)
    lead = (batch,) if batch else ()
    x = jnp.zeros(lead + tuple(grid), jnp.float32)
    n = str(jax.make_jaxpr(step.global_fn)(x)).count("ppermute")
    out.append(n / len(sched))
print(json.dumps(out))
"""

CENSUS_CASES = [((4,), ("x", ""), (32, 16), (3, 3, 1), "periodic", None),
                ((2, 2), ("x", "y"), (32, 16), (2, 2), "zero", None),
                ((4, 1), ("x", "y"), (32, 16), (4, 2), "periodic", None),
                ((2, 2), ("x", "y", ""), (16, 16, 8), (2, 1), "periodic",
                 None),
                ((2, 2), ("x", "y"), (16, 16), (2, 2), "periodic", 3)]


def test_exchange_census_equals_reference_ppermutes():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = _SRC
    env["JAX_PLATFORMS"] = "cpu"
    body = f"CASES = {CENSUS_CASES!r}\n" + textwrap.dedent(_CENSUS)
    proc = subprocess.run([sys.executable, "-c", body], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    got = []
    for shape, gaxes, grid, sched, boundary, batch in CENSUS_CASES:
        mesh = make_mesh(shape, ("x", "y")[:len(shape)], devices="cpu")
        step = dist.make_fused_distributed_stepper(
            ss.box(len(grid), 1, seed=0), mesh, gaxes, schedule=sched,
            backend="torch", boundary=boundary, batch=batch)
        lead = (batch,) if batch else ()
        dist.reset_exchange_counts()
        step(torch.zeros(lead + tuple(grid)))
        got.append(dist.exchange_counts["permutes"] / len(sched))
        assert dist.exchange_counts["exchanges"] == \
            len(sched) * sum(1 for a in gaxes if a)
    assert got == ref, (got, ref)
