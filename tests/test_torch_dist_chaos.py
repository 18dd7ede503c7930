"""Distributed chaos in the port: the ``dist.*`` fault sites, shard
checkpoints and reshard-on-failure recovery, on meshes of CPU slots.

The JAX package runs these scenarios on fake CPU devices in subprocesses
(``tests/test_dist_chaos.py``); the port's single-controller mesh needs
no devices, so the same scenarios run in-process on slots that all name
the CPU.  The exhaustive site x action x seed x mesh-shape matrix is
``slow`` as the reference's is.  Sharded checkpoints cross between the
packages both ways (the JAX side writes its mesh-sharded checkpoint in a
subprocess with four fake devices).
"""
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.checkpoint import checkpointer as ref_ck

from repro_torch import api
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.core import distributed as dist
from repro_torch.core.plan_cache import cache_key
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve_stencil import StencilServer
from repro_torch.rollout.executor import (compile_program, run_checkpointed,
                                          shrink_mesh)
from repro_torch.rollout.program import RolloutProgram, Segment, UpdateOp
from repro_torch.runtime import chaos
from repro_torch.runtime.fault_tolerance import RestartPolicy

torch.set_num_threads(2)

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")

# a 3-segment mesh-sharded rollout program on a 24x24 grid (divisible by
# every 1-axis mesh of the ladder)
SPEC = api.box(2, 1, seed=0)
GRID = (24, 24)
X = torch.from_numpy(np.random.default_rng(0).normal(size=GRID)
                     .astype(np.float32))


def _mesh(shape):
    return make_mesh(shape, ("gx", "gy")[:len(shape)], devices="cpu")


def program(mesh, grid_axes=("gx", "")):
    prob = api.StencilProblem(SPEC, GRID, boundary="periodic", steps=1,
                              mesh=mesh, grid_axes=grid_axes)
    return RolloutProgram(prob, [
        Segment(2, emit=True),
        Segment(2, UpdateOp("scale", {"factor": 0.5}), emit=True),
        Segment(2, emit=True)])


def _compile(mesh, grid_axes=("gx", "")):
    return compile_program(program(mesh, grid_axes), backends=["cuda"],
                           device="cpu")


def bitsame(a, b):
    return torch.equal(a, b)


def test_dist_sites_fire_raise_and_corrupt():
    """The host-side wrapper fires dist.chunk / dist.exchange /
    dist.device; "raise" raises a FaultError carrying the site, "corrupt"
    computes through a poisoned copy then raises (the result is
    discarded), and an ACTIVE-but-idle plan leaves results
    bit-identical."""
    mesh = _mesh((4,))
    prob = api.StencilProblem(SPEC, GRID, boundary="periodic", steps=4,
                              mesh=mesh, grid_axes=("gx", ""))
    run = api.compile(api.plan(prob, fuse=2, backends=["cuda"]), mesh=mesh)
    y0 = run(X)
    plan = chaos.FaultPlan(seed=3).rule("dist.chunk", at=(1,))
    with pytest.raises(chaos.FaultError) as e:
        with plan:
            run(X)
    assert e.value.site == "dist.chunk"
    assert plan.fired("dist.chunk") == 1
    site, idx, action, ctx = plan.log[0]
    assert ctx["devices"] == 4 and ctx["mesh"] == "4", ctx
    plan2 = chaos.FaultPlan(seed=3).rule("dist.exchange", at=(0,),
                                         action="corrupt")
    with pytest.raises(chaos.FaultError, match="checksum"):
        with plan2:
            run(X)
    with chaos.FaultPlan(seed=1).rule("dist.device", rate=0.0):
        y1 = run(X)
    assert bitsame(y0, y1), "idle plan changed bits"
    assert bitsame(y0, run(X)), "post-fault call dirty"


def test_exchange_census_unchanged_by_chaos_wrapper():
    """The chaos wrapper is host-side only: a call's exchange census is
    identical with and without an active plan, and matches chunks x
    sharded axes (x 2 permutes)."""
    mesh = _mesh((4,))
    prob = api.StencilProblem(SPEC, GRID, boundary="periodic", steps=4,
                              mesh=mesh, grid_axes=("gx", ""))
    run = api.compile(api.plan(prob, fuse=2, backends=["cuda"]), mesh=mesh)
    dist.reset_exchange_counts()
    run(X)
    n0 = dict(dist.exchange_counts)
    dist.reset_exchange_counts()
    with chaos.FaultPlan(seed=9).rule("dist.chunk", rate=1.0, times=0):
        run(X)
    assert dict(dist.exchange_counts) == n0
    assert n0["permutes"] == 2 * 1 * 2, n0   # 2 chunks x 1 axis x 2 dirs
    assert n0["exchanges"] == 2 and n0["strips"] == 2 * 4 * 2


def test_reshard_recovery_bit_exact(tmp_path):
    """A dist.exchange fault storm exhausts segment 1's retry budget
    mid-rollout, the executor reshards 4 -> 2 slots from the shard
    checkpoint, and every emit plus the final state is BIT-exact vs the
    fault-free 4-slot run; the post-reshard checkpoint carries the
    2-shard layout."""
    ref4 = run_checkpointed(_compile(_mesh((4,))), X)
    ref2 = run_checkpointed(_compile(_mesh((2,))), X)
    for (_, a), (_, b) in zip(ref4.emits, ref2.emits):
        assert bitsame(a, b), "4-slot and 2-slot disagree fault-free"
    d = str(tmp_path)
    c4 = _compile(_mesh((4,)))
    plan = chaos.FaultPlan(seed=5).rule("dist.exchange", at=(1, 2, 3),
                                        match={"chunk": 0})
    with plan:
        res = run_checkpointed(
            c4, X, directory=d,
            restart=RestartPolicy(max_failures=2, backoff_s=0.0))
    assert plan.fired("dist.exchange") == 3
    assert res.attempts == (1, 4, 1), res.attempts
    assert res.recovered == (0, 1, 0), res.recovered
    assert res.resharded == 1, res.resharded
    for (sa, a), (sb, b) in zip(res.emits, ref4.emits):
        assert sa == sb and bitsame(a, b), "reshard broke bit-exactness"
    assert bitsame(res.final, ref4.final)
    last = sorted(glob.glob(os.path.join(d, "step_*")))[-1]
    shards = sorted(os.path.basename(p)
                    for p in glob.glob(os.path.join(last, "shard_*")))
    assert shards == ["shard_0.npz", "shard_1.npz"], shards
    assert shrink_mesh(shrink_mesh(_mesh((4,)))).shape == (1,)


def test_torn_shard_write_falls_back_to_previous_checkpoint(tmp_path):
    """A torn single-SHARD write (file truncated, manifest + rename
    completed) is caught by the per-shard manifest digest: restoring the
    torn step raises, and a resume falls back to the newest intact
    checkpoint and recomputes — bit-exact."""
    mesh = _mesh((4,))
    ref = run_checkpointed(_compile(mesh), X)
    d = str(tmp_path)
    # corrupt the SECOND checkpoint write (segment 1's, step 4): with a
    # sharded tree the chaos hook truncates the highest-named shard
    plan = chaos.FaultPlan(seed=0).rule("checkpoint.write", at=(1,),
                                        action="corrupt")
    with plan:
        mid = run_checkpointed(_compile(mesh), X, directory=d)
    assert bitsame(mid.final, ref.final)
    assert ck.retained_steps(d) == [2, 4, 6]
    with pytest.raises(ValueError, match="digest"):
        ck.restore_checkpoint(d, 4, {"state": X})
    # resume=True walks newest-first: step 6 is intact, so a fresh run
    # restores it and returns immediately with the same final state
    res = run_checkpointed(_compile(mesh), X, directory=d)
    assert bitsame(res.final, ref.final)
    assert res.attempts == (0, 0, 0), res.attempts


def test_cache_key_includes_mesh_shape():
    """A reshard is a different executable: problems differing only in
    mesh shape get different cache keys (and both differ from the
    unsharded problem)."""
    def key(mesh):
        kw = {} if mesh is None else {"mesh": mesh, "grid_axes": ("gx", "")}
        return cache_key(api.StencilProblem(SPEC, GRID, boundary="periodic",
                                            steps=4, **kw))
    k4, k2, k0 = key(_mesh((4,))), key(_mesh((2,))), key(None)
    assert len({k4, k2, k0}) == 3, (k4, k2, k0)
    assert key(_mesh((4,))) == k4


def test_server_eviction_shrinks_group_mesh():
    """The serving mirror: under mesh serving an evicted slot SHRINKS the
    shape group's mesh over the survivors (counted in
    stats()["faults"]["mesh_shrinks"]) instead of remapping, and the
    shrunk-mesh results stay bit-exact vs the healthy mesh run (both
    meshes plan the ``torch`` backend, the counterpart of the reference's
    ``jnp`` pin).  Every slot names the CPU: slots are told apart by
    index, so one eviction takes out one slot."""
    states = [torch.from_numpy(np.random.default_rng(s).normal(size=GRID)
                               .astype(np.float32)) for s in range(3)]
    healthy = StencilServer(SPEC, steps=4, backends=["torch"], max_batch=1,
                            devices=["cpu"] * 4, mesh_shape=(4,))
    base = healthy.serve(states)
    assert healthy.stats()["meshes"] == {"24x24": "4"}
    srv = StencilServer(SPEC, steps=4, backends=["torch"], max_batch=1,
                        devices=["cpu"] * 4, mesh_shape=(4,), evict_after=3)
    plan = chaos.FaultPlan(seed=0).rule("serve.settle", at=(0, 1, 2))
    with plan:
        out = srv.serve(states)
    st = srv.stats()
    assert st["faults"]["evictions"] == 1, st["faults"]
    assert st["faults"]["mesh_shrinks"] == 1, st["faults"]
    assert st["meshes"] == {"24x24": "2"}, st["meshes"]
    assert [row["evicted"] for row in st["devices"]].count(True) == 1
    for a, b in zip(base, out):
        assert bitsame(a, b), "shrunk-mesh serving broke bit-exactness"
    # rollout serving on the mesh books the executor-mirror counters
    t = srv.submit_rollout(states[0], [(2, None, True), (2, None, False)])
    srv.flush()[t]
    st = srv.stats()
    assert st["faults"]["rollout_attempts"] == 2, st["faults"]
    assert st["faults"]["rollout_recovered"] == 0, st["faults"]


@pytest.mark.slow
@pytest.mark.parametrize("mesh_shape,grid_axes", [
    ((4,), ("gx", "")),
    ((2, 2), ("gx", "gy")),
])
def test_dist_fault_matrix(mesh_shape, grid_axes):
    """Exhaustive seeded matrix per mesh shape: site x action x seed,
    random-rate rules.  Every cell must (a) recover within the retry +
    reshard ladder, (b) be deterministic — the same plan seed reproduces
    the identical fire log and identical result bytes — and (c)
    round-trip through FaultPlan.replay()."""
    ref = run_checkpointed(_compile(_mesh(mesh_shape), grid_axes), X)

    def cell(site, action, seed):
        plan = chaos.FaultPlan(seed=seed).rule(site, rate=0.3, times=3,
                                               action=action)
        with plan:
            res = run_checkpointed(
                _compile(_mesh(mesh_shape), grid_axes), X,
                restart=RestartPolicy(max_failures=2, backoff_s=0.0))
        return plan, res

    for site in ("dist.exchange", "dist.chunk", "dist.device"):
        for action in ("raise", "corrupt"):
            for seed in (0, 1):
                p1, r1 = cell(site, action, seed)
                p2, r2 = cell(site, action, seed)
                assert p1.log == p2.log, (site, action, seed)
                assert bitsame(r1.final, r2.final), (site, action, seed)
                assert r1.attempts == r2.attempts and \
                    r1.resharded == r2.resharded, (site, action, seed)
                rp = p1.replay()
                with rp:
                    r3 = run_checkpointed(
                        _compile(_mesh(mesh_shape), grid_axes), X,
                        restart=RestartPolicy(max_failures=2, backoff_s=0.0))
                assert rp.log == p1.log, (site, action, seed)
                assert bitsame(r3.final, r1.final), (site, action, seed)
                if r1.resharded == 0:
                    assert bitsame(r1.final, ref.final), (site, action, seed)


_REF_WRITE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint.checkpointer import save_checkpoint
from repro.launch.mesh import make_mesh
mesh = make_mesh((2, 2), ("gx", "gy"))
x = np.arange(8 * 6 * 4, dtype=np.float32).reshape(8, 6, 4)
arr = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("gx", "gy")))
save_checkpoint(DIR, 7, {"state": arr, "emits": {"00000002": arr * 2}},
                extra={"program": "p", "segment": 1})
"""


def test_reference_sharded_checkpoint_restores_onto_a_port_mesh(tmp_path):
    """A checkpoint the JAX package writes from a 2x2 mesh (four fake
    devices) restores here onto a mesh of another shape, bit-exact."""
    d = str(tmp_path)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = _SRC
    env["JAX_PLATFORMS"] = "cpu"
    body = f"DIR = {d!r}\n" + textwrap.dedent(_REF_WRITE)
    proc = subprocess.run([sys.executable, "-c", body], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(glob.glob(os.path.join(d, "step_00000007", "shard_*"))) == 4
    x = np.arange(8 * 6 * 4, dtype=np.float32).reshape(8, 6, 4)
    mesh = make_mesh((4,), ("gx",), devices="cpu")
    target = {"state": torch.zeros(()), "emits": {"00000002": torch.zeros(())}}
    got, extra = ck.restore_checkpoint(
        d, 7, target, shardings=dist.MeshSharding(mesh, ("gx", "", "")))
    assert extra == {"program": "p", "segment": 1}
    assert got["state"].mesh is mesh and got["state"].local_shape == (2, 6, 4)
    np.testing.assert_array_equal(dist.unshard(got["state"]).numpy(), x)
    np.testing.assert_array_equal(
        dist.unshard(got["emits"]["00000002"]).numpy(), 2 * x)


def test_port_sharded_checkpoint_restores_in_reference(tmp_path):
    """The reverse: the port writes a 2x2-sharded state as one shard file
    per slot with each block's global index; the JAX package's restore
    reassembles it bit-exact."""
    d = str(tmp_path)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 8, 6))
                         .astype(np.float32))
    st = dist.shard(x, make_mesh((2, 2), ("gx", "gy"), devices="cpu"),
                    ("gx", "gy"))
    ck.save_checkpoint(d, 3, {"state": st, "n": torch.tensor(5)},
                       extra={"k": 1})
    files = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(d, "step_00000003", "*.npz")))
    assert files == ["shard_0.npz", "shard_1.npz", "shard_2.npz",
                     "shard_3.npz", "shard_full.npz"]
    manifest = ck.read_manifest(d, 3)
    entry = next(e for e in manifest["leaves"] if e["key"] == "state")
    assert entry["mesh"] == {"shape": [2, 2], "axes": ["gx", "gy"],
                             "grid_axes": ["gx", "gy"]}
    got, extra = ref_ck.restore_checkpoint(
        d, 3, {"state": jnp.zeros(()), "n": jnp.zeros((), jnp.int32)})
    assert extra == {"k": 1}
    np.testing.assert_array_equal(np.asarray(got["state"]), x.numpy())
    assert int(got["n"]) == 5
