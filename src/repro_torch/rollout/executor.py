"""Compiled rollout execution: streaming, checkpointed, restartable.

:func:`compile_program` lowers a :class:`~repro_torch.rollout.planning
.RolloutPlan` into a :class:`CompiledRollout`: one compiled fused sweep
per DISTINCT segment plan (segments sharing a plan share the executable)
plus one update fn per distinct (op, shape).  The update runs as its own
pointwise pass AFTER the segment's fused sweep — it is a fusion barrier
by construction, so the sweep executable is exactly the single-sweep
path's and inherits its exactness guarantees; streaming an emit point
costs nothing extra (the post-update state is already materialized).

:func:`run_checkpointed` drives it with segment-boundary checkpoints
through :class:`~repro_torch.checkpoint.checkpointer.CheckpointManager`
(atomic rename, ``keep_last`` retention), resume-from-latest that is
BIT-exact vs an uninterrupted run (float32 states round-trip ``.npz``
exactly, and re-running a segment from its checkpointed start state is
deterministic), and per-segment :class:`~repro_torch.runtime
.fault_tolerance.HeartbeatMonitor` / :class:`~repro_torch.runtime
.fault_tolerance.RestartPolicy` guards: a failed or timed-out segment
re-runs from its start state after bounded backoff.

The port's counterpart of the JAX package's ``rollout/executor.py``.
PyTorch runs eagerly, so there is no ``jit`` wrapper: the output of
:func:`repro_torch.core.planner.compile_plan` is already the executable.

Mesh-sharded programs (the problem carries a ``mesh``) compile each
segment to the fused distributed stepper and keep the state as a
:class:`~repro_torch.core.distributed.ShardedState` between segments;
an update op runs on the gathered global state (one gather and one
re-shard a segment that has one).  :func:`run_checkpointed` writes
shard checkpoints and, when a ``dist.*`` fault exhausts a segment's
retries, reshards onto :func:`shrink_mesh`'s smaller mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import (CheckpointManager,
                                                 read_manifest,
                                                 restore_checkpoint)
from repro_torch.core import distributed as dist
from repro_torch.core.engine import resolve_device
from repro_torch.core.planner import compile_plan
from repro_torch.launch.mesh import DeviceMesh, shrunk_shape
from repro_torch.rollout.planning import RolloutPlan, plan_program
from repro_torch.rollout.program import (RolloutProgram, build_update,
                                         segment_out_grid)
from repro_torch.runtime import chaos
from repro_torch.runtime.chaos import FaultError
from repro_torch.runtime.fault_tolerance import supervised

__all__ = ["CompiledRollout", "RolloutResult", "compile_program",
           "run_checkpointed", "shrink_mesh"]


@dataclasses.dataclass(frozen=True)
class RolloutResult:
    """Final state plus every emitted intermediate, in program order.

    ``emits`` pairs each emitting segment's CUMULATIVE step count with
    its post-update state.

    ``attempts[i]`` counts how many times segment ``i`` was DISPATCHED
    (1 = clean first try; 0 = skipped by a checkpoint resume),
    ``recovered[i]`` flags segments whose surviving state came from a
    retry (attempt > 1), and ``resharded`` counts mesh shrinks a
    ``dist.*`` fault storm forced.
    """

    final: Any
    emits: tuple[tuple[int, Any], ...] = ()
    attempts: tuple[int, ...] = ()
    recovered: tuple[int, ...] = ()
    resharded: int = 0

    def emit_dict(self) -> dict[int, Any]:
        return dict(self.emits)


@dataclasses.dataclass
class CompiledRollout:
    """Executable form of one rollout program on one device or a mesh.

    ``run(x)`` drives the whole program; :meth:`stream` yields after
    every segment (the serving loop's drain unit); :meth:`run_segment`
    is one segment's sweep+update — the retry unit
    :func:`run_checkpointed` guards.  On a mesh the segments pass a
    ``ShardedState`` along; ``run`` shards a global tensor first and
    gathers the results back onto its device.
    """

    plan: RolloutPlan
    program: RolloutProgram
    sweeps: tuple[Callable, ...]          # one compiled fused sweep a segment
    updates: tuple[Callable | None, ...]  # pointwise update or None
    device: torch.device                  # where states live and restore
    mesh: DeviceMesh | None = None        # the live mesh of a sharded program

    def run_segment(self, i: int, x):
        """Advance one segment: fused sweep, then the update op."""
        y = self.sweeps[i](x)
        up = self.updates[i]
        if up is not None:
            if isinstance(y, dist.ShardedState):
                y = dist.shard(up(dist.unshard(y)), y.mesh, y.grid_axes,
                               y.batch)
            else:
                y = up(y)
            chaos.fire("rollout.update", segment=int(i))
        return y

    def stream(self, x, start_segment: int = 0):
        """Yield ``(segment index, cumulative step, state)`` after every
        segment — emit filtering is the caller's (states stream without
        re-entering the fused sweep)."""
        segs = self.program.segments
        t = sum(s.steps for s in segs[:start_segment])
        for i in range(start_segment, len(segs)):
            x = self.run_segment(i, x)
            t += segs[i].steps
            yield i, t, x

    def run(self, x, start_segment: int = 0) -> RolloutResult:
        home = None
        sharding = _state_sharding(self)
        if sharding is not None and isinstance(x, torch.Tensor):
            home = x.device
            x = sharding.place(x)
        emits = []
        for i, t, x in self.stream(x, start_segment):
            if self.program.segments[i].emit:
                emits.append((t, x))
        if home is not None:
            return RolloutResult(
                final=dist.unshard(x, home),
                emits=tuple((t, dist.unshard(a, home)) for t, a in emits))
        return RolloutResult(final=x, emits=tuple(emits))

    def __call__(self, x) -> RolloutResult:
        return self.run(x)


def compile_program(rplan: RolloutPlan | RolloutProgram, *,
                    device="cuda", hw=None, mesh=None,
                    **plan_kwargs) -> CompiledRollout:
    """Materialize a rollout plan (planning first if given a program) on
    ``device`` — the card unless the caller asks for ``"cpu"``; without a
    card the default raises.

    Distinct segments sharing an identical plan share ONE compiled sweep;
    updates dedupe by (op identity, output shape).  The per-segment sweep
    is exactly the single-sweep ``compile_plan`` executable, so everything
    proven about fused sweeps (bit-exactness per strategy, boundary
    handling) holds per segment.

    Mesh-sharded programs (the problem carries a ``mesh``, or the plan's
    segments record a ``sharding``) compile each segment to the fused
    distributed stepper — one ``t*r``-deep exchange per fused chunk,
    exactly the single-sweep executable again.  ``mesh`` binds the live
    mesh (default: the program's own, else rebuilt from the recorded
    shape on ``device``, as in ``compile_plan``); it never enters the
    plan or the program digest.
    """
    dev = resolve_device(device)
    if isinstance(rplan, RolloutProgram):
        if mesh is None:
            mesh = rplan.problem.mesh
        rplan = plan_program(rplan, hw, **plan_kwargs)
    program = rplan.program_obj()
    sweep_by_plan: dict[str, Callable] = {}
    update_by_key: dict[tuple, Callable] = {}
    sweeps, updates = [], []
    for i, seg in enumerate(program.segments):
        p = rplan.segment_plans[i]
        pj = p.to_json()
        fn = sweep_by_plan.get(pj)
        if fn is None:
            cp = compile_plan(p, mesh=mesh, device=dev)
            if p.sharding is not None and mesh is None:
                mesh = cp.stepper.mesh
            fn = sweep_by_plan[pj] = cp.fn
        sweeps.append(fn)
        if seg.update is None:
            updates.append(None)
            continue
        pb = program.segment_problem(i)
        out_grid = segment_out_grid(pb)
        ukey = (seg.update.update_id, out_grid)
        ufn = update_by_key.get(ukey)
        if ufn is None:
            ufn = update_by_key[ukey] = build_update(seg.update, pb, out_grid)
        updates.append(ufn)
    sharded = any(p.sharding is not None for p in rplan.segment_plans)
    return CompiledRollout(plan=rplan, program=program,
                           sweeps=tuple(sweeps), updates=tuple(updates),
                           device=dev, mesh=mesh if sharded else None)


# ---------------------------------------------------------------------------
# Reshard-on-failure: shrink the mesh, keep the plan
# ---------------------------------------------------------------------------

def _is_dist_fault(err: BaseException | None) -> bool:
    """Did this failure originate at a ``dist.*`` chaos site (an injected
    mesh fault — the class of error a smaller mesh survives)?"""
    while err is not None:
        if isinstance(err, FaultError) and err.site.startswith("dist."):
            return True
        err = err.__cause__
    return False


def shrink_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The next-smaller mesh after losing slots (:func:`repro_torch.launch
    .mesh.shrunk_shape`: same axis names, same GLOBAL grid — local blocks
    double), keeping the leading slots of the old mesh (their devices and
    slot ids).  Raises when the mesh is already 1x...x1."""
    shape = shrunk_shape(mesh.shape)
    if shape is None:
        raise ValueError(f"mesh {mesh.shape} cannot shrink further")
    n = int(np.prod(shape))
    return DeviceMesh(mesh.devices.reshape(-1)[:n].reshape(shape),
                      mesh.axis_names, mesh.slots.reshape(-1)[:n])


def _reshard_compiled(compiled: CompiledRollout,
                      new_mesh: DeviceMesh) -> CompiledRollout:
    """Rebuild every distributed sweep on ``new_mesh``, REUSING the
    frozen segment plans (same fuse schedule / backend / block — only
    the recorded mesh shape changes), so the resumed numerics are the
    already-proven fused-sweep executables on bigger local blocks."""
    new_shape = list(new_mesh.shape)
    plans = tuple(
        dataclasses.replace(p, sharding={**p.sharding,
                                         "mesh_shape": new_shape})
        if p.sharding is not None else p
        for p in compiled.plan.segment_plans)
    rplan = dataclasses.replace(compiled.plan, segment_plans=plans)
    return compile_program(rplan, device=compiled.device, mesh=new_mesh)


def _state_sharding(compiled: CompiledRollout) -> dist.MeshSharding | None:
    """Where rollout states live (None if the program is single-device)."""
    if compiled.mesh is None:
        return None
    p0 = next((p for p in compiled.plan.segment_plans
               if p.sharding is not None), None)
    if p0 is None:
        return None
    return dist.MeshSharding(compiled.mesh, tuple(p0.sharding["grid_axes"]))


# ---------------------------------------------------------------------------
# Checkpointed, fault-tolerant driving
# ---------------------------------------------------------------------------

def _checkpoint_tree(state, emits: Sequence[tuple[int, Any]]) -> dict:
    return {"state": state,
            "emits": {f"{t:08d}": a for t, a in emits}}


def _manifest_target(directory: str, step: int) -> dict:
    """Zero-leaf target tree matching a checkpoint's manifest — restore
    needs a structural template, and the emit count varies per step."""
    tree: dict = {}
    for entry in read_manifest(directory, step)["leaves"]:
        parts = entry["key"].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.zeros((), dtype=getattr(torch,
                                                        entry["dtype"]))
    return tree


def _wait(y):
    """Block until ``y``'s device work is done (the current streams'), so
    a segment's time and its faults land inside its supervised attempt."""
    blocks = y.blocks.flat if isinstance(y, dist.ShardedState) else [y]
    for dev in {b.device for b in blocks if b.device.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()
    return y


def run_checkpointed(compiled: CompiledRollout, x, *,
                     directory: str | None = None,
                     keep_last: int | None = 3,
                     monitor=None,
                     restart=None,
                     fault_injector: Callable | None = None,
                     resume: bool = True) -> RolloutResult:
    """Drive a compiled rollout with checkpoints and restart guards.

    After every segment the post-update state (plus all emits so far)
    is checkpointed synchronously to ``directory`` under the atomic
    ``step_XXXXXXXX`` layout, retaining the last ``keep_last``; a process
    killed mid-program re-invokes this function and (``resume=True``)
    continues from the latest checkpoint — bit-exact vs an uninterrupted
    run, guarded by the program's content digest.  Restored states land
    on the compiled program's device.

    ``monitor`` (:class:`HeartbeatMonitor`) brackets each segment as one
    heartbeat step — a ``hard_timeout_s`` overrun raises
    :class:`StepTimeout` into the retry path.  ``restart``
    (:class:`RestartPolicy`) converts a failed segment into
    sleep-backoff-and-re-run-from-segment-start; without one, failures
    propagate (with checkpoints intact for the next attempt).  Both run
    through the shared :func:`repro_torch.runtime.fault_tolerance
    .supervised` loop.  ``fault_injector(segment, attempt)`` runs after
    each segment's dispatch and may raise — the test hook; the chaos
    sites ``rollout.segment`` / ``checkpoint.write`` /
    ``checkpoint.read`` are the seeded equivalent.

    Resume walks the retained checkpoints NEWEST-FIRST: a torn or
    corrupt latest checkpoint (truncated manifest, a shard failing its
    digest) is skipped in favor of the previous retained one; only a
    checkpoint that restores cleanly but belongs to a DIFFERENT program
    raises.

    Mesh-sharded programs keep the state sharded between segments and
    checkpoint it as ``shard_<slot>.npz`` files; the final state and the
    emits come back gathered onto the lead slot's device.  They add a
    LAST rung under the same supervision: when a ``dist.*`` fault (an
    injected mesh failure — lost slot, failed chunk dispatch, corrupted
    exchange) exhausts a segment's retry budget, the executor RESHARDS
    instead of dying — it rebuilds every distributed sweep on
    :func:`shrink_mesh`'s smaller mesh (same global grid, same frozen
    per-segment plans, bigger local blocks), reloads the newest intact
    shard checkpoint re-sharded onto it (or re-shards the in-memory
    segment state when running uncheckpointed), and re-runs the segment
    under a fresh budget.  ``resharded`` counts the shrinks.
    """
    program = compiled.program
    n = len(program.segments)
    start, emits = 0, []
    mgr = None
    shd = _state_sharding(compiled)
    if directory is not None:
        # keep= (not keep_last=) so keep_last=None means retain-all here
        mgr = CheckpointManager(directory, keep=keep_last,
                                async_save=False)
        if resume:
            for step0 in reversed(mgr.steps()):
                try:
                    target = _manifest_target(directory, step0)
                    tree, extra = restore_checkpoint(
                        directory, step0, target, device=compiled.device,
                        shardings=shd)
                except Exception:
                    # torn/corrupt checkpoint: fall back to the previous
                    # retained one instead of failing the whole resume
                    continue
                if extra.get("program") != program.digest():
                    raise ValueError(
                        f"checkpoint at {directory} step {step0} belongs to "
                        f"a different rollout program "
                        f"({extra.get('program')} != {program.digest()})")
                start = int(extra["segment"])
                x = tree["state"]
                emits = [(int(k), v)
                         for k, v in sorted(tree.get("emits", {}).items())]
                break

    if shd is not None and isinstance(x, torch.Tensor):
        x = shd.place(x)
    attempts = [0] * n
    recovered = [0] * n
    resharded = 0
    t = sum(s.steps for s in program.segments[:start])
    for i in range(start, n):
        seg = {"x": x}

        def _attempt(attempt: int, i=i, seg=seg):
            attempts[i] += 1
            y = compiled.run_segment(i, seg["x"])
            chaos.fire("rollout.segment", segment=int(i),
                       attempt=int(attempt))
            if fault_injector is not None:
                fault_injector(i, attempt)
            return _wait(y)

        while True:
            try:
                x = supervised(_attempt, restart=restart, monitor=monitor,
                               step=i)
                break
            except RuntimeError as e:
                if compiled.mesh is None or not _is_dist_fault(e.__cause__):
                    raise
                # a mesh fault burned the whole retry budget: shrink the
                # mesh (raises when already 1x..x1 — then the failure is
                # real), rebuild the sweeps, reload the newest intact
                # shard checkpoint re-sharded onto the survivors, re-run
                # the segment on the fresh budget on_failure just reset
                compiled = _reshard_compiled(compiled,
                                             shrink_mesh(compiled.mesh))
                shd = _state_sharding(compiled)
                restored = False
                if mgr is not None:
                    for step0 in reversed(mgr.steps()):
                        try:
                            target = _manifest_target(directory, step0)
                            tree, extra = restore_checkpoint(
                                directory, step0, target,
                                device=compiled.device, shardings=shd)
                        except Exception:
                            continue
                        if extra.get("program") != program.digest() or \
                                int(extra["segment"]) != i:
                            continue
                        seg["x"] = tree["state"]
                        emits = [(int(k), v) for k, v in
                                 sorted(tree.get("emits", {}).items())]
                        restored = True
                        break
                if not restored:
                    # uncheckpointed (or the segment predates any save):
                    # the in-memory start state re-shards onto the
                    # shrunk mesh directly
                    seg["x"] = shd.place(seg["x"])
                resharded += 1
        if attempts[i] > 1:
            recovered[i] = 1
        t += program.segments[i].steps
        if program.segments[i].emit:
            emits.append((t, x))
        if mgr is not None:
            mgr.save(t, _checkpoint_tree(x, emits),
                     extra={"program": program.digest(),
                            "segment": i + 1, "step": t})
    if shd is not None:
        x = dist.unshard(x)
        emits = [(s, dist.unshard(a)) for s, a in emits]
    return RolloutResult(final=x, emits=tuple((int(s), a) for s, a in emits),
                         attempts=tuple(attempts),
                         recovered=tuple(recovered), resharded=resharded)
