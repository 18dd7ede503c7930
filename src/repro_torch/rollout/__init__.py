"""Rollout programs: interleaved fused sweeps + per-step update operators.

The serving stack answers "advance B states T steps"; the workloads
stencils exist for (assimilation, forced fluids, imaging pipelines)
interleave stencil prediction with pointwise state updates and must
survive running for hours.  This package makes the plan a *program*:

  * :mod:`repro_torch.rollout.program` — the :class:`RolloutProgram`
    spec (:class:`~repro_torch.core.planner.StencilProblem` + ordered
    :class:`Segment` list, each ``sweep(T_i)`` then an optional
    registered :class:`UpdateOp`, plus emit points) and the update-op
    registry (:func:`register_update_op`).
  * :mod:`repro_torch.rollout.planning` — :func:`plan_program` chooses
    fuse strategy/depth PER SEGMENT under the shared cost model and
    freezes the decisions into a :class:`RolloutPlan`.
  * :mod:`repro_torch.rollout.executor` — :func:`compile_program` builds
    the segment-wise executable (:class:`CompiledRollout`) and
    :func:`run_checkpointed` drives it with segment-boundary
    checkpoints, heartbeat/hard-timeout guards and bounded-backoff
    restarts (bit-exact resume).

The port of the JAX package's ``repro.rollout``, on one device.
"""
from repro_torch.rollout.program import (RolloutProgram, Segment, UpdateOp,
                                         as_segments, build_update,
                                         get_update_builder,
                                         register_update_op, update_op_names)
from repro_torch.rollout.planning import RolloutPlan, plan_program
from repro_torch.rollout.executor import (CompiledRollout, RolloutResult,
                                          compile_program, run_checkpointed)

__all__ = [
    "RolloutProgram", "Segment", "UpdateOp", "as_segments",
    "register_update_op", "update_op_names", "get_update_builder",
    "build_update",
    "RolloutPlan", "plan_program",
    "CompiledRollout", "RolloutResult", "compile_program",
    "run_checkpointed",
]
