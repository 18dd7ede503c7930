"""Public facade: ``StencilProblem -> plan() -> ExecutionPlan -> compile()``,
on one NVIDIA H100.

    from repro_torch import api

    problem = api.StencilProblem(api.star(2, 2), grid=(8192, 8192),
                                 boundary="periodic", steps=16)
    p = api.plan(problem, backends=["cuda"])   # frozen, JSON-serializable
    print(p.explain())                         # modelled roofline costs
    run = api.compile(p)                       # on the card by default
    y = run(x)                                 # x: a CUDA tensor

``api.compile(p, device="cpu")`` runs the same plan on the CPU, where the
``cuda`` backend's kernel wrappers use their plain PyTorch versions.  A
problem or plan of the JAX package carries across with identical numbers:
``StencilProblem.from_dict(ref_problem.to_dict())`` and
``ExecutionPlan.from_json(ref_plan.to_json())`` (backend names mapped by
``REFERENCE_BACKENDS``).

``api.calibrate(problem, ...)`` measures a problem's top candidates
(counted flops and bytes of each executed chunk, optionally its time) into
a :class:`CalibrationRecord`; ``api.plan(problem, calibration=record)``
re-ranks with it.  Records cross between the packages in both directions.

Distributed: give the problem a mesh of device slots and per-axis mesh
names and the compiled stepper exchanges a single ``T*r``-deep halo once
per fused chunk, running the step or sweep kernel on each slot's block
(one process drives every slot; a slot may repeat a device, so four
slots of one card form a 2x2 mesh):

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("x", "y"))             # devices="cpu" too
    problem = api.StencilProblem(api.star(2, 2), grid=(8192, 8192),
                                 boundary="periodic", steps=16,
                                 mesh=mesh, grid_axes=("x", "y"))
    run = api.compile(api.plan(problem, backends=["cuda"]), mesh=mesh)
    y = run(x)             # x: a global tensor, or a ShardedState

Serving and rollouts sit on top: a :class:`PlanCache` memoizes plan +
compile per problem, a :class:`StencilServer` batches a request stream
into cached executables on the card, :class:`RolloutProgram` s
interleave fused sweeps with update ops under checkpoints
(:func:`run_checkpointed`), and a seeded :class:`FaultPlan` injects
deterministic failures at named sites to prove recovery end to end:

    server = api.StencilServer(api.PAPER_SUITE()["star2d_r2"], steps=16,
                               backends=["cuda"])      # devices=["cpu"] too
    with api.FaultPlan(seed=0).rule("serve.settle", rate=0.3):
        outs = server.serve(states)                    # still bit-exact
"""
from __future__ import annotations

from repro_torch.core.engine import (Backend, StencilEngine, backend_names,
                                     choose_cover, default_block, get_backend,
                                     legal_covers, register_backend)
from repro_torch.core.plan_cache import CachedExecutable, PlanCache, cache_key
from repro_torch.core.planner import (REFERENCE_BACKENDS, CandidateCost,
                                      CompiledStencil, ExecutionPlan,
                                      FUSE_STRATEGIES, PLAN_VERSION,
                                      StencilProblem, batch_cost_curve,
                                      best_block, candidate_blocks,
                                      candidate_cost, compile_plan,
                                      max_profitable_batch, plan,
                                      serving_buckets)
from repro_torch.core.stencil_spec import (PAPER_SUITE, StencilSpec, box,
                                           diagonal, from_gather_coeffs,
                                           from_numpy, random_coeff_field,
                                           random_domain_mask, star)
from repro_torch.launch.calibrate import (CalibrationRecord,
                                          CandidateMeasurement, calibrate,
                                          measure_candidate)
from repro_torch.launch.serve_stencil import (RequestShed, ServeStats,
                                              StencilServer)
from repro_torch.rollout import (CompiledRollout, RolloutPlan, RolloutProgram,
                                 RolloutResult, Segment, UpdateOp,
                                 compile_program, plan_program,
                                 register_update_op, run_checkpointed,
                                 update_op_names)
from repro_torch.runtime.chaos import (FAULT_SITES, FaultError, FaultPlan,
                                       FaultRule)
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                 RestartPolicy, StepTimeout,
                                                 supervised)

compile = compile_plan  # noqa: A001 - the facade verb (shadows the builtin
#                         inside this namespace only, by design)

__all__ = [
    "StencilProblem", "ExecutionPlan", "CandidateCost", "CompiledStencil",
    "plan", "compile", "compile_plan", "candidate_cost", "candidate_blocks",
    "best_block", "batch_cost_curve", "max_profitable_batch",
    "serving_buckets", "FUSE_STRATEGIES", "PLAN_VERSION",
    "REFERENCE_BACKENDS",
    "CalibrationRecord", "CandidateMeasurement", "calibrate",
    "measure_candidate",
    "PlanCache", "CachedExecutable", "cache_key",
    "StencilServer", "ServeStats", "RequestShed",
    "FaultPlan", "FaultRule", "FaultError", "FAULT_SITES",
    "RestartPolicy", "HeartbeatMonitor", "StepTimeout", "supervised",
    "RolloutProgram", "Segment", "UpdateOp", "RolloutPlan", "RolloutResult",
    "CompiledRollout", "plan_program", "compile_program", "run_checkpointed",
    "register_update_op", "update_op_names",
    "StencilEngine", "Backend", "register_backend", "get_backend",
    "backend_names", "choose_cover", "legal_covers", "default_block",
    "StencilSpec", "box", "star", "diagonal", "from_gather_coeffs",
    "from_numpy", "random_coeff_field", "random_domain_mask", "PAPER_SUITE",
]
