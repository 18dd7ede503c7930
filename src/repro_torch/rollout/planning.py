"""Program planner: per-segment fuse decisions under the shared cost model.

:func:`plan_program` runs :func:`repro_torch.core.planner.plan` once per
segment — each segment is its own :class:`StencilProblem` (own step
count; under ``boundary="valid"`` its own shrunken grid), so the planner
is free to pick a DIFFERENT fuse strategy/depth/block per segment: a
long prediction window fuses deep, a 2-step inter-update hop may not
clear the fusion break-even at all.  The decisions freeze into a
:class:`RolloutPlan` — the same kind of artifact as a single-sweep
:class:`~repro_torch.core.planner.ExecutionPlan` (JSON round-trip, versioned
with the shared ``PLAN_VERSION``, an ``explain()`` table) but one row
per segment, with program totals and the modelled fused-vs-stepwise
traffic win the segmentation preserves.

The trade-off this table surfaces: an update point
is a fusion BARRIER — the post-update state must materialize, so the
paper's T-fold traffic cut applies per segment, not across the program.
``explain()`` prices both sides: the fused program's modelled HBM bytes
per state against the same program executed one step at a time.

The port's copy of the JAX package's ``rollout/planning.py``.  A
``RolloutPlan.to_json()`` of the JAX package loads here, its backend
names mapped by :data:`repro_torch.core.planner.REFERENCE_BACKENDS`
(through :meth:`ExecutionPlan.from_json`).
"""
from __future__ import annotations

import dataclasses
import json

import torch

from repro_torch.core import matrixization as mx
from repro_torch.core.planner import (ExecutionPlan, PLAN_VERSION, _n_blocks,
                                      plan)
from repro_torch.rollout.program import RolloutProgram

__all__ = ["RolloutPlan", "plan_program", "segment_traffic"]


def segment_traffic(eplan: ExecutionPlan) -> tuple[float, float]:
    """Modelled HBM bytes of one segment, (as planned, one step at a
    time), whole batch.

    Both sides use the plan's own block tiling: per fused chunk of depth
    ``t`` each tile of each state reads a ``t*r``-haloed slab and writes
    the tile once (``matrixization.block_hbm_bytes``); the stepwise
    baseline pays that read+write at halo ``r`` for EVERY step.
    """
    spec = eplan.spec
    nb = _n_blocks(eplan.grid, eplan.block)
    dtype_bytes = getattr(torch, eplan.problem["dtype"]).itemsize
    batch = eplan.batch
    fused = sum(
        batch * mx.block_hbm_bytes(eplan.block, t * spec.order,
                                   dtype_bytes) * nb
        for t in eplan.fuse_schedule)
    stepwise = eplan.steps * batch * mx.block_hbm_bytes(
        eplan.block, spec.order, dtype_bytes) * nb
    return float(fused), float(stepwise)


def _stepwise_t_per_step(eplan: ExecutionPlan) -> float:
    """Best modelled per-state-step cost among the plan's OWN depth-1
    rows — the step-by-step baseline priced by the same table (depth 1 is
    always enumerated, even under a pinned-strategy search)."""
    rows = [c.t_per_step for c in eplan.candidates if c.depth == 1]
    return min(rows) if rows else eplan.chosen().t_per_step


@dataclasses.dataclass(frozen=True)
class RolloutPlan:
    """Frozen per-segment decision record of one rollout program.

    ``program`` is the :meth:`RolloutProgram.to_dict` statement;
    ``segment_plans`` holds one full :class:`ExecutionPlan` per segment
    (cost tables included), so every single-sweep reporting/diffing tool
    works on a rollout's parts while :meth:`explain` renders the program
    view.  Versioned with the shared ``PLAN_VERSION`` — a rollout plan
    and its segment plans can never disagree about format.
    """

    version: int
    program: dict
    segment_plans: tuple[ExecutionPlan, ...]

    # -- reconstruction ----------------------------------------------------
    def program_obj(self) -> RolloutProgram:
        return RolloutProgram.from_dict(self.program)

    @property
    def total_steps(self) -> int:
        return sum(p.steps for p in self.segment_plans)

    def traffic(self) -> dict:
        """Program-total modelled HBM bytes per state: fused-as-planned
        vs one-step-at-a-time, and their ratio (the win an update
        barrier caps)."""
        fused = stepwise = 0.0
        for p in self.segment_plans:
            f, s = segment_traffic(p)
            fused += f
            stepwise += s
        batch = self.segment_plans[0].batch
        return {"fused_bytes_per_state": fused / batch,
                "stepwise_bytes_per_state": stepwise / batch,
                "traffic_ratio": stepwise / fused if fused else float("inf")}

    # -- serialization -----------------------------------------------------
    def to_json(self, indent: int | None = None) -> str:
        return json.dumps({
            "version": self.version,
            "program": self.program,
            "segment_plans": [json.loads(p.to_json())
                              for p in self.segment_plans],
        }, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "RolloutPlan":
        d = json.loads(text)
        if d.get("version") != PLAN_VERSION:
            raise ValueError(f"rollout plan version {d.get('version')!r} "
                             f"does not match this code's "
                             f"PLAN_VERSION={PLAN_VERSION}; re-plan")
        return cls(version=d["version"], program=d["program"],
                   segment_plans=tuple(ExecutionPlan.from_json(json.dumps(p))
                                       for p in d["segment_plans"]))

    # -- reporting ---------------------------------------------------------
    def explain(self) -> str:
        """One row per segment (planner decisions + per-state-step cost),
        then program totals and the fused-vs-stepwise traffic model.

        Columns: ``seg`` index, ``steps`` segment sweep length,
        ``update`` the post-sweep op (``-`` for none), ``emit`` whether
        the segment streams its state, ``strat``/``depth``/``schedule``/
        ``backend``/``block`` the segment plan's chosen execution,
        ``t/state-step`` its modelled per-state-per-step seconds,
        ``MB/state-step`` its modelled fused HBM traffic per state-step.
        """
        prog = self.program
        segs = prog["segments"]
        p0 = self.segment_plans[0]
        head = p0.problem
        spec = p0.spec
        lines = [
            f"RolloutPlan v{self.version}: {spec.describe()} | "
            f"grid={tuple(prog['problem']['grid'])} {head['dtype']} | "
            f"boundary={head['boundary']} | batch={p0.batch} | "
            f"{len(segs)} segments, {self.total_steps} total steps",
            "  seg steps update               emit strat    depth "
            "schedule backend     block        t/state-step MB/state-step",
        ]
        for i, (seg, p) in enumerate(zip(segs, self.segment_plans)):
            up = seg.get("update")
            up_s = up["op"] if up else "-"
            ch = p.chosen()
            fused, _ = segment_traffic(p)
            mb = fused / (p.batch * p.steps) / 1e6
            blk = "x".join(str(b) for b in p.block)
            lines.append(
                f"  {i:3d} {p.steps:5d} {up_s:<20s} "
                f"{'yes' if seg.get('emit') else 'no ':<4s} "
                f"{p.fuse_strategy:<8s} {p.fuse_depth:5d} "
                f"{p.schedule_str():<8s} {p.backend:<11s} {blk:<12s} "
                f"{ch.t_per_step:.3e}    {mb:.3f}")
        t = self.traffic()
        t_total = sum(p.chosen().t_per_step * p.steps
                      for p in self.segment_plans)
        step_total = sum(_stepwise_t_per_step(p) * p.steps
                         for p in self.segment_plans)
        lines.append(
            f"program totals/state: modelled {t_total:.3e}s fused vs "
            f"{step_total:.3e}s stepwise "
            f"({step_total / t_total if t_total else float('nan'):.2f}x), "
            f"HBM {t['fused_bytes_per_state'] / 1e6:.1f} MB fused vs "
            f"{t['stepwise_bytes_per_state'] / 1e6:.1f} MB stepwise "
            f"({t['traffic_ratio']:.2f}x)")
        lines.append(
            "update points are fusion barriers: the traffic win applies "
            "per segment, not across the program")
        return "\n".join(lines)


def plan_program(program: RolloutProgram, hw=None, *, cache=None,
                 calibration=None, **plan_kwargs) -> RolloutPlan:
    """Plan every segment of ``program`` under the shared cost model.

    Each segment plans as its own problem — so fuse strategy, depth and
    block are chosen PER SEGMENT (a 16-step prediction window and a
    2-step inter-update hop get different depths from the same roofline).
    ``plan_kwargs`` pass through to :func:`repro_torch.core.planner.plan`
    unchanged (pins pin every segment).  ``cache`` routes the per-segment
    planning through a :class:`repro_torch.core.plan_cache.PlanCache`'s
    ``plan_only`` memo, so programs sharing segment shapes (or a later
    ``get_program`` compile) never re-enumerate a cost table.
    """
    seg_plans = []
    for i in range(len(program.segments)):
        pb = program.segment_problem(i)
        if cache is not None:
            seg_plans.append(cache.plan_only(pb, calibration=calibration,
                                             **plan_kwargs))
        else:
            seg_plans.append(plan(pb, hw, calibration=calibration,
                                  **plan_kwargs))
    return RolloutPlan(version=PLAN_VERSION, program=program.to_dict(),
                       segment_plans=tuple(seg_plans))
