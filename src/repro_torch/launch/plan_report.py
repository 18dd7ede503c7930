"""Plan report: ``plan(problem).explain()`` for the PAPER_SUITE on the card.

The golden test (``tests/test_torch_plan_golden.py``) diffs this module's
output against ``tests/golden/torch_plan_report.txt``, so any cost-model
or decision change of the port's planner shows up as a reviewable diff.
``--hw`` re-targets the roofline constants; ``--calibration record.json``
re-ranks every table with the measured per-(backend, strategy) factors of
a :class:`repro_torch.launch.calibrate.CalibrationRecord` (the golden
itself is always the UNcalibrated model, so it does not depend on the
host).

    PYTHONPATH=src python -m repro_torch.launch.plan_report [--hw h100_sxm]
        [--calibration record.json]

Column meanings (one table per PAPER_SUITE spec, one row per enumerated
candidate, best first — see ``ExecutionPlan.explain``):

    rank       selection order under the deterministic total order
    depth      fused-chunk length T (temporal fusion, paper §6)
    batch      states advanced together per call (the problem's batch)
    strat      temporal strategy: "operator" (one radius-T*r fused
               operator) | "inkernel" (T base steps per sweep-kernel
               launch, shared-memory intermediates, flops linear in T)
    coeff      coefficient kind of the spec: "const" | "vary" | "mask" |
               "vary+mask"
    cover      coefficient-line cover of the T-fused operator (of the
               BASE operator for inkernel rows)
    backend    backend registry entry executing the update
    block      output tile the row was scored at (the block search)
    t_compute  calibrated compute seconds per fused sweep over the grid
    t_traffic  calibrated device-memory seconds per fused sweep
    t_comm     link seconds per fused chunk (0 on one card)
    t/model    UNcalibrated per-state-per-step score
               (max(compute,traffic,comm) + launch overhead) / (T * batch)
    t/step     calibrated per-state-per-step score — the quantity plan()
               minimizes (equals t/model without a calibration, as in the
               golden)
"""
from __future__ import annotations

import argparse

from repro_torch.core.planner import StencilProblem, plan
from repro_torch.core.stencil_spec import PAPER_SUITE
from repro_torch.launch.mesh import H100_SXM, get_hardware

__all__ = ["generate_report", "REPORT_GRID_2D", "REPORT_GRID_3D",
           "REPORT_STEPS", "REPORT_MAX_DEPTH", "REPORT_TOP"]

# Report cell: one representative shape-preserving evolution per paper spec.
REPORT_GRID_2D = (256, 256)
REPORT_GRID_3D = (64, 64, 64)
REPORT_STEPS = 16
REPORT_MAX_DEPTH = 4
REPORT_TOP = 4


def generate_report(hw=H100_SXM, steps: int = REPORT_STEPS,
                    max_depth: int = REPORT_MAX_DEPTH,
                    top: int = REPORT_TOP, calibration=None) -> str:
    """Deterministic plan.explain() report for every PAPER_SUITE spec."""
    lines = [
        f"# plan-report: PAPER_SUITE on {hw.name} "
        f"(steps={steps}, max_depth={max_depth})",
    ]
    suite = PAPER_SUITE()
    for name in sorted(suite):
        spec = suite[name]
        grid = REPORT_GRID_2D if spec.ndim == 2 else REPORT_GRID_3D
        problem = StencilProblem(spec, grid, boundary="periodic", steps=steps)
        p = plan(problem, hw, max_depth=max_depth, calibration=calibration)
        lines.append("")
        lines.append(f"## {name}")
        lines.append(p.explain(top=top))
    return "\n".join(lines) + "\n"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", default=H100_SXM.name)
    ap.add_argument("--steps", type=int, default=REPORT_STEPS)
    ap.add_argument("--max-depth", type=int, default=REPORT_MAX_DEPTH)
    ap.add_argument("--calibration", default=None, metavar="JSON_PATH",
                    help="CalibrationRecord JSON (e.g. "
                         "api.calibrate(...).to_json()) to re-rank the "
                         "tables with")
    args = ap.parse_args()
    calibration = None
    if args.calibration:
        from repro_torch.launch.calibrate import CalibrationRecord
        with open(args.calibration) as f:
            calibration = CalibrationRecord.from_json(f.read())
    print(generate_report(get_hardware(args.hw), steps=args.steps,
                          max_depth=args.max_depth, calibration=calibration),
          end="")


if __name__ == "__main__":
    main()
