"""The port's plan report: its planner's decisions and modelled costs for
the PAPER_SUITE on the H100's roofline constants, frozen in
``tests/golden/torch_plan_report.txt``.

A cost-model or decision change of the port's planner must come with a
reviewed golden update: regenerate with ``PYTHONPATH=src python -m
repro_torch.launch.plan_report > tests/golden/torch_plan_report.txt``.
Pure model — nothing runs a kernel."""
import difflib
import os

import torch

from repro_torch.core.stencil_spec import PAPER_SUITE
from repro_torch.launch import plan_report
from repro_torch.launch.calibrate import CALIBRATION_VERSION, CalibrationRecord

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_plan_report.txt")


def test_torch_plan_report_matches_golden():
    with open(GOLDEN) as f:
        golden = f.read()
    current = plan_report.generate_report()
    if current != golden:
        diff = "\n".join(difflib.unified_diff(
            golden.splitlines(), current.splitlines(),
            fromfile="tests/golden/torch_plan_report.txt",
            tofile="generated", lineterm="", n=2))
        raise AssertionError(
            "the port's plan report drifted from its golden — if the "
            "cost-model change is intended, regenerate with `python -m "
            "repro_torch.launch.plan_report > "
            f"tests/golden/torch_plan_report.txt`\n{diff}")


def test_torch_plan_report_covers_whole_suite():
    current = plan_report.generate_report()
    assert current.startswith("# plan-report: PAPER_SUITE on h100_sxm ")
    for name in PAPER_SUITE():
        assert f"## {name}" in current
    # every suite spec, plus the distributed case on a 2x2 mesh
    assert current.count("<- chosen") == len(PAPER_SUITE()) + 1 == 14
    assert "## star2d_r2 on a 2x2 mesh" in current
    assert current.count("mesh=2x2(x,y)") == 1


def test_calibrated_report_says_calibrated(tmp_path):
    rec = CalibrationRecord(version=CALIBRATION_VERSION, hw="h100_sxm",
                            problem={}, compute={"cuda:inkernel": 1.5},
                            traffic={"cuda": 3.0}, measurements=())
    path = tmp_path / "record.json"
    path.write_text(rec.to_json())
    loaded = CalibrationRecord.from_json(path.read_text())
    report = plan_report.generate_report(calibration=loaded)
    assert report.count("calibrated (h100_sxm measured") == 14
    assert "cuda:x1.00/x3.00 cuda:inkernel:x1.50/x1.00" in report
    assert "calibrated/state-step" in report
    assert report != plan_report.generate_report()
