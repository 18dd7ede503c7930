"""Each cell on the card at its own size, through the command a checker
runs: a sound run is correct, its reference's control is not.  Skips
without a card:

    python -m pytest portbench/tests -m card
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = tuple(w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"])


def run(cell: str, seed: int, *extra: str) -> dict:
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "3", "--trace", "0", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_is_correct_and_its_control_is_not(card, cell):
    sound = run(cell, 2 ** 31 + 17)
    assert sound["correct"] is True, sound["checks"]
    assert sound["device"]["kind"].startswith("NVIDIA")
    lower = harness.reference_for(harness.load_cell(cell)).CONTROLS[0]
    control = run(cell, 2 ** 31 + 17, "--control", lower)
    assert control["correct"] is False, control["checks"]
