"""The port's own trace read on the card: a traced run of each cell at its
own size reports the pads' and the kernels' bytes a call of the closed
form, a pad bandwidth share under 100%, and a pad device time (the
``halo.pad`` spans' CUDA events) that agrees with the gather kernels' in
the same profiled window.  Skips without a card:

    python -m pytest portbench/tests -m card
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import yardstick

ROOT = Path(__file__).resolve().parents[2]

#: GB a call at the cells' sizes, (pads, kernels): 2 and 24 periodic
#: gathers of a 2^30-point f32 state (no tile pads), and the sweep and
#: step kernels' launch prices over the planned schedules (3x5+1 on 64x128
#: tiles, 1x8 on 16x32x32)
CLOSED_FORM_GB = {"star2d_r2.rollout": (17.1819664, 58.459160576),
                  "star3d_r2.rollout": (207.369013248, 88.820678656)}


def traced_run(cell: str, seed: int) -> dict:
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "4", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CLOSED_FORM_GB))
def test_traced_run_reads_the_ports_spans(card, cell):
    r = traced_run(cell, 2 ** 31 + 29)
    assert r["correct"] is True, r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    pad_gb, kernel_gb = CLOSED_FORM_GB[cell]
    assert m["pad_gb_per_call"] == pytest.approx(pad_gb, rel=1e-3)
    assert m["kernel_gb_per_call"] == pytest.approx(kernel_gb, rel=1e-3)
    assert 0 < m["pad_bw_pct"] <= 100
    # the sub-window's calls, from its roofline share and the call's bound
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / f"{cell.split('.')[0]}.json").read_text())
    peaks = yardstick.card_peaks(r["device"]["kind"])
    bound = yardstick.bound_s(*yardstick.stencil_call_work(
        cfg["grid"], len(cfg["taps"]), cfg["steps_per_call"]), peaks)
    calls = round(m["call_roofline"] / 100 * r["device"]["window_s"] / bound)
    pad_s = (m["pad_gb_per_call"] * 1e9 * calls
             / (m["pad_bw_pct"] / 100 * peaks["hbm_bytes_per_s"]))
    gather_s = sum(s for name, s in r["breakdown"]["device_ops"]
                   if "gather" in name)
    assert pad_s == pytest.approx(gather_s, rel=0.05)
