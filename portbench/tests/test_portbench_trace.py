"""The port's own trace read on the card: a traced run of each cell at its
own size reports the kernels' bytes a call of the closed form, no pad
bytes, and no ``halo.pad`` span at all: since the kernels read the
periodic halo of the unpadded state (wrap mode), no periodic chunk pads.
Skips without a card:

    python -m pytest portbench/tests -m card
"""
import time

import pytest
import torch

from portbench import harness, port_trace

#: GB a call at the cells' sizes, (pads, kernels): no pads; the kernels'
#: launch prices over the planned schedules, each launch walking axis 0:
#: 5 sweep launches (3 steps, 64x128 tiles, 4 tiles a block) and 1 step
#: launch at 32768^2; 8 step launches (16x32x32 tiles, 4 a block) at 1024^3
CLOSED_FORM_GB = {"star2d_r2.rollout": (0.0, 55.099129856),
                  "star3d_r2.rollout": (0.0, 80.589881344)}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CLOSED_FORM_GB))
def test_traced_run_reads_the_ports_spans(card, cell, monkeypatch):
    sessions = []
    read = port_trace.session

    def keep(run):
        s = read(run)
        if not sessions:
            sessions.append(run.port_trace)
        return s

    monkeypatch.setattr(port_trace, "session", keep)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    r = harness.run_cell(harness.load_cell(cell), 2 ** 31 + 29, 4, True,
                         device=card, t0=time.perf_counter())
    assert r["correct"] is True, r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    pad_gb, kernel_gb = CLOSED_FORM_GB[cell]
    assert m["pad_gb_per_call"] == pad_gb
    assert m["kernel_gb_per_call"] == pytest.approx(kernel_gb, rel=1e-9)
    assert "pad_bw_pct" not in m
    session = sessions[0]
    assert session["stencil.call"]["count"] > 0
    assert "halo.pad" not in session, session
    assert not any("gather" in name or "index_select" in name
                   for name, _ in r["breakdown"]["device_ops"])
