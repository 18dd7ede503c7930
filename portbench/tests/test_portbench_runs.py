"""Whole runs of each cell on the CPU at small sizes, past the look for a
card: a sound run is correct; the control (the reference in TF32 in the
program's place) and each fault the cell can have, planted in the timed
path, are not."""
import json
import time

import pytest
import torch

from portbench import harness

SMALL = {
    "star2d_r2.rollout": {"config": {"grid": [96, 80]}},
    "star3d_r2.rollout": {"config": {"grid": [24, 20, 16]}},
}
CELLS = tuple(SMALL)


def run(name, *, control=None, trace=False, seconds=0.4, seed=2 ** 40 + 1):
    cell = harness.load_cell(name, overrides=SMALL[name])
    return harness.run_cell(cell, seed, seconds, trace,
                            device=torch.device("cpu"),
                            t0=time.perf_counter(), control=control)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_prints_its_checks_last(name):
    r = run(name)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["checks"]["max_rel_err"]["value"] < \
        r["checks"]["max_rel_err"]["limit"]
    assert "setup_s" in r["metrics"]
    json.loads(json.dumps(r))


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer_metrics_only(name):
    r = run(name, trace=True)
    assert r["correct"] is True
    assert "setup_s" not in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert r["device"]["window_s"] > 0
    assert "breakdown" in r


@pytest.mark.parametrize("name", CELLS)
def test_control_in_tf32_is_not_correct(name):
    r = run(name, control="tf32")
    assert r["correct"] is False
    assert r["checks"]["max_rel_err"]["value"] > \
        3 * r["checks"]["max_rel_err"]["limit"]


def _plant_rollout(monkeypatch, fault):
    from repro_torch import api
    real = api.compile

    def broken(plan, **kw):
        call = real(plan, **kw)

        def fn(x):
            if fault == "unchanged":
                return x.clone()
            y = call(x).clone()
            y.view(-1)[y.numel() // 3] += y.abs().max()
            return y
        return fn

    monkeypatch.setattr(api, "compile", broken)


@pytest.mark.parametrize("name, fault", [
    ("star2d_r2.rollout", "unchanged"), ("star2d_r2.rollout", "altered"),
    ("star3d_r2.rollout", "unchanged"), ("star3d_r2.rollout", "altered")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    _plant_rollout(monkeypatch, fault)
    r = run(name)
    assert r["correct"] is False, r["checks"]
