"""The benchmark's arithmetic on the CPU: the work counts and bounds,
percentiles, the device-timeline reduction, the metric readers, and the
harness's hold on what the reference compares."""
import json
import time
from pathlib import Path

import pytest
import torch

from portbench import harness, timeline, yardstick

HERE = Path(__file__).resolve().parents[1]
H100 = {"hbm_bytes_per_s": 3.35e12, "f32_accurate_flops_per_s": 1.65e14,
        "bf16_dense_flops_per_s": 9.89e14}


@pytest.mark.parametrize("name, bound_ms", [("star2d_r2", 2.564),
                                            ("star3d_r2", 2.564)])
def test_call_bounds_follow_the_problem(name, bound_ms):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    nbytes, flops = yardstick.stencil_call_work(
        cfg["grid"], len(cfg["taps"]), cfg["steps_per_call"])
    assert nbytes == 2 * 4 * torch.tensor(cfg["grid"]).prod().item()
    assert flops == 2 * len(cfg["taps"]) * nbytes / 8 * cfg["steps_per_call"]
    assert yardstick.bound_s(nbytes, flops, H100) * 1e3 == pytest.approx(
        bound_ms, abs=5e-4)
    # bytes bound both: the flops at 3xTF32 take less
    assert flops / H100["f32_accurate_flops_per_s"] < \
        nbytes / H100["hbm_bytes_per_s"]


def test_card_peaks_by_name():
    p = yardstick.card_peaks("NVIDIA H100 80GB HBM3")
    assert p == H100
    assert yardstick.card_peaks("NVIDIA A100-SXM4-40GB") is None


def test_percentile_by_nearest_rank():
    xs = list(range(1, 101))
    assert yardstick.percentile(xs, 50) == 50
    assert yardstick.percentile(xs, 95) == 95
    assert yardstick.percentile(reversed(xs), 95) == 95
    assert yardstick.percentile([3.0], 95) == 3.0


def test_max_rel_err():
    want = torch.tensor([1.0, -2.0], dtype=torch.float64)
    assert yardstick.max_rel_err(torch.tensor([1.0, -2.0]), want) == 0
    assert yardstick.max_rel_err(torch.tensor([1.0, -1.0]), want) == 0.5
    assert yardstick.max_rel_err(torch.tensor([1.0]), want) == float("inf")
    nan = yardstick.max_rel_err(torch.tensor([float("nan"), 1.0]), want)
    assert nan != nan


def test_union_and_gaps():
    assert timeline.union_s([(0, 10), (5, 20), (30, 40)]) == pytest.approx(
        30e-6)
    device = [("stencil_sweep_kernel<float>", 100, 400),
              ("Memcpy HtoD (Pinned -> Device)", 400, 500),
              ("index_select", 450, 520), ("stencil_step_kernel", 700, 900),
              ("elementwise", 950, 1200)]
    # the host span that launched device work shows on the device too
    device.append(("portbench.call", 90, 1210))
    host = [(timeline.WINDOW_SPAN, 0, 1000), ("portbench.call", 0, 1000),
            ("aten::roll", 520, 700), ("cudaStreamSynchronize", 900, 950)]
    t = timeline.summarize(device, host, ["stencil_sweep_kernel",
                                          "stencil_step_kernel"])
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((420 + 200 + 50) * 1e-6)
    assert t.kernel_s == pytest.approx(500e-6)
    assert t.h2d_s == pytest.approx(100e-6)
    assert t.device_s == pytest.approx((300 + 100 + 70 + 200 + 50) * 1e-6)
    assert t.n_device_ops == 5
    assert t.ops[0] == ["stencil_sweep_kernel<float>", pytest.approx(3e-4)]
    names = dict((n.rsplit(" x", 1)[0], s) for n, s in t.gaps)
    assert names == {"portbench.call": pytest.approx(100e-6),
                     "aten::roll": pytest.approx(180e-6),
                     "cudaStreamSynchronize": pytest.approx(50e-6)}
    assert timeline.summarize(device, host[1:], ["x"]) is None


def _record(cell_name, bench_path=HERE.parent / "BENCHMARK.json", **kw):
    cell = harness.load_cell(cell_name, bench_path)
    record = harness.RunRecord(cell=cell, **kw)
    return cell, record


def test_readers_leave_out_what_they_cannot_read():
    cell, record = _record("star2d_r2.rollout", setup_s=12.0, calls=100,
                           updates=1e11, window_s=0.5)
    e2e = harness.read_metrics(record, cell.end_to_end)
    assert e2e == {"gpts_per_s": {"value": 200.0, "unit": "Gpt/s"},
                   "setup_s": {"value": 12.0, "unit": "s"}}
    # no trace: no per-layer metric, and no roofline reads 0
    assert harness.read_metrics(record, cell.per_layer) == {}
    record.trace = timeline.DeviceTrace(
        window_s=0.5, busy_s=0.48, device_s=0.49, kernel_s=0.0, h2d_s=0.0,
        ops=[], gaps=[], n_device_ops=10)
    record.sub = {"calls": 100, "launches": 600}
    record.bound_s = 1.6e-4
    got = harness.read_metrics(record, cell.per_layer)
    assert "kernels_roofline" not in got
    assert got["call_roofline"]["value"] == pytest.approx(3.2)
    assert got["launches_per_call"]["value"] == 6
    assert got["outside_kernels_pct"]["value"] == pytest.approx(100.0)
    assert got["device_idle_pct.rollout"]["value"] == pytest.approx(4.0)
    assert set(got) == {"call_roofline", "launches_per_call",
                        "outside_kernels_pct", "device_idle_pct.rollout"}


def test_a_dotted_name_falls_back_to_the_reader_without_its_suffix(
        tmp_path):
    (tmp_path / "idle.py").write_text("")
    (tmp_path / "idle.own.py").write_text("")
    assert harness.reader_path("idle.serve", tmp_path) == tmp_path / "idle.py"
    assert harness.reader_path("idle.own", tmp_path) == \
        tmp_path / "idle.own.py"
    assert harness.reader_path("other", tmp_path) == tmp_path / "other.py"


def test_the_harness_holds_what_the_reference_checks_to_the_limits(
        monkeypatch):
    """The comparison is the reference's: the harness hands it the
    driver's answers as they are, and applies the cell's limits to the
    numbers it returns, whatever they are called."""
    seen = {}

    class Reference:
        CONTROLS = ()

        @staticmethod
        def checks(config, answers, control, device):
            seen["answers"] = answers
            return {"max_rel_err": 2e-4}, {"note": 1.0}

    monkeypatch.setattr(harness, "reference_for", lambda cell: Reference)
    cell = harness.load_cell("star2d_r2.rollout", overrides={
        "config": {"grid": [16, 16]}})
    r = harness.run_cell(cell, 3, 0.1, False, device=torch.device("cpu"),
                         t0=time.perf_counter())
    assert r["correct"] is False
    assert r["checks"] == {"max_rel_err": {"value": 2e-4, "limit": 1e-4}}
    assert r["info"]["note"] == 1.0
    assert [a[0] for a in seen["answers"]][0] == "call 0"


def test_every_metric_has_its_reader_and_every_cell_its_files():
    d = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for m in d["end_to_end"] + d["per_layer"]:
        assert harness.reader_path(m["name"]).is_file(), m["name"]
    for w in d["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (HERE / "drivers" / f"{cell.mix['kind']}.py").is_file()
        if "spec" in cell.config:
            assert (HERE / "specs" / f"{cell.config['spec']}.py").is_file()
        ref = harness.reference_for(cell)
        assert cell.limits and all(
            v["lower"] < v["limit"] < v["upper"]
            for v in cell.limits.values())
        assert ref.CONTROLS
