"""The port's measured-cost calibration against the JAX package's: the
record's factor tables and JSON in both directions, re-ranking by a
record, measured records of the port's backends (counted on the CPU,
``device="cpu"``), and the kernel wrappers' launch counts."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import stencil_spec as ref_ss
from repro.launch import calibrate as ref_cal

from repro_torch import api
from repro_torch.core import coefficient_lines as cl
from repro_torch.core import stencil_spec as ss
from repro_torch.kernels import stencil_mxu as sm
from repro_torch.launch import calibrate as cal
from repro_torch.launch.op_analysis import analyze_ops

torch.set_num_threads(2)


def _problem(spec=None, grid=(64, 64), boundary="periodic", steps=6, **kw):
    return api.StencilProblem(spec or ss.box(2, 1, seed=0), grid,
                              boundary=boundary, steps=steps, **kw)


# (depth, option, backend, block, m_flops, m_bytes, c_flops, c_bytes, wall,
#  strategy): factors per key from several rows, one row with no flops
ROWS = [
    (1, "parallel", "jnp", (32, 32), 1e6, 2e5, 1.5e6, 9e5, None, "operator"),
    (2, "parallel", "jnp", (32, 64), 2e6, 3e5, 2.2e6, 8e5, 1e-3, "operator"),
    (3, "minimal", "jnp", (64, 64), 3e6, 4e5, 3.9e6, 7e5, 2e-3, "operator"),
    (2, "parallel", "pallas", (32, 32), 4e6, 1e5, 4e6, 1.1e5, None,
     "inkernel"),
    (1, "parallel", "codegen", (32, 32), 1e6, 2e5, 0.0, 5e5, None,
     "operator"),
]


def _measurements(cls):
    keys = [f.name for f in dataclasses.fields(cls)]
    return [cls(**dict(zip(keys, row))) for row in ROWS]


def _ref_problem_dict():
    return ref_api.StencilProblem(ref_ss.box(2, 1, seed=0), (64, 64),
                                  boundary="periodic", steps=6).to_dict()


def test_from_measurements_factor_tables_match_the_reference():
    ref = ref_cal.CalibrationRecord.from_measurements(
        "tpu_v5e", _ref_problem_dict(),
        _measurements(ref_cal.CandidateMeasurement))
    port = cal.CalibrationRecord.from_measurements(
        "tpu_v5e", _ref_problem_dict(),
        _measurements(cal.CandidateMeasurement))
    assert port.compute == ref.compute
    assert port.traffic == ref.traffic
    assert set(port.compute) == {"jnp", "pallas:inkernel", "codegen"}
    assert port.compute["codegen"] == 1.0       # no counted flops


def test_reference_record_json_is_read_by_the_port_and_plan_accepts_it():
    ref = ref_cal.CalibrationRecord.from_measurements(
        "tpu_v5e", _ref_problem_dict(),
        _measurements(ref_cal.CandidateMeasurement))
    port = cal.CalibrationRecord.from_json(ref.to_json())
    assert port.to_json() == ref.to_json()
    assert cal.CalibrationRecord.from_json(port.to_json()) == port
    assert port.measurements == tuple(_measurements(cal.CandidateMeasurement))
    p = api.plan(_problem(), calibration=port)
    assert p.calibration == {"hw": "tpu_v5e", "compute": ref.compute,
                             "traffic": ref.traffic}
    # the reference's own backend names price nothing here; a name both
    # packages register (codegen) takes its factors
    p0 = {c.key: c for c in api.plan(_problem()).candidates}
    for c in p.candidates:
        factor = ref.traffic["codegen"] if c.backend == "codegen" else 1.0
        assert c.t_traffic == pytest.approx(p0[c.key].t_traffic * factor)
        if c.backend != "codegen":
            assert c.t_per_step == pytest.approx(c.t_model)


def test_port_record_json_is_read_by_the_reference():
    rec = api.calibrate(_problem(grid=(48, 48), steps=4), top_k=2,
                        backends=["cuda"], device="cpu")
    assert rec.version == cal.CALIBRATION_VERSION
    assert rec.hw == "h100_sxm"
    ref = ref_cal.CalibrationRecord.from_json(rec.to_json())
    assert ref.to_json() == rec.to_json()
    assert ref.compute == rec.compute and ref.traffic == rec.traffic
    p = ref_api.plan(ref_api.StencilProblem(ref_ss.box(2, 1, seed=0),
                                            (48, 48), steps=4),
                     calibration=ref)
    assert p.calibration["compute"] == rec.compute


def test_calibration_record_json_round_trip():
    prob = _problem(grid=(48, 48), steps=4)
    rec = api.calibrate(prob, top_k=2, backends=["torch"], device="cpu")
    assert rec.measurements and rec.compute["torch"] > 0
    assert rec.traffic["torch"] > 0
    again = api.CalibrationRecord.from_json(rec.to_json())
    assert again == rec
    assert again.to_json() == rec.to_json()


def test_calibration_record_version_guard():
    rec = cal.CalibrationRecord(version=cal.CALIBRATION_VERSION,
                                hw="h100_sxm", problem={}, compute={},
                                traffic={}, measurements=())
    d = json.loads(rec.to_json())
    d["version"] = 999
    with pytest.raises(ValueError, match="version"):
        cal.CalibrationRecord.from_json(json.dumps(d))


def test_scenario_problem_is_recorded_by_digest():
    spec = ss.star(2, 1, seed=1)
    grid = (32, 32)
    spec = spec.with_field(ss.random_coeff_field(grid, seed=1),
                           domain_mask=ss.random_domain_mask(grid, seed=2))
    prob = _problem(spec, grid=grid, steps=4)
    rec = api.calibrate(prob, top_k=1, backends=["cuda"], device="cpu")
    assert rec.problem["spec"]["scenario_digest"] == spec.scenario_digest()
    assert "coeff_field" not in rec.problem["spec"]
    assert api.CalibrationRecord.from_json(rec.to_json()) == rec


def test_measure_candidate_reports_positive_costs_and_wall_clock():
    prob = _problem(grid=(32, 32), steps=2)
    m = api.measure_candidate(prob, 2, "parallel", "torch", (32, 32),
                              wall=True, repeats=2, device="cpu")
    assert m.measured_flops > 0 and m.measured_bytes > 0
    assert m.modelled_flops > 0 and m.modelled_bytes > 0
    assert m.wall_s is not None and m.wall_s > 0


def test_calibrate_suite_pools_cells_into_one_record():
    rec = cal.calibrate_suite(names=("box2d_r1", "star3d_r1"), grid=(24, 24),
                              steps=4, backends=("torch",), top_k=1,
                              device="cpu")
    assert rec.problem["suite"] == ["box2d_r1", "star3d_r1"]
    assert set(rec.compute) == {"torch"}
    assert len(rec.measurements) == 2
    p = api.plan(_problem(), calibration=api.CalibrationRecord.from_json(
        rec.to_json()))
    assert p.calibration["compute"] == rec.compute


def test_calibration_entry_points_need_a_card_by_default():
    prob = _problem(grid=(16, 16), steps=2)
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        api.calibrate(prob, top_k=1, backends=["cuda"])
    with pytest.raises(RuntimeError, match="cuda"):
        api.measure_candidate(prob, 1, "parallel", "cuda", (16, 16))


# ---------------------------------------------------------------------------
# Calibration feeding back into plan()
# ---------------------------------------------------------------------------

def _synthetic_record(compute=None, traffic=None):
    return cal.CalibrationRecord(version=cal.CALIBRATION_VERSION,
                                 hw="h100_sxm", problem={},
                                 compute=dict(compute or {}),
                                 traffic=dict(traffic or {}),
                                 measurements=())


def test_calibration_reranks_the_candidate_table():
    """box2d_r1 at 256^2 is compute-bound for the eager backends, so
    uncalibrated the higher-efficiency codegen beats torch; a 3x flops
    factor on codegen flips the decision."""
    prob = _problem(grid=(256, 256), steps=16)
    p0 = api.plan(prob, backends=["torch", "codegen"])
    assert p0.backend == "codegen"
    assert p0.calibration is None
    rec = _synthetic_record(compute={"codegen": 3.0})
    p1 = api.plan(prob, backends=["torch", "codegen"], calibration=rec)
    assert p1.backend == "torch"
    assert p1.calibration == {"hw": "h100_sxm", "compute": {"codegen": 3.0},
                              "traffic": {}}
    # the uncalibrated score is kept per row
    ch = p1.chosen()
    assert ch.t_model == pytest.approx(ch.t_per_step)  # torch: no factor
    top_codegen = next(c for c in p1.ranked() if c.backend == "codegen")
    assert top_codegen.t_per_step > top_codegen.t_model
    # and the calibrated plan round-trips
    assert api.ExecutionPlan.from_json(p1.to_json()) == p1


def test_real_measured_record_changes_ranking_terms():
    """A record counted off executed torch chunks scales the table: the
    eager path's counted traffic (pads, Toeplitz products, partial sums)
    is far above the tile model."""
    prob = _problem(grid=(64, 64), steps=6)
    rec = api.calibrate(prob, top_k=2, backends=["torch"], device="cpu")
    assert rec.traffic["torch"] > 1.0
    p0 = api.plan(prob, backends=["torch"])
    p1 = api.plan(prob, backends=["torch"], calibration=rec)
    c0 = {c.key: c for c in p0.candidates}
    for c in p1.candidates:
        assert c.t_traffic == pytest.approx(
            c0[c.key].t_traffic * rec.traffic["torch"])
        assert c.t_model == pytest.approx(c0[c.key].t_per_step)


def test_calibrated_plan_never_outranks_a_strict_dominator():
    """Calibration is a positive per-key rescaling: if candidate A
    dominates B on every uncalibrated per-step term under one factor key,
    no record may rank B above A."""
    prob = _problem(ss.star(2, 2, seed=3), grid=(96, 96), steps=8)
    backends = ["torch", "codegen", "cuda"]
    p0 = api.plan(prob, backends=backends)
    rec = _synthetic_record(
        compute={"torch": 2.5, "codegen": 7.0, "cuda": 1.3,
                 "cuda:inkernel": 0.6},
        traffic={"torch": 31.0, "codegen": 1.5, "cuda": 3.0,
                 "cuda:inkernel": 1.1})
    p1 = api.plan(prob, backends=backends, calibration=rec)
    cal_rows = {c.key: c for c in p1.candidates}
    raw = list(p0.candidates)
    assert set(cal_rows) == {c.key for c in raw}
    checked = 0
    for a in raw:
        for b in raw:
            if a.key == b.key or cal.factor_key(a.backend, a.strategy) \
                    != cal.factor_key(b.backend, b.strategy):
                continue
            if (a.t_compute / a.depth <= b.t_compute / b.depth
                    and a.t_traffic / a.depth <= b.t_traffic / b.depth
                    and a.t_comm / a.depth <= b.t_comm / b.depth
                    and a.depth >= b.depth):
                checked += 1
                assert cal_rows[a.key].t_per_step <= \
                    cal_rows[b.key].t_per_step * (1 + 1e-12), (a.key, b.key)
    assert checked > 0


def test_calibrate_measures_inkernel_factors_separately():
    assert cal.factor_key("cuda") == "cuda"
    assert cal.factor_key("cuda", "inkernel") == "cuda:inkernel"
    prob = api.StencilProblem(ss.PAPER_SUITE()["box2d_r1"], (32, 32),
                              boundary="periodic", steps=4)
    rec = api.calibrate(prob, top_k=2, backends=["cuda"], fuse=2,
                        fuse_strategy="inkernel", device="cpu")
    assert "cuda:inkernel" in rec.compute
    assert all(m.strategy == "inkernel" for m in rec.measurements)
    assert api.CalibrationRecord.from_json(rec.to_json()) == rec
    # the factors feed back into the matching rows only
    p = api.plan(prob, fuse=2, backends=["cuda"], calibration=rec)
    for c in p.candidates:
        expect = (rec.traffic["cuda:inkernel"]
                  if c.strategy == "inkernel" else 1.0)
        uncal = api.candidate_cost(prob, c.depth, c.option, c.backend,
                                   block=c.block, strategy=c.strategy)
        assert c.t_traffic == pytest.approx(uncal.t_traffic * expect)


# ---------------------------------------------------------------------------
# What a chunk executes
# ---------------------------------------------------------------------------

def test_periodic_operator_chunk_counts_its_pad_inkernel_chunk_none():
    """A periodic operator chunk hands the step kernel the unpadded state,
    as the in-kernel chunk hands the sweep kernel: both kernels read the
    periodic halo through wrapped indices, so neither chunk pads, and
    both counts stay near the model (one kernel read and write)."""
    prob = _problem(ss.PAPER_SUITE()["box2d_r1"], grid=(64, 256), steps=4)
    kw = dict(device="cpu")
    op = api.measure_candidate(prob, 2, "minimal", "cuda", (32, 128), **kw)
    ink = api.measure_candidate(prob, 2, "minimal", "cuda", (32, 128),
                                strategy="inkernel", **kw)
    assert 1.0 <= op.measured_bytes / op.modelled_bytes < 1.2
    assert 1.0 <= ink.measured_bytes / ink.modelled_bytes < 1.2
    # the compute counts are the kernels' FMAs, as modelled
    assert op.measured_flops == pytest.approx(op.modelled_flops)
    assert ink.measured_flops == pytest.approx(ink.modelled_flops)

    eng = api.StencilEngine(prob.spec, option="minimal", backend="cuda",
                            block=(32, 128), boundary="periodic",
                            device="cpu")
    x = torch.zeros(prob.grid)
    _, c_op = analyze_ops(lambda v: eng._apply_chunk(v, 2, "operator"), x)
    _, c_ink = analyze_ops(lambda v: eng._apply_chunk(v, 2, "inkernel"), x)
    assert c_op.ops == {} and c_op.kernels == {"stencil_step": 1}
    assert c_ink.ops == {} and c_ink.kernels == {"stencil_sweep": 1}


def test_step_wrapper_counts_equal_its_launch_geometry():
    spec = ss.PAPER_SUITE()["star2d_r2"]
    plan = sm.build_kernel_plan(spec, cl.make_cover(spec, "orthogonal"),
                                (16, 32), batch=2)
    x = torch.randn(2, 32 + 4, 64 + 4)
    _, cost = analyze_ops(sm.stencil_cuda_call, x, plan)
    blocks = 2 * (32 // 16) * (64 // 32)
    taps = 9
    table = 4 * len(sm.tap_runs(plan.taps)) + taps
    assert cost.kernels == {"stencil_step": 1}
    assert cost.kernel_fmas == taps * 2 * 32 * 64
    assert cost.kernel_bytes == blocks * ((16 + 4) * (32 + 4) * 4
                                          + table * 4) + 2 * 32 * 64 * 4
    assert cost.dot_flops == 2 * cost.kernel_fmas
    assert cost.op_bytes == 0 and cost.ops == {}   # plain version unseen


def test_sweep_wrapper_counts_recomputed_rings_and_aux_per_step():
    grid = (40, 50)
    spec = ss.PAPER_SUITE()["star2d_r1"].with_field(
        ss.random_coeff_field(grid, seed=1),
        domain_mask=ss.random_domain_mask(grid, seed=2))
    block, steps = (16, 32), 2
    plan = sm.build_sweep_kernel_plan(spec, cl.make_cover(spec, "parallel"),
                                      block, steps, wrap=True)
    aux = [torch.rand(sm.sweep_aux_shape(grid, plan)) for _ in range(2)]
    x = torch.randn(grid)
    _, cost = analyze_ops(sm.sweep_cuda_call, x, plan, aux)
    blocks = 3 * 2                      # ragged tiles: ceil(40/16) x ceil(50/32)
    live = 18 * 34 + 16 * 32            # step 0 recomputes a ring of r = 1
    table = 4 * len(sm.tap_runs(plan.taps)) + 5
    assert cost.kernel_fmas == 5 * live * blocks
    assert cost.kernel_bytes == blocks * ((16 + 4) * (32 + 4) * 4
                                          + 2 * live * 4 + table * 4) \
        + 40 * 50 * 4
    assert cost.op_bytes == 0


def test_counts_ignore_views_and_count_copies():
    x = torch.zeros(8, 16)

    def fn(v):
        w = v[:, 2:10]                   # a view: nothing moves
        return w.contiguous() + 1.0      # a copy and an add

    _, cost = analyze_ops(fn, x)
    assert cost.op_bytes == (8 * 8 * 4) * 2 + (8 * 8 * 4) * 2
    assert cost.kernels == {}
    _, mm = analyze_ops(torch.mm, torch.ones(4, 6), torch.ones(6, 5))
    assert mm.dot_flops == 2 * 4 * 6 * 5
    assert np.isclose(mm.op_flops, mm.dot_flops)
