"""Measured-cost calibration for the planner.

``plan()`` ranks (cover x backend x fuse x block) candidates with a purely
analytic roofline; this module confronts that model with what a chunk
really executes and feeds the discrepancy back:

  * :func:`measure_candidate` builds ONE candidate of a problem (the chunk
    at its depth/cover/backend/block/strategy, exactly as ``compile_plan``
    runs it), runs it once to build its caches, then counts a second run
    (:func:`repro_torch.launch.op_analysis.analyze_ops`: the kernels'
    FMAs and bytes from their launch geometry, every other op's operands
    and results) and optionally times it: on the card with CUDA events, a
    warm-up and the median of ``repeats``; on the CPU with the host clock
    (which only the tests read).
  * :func:`calibrate` measures a plan's top-K candidates and freezes the
    per-(backend, strategy) ``counted/modelled`` ratios into a
    :class:`CalibrationRecord` — frozen and JSON-round-trippable, in the
    JAX package's JSON shape, so either package reads the other's records
    (factors keep the measuring package's backend names; a factor for a
    backend this package lacks rescales nothing).
  * ``plan(problem, calibration=record)`` then re-ranks the cost table:
    the compute factor divides the backend's modelled efficiency, the
    traffic factor scales ``t_traffic``.  ``wall_s`` is evidence in the
    record, not a factor.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card the default raises.

    record = calibrate(problem, top_k=3, wall=True, backends=["cuda"])
    p = plan(problem, calibration=record)
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.engine import StencilEngine, resolve_device
from repro_torch.core.planner import (StencilProblem, candidate_cost, plan,
                                      factor_key as _factor_key)
from repro_torch.core.stencil_spec import PAPER_SUITE
from repro_torch.launch.op_analysis import analyze_ops

__all__ = ["CandidateMeasurement", "CalibrationRecord", "measure_candidate",
           "calibrate", "calibrate_suite", "factor_key",
           "CALIBRATION_VERSION"]

#: The record schema shared with the JAX package.
CALIBRATION_VERSION = 2

# THE key format lives beside its reader (planner._calib_factor); this
# module only re-exports it for record construction.
factor_key = _factor_key


@dataclasses.dataclass(frozen=True)
class CandidateMeasurement:
    """Modelled-vs-counted costs of one executed candidate chunk.

    ``modelled_*`` are the planner's raw roofline terms (per chunk over
    the grid and the batch, from :func:`candidate_cost`); ``measured_*``
    are the counts of one executed chunk (``op_analysis``: 2 flops per
    kernel FMA plus matmul/convolution flops; the kernels' device-memory
    bytes plus every other op's).  ``wall_s`` is the chunk's median time
    on the device it ran on (None unless timing was requested).
    ``strategy`` records which temporal execution ran ("operator" fused
    operator | "inkernel" multi-step kernel).
    """
    depth: int
    option: str
    backend: str
    block: tuple[int, ...]
    modelled_flops: float
    modelled_bytes: float
    measured_flops: float
    measured_bytes: float
    wall_s: float | None = None
    strategy: str = "operator"


@dataclasses.dataclass(frozen=True)
class CalibrationRecord:
    """Frozen per-(backend, strategy) factors, with their evidence.

    Factor tables are keyed by :func:`factor_key` — the bare backend name
    for operator-strategy measurements, ``"backend:inkernel"`` for
    in-kernel ones.  ``compute[key]`` is the median counted/modelled flop
    ratio of that key's measurements (the planner divides the backend's
    efficiency by it); ``traffic[key]`` the median counted/modelled byte
    ratio (the planner multiplies ``t_traffic`` by it).  Factors are
    strictly positive, so calibration is a monotone per-key rescaling: it
    can re-rank backends and strategies against each other but never
    ranks a candidate above one that strictly dominates it within the same
    key — nor two tiles of one key against each other.

    ``problem`` is stored JSON-native (arrays as lists; :func:`calibrate`
    names scenario fields by their digest), so
    ``CalibrationRecord.from_json(r.to_json()) == r``.
    """
    version: int
    hw: str
    problem: dict                 # what was measured (cell metadata)
    compute: dict[str, float]     # key -> counted/modelled flops ratio
    traffic: dict[str, float]     # key -> counted/modelled bytes ratio
    measurements: tuple[CandidateMeasurement, ...]

    # -- construction ------------------------------------------------------
    @classmethod
    def from_measurements(cls, hw: str, problem: dict,
                          measurements: Sequence[CandidateMeasurement]
                          ) -> "CalibrationRecord":
        """Pool measurements into per-(backend, strategy) median factors."""
        compute: dict[str, float] = {}
        traffic: dict[str, float] = {}
        keys = sorted({factor_key(m.backend, m.strategy)
                       for m in measurements})
        for key in keys:
            ms = [m for m in measurements
                  if factor_key(m.backend, m.strategy) == key]
            fl = [m.measured_flops / m.modelled_flops for m in ms
                  if m.modelled_flops > 0 and m.measured_flops > 0]
            by = [m.measured_bytes / m.modelled_bytes for m in ms
                  if m.modelled_bytes > 0 and m.measured_bytes > 0]
            compute[key] = float(np.median(fl)) if fl else 1.0
            traffic[key] = float(np.median(by)) if by else 1.0
        return cls(version=CALIBRATION_VERSION, hw=hw,
                   problem=_json_native(problem), compute=compute,
                   traffic=traffic, measurements=tuple(measurements))

    # -- serialization (the JAX package's JSON shape) ----------------------
    def to_json(self, indent: int | None = None) -> str:
        d = dataclasses.asdict(self)
        d["measurements"] = [dict(dataclasses.asdict(m), block=list(m.block))
                             for m in self.measurements]
        return json.dumps(d, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "CalibrationRecord":
        d = json.loads(text)
        if d.get("version") != CALIBRATION_VERSION:
            raise ValueError(
                f"calibration version {d.get('version')!r} does not match "
                f"this code's CALIBRATION_VERSION={CALIBRATION_VERSION}; "
                f"re-run the calibration pass")
        d["measurements"] = tuple(
            CandidateMeasurement(**dict(m, block=tuple(m["block"])))
            for m in d["measurements"])
        return cls(**d)


def _json_native(d: dict) -> dict:
    """``d`` with arrays as lists (a problem's scenario fields)."""
    def default(o):
        if isinstance(o, (np.ndarray, np.generic)):
            return o.tolist()
        raise TypeError(f"{type(o).__name__} is not JSON serializable")
    return json.loads(json.dumps(d, default=default))


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def _median_s(fn, x, repeats: int, device: torch.device) -> float:
    """Median seconds of ``fn(x)`` after one warm-up: CUDA events on the
    card, the host clock on the CPU."""
    fn(x)
    ts = []
    for _ in range(max(1, repeats)):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(x)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(x)
            ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


def measure_candidate(problem: StencilProblem, depth: int, option: str,
                      backend: str, block: tuple[int, ...], *,
                      device="cuda", wall: bool = False, repeats: int = 3,
                      base_option: str | None = None,
                      strategy: str = "operator") -> CandidateMeasurement:
    """Run one candidate's chunk and count what it executes.

    The chunk is exactly what ``compile_plan`` runs: the engine's
    ``_apply_chunk`` at ``depth`` with ``strategy`` (fused operator
    re-covered with ``option``, or the in-kernel multi-step core over the
    base cover ``option``; boundary handling included), on a zero state of
    the problem's grid (with its batch axis when ``batch > 1``).  The
    first run builds the kernel plans, tap tables and scenario operands
    that every later call reuses; the second is counted
    (``op_analysis``), so the counts describe a steady-state chunk.
    """
    spec = problem.spec
    dev = resolve_device(device)
    # the base engine's cover must match compile_plan's (it prices the
    # zero-boundary strip fixups at depth>1, and for the in-kernel strategy
    # it IS the per-step cover): the pinned base_option if the plan had
    # one, the candidate's own cover for in-kernel/depth-1 rows, else the
    # same choose_cover default compile_plan uses
    if depth == 1 or strategy == "inkernel":
        base_opt = option
    else:
        base_opt = base_option or "auto"
    eng = StencilEngine(spec, option=base_opt, backend=backend,
                        block=tuple(block), boundary=problem.boundary,
                        device=dev)
    if depth > 1:
        if strategy == "inkernel":
            eng._chunk_fn(depth, strategy)
        else:
            eng.fused_engine(depth, option=option)

    def chunk(x):
        return eng._apply_chunk(x, depth, strategy)

    lead = (problem.batch,) if problem.batch > 1 else ()
    x = torch.zeros(lead + problem.grid,
                    dtype=getattr(torch, problem.dtype), device=dev)
    with torch.no_grad():
        chunk(x)                                  # builds the caches
        _, counted = analyze_ops(chunk, x)
        wall_s = _median_s(chunk, x, repeats, dev) if wall else None

    modelled = candidate_cost(problem, depth, option, backend, block=block,
                              base_option=base_option, strategy=strategy)
    return CandidateMeasurement(
        depth=depth, option=option, backend=backend, block=tuple(block),
        modelled_flops=float(modelled.mxu_flops),
        modelled_bytes=float(modelled.hbm_bytes),
        measured_flops=float(counted.dot_flops),
        measured_bytes=float(counted.traffic_bytes),
        wall_s=wall_s, strategy=strategy)


def _problem_meta(problem: StencilProblem) -> dict:
    """The record's ``problem``: the problem's description, except that
    scenario fields are named by their digest (a record stays small at a
    full grid)."""
    d = problem.to_dict()
    spec = d["spec"]
    if "coeff_field" in spec or "domain_mask" in spec:
        spec.pop("coeff_field", None)
        spec.pop("domain_mask", None)
        spec["scenario_digest"] = problem.spec.scenario_digest()
    return d


def calibrate(problem: StencilProblem, hw=None, *, top_k: int = 3,
              wall: bool = False, device="cuda",
              **plan_kwargs) -> CalibrationRecord:
    """Measure a problem's top-K planned candidates into a record.

    ``plan_kwargs`` pass through to :func:`repro_torch.core.planner.plan`
    (``backends=``, ``option=``, ``fuse=``, ...), so the measured set can
    be restricted to the backends worth running.  The record feeds
    straight back: ``plan(problem, calibration=calibrate(problem, ...))``.
    """
    p = plan(problem, hw, **plan_kwargs)
    ranked = p.ranked()[:max(1, top_k)]
    measurements = [
        measure_candidate(problem, c.depth, c.option, c.backend, c.block,
                          device=device, wall=wall,
                          base_option=plan_kwargs.get("option"),
                          strategy=c.strategy)
        for c in ranked]
    return CalibrationRecord.from_measurements(
        p.hw["name"], _problem_meta(problem), measurements)


def calibrate_suite(names: Sequence[str] = ("box2d_r1", "star2d_r2"),
                    grid: tuple[int, ...] = (96, 96), steps: int = 8,
                    backends: Sequence[str] = ("torch", "codegen"),
                    hw=None, top_k: int = 2, wall: bool = False,
                    device="cuda") -> CalibrationRecord:
    """One pooled record over a small PAPER_SUITE subset: a single
    :class:`CalibrationRecord` whose factors pool every (cell x
    candidate) measurement, serialized by the same ``to_json``."""
    suite = PAPER_SUITE()
    measurements: list[CandidateMeasurement] = []
    hw_name = None
    for name in names:
        spec = suite[name]
        # per-cell grid: truncate to the spec's dimensionality, or extend
        # with the last extent (e.g. (96, 96) -> (96, 96, 96) for 3-D)
        cell_grid = (tuple(grid[:spec.ndim]) if spec.ndim <= len(grid)
                     else tuple(grid) + (grid[-1],) * (spec.ndim - len(grid)))
        problem = StencilProblem(spec, cell_grid,
                                 boundary="periodic", steps=steps)
        p = plan(problem, hw, backends=list(backends))
        hw_name = p.hw["name"]
        for c in p.ranked()[:max(1, top_k)]:
            measurements.append(
                measure_candidate(problem, c.depth, c.option, c.backend,
                                  c.block, device=device, wall=wall,
                                  strategy=c.strategy))
    meta = {"suite": list(names), "grid": list(grid), "steps": int(steps),
            "backends": list(backends)}
    return CalibrationRecord.from_measurements(hw_name or "", meta,
                                               measurements)
