"""Declarative planning layer: ``StencilProblem -> plan() -> ExecutionPlan
-> compile()``.

The paper's §5.2 leaves "a performance model to determine the optimal
option" as future work.  This module IS that model, made first-class: one
cost function scores every enumerated (cover option x backend x fuse depth
x strategy x block) candidate with roofline terms (compute and
device-memory traffic on the card), and the winning decisions are frozen
into an :class:`ExecutionPlan` — a JSON-(de)serializable artifact that
records every choice WITH its modelled cost, renders the cost table via
:meth:`ExecutionPlan.explain`, and compiles to an executable with
:func:`compile_plan`.

Decisions recorded per plan:
  * ``option``       — coefficient-line cover of the (fused) operator; for
    ``fuse_strategy="inkernel"`` the cover of the BASE operator, applied at
    every in-kernel step
  * ``base_option``  — cover of the unfused operator (remainder chunks,
    Dirichlet-0 strip fixups)
  * ``backend``      — an entry of the engine's backend registry
  * ``block``        — output tile (one CUDA block's tile for the kernels)
  * ``fuse_depth`` / ``fuse_schedule`` — temporal chunking (paper §6)
  * ``fuse_strategy`` — "operator" (compose T steps into one radius-``T*r``
    stencil) | "inkernel" (T base-radius steps per kernel with
    shared-memory intermediates; only for backends registering a
    ``sweep_builder``).  Both carry the same 1-read/1-write-per-chunk
    traffic
  * ``halo_strategy`` — "none" (valid) | "pad" (single device) |
    "exchange" (mesh: ONE ``T*r``-deep exchange per fused chunk)
  * ``sharding``     — mesh shape/axes + grid axis mapping

Cost model (per fused sweep over the device-local grid, divided by the
chunk depth and the batch for a per-state-step figure):
  * t_compute = flops(block) * n_blocks
                / (peak_flops * backend.effective_efficiency(calibration))
                [+ the modelled Dirichlet-0 strip recompute surcharge];
                flops are the backend's ``flops_model`` (the Hopper kernels:
                one f32 FMA per non-zero tap) or the cover's dense Toeplitz
                products
  * t_traffic = block_hbm_bytes(block, T*r) * n_blocks / hbm_bw
                [* the backend's calibrated traffic factor]
  * t_comm    = 2 * T*r * (face area) * dtype_bytes / ici_bw  per sharded
                axis (one deep exchange per chunk; ``ici_bw`` is the
                card's NVLink rate each way)
The chosen candidate minimizes (max(t_compute, t_traffic, t_comm) +
launch) / (T * batch); ties break toward the higher-efficiency backend, then
lexicographically, so plans are deterministic.  Hardware constants come
from ``repro_torch.launch.mesh.H100_SXM``; tiles are gated by what the
kernels keep in a block's shared memory (``matrixization.step_smem_bytes``
/ ``sweep_feasible``) against one budget, ``TILE_SMEM_BUDGET`` (two
blocks per SM), so a plan never picks a tile the kernels cannot launch.

``calibration`` takes a measured
:class:`repro_torch.launch.calibrate.CalibrationRecord` (this package's or
the JAX package's, read by ``from_json``) or an equivalent factor
mapping.  Distributed planning (``StencilProblem(mesh=..., grid_axes=...)``
with a :class:`repro_torch.launch.mesh.DeviceMesh`) plans the
device-local block and compiles to the fused distributed stepper of
:mod:`repro_torch.core.distributed`.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import coefficient_lines as cl
from repro_torch.core import halo
from repro_torch.core import matrixization as mx
from repro_torch.core import temporal
from repro_torch.core.engine import (StencilEngine, backend_names,
                                     choose_cover, default_block, get_backend,
                                     legal_covers, max_fuse_depth_for,
                                     resolve_device)
from repro_torch.core.stencil_spec import StencilSpec, from_numpy
from repro_torch.runtime import trace

__all__ = ["StencilProblem", "CandidateCost", "ExecutionPlan",
           "CompiledStencil", "plan", "compile_plan", "candidate_cost",
           "candidate_blocks", "best_block", "batch_cost_curve",
           "max_profitable_batch", "serving_buckets", "factor_key",
           "FUSE_STRATEGIES", "PLAN_VERSION", "LAUNCH_OVERHEAD_S",
           "REFERENCE_BACKENDS", "TILE_SMEM_BUDGET"]

#: The plan schema shared with the JAX package's planner, so its plans
#: load here (:meth:`ExecutionPlan.from_json`).
PLAN_VERSION = 6

FUSE_STRATEGIES = temporal.FUSE_STRATEGIES

#: Modelled per-fused-chunk dispatch overhead (seconds): the host-side
#: launch of one chunk's kernel and its tap table, which one chunk pays
#: regardless of how many states it advances.  A modelled figure, not a
#: measurement; hardware specs may override it via ``launch_overhead_s``.
LAUNCH_OVERHEAD_S = 5e-6

#: Backend names of the JAX package and the port's counterparts, applied
#: when a plan of the JAX package is loaded here.
REFERENCE_BACKENDS = {"pallas": "cuda", "jnp": "torch"}

#: The span (:mod:`repro_torch.runtime.trace`) of one compiled call,
#: single-device or distributed
CALL_SPAN = "stencil.call"

#: Shared memory a plan lets one block claim (two blocks per SM), re-exported
#: from :mod:`matrixization`: the block search, fused-operator candidates
#: and in-kernel candidates are all gated on it.
TILE_SMEM_BUDGET = mx.TILE_SMEM_BUDGET


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Problem statement
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StencilProblem:
    """What to solve, declaratively — the planner decides how.

    Fields:
      spec: the stencil operator (:class:`repro_torch.core.stencil_spec
        .StencilSpec`; build one with ``api.box`` / ``api.star`` /
        ``api.diagonal`` / ``api.from_gather_coeffs``).
      grid: spatial extents, one per ``spec.ndim`` axis.
      dtype: a torch dtype name ("float32", "bfloat16"); prices the
        traffic terms and types the compiled executable's expected input.
      boundary: "periodic" | "zero" (Dirichlet-0) | "valid" (shrinking).
      steps: how many stencil applications ``compile(plan(...))`` advances
        per call (0 = identity; the fuse schedule covers them exactly).
      batch: how many independent states one compiled call advances
        together (a leading batch axis of the executable's input; the
        kernels' second grid dimension).
      mesh / grid_axes: set together or not at all.  ``mesh`` is a
        :class:`repro_torch.launch.mesh.DeviceMesh`; ``grid_axes`` names
        one mesh axis per spatial axis ('' for unsharded).  When set,
        planning is per device-local block and compile() emits the fused
        distributed stepper (one deep halo exchange per fused chunk).

    Example::

        problem = StencilProblem(api.star(2, 2), grid=(256, 256),
                                 boundary="periodic", steps=32)
        run = api.compile(api.plan(problem))      # on the card
    """

    spec: StencilSpec
    grid: tuple[int, ...]
    dtype: str = "float32"
    boundary: str = "periodic"
    steps: int = 1
    batch: int = 1
    mesh: Any | None = None
    grid_axes: tuple[str, ...] | None = None

    def __post_init__(self):
        halo.check_boundary(self.boundary)
        object.__setattr__(self, "grid", tuple(int(n) for n in self.grid))
        if len(self.grid) != self.spec.ndim:
            raise ValueError(f"grid {self.grid} has {len(self.grid)} axes for "
                             f"a {self.spec.ndim}-D spec")
        if self.steps < 0:
            raise ValueError("steps >= 0")
        object.__setattr__(self, "batch", int(self.batch))
        if self.batch < 1:
            raise ValueError("batch >= 1")
        for name, f in (("coeff_field", self.spec.coeff_field),
                        ("domain_mask", self.spec.domain_mask)):
            if f is not None and tuple(f.shape) != self.grid:
                raise ValueError(f"spec {name} shape {tuple(f.shape)} != "
                                 f"problem grid {self.grid} — scenario "
                                 f"fields live on the problem grid")
        if (self.mesh is None) != (self.grid_axes is None):
            raise ValueError("mesh and grid_axes must be given together")
        if self.mesh is not None and not self.spec.is_constant_dense:
            raise ValueError("distributed planning does not support "
                             "varying-coefficient or masked specs (the deep "
                             "halo exchange does not yet ship the scenario "
                             "fields); plan per device or drop the mesh")
        if self.grid_axes is not None:
            object.__setattr__(self, "grid_axes", tuple(self.grid_axes))
            if len(self.grid_axes) != self.spec.ndim:
                raise ValueError("grid_axes needs one entry per spatial axis")
            if self.boundary == "valid":
                raise ValueError("distributed problems need a "
                                 "shape-preserving boundary")
        _torch_dtype(self.dtype)  # validate

    @property
    def dtype_bytes(self) -> int:
        return _torch_dtype(self.dtype).itemsize

    def mesh_axis_sizes(self) -> dict[str, int]:
        if self.mesh is None:
            return {}
        return self.mesh.axis_sizes()

    def local_grid(self) -> tuple[int, ...]:
        """Per-slot spatial extents (== grid on a single device)."""
        if self.mesh is None:
            return self.grid
        sizes = self.mesh_axis_sizes()
        out = []
        for n, ax in zip(self.grid, self.grid_axes):
            d = sizes.get(ax, 1) if ax else 1
            if n % d:
                raise ValueError(f"grid extent {n} not divisible by mesh "
                                 f"axis {ax!r} of size {d}")
            out.append(n // d)
        return tuple(out)

    def to_dict(self) -> dict:
        """The numpy-level description: the spec's coefficients as lists,
        its scenario fields as arrays (``ExecutionPlan.to_json`` writes
        them as lists)."""
        spec_d = {"gather_coeffs": np.asarray(self.spec.gather_coeffs).tolist(),
                  "shape": self.spec.shape,
                  "coefficients": self.spec.coefficients}
        if self.spec.coeff_field is not None:
            spec_d["coeff_field"] = np.asarray(self.spec.coeff_field)
        if self.spec.domain_mask is not None:
            spec_d["domain_mask"] = np.asarray(self.spec.domain_mask, np.int8)
        return {
            "spec": spec_d,
            "grid": list(self.grid),
            "dtype": self.dtype,
            "boundary": self.boundary,
            "steps": int(self.steps),
            "batch": int(self.batch),
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "StencilProblem":
        """The problem of a ``to_dict()`` description — this package's or
        the JAX package's (fields as lists or arrays), with identical
        numbers."""
        return cls(from_numpy(d["spec"]), grid=tuple(d["grid"]),
                   dtype=d.get("dtype", "float32"),
                   boundary=d.get("boundary", "periodic"),
                   steps=int(d.get("steps", 1)), batch=int(d.get("batch", 1)))


# ---------------------------------------------------------------------------
# Cost records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CandidateCost:
    """Roofline model of one (fuse depth, strategy, cover, backend, block)
    candidate.

    ``t_compute`` / ``t_traffic`` / ``t_comm`` are the CALIBRATED seconds
    per fused sweep of the WHOLE batch over one slot's block (equal to
    the raw modelled terms when the plan carries no calibration;
    ``t_comm`` is 0 on one device);
    ``t_launch`` is the per-chunk dispatch overhead; ``t_per_step`` ranks
    the table and is normalized PER STATE per step:
    ``(max(compute, traffic, comm) + launch) / (depth * batch)``.
    ``t_model`` always holds the uncalibrated per-state-step score.
    ``mxu_flops`` keeps the plan schema's field name and holds the
    backend's modelled flops.  For "inkernel" rows ``option`` names the
    BASE cover applied at every step.
    """
    depth: int
    option: str
    backend: str
    block: tuple[int, ...]  # output tile this row was scored at
    mxu_flops: float        # per fused sweep over the grid (all states)
    hbm_bytes: float        # per fused sweep over the grid (all states)
    ici_bytes: float        # per fused chunk (deep halo exchange, all states)
    t_compute: float        # seconds per sweep
    t_traffic: float
    t_comm: float
    t_model: float          # UNcalibrated (max(c, t, m) + launch)/(depth*B)
    t_per_step: float       # calibrated (max(c, t, m) + launch)/(depth*B)
    strategy: str = "operator"
    batch: int = 1          # states advanced together (problem.batch)
    t_launch: float = LAUNCH_OVERHEAD_S   # per-chunk dispatch overhead

    @property
    def key(self) -> tuple:
        """Identity of the decision this row prices (table join key)."""
        return (self.depth, self.option, self.backend, self.block,
                self.strategy)


def _n_blocks(grid: Sequence[int], block: Sequence[int]) -> int:
    return int(np.prod([math.ceil(g / b) for g, b in zip(grid, block)]))


def _backend_efficiency(name: str) -> float:
    """Modelled efficiency, tolerant of plans shipped from a process that
    had other backends registered (explain() must not require them)."""
    try:
        return get_backend(name).efficiency
    except ValueError:
        return 0.0


def _selection_key(c: CandidateCost):
    """Deterministic total order: min bound cost; on a bound tie the
    least total resource use, then the higher-efficiency backend, then
    lexicographic."""
    return (c.t_per_step, (c.t_compute + c.t_traffic + c.t_comm) / c.depth,
            -_backend_efficiency(c.backend),
            c.depth, c.strategy, c.option, c.backend, c.block)


def factor_key(backend: str, strategy: str = "operator") -> str:
    """Calibration factor-table key for a (backend, fuse strategy) pair:
    the bare backend name for the operator strategy (also the fallback
    when no strategy-specific factor exists), ``"backend:strategy"``
    otherwise."""
    return backend if strategy == "operator" else f"{backend}:{strategy}"


def _calib_factor(table: Mapping, backend: str, strategy: str):
    """Measured factor for a (backend, strategy), falling back to the
    backend-wide (operator) factor when no strategy-specific one exists."""
    key = factor_key(backend, strategy)
    if key in table:
        return table.get(key)
    return table.get(backend)


def _step_flops(be, spec: StencilSpec, cover: cl.LineCover,
                block: tuple[int, ...]) -> float:
    """One step's flops on one block as the backend executes it."""
    if be.flops_model is not None:
        return float(be.flops_model(spec, block))
    return float(mx.toeplitz_flops(cover, block))


def _candidate(spec: StencilSpec, fspec: StencilSpec | None, depth: int,
               option: str, cover: cl.LineCover, backend: str,
               block: tuple[int, ...], grid: tuple[int, ...],
               sharded_axes: Sequence[int], boundary: str,
               base_flops: float, dtype_bytes: int, hw,
               calib: Mapping | None = None,
               strategy: str = "operator",
               batch: int = 1) -> CandidateCost:
    be = get_backend(backend)
    if strategy == "inkernel":
        # T base-radius steps in shared memory: flops linear in T (plus
        # the shrinking-halo overhead); ``cover`` is the BASE cover here
        flops_block = mx.inkernel_flops(
            lambda ext: _step_flops(be, spec, cover, ext), block, depth,
            spec.order) * batch
    else:
        flops_block = _step_flops(be, fspec, cover, block) * batch
    nb = _n_blocks(grid, block)
    flops = float(flops_block) * nb
    if boundary == "zero" and depth > 1:
        # Dirichlet-0 strip fixups: 2 strips per axis, each re-evolved by
        # `depth` unfused steps — modelled as that fraction of `depth` full
        # unfused sweeps; both strategies share the fixup, every batched
        # state pays it
        frac = min(1.0, 3 * depth * spec.order / min(grid))
        flops += 2 * spec.ndim * depth * frac * base_flops * batch
    # one T*r-deep haloed read + one write per chunk PER STATE — identical
    # traffic for both strategies (in-kernel intermediates stay on chip)
    bytes_hbm = batch * mx.block_hbm_bytes(block, depth * spec.order,
                                           dtype_bytes) * nb
    # varying/masked fields: read once per chunk alongside the state — f32,
    # haloed to the chunk depth, shared across all states
    n_aux = mx.n_aux_operands(spec)
    if n_aux:
        bytes_hbm += mx.aux_hbm_bytes(block, depth * spec.order, n_aux) * nb
    # masked-domain cover: tiles with no active point could skip their
    # work — modelled as the active-tile fraction (pricing only)
    active = mx.active_block_fraction(spec.domain_mask, block)
    if active < 1.0:
        flops *= active
        bytes_hbm *= active
    # one T*r-deep exchange per chunk: two strips per sharded axis, each
    # the block's face (every state of the batch)
    ici = 0.0
    for a in sharded_axes:
        face = float(np.prod([g for i, g in enumerate(grid) if i != a]))
        ici += 2 * depth * spec.order * face * dtype_bytes * batch
    t_launch = float(getattr(hw, "launch_overhead_s", LAUNCH_OVERHEAD_S))
    per = depth * batch
    t_compute_raw = flops / (hw.peak_flops * be.efficiency)
    t_traffic_raw = bytes_hbm / hw.hbm_bw
    t_comm = ici / hw.ici_bw if ici else 0.0
    if calib is not None:
        cfac = _calib_factor(calib.get("compute", {}), backend, strategy)
        eff = be.effective_efficiency(
            {backend: cfac} if cfac is not None else None)
        t_compute = flops / (hw.peak_flops * eff)
        tfac = _calib_factor(calib.get("traffic", {}), backend, strategy)
        t_traffic = t_traffic_raw * float(1.0 if tfac is None else tfac)
    else:
        t_compute, t_traffic = t_compute_raw, t_traffic_raw
    return CandidateCost(depth=depth, option=option, backend=backend,
                         block=tuple(block), strategy=strategy, batch=batch,
                         mxu_flops=flops, hbm_bytes=bytes_hbm, ici_bytes=ici,
                         t_compute=t_compute, t_traffic=t_traffic,
                         t_comm=t_comm, t_launch=t_launch,
                         t_model=(max(t_compute_raw, t_traffic_raw, t_comm)
                                  + t_launch) / per,
                         t_per_step=(max(t_compute, t_traffic, t_comm)
                                     + t_launch) / per)


# ---------------------------------------------------------------------------
# Block search
# ---------------------------------------------------------------------------

# Per-axis tile extents: the minormost axis a multiple of a warp's 32
# lanes (coalesced 128-byte rows of f32), the others small enough that a
# haloed slab of the tile stays within TILE_SMEM_BUDGET.
_TILE_EXTENTS = {
    2: ((8, 16, 32, 64, 128), (32, 64, 128, 256)),
    3: ((4, 8, 16), (8, 16, 32), (32, 64, 128)),
}


def _ranked_blocks(spec: StencilSpec, grid: Sequence[int], hw,
                   dtype_bytes: int, halo_width: int | None,
                   batch: int = 1
                   ) -> tuple[list[tuple[int, ...]], tuple[int, ...]]:
    """Shared enumeration for :func:`candidate_blocks` / :func:`best_block`:
    (every feasible tile in roofline-score order — best first, the clipped
    default block).  The batch is a grid dimension of the kernels, so it
    scales the score but not the feasibility bound."""
    nd = spec.ndim
    if halo_width is None:
        halo_width = spec.order
    default = tuple(min(b, int(g)) for b, g in zip(default_block(spec), grid))
    extents = _TILE_EXTENTS.get(nd)
    if extents is None:               # no tile table for this rank
        return [default], default
    sizes = [sorted({min(int(s), int(g)) for s in ext} | {d})
             for ext, g, d in zip(extents, grid, default)]
    blocks = {tuple(b) for b in itertools.product(*sizes)}
    blocks.add(default)
    feasible = sorted(
        b for b in blocks
        if mx.step_smem_bytes(b, halo_width) <= TILE_SMEM_BUDGET) or [default]

    def score(blk):
        # per state, per output: the kernels' f32 FMAs vs the haloed
        # traffic of one chunk at this tile
        t_c = batch * mx.tap_flops(spec, blk) / hw.peak_flops
        t_t = batch * mx.block_hbm_bytes(blk, halo_width,
                                         dtype_bytes) / hw.hbm_bw
        return max(t_c, t_t) / float(batch * np.prod(blk))

    return sorted(feasible, key=lambda b: (score(b), b)), default


def candidate_blocks(spec: StencilSpec, grid: Sequence[int], hw=None,
                     dtype_bytes: int = 4, *,
                     halo_width: int | None = None,
                     max_blocks: int = 4,
                     batch: int = 1) -> list[tuple[int, ...]]:
    """Candidate output tiles for the planner's block search.

    Enumerates the cartesian product of the per-axis tile extents (clipped
    to the grid), then prunes:

      1. *feasibility* — the f32 haloed slab (at ``halo_width``, default
         ``spec.order``) must fit :data:`TILE_SMEM_BUDGET`;
      2. *roofline score* — per output element, the max of the kernels'
         compute term and the haloed traffic term; only the best
         ``max_blocks`` tiles survive.

    The clipped ``default_block`` is always in the result.  Deterministic:
    the result is sorted and depends only on the arguments.
    """
    if hw is None:
        hw = _default_hw()
    ranked, default = _ranked_blocks(spec, grid, hw, dtype_bytes,
                                     halo_width, batch)
    keep = ranked[:max(1, int(max_blocks))]
    if default not in keep:
        keep[-1] = default
    return sorted(keep)


def best_block(spec: StencilSpec, grid: Sequence[int], hw=None,
               dtype_bytes: int = 4, *, halo_width: int | None = None,
               batch: int = 1) -> tuple[int, ...]:
    """The top-ranked tile of the block search (the kernel wrappers'
    default when no block is pinned — see ``kernels.ops``)."""
    if hw is None:
        hw = _default_hw()
    ranked, _ = _ranked_blocks(spec, grid, hw, dtype_bytes, halo_width,
                               batch)
    return ranked[0]


# ---------------------------------------------------------------------------
# ExecutionPlan — the frozen decision record
# ---------------------------------------------------------------------------

def _json_default(o):
    """Scenario fields ride the problem dict as arrays; JSON gets lists."""
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.generic):
        return o.item()
    raise TypeError(f"{type(o).__name__} is not JSON serializable")


def _from_reference(d: dict) -> dict:
    """Map a plan dict of the JAX package onto the port: backend names
    (``REFERENCE_BACKENDS``) in the decision, the cost table and the
    calibration factors, and the hardware record's peak key."""
    def rename(name: str) -> str:
        base, _, strat = name.partition(":")
        base = REFERENCE_BACKENDS.get(base, base)
        return f"{base}:{strat}" if strat else base

    d["backend"] = rename(d["backend"])
    d["candidates"] = [dict(c, backend=rename(c["backend"]))
                       for c in d["candidates"]]
    hw = dict(d["hw"])
    if "peak_flops" not in hw and "peak_flops_bf16" in hw:
        hw["peak_flops"] = hw.pop("peak_flops_bf16")
    d["hw"] = hw
    cal = d.get("calibration")
    if cal is not None:
        d["calibration"] = dict(
            cal, **{k: {rename(b): v for b, v in cal.get(k, {}).items()}
                    for k in ("compute", "traffic")})
    return d


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Every decision the planner made, with its modelled cost.

    Frozen and JSON-round-trippable: ``from_json(p.to_json()).to_json() ==
    p.to_json()``.  The plan is the unit of reproducibility — ship it,
    diff it, and load the JAX package's plans too (:meth:`from_json`).
    """

    version: int
    problem: dict
    hw: dict
    option: str            # cover of the fused operator at fuse_depth
    #                        (BASE cover when fuse_strategy="inkernel")
    base_option: str       # cover of the unfused operator
    backend: str
    block: tuple[int, ...]
    unroll: tuple[int, ...]
    fuse_depth: int
    fuse_schedule: tuple[int, ...]
    fuse_strategy: str     # "operator" | "inkernel"
    halo_strategy: str     # "none" | "pad"
    halo_width: int
    sharding: dict | None
    candidates: tuple[CandidateCost, ...]
    calibration: dict | None = None   # {"hw": str, "compute": {key:
    #   measured/modelled flops}, "traffic": {key: measured/modelled bytes}}

    # -- reconstruction ----------------------------------------------------
    @property
    def spec(self) -> StencilSpec:
        return from_numpy(self.problem["spec"])

    @property
    def steps(self) -> int:
        return int(self.problem["steps"])

    @property
    def batch(self) -> int:
        return int(self.problem.get("batch", 1))

    @property
    def boundary(self) -> str:
        return self.problem["boundary"]

    @property
    def grid(self) -> tuple[int, ...]:
        return tuple(self.problem["grid"])

    def chosen(self) -> CandidateCost:
        for c in self.candidates:
            if c.key == (self.fuse_depth, self.option, self.backend,
                         self.block, self.fuse_strategy):
                return c
        raise KeyError("chosen candidate missing from the cost table")

    def ranked(self) -> tuple[CandidateCost, ...]:
        """The cost table in selection order (best candidate first)."""
        return tuple(sorted(self.candidates, key=_selection_key))

    # -- serialization -----------------------------------------------------
    def to_json(self, indent: int | None = None) -> str:
        d = dataclasses.asdict(self)
        d["block"] = list(self.block)
        d["unroll"] = list(self.unroll)
        d["fuse_schedule"] = list(self.fuse_schedule)
        d["candidates"] = [dict(dataclasses.asdict(c), block=list(c.block))
                           for c in self.candidates]
        return json.dumps(d, indent=indent, default=_json_default)

    @classmethod
    def from_json(cls, text: str) -> "ExecutionPlan":
        """Load a plan of this package or of the JAX package (same schema
        version; its backend names are mapped by ``REFERENCE_BACKENDS``)."""
        d = json.loads(text)
        if d.get("version") != PLAN_VERSION:
            raise ValueError(f"plan version {d.get('version')!r} does not "
                             f"match this code's PLAN_VERSION={PLAN_VERSION};"
                             f" re-plan the problem")
        d = _from_reference(d)
        d["block"] = tuple(d["block"])
        d["unroll"] = tuple(d["unroll"])
        d["fuse_schedule"] = tuple(d["fuse_schedule"])
        d["candidates"] = tuple(
            CandidateCost(**dict(c, block=tuple(c["block"])))
            for c in d["candidates"])
        return cls(**d)

    # -- reporting ---------------------------------------------------------
    def schedule_str(self) -> str:
        if not self.fuse_schedule:
            return "[]"
        full = sum(1 for t in self.fuse_schedule if t == self.fuse_depth)
        rem = [t for t in self.fuse_schedule if t != self.fuse_depth]
        s = f"{self.fuse_depth}x{full}"
        if rem:
            s += "+" + "+".join(str(t) for t in rem)
        return s

    def explain(self, top: int = 8) -> str:
        """Human-readable decision record with the modelled cost table.

        One row per enumerated candidate, best first: ``depth`` fused-chunk
        length T, ``batch`` states advanced together, ``strat`` temporal
        strategy ("operator" | "inkernel"), ``coeff`` coefficient kind
        ("const" | "vary" | "mask" | "vary+mask"), ``cover`` line cover
        (of the BASE operator for inkernel rows), ``backend``, ``block``
        the tile the row was scored at, ``t_compute``/``t_traffic``/
        ``t_comm`` calibrated roofline seconds per fused sweep of the whole
        batch, ``t/model`` the uncalibrated and ``t/step`` the calibrated
        per-state-step score the ranking minimizes.

        For varying/masked specs a ``fusion legality`` line states which
        (strategy, depth) pairs were excluded and why.
        """
        p = self.problem
        spec = self.spec
        sh = self.sharding
        mesh_s = ("-" if sh is None else
                  "x".join(str(n) for n in sh["mesh_shape"]) + "("
                  + ",".join(a if a else "." for a in sh["grid_axes"]) + ")")
        ch = self.chosen()
        lines = [
            f"ExecutionPlan v{self.version}: {spec.describe()} | "
            f"grid={tuple(p['grid'])} {p['dtype']} | boundary={p['boundary']} "
            f"| steps={p['steps']} | batch={self.batch} | mesh={mesh_s}",
            f"hw {self.hw['name']}: {self.hw['peak_flops'] / 1e12:.0f} "
            f"TFLOP/s peak, {self.hw['hbm_bw'] / 1e9:.0f} GB/s device "
            f"memory, {self.hw['ici_bw'] / 1e9:.0f} GB/s link",
            f"chosen: backend={self.backend} cover={self.option} "
            f"(base {self.base_option}) block={self.block} "
            f"fuse={self.fuse_depth} strategy={self.fuse_strategy} "
            f"schedule={self.schedule_str()} "
            f"halo={self.halo_strategy} width={self.halo_width}",
            f"{'modelled' if self.calibration is None else 'calibrated'}"
            f"/state-step: "
            f"compute {ch.t_compute / (ch.depth * ch.batch):.3e}s, "
            f"traffic {ch.t_traffic / (ch.depth * ch.batch):.3e}s, "
            f"comm {ch.t_comm / (ch.depth * ch.batch):.3e}s, "
            f"launch {ch.t_launch / (ch.depth * ch.batch):.3e}s "
            f"-> {ch.t_per_step:.3e}s",
        ]
        if self.calibration is not None:
            cal = self.calibration
            facts = " ".join(
                f"{be}:x{cal['compute'].get(be, 1.0):.2f}/"
                f"x{cal['traffic'].get(be, 1.0):.2f}"
                for be in sorted(set(cal["compute"]) | set(cal["traffic"])))
            lines.append(f"calibrated ({cal.get('hw', '?')} measured, "
                         f"compute/traffic factors): {facts}")
        coeff_kind = ("const" if spec.is_constant_dense else "+".join(
            (["vary"] if spec.is_varying else [])
            + (["mask"] if spec.is_masked else [])))
        if not spec.is_constant_dense:
            ink = temporal.fusion_legal(spec, self.boundary, "inkernel", 2)
            lines.append(
                f"fusion legality ({coeff_kind}): operator depth>1 excluded "
                f"(per-step scale does not compose); inkernel depth>1 "
                + (f"legal at boundary={self.boundary!r}" if ink else
                   f"excluded at boundary={self.boundary!r} -> depth-1 "
                   f"fallback"))
        lines.append(
            "  rank depth batch strat    coeff     cover       backend     "
            "block        t_compute   t_traffic   t_comm      t/model     "
            "t/step")
        ranked = self.ranked()
        for i, c in enumerate(ranked[:top]):
            mark = "  <- chosen" if c.key == (
                self.fuse_depth, self.option, self.backend, self.block,
                self.fuse_strategy) else ""
            blk = "x".join(str(b) for b in c.block)
            lines.append(
                f"  {i + 1:4d} {c.depth:5d} {c.batch:5d} {c.strategy:<8s} "
                f"{coeff_kind:<9s} "
                f"{c.option:<11s} {c.backend:<11s} "
                f"{blk:<12s} "
                f"{c.t_compute:.3e}   {c.t_traffic:.3e}   {c.t_comm:.3e}   "
                f"{c.t_model:.3e}   {c.t_per_step:.3e}{mark}")
        if len(ranked) > top:
            lines.append(f"  ... {len(ranked) - top} more candidates")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# plan()
# ---------------------------------------------------------------------------

def _hw_dict(hw) -> dict:
    # launch_overhead_s is recorded even at its default: every term that
    # shaped the scores must be reconstructible from the plan JSON alone
    return {"name": hw.name, "peak_flops": float(hw.peak_flops),
            "hbm_bw": float(hw.hbm_bw), "ici_bw": float(hw.ici_bw),
            "hbm_bytes": float(hw.hbm_bytes),
            "launch_overhead_s": float(getattr(hw, "launch_overhead_s",
                                               LAUNCH_OVERHEAD_S))}


def _default_hw():
    from repro_torch.launch.mesh import H100_SXM
    return H100_SXM


def _sharded_axes(problem: StencilProblem) -> list[int]:
    if problem.grid_axes is None:
        return []
    sizes = problem.mesh_axis_sizes()
    return [i for i, ax in enumerate(problem.grid_axes)
            if ax and sizes.get(ax, 1) > 1]


def _base_stats(spec: StencilSpec, block: tuple[int, ...],
                grid: tuple[int, ...],
                option: str | None) -> tuple[str, float]:
    """(base cover, unfused-sweep flops) at one block — the shared
    plan()/candidate_cost() path, so the Dirichlet-0 strip surcharge (which
    is priced in unfused sweeps) cannot drift between the two."""
    base_option, base_cover = ((option, cl.make_cover(spec, option))
                               if option else choose_cover(spec, block[0]))
    base_flops = float(mx.toeplitz_flops(base_cover, block)) \
        * _n_blocks(grid, block)
    return base_option, base_flops


def _calibration_dict(calibration) -> dict | None:
    """Normalize plan()'s ``calibration`` input to the JSON-native summary
    stored on the plan: a ``CalibrationRecord``, an equivalent mapping
    (``{"hw": ..., "compute": {key: factor}, "traffic": {key: factor}}``),
    or None.  Duck-typed so ``core`` never imports ``launch``."""
    if calibration is None:
        return None
    if isinstance(calibration, Mapping):
        hw = calibration.get("hw", "")
        compute = calibration.get("compute", {})
        traffic = calibration.get("traffic", {})
    elif hasattr(calibration, "compute") and hasattr(calibration, "traffic"):
        hw = getattr(calibration, "hw", "")
        compute = calibration.compute
        traffic = calibration.traffic
    else:
        raise TypeError(f"calibration must be a CalibrationRecord or a "
                        f"mapping of factor tables, got "
                        f"{type(calibration).__name__}")
    return {"hw": str(hw),
            "compute": {k: float(v) for k, v in sorted(compute.items())},
            "traffic": {k: float(v) for k, v in sorted(traffic.items())}}


def _feasible_depth(boundary: str, r: int, n_min: int, steps: int) -> int:
    """Hard feasibility cap (shape + boundary + step count) — shared with
    the engine via :func:`repro_torch.core.engine.max_fuse_depth_for` so a
    planned depth is never one the execution layer rejects."""
    if steps <= 1:
        return 1
    return max(1, min(steps, max_fuse_depth_for(boundary, max(r, 1), n_min)))


def plan(problem: StencilProblem, hw=None, *,
         backends: Sequence[str] | None = None,
         option: str | None = None,
         fuse: int | None = None,
         fuse_strategy: str | None = None,
         block: tuple[int, ...] | None = None,
         max_depth: int = 4,
         max_blocks: int = 4,
         calibration=None) -> ExecutionPlan:
    """Enumerate (cover x backend x fuse x block x strategy) candidates,
    pick the min-cost one.

    ``option`` / ``backends`` / ``fuse`` / ``fuse_strategy`` / ``block``
    pin a decision instead of searching it (the pinned value still gets its
    cost modelled and recorded).  A pinned ``option`` constrains the
    UNFUSED operator; fused operators are re-covered per depth, exactly as
    the engine's sweep does (inkernel candidates keep the base cover).
    Without a ``block`` pin the search scores every tile from
    :func:`candidate_blocks` (at most ``max_blocks`` of them).  Inkernel
    candidates (``matrixization.sweep_feasible``) and fused operators of a
    backend whose kernels hold the tile in shared memory
    (``matrixization.step_smem_bytes``) are kept only where the tile's
    shared memory fits :data:`TILE_SMEM_BUDGET`, the block search's own
    bound.

    ``calibration`` re-ranks the table with per-(backend, strategy)
    factors (a ``CalibrationRecord`` or a mapping); the uncalibrated score
    is kept per row in ``CandidateCost.t_model``.
    """
    if hw is None:
        hw = _default_hw()
    spec = problem.spec
    r = spec.order

    names = list(backends) if backends is not None else backend_names()
    for nm in names:
        get_backend(nm)  # fail fast on unknown names
    if option is not None and option not in cl.COVER_OPTIONS:
        raise ValueError(f"unknown cover option {option!r}; choose from "
                         f"{list(cl.COVER_OPTIONS)}")
    if fuse_strategy is not None and fuse_strategy not in FUSE_STRATEGIES:
        raise ValueError(f"unknown fuse strategy {fuse_strategy!r}; choose "
                         f"from {FUSE_STRATEGIES}")
    strategies = (FUSE_STRATEGIES if fuse_strategy is None
                  else (fuse_strategy,))
    if fuse_strategy == "inkernel" and not any(
            get_backend(nm).sweep_builder is not None
            and get_backend(nm).supports(problem.spec) for nm in names):
        raise ValueError(
            f"fuse_strategy='inkernel' pinned but no backend in {names} "
            f"registers a sweep_builder supporting this spec "
            f"(see register_backend)")

    grid = problem.local_grid()
    sharded_axes = _sharded_axes(problem)
    calib = _calibration_dict(calibration)
    if block is not None:
        blocks = [tuple(int(b) for b in block)]
    else:
        blocks = candidate_blocks(spec, grid, hw, problem.dtype_bytes,
                                  max_blocks=max_blocks, batch=problem.batch)
    base_stats = {blk: _base_stats(spec, blk, grid, option) for blk in blocks}

    feasible = _feasible_depth(problem.boundary, r, min(grid), problem.steps)
    if fuse is not None:
        # a pin is checked against FEASIBILITY only — max_depth is a
        # search-enumeration width, not a legality bound
        if fuse < 1:
            raise ValueError(f"fuse depth must be >= 1, got {fuse}")
        if fuse > max(feasible, 1):
            raise ValueError(f"fuse depth {fuse} exceeds the shape/boundary "
                             f"cap {feasible} for grid {grid}")
        depths = [int(fuse)]
    else:
        depths = list(range(1, min(feasible, max_depth) + 1))

    fused_specs: dict[int, StencilSpec] = {1: spec}
    base_opts = [option] if option else legal_covers(spec)
    base_covers = {opt: cl.make_cover(spec, opt) for opt in base_opts}
    cands: list[CandidateCost] = []
    for t in depths:
        # depth 1 has no strategy (a chunk of one step IS the base
        # operator), so the baseline row is enumerated even under a
        # pinned-inkernel search.  fusion_legal gates BOTH branches: the
        # planner cannot emit an illegal pair.
        if ("operator" in strategies or t == 1) and \
                temporal.fusion_legal(spec, problem.boundary, "operator", t):
            fspec = fused_specs.get(t)
            if fspec is None:
                fspec = temporal.fuse_steps(spec, t)
                fused_specs[t] = fspec
            opts = [option] if (t == 1 and option) else legal_covers(fspec)
            for oi, opt in enumerate(opts):
                cover = cl.make_cover(fspec, opt)
                for nm in names:
                    be = get_backend(nm)
                    if not be.supports(fspec):
                        continue
                    if not be.uses_cover and oi > 0:
                        continue  # cover-free execution: one row per depth
                    for blk in blocks:
                        if be.smem_tiles and t > 1 and mx.step_smem_bytes(
                                blk, t * r) > TILE_SMEM_BUDGET:
                            continue
                        cands.append(_candidate(
                            spec, fspec, t, opt, cover, nm, blk, grid,
                            sharded_axes, problem.boundary,
                            base_stats[blk][1],
                            problem.dtype_bytes, hw, calib,
                            batch=problem.batch))
        if "inkernel" in strategies and t > 1 and \
                temporal.fusion_legal(spec, problem.boundary, "inkernel", t):
            # T base-radius steps per kernel: the cover is the BASE spec's
            # (re-applied every step); only backends with a registered
            # sweep_builder can execute it, at tiles the kernel can launch
            for oi, opt in enumerate(base_opts):
                cover = base_covers[opt]
                for nm in names:
                    be = get_backend(nm)
                    if be.sweep_builder is None or not be.supports(spec):
                        continue
                    if not be.uses_cover and oi > 0:
                        continue
                    for blk in blocks:
                        if not mx.sweep_feasible(blk, t, r,
                                                 limit=TILE_SMEM_BUDGET):
                            continue
                        cands.append(_candidate(
                            spec, None, t, opt, cover, nm, blk, grid,
                            sharded_axes, problem.boundary,
                            base_stats[blk][1],
                            problem.dtype_bytes, hw, calib,
                            strategy="inkernel", batch=problem.batch))
    if not cands:
        raise ValueError("no feasible (cover x backend x fuse x strategy) "
                         "candidate — check the backend/strategy pins "
                         "against the spec")

    best = min(cands, key=_selection_key)
    depth = best.depth if problem.steps else 1
    block = best.block
    base_option = base_stats[block][0]
    if depth == 1 or best.strategy == "inkernel":
        # depth 1: fused and unfused operator coincide; inkernel: the
        # chunk re-applies the base cover per step — either way the record
        # must match what compile() executes
        base_option = best.option
    schedule = tuple(temporal.fuse_schedule(problem.steps, depth))

    if problem.boundary == "valid":
        halo_strategy = "none"
    elif problem.mesh is not None:
        # the compiled stepper exchanges on EVERY named mesh axis (size-1
        # axes exchange with themselves, carrying no link traffic —
        # t_comm already reflects that), so the record matches the
        # executable
        halo_strategy = "exchange"
    else:
        halo_strategy = "pad"
    sharding = None
    if problem.mesh is not None:
        sharding = {"mesh_shape": list(problem.mesh.shape),
                    "mesh_axes": list(problem.mesh.axis_names),
                    "grid_axes": list(problem.grid_axes)}

    return ExecutionPlan(
        version=PLAN_VERSION,
        problem=problem.to_dict(),
        hw=_hw_dict(hw),
        option=best.option,
        base_option=base_option,
        backend=best.backend,
        block=block,
        unroll=(1,) * spec.ndim,
        fuse_depth=depth,
        fuse_schedule=schedule,
        fuse_strategy=best.strategy if depth > 1 else "operator",
        halo_strategy=halo_strategy,
        halo_width=depth * r,
        sharding=sharding,
        candidates=tuple(cands),
        calibration=calib,
    )


def candidate_cost(problem: StencilProblem, depth: int, option: str,
                   backend: str, hw=None,
                   block: tuple[int, ...] | None = None,
                   base_option: str | None = None,
                   strategy: str = "operator",
                   calibration=None) -> CandidateCost:
    """Model one candidate independently (the property-test entry point).

    ``base_option`` and ``calibration`` must match what was given to
    ``plan()`` (if anything) for the Dirichlet-0 strip surcharge and the
    calibrated terms to agree with the plan's own table — both paths share
    :func:`_base_stats` and :func:`_candidate`.  For
    ``strategy="inkernel"``, ``option`` names the BASE cover.
    """
    if hw is None:
        hw = _default_hw()
    spec = problem.spec
    grid = problem.local_grid()
    if block is None:
        block = tuple(min(b, g) for b, g in zip(default_block(spec), grid))
    block = tuple(int(b) for b in block)
    _, base_flops = _base_stats(spec, block, grid, base_option)
    if strategy == "inkernel":
        fspec, cover = None, cl.make_cover(spec, option)
    else:
        fspec = spec if depth == 1 else temporal.fuse_steps(spec, depth)
        cover = cl.make_cover(fspec, option)
    return _candidate(spec, fspec, depth, option, cover, backend, block,
                      grid, _sharded_axes(problem), problem.boundary,
                      base_flops,
                      problem.dtype_bytes, hw,
                      _calibration_dict(calibration), strategy=strategy,
                      batch=problem.batch)


# ---------------------------------------------------------------------------
# Serving admission: the batch bucket-cliff query
# ---------------------------------------------------------------------------

def serving_buckets(max_batch: int) -> list[int]:
    """The batch bucket sizes a serving loop compiles for a ``max_batch``
    cap: powers of two plus the cap itself, ascending."""
    if max_batch < 1:
        raise ValueError("max_batch >= 1")
    bs = [1]
    while bs[-1] * 2 < max_batch:
        bs.append(bs[-1] * 2)
    if max_batch > 1:
        bs.append(int(max_batch))
    return bs


def batch_cost_curve(problem: StencilProblem, max_batch: int, hw=None, *,
                     plan_fn: Callable | None = None,
                     **plan_kwargs) -> dict[int, float]:
    """Modelled per-STATE cost of ``problem`` at every serving bucket:
    ``{bucket: chosen t_per_step}`` (the problem's own ``batch`` is
    ignored).  Model-only: nothing is compiled.  ``plan_fn`` substitutes a
    custom planner; by default :func:`plan` runs with ``hw`` and
    ``plan_kwargs``."""
    if plan_fn is None:
        if hw is None:
            hw = _default_hw()

        def plan_fn(pb):
            return plan(pb, hw, **plan_kwargs)

    return {b: plan_fn(dataclasses.replace(problem, batch=b))
              .chosen().t_per_step
            for b in serving_buckets(max_batch)}


def max_profitable_batch(problem: StencilProblem, max_batch: int, hw=None, *,
                         rtol: float = 0.0,
                         plan_fn: Callable | None = None,
                         **plan_kwargs) -> int:
    """Largest serving bucket whose modelled per-state cost is within
    ``rtol`` of the :func:`batch_cost_curve` minimum — the admission cap
    for one shape group."""
    curve = batch_cost_curve(problem, max_batch, hw, plan_fn=plan_fn,
                             **plan_kwargs)
    best = min(curve.values())
    return max(b for b, t in curve.items() if t <= best * (1.0 + rtol))


# ---------------------------------------------------------------------------
# compile()
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompiledStencil:
    """An executable for one ExecutionPlan on one device or a mesh.

    ``fn(x)`` advances ``plan.steps`` applications (PyTorch runs eagerly:
    the schedule, covers and kernel plans are fixed here, the kernels
    build at their first launch); ``step`` is the single
    shape-preserving step where one exists.  A distributed plan carries
    its :class:`repro_torch.core.distributed.DistributedStepper` in
    ``stepper``; its ``fn`` takes a global tensor (sharded and gathered
    around the call) or a ``ShardedState`` on the stepper's mesh.
    """

    plan: ExecutionPlan
    fn: Callable
    step: Callable | None = None
    engine: StencilEngine | None = None
    stepper: Any | None = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def _check_plan_input(x, grid: tuple[int, ...], nd: int, batch: int,
                      exact_rank: bool = False) -> None:
    """Shared shape gate of every compiled executable's entry point.

    ``exact_rank`` is set by the distributed wrapper, whose blocks have a
    fixed rank: there an unplanned extra leading axis fails HERE with a
    clear error.  Single-device executables keep accepting ad-hoc leading
    axes at batch 1 (the engine cores are lead-polymorphic)."""
    if tuple(x.shape[x.ndim - nd:]) != grid:
        raise ValueError(f"input spatial shape "
                         f"{tuple(x.shape[x.ndim - nd:])} != planned "
                         f"grid {grid}")
    lead = tuple(x.shape[:x.ndim - nd])
    if batch > 1 and lead != (batch,):
        raise ValueError(f"plan expects a leading batch axis of "
                         f"{batch}, got input shape {tuple(x.shape)}")
    if batch <= 1 and exact_rank and lead:
        raise ValueError(f"plan was compiled without a batch axis; got "
                         f"input shape {tuple(x.shape)} with leading axes "
                         f"{lead} (plan with batch={lead[0]} to batch)")


def _compile_distributed(eplan: ExecutionPlan, mesh,
                         device) -> CompiledStencil:
    from repro_torch.core.distributed import make_fused_distributed_stepper
    from repro_torch.launch.mesh import make_mesh
    sh = eplan.sharding
    if mesh is None:
        resolve_device(device)
        mesh = make_mesh(sh["mesh_shape"], sh["mesh_axes"], devices=device)
    if list(mesh.axis_names) != list(sh["mesh_axes"]) or \
            list(mesh.shape) != list(sh["mesh_shape"]):
        raise ValueError(f"mesh {mesh.axis_names}{mesh.shape} does not "
                         f"match the plan's {sh}")
    for d in set(mesh.devices.flat):
        resolve_device(d)
    spec = eplan.spec
    batch = eplan.batch
    stepper = make_fused_distributed_stepper(
        spec, mesh, sh["grid_axes"], schedule=eplan.fuse_schedule,
        option=eplan.base_option,
        fused_option=eplan.option if eplan.fuse_depth > 1 else "auto",
        backend=eplan.backend, boundary=eplan.boundary, block=eplan.block,
        fuse_strategy=eplan.fuse_strategy,
        batch=batch if batch > 1 else None)

    def fn(x):
        # the same clear shape errors the single-device fn raises
        _check_plan_input(x, eplan.grid, spec.ndim, batch, exact_rank=True)
        # through the stepper's __call__: the host-side dist.* chaos
        # wrapper lives there (one global read unless a FaultPlan is
        # active; the work and its exchange census are identical)
        with trace.span(CALL_SPAN):
            return stepper(x)

    return CompiledStencil(plan=eplan, fn=fn, stepper=stepper)


def compile_plan(eplan: ExecutionPlan, mesh=None, *,
                 device="cuda") -> CompiledStencil:
    """Materialize an ExecutionPlan into an executable on ``device``
    (the card unless the caller asks for ``"cpu"``; without a card the
    default raises).

    Distributed plans (``sharding`` set) compile to the fused sharded
    stepper on ``mesh``: ONE ``T*r``-deep halo exchange per fused chunk.
    Without a ``mesh`` the recorded mesh shape is rebuilt with every slot
    on ``device``; a mesh of another shape or axis names raises
    ``ValueError``.
    """
    if eplan.fuse_strategy not in FUSE_STRATEGIES:
        raise ValueError(f"plan carries unknown fuse strategy "
                         f"{eplan.fuse_strategy!r}; choose from "
                         f"{FUSE_STRATEGIES}")
    if eplan.sharding is not None:
        return _compile_distributed(eplan, mesh, device)
    spec = eplan.spec
    batch = eplan.batch
    eng = StencilEngine(spec, option=eplan.base_option, backend=eplan.backend,
                        block=eplan.block, boundary=eplan.boundary,
                        device=device)
    strategy = eplan.fuse_strategy
    for t in set(eplan.fuse_schedule):
        if t > 1:
            if strategy == "inkernel":
                eng._chunk_fn(t, strategy)
            else:
                eng.fused_engine(t, option=eplan.option
                                 if t == eplan.fuse_depth else "auto")
    schedule = eplan.fuse_schedule
    grid = eplan.grid
    nd = spec.ndim

    def fn(x: torch.Tensor) -> torch.Tensor:
        _check_plan_input(x, grid, nd, batch)
        eng._check_device(x)
        with trace.span(CALL_SPAN):
            for t in schedule:
                x = eng._apply_chunk(x, t, strategy)
            return x

    step = eng.step_fn() if eplan.boundary != "valid" else None
    return CompiledStencil(plan=eplan, fn=fn, step=step, engine=eng)
