"""StencilEngine: plan (cover option x backend x block) -> executable update.

The paper leaves "a performance model ... to determine the optimal option"
as future work (§5.2); ``choose_cover`` supplies one — it scores every legal
cover by modelled outer-product count at the engine's block size and picks
the cheapest, which reproduces the paper's measured preferences (parallel
for r=1 stars and all boxes, orthogonal for high-order stars).

The full decision record lives in
:class:`repro_torch.core.planner.ExecutionPlan`; backends are pluggable
through :func:`register_backend` — ``torch`` / ``separable`` / ``codegen``
/ ``cuda`` are ordinary registry entries.

An engine runs on one device, ``"cuda"`` unless the caller asks for
another (the tests ask for ``"cpu"``, where the ``cuda`` backend's kernel
wrappers run their plain versions).  A tensor on another device raises
``ValueError``; on a machine without a card the default raises at
construction instead of carrying on on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.core import coefficient_lines as cl
from repro_torch.core import halo
from repro_torch.core import matrixization as mx
from repro_torch.core import temporal
from repro_torch.core.stencil_spec import StencilSpec
from repro_torch.runtime import trace

__all__ = ["StencilPlan", "StencilEngine", "choose_cover", "legal_covers",
           "default_block", "max_fuse_depth_for", "Backend",
           "register_backend", "get_backend", "backend_names",
           "resolve_device"]

Tensor = torch.Tensor


def default_block(spec: StencilSpec) -> tuple[int, ...]:
    """The engine's default output tile for a spec's dimensionality.

    Sized for a Hopper block's shared memory rather than a TPU tile: the
    minor extent is a multiple of a warp's 32 lanes (coalesced rows), and
    the haloed f32 slab stays small enough that a fused operator several
    orders deep still fits (2-D at r=1: 34*130*4 B = 17.7 KB; 3-D: 10*18*66*4
    B = 47.5 KB, against 227 KB a block may claim).
    """
    return (32, 128) if spec.ndim == 2 else (8, 16, 64)[:spec.ndim]


def resolve_device(device) -> torch.device:
    """A port entry point's device (the engine's, the LM serving path's);
    the default ``"cuda"`` raises when no card is present rather than
    silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run the plain kernel versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def max_fuse_depth_for(boundary: str, order: int, n_min: int) -> int:
    """Largest legal fused-chunk depth for a spatial extent and boundary.

    The single source of the feasibility formulas (the engine's sweep cap
    AND the planner's search cap — a depth the planner picks must never be
    one the execution layer rejects): 'periodic' wrap-padding needs halo
    <= extent; 'zero' strip splicing needs the two ``order*T`` strips to
    fit; 'valid' needs a non-empty output after the ``2*order*T`` shrink.
    """
    if boundary == "periodic":
        return max(1, n_min // order)
    if boundary == "zero":
        return max(1, n_min // (2 * order))
    return max(1, (n_min - 1) // (2 * order))


def legal_covers(spec: StencilSpec) -> list[str]:
    opts = ["parallel"]
    if spec.shape == "star":
        opts.append("orthogonal")
        if spec.ndim == 3:
            opts.append("hybrid")
    if spec.shape == "diagonal":
        opts.append("diagonal")
    if spec.ndim == 2:
        opts.append("minimal")
    return opts


def choose_cover(spec: StencilSpec, n: int) -> tuple[str, cl.LineCover]:
    """Performance-model cover selection: min modelled op count."""
    best = None
    for opt in legal_covers(spec):
        cover = cl.make_cover(spec, opt)
        cost = cl.cover_outer_product_count(cover, n)
        # The kernels read every tap from the shared-memory slab, so no
        # cover pays a strided-access penalty: raw op count is the model
        # (the same one the JAX package uses, so both pick the same cover).
        if best is None or cost < best[0]:
            best = (cost, opt, cover)
    return best[1], best[2]


@dataclasses.dataclass(frozen=True)
class StencilPlan:
    spec: StencilSpec
    option: str
    cover: cl.LineCover
    backend: str          # any registered backend name
    block: tuple[int, ...]
    unroll: tuple[int, ...]
    boundary: str         # "valid" | "zero" | "periodic"

    def op_count(self, n: int | None = None) -> int:
        return cl.cover_outer_product_count(self.cover, n or self.block[0])


# ---------------------------------------------------------------------------
# Backend registry.  A backend builder maps a StencilPlan to a VALID-mode
# core callable; the halo layer lifts it to the requested boundary.
# ``efficiency`` is the modelled fraction of the card's f32 peak the
# backend sustains (used by the planner's roofline scoring), and
# ``supports`` gates the backend per spec.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    builder: Callable[..., Callable[[Tensor], Tensor]]
    efficiency: float = 0.7
    supports: Callable[[StencilSpec], bool] = lambda spec: True
    uses_cover: bool = True   # False: execution ignores the line cover
    #                           (e.g. SVD-separable), so the planner scores
    #                           it once per fuse depth, not once per cover
    flops_model: Callable[[StencilSpec, tuple[int, ...]], int] | None = None
    #                           None: the planner prices the backend by the
    #                           cover's dense Toeplitz flops; otherwise
    #                           (spec, block) -> flops of one step
    sweep_builder: Callable[..., Callable[[Tensor], Tensor]] | None = None
    #                           (plan, steps, **opts) -> a T-step valid-mode
    #                           core (shrinks each spatial axis by
    #                           2*steps*order) executing fuse_strategy=
    #                           "inkernel"; None: the backend only runs the
    #                           operator-fusion strategy
    smem_tiles: bool = False  # True: its kernels hold each haloed tile in
    #                           a block's shared memory, so the planner and
    #                           the fuse-depth chooser (its smem_gate) drop
    #                           fused operators whose tile does not fit
    wraps: bool = False       # True: builder and sweep_builder take
    #                           boundary="periodic" and then return a
    #                           shape-preserving core that reads the
    #                           periodic halo itself, so the engine does
    #                           not pad the state for it

    def effective_efficiency(self, compute_factors=None) -> float:
        """The backend's calibratable efficiency model: ``efficiency``
        divided by a measured/modelled flop ratio from ``compute_factors``
        (backend name -> ratio; missing entries or None leave it as
        modelled)."""
        if not compute_factors:
            return self.efficiency
        factor = float(compute_factors.get(self.name, 1.0))
        return self.efficiency / max(factor, 1e-9)


_BACKENDS: dict[str, Backend] = {}


def register_backend(name: str, builder: Callable, *,
                     efficiency: float = 0.7,
                     supports: Callable[[StencilSpec], bool] | None = None,
                     uses_cover: bool = True,
                     flops_model: Callable | None = None,
                     sweep_builder: Callable | None = None,
                     smem_tiles: bool = False,
                     wraps: bool = False,
                     overwrite: bool = False) -> Backend:
    """Register a stencil execution backend.

    ``builder(plan, **options) -> core`` must return a valid-mode update
    (shrinks each spatial axis by ``2 * plan.spec.order``).  The engine and
    the planner both dispatch through this table, so a registered backend
    is automatically enumerated, priced (``efficiency`` modelled fraction
    of peak, ``flops_model(spec, block)`` when its arithmetic is not the
    cover's dense Toeplitz products), gated per spec (``supports``), and
    compiled.  ``uses_cover=False`` marks backends whose execution ignores
    the line cover (scored once per depth/block instead of once per
    cover).  ``sweep_builder(plan, steps, **opts)`` optionally supplies an
    in-kernel temporal-blocking core; registering one makes the backend
    eligible for the planner's ``fuse_strategy="inkernel"`` candidates.
    ``opts`` carries the shared-memory ``scratch`` policy
    (``temporal.SCRATCH_MODES``) and the core's ``boundary`` ('valid':
    shrink by ``2 * steps * order``; 'periodic': keep the shape and read
    the halo in the kernel) — accept ``**opts`` so new options stay
    backward-compatible.  ``smem_tiles=True`` marks kernels that keep the
    haloed tile in shared memory (fused operators are then gated by
    ``matrixization.step_smem_bytes``).  ``wraps=True``: both builders
    also take ``boundary="periodic"`` and then return a
    shape-preserving core reading the periodic halo itself; the engine
    uses it instead of padding the state for the valid-mode core.

    Raises ``ValueError`` on duplicate names unless ``overwrite=True``.
    """
    if name in _BACKENDS and not overwrite:
        raise ValueError(f"backend {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    be = Backend(name=name, builder=builder, efficiency=float(efficiency),
                 supports=supports or (lambda spec: True),
                 uses_cover=uses_cover, flops_model=flops_model,
                 sweep_builder=sweep_builder, smem_tiles=smem_tiles,
                 wraps=wraps)
    _BACKENDS[name] = be
    return be


def get_backend(name: str) -> Backend:
    if name not in _BACKENDS:
        raise ValueError(f"unknown backend {name!r}; registered: "
                         f"{sorted(_BACKENDS)}")
    return _BACKENDS[name]


def backend_names() -> list[str]:
    return sorted(_BACKENDS)


def _torch_builder(plan: StencilPlan, **_opts) -> Callable:
    return functools.partial(mx.matrixized_apply, spec=plan.spec,
                             cover=plan.cover)


def _separable_builder(plan: StencilPlan, **_opts) -> Callable:
    return functools.partial(mx.separable_apply, spec=plan.spec)


def _codegen_builder(plan: StencilPlan, **_opts) -> Callable:
    from repro_torch.core.codegen import generate_update
    return generate_update(plan).fn


def _cuda_builder(plan: StencilPlan, *, boundary: str = "valid",
                  **_opts) -> Callable:
    from repro_torch.kernels import ops as kops
    return kops.cuda_backend_core(plan, boundary=boundary)


def _cuda_sweep_builder(plan: StencilPlan, steps: int, *,
                        scratch: str = "pingpong", boundary: str = "valid",
                        **_opts) -> Callable:
    from repro_torch.kernels import ops as kops
    return kops.cuda_sweep_core(plan, steps, scratch=scratch,
                                boundary=boundary)


# separable factors the CONSTANT Toeplitz operator through its SVD and
# codegen emits shift-add source from the constant taps — neither can
# express a per-point coefficient scale or a domain mask, so both are
# gated to constant dense specs.  torch (matrixized_apply) and cuda
# (aux-operand kernels) execute every spec kind.  The cuda kernels do one
# f32 FMA per non-zero tap, each fed by one shared-memory load: a Hopper
# SM loads 32 words from shared memory per clock against 128 FMAs, so the
# modelled efficiency is a quarter of the f32 peak.  Every efficiency here
# is a model, not a measurement; a measured ratio enters through
# ``planner.plan(calibration=...)``.
register_backend("torch", _torch_builder, efficiency=0.7)
register_backend("separable", _separable_builder, efficiency=0.75,
                 supports=lambda spec: spec.ndim == 2 and
                 spec.is_constant_dense,
                 uses_cover=False, flops_model=mx.separable_flops)
register_backend("codegen", _codegen_builder, efficiency=0.8,
                 supports=lambda spec: spec.is_constant_dense)
register_backend("cuda", _cuda_builder, efficiency=0.25,
                 flops_model=mx.tap_flops,
                 sweep_builder=_cuda_sweep_builder, smem_tiles=True,
                 wraps=True)


class StencilEngine:
    """Plan and execute a stencil update.

    Example:
        eng = StencilEngine(spec, option="auto", backend="cuda")
        y = eng(x)            # single step, x on the card
        y = eng.run(x, steps=100)

    For the full declarative pipeline (decision record with modelled costs,
    JSON-serializable plans) use ``repro_torch.api.plan`` /
    ``repro_torch.api.compile``; the engine is the execution substrate
    those build on.
    """

    def __init__(self, spec: StencilSpec, option: str = "auto",
                 backend: str = "torch", block: tuple[int, ...] | None = None,
                 unroll: tuple[int, ...] | None = None,
                 boundary: str = "valid", scratch: str = "pingpong",
                 device="cuda"):
        self.device = resolve_device(device)
        if block is None:
            block = default_block(spec)
        if option == "auto":
            option, cover = choose_cover(spec, block[0])
        else:
            cover = cl.make_cover(spec, option)
        if unroll is None:
            unroll = (1,) * spec.ndim
        self.plan = StencilPlan(spec=spec, option=option, cover=cover,
                                backend=backend, block=tuple(block),
                                unroll=tuple(unroll),
                                boundary=halo.check_boundary(boundary))
        self.scratch = temporal.check_scratch(scratch)
        self._core = self._build_core()
        self._fn = self._boundary_fn()
        # built-core caches: keys carry EVERY argument that changes the
        # built core beyond the engine's own frozen plan — fused_engine
        # keys the depth (the cover option is compatibility-checked and
        # rebuilt on mismatch), inkernel_core keys (depth, scratch policy,
        # boundary).
        self._fused_engines: dict[int, "StencilEngine"] = {}
        self._inkernel_cores: dict[tuple[int, str, str], Callable] = {}

    @classmethod
    def from_execution_plan(cls, eplan, device="cuda") -> "StencilEngine":
        """Compatibility constructor from a planner ``ExecutionPlan``."""
        return cls(eplan.spec, option=eplan.base_option, backend=eplan.backend,
                   block=eplan.block, unroll=eplan.unroll,
                   boundary=eplan.problem["boundary"], device=device)

    # -- construction -------------------------------------------------------
    def _build_core(self) -> Callable[[Tensor], Tensor]:
        """The valid-mode update via the backend registry; boundary handling
        is layered on by :meth:`_boundary_fn`."""
        backend = get_backend(self.plan.backend)
        if not backend.supports(self.plan.spec):
            raise ValueError(f"backend {backend.name!r} does not support "
                             f"{self.plan.spec.describe()}")
        return backend.builder(self.plan)

    def _shape_preserving(self, build: Callable[[str], Callable],
                          width: int) -> Callable[[Tensor], Tensor]:
        """``build(boundary)``'s core at the plan's boundary: at
        'periodic' the backend's own wrap core where it has one (the
        kernels read the halo through wrapped indices), else the
        valid-mode core lifted by the halo layer by ``width``."""
        plan = self.plan
        if plan.boundary == "periodic" and get_backend(plan.backend).wraps:
            return build("periodic")
        return halo.wrap_boundary(build("valid"), width, plan.spec.ndim,
                                  plan.boundary)

    def _boundary_fn(self) -> Callable[[Tensor], Tensor]:
        """The shape-preserving single-step update."""
        builder = get_backend(self.plan.backend).builder
        return self._shape_preserving(
            lambda b: self._core if b == "valid"
            else builder(self.plan, boundary=b), self.plan.spec.order)

    def _check_device(self, x: Tensor) -> None:
        if x.device.type != self.device.type or (
                self.device.index is not None
                and x.device.index != self.device.index):
            raise ValueError(f"input on device {x.device}, engine runs on "
                             f"device {self.device}")

    # -- execution -----------------------------------------------------------
    def __call__(self, x: Tensor) -> Tensor:
        self._check_device(x)
        return self._fn(x)

    def step_fn(self) -> Callable[[Tensor], Tensor]:
        return self.__call__

    def run(self, x: Tensor, steps: int) -> Tensor:
        """Multi-step evolution (requires a shape-preserving boundary)."""
        if self.plan.boundary == "valid":
            raise ValueError("multi-step needs boundary='zero'|'periodic'")
        self._check_device(x)
        for _ in range(steps):
            x = self._fn(x)
        return x

    # -- fused temporal sweep (paper §6 made executable) ---------------------
    def _legal_strategies(self) -> tuple[str, ...]:
        return (temporal.FUSE_STRATEGIES if self.supports_inkernel
                else ("operator",))

    def _strategy_set(self, strategy: str) -> tuple[str, ...]:
        """Validate a strategy pin and return the strategies to search."""
        if strategy == "auto":
            return self._legal_strategies()
        if strategy not in temporal.FUSE_STRATEGIES:
            raise ValueError(f"unknown fuse strategy {strategy!r}; choose "
                             f"from {temporal.FUSE_STRATEGIES + ('auto',)}")
        if strategy == "inkernel" and not self.supports_inkernel:
            raise ValueError(
                f"backend {self.plan.backend!r} registers no sweep_builder; "
                f"fuse_strategy='inkernel' needs one (see register_backend)")
        return (strategy,)

    def _choose(self, steps: int, strategies, max_depth: int = 8):
        be = get_backend(self.plan.backend)
        return temporal.choose_fuse_depth(
            self.plan.spec, steps, self.plan.block, max_depth=max_depth,
            strategies=strategies, boundary=self.plan.boundary,
            flops_model=be.flops_model, smem_gate=be.smem_tiles)

    def _resolve(self, steps: int, fuse: int | str, strategy: str,
                 grid: tuple[int, ...] | None = None) -> tuple[int, str]:
        """Fix the (chunk depth, strategy) pair for a sweep.

        fuse="auto" uses temporal.choose_fuse_depth — deliberately a
        simpler model than the planner's (block-level compute/traffic
        only).  A planned depth is honoured exactly because compile()
        passes it as an explicit schedule and never re-enters this chooser.

        The depth search is RESTRICTED to the strategies the pin allows,
        and with everything "auto" one chooser call decides both; ``grid``
        caps the depth by shape/boundary first.  For varying/masked specs
        the chooser also filters by :func:`temporal.fusion_legal`, so
        "auto" falls back to a legal pair on its own; an EXPLICITLY pinned
        illegal pair raises instead of silently running the
        constant-coefficient fused operator.
        """
        strategies = self._strategy_set(strategy)
        spec, boundary = self.plan.spec, self.plan.boundary
        chosen = None
        if fuse == "auto":
            dec = self._choose(steps, strategies)
            depth, chosen = dec.depth, dec.strategy
        else:
            depth = int(fuse)
            if depth < 1:
                raise ValueError(f"fuse depth must be >= 1, got {fuse}")
        capped = depth if grid is None else min(
            depth, max(steps, 1), self.max_fuse_depth(grid))
        if strategy != "auto":
            self._check_fusion_legal(capped, strategy)
            return capped, strategy
        if chosen is not None and capped == depth:
            return capped, chosen
        legal = [s for s in strategies
                 if temporal.fusion_legal(spec, boundary, s, capped)]
        if not legal:
            # an explicit depth pin that no strategy can run exactly
            self._check_fusion_legal(capped, strategies[0])
        if capped <= 1 or "inkernel" not in legal:
            return capped, "operator"
        dec = self._choose(capped, tuple(legal), max_depth=capped)
        try:
            return capped, dec.candidate(capped).strategy
        except KeyError:
            raise ValueError(
                f"no fuse strategy at depth {capped} fits the kernels' "
                f"shared memory at block {self.plan.block}; pin a smaller "
                f"depth or block") from None

    def _check_fusion_legal(self, depth: int, strategy: str) -> None:
        """Raise for a (strategy, depth) pair that is inexact for this
        spec/boundary — the regression gate against silently applying the
        constant-coefficient fused operator to a varying/masked spec."""
        if not temporal.fusion_legal(self.plan.spec, self.plan.boundary,
                                     strategy, depth):
            raise ValueError(
                f"fuse depth {depth} with strategy {strategy!r} is not "
                f"exact for {self.plan.spec.describe()} at boundary="
                f"{self.plan.boundary!r}; legal fallbacks: depth 1, or "
                f"strategy='inkernel' under 'valid'/'periodic'")

    def sweep(self, x: Tensor, steps: int, fuse: int | str = "auto",
              strategy: str = "auto") -> Tensor:
        """Advance ``steps`` applications via fused multi-step sweeps.

        Each chunk of ``T`` steps executes as ONE pass over the grid;
        device-memory traffic per chunk drops ~T-fold either way, and
        ``strategy`` picks how the chunk computes:

        * ``"operator"`` — ONE application of the T-fold self-correlated
          operator (``temporal.fuse_steps``), re-planned through this
          engine's backend (cover and kernel plan rebuilt for the fused
          higher-order spec; flops grow ``(2Tr+1)``-dense).
        * ``"inkernel"`` — T applications of the BASE operator inside one
          kernel with shared-memory intermediates (the backend's
          registered ``sweep_builder``; flops stay linear in T).
        * ``"auto"`` — the roofline model picks per chunk depth;
          ``fuse="auto"`` additionally picks T (``choose_fuse_depth``).

        Boundary semantics match ``steps`` sequential applications exactly:
        'valid' and 'periodic' compose exactly; 'zero' fuses the interior
        and splices sequentially-computed strips of width ``order*T`` at
        the boundary (both strategies share the same strip fixup).
        """
        if steps < 0:
            raise ValueError("steps >= 0")
        self._check_device(x)
        if steps == 0:
            return x
        grid = tuple(x.shape[x.ndim - self.plan.spec.ndim:])
        depth, strategy = self._resolve(steps, fuse, strategy, grid)
        for t in temporal.fuse_schedule(steps, depth):
            x = self._apply_chunk(x, t, strategy)
        return x

    def sweep_fn(self, steps: int, fuse: int | str = "auto",
                 grid: tuple[int, ...] | None = None,
                 strategy: str = "auto") -> Callable[[Tensor], Tensor]:
        """A closure over :meth:`sweep` with a static step count.

        The fuse depth and strategy (``"auto"`` included) are resolved
        HERE, at closure-build time.  Passing ``grid`` (the spatial
        extents) additionally freezes the shape-capped schedule and
        pre-builds the fused engines / in-kernel cores eagerly, so the
        first call does no planning work at all.
        """
        if steps < 0:
            raise ValueError("steps >= 0")
        if steps:
            depth, strategy = self._resolve(
                steps, fuse, strategy,
                tuple(grid) if grid is not None else None)
        else:
            depth, strategy = 1, "operator"
        schedule: list[int] | None = None
        if grid is not None:
            schedule = temporal.fuse_schedule(steps, depth)
            for t in set(schedule):
                if t > 1:
                    self._chunk_fn(t, strategy)

        def fn(x: Tensor) -> Tensor:
            self._check_device(x)
            if steps == 0:
                return x
            sched = schedule
            if sched is None:
                g = x.shape[x.ndim - self.plan.spec.ndim:]
                sched = temporal.fuse_schedule(
                    steps, min(depth, steps, self.max_fuse_depth(g)))
            for t in sched:
                x = self._apply_chunk(x, t, strategy)
            return x

        return fn

    def max_fuse_depth(self, grid: tuple[int, ...]) -> int:
        """Largest legal chunk depth for this spatial shape and boundary."""
        return max_fuse_depth_for(self.plan.boundary, self.plan.spec.order,
                                  min(grid))

    def fused_engine(self, t: int, option: str = "auto") -> "StencilEngine":
        """Engine for the fused t-step operator (cover + kernel re-planned).

        A cached engine is reused only if its cover is compatible with the
        request ('auto' accepts any; a pinned option rebuilds on mismatch).
        """
        eng = self._fused_engines.get(t)
        if eng is not None and option not in ("auto", eng.plan.option):
            eng = None
        if eng is None:
            eng = StencilEngine(temporal.fuse_steps(self.plan.spec, t),
                                option=option, backend=self.plan.backend,
                                block=self.plan.block,
                                boundary=self.plan.boundary,
                                scratch=self.scratch, device=self.device)
            self._fused_engines[t] = eng
        return eng

    @property
    def supports_inkernel(self) -> bool:
        """Whether this engine's backend registers an in-kernel sweep."""
        return get_backend(self.plan.backend).sweep_builder is not None

    def inkernel_core(self, t: int, scratch: str | None = None,
                      boundary: str = "valid") -> Callable[[Tensor], Tensor]:
        """The backend's t-step in-kernel temporal-blocking core (cached).

        At ``boundary="valid"`` a callable shrinking each spatial axis by
        ``2*t*order`` — the exact contract of the t-fused operator's core,
        so the halo layer and the Dirichlet-0 strip splice drive either
        interchangeably; at ``boundary="periodic"`` a shape-preserving
        update whose kernel reads the periodic halo itself (no padded
        copy).  ``scratch`` overrides the engine's shared-memory policy
        for this core; both are part of the cache key.
        """
        scratch = temporal.check_scratch(scratch or self.scratch)
        key = (t, scratch, halo.check_boundary(boundary))
        core = self._inkernel_cores.get(key)
        if core is None:
            be = get_backend(self.plan.backend)
            if be.sweep_builder is None:
                raise ValueError(
                    f"backend {self.plan.backend!r} registers no "
                    f"sweep_builder; fuse_strategy='inkernel' needs one")
            core = be.sweep_builder(self.plan, t, scratch=scratch,
                                    boundary=boundary)
            self._inkernel_cores[key] = core
        return core

    def _chunk_fn(self, t: int, strategy: str) -> Callable[[Tensor], Tensor]:
        """Shape-preserving t-step chunk update (boundary-lifted).

        Unknown strategies fail HERE with a ValueError (not a silent
        fall-through to operator fusion): this is the last gate every
        chunk execution passes, including strategies read back from a
        serialized plan.
        """
        if strategy not in temporal.FUSE_STRATEGIES:
            raise ValueError(f"unknown fuse strategy {strategy!r}; choose "
                             f"from {temporal.FUSE_STRATEGIES}")
        self._check_fusion_legal(t, strategy)
        if strategy == "inkernel":
            return self._shape_preserving(
                lambda b: self.inkernel_core(t, boundary=b),
                t * self.plan.spec.order)
        return self.fused_engine(t)._fn

    def _apply_chunk(self, x: Tensor, t: int,
                     strategy: str = "operator") -> Tensor:
        """One chunk of ``t`` steps: an ``engine.chunk`` span, the parent
        of the pads and launches it makes."""
        with trace.span("engine.chunk"):
            if t == 1:
                return self._fn(x)
            chunk_fn = self._chunk_fn(t, strategy)
            if self.plan.boundary == "zero":
                return self._zero_boundary_chunk(x, t, chunk_fn)
            return chunk_fn(x)

    def _zero_boundary_chunk(self, x: Tensor, t: int,
                             chunk_fn: Callable) -> Tensor:
        """Fused interior + sequential Dirichlet-0 boundary strips.

        The fused chunk (either strategy) equals the zero-EXTENDED
        evolution, which matches per-step clamping only at distance >= t*r
        from the boundary.  Each boundary strip of output width ``t*r`` is
        recomputed by ``t`` unfused steps over a ``2*t*r``-deep input strip:
        zero-padded on true boundaries (outer side + every other axis),
        valid-shrunk on the interior side, so the strip values are exactly
        the sequential ones.
        """
        spec = self.plan.spec
        r, nd = spec.order, spec.ndim
        rt = r * t
        lead = x.ndim - nd
        # the splice writes into a copy, so the chunk output (which a core
        # may hand back aliased) is never modified in place
        y = chunk_fn(x).clone()
        core = self._core
        for a in range(nd):
            axis = lead + a
            n_a = x.shape[axis]
            for side in (0, 1):
                w0 = 2 * rt  # guaranteed <= n_a by max_fuse_depth
                s = x.narrow(axis, 0 if side == 0 else n_a - w0, w0)
                for _ in range(t):
                    pads = [(r, r)] * nd
                    pads[a] = (r, 0) if side == 0 else (0, r)
                    s = core(halo.pad_trailing(s, pads, "zero"))
                y.narrow(axis, 0 if side == 0 else n_a - rt, rt).copy_(s)
        return y
