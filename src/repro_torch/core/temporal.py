"""Temporal fusion — the paper's §6 future work, done analytically.

The paper closes with "it is desirable to reuse data blocks over several
time steps ... a combination of the two techniques [matrixization +
temporal tiling] is our future work."  For constant-coefficient linear
stencils the combination has a closed form: T applications of a stencil
with gather taps ``C`` equal ONE application of the T-fold
self-correlation ``C^(*T)`` (order T*r).  One fused sweep then reads the
input once instead of T times — the memory-bound stencil's traffic drops
~T-fold at the cost of a larger (but still banded) coefficient line, i.e.
more arithmetic, which is exactly the trade the roofline favours.

Boundary semantics: exact for 'valid' (correlations compose freely with no
boundary in sight) and for 'periodic' at any size >= the fused extent
(wrap-around composition).  For 'zero' (Dirichlet-0) the fused operator is
exact only at distance >= T*r from the boundary: the unfused evolution
re-clamps the field to zero OUTSIDE the domain after every step, which the
single fused correlation cannot express.  ``StencilEngine.sweep`` therefore
splices sequentially-computed boundary strips of width T*r over the fused
interior (DESIGN.md §Temporal) — the fused-extent edge case every temporal
blocking scheme has to handle.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import matrixization as mx
# the scratch-mode registry lives with the residency model it
# parameterizes; re-exported next to the other temporal-blocking policy
# constants
from repro_torch.core.matrixization import SCRATCH_MODES, check_scratch
from repro_torch.core.stencil_spec import StencilSpec, from_gather_coeffs

__all__ = ["fuse_steps", "fused_flops_ratio", "fused_traffic_ratio",
           "inkernel_flops_ratio", "inkernel_traffic_ratio",
           "fuse_schedule", "FUSE_STRATEGIES", "SCRATCH_MODES",
           "check_scratch", "FuseCandidate", "FuseDecision",
           "choose_fuse_depth", "fusion_legal"]

#: The two executable temporal-blocking strategies: "operator" composes T
#: steps into one stencil of radius T*r (this module's fuse_steps);
#: "inkernel" runs T base-radius steps inside one kernel block with
#: shared-memory intermediates (kernels/stencil_mxu.sweep_cuda_call).
FUSE_STRATEGIES = ("operator", "inkernel")


def _correlate_full(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Full-mode n-D cross-correlation of gather tap tensors.

    Applying stencil B after stencil A equals applying taps
    ``(A *full* B)`` — gather offsets add, so the composed tap at offset o
    is sum over u+v=o of A[u]B[v] (a convolution of the offset-indexed
    taps; since both are stored offset-ascending this is plain full
    convolution of the arrays).
    """
    out_shape = tuple(sa + sb - 1 for sa, sb in zip(a.shape, b.shape))
    out = np.zeros(out_shape, dtype=np.float64)
    for idx in np.ndindex(*a.shape):
        sl = tuple(slice(i, i + sb) for i, sb in zip(idx, b.shape))
        out[sl] += a[idx] * b
    return out


def fusion_legal(spec: StencilSpec, boundary: str, strategy: str,
                 depth: int) -> bool:
    """Whether a (strategy, depth) temporal-blocking pair is EXACT.

    Depth <= 1 is always legal (it IS the sequential evolution), and
    constant-coefficient unmasked specs keep their existing rules (the
    engine layers boundary splicing on top).  For varying/masked specs the
    per-step scale does not commute with composition:

    - "operator" at depth > 1 is NEVER legal — the fused correlation
      ``C^(*T)`` would have to become a step-dependent product of scaled
      operators, which is no longer a shared Toeplitz band.
    - "inkernel" at depth > 1 IS legal for 'valid'/'periodic' — the kernel
      re-reads the band and re-applies the scale at every step, and the
      slab extension (none / wrap) matches the true evolution.  'zero' is
      illegal: the zero-extended strip splice assumes a position-
      independent operator.

    Every execution path funnels through this predicate (planner candidate
    table, engine resolve, fuse-depth chooser), so an illegal pair can be
    neither planned nor executed silently.
    """
    if depth <= 1:
        return True
    if spec.is_constant_dense:
        return True
    if strategy == "operator":
        return False
    return boundary in ("valid", "periodic")


def fuse_steps(spec: StencilSpec, steps: int) -> StencilSpec:
    """Spec whose single application equals ``steps`` applications.

    Only constant-coefficient unmasked specs compose — a varying or masked
    spec raises at ``steps > 1`` (see :func:`fusion_legal`) and passes
    through unchanged at ``steps == 1`` (its scenario fields must survive).
    """
    if steps < 1:
        raise ValueError("steps >= 1")
    if not spec.is_constant_dense:
        if steps > 1:
            raise ValueError(
                "operator fusion is not exact for varying-coefficient or "
                "masked specs: the per-step scale does not commute with "
                "correlation composition (use strategy='inkernel' or "
                "depth 1)")
        return spec
    c = np.asarray(spec.gather_coeffs, np.float64)
    acc = c
    for _ in range(steps - 1):
        acc = _correlate_full(acc, c)
    return from_gather_coeffs(acc, shape="box")


def fused_flops_ratio(spec: StencilSpec, steps: int, n: int = 128) -> float:
    """Op ratio fused/unfused for the parallel cover (napkin model):
    unfused: steps x (2r+1) lines of (n+2r) products;
    fused:   (2Tr+1) lines of (n+2Tr) products."""
    r = spec.order
    unfused = steps * (2 * r + 1) * (n + 2 * r)
    rt = steps * r
    fused = (2 * rt + 1) * (n + 2 * rt)
    return fused / unfused


def fused_traffic_ratio(steps: int) -> float:
    """Device-memory traffic ratio fused/unfused: one read+write instead
    of T."""
    return 1.0 / steps


def inkernel_flops_ratio(spec: StencilSpec, steps: int, n: int = 128) -> float:
    """Op ratio inkernel/unfused for the parallel cover (napkin model):
    unfused: steps x (2r+1) lines of (n+2r) products;
    inkernel: step s runs the SAME (2r+1)-line operator over the live slab
    of extent n + 2*(steps-1-s)*r — linear in T with only the shrinking-halo
    overhead, vs the operator-fused (2Tr+1)^d growth (fused_flops_ratio)."""
    r = spec.order
    unfused = steps * (2 * r + 1) * (n + 2 * r)
    inkernel = sum((2 * r + 1) * (n + 2 * (steps - 1 - s) * r + 2 * r)
                   for s in range(steps))
    return inkernel / unfused


def inkernel_traffic_ratio(steps: int) -> float:
    """Traffic ratio inkernel/unfused: identical to operator fusion —
    intermediates live in shared memory, one deep-haloed read + one write
    per chunk."""
    return fused_traffic_ratio(steps)


def fuse_schedule(steps: int, depth: int) -> list[int]:
    """Chunk ``steps`` applications into fused sweeps of ``depth`` steps.

    ``steps=7, depth=3 -> [3, 3, 1]``: full-depth chunks plus one remainder
    chunk so the total evolution is exactly ``steps`` applications.
    """
    if steps < 0 or depth < 1:
        raise ValueError(f"need steps >= 0, depth >= 1; got {steps}, {depth}")
    sched = [depth] * (steps // depth)
    if steps % depth:
        sched.append(steps % depth)
    return sched


# ---------------------------------------------------------------------------
# Fuse-depth chooser — the §5.2-style performance model applied to the §6
# trade: deeper fusion divides device-memory traffic by T
# (fused_traffic_ratio) but grows the fused operator's order to T*r and
# with it the arithmetic per sweep.  The roofline winner is whichever depth
# minimizes modelled time per ORIGINAL step.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FuseCandidate:
    """Roofline model of one (fuse depth, strategy) at a fixed block size."""
    depth: int
    option: str               # cover option (fused spec for "operator",
    #                           base spec for "inkernel" — applied per step)
    flops: int                # per output block, per fused sweep
    hbm_bytes: float          # per output block, per fused sweep (halo read + write)
    t_compute: float          # seconds per sweep, compute-bound
    t_traffic: float          # seconds per sweep, bandwidth-bound
    t_per_step: float         # max(t_compute, t_traffic) / depth
    traffic_reduction: float  # unfused bytes / fused bytes, per original step
    strategy: str = "operator"  # one of FUSE_STRATEGIES


@dataclasses.dataclass(frozen=True)
class FuseDecision:
    depth: int
    candidates: tuple[FuseCandidate, ...]
    strategy: str = "operator"

    def candidate(self, depth: int,
                  strategy: str | None = None) -> FuseCandidate:
        """The candidate at ``depth`` (the cheapest one when both strategies
        were enumerated and ``strategy`` is not pinned)."""
        found = [c for c in self.candidates if c.depth == depth
                 and (strategy is None or c.strategy == strategy)]
        if not found:
            raise KeyError((depth, strategy))
        return min(found, key=lambda c: c.t_per_step)


def choose_fuse_depth(spec: StencilSpec, steps: int,
                      block: tuple[int, ...] | None = None,
                      peak_flops: float | None = None,
                      hbm_bw: float | None = None,
                      dtype_bytes: int = 4,
                      max_depth: int = 8,
                      strategies: Sequence[str] = ("operator",),
                      *, boundary: str | None = None,
                      flops_model: Callable | None = None,
                      smem_gate: bool) -> FuseDecision:
    """Pick the (fuse depth T, strategy) minimizing modelled time per
    original step.

    Compute side: ``flops_model(spec, block)`` of the fused spec
    ("operator") or of the base spec at every in-kernel step's live extent
    ("inkernel"); without a ``flops_model`` the cover's dense Toeplitz
    flops (:func:`repro_torch.core.matrixization.toeplitz_flops`).  The
    engine passes its backend's model, so a kernel backend is priced by
    what its kernels execute.  Memory side: the per-sweep bytes scaled by
    :func:`fused_traffic_ratio`.  Hardware defaults come from
    ``repro_torch.launch.mesh.H100_SXM``.  Only the strategies the caller's
    backend can execute should be passed.

    In-kernel candidates must fit the sweep kernel
    (``matrixization.sweep_feasible``) and, with ``smem_gate`` (the
    backend's ``smem_tiles``: its kernels keep the tile in shared memory),
    fused operators must fit the step kernel
    (``matrixization.step_smem_bytes``), both within
    ``matrixization.TILE_SMEM_BUDGET`` — the same gates the planner
    applies, so an auto-chosen depth is never one the kernels cannot
    launch.

    ``boundary`` filters candidates through :func:`fusion_legal`; when not
    given, scenario specs assume the most conservative boundary ('zero' —
    depth 1 both strategies).  Varying/masked specs also price their
    per-sweep field re-read into the traffic side.
    """
    # deferred imports: engine imports us at module load
    from repro_torch.core.engine import choose_cover, default_block

    if steps < 1:
        raise ValueError("steps >= 1")
    for s in strategies:
        if s not in FUSE_STRATEGIES:
            raise ValueError(f"unknown fuse strategy {s!r}; choose from "
                             f"{FUSE_STRATEGIES}")
    if peak_flops is None or hbm_bw is None:
        from repro_torch.launch.mesh import H100_SXM
        peak_flops = H100_SXM.peak_flops if peak_flops is None else peak_flops
        hbm_bw = H100_SXM.hbm_bw if hbm_bw is None else hbm_bw
    block = tuple(block) if block is not None else default_block(spec)
    r = spec.order
    n_aux = mx.n_aux_operands(spec)
    eff_boundary = boundary if boundary is not None else "zero"

    def step_flops(s: StencilSpec, cover, blk) -> float:
        if flops_model is not None:
            return flops_model(s, blk)
        return mx.toeplitz_flops(cover, blk)

    base_bytes = mx.block_hbm_bytes(block, r, dtype_bytes) \
        + mx.aux_hbm_bytes(block, r, n_aux)          # one unfused sweep
    # the unfused cover: the per-step operator of every inkernel candidate
    # AND the t=1 baseline row (depth 1 has no strategy, so the baseline is
    # enumerated even under a pinned-inkernel search)
    base_option, base_cover = choose_cover(spec, block[0])
    cands = []
    for t in range(1, min(steps, max_depth) + 1):
        bytes_ = mx.block_hbm_bytes(block, t * r, dtype_bytes) \
            + mx.aux_hbm_bytes(block, t * r, n_aux)
        t_traf = bytes_ / hbm_bw
        # per original step: the fused sweep advances t steps at once
        reduction = base_bytes / (bytes_ * fused_traffic_ratio(t))
        if ("operator" in strategies or t == 1) and \
                fusion_legal(spec, eff_boundary, "operator", t) and \
                (t == 1 or not smem_gate
                 or mx.step_smem_bytes(block, t * r)
                 <= mx.TILE_SMEM_BUDGET):
            if t == 1:
                fspec, option, cover = spec, base_option, base_cover
            else:
                fspec = fuse_steps(spec, t)
                option, cover = choose_cover(fspec, block[0])
            flops = step_flops(fspec, cover, block)
            t_comp = flops / peak_flops
            cands.append(FuseCandidate(
                depth=t, option=option, flops=int(flops),
                hbm_bytes=bytes_, t_compute=t_comp, t_traffic=t_traf,
                t_per_step=max(t_comp, t_traf) / t,
                traffic_reduction=reduction, strategy="operator"))
        if "inkernel" in strategies and t > 1 and \
                fusion_legal(spec, eff_boundary, "inkernel", t) and \
                mx.sweep_feasible(block, t, r, limit=mx.TILE_SMEM_BUDGET):
            flops = mx.inkernel_flops(
                lambda ext: step_flops(spec, base_cover, ext), block, t, r)
            t_comp = flops / peak_flops
            cands.append(FuseCandidate(
                depth=t, option=base_option, flops=int(flops),
                hbm_bytes=bytes_, t_compute=t_comp, t_traffic=t_traf,
                t_per_step=max(t_comp, t_traf) / t,
                traffic_reduction=reduction, strategy="inkernel"))
    if not cands:
        raise ValueError(f"no fuse candidate for strategies {strategies!r} "
                         f"at steps={steps}")
    best = min(cands, key=lambda c: (c.t_per_step, c.t_compute, c.depth,
                                     c.strategy))
    return FuseDecision(depth=best.depth, candidates=tuple(cands),
                        strategy=best.strategy)
