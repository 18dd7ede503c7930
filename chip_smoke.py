#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases:

1. identify the card (``nvidia-smi`` name and power limit, torch and CUDA
   versions) and turn TF32 off for matmuls and cuDNN;
2. build the four CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc for ``sm_90a``, one process per source (timed; the compiler's
   register report is printed);
3. hold each kernel against its plain PyTorch version on the card, at
   1000^2 and 90^3 (not tile multiples), f32 and bf16, constant and
   varying+masked, unbatched and batch 3, both sweep scratch modes, the
   sweep both on a haloed input and in wrap mode (the unpadded periodic
   state, its halo read through wrapped indices, ragged tiles masked in
   the kernel); and the step kernel at tiles whose last extent is not a
   multiple of its 8 outputs per thread and on input rows that are not
   16-byte aligned;
4. drive the port's main path — ``api.plan`` -> ``api.compile`` -> run,
   backends restricted to ``["cuda"]`` — on four full-size cells and check
   each against the port's gather oracle (``reference_evolve``) on the card
   at max|diff| <= 1e-4; the launch counters are zeroed just before and
   read just after, and both kernels must have launched;
5. hold every distinct kernel configuration the main path launched
   (kernel, spec, cover, tile, T, aux operands, input mode — read from
   each cell's compiled engine) against its plain version at the path's
   shapes;
6. time each kernel with CUDA events at the path's shapes next to its
   roofline bound (data-sheet 3.35 TB/s and 67 TFLOP/s f32), its plain
   version and one PyTorch library call (``F.conv2d`` with TF32 off, on
   the haloed input); the step kernel again on the star3d_r2 cell's step
   against ``F.conv3d``; the sweep at both of its main-path shapes (the
   star2d_r2 chunk, and the varying+masked star2d_r1 chunk, which no one
   library call computes), and at the path's tile against a 128x128 tile,
   in turns;
7. time each cell's warm run on the host clock and break one profiled
   run's device time into the two kernels and everything else, with the
   periodic-pad gathers counted: only the step kernel's chunks may pad;
8. hold the LM kernels against their plain versions: the banded mixer
   (shared and depthwise band, W in {1, 2, 4}, T = 1539, D = 3237, batch 1
   and 4, f32 and bf16) and flash attention (causal and full, f32 and
   bf16, B = 4, H = 25, S in {40, 128, 1536}, Dh in {8, 16, 64, 128}), and
   ``flash_attention``'s gradients against autograd through the plain
   version;
9. build Hymba-1.5B at full width and depth on the card from a seeded
   generator and serve batch 4 x 1536-token prompts for 32 greedy tokens
   through ``launch.serve.serve`` (cold, then warm): finite logits, ring
   and full caches, and the banded mixer launched 32 + 32 x 32 times
   (counter zeroed just before, read just after); then drive
   ``flash_attention`` (forward and backward) at Hymba's attention widths;
10. the full-width f32 serving consistency check (one 1040-token prefill
   against 1000 prefilled + 40 decoded tokens, the ring wrapping), and
   every banded-mixer configuration phase 9 launched against its plain
   version;

then phase 6's timing for the two LM kernels (banded mixer at the
prefill's and a decode step's shape — the decode call also by its device
time from the profiler, beside the events time of 20 back-to-back calls,
which is the host's time per call — flash attention at (4, 25, 1536, 64)
causal in f32 and in bf16; library yardsticks ``F.conv1d`` and SDPA;
flash attention's bound at the tensor-core rate its arithmetic runs at,
3xTF32 in f32 and bf16 in bf16) and phase 7's breakdown of one warm
prefill and decode step of the serve cell; then the stencil serving
slice:

11. ``StencilServer`` at full width: star2d_r2, 16 periodic steps, 32
   f32 requests alternating 4096^2 and 2730^2 (numpy, seed 0), buckets of
   up to 8, ``backends=["cuda"]``, in five passes — cold sync, warm sync,
   warm async, warm async on requests already on the card, and the
   background stepper with four submitter threads blocking in
   ``results(timeout_s=)``.  Pass 1 against the gather oracle on the card
   at 1e-4, passes 2-5 bit-identical to it; each state of the first of
   each shape also in buckets of 1, 2 and 4; cold misses equal to the
   distinct (shape, bucket) executables and no warm miss; launches of the
   step and sweep kernels equal to what the settled plans imply (counters
   zeroed before each pass); ``degraded == {}`` and no fault counted.
   Prints the plan per bucket, the port's admission cap per PAPER_SUITE
   cell, states/s, us/state, p50/p95 latency per pass, and a profiled warm async pass's device time (kernels, H2D, D2H,
   other, idle share), for numpy and for device-resident requests;
12. chaos on the card (box2d_r1 2048^2, 4 steps, buckets of up to 4, 12
   requests): seeded dispatch/settle/compile faults recover bit-identical
   to the fault-free sync server with ``retries == bucket_failures ==
   fired()``, and the seeded server's own launches (counters zeroed just
   before it) equal what its launched buckets' plans imply, settled or
   failed at settle; persistent compile faults of the cuda backend
   degrade the group to the eager ``torch`` backend, bit-identical to a
   torch-pinned server;
13. rollouts: a three-segment star2d_r2 program at 8192^2 (``source``,
   ``nudge`` + emit, emit) compiled on the card, against a stepwise
   oracle at 1e-4; killed during segment 1 and resumed from its
   checkpoint (``keep_last=2``), bit-identical to the uninterrupted run;
   checkpoint write and restore times; two 4096^2 rollouts through phase
   11's server with their emits streamed, bit-identical to the compiled
   program at batch 2.

Any kernel-vs-plain error over its tolerance (phases 3, 5, 6, 8 and 10),
any main-path cell off its oracle, or any serve, server, chaos or
rollout check that fails (phases 9-13) fails the run.

The last three lines are a JSON object ``{"kernels": [...]}`` (all four
kernels; ``launches`` is the count of each kernel's own path — phase 4
for the step and sweep kernels — and the step and sweep rows give the
counts of phases 4, 11, 12 (the seeded server) and 13 in
``launches_by_path``), the card's ``name,
power.limit`` and ``{"ok": true, "device": {...}}``.  Without a card, or without the
repository's sources beside this file, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: HBM3 bandwidth, the f32 rate outside the tensor cores
# (the stencil kernels and the banded mixer are f32 FMAs), and the dense
# tensor-core rates flash attention runs at: bf16, and TF32, of which f32
# takes three products per f32 product (3xTF32, the repo's rule for f32 on
# tensor cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12
TF32_TC_FLOPS_PER_S = 495e12
# (rate, what bound_by names) per kind of arithmetic
RATES = {"f32": (F32_FLOPS_PER_S, "operations"),
         "3xtf32": (TF32_TC_FLOPS_PER_S / 3, "operations, 3xTF32"),
         "bf16": (BF16_TC_FLOPS_PER_S, "operations, bf16 tensor cores")}

KERNEL_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
E2E_ATOL = 1e-4
# flash attention against its plain version: the reference test's bars
# (tests/test_flash_kernel.py), and its gradients against autograd
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# bf16 flash attention is also held to this share of max|plain| (about
# five bf16 ulps at the largest output): at S=1536 without the causal mask
# an output averages ~565 effective keys, and its RMS (~0.04) is close to
# the fixed 3e-2 bar
FLASH_BF16_REL_TOL = 2e-2
FLASH_GRAD_TOL = 1e-4
# serving consistency at full width, f32: max|diff| of the last logits
# over max|logits|
CONSISTENCY_REL_TOL = 1e-3

# phase 3: (suite name, cover, tile, output extent, sweep steps) per rank
KERNEL_CASES = {2: ("star2d_r2", "orthogonal", (32, 128), (1000, 1000), 3),
                3: ("box3d_r1", "parallel", (8, 8, 32), (90, 90, 90), 2)}
# phase 3, the step kernel's edges: (suite name, tile, output extent) with
# tiles whose last extent is not a multiple of its 8 outputs per thread,
# and input rows that are not 16-byte aligned (4-byte copies)
STEP_EDGE_CASES = (("star2d_r2", (16, 20), (97, 103)),
                   ("box2d_r1", (8, 12), (40, 37)),
                   ("star3d_r2", (4, 8, 12), (20, 17, 25)),
                   ("box3d_r1", (2, 6, 6), (10, 12, 11)),
                   ("star2d_r1", (16, 128), (64, 8190)))

# phase 4: the main path at full size (periodic grids)
CELLS = (
    dict(label="star2d_r2 8192^2 inkernel", name="star2d_r2",
         grid=(8192, 8192), steps=16, strategy="inkernel", scenario=False),
    dict(label="box2d_r1 8192^2 operator", name="box2d_r1",
         grid=(8192, 8192), steps=16, strategy="operator", scenario=False),
    dict(label="star3d_r2 512^3 auto", name="star3d_r2",
         grid=(512, 512, 512), steps=8, strategy=None, scenario=False),
    dict(label="star2d_r1 4096^2 varying+masked inkernel", name="star2d_r1",
         grid=(4096, 4096), steps=8, strategy="inkernel", scenario=True),
)


# phases 8-10: the LM slice at Hymba-1.5B's widths
BANDED_RAGGED = (1539, 3200 + 37)       # (T, D): prefill rows, ragged D
FLASH_SHAPE = (4, 25, 1536, 64)         # (B, H, S, Dh)
# phase 8: (S, Dh) of flash attention at (4, 25, S, Dh); S = 40 is not a
# multiple of the kernel's 64-row tiles (the wrapper's blocks are then 40)
FLASH_CASES = ((128, 16), (128, 64), (1536, 16), (1536, 64), (40, 8),
               (40, 128), (1536, 8), (1536, 128))
SERVE = dict(batch=4, prompt_len=1536, gen_len=32)
CONSISTENCY = dict(batch=2, prompt_len=1040, split=1000, seed=2)

# phases 11-13: the stencil serving slice (2730 is the CLI's second shape,
# two thirds of 4096)
SERVE_STENCIL = dict(cell="star2d_r2", steps=16, grids=(4096, 2730),
                     requests=32, max_batch=8, submitters=4)
CHAOS = dict(cell="box2d_r1", grid=2048, steps=4, max_batch=4, requests=12)
ROLLOUT = dict(cell="star2d_r2", grid=8192, serve_grid=4096)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def seeded_normal(shape, seed: int, device):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(tuple(shape), generator=g, device=device)


def seeded_aux(shape, seed: int, device):
    """A field in [0.5, 1.5) and a 0/1 mask with ~80% active points."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    field = 0.5 + torch.rand(tuple(shape), generator=g, device=device)
    mask = (torch.rand(tuple(shape), generator=g, device=device) < 0.8)
    return field.contiguous(), mask.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(device, cases=KERNEL_CASES):
    """Yield (label, kernel output, plain output, tolerance) for every
    case of tests/test_torch_kernels.py at the given extents."""
    import numpy as np
    import torch
    from repro_torch.core import coefficient_lines as cl
    from repro_torch.core import stencil_spec as ss
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mxu as sm

    seed = 0
    for nd, (name, cover_opt, block, out, steps) in cases.items():
        base = ss.PAPER_SUITE()[name]
        for scenario in ("constant", "varying+masked"):
            spec = base if scenario == "constant" else base.with_field(
                np.ones(out), domain_mask=np.ones(out, bool))
            cover = cl.make_cover(spec, cover_opt)
            r = spec.order
            for dtype in ("float32", "bfloat16"):
                for batch in (None, 3):
                    lead = (batch,) if batch else ()
                    seed += 1
                    x = seeded_normal(lead + tuple(n + 2 * r for n in out),
                                      seed, device)
                    x = ops._pad_to_multiple(x.to(getattr(torch, dtype)),
                                             block, r, nd)
                    aux = () if spec.is_constant_dense else seeded_aux(
                        tuple(s - 2 * r for s in x.shape[-nd:]), seed + 100,
                        device)
                    plan = sm.build_kernel_plan(spec, cover, block,
                                                batch=batch)
                    label = (f"step  {name} {out} {dtype} {scenario} "
                             f"batch={batch}")
                    yield (label, sm.stencil_cuda_call(x, plan, aux),
                           sm.stencil_step_plain(x, plan, aux),
                           KERNEL_TOL[dtype])
                    w = steps * r
                    x = seeded_normal(lead + tuple(n + 2 * w for n in out),
                                      seed + 200, device)
                    x = ops._pad_to_multiple(x.to(getattr(torch, dtype)),
                                             block, w, nd)
                    aux = () if spec.is_constant_dense else seeded_aux(
                        x.shape[-nd:], seed + 300, device)
                    for scratch in ("pingpong", "single"):
                        plan = sm.build_sweep_kernel_plan(
                            spec, cover, block, steps, batch=batch,
                            scratch=scratch)
                        label = (f"sweep {name} {out} T={steps} {dtype} "
                                 f"{scenario} batch={batch} {scratch}")
                        yield (label, sm.sweep_cuda_call(x, plan, aux),
                               sm.sweep_plain(x, plan, aux),
                               KERNEL_TOL[dtype])
                    # wrap mode: the unpadded periodic state, any extents
                    x = seeded_normal(lead + tuple(out), seed + 400,
                                      device).to(getattr(torch, dtype))
                    for scratch in ("pingpong", "single"):
                        plan = sm.build_sweep_kernel_plan(
                            spec, cover, block, steps, batch=batch,
                            scratch=scratch, wrap=True)
                        aux = () if spec.is_constant_dense else seeded_aux(
                            sm.sweep_aux_shape(out, plan), seed + 500,
                            device)
                        label = (f"sweep {name} {out} T={steps} {dtype} "
                                 f"{scenario} batch={batch} {scratch} wrap")
                        yield (label, sm.sweep_cuda_call(x, plan, aux),
                               sm.sweep_plain(x, plan, aux),
                               KERNEL_TOL[dtype])


def step_edge_cases(device, cases=STEP_EDGE_CASES):
    """Yield (label, kernel output, plain output, tolerance) for the step
    kernel at :data:`STEP_EDGE_CASES`: constant and varying+masked, f32
    and bf16, unbatched and batch 3."""
    import numpy as np
    import torch
    from repro_torch.core import coefficient_lines as cl
    from repro_torch.core import stencil_spec as ss
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mxu as sm

    seed = 300
    for name, block, out in cases:
        base = ss.PAPER_SUITE()[name]
        nd, r = base.ndim, base.order
        for scenario in ("constant", "varying+masked"):
            spec = base if scenario == "constant" else base.with_field(
                np.ones(out), domain_mask=np.ones(out, bool))
            cover = cl.make_cover(spec, "parallel")
            for dtype in ("float32", "bfloat16"):
                for batch in (None, 3):
                    seed += 1
                    lead = (batch,) if batch else ()
                    x = seeded_normal(lead + tuple(n + 2 * r for n in out),
                                      seed, device)
                    x = ops._pad_to_multiple(x.to(getattr(torch, dtype)),
                                             block, r, nd)
                    aux = () if spec.is_constant_dense else seeded_aux(
                        tuple(s - 2 * r for s in x.shape[-nd:]), seed + 100,
                        device)
                    plan = sm.build_kernel_plan(spec, cover, block,
                                                batch=batch)
                    yield (f"step  {name} tile {block} {out} {dtype} "
                           f"{scenario} batch={batch}",
                           sm.stencil_cuda_call(x, plan, aux),
                           sm.stencil_step_plain(x, plan, aux),
                           KERNEL_TOL[dtype])


def check_cases(device, failures: list, cases) -> None:
    """Hold each ``(label, kernel output, plain output, tolerance)`` of
    ``cases``; a case over its tolerance (or of another shape or type) is
    a failure."""
    import torch
    for label, got, want, tol in cases:
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= tol and got.shape == want.shape and got.dtype == want.dtype
        log(f"  {label}: max|kernel-plain| {err:.3e} (tol {tol:g})"
            f"{'' if ok else '  FAIL'}")
        if not ok:
            failures.append(f"kernel vs plain: {label}: {err:.3e}")


# ---------------------------------------------------------------------------
# phase 4: the main path at full size
# ---------------------------------------------------------------------------

def cell_spec(cell):
    from repro_torch.core import stencil_spec as ss
    spec = ss.PAPER_SUITE()[cell["name"]]
    if cell["scenario"]:
        spec = spec.with_field(
            ss.random_coeff_field(cell["grid"], seed=1),
            domain_mask=ss.random_domain_mask(cell["grid"], seed=2))
    return spec


def run_cells(device, failures: list, cells=CELLS) -> dict:
    """Drive api.plan -> api.compile -> run for every cell; returns the
    compiled executables by label and the launch counts of the whole
    main-path run."""
    import torch
    from repro_torch import api
    from repro_torch.core.time_stepper import reference_evolve
    from repro_torch.kernels import stencil_mxu as sm

    runs = {}
    counters = (sm.stencil_cuda_call, sm.sweep_cuda_call)
    for c in counters:
        c.launches = 0                      # zeroed just before the path
    for i, cell in enumerate(cells):
        spec = cell_spec(cell)
        problem = api.StencilProblem(spec, grid=cell["grid"],
                                     boundary="periodic",
                                     steps=cell["steps"])
        t0 = time.perf_counter()
        p = api.plan(problem, backends=["cuda"],
                     fuse_strategy=cell["strategy"])
        run = api.compile(p, device=device)
        t_plan = time.perf_counter() - t0
        runs[cell["label"]] = run
        log(f"  {cell['label']}: plan backend={p.backend} cover={p.option} "
            f"block={p.block} fuse={p.fuse_depth} strategy={p.fuse_strategy} "
            f"schedule={p.schedule_str()} ({t_plan:.2f}s to plan+compile)")
        x = seeded_normal(cell["grid"], 1000 + i, device)
        before = [c.launches for c in counters]
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = run(x)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launched = [c.launches - b for c, b in zip(counters, before)]
        want = reference_evolve(spec, x, cell["steps"], "periodic")
        err = (y - want).abs().max().item()
        finite = bool(torch.isfinite(y).all())
        ok = (err <= E2E_ATOL and finite and y.shape == x.shape
              and y.dtype == x.dtype)
        log(f"  {cell['label']}: max|port-oracle| {err:.3e} (tol "
            f"{E2E_ATOL:g}), finite={finite}, shape={tuple(y.shape)}, "
            f"run {t_run * 1e3:.1f} ms incl. first-launch setup, launches "
            f"step={launched[0]} sweep={launched[1]}{'' if ok else '  FAIL'}")
        if not ok:
            failures.append(f"main path: {cell['label']}: {err:.3e}")
        del x, y, want
    counts = {"stencil_step": sm.stencil_cuda_call.launches,
              "stencil_sweep": sm.sweep_cuda_call.launches}
    for name, n in counts.items():
        if n <= 0:
            failures.append(f"main path never launched the {name} kernel")
    log(f"  launches over the main path: {counts}")
    return {"runs": runs, "launches": counts}


# ---------------------------------------------------------------------------
# phase 5: every kernel configuration of the main path against its plain
# version, at the path's own shapes
# ---------------------------------------------------------------------------

def path_launches(cell, run, device):
    """Every distinct (kernel, spec, cover, block, T, aux) the cell's run
    launched, read from its compiled engine, with seeded inputs of the
    path's shapes.  Yields dicts with the kernel and plain callables."""
    from repro_torch.core import halo
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mxu as sm

    eng, p = run.engine, run.plan
    grid = tuple(cell["grid"])
    for t in sorted(set(p.fuse_schedule)):
        if t > 1 and p.fuse_strategy == "inkernel":
            e, steps, name = eng, t, "stencil_sweep"
        else:
            e = eng if t == 1 else eng.fused_engine(t)
            steps, name = 1, "stencil_step"
        spec, cover = e.plan.spec, e.plan.cover
        block = tuple(min(b, s) for b, s in zip(e.plan.block, grid))
        w = steps * spec.order
        state = seeded_normal(grid, 2000 + t, device)
        # the haloed input: the step kernel's, and the library's yardstick
        haloed = halo.pad_halo(state, w, spec.ndim, "periodic")
        if name == "stencil_sweep":
            # the path's periodic sweep takes the unpadded state (wrap mode)
            x, mode = state, "wrap mode"
            aux = ops._scenario_aux_sweep(spec, grid, w, block, "periodic",
                                          device)
            plan = sm.build_sweep_kernel_plan(spec, cover, block, steps,
                                              scratch=e.scratch, wrap=True)
            kernel, plain = sm.sweep_cuda_call, sm.sweep_plain
        else:
            x = haloed = ops._pad_to_multiple(haloed, block, w, spec.ndim)
            mode = "haloed"
            aux = ops._scenario_aux_single(spec, grid, block, device)
            plan = sm.build_kernel_plan(spec, cover, block)
            kernel, plain = sm.stencil_cuda_call, sm.stencil_step_plain
        yield dict(
            name=name, t=t, spec=spec, cover=cover, steps=steps, x=x,
            haloed=haloed, aux=aux, block=block,
            kernel=lambda x=x, plan=plan, aux=aux, k=kernel: k(x, plan, aux),
            plain=lambda x=x, plan=plan, aux=aux, f=plain: f(x, plan, aux),
            label=(f"{name} [{cell['label']}] chunk T={t}: "
                   f"{spec.describe()}, block {block}, {len(aux)} aux, "
                   f"input {tuple(x.shape)} {mode}"))


def check_path_kernels(device, main: dict, failures: list) -> None:
    import torch
    for cell in CELLS:
        for case in path_launches(cell, main["runs"][cell["label"]], device):
            got, want = case["kernel"](), case["plain"]()
            if device.type == "cuda":
                torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL[str(got.dtype).removeprefix("torch.")]
            ok = err <= tol and got.shape == want.shape
            log(f"  {case['label']}: max|kernel-plain| {err:.3e} "
                f"(tol {tol:g}){'' if ok else '  FAIL'}")
            if not ok:
                failures.append(f"kernel vs plain on the path: "
                                f"{case['label']}: {err:.3e}")
            del got, want, case


# ---------------------------------------------------------------------------
# phase 6: kernel times at the path's shapes
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Time of one ``fn()``: ``reps`` back-to-back calls between two CUDA
    events, after warm-up, over ``reps`` — the host's work for one call
    overlaps the device's work for the one before."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled_device_ms(fn, kernel: str, reps: int = 20):
    """Mean device time (ms) of one launch of the kernel whose name holds
    ``kernel`` over ``reps`` calls of ``fn``, from ``torch.profiler``;
    None when the profiler saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and kernel in ev.key:
            total += ev.self_device_time_total / 1e3
            count += ev.count
    return total / count if count else None


def bound(read_bytes: float, write_bytes: float, flops: float,
          rate: str = "f32"):
    """(least ms, what bounds it): the bytes over the HBM rate against the
    flops over ``RATES[rate]``."""
    flops_per_s, ops_label = RATES[rate]
    t_bytes = (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, ops_label)


def flash_flops(shape) -> float:
    """Flops of one causal attention forward: Q K^T and P V over the kept
    (query, key) pairs, 2 flops each per Dh element — S(S+1)/2 pairs per
    (b, h), so 2(S+1) flops per output element."""
    b, h, s, dh = shape
    return 2.0 * (s + 1) * b * h * s * dh


def time_kernels(device, main: dict, failures: list) -> list[dict]:
    """Time the two kernels at the main path's shapes: the step kernel on
    the box2d_r1 cell's fused operator, the sweep kernel on the star2d_r2
    cell's deepest chunk; then (logged lines) the step kernel on the
    star3d_r2 cell's step against ``F.conv3d`` and the sweep on the
    varying+masked star2d_r1 cell's chunk, where no one library call
    computes the same function."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import temporal

    rows = []
    for name, cell, source, replaces in (
            ("stencil_step", CELLS[1],
             "src/repro_torch/kernels/csrc/stencil_step.cu",
             "src/repro/kernels/stencil_mxu.py:277"),
            ("stencil_sweep", CELLS[0],
             "src/repro_torch/kernels/csrc/stencil_sweep.cu",
             "src/repro/kernels/stencil_mxu.py:456"),
            ("stencil_step", CELLS[2],
             "src/repro_torch/kernels/csrc/stencil_step.cu",
             "src/repro/kernels/stencil_mxu.py:277"),
            ("stencil_sweep", CELLS[3],
             "src/repro_torch/kernels/csrc/stencil_sweep.cu",
             "src/repro/kernels/stencil_mxu.py:456")):
        case = [c for c in path_launches(cell, main["runs"][cell["label"]],
                                         device) if c["name"] == name][-1]
        spec, steps, x = case["spec"], case["steps"], case["x"]
        conv = F.conv2d if spec.ndim == 2 else F.conv3d
        library = None
        if spec.is_constant_dense:
            # the library yardstick: one convolution with the chunk's
            # T-fused constant taps over the haloed input computes the
            # same function
            weight = torch.as_tensor(
                temporal.fuse_steps(spec, steps).gather_coeffs,
                dtype=torch.float32, device=device)[None, None]
            library = (lambda xh=case["haloed"], wt=weight, conv=conv:
                       conv(xh[None, None], wt)[0, 0])
        row = _time_row(
            name, source, replaces, main["launches"][name], failures,
            kernel=case["kernel"], plain=case["plain"], library=library,
            inputs=(x, *case["aux"]), flops_per_out=2 * spec.taps * steps,
            desc=case["label"], library_name=conv.__name__,
            library_reps=20 if spec.ndim == 2 else 3)
        if cell is CELLS[0] or cell is CELLS[1]:
            rows.append(row)
        del case, x
    return rows


def compare_sweep_tiles(device, main: dict, failures: list) -> None:
    """The sweep kernel on the star2d_r2 cell's chunk at the tile the
    planner picks within the residency budget (two blocks per SM) against
    128x128, which only the launch limit admits (one block per SM): the
    same input, timed in turns in this call (path, wide, wide, path)."""
    import torch
    from repro_torch.kernels import stencil_mxu as sm

    cell = CELLS[0]
    case = [c for c in path_launches(cell, main["runs"][cell["label"]],
                                     device)
            if c["name"] == "stencil_sweep"][-1]
    x, wide = case["x"], (128, 128)
    plan = sm.build_sweep_kernel_plan(case["spec"], case["cover"], wide,
                                      case["steps"], wrap=True)
    runs = {"path": case["kernel"],
            "wide": lambda: sm.sweep_cuda_call(x, plan)}
    err = (runs["wide"]() - runs["path"]()).abs().max().item()
    if not err <= KERNEL_TOL["float32"]:
        failures.append(f"sweep at tile {wide} vs the path's tile: {err:.3e}")
    times = {"path": [], "wide": []}
    for key in ("path", "wide", "wide", "path"):
        times[key].append(cuda_ms(runs[key], reps=20))
    log(f"  sweep tiles in turns, {case['label']}: path tile "
        f"{times['path'][0]:.3f}, {times['path'][1]:.3f} ms; tile {wide} "
        f"{times['wide'][0]:.3f}, {times['wide'][1]:.3f} ms; "
        f"max|diff| {err:.2e}")
    del case, x


def _time_row(name, source, replaces, launches, failures, *, kernel, plain,
              library, inputs, flops_per_out, desc, tol=None,
              library_name="F.conv2d", rate="f32", library_reps=20) -> dict:
    """Time ``kernel``, ``plain`` and ``library`` at one shape with CUDA
    events and return the kernel's row of the ``kernels`` line; the bound
    counts each tensor of ``inputs`` read once and the output written
    once, and the flops at ``RATES[rate]``."""
    import torch
    got = kernel()
    want = plain()
    lib = library() if library is not None else None
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if got.shape != want.shape:
        err = float("inf")
    lib_err = float("nan") if lib is None else \
        (lib.float() - want.float()).abs().max().item()
    if tol is None:
        tol = KERNEL_TOL[str(got.dtype).removeprefix("torch.")]
    if not err <= tol:
        failures.append(f"kernel vs plain at the timed shape: {desc}: "
                        f"{err:.3e}")
    n_out = got.numel()
    ms = cuda_ms(kernel, reps=20)
    plain_ms = cuda_ms(plain, reps=5, warmup=1)
    library_ms = None if library is None else \
        cuda_ms(library, reps=library_reps, warmup=1)
    bound_ms, bound_by = bound(
        sum(a.numel() * a.element_size() for a in inputs),
        n_out * got.element_size(), flops_per_out * n_out, rate)
    lib_text = "no one library call" if library_ms is None else \
        f"{library_name} {library_ms:.3f} ms (max|library-plain| " \
        f"{lib_err:.2e})"
    log(f"  {desc}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"{lib_text}, bound {bound_ms:.3f} ms by {bound_by} "
        f"({bound_ms / ms:.1%} of it), max|kernel-plain| {err:.2e} "
        f"(tol {tol:g}){'' if err <= tol else '  FAIL'}")
    del got, want, lib
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phase 7: where a whole cell's time goes
# ---------------------------------------------------------------------------

def expected_pad_gathers(run) -> int:
    """Periodic-pad gathers a cell's run may launch: one ``index_select``
    per spatial axis for every chunk the step kernel runs (the halo layer
    pads its haloed input); the sweep kernel's chunks read the periodic
    halo themselves and pad nothing."""
    p = run.plan
    return sum(p.spec.ndim for t in p.fuse_schedule
               if not (t > 1 and p.fuse_strategy == "inkernel"))


def cell_breakdown(device, main: dict, failures: list) -> None:
    """For each cell, a warm run of the compiled executable: its time on
    the host clock (median of 3, each ending in a synchronize), and from
    one profiled run the device time of the two kernels and of every other
    device op (pads, copies), with the periodic-pad gathers counted (more
    than :func:`expected_pad_gathers` fails the run).  The device's idle
    share is that device time against the unprofiled warm run (the
    profiler slows the host, so the profiled run's own wall time is
    longer)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i, cell in enumerate(CELLS):
        run = main["runs"][cell["label"]]
        x = seeded_normal(cell["grid"], 1000 + i, device)
        run(x)
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(x)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(x)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        groups = {"stencil_step": 0.0, "stencil_sweep": 0.0, "other": 0.0}
        others: dict[str, float] = {}
        pads, pad_ms = 0, 0.0
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            ms = ev.self_device_time_total / 1e3
            key = next((k for k in ("stencil_step", "stencil_sweep")
                        if f"{k}_kernel" in ev.key), "other")
            groups[key] += ms
            if key == "other":
                others[ev.key[:60]] = others.get(ev.key[:60], 0.0) + ms
                if "gather" in ev.key.lower():
                    pads += ev.count
                    pad_ms += ms
        busy = sum(groups.values())
        if busy == 0.0:
            log(f"  {cell['label']}: warm run {wall:.3f} ms (host clock); "
                f"the profiler saw no device time: breakdown not measured")
            continue
        top = "; ".join(f"{k} {v:.3f}" for k, v in sorted(
            others.items(), key=lambda kv: -kv[1])[:4])
        allowed = expected_pad_gathers(run)
        ok = pads <= allowed
        log(f"  {cell['label']}: warm run {wall:.3f} ms (host clock, "
            f"median of 3); profiled run {prof_wall:.3f} ms: step kernel "
            f"{groups['stencil_step']:.3f} ms, sweep kernel "
            f"{groups['stencil_sweep']:.3f} ms, other device ops "
            f"{groups['other']:.3f} ms [{top}], of which periodic-pad "
            f"gathers (index_select) {pads} launches {pad_ms:.3f} ms "
            f"(the step kernel's chunks allow {allowed}); device idle "
            f"{max(0.0, 1 - busy / wall):.1%} of the warm run"
            f"{'' if ok else '  FAIL'}")
        if not ok:
            failures.append(f"{cell['label']}: {pads} periodic-pad gathers, "
                            f"{allowed} allowed")
        del x


# ---------------------------------------------------------------------------
# phase 8: the LM kernels against their plain versions
# ---------------------------------------------------------------------------

def lm_kernel_cases(device):
    """Yield (label, kernel output, plain output, tolerance): the banded
    mixer (both band kinds, W in {1, 2, 4}, ragged T and D, batch 1 and
    4, f32 and bf16) and flash attention (causal and full, f32 and bf16,
    (S, Dh) in :data:`FLASH_CASES`) at Hymba's batch and heads."""
    import torch
    from repro_torch.kernels import banded_mixer as bm
    from repro_torch.kernels import flash_attention as fa

    seed = 5000
    t_len, d = BANDED_RAGGED
    for kind in ("shared", "depthwise"):
        for w in (1, 2, 4):
            for batch in (1, 4):
                for dtype in ("float32", "bfloat16"):
                    seed += 2
                    x = seeded_normal((batch, t_len, d), seed, device).to(
                        getattr(torch, dtype))
                    # the model's band scale (1/W), so |y| stays where one
                    # bf16 ulp is under the tolerance
                    band = seeded_normal((w, d) if kind == "depthwise"
                                         else (w,), seed + 1, device) / w
                    yield (f"banded_mixer {kind} W={w} x{tuple(x.shape)} "
                           f"{dtype}", bm.banded_mixer_cuda_call(x, band),
                           bm.banded_mixer_plain(x, band), KERNEL_TOL[dtype])
    for causal in (True, False):
        for dtype in ("float32", "bfloat16"):
            for s, dh in FLASH_CASES:
                seed += 3
                q, k, v = (seeded_normal(
                    (4, 25, s, dh), seed + i, device).to(
                    getattr(torch, dtype)) for i in range(3))
                plain = fa.flash_attention_plain(q, k, v, causal)
                tol, bar = FLASH_TOL[dtype], ""
                if dtype == "bfloat16":
                    peak = plain.float().abs().max().item()
                    tol = min(tol, FLASH_BF16_REL_TOL * peak)
                    bar = (f" [tol = min({FLASH_TOL[dtype]:g}, "
                           f"{FLASH_BF16_REL_TOL:g} x max|plain| "
                           f"{peak:.3g})]")
                yield (f"flash_attention causal={causal} {dtype} "
                       f"q{tuple(q.shape)}{bar}",
                       fa.flash_attention_cuda(q, k, v, causal=causal),
                       plain, tol)


def check_flash_grad(device, failures: list) -> None:
    """Gradients of ``flash_attention`` (kernel forward, dense backward)
    against autograd through the plain version."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    qkv = [seeded_normal((1, 2, 256, 64), 6000 + i, device) for i in range(3)]
    grads = []
    for fn in (fa.flash_attention,
               lambda q, k, v: fa.flash_attention_plain(q, k, v, True)):
        leaves = [t.clone().requires_grad_(True) for t in qkv]
        loss = torch.sin(fn(*leaves)).sum()
        grads.append(torch.autograd.grad(loss, leaves))
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(*grads))
    ok = err <= FLASH_GRAD_TOL
    log(f"  flash_attention grads (1, 2, 256, 64) f32 vs autograd through "
        f"the plain version: max|diff| {err:.3e} (tol {FLASH_GRAD_TOL:g})"
        f"{'' if ok else '  FAIL'}")
    if not ok:
        failures.append(f"flash_attention grads: {err:.3e}")


# ---------------------------------------------------------------------------
# phase 9: Hymba-1.5B serves a few requests; flash attention's entry point
# ---------------------------------------------------------------------------

def _recording_banded_configs(seen: set):
    """Record every (x shape, band shape, dtype, tile) that ``ops.banded_mix``
    hands the banded mixer's wrapper, until the returned function is
    called.  The wrapper itself stays in place (its launch counter is its
    own); ``ops`` calls it through a recording stand-in of its module."""
    import types
    from repro_torch.kernels import banded_mixer as bm
    from repro_torch.kernels import ops

    def record(x, band, block_t=bm.BLOCK_T, block_d=bm.BLOCK_D):
        seen.add((tuple(x.shape), tuple(band.shape), x.dtype, block_t,
                  block_d))
        return bm.banded_mixer_cuda_call(x, band, block_t, block_d)

    ops.banded_mixer = types.SimpleNamespace(MAX_BATCH=bm.MAX_BATCH,
                                             banded_mixer_cuda_call=record)

    def restore():
        ops.banded_mixer = bm
    return restore


def serve_hymba(device, failures: list) -> dict:
    """Build Hymba-1.5B at full width and depth from a seeded generator
    (bf16 compute), serve batch 4 x 1536-token prompts for 32 greedy
    tokens through ``launch.serve.serve`` (make_prefill /
    make_decode_step) once cold and once warm; the banded mixer's counter
    is zeroed just before the cold run and read just after."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import banded_mixer as bm
    from repro_torch.launch.input_specs import (sample_from_specs,
                                                train_batch_specs)
    from repro_torch.launch.serve import serve
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models import transformer as tf

    cfg = get_config("hymba_1_5b")
    t0 = time.perf_counter()
    model = tf.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {n_params} parameters built on the card in "
        f"{time.perf_counter() - t0:.2f} s (param_count() "
        f"{cfg.param_count()}), compute {cfg.compute_dtype}, "
        f"{cfg.num_layers} layers, window {cfg.sliding_window}")
    tokens = sample_from_specs(
        train_batch_specs(cfg, SERVE["batch"], SERVE["prompt_len"]), cfg,
        seed=1)["tokens"].to(device)
    gen_len = SERVE["gen_len"]

    configs: set = set()
    restore = _recording_banded_configs(configs)
    torch.cuda.reset_peak_memory_stats()
    bm.banded_mixer_cuda_call.launches = 0      # zeroed just before the path
    try:
        cold = serve(model, tokens, gen_len)
    finally:
        restore()
    launches = bm.banded_mixer_cuda_call.launches
    peak = torch.cuda.max_memory_allocated()
    warm = serve(model, tokens, gen_len)

    expect = cfg.num_layers * (1 + gen_len)
    finite = all(bool(torch.isfinite(l).all()) for l in cold["logits"])
    shapes_ok = (cold["ids"].shape == (SERVE["batch"], gen_len)
                 and cold["logits"][0].shape == (SERVE["batch"],
                                                 cfg.vocab_size))
    kinds = sorted({type(c[0]).__name__ for c in cold["state"].caches})
    same = bool(torch.equal(cold["ids"], warm["ids"]))
    for run, out in (("cold", cold), ("warm", warm)):
        log(f"  serve {run}: prefill {SERVE['batch']}x{SERVE['prompt_len']} "
            f"{out['prefill_ms']:.1f} ms, decode {gen_len} tokens "
            f"{out['decode_ms']:.1f} ms ({out['decode_ms'] / gen_len:.2f} "
            f"ms/token) (host clock, synchronised)")
    for b, ids in enumerate(cold["ids"][:, :8].tolist()):
        log(f"  request {b}: first 8 generated ids {ids}")
    ok = finite and shapes_ok and launches == expect and same \
        and kinds == sorted([kvc.FullKVCache.__name__,
                             kvc.RingKVCache.__name__])
    log(f"  finite logits {finite}, shapes ok {shapes_ok}, caches {kinds}, "
        f"warm ids == cold ids {same}, banded_mixer launches {launches} "
        f"(expected {cfg.num_layers} + {cfg.num_layers} x {gen_len} = "
        f"{expect}), peak memory {peak / 2**30:.2f} GiB"
        f"{'' if ok else '  FAIL'}")
    if not ok:
        failures.append(f"serve: finite={finite} shapes={shapes_ok} "
                        f"launches={launches}/{expect} same={same} "
                        f"caches={kinds}")
    return {"cfg": cfg, "model": model, "tokens": tokens,
            "configs": configs, "launches": launches, "warm": warm}


def flash_path(device, failures: list) -> int:
    """Drive flash attention's own entry point, ``flash_attention`` (kernel
    forward, dense backward), at Hymba's attention widths; its counter is
    zeroed just before and read just after.  Returns the launches."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (seeded_normal(FLASH_SHAPE, 7000 + i, device).requires_grad_(True)
               for i in range(3))
    fa.flash_attention_cuda.launches = 0
    out = fa.flash_attention(q, k, v, causal=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    launches = fa.flash_attention_cuda.launches
    with torch.no_grad():
        err = (out - fa.flash_attention_plain(q, k, v, True)).abs().max().item()
    finite = all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
    ok = err <= FLASH_TOL["float32"] and finite and launches > 0
    log(f"  flash_attention{FLASH_SHAPE} f32 causal, forward + backward: "
        f"max|out-plain| {err:.3e} (tol {FLASH_TOL['float32']:g}), finite "
        f"grads {finite}, launches {launches}{'' if ok else '  FAIL'}")
    if not ok:
        failures.append(f"flash path: err={err:.3e} finite={finite} "
                        f"launches={launches}")
    del q, k, v, out
    return launches


# ---------------------------------------------------------------------------
# phase 10: the serving path's own correctness at full width
# ---------------------------------------------------------------------------

def serve_consistency(device, failures: list, lm: dict) -> None:
    """Full-width f32 counterpart of the reference's
    ``test_smoke_serve_consistency``: the last logits of one 1040-token
    prefill (the ring write with s >= window) against a 1000-token prefill
    followed by 40 decode steps (the ring wraps during decode), both with
    ``max_len`` 1041; then every banded-mixer configuration phase 9
    launched against its plain version at its own shape."""
    import dataclasses

    import torch
    from repro_torch.kernels import banded_mixer as bm
    from repro_torch.launch.input_specs import (sample_from_specs,
                                                train_batch_specs)
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models import transformer as tf
    from repro_torch.train.serve_step import make_decode_step, make_prefill

    c = CONSISTENCY
    cfg = dataclasses.replace(lm["cfg"], compute_dtype="float32")
    model = tf.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    tokens = sample_from_specs(
        train_batch_specs(cfg, c["batch"], c["prompt_len"]), cfg,
        seed=c["seed"])["tokens"].to(device)
    max_len = c["prompt_len"] + 1
    prefill = make_prefill(cfg, max_len)
    decode = make_decode_step(cfg)
    with torch.no_grad():
        full, _ = prefill(model, tokens)
        last, state = prefill(model, tokens[:, :c["split"]])
        for t in range(c["split"], c["prompt_len"]):
            last, state = decode(model, state, tokens[:, t:t + 1])
    rings = sum(isinstance(cache[0], kvc.RingKVCache)
                for cache in state.caches)
    scale = full.abs().max().item()
    err = (last - full).abs().max().item()
    tol = CONSISTENCY_REL_TOL * scale
    ok = err <= tol and bool(torch.isfinite(full).all()) and rings > 0
    log(f"  f32, batch {c['batch']}: prefill {c['prompt_len']} vs prefill "
        f"{c['split']} + decode {c['prompt_len'] - c['split']} ({rings} "
        f"ring caches, window {cfg.sliding_window}, max_len {max_len}): "
        f"max|diff| of the last logits {err:.3e} (tol {tol:.3e} = "
        f"{CONSISTENCY_REL_TOL:g} x max|logits| {scale:.3f})"
        f"{'' if ok else '  FAIL'}")
    if not ok:
        failures.append(f"serve consistency: {err:.3e} > {tol:.3e} "
                        f"(rings={rings})")
    del model, full, last, state

    def path_cases():
        for i, (shape, band_shape, dtype, bt, bd) in enumerate(
                sorted(lm["configs"], key=str)):
            x = seeded_normal(shape, 8000 + i, device).to(dtype)
            band = seeded_normal(band_shape, 8100 + i, device) / band_shape[0]
            yield (f"banded_mixer on the serve path: x{shape} band"
                   f"{band_shape} {str(dtype).removeprefix('torch.')} tile "
                   f"({bt}, {bd})", bm.banded_mixer_cuda_call(x, band, bt, bd),
                   bm.banded_mixer_plain(x, band),
                   KERNEL_TOL[str(dtype).removeprefix("torch.")])
    check_cases(device, failures, path_cases())


# ---------------------------------------------------------------------------
# phase 6 (LM kernels): times at the serve path's shapes
# ---------------------------------------------------------------------------

def time_lm_kernels(device, lm: dict, flash_launches: int,
                    failures: list) -> list[dict]:
    """The banded mixer at the prefill's shape (and its decode-step time
    beside it) and flash attention at Hymba's attention widths, with their
    bounds, plain versions and one library call each: ``F.conv1d`` with
    ``groups=D`` on the causally padded input, and
    ``F.scaled_dot_product_attention(is_causal=True)`` in f32 (TF32 off);
    flash attention is timed again in bf16 (a logged line)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import banded_mixer as bm
    from repro_torch.kernels import flash_attention as fa

    prefill_shape, decode_shape = sorted(
        {c[0] for c in lm["configs"]}, key=lambda s: -s[1])[:2]
    rows = []
    for shape, label in ((prefill_shape, "prefill"), (decode_shape, "decode")):
        batch, t_len, d = shape
        w = lm["cfg"].ssm.conv_width
        x = seeded_normal(shape, 9000, device)
        band = seeded_normal((w, d), 9001, device) / w
        # conv1d is a cross-correlation: flip the band; pad W-1 in front
        weight = band.flip(0).t().contiguous()[:, None, :]

        def library(x=x, weight=weight, w=w, d=d):
            xc = F.pad(x.transpose(1, 2), (w - 1, 0))
            return F.conv1d(xc, weight, groups=d).transpose(1, 2)
        row = _time_row(
            "banded_mixer", "src/repro_torch/kernels/csrc/banded_mixer.cu",
            "src/repro/kernels/banded_mixer.py:53", lm["launches"], failures,
            kernel=lambda x=x, band=band: bm.banded_mixer_cuda_call(x, band),
            plain=lambda x=x, band=band: bm.banded_mixer_plain(x, band),
            library=library, inputs=(x, band), flops_per_out=2 * w,
            desc=f"banded_mixer {label} x{shape} f32 depthwise W={w}",
            library_name="F.conv1d(groups=D)")
        if label == "prefill":
            rows.append(row)
        else:
            dev = profiled_device_ms(
                lambda x=x, band=band: bm.banded_mixer_cuda_call(x, band),
                "banded_mixer_kernel")
            log(f"  banded_mixer decode x{shape}: host time per call "
                f"{row['ms'] * 1e3:.2f} us (CUDA events over 20 "
                f"back-to-back calls: the launches are host-bound), device "
                f"time per launch "
                f"{'not measured' if dev is None else f'{dev * 1e3:.2f} us'}"
                f" (torch.profiler, 20 calls), bound "
                f"{row['bound_ms'] * 1e3:.2f} us by {row['bound_by']}")
    for dtype, rate in (("float32", "3xtf32"), ("bfloat16", "bf16")):
        q, k, v = (seeded_normal(FLASH_SHAPE, 9100 + i, device).to(
            getattr(torch, dtype)) for i in range(3))
        tol = FLASH_TOL[dtype]
        if dtype == "bfloat16":
            peak = fa.flash_attention_plain(q, k, v, True).float().abs().max()
            tol = min(tol, FLASH_BF16_REL_TOL * peak.item())
        row = _time_row(
            "flash_attention",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:57", flash_launches,
            failures,
            kernel=lambda: fa.flash_attention_cuda(q, k, v, causal=True),
            plain=lambda: fa.flash_attention_plain(q, k, v, True),
            library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True),
            inputs=(q, k, v),
            flops_per_out=flash_flops(FLASH_SHAPE) / q.numel(),
            tol=tol, desc=f"flash_attention q{FLASH_SHAPE} {dtype} causal",
            library_name="SDPA(is_causal)", rate=rate)
        if dtype == "float32":
            rows.append(row)
            cores, _ = bound(0.0, 0.0, flash_flops(FLASH_SHAPE), "f32")
            log(f"  flash_attention f32 bound at the CUDA-core f32 rate "
                f"({F32_FLOPS_PER_S / 1e12:g} TFLOP/s), which the kernel "
                f"does not use: {cores:.3f} ms")
        del q, k, v
    return rows


# ---------------------------------------------------------------------------
# phase 7 (serve cell): where a prefill's and a decode step's time goes
# ---------------------------------------------------------------------------

_MATMUL = ("gemm", "gemv", "nvjet", "xmma", "cutlass")


def _device_split(prof) -> dict:
    """Device time (ms) of a profiled run split into the banded mixer
    kernel, the ``attention`` and ``ssm_scan`` spans (every device op
    their code launched), the remaining matmuls, and the rest."""
    from torch.autograd import DeviceType

    def kernels_under(ev):
        yield from ev.kernels
        for ch in ev.cpu_children:
            yield from kernels_under(ch)

    total = banded = matmul = 0.0
    spans = {"attention": 0.0, "ssm_scan": 0.0}
    in_span_matmul = 0.0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation:
            ms = ev.device_time_total / 1e3
            total += ms
            name = ev.name.lower()
            if "banded_mixer_kernel" in name:
                banded += ms
            elif any(m in name for m in _MATMUL):
                matmul += ms
        elif ev.device_type == DeviceType.CPU and ev.name in spans:
            spans[ev.name] += ev.device_time_total / 1e3
            in_span_matmul += sum(
                k.duration for k in kernels_under(ev)
                if any(m in k.name.lower() for m in _MATMUL)) / 1e3
    matmul -= in_span_matmul
    other = total - banded - matmul - sum(spans.values())
    return {"total": total, "banded_mixer": banded, "matmuls": matmul,
            **spans, "other": other}


def serve_breakdown(device, lm: dict) -> None:
    """Device time of one warm prefill and one warm decode step of the
    phase 9 model, split by :func:`_device_split`; the device's idle share
    is against the unprofiled warm times of phase 9 (host clock)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.serve_step import make_decode_step, make_prefill

    cfg, model, tokens = lm["cfg"], lm["model"], lm["tokens"]
    warm = lm["warm"]
    prefill = make_prefill(cfg, tokens.shape[1] + SERVE["gen_len"] + 1)
    decode = make_decode_step(cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad():
        with profile(activities=acts) as p_prefill:
            last, state = prefill(model, tokens)
            torch.cuda.synchronize()
        tok = torch.argmax(last, dim=-1)[:, None]
        decode(model, state, tok)                 # warm the decode path
        torch.cuda.synchronize()
        with profile(activities=acts) as p_decode:
            decode(model, state, torch.argmax(last, dim=-1)[:, None])
            torch.cuda.synchronize()
    for stage, prof, wall in (
            ("prefill", p_prefill, warm["prefill_ms"]),
            ("decode step", p_decode, warm["decode_ms"] / SERVE["gen_len"])):
        split = _device_split(prof)
        if split["total"] == 0.0:
            log(f"  serve {stage}: warm {wall:.3f} ms (host clock); the "
                f"profiler saw no device time: breakdown not measured")
            continue
        parts = ", ".join(f"{k} {v:.3f}" for k, v in split.items()
                          if k != "total")
        log(f"  serve {stage}: warm {wall:.3f} ms (host clock); device "
            f"{split['total']:.3f} ms = {parts} ms; device idle "
            f"{max(0.0, 1 - split['total'] / wall):.1%} of the warm run")


# ---------------------------------------------------------------------------
# phases 11-13: the stencil serving slice (plan cache, server, chaos,
# rollouts with checkpoints)
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def _stencil_counters():
    from repro_torch.kernels import stencil_mxu as sm
    return {"stencil_step": sm.stencil_cuda_call,
            "stencil_sweep": sm.sweep_cuda_call}


def _zero_counts() -> None:
    for c in _stencil_counters().values():
        c.launches = 0


def _read_counts() -> dict:
    return {k: c.launches for k, c in _stencil_counters().items()}


def plan_launches(eplan) -> dict:
    """Kernel launches one call of a compiled plan makes: a sweep launch
    for every in-kernel chunk deeper than 1, a step launch for every
    other chunk (the batch rides one launch)."""
    sweep = sum(1 for t in eplan.fuse_schedule
                if t > 1 and eplan.fuse_strategy == "inkernel")
    return {"stencil_step": len(eplan.fuse_schedule) - sweep,
            "stencil_sweep": sweep}


def _entry_plans(entry) -> list:
    """The ExecutionPlans one cache entry's call runs (one, or one per
    segment of a rollout program)."""
    return list(getattr(entry.plan, "segment_plans", [entry.plan]))


def expected_launches(caches, calls_before: dict,
                      counter: str = "calls") -> dict:
    """Launches the calls of every cache entry since ``calls_before``
    imply, from each entry's plan: its settled calls, or with
    ``counter="dispatches"`` every launch that returned, settled or not."""
    want = {"stencil_step": 0, "stencil_sweep": 0}
    for cache in caches:
        for key, entry in cache._entries.items():
            n = getattr(entry, counter) - calls_before.get((id(cache), key), 0)
            for p in _entry_plans(entry):
                for k, v in plan_launches(p).items():
                    want[k] += n * v
    return want


def _entry_calls(caches) -> dict:
    return {(id(c), k): e.calls for c in caches for k, e in c._entries.items()}


def _bucket_plans(server) -> list[str]:
    rows = []
    for key, entry in sorted(server.cache._entries.items(),
                             key=lambda kv: (kv[0][2], kv[0][6])):
        for p in _entry_plans(entry):
            rows.append(f"{'x'.join(map(str, p.grid))} bucket {p.batch}: "
                        f"strategy {p.fuse_strategy}, depth {p.fuse_depth} "
                        f"(schedule {p.schedule_str()}), tile "
                        f"{'x'.join(map(str, p.block))}, backend {p.backend}")
    return rows


def admission_caps(max_batch: int) -> dict:
    """The port's admission cap (``max_profitable_batch`` from its Hopper
    cost model, on the host) for every PAPER_SUITE cell, 16 periodic
    steps, at the JAX package's model grids (256^2, 64^3) and at serving
    grids of 2^24 points (4096^2, 256^3)."""
    from repro_torch import api
    caps = {}
    for name, spec in api.PAPER_SUITE().items():
        grids = ((256, 4096) if spec.ndim == 2 else (64, 256))
        caps[name] = {
            "x".join([str(g)] * spec.ndim): api.max_profitable_batch(
                api.StencilProblem(spec, (g,) * spec.ndim,
                                   boundary="periodic", steps=16), max_batch)
            for g in grids}
    return caps


def _device_breakdown(prof, wall_ms: float) -> str:
    """Device time of a profiled run: the two stencil kernels, host-to-
    device and device-to-host copies, everything else; idle share against
    ``wall_ms``."""
    from torch.autograd import DeviceType
    parts = {"kernels": 0.0, "H2D": 0.0, "D2H": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        name = ev.key.lower()
        if "stencil_step_kernel" in name or "stencil_sweep_kernel" in name:
            parts["kernels"] += ms
        elif "memcpy" in name and "htod" in name:
            parts["H2D"] += ms
        elif "memcpy" in name and "dtoh" in name:
            parts["D2H"] += ms
        else:
            parts["other"] += ms
    busy = sum(parts.values())
    if busy == 0.0:
        return "the profiler saw no device time: breakdown not measured"
    text = ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
    return (f"device {busy:.3f} ms = {text} ms; device idle "
            f"{max(0.0, 1 - busy / wall_ms):.1%} of the {wall_ms:.1f} ms "
            f"pass")


def serve_stencil(device, failures: list) -> dict:
    """Phase 11: ``StencilServer`` at full width — 32 f32 requests of
    star2d_r2, alternating 4096^2 and 2730^2, 16 periodic steps, buckets
    of up to 8, backends ``["cuda"]``; five passes (cold sync, warm sync,
    warm async, warm async on device-resident requests, background
    stepper with four submitter threads), each against pass 1 bit for
    bit, pass 1 against the gather oracle on the card at 1e-4."""
    import threading
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core.time_stepper import reference_evolve

    cfg = SERVE_STENCIL
    spec = api.PAPER_SUITE()[cfg["cell"]]
    rng = np.random.default_rng(0)
    states = [rng.standard_normal((g, g), dtype=np.float32)
              for g in (cfg["grids"][i % 2] for i in range(cfg["requests"]))]
    server = api.StencilServer(spec, cfg["steps"], boundary="periodic",
                               max_batch=cfg["max_batch"],
                               backends=["cuda"], devices=[device])
    shapes = sorted({s.shape for s in states})
    counts = {"stencil_step": 0, "stencil_sweep": 0}
    passes = {}

    def background(batch):
        server.start()
        got, errors = [None] * len(batch), []
        per = len(batch) // cfg["submitters"]

        def submitter(lo):
            try:
                tickets = [(i, server.submit(batch[i]))
                           for i in range(lo, lo + per)]
                for i, t in tickets:
                    got[i] = server.results(t, timeout_s=300.0)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=submitter, args=(k * per,))
                   for k in range(cfg["submitters"])]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(300.0)
        finally:
            server.stop()
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"background pass failed: {errors}")
        return got

    def run_pass(name, batch, mode):
        server.async_dispatch = mode != "sync"
        server.reset_stats()
        misses0 = server.cache.misses
        calls0 = _entry_calls(server.caches)
        _zero_counts()
        _sync(device)
        t0 = time.perf_counter()
        outs = background(batch) if mode == "background" else \
            server.serve(batch)
        _sync(device)
        wall = time.perf_counter() - t0
        launched = _read_counts()
        want = expected_launches(server.caches, calls0)
        for k in counts:
            counts[k] += launched[k]
        st = server.stats()
        misses = server.cache.misses - misses0
        n = len(batch)
        log(f"  pass {name}: {n} states in {wall * 1e3:.1f} ms = "
            f"{n / wall:.1f} states/s, {wall / n * 1e6:.0f} us/state; "
            f"latency p50 {st['latency']['p50_s'] * 1e3:.1f} ms, p95 "
            f"{st['latency']['p95_s'] * 1e3:.1f} ms; {st['batches']} "
            f"buckets, cache misses {misses}; launches {launched} "
            f"(plans imply {want})")
        ok = launched == want and st["degraded"] == {} and not any(
            v for k, v in st["faults"].items())
        if not ok:
            failures.append(f"stencil server pass {name}: launches "
                            f"{launched} vs {want}, degraded "
                            f"{st['degraded']}, faults {st['faults']}")
        passes[name] = dict(wall_s=wall, misses=misses, stats=st)
        return outs

    first = run_pass("1 cold sync", states, "sync")
    distinct = len(server.cache)
    log(f"  cold pass: {passes['1 cold sync']['misses']} plan-cache misses "
        f"for {distinct} distinct (shape, bucket) executables; admission "
        f"caps {server.stats()['admission']}")
    if passes["1 cold sync"]["misses"] != distinct:
        failures.append("stencil server: cold misses != executables")
    for row in _bucket_plans(server):
        log(f"  plan {row}")
    t0 = time.perf_counter()
    caps = admission_caps(cfg["max_batch"])
    log(f"  admission caps at max_batch {cfg['max_batch']} per PAPER_SUITE "
        f"cell, 16 periodic steps (planner on the host, "
        f"{time.perf_counter() - t0:.1f} s): {json.dumps(caps)}")
    worst = 0.0
    for x, y in zip(states, first):
        want = reference_evolve(spec, torch.from_numpy(x).to(device),
                                cfg["steps"], "periodic")
        ok_shape = y.shape == want.shape and y.device.type == device.type
        err = (y - want).abs().max().item() if ok_shape else float("inf")
        worst = max(worst, err)
        del want
    finite = all(bool(torch.isfinite(y).all()) for y in first)
    log(f"  pass 1 vs the gather oracle: max|diff| {worst:.3e} (tol "
        f"{E2E_ATOL:g}), finite={finite}")
    if not (worst <= E2E_ATOL and finite):
        failures.append(f"stencil server vs oracle: {worst:.3e}")

    def same_bits(name, outs):
        same = all(torch.equal(a, b) for a, b in zip(outs, first))
        log(f"  pass {name}: bit-identical to pass 1: {same}")
        if not same:
            failures.append(f"stencil server pass {name} differs from 1")

    same_bits("2 warm sync", run_pass("2 warm sync", states, "sync"))
    same_bits("3 warm async", run_pass("3 warm async", states, "async"))
    on_card = [torch.from_numpy(s).to(device) for s in states]
    same_bits("4 warm async, device-resident",
              run_pass("4 warm async, device-resident", on_card, "async"))
    # a state's result against its bucket: the first state of each shape
    # alone and in buckets of 2 and 4 (which also warms those buckets for
    # the background pass, whose buckets form as requests arrive)
    for k in (1, 2, 4):
        for shape in shapes:
            idx = [i for i, s in enumerate(states) if s.shape == shape][:k]
            outs = server.serve([states[i] for i in idx])
            same = all(torch.equal(o, first[i]) for o, i in zip(outs, idx))
            log(f"  {'x'.join(map(str, shape))} in a bucket of {k}: "
                f"bit-identical to its bucket of {cfg['max_batch']}: {same}")
            if not same:
                failures.append(f"stencil server: result depends on the "
                                f"bucket ({shape}, {k})")
    same_bits("5 background, 4 submitters",
              run_pass("5 background, 4 submitters", states, "background"))
    for name, p in passes.items():
        if name != "1 cold sync" and p["misses"]:
            failures.append(f"stencil server pass {name}: {p['misses']} "
                            f"misses on a warm pass")
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        server.async_dispatch = True
        for label, batch in (("numpy requests", states),
                             ("device-resident requests", on_card)):
            _sync(device)
            t0 = time.perf_counter()
            server.serve(batch)
            _sync(device)
            wall = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                server.serve(batch)
                _sync(device)
            log(f"  warm async pass, {label}: {_device_breakdown(prof, wall)}")
    del on_card, first
    return {"server": server, "launches": counts, "passes": passes}


def chaos_on_card(device, failures: list) -> dict:
    """Phase 12: the chaos gates at a real size — box2d_r1 at 2048^2, 4
    steps, buckets of up to 4, 12 requests: seeded dispatch/settle/compile
    faults under the retry rung against the fault-free sync server, and
    persistent compile faults of the cuda backend degrading the group to
    the eager ``torch`` backend against a torch-pinned server."""
    import numpy as np
    import torch
    from repro_torch import api

    cfg = CHAOS
    spec = api.PAPER_SUITE()[cfg["cell"]]
    rng = np.random.default_rng(1)
    g = cfg["grid"]
    states = [rng.standard_normal((g, g), dtype=np.float32)
              for _ in range(cfg["requests"])]
    name = f"{g}x{g}"

    def server(backends, **kw):
        return api.StencilServer(spec, cfg["steps"], boundary="periodic",
                                 max_batch=cfg["max_batch"],
                                 backends=backends, devices=[device], **kw)

    def quick():
        return api.RestartPolicy(max_failures=8, backoff_s=0.005)

    base = server(["cuda"], async_dispatch=False).serve(states)
    srv = server(["cuda"], restart=quick(), fallback_after=None)
    plan = (api.FaultPlan(seed=2)
            .rule("serve.dispatch", rate=0.3)
            .rule("serve.settle", rate=0.3)
            .rule("cache.compile", rate=0.5, times=2))
    _zero_counts()
    with plan:
        outs = srv.serve(states)
    counts = _read_counts()
    f = srv.stats()["faults"]
    by_site = plan.stats()["by_site"]
    same = all(torch.equal(a, b) for a, b in zip(outs, base))
    ok = (same and plan.fired() > 0
          and f["retries"] == f["bucket_failures"] == plan.fired())
    log(f"  seeded faults: {plan.fired()} fired ({by_site}),"
        f" bucket failures {f['bucket_failures']}, retries {f['retries']}; "
        f"bit-identical to the fault-free sync server: {same}"
        f"{'' if ok else '  FAIL'}")
    if not ok:
        failures.append("chaos on the card: seeded faults")
    # every bucket that returned from its launch ran its plan's kernels:
    # the settled ones, and those failed at settle by an injected fault
    want = expected_launches(srv.caches, {}, counter="dispatches")
    settled = sum(e.calls for c in srv.caches for e in c._entries.values())
    launched = sum(e.dispatches for c in srv.caches
                   for e in c._entries.values())
    ok = (counts == want and sum(counts.values()) > 0
          and launched == settled + by_site.get("serve.settle", 0))
    log(f"  launches of the seeded server: {counts} (plans imply {want} "
        f"over {launched} launched buckets = {settled} settled + "
        f"{by_site.get('serve.settle', 0)} failed at settle)"
        f"{'' if ok else '  FAIL'}")
    if not ok:
        failures.append(f"chaos launches {counts} vs {want}")
    torch_base = server(["torch"], async_dispatch=False).serve(states)
    srv = server(["cuda"], restart=quick(), fallback_after=2)
    plan = api.FaultPlan(seed=0).rule("cache.compile", rate=1.0,
                                      match={"backend": "cuda"})
    _zero_counts()
    with plan:
        outs = srv.serve(states)
    degraded_counts = _read_counts()
    st = srv.stats()
    same = all(torch.equal(a, b) for a, b in zip(outs, torch_base))
    ok = (same and st["degraded"] == {name: ["torch"]}
          and st["faults"]["fallbacks"] == 1)
    log(f"  fallback rung: degraded {st['degraded']}, fallbacks "
        f"{st['faults']['fallbacks']}, {plan.fired()} compile faults, "
        f"kernel launches {degraded_counts}; bit-identical to the "
        f"torch-pinned server: {same}{'' if ok else '  FAIL'}")
    if not ok:
        failures.append("chaos on the card: fallback rung")
    return {"launches": counts}


def rollouts(device, failures: list, server) -> dict:
    """Phase 13: a three-segment rollout of star2d_r2 at 8192^2 compiled on
    the card against a stepwise oracle (``reference_evolve`` per segment
    plus the update) at 1e-4; killed during segment 1 and resumed from its
    checkpoint, bit-identical to the uninterrupted run; two 4096^2
    rollouts through phase 11's server, emits streamed."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.checkpoint.checkpointer import (restore_checkpoint,
                                                     save_checkpoint)
    from repro_torch.core.time_stepper import reference_evolve
    from repro_torch.rollout import build_update

    cfg = ROLLOUT
    spec = api.PAPER_SUITE()[cfg["cell"]]
    segs = [api.Segment(5, api.UpdateOp("source",
                                        {"seed": 3, "scale": 0.01})),
            api.Segment(5, api.UpdateOp("nudge", {"seed": 4, "gain": 0.1}),
                        emit=True),
            api.Segment(6, emit=True)]
    g = cfg["grid"]
    program = api.RolloutProgram(
        api.StencilProblem(spec, (g, g), boundary="periodic", steps=1),
        segs)
    _zero_counts()
    t0 = time.perf_counter()
    compiled = api.compile_program(program, backends=["cuda"], device=device)
    log(f"  {g}^2 program planned and compiled in "
        f"{time.perf_counter() - t0:.2f} s:")
    for line in compiled.plan.explain().splitlines():
        log(f"    {line}")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (g, g), dtype=np.float32)).to(device)
    _sync(device)
    t0 = time.perf_counter()
    clean = compiled.run(x)
    _sync(device)
    log(f"  run {(time.perf_counter() - t0) * 1e3:.1f} ms (first call)")
    y, oracle = x, []
    for i, seg in enumerate(segs):
        y = reference_evolve(spec, y, seg.steps, "periodic")
        if seg.update is not None:
            y = build_update(seg.update, program.segment_problem(i))(y)
        if seg.emit:
            oracle.append(y)
    errs = [(a - b).abs().max().item()
            for a, b in zip([e for _, e in clean.emits] + [clean.final],
                            oracle + [y])]
    ok = max(errs) <= E2E_ATOL and [t for t, _ in clean.emits] == [10, 16]
    log(f"  emits at {[t for t, _ in clean.emits]} and final vs the stepwise "
        f"oracle: max|diff| {', '.join(f'{e:.3e}' for e in errs)} (tol "
        f"{E2E_ATOL:g}){'' if ok else '  FAIL'}")
    if not ok:
        failures.append(f"rollout vs oracle: {errs}")
    del y, oracle

    class Kill(RuntimeError):
        pass

    def kill(seg, attempt):
        if seg == 1:
            raise Kill("killed during segment 1")

    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        try:
            api.run_checkpointed(compiled, x, directory=d, keep_last=2,
                                 fault_injector=kill)
            failures.append("rollout: the injected kill did not fire")
        except Kill:
            pass
        _sync(device)
        t0 = time.perf_counter()
        resumed = api.run_checkpointed(compiled, x, directory=d,
                                       keep_last=2)
        _sync(device)
        t_resume = time.perf_counter() - t0
        same = (torch.equal(resumed.final, clean.final) and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(resumed.emits,
                                                       clean.emits))
            and resumed.attempts == (0, 1, 1))
        log(f"  killed during segment 1, resumed from the segment-0 "
            f"checkpoint: attempts {resumed.attempts}, bit-identical to the "
            f"uninterrupted run: {same} ({t_resume:.2f} s to resume and "
            f"finish, checkpoints included){'' if same else '  FAIL'}")
        if not same:
            failures.append("rollout kill/resume differs")
        tree = {"state": clean.final,
                "emits": {f"{t:08d}": a for t, a in clean.emits}}
        nbytes = sum(t.numel() * t.element_size()
                     for t in [clean.final] + [a for _, a in clean.emits])
        t0 = time.perf_counter()
        save_checkpoint(d, 99, tree, extra={"probe": 1})
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _ = restore_checkpoint(d, 99, tree, device=device)
        _sync(device)
        t_load = time.perf_counter() - t0
        exact = torch.equal(back["state"], clean.final)
        log(f"  checkpoint of {nbytes / 2**20:.0f} MiB (state + 2 emits): "
            f"write {t_save:.2f} s, restore to the card {t_load:.2f} s "
            f"(host clock, local disk), bit-exact {exact}")
        if not exact:
            failures.append("checkpoint round trip differs")
        del back, tree
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del x, clean, resumed
    # two 4096^2 rollouts through the phase 11 server
    sg = cfg["serve_grid"]
    rng = np.random.default_rng(6)
    xs = [rng.standard_normal((sg, sg), dtype=np.float32) for _ in range(2)]
    server.async_dispatch = True
    calls0 = _entry_calls(server.caches)
    tickets = [server.submit_rollout(s, segs) for s in xs]
    streamed = {t: [] for t in tickets}
    running = set(tickets)
    while running:
        server.step()
        for t in sorted(running):
            # a drained, finished rollout leaves the server
            streamed[t] += server.rollout_results(t)
            if server.rollout_done(t):
                running.discard(t)
    finals = server.flush()
    counts = _read_counts()
    # the segment runs above: the clean run (0, 1, 2), the killed run
    # (0, then 1 before the kill) and the resumed one (1, 2); then the
    # server's settled one-segment programs
    want = expected_launches(server.caches, calls0)
    for i, n in enumerate((2, 3, 2)):
        for k, v in plan_launches(compiled.plan.segment_plans[i]).items():
            want[k] += n * v
    ref = api.compile_program(api.RolloutProgram(
        api.StencilProblem(spec, (sg, sg), boundary="periodic", steps=1,
                           batch=2), segs), backends=["cuda"],
        device=device).run(torch.from_numpy(np.stack(xs)).to(device))
    same = all(torch.equal(finals[t], ref.final[i])
               and [s for s, _ in streamed[t]] == [10, 16]
               and all(torch.equal(a, e[i]) for (_, a), (_, e)
                       in zip(streamed[t], ref.emits))
               for i, t in enumerate(tickets))
    log(f"  two {sg}^2 rollouts through the server: emits streamed at "
        f"{[[s for s, _ in streamed[t]] for t in tickets]}, bit-identical "
        f"to the compiled program at batch 2: {same}"
        f"{'' if same else '  FAIL'}")
    if not same:
        failures.append("rollouts through the server differ")
    log(f"  launches over phase 13: {counts} (plans imply {want})")
    if counts != want:
        failures.append(f"rollout launches {counts} vs {want}")
    return {"launches": counts}


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test runs only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda_build   # fails outside the repo

    t_start = time.perf_counter()
    device = torch.device("cuda")
    failures: list[str] = []

    log("phase 1: card")
    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  nvidia-smi: {smi}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    log("phase 2: build")
    t0 = time.perf_counter()
    built = cuda_build.build()
    log(f"  nvcc {' '.join(cuda_build.NVCC_FLAGS)}")
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
        f"(wall, in parallel)")
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
        for line in cuda_build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("phase 3: kernels against their plain versions")
    check_cases(device, failures, kernel_cases(device))
    check_cases(device, failures, step_edge_cases(device))

    log("phase 4: main path, api.plan -> api.compile -> run")
    main_run = run_cells(device, failures)

    log("phase 5: every kernel configuration of the main path against its "
        "plain version")
    check_path_kernels(device, main_run, failures)

    log("phase 6: kernel times at the path's shapes (CUDA events, median)")
    rows = time_kernels(device, main_run, failures)
    compare_sweep_tiles(device, main_run, failures)

    log("phase 7: whole cells, warm (host clock; device time by profiler)")
    cell_breakdown(device, main_run, failures)

    log("phase 8: the LM kernels against their plain versions")
    check_cases(device, failures, lm_kernel_cases(device))
    check_flash_grad(device, failures)

    log("phase 9: Hymba-1.5B serves batch 4 x 1536 tokens, 32 greedy "
        "tokens; flash attention's entry point")
    lm = serve_hymba(device, failures)
    flash_launches = flash_path(device, failures)

    log("phase 10: serving consistency at full width; the serve path's "
        "banded-mixer configurations against their plain versions")
    serve_consistency(device, failures, lm)

    log("phase 6 (LM kernels): kernel times at the serve path's shapes")
    rows += time_lm_kernels(device, lm, flash_launches, failures)

    log("phase 7 (serve cell): one warm prefill and decode step, device "
        "time by profiler")
    serve_breakdown(device, lm)

    t_serving = time.perf_counter()
    log("phase 11: StencilServer at full width, star2d_r2 4096^2/2730^2, "
        "32 requests, 16 steps, buckets of up to 8")
    served = serve_stencil(device, failures)
    log("phase 12: chaos on the card, box2d_r1 2048^2")
    chaotic = chaos_on_card(device, failures)
    log("phase 13: rollouts at full width, star2d_r2 8192^2, with "
        "checkpoints; two 4096^2 rollouts through the server")
    rolled = rollouts(device, failures, served["server"])
    log(f"  phases 11-13 took {time.perf_counter() - t_serving:.1f} s")
    for row in rows:
        if row["name"] in main_run["launches"]:
            by_path = {"main": main_run["launches"][row["name"]],
                       "stencil_server": served["launches"][row["name"]],
                       "chaos": chaotic["launches"][row["name"]],
                       "rollouts": rolled["launches"][row["name"]]}
            row["launches_by_path"] = by_path
            # the server's plans run both kernels; the rollout's plans
            # are in-kernel chunks only (phase 13 prints them)
            if by_path["stencil_server"] <= 0 or (
                    row["name"] == "stencil_sweep"
                    and by_path["rollouts"] <= 0):
                failures.append(f"the serving paths never launched the "
                                f"{row['name']} kernel")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    if failures:
        for f in failures:
            print(f"chip_smoke: FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
