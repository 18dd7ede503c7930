#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases:

1. identify the card (``nvidia-smi`` name and power limit, torch and CUDA
   versions) and turn TF32 off for matmuls and cuDNN;
2. build both CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   for ``sm_90a`` (timed; the compiler's register report is printed);
3. hold each kernel against its plain PyTorch version on the card, at
   1000^2 and 90^3 (not tile multiples), f32 and bf16, constant and
   varying+masked, unbatched and batch 3, both sweep scratch modes;
4. drive the port's main path — ``api.plan`` -> ``api.compile`` -> run,
   backends restricted to ``["cuda"]`` — on four full-size cells and check
   each against the port's gather oracle (``reference_evolve``) on the card
   at max|diff| <= 1e-4; the launch counters are zeroed just before and
   read just after, and both kernels must have launched;
5. hold every distinct kernel configuration the main path launched
   (kernel, spec, cover, tile, T, aux operands — read from each cell's
   compiled engine) against its plain version at the path's shapes;
6. time each kernel with CUDA events at the path's shapes next to its
   roofline bound (data-sheet 3.35 TB/s and 67 TFLOP/s f32), its plain
   version and one PyTorch library call (``F.conv2d`` with TF32 off), and
   the sweep at the path's tile against a 128x128 tile, in turns;
7. time each cell's warm run on the host clock and break one profiled
   run's device time into the two kernels and everything else.

Any kernel-vs-plain error over its tolerance (phases 3, 5 and 6) or any
main-path cell off its oracle fails the run.

The line before the last is a JSON object ``{"kernels": [...]}`` and the
one before it the card's ``name, power.limit``; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the
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

# H100 SXM data sheet: HBM3 bandwidth, and the f32 rate outside the tensor
# cores (the kernels are f32 FMAs without TF32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

KERNEL_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
E2E_ATOL = 1e-4

# phase 3: (suite name, cover, tile, output extent, sweep steps) per rank
KERNEL_CASES = {2: ("star2d_r2", "orthogonal", (32, 128), (1000, 1000), 3),
                3: ("box3d_r1", "parallel", (8, 8, 32), (90, 90, 90), 2)}

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


def check_kernels(device, failures: list, cases=KERNEL_CASES) -> None:
    import torch
    for label, got, want, tol in kernel_cases(device, cases):
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
        x = halo.pad_halo(seeded_normal(grid, 2000 + t, device), w,
                          spec.ndim, "periodic")
        x = ops._pad_to_multiple(x, block, w, spec.ndim)
        if name == "stencil_sweep":
            aux = ops._scenario_aux_sweep(spec, grid, w, block, "periodic",
                                          device)
            plan = sm.build_sweep_kernel_plan(spec, cover, block, steps,
                                              scratch=e.scratch)
            kernel, plain = sm.sweep_cuda_call, sm.sweep_plain
        else:
            aux = ops._scenario_aux_single(spec, grid, block, device)
            plan = sm.build_kernel_plan(spec, cover, block)
            kernel, plain = sm.stencil_cuda_call, sm.stencil_step_plain
        yield dict(
            name=name, t=t, spec=spec, cover=cover, steps=steps, x=x,
            aux=aux,
            kernel=lambda x=x, plan=plan, aux=aux, k=kernel: k(x, plan, aux),
            plain=lambda x=x, plan=plan, aux=aux, f=plain: f(x, plan, aux),
            label=(f"{name} [{cell['label']}] chunk T={t}: "
                   f"{spec.describe()}, block {block}, {len(aux)} aux, "
                   f"input {tuple(x.shape)}"))


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


def bound(read_bytes: float, write_bytes: float, flops: float):
    t_bytes = (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(device, main: dict, failures: list) -> list[dict]:
    """Time the two kernels at the main path's shapes: the step kernel on
    the box2d_r1 cell's fused operator, the sweep kernel on the star2d_r2
    cell's deepest chunk."""
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
             "src/repro/kernels/stencil_mxu.py:456")):
        case = [c for c in path_launches(cell, main["runs"][cell["label"]],
                                         device) if c["name"] == name][-1]
        spec, steps, x = case["spec"], case["steps"], case["x"]
        # the library yardstick: one convolution with the chunk's T-fused
        # constant taps computes the same function
        weight = torch.as_tensor(
            temporal.fuse_steps(spec, steps).gather_coeffs,
            dtype=torch.float32, device=device)[None, None]
        rows.append(_time_row(
            name, source, replaces, main["launches"][name], failures,
            kernel=case["kernel"], plain=case["plain"],
            library=lambda x=x, wt=weight: F.conv2d(x[None, None], wt)[0, 0],
            x=x, aux=case["aux"], flops_per_out=2 * spec.taps * steps,
            desc=case["label"]))
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
                                      case["steps"])
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
              library, x, aux, flops_per_out, desc) -> dict:
    import torch
    got = kernel()
    want = plain()
    lib = library()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    lib_err = (lib.float() - want.float()).abs().max().item()
    tol = KERNEL_TOL[str(got.dtype).removeprefix("torch.")]
    if not err <= tol:
        failures.append(f"kernel vs plain at the timed shape: {desc}: "
                        f"{err:.3e}")
    n_out = got.numel()
    ms = cuda_ms(kernel, reps=20)
    plain_ms = cuda_ms(plain, reps=5, warmup=1)
    library_ms = cuda_ms(library, reps=20)
    bound_ms, bound_by = bound(
        x.numel() * x.element_size()
        + sum(a.numel() * a.element_size() for a in aux),
        n_out * got.element_size(), flops_per_out * n_out)
    log(f"  {desc}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"F.conv2d {library_ms:.3f} ms (max|conv-plain| {lib_err:.2e}), "
        f"bound {bound_ms:.3f} ms by {bound_by}, max|kernel-plain| {err:.2e} "
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

def cell_breakdown(device, main: dict) -> None:
    """For each cell, a warm run of the compiled executable: its time on
    the host clock (median of 3, each ending in a synchronize), and from
    one profiled run the device time of the two kernels and of every other
    device op (pads, copies, tap tables).  The device's idle share is that
    device time against the unprofiled warm run (the profiler slows the
    host, so the profiled run's own wall time is longer)."""
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
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            ms = ev.self_device_time_total / 1e3
            key = next((k for k in ("stencil_step", "stencil_sweep")
                        if f"{k}_kernel" in ev.key), "other")
            groups[key] += ms
            if key == "other":
                others[ev.key[:60]] = others.get(ev.key[:60], 0.0) + ms
        busy = sum(groups.values())
        if busy == 0.0:
            log(f"  {cell['label']}: warm run {wall:.3f} ms (host clock); "
                f"the profiler saw no device time: breakdown not measured")
            continue
        top = "; ".join(f"{k} {v:.3f}" for k, v in sorted(
            others.items(), key=lambda kv: -kv[1])[:4])
        log(f"  {cell['label']}: warm run {wall:.3f} ms (host clock, "
            f"median of 3); profiled run {prof_wall:.3f} ms: step kernel "
            f"{groups['stencil_step']:.3f} ms, sweep kernel "
            f"{groups['stencil_sweep']:.3f} ms, other device ops "
            f"{groups['other']:.3f} ms [{top}], device idle "
            f"{max(0.0, 1 - busy / wall):.1%} of the warm run")
        del x


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
    check_kernels(device, failures)

    log("phase 4: main path, api.plan -> api.compile -> run")
    main_run = run_cells(device, failures)

    log("phase 5: every kernel configuration of the main path against its "
        "plain version")
    check_path_kernels(device, main_run, failures)

    log("phase 6: kernel times at the path's shapes (CUDA events, median)")
    rows = time_kernels(device, main_run, failures)
    compare_sweep_tiles(device, main_run, failures)

    log("phase 7: whole cells, warm (host clock; device time by profiler)")
    cell_breakdown(device, main_run)
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
