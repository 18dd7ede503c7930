#!/usr/bin/env python3
"""Time an earlier design of the port's kernels against the current one,
in turns, on one card.

The earlier sources are taken from git by the caller, so that the run
needs no repository history; the tool times every kernel whose earlier
source it finds in ``--old``:

    mkdir -p _chip/old
    git show <commit>:src/repro_torch/kernels/csrc/stencil_sweep.cu > _chip/old/stencil_sweep.cu
    git show <commit>:src/repro_torch/kernels/csrc/banded_mixer.cu > _chip/old/banded_mixer.cu
    python3 tools/torch_kernel_turns.py --old _chip/old

(and likewise ``flash_attention.cu`` and ``stencil_step.cu``).  The
earlier sources must have the C interfaces of the port's first CUDA
designs: ``flash_attention_launch`` with explicit query/key blocks
(commit 5fdf53f); ``stencil_step_launch`` and ``stencil_sweep_launch``
with a table of coefficients then slab offsets (5fdf53f for the step
kernel, 2ea350e for the sweep); ``banded_mixer_launch`` with the
(time, channel) tile of a shared-memory slab (2ea350e, whose wrapper set
the launcher's argument types on every call, as the earlier call here
does).  Each is built with the current ``cuda_build.NVCC_FLAGS`` into
``<old>/build``.  At the shapes ``chip_smoke.py`` times, after each
kernel was held against the plain version:

* flash attention at (4, 25, 1536, 64) causal in f32 and bf16, and the
  step kernel on the box2d_r1 cell's fused operator and on the star3d_r2
  cell's step: old, new, new, old (CUDA events, 20 launches each);
* the sweep on the star2d_r2 and the varying+masked star2d_r1 cells'
  chunks at the planner's tile: the earlier kernel on the haloed input,
  then the current one on the haloed input and in wrap mode on the
  unpadded state (the path's mode): old, halo, wrap, wrap, halo, old;
* the banded mixer at the prefill's shape (events) and at a decode
  step's, where it prints the device time of one launch by profiler and
  the host time per call (events over 20 back-to-back calls), each at
  its design's tile.

Prints one JSON object per shape and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


OLD_SOURCES = ("flash_attention", "stencil_step", "stencil_sweep",
               "banded_mixer")


def build_old(old: Path) -> dict:
    """Build every earlier source found in ``old``, in parallel."""
    from repro_torch.kernels import cuda_build
    out = old / "build"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in OLD_SOURCES:
        if not (old / f"{name}.cu").is_file():
            continue
        lib = out / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
             str(old / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _flat_table(taps, slab):
    """The first designs' tap table: the f32 coefficients' bits, then each
    tap's linear offset into the unpadded slab of extents ``slab``."""
    import numpy as np
    from repro_torch.kernels import stencil_mxu as sm
    strides = sm._slab_strides(slab, int(slab[-1]))
    coef = np.array([c for c, _ in taps], np.float32)
    offs = np.array([sum(g * st for g, st in zip(sm._as3(o, 0), strides))
                     for _, o in taps], np.int32)
    return np.concatenate([coef.view(np.int32), offs])


def old_flash(lib):
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, k, v):
        import torch
        b, h, s, dh = q.shape
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 int(q.dtype == torch.bfloat16), b * h, s, dh, 128, 128,
                 1.0 / math.sqrt(dh), 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier flash kernel: CUDA error {err}")
        return out
    return call


def old_step(lib, plan, x):
    """The earlier step kernel on ``plan`` (its table: coefficients, then
    offsets at the unpadded slab's strides)."""
    import torch
    from repro_torch.kernels import stencil_mxu as sm
    fn = lib.stencil_step_launch
    fn.argtypes = sm._C_ARGS + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    r = plan.spec.order
    table = torch.from_numpy(_flat_table(
        plan.taps, [b + 2 * r for b in plan.block])).to(x.device)
    out_shape = tuple(s - 2 * r for s in x.shape)

    def call():
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        sm._launch(fn, "earlier stencil_step", x, out, (), table,
                   len(plan.taps), 1, out_shape, plan.block,
                   sm._as3((r,) * plan.spec.ndim, 0))
        return out
    return call


def old_sweep(lib, plan, x, aux):
    """The earlier sweep kernel on ``plan`` over the haloed input ``x``
    (its table: coefficients, then offsets at the unpadded slab's
    strides)."""
    import torch
    from repro_torch.kernels import stencil_mxu as sm
    fn = lib.stencil_sweep_launch
    fn.argtypes = sm._C_ARGS + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    r, steps = plan.spec.order, plan.steps
    table = torch.from_numpy(_flat_table(
        plan.taps, [b + 2 * steps * r for b in plan.block])).to(x.device)
    out_shape = tuple(s - 2 * steps * r for s in x.shape)

    def call():
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        sm._launch(fn, "earlier stencil_sweep", x, out, aux, table,
                   len(plan.taps), 1, out_shape, plan.block,
                   sm._as3((r,) * plan.spec.ndim, 0), steps,
                   int(plan.scratch == "single"))
        return out
    return call


def old_mixer(lib, x, band, tile):
    """The earlier banded mixer at its tile, called as its wrapper did:
    the launcher's argument types set on every call."""
    import torch

    def call():
        fn = lib.banded_mixer_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = torch.empty_like(x)
        b, t_len, d = x.shape
        err = fn(x.data_ptr(), out.data_ptr(), band.data_ptr(),
                 int(band.ndim == 2), band.shape[0], 0, b, t_len, d, *tile,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier banded mixer: CUDA error {err}")
        return out
    return call


def _errors(fns: dict, plain, tol) -> dict:
    """max|kernel - plain| of each of ``fns``; raises past ``tol``."""
    import torch
    want = plain().float()
    errs = {}
    for key, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        errs[key] = (got.float() - want).abs().max().item()
        if not errs[key] <= tol:
            raise RuntimeError(f"{key} kernel off its plain version: "
                               f"{errs[key]:.3e} > {tol:g}")
    return errs


def turns(old, new, plain, tol):
    """max|kernel - plain| of each, then old, new, new, old."""
    import chip_smoke as cs
    errs = _errors({"old": old, "new": new}, plain, tol)
    ms = {"old": [], "new": []}
    for key in ("old", "new", "new", "old"):
        ms[key].append(cs.cuda_ms(old if key == "old" else new, reps=20))
    return {"old_ms": ms["old"], "new_ms": ms["new"],
            "max_abs_err": errs}


def sweep_rows(libs, dev):
    """The sweep kernels in turns at the two in-kernel cells' chunks."""
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.kernels import stencil_mxu as sm

    for cell in (cs.CELLS[0], cs.CELLS[3]):
        spec = cs.cell_spec(cell)
        run = api.compile(api.plan(
            api.StencilProblem(spec, grid=cell["grid"], boundary="periodic",
                               steps=cell["steps"]),
            backends=["cuda"], fuse_strategy=cell["strategy"]), device=dev)
        case = [c for c in cs.path_launches(cell, run, dev)
                if c["name"] == "stencil_sweep"][-1]
        xh, aux = case["haloed"], case["aux"]
        plan = sm.build_sweep_kernel_plan(case["spec"], case["cover"],
                                          case["block"], case["steps"])
        fns = {"old": old_sweep(libs["stencil_sweep"], plan, xh, aux),
               "halo": lambda: sm.sweep_cuda_call(xh, plan, aux),
               "wrap": case["kernel"]}
        errs = _errors(fns, case["plain"], cs.KERNEL_TOL["float32"])
        ms = {k: [] for k in fns}
        for key in ("old", "halo", "wrap", "wrap", "halo", "old"):
            ms[key].append(cs.cuda_ms(fns[key], reps=20))
        yield {"kernel": "stencil_sweep", "cell": cell["label"],
               "block": case["block"], "depth": case["steps"],
               "taps": len(plan.taps), "aux": len(aux),
               "state": tuple(case["x"].shape), "haloed": tuple(xh.shape),
               **{f"{k}_ms": v for k, v in ms.items()}, "max_abs_err": errs}
        del run, case, xh, aux, fns


def mixer_rows(libs, dev):
    """The banded mixers at the serve path's prefill and decode shapes."""
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import banded_mixer as bm

    cfg = get_config("hymba_1_5b")
    w, di = cfg.ssm.conv_width, cfg.ssm.expand * cfg.d_model
    batch = cs.SERVE["batch"]
    for label, t_len in (("prefill", cs.SERVE["prompt_len"] + w - 1),
                         ("decode", w)):
        shape = (batch, t_len, di)
        x = cs.seeded_normal(shape, 9000, dev)
        band = cs.seeded_normal((w, di), 9001, dev) / w
        old_tile = (min(128, t_len), 128)
        new_tile = (min(bm.BLOCK_T, t_len), bm.BLOCK_D)
        fns = {"old": old_mixer(libs["banded_mixer"], x, band, old_tile),
               "new": lambda x=x, band=band: bm.banded_mixer_cuda_call(
                   x, band, *new_tile)}
        row = {"kernel": "banded_mixer", "shape": shape,
               "dtype": "torch.float32", "band": f"depthwise W={w}",
               "old_tile": old_tile, "new_tile": new_tile}
        if label == "prefill":
            row.update(turns(fns["old"], fns["new"],
                             lambda: bm.banded_mixer_plain(x, band),
                             cs.KERNEL_TOL["float32"]))
            row["timed_by"] = "CUDA events"
        else:
            errs = _errors(fns, lambda: bm.banded_mixer_plain(x, band),
                           cs.KERNEL_TOL["float32"])
            dev_ms = {"old": [], "new": []}
            host_ms = {"old": [], "new": []}
            for key in ("old", "new", "new", "old"):
                dev_ms[key].append(cs.profiled_device_ms(
                    fns[key], "banded_mixer_kernel"))
                host_ms[key].append(cs.cuda_ms(fns[key], reps=20))
            row.update({"timed_by": "device time (profiler); host time per "
                                    "call (events over 20 calls)",
                        "old_ms": dev_ms["old"], "new_ms": dev_ms["new"],
                        "old_host_ms": host_ms["old"],
                        "new_host_ms": host_ms["new"], "max_abs_err": errs})
        yield row
        del x, band, fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory with the earlier sources (any of "
                         + ", ".join(f"{n}.cu" for n in OLD_SOURCES) + ")")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.core import coefficient_lines as cl
    from repro_torch.core import halo
    from repro_torch.core import temporal
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mxu as sm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = cs.nvidia_smi_line()
    libs = build_old(args.old)

    rows = []
    if "flash_attention" in libs:
        old_fa = old_flash(libs["flash_attention"])
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (cs.seeded_normal(cs.FLASH_SHAPE, 9100 + i, dev).to(dtype)
                       for i in range(3))
            tol = cs.FLASH_TOL[str(dtype).removeprefix("torch.")]
            res = turns(lambda: old_fa(q, k, v),
                        lambda: fa.flash_attention_cuda(q, k, v, causal=True),
                        lambda: fa.flash_attention_plain(q, k, v, True), tol)
            rows.append({"kernel": "flash_attention", "shape": cs.FLASH_SHAPE,
                         "dtype": str(dtype), "causal": True, **res})
            print(json.dumps(rows[-1]), flush=True)
            del q, k, v

    for cell in (cs.CELLS[1], cs.CELLS[2]) if "stencil_step" in libs else ():
        spec = cs.cell_spec(cell)
        p = api.plan(api.StencilProblem(spec, grid=cell["grid"],
                                        boundary="periodic",
                                        steps=cell["steps"]),
                     backends=["cuda"], fuse_strategy=cell["strategy"])
        depth = max(p.fuse_schedule)
        fspec = temporal.fuse_steps(spec, depth) if depth > 1 else spec
        r = fspec.order
        x = halo.pad_halo(cs.seeded_normal(cell["grid"], 2000 + depth, dev),
                          r, spec.ndim, "periodic")
        xb = ops._pad_to_multiple(x, p.block, r, spec.ndim)
        # the kernels sum the taps in row order, so the cover does not
        # change their work
        plan = sm.build_kernel_plan(
            fspec, cl.make_cover(fspec, "parallel"), p.block)
        res = turns(old_step(libs["stencil_step"], plan, xb),
                    lambda: sm.stencil_cuda_call(xb, plan),
                    lambda: sm.stencil_step_plain(xb, plan),
                    cs.KERNEL_TOL["float32"])
        rows.append({"kernel": "stencil_step", "cell": cell["label"],
                     "block": p.block, "depth": depth,
                     "taps": len(plan.taps), "input": tuple(xb.shape),
                     **res})
        print(json.dumps(rows[-1]), flush=True)
        del x, xb

    if "stencil_sweep" in libs:
        for row in sweep_rows(libs, dev):
            rows.append(row)
            print(json.dumps(row), flush=True)
    if "banded_mixer" in libs:
        for row in mixer_rows(libs, dev):
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
