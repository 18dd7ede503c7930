#!/usr/bin/env python3
"""Time an earlier design of the port's flash-attention and stencil-step
kernels against the current one, in turns, on one card.

The earlier sources are taken from git by the caller, so that the run
needs no repository history:

    mkdir -p _chip/old
    git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu > _chip/old/flash_attention.cu
    git show <commit>:src/repro_torch/kernels/csrc/stencil_step.cu > _chip/old/stencil_step.cu
    python3 tools/torch_kernel_turns.py --old _chip/old

The earlier sources must have the C interface of the first CUDA design of
the port (``flash_attention_launch`` with explicit query/key blocks;
``stencil_step_launch`` with a table of coefficients then slab offsets).
Both are built with the current ``cuda_build.NVCC_FLAGS`` into
``<old>/build``.  At the shapes ``chip_smoke.py`` times (flash attention
at (4, 25, 1536, 64) causal in f32 and bf16; the step kernel on the
box2d_r1 cell's fused operator and on the star3d_r2 cell's step, at the
tiles the planner picks), each pair runs old, new, new, old (CUDA
events, 20 launches each) after both were held against the plain
version.  Prints one JSON object per
shape and the card's name and power limit.
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


def build_old(old: Path) -> dict:
    from repro_torch.kernels import cuda_build
    out = old / "build"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("flash_attention", "stencil_step"):
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
    table = torch.from_numpy(sm._sweep_table(
        plan.taps, [b + 2 * r for b in plan.block])).to(x.device)
    out_shape = tuple(s - 2 * r for s in x.shape)

    def call():
        out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
        sm._launch(fn, "earlier stencil_step", x, out, (), table,
                   len(plan.taps), 1, out_shape, plan.block,
                   sm._as3((r,) * plan.spec.ndim, 0))
        return out
    return call


def turns(old, new, plain, tol):
    """max|kernel - plain| of each, then old, new, new, old."""
    import torch
    import chip_smoke as cs
    want = plain().float()
    errs = {}
    for key, fn in (("old", old), ("new", new)):
        got = fn()
        torch.cuda.synchronize()
        errs[key] = (got.float() - want).abs().max().item()
        if not errs[key] <= tol:
            raise RuntimeError(f"{key} kernel off its plain version: "
                               f"{errs[key]:.3e} > {tol:g}")
    ms = {"old": [], "new": []}
    for key in ("old", "new", "new", "old"):
        ms[key].append(cs.cuda_ms(old if key == "old" else new, reps=20))
    return {"old_ms": ms["old"], "new_ms": ms["new"],
            "max_abs_err": errs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory with the earlier flash_attention.cu and "
                         "stencil_step.cu")
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

    for cell in (cs.CELLS[1], cs.CELLS[2]):
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
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
