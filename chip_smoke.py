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
   bf16, B = 4, H = 25, S in {40, 128, 1536}, Dh in {8, 16, 64, 128}),
   ``ops.banded_mix``'s gradients (``dx`` by flip-mix-flip through the
   kernel, ``dband``) against autograd through the plain version at 1e-5
   x max|plain| (the train shape (2, 1024, 3200) depthwise, T = 1027, a
   shared band, and a leading batch beyond ``MAX_BATCH``), and
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
   program at batch 2;
14. the planner's calibration: ``api.calibrate(top_k=3, wall=True)`` on
   the four phase 4 cells at full size, the planner free
   (``backends=["cuda"]``): each measurement's modelled against counted
   flops and bytes, its time (CUDA events) against the modelled chunk
   time; the step and sweep kernels launched; the record's JSON round
   trip; one candidate of the 4096^2 cell counted again with
   ``device="cpu"`` and equal; each calibrated plan beside the
   uncalibrated one, compiled, run and held against the oracle at 1e-4;
   the pooled record through a file into ``plan_report``;
15. the differentiable stencil ``ops.stencil_apply_vjp`` at box2d_r1
   8192^2 f32 and star3d_r1 256^3, loss sum(cos(y)): one step launch for
   the forward and one for the adjoint, the step kernel's plain version
   never run; dx against plain autograd on the card at 1e-4, dC at 1e-4
   x sum|g x| per tap; forward and backward ms;
16. Hymba-1.5B trains at full width and depth through ``Trainer.run``:
   f32 parameters, bf16 compute, remat "full", batch 4 x 1024 tokens of
   ``SyntheticLM`` (seed 0) in 2 microbatches, AdamW at
   ``cosine_schedule(3e-4)``, 4 steps and the final checkpoint: loss and
   grad norm finite at every step, the last loss below the first, the
   banded mixer's forward and backward launches equal to 32 layers x 2
   microbatches x 4 steps x (2 forward + 1 backward) (counters zeroed
   just before ``run``); step time, tokens/s, the checkpoint's write
   time, peak memory, and one profiled step's device time by span;
17. (a) one f32-compute step at full width and depth (batch 1 x 1024),
   ``kernel_impl="cuda"`` against ``"ref"``: loss to a relative 1e-5,
   grad norm to 1e-4, every layer's ``conv_band`` gradient to 1e-3 x
   max|ref|; (b) Trainer recovery at full width, depth 2: 6 steps, a
   checkpoint every 2, faults before steps 3 and 5, in a subprocess with
   deterministic algorithms — bit-identical to an uninterrupted run;

and phase 6's row for the banded mixer's backward (``dx`` at (2, 1024,
3200) f32: 20 back-to-back backward calls, the launch alone, its byte
bound, autograd through the plain version and through ``F.conv1d``);
then the other LM families, one model at a time:

18. Qwen3-30B-A3B (4 x 1024, 16 tokens), RWKV-6 1.6B (4 x 1536, 32),
   MusicGen-large (4 x 4 codebooks x 1024 with (4, 64, 2048)
   conditioning, 32), Gemma-3 12B (4 x 1536, past its 1024 window, 32)
   and LLaVA-NeXT-34B (1 x 576 image + 512 text tokens, 16) serve at full
   width and depth in the bf16 serving build (seed 0; inputs
   ``sample_from_specs(prefill_specs(...), seed=1)``) through
   ``launch.serve.serve``, cold and warm: parameters, resident and peak
   GiB, prefill ms and decode ms/token (host clock, synchronised),
   finite logits of the expected shapes, warm ids equal to cold; MoE's
   tokens per expert in the prefill and no dropped assignment; every
   kernel counter zeroed just before the cold run and read just after
   (no kernel is on these paths: all must read 0); one profiled warm
   prefill and decode step split into matmuls, attention, MoE dispatch,
   RWKV chunk loop and other, with the device's idle share.  A model
   whose bf16 weights do not fit the card's free memory runs with its
   depth cut to what fits, and says so;
19. all nine of those architectures (the dense four, the MoE two,
   RWKV-6, MusicGen, LLaVA) in f32 at full width, one pattern cycle deep
   (at least two layers; Gemma-3's six): a 1040-token prefill (after a
   VLM's image tokens) against a 1000-token prefill + 40 decode steps,
   the last logits within phase 10's 1e-3 x max|logits|, no MoE
   assignment dropped;

then the distributed stencil path, on meshes of slots that all name the
card (one process drives every slot, as the JAX package drives its
mesh):

20. four cells through ``api.plan(StencilProblem(..., mesh=,
   grid_axes=))`` -> ``api.compile``: star2d_r2 8192^2 periodic inkernel
   on 2x2, box2d_r1 8192^2 zero operator on 4x1, star3d_r2 512^3
   periodic on 2x2 over axes 0-1, star2d_r2 batch 4 x 4096^2 periodic
   inkernel on 2x2: each against the gather oracle at 1e-4, against the
   same plan compiled on one device, and ``overlap=False`` bit-identical;
   the exchange census one exchange per fused chunk and named axis, and
   the kernel launches equal to the plan's (counters zeroed just before
   the run, read just after); every kernel configuration the path
   launched against its plain version at its shard shape; warm times
   (overlap, serial, one device) and one profiled run split into
   kernels, strip copies, haloed-buffer fills, other and idle;
21. mesh fault tolerance: a star2d_r2 8192^2 rollout on 4x1 slots with
   shard checkpoints, a seeded ``dist.exchange`` storm, the reshard to
   2x1, bit-identical to the fault-free run; ``StencilServer(mesh_shape=
   (2, 2))`` on four slots serving 16 star2d_r2 4096^2 requests, one slot
   evicted and the group mesh shrunk to 2x1, every result at 1e-4.

Any kernel-vs-plain error over its tolerance (phases 3, 5, 6, 8, 10 and
20), any main-path cell off its oracle, or any serve, server, chaos,
rollout, calibration, gradient, training, family or distributed check
that fails (phases 9-21) fails the run.

The last three lines are a JSON object ``{"kernels": [...]}`` (all four
kernels; ``launches`` is the count of each kernel's own path — phase 4
for the step and sweep kernels — and the step and sweep rows give the
counts of phases 4, 11, 12 (the seeded server), 13, 14 and 15 in
``launches_by_path``; the banded mixer's row counts phase 9's serve run,
with phase 16's train launches beside it, and the ``banded_mixer_backward``
row phase 16's backward launches; every row's ``launches_by_path`` also
holds ``lm_families``, phase 18's launches of that kernel, and the step
and sweep rows ``distributed`` and ``distributed_recovery``, phases 20
and 21), the card's ``name,
power.limit`` and ``{"ok": true, "device": {...}}``.  Without a card, or without the
repository's sources beside this file, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import gc
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

# phase 14: candidates measured per main-path cell
CALIBRATE_TOP_K = 3
# phase 20: the distributed path on slots of the card (the phase 4-7
# cells' sizes; the planner free apart from the strategy pin)
DIST_CELLS = (
    dict(label="star2d_r2 8192^2 inkernel on 2x2", name="star2d_r2",
         grid=(8192, 8192), steps=16, boundary="periodic",
         strategy="inkernel", mesh=(2, 2), grid_axes=("x", "y")),
    dict(label="box2d_r1 8192^2 zero operator on 4x1", name="box2d_r1",
         grid=(8192, 8192), steps=16, boundary="zero", strategy="operator",
         mesh=(4, 1), grid_axes=("x", "y")),
    dict(label="star3d_r2 512^3 on 2x2", name="star3d_r2",
         grid=(512, 512, 512), steps=8, boundary="periodic", strategy=None,
         mesh=(2, 2), grid_axes=("x", "y", "")),
    dict(label="star2d_r2 batch 4 4096^2 inkernel on 2x2", name="star2d_r2",
         grid=(4096, 4096), steps=16, boundary="periodic",
         strategy="inkernel", mesh=(2, 2), grid_axes=("x", "y"), batch=4),
)
# phase 21: mesh fault tolerance
DIST_RECOVERY = dict(cell="star2d_r2", grid=8192, segment=4,
                     serve_grid=4096, steps=16, requests=16, max_batch=4)
# phase 15: the differentiable stencil at full width; dC sums ~6.7e7
# products a tap at 8192^2, so it is held to this share of sum|g x|
VJP_CELLS = (dict(name="box2d_r1", grid=(8192, 8192)),
             dict(name="star3d_r1", grid=(256, 256, 256)))
VJP_DC_REL_TOL = 1e-4

# phase 8: banded_mix backward cases (leading axes, T, D, band kind); the
# last has a leading batch beyond the kernel's grid limit MAX_BATCH
BANDED_GRAD_CASES = (((2,), 1024, 3200, "depthwise"),
                     ((2,), 1027, 3200, "depthwise"),
                     ((2,), 1024, 3200, "shared"),
                     ((65535 + 3,), 6, 8, "depthwise"))
# dx and dband against autograd through the plain version: this share of
# max|plain|
BANDED_GRAD_REL_TOL = 1e-5
# phase 16: Hymba-1.5B trains at full width and depth (f32 parameters,
# bf16 compute, remat "full")
TRAIN = dict(batch=4, seq=1024, microbatches=2, steps=4, lr=3e-4, seed=0)
# phase 17a: one f32-compute step, kernel_impl "cuda" against "ref"
TRAIN_CHECK = dict(batch=1, seq=1024, seed=1)
TRAIN_CHECK_REL_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "conv_band": 1e-3}
# phase 17b: Trainer recovery at full width, depth 2 (one windowed and one
# global layer: the pattern's period cut from 8 to 2)
RECOVERY = dict(layers=2, period=2, batch=2, seq=256, steps=6, every=2,
                faults=(3, 5))
# phase 18: the other families served at full width and depth, bf16 (a
# VLM's prompt_len counts its image tokens: 576 + 512 text tokens)
FAMILY_SERVE = (
    dict(arch="qwen3_moe_30b_a3b", batch=4, prompt_len=1024, gen_len=16),
    dict(arch="rwkv6_1_6b", batch=4, prompt_len=1536, gen_len=32),
    dict(arch="musicgen_large", batch=4, prompt_len=1024, gen_len=32),
    dict(arch="gemma3_12b", batch=4, prompt_len=1536, gen_len=32),
    dict(arch="llava_next_34b", batch=1, prompt_len=576 + 512, gen_len=16),
)
# phase 19: every other architecture, f32 at full width, depth one pattern
# cycle: a prompt_len prefill against split + (prompt_len - split) decoded
# text tokens
FAMILY_ARCHS = ("yi_6b", "gemma_2b", "tinyllama_1_1b", "gemma3_12b",
                "musicgen_large", "rwkv6_1_6b", "llava_next_34b",
                "qwen3_moe_30b_a3b", "granite_moe_3b_a800m")
FAMILY_CONSISTENCY = dict(batch=2, prompt_len=1040, split=1000, seed=2)


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


def profiled_call_ms(fn, reps: int = 20):
    """Mean device time (ms) of every kernel one ``fn()`` launches, over
    ``reps`` calls, from ``torch.profiler``; None when it saw none."""
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
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA) / 1e3
    return total / reps if total else None


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


def banded_grad_cases(device):
    """Yield (label, kernel output, plain output, tolerance) for the
    gradients of ``ops.banded_mix`` (``dx`` by flip-mix-flip through the
    kernel, ``dband`` a reduction a tap) against autograd through the
    plain version on the card, for each of :data:`BANDED_GRAD_CASES`, at
    ``BANDED_GRAD_REL_TOL`` x max|plain|."""
    import torch
    from repro_torch.kernels import banded_mixer as bm
    from repro_torch.kernels import ops

    for i, (lead, t_len, d, kind) in enumerate(BANDED_GRAD_CASES):
        shape = lead + (t_len, d)
        x = seeded_normal(shape, 5500 + 3 * i, device)
        band = seeded_normal((4, d) if kind == "depthwise" else (4,),
                             5501 + 3 * i, device) / 4
        g = seeded_normal(shape, 5502 + 3 * i, device)
        grads = []
        for fn in (ops.banded_mix, bm.banded_mixer_plain):
            xr, br = x.clone().requires_grad_(), band.clone().requires_grad_()
            xin = xr if fn is ops.banded_mix else xr.reshape(-1, t_len, d)
            y = fn(xin, br).reshape(shape)
            grads.append(torch.autograd.grad(y, (xr, br), g))
        for j, what in enumerate(("dx", "dband")):
            got, want = grads[0][j], grads[1][j]
            tol = BANDED_GRAD_REL_TOL * want.abs().max().item()
            yield (f"banded_mix {what} x{shape} {kind} band f32 [tol = "
                   f"{BANDED_GRAD_REL_TOL:g} x max|plain|]", got, want, tol)
        del x, g, grads


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

    def record(x, band, block_t=bm.BLOCK_T, block_d=bm.BLOCK_D, **kw):
        seen.add((tuple(x.shape), tuple(band.shape), x.dtype, block_t,
                  block_d))
        return bm.banded_mixer_cuda_call(x, band, block_t, block_d, **kw)

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


def _device_split(prof, span_names=("attention", "ssm_scan")) -> dict:
    """Device time (ms) of a profiled run split into the banded mixer
    kernel, the spans ``span_names`` (every device op their code
    launched), the remaining matmuls, and the rest."""
    from torch.autograd import DeviceType

    def kernels_under(ev):
        yield from ev.kernels
        for ch in ev.cpu_children:
            yield from kernels_under(ch)

    total = banded = matmul = 0.0
    spans = dict.fromkeys(span_names, 0.0)
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

# ---------------------------------------------------------------------------
# phase 14: the planner's calibration on the card
# ---------------------------------------------------------------------------

def calibrate_cells(device, failures: list, cells=CELLS) -> dict:
    """Phase 14: ``api.calibrate(top_k=3, wall=True)`` on every main-path
    cell at full size, the planner free to choose (``backends=["cuda"]``);
    each measurement beside its model; the record's JSON round trip; one
    candidate of the varying+masked cell counted again on the CPU (the
    counts must not depend on the device); the calibrated plan beside the
    uncalibrated one, compiled, run and held against the oracle; and the
    pooled record through a file into ``plan_report``.  Returns the
    launches of the calibration runs."""
    import tempfile
    import torch
    from repro_torch import api
    from repro_torch.core.time_stepper import reference_evolve
    from repro_torch.launch import plan_report
    from repro_torch.launch.calibrate import factor_key

    cal_cells = []
    _zero_counts()                      # zeroed just before the path
    for cell in cells:
        problem = api.StencilProblem(cell_spec(cell), grid=cell["grid"],
                                     boundary="periodic",
                                     steps=cell["steps"])
        t0 = time.perf_counter()
        rec = api.calibrate(problem, top_k=CALIBRATE_TOP_K, wall=True,
                            backends=["cuda"], device=device)
        _sync(device)
        cal_cells.append((cell, problem, rec))
        log(f"  {cell['label']}: calibrated {len(rec.measurements)} "
            f"candidates in {time.perf_counter() - t0:.2f} s; factors "
            f"compute {rec.compute} traffic {rec.traffic}")
        for m in rec.measurements:
            c = api.candidate_cost(problem, m.depth, m.option, m.backend,
                                   block=m.block, strategy=m.strategy)
            chunk_ms = (max(c.t_compute, c.t_traffic) + c.t_launch) * 1e3
            wall_ms = m.wall_s * 1e3
            log(f"    {factor_key(m.backend, m.strategy)} "
                f"T={m.depth} {m.option} block "
                f"{'x'.join(map(str, m.block))}: flops modelled "
                f"{m.modelled_flops:.4e} counted {m.measured_flops:.4e} "
                f"(x{m.measured_flops / m.modelled_flops:.3f}), bytes "
                f"modelled {m.modelled_bytes:.4e} counted "
                f"{m.measured_bytes:.4e} "
                f"(x{m.measured_bytes / m.modelled_bytes:.3f}); chunk "
                f"{wall_ms:.3f} ms (CUDA events, median of 3) against "
                f"{chunk_ms:.3f} ms modelled (x{wall_ms / chunk_ms:.2f})")
        again = api.CalibrationRecord.from_json(rec.to_json())
        if again != rec or again.to_json() != rec.to_json():
            failures.append(f"calibration record JSON round trip: "
                            f"{cell['label']}")
        if not all(m.measured_flops > 0 and m.measured_bytes > 0
                   and m.wall_s and m.wall_s > 0 for m in rec.measurements):
            failures.append(f"calibration: {cell['label']}: a measurement "
                            f"without counts or time")
    counts = _read_counts()
    log(f"  launches over the calibration runs: {counts}")
    for name, n in counts.items():
        if n <= 0:
            failures.append(f"calibration never launched the {name} "
                            f"kernel")

    # the counts of one candidate do not depend on the device
    cell, problem, rec = next(c for c in cal_cells if c[0]["scenario"])
    m = rec.measurements[0]
    t0 = time.perf_counter()
    on_cpu = api.measure_candidate(problem, m.depth, m.option, m.backend,
                                   m.block, strategy=m.strategy,
                                   device="cpu")
    same = (on_cpu.measured_flops == m.measured_flops
            and on_cpu.measured_bytes == m.measured_bytes)
    log(f"  {cell['label']} {m.backend}:{m.strategy} T={m.depth}: counted "
        f"on the CPU flops {on_cpu.measured_flops:.6e} bytes "
        f"{on_cpu.measured_bytes:.6e}, on the card {m.measured_flops:.6e} "
        f"/ {m.measured_bytes:.6e} ({time.perf_counter() - t0:.1f} s)"
        f"{'' if same else '  FAIL'}")
    if not same:
        failures.append("calibration counts differ between the card and "
                        "the CPU")

    # the calibrated plans run, and agree with the oracle
    for i, (cell, problem, rec) in enumerate(cal_cells):
        p0 = api.plan(problem, backends=["cuda"])
        p1 = api.plan(problem, backends=["cuda"], calibration=rec)
        log(f"  {cell['label']}: uncalibrated {p0.fuse_strategy} "
            f"T={p0.fuse_depth} {p0.option} block "
            f"{'x'.join(map(str, p0.block))} {p0.chosen().t_per_step:.3e} "
            f"s/step; calibrated {p1.fuse_strategy} T={p1.fuse_depth} "
            f"{p1.option} block {'x'.join(map(str, p1.block))} "
            f"{p1.chosen().t_per_step:.3e} s/step")
        x = seeded_normal(cell["grid"], 4000 + i, device)
        y = api.compile(p1, device=device)(x)
        want = reference_evolve(problem.spec, x, cell["steps"], "periodic")
        err = (y - want).abs().max().item()
        ok = err <= E2E_ATOL and bool(torch.isfinite(y).all()) \
            and y.shape == x.shape
        log(f"    calibrated plan: max|port-oracle| {err:.3e} (tol "
            f"{E2E_ATOL:g}){'' if ok else '  FAIL'}")
        if not ok:
            failures.append(f"calibrated plan: {cell['label']}: {err:.3e}")
        del x, y, want

    # the pooled record, through a file, re-ranks the plan report
    pooled = api.CalibrationRecord.from_measurements(
        cal_cells[0][2].hw, {"cells": [c["label"] for c, _, _ in cal_cells]},
        [m for _, _, rec in cal_cells for m in rec.measurements])
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "calibration.json"
        path.write_text(pooled.to_json(indent=1))
        loaded = api.CalibrationRecord.from_json(path.read_text())
    report = plan_report.generate_report(calibration=loaded)
    plain_report = plan_report.generate_report()
    chosen = [ln for ln in report.splitlines() if ln.startswith("chosen")]
    was = [ln for ln in plain_report.splitlines() if ln.startswith("chosen")]
    # one table per PAPER_SUITE spec, and the distributed case
    tables = len(api.PAPER_SUITE()) + 1
    ok = (loaded == pooled and len(chosen) == tables
          and report.count("calibrated (") == tables)
    log(f"  pooled record: compute {pooled.compute} traffic "
        f"{pooled.traffic}; plan report re-ranked with it: "
        f"{sum(a != b for a, b in zip(chosen, was))} of {tables} choices "
        f"moved{'' if ok else '  FAIL'}")
    for a, b in zip(chosen, was):
        if a != b:
            log(f"    {b} -> {a}")
    if not ok:
        failures.append("plan report with the pooled calibration record")
    return {"launches": counts}


# ---------------------------------------------------------------------------
# phase 15: the differentiable stencil at full width
# ---------------------------------------------------------------------------

def _manual_loss_grads(x, c):
    """dx and dC of sum(cos(valid stencil)) through plain autograd: the
    stencil as a sum of shifted windows (the reference test's manual
    loss), on the tensors' device."""
    import numpy as np
    import torch
    xr = x.detach().clone().requires_grad_()
    cr = c.detach().clone().requires_grad_()
    out = [n - (c.shape[0] - 1) for n in x.shape]
    acc = None
    for off in np.ndindex(*c.shape):
        win = xr[tuple(slice(o, o + n) for o, n in zip(off, out))]
        acc = cr[off] * win if acc is None else acc + cr[off] * win
    torch.cos(acc).sum().backward()
    return xr.grad, cr.grad


def stencil_vjp_on_card(device, failures: list) -> dict:
    """Phase 15: ``ops.stencil_apply_vjp`` at full width, loss sum(cos(y)):
    the step kernel must launch for the forward and for the adjoint, the
    step kernel's plain version never; dx against plain autograd on the
    card at 1e-4, dC at 1e-4 x sum|g x| per tap; forward and backward ms
    by CUDA events."""
    import numpy as np
    import torch
    from repro_torch.core import stencil_spec as ss
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mxu as sm

    plain_calls = []
    real_plain = sm.stencil_step_plain

    def counting_plain(*args, **kwargs):
        plain_calls.append(1)
        return real_plain(*args, **kwargs)

    total = 0
    sm.stencil_step_plain = counting_plain
    try:
        for i, cell in enumerate(VJP_CELLS):
            spec = ss.PAPER_SUITE()[cell["name"]]
            x = seeded_normal(cell["grid"], 3000 + i, device)
            c = torch.tensor(np.asarray(spec.gather_coeffs, np.float32),
                             device=device)
            xg, cg = x.clone().requires_grad_(), c.clone().requires_grad_()
            _zero_counts()              # zeroed just before the path
            y = ops.stencil_apply_vjp(xg, cg)
            fwd = sm.stencil_cuda_call.launches
            torch.cos(y).sum().backward()
            _sync(device)
            bwd = sm.stencil_cuda_call.launches - fwd
            total += fwd + bwd
            rx, rc = _manual_loss_grads(x, c)
            g = -torch.sin(y.detach())
            bars = torch.stack([
                (g * x[tuple(slice(o, o + n) for o, n in
                             zip(off, g.shape))]).abs().sum()
                for off in np.ndindex(*c.shape)]).reshape(c.shape) \
                * VJP_DC_REL_TOL
            dx_err = (xg.grad - rx).abs().max().item()
            dc_err = (cg.grad - rc).abs()
            dc_ok = bool((dc_err <= bars).all())
            ok = (fwd == 1 and bwd == 1 and dx_err <= E2E_ATOL and dc_ok
                  and bool(torch.isfinite(xg.grad).all()))
            # times: the forward, and the backward alone on a kept graph
            fwd_ms = cuda_ms(lambda: ops.stencil_apply_vjp(x, c), reps=5)
            xk, ck = x.clone().requires_grad_(), c.clone().requires_grad_()
            yk = ops.stencil_apply_vjp(xk, ck)
            bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                yk, (xk, ck), g, retain_graph=True), reps=5)
            log(f"  {cell['name']} {'x'.join(map(str, cell['grid']))} f32: "
                f"step launches forward {fwd}, backward {bwd}; "
                f"max|dx - plain| {dx_err:.3e} (tol {E2E_ATOL:g}); "
                f"max|dC - plain| {dc_err.max().item():.3e} against "
                f"per-tap bars {bars.min().item():.3e}..."
                f"{bars.max().item():.3e} ({VJP_DC_REL_TOL:g} x sum|g x|); "
                f"forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms "
                f"(CUDA events, 5 calls){'' if ok else '  FAIL'}")
            if not ok:
                failures.append(f"stencil_apply_vjp: {cell['name']}: dx "
                                f"{dx_err:.3e}, dC within bars {dc_ok}, "
                                f"launches {fwd}/{bwd}")
            del x, y, xg, cg, rx, rc, g, xk, yk
    finally:
        sm.stencil_step_plain = real_plain
    if plain_calls:
        failures.append(f"the step kernel's plain version ran "
                        f"{len(plain_calls)} times on the card path")
    return {"launches": {"stencil_step": total, "stencil_sweep": 0}}


# ---------------------------------------------------------------------------
# phase 16: Hymba-1.5B trains at full width and depth
# ---------------------------------------------------------------------------

# profiler spans of the train step (``record_function`` in the port): the
# SSM scan's forward (and remat recompute) and backward, the banded mixer's
# backward (flips + the dx launch), attention and the CE forward (each with
# its recompute; their backward kernels fall under matmuls and other), and
# the optimizer
_TRAIN_SPANS = ("ssm_scan", "ssm_scan_backward", "banded_mix_backward",
                "attention", "cross_entropy", "adamw")


def _train_split(prof) -> dict:
    """Device time (ms) of a profiled train step: the banded mixer's
    forward launches (its kernel outside every span), each of
    :data:`_TRAIN_SPANS`, the matmuls outside the spans, and the rest;
    ``kernels``, the count of device kernels and copies.

    A step holds millions of profiler events, so this reads the raw
    events (``kineto_results``), not ``prof.events()``: a kernel belongs
    to the span, on its launching thread, that holds the start of the op
    it is linked to (the spans do not nest)."""
    import bisect

    from torch.autograd import DeviceType

    spans: dict = {}        # thread -> [(start, end, name)]
    ops: dict = {}          # correlation id -> (start, thread)
    kernels = []            # (name, ns, linked correlation id)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() != 0:
                continue                # a runtime call, not an op
            name = e.name()
            if name in _TRAIN_SPANS:
                spans.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.end_ns(), name))
            ops[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif e.device_type() == DeviceType.CUDA and \
                not e.is_user_annotation():
            kernels.append((e.name().lower(), e.end_ns() - e.start_ns(),
                            e.linked_correlation_id()))
    for lst in spans.values():
        lst.sort()
    starts = {t: [s[0] for s in lst] for t, lst in spans.items()}

    def span_of(corr):
        start, thread = ops.get(corr, (None, None))
        if thread not in spans:
            return None
        i = bisect.bisect_right(starts[thread], start) - 1
        if i >= 0 and start < spans[thread][i][1]:
            return spans[thread][i][2]
        return None

    split = dict.fromkeys(("total", "banded_mixer_forward") + _TRAIN_SPANS
                          + ("matmuls", "other"), 0.0)
    for name, ns, corr in kernels:
        ms = ns / 1e6
        split["total"] += ms
        span = span_of(corr)
        if span is not None:
            split[span] += ms
        elif "banded_mixer_kernel" in name:
            split["banded_mixer_forward"] += ms
        elif any(m in name for m in _MATMUL):
            split["matmuls"] += ms
        else:
            split["other"] += ms
    split["banded_mixer_backward"] = split.pop("banded_mix_backward")
    split["kernels"] = len(kernels)
    return split


def train_hymba(device, failures: list) -> dict:
    """Phase 16: ``Trainer.run`` on Hymba-1.5B at full width and depth
    (f32 parameters, bf16 compute, remat "full"), batch 4 x 1024 tokens of
    ``SyntheticLM`` (seed 0) in two microbatches, AdamW at
    ``cosine_schedule(3e-4)``, 4 steps and the final save.  The banded
    mixer's counters are zeroed just before ``run`` and read just after;
    then one more step under the profiler."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import banded_mixer as bm
    from repro_torch.optim.adamw import adamw, cosine_schedule
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t = TRAIN
    cfg = get_config("hymba_1_5b")
    ckpt_dir = ROOT / "_chip" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tr = Trainer(
        cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=t["seq"],
                        global_batch=t["batch"], seed=t["seed"]),
        TrainerConfig(total_steps=t["steps"], checkpoint_every=10 ** 9,
                      checkpoint_dir=str(ckpt_dir), log_every=1,
                      async_checkpoint=False,
                      microbatches=t["microbatches"]),
        optimizer=adamw(lr=cosine_schedule(t["lr"], warmup=1,
                                           total=t["steps"])),
        device=device)
    saves = []
    save = tr.ckpt.save

    def timed_save(*args, **kwargs):
        t0 = time.perf_counter()
        save(*args, **kwargs)
        saves.append(time.perf_counter() - t0)
    tr.ckpt.save = timed_save
    torch.cuda.reset_peak_memory_stats()
    bm.banded_mixer_cuda_call.launches = 0      # zeroed just before the path
    bm.banded_mixer_cuda_call.backward_launches = 0
    t0 = time.perf_counter()
    state = tr.run()
    run_s = time.perf_counter() - t0
    launches = bm.banded_mixer_cuda_call.launches
    backward = bm.banded_mixer_cuda_call.backward_launches
    peak = torch.cuda.max_memory_allocated()
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*")
                     if f.is_file())
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    log_ = tr.metrics_log
    losses = [m["loss"] for m in log_]
    norms = [m["grad_norm"] for m in log_]
    mb_batch = t["batch"] // t["microbatches"]
    per_pass = cfg.num_layers * t["microbatches"] * t["steps"] * -(
        -mb_batch // bm.MAX_BATCH)
    want = {"forward": 2 * per_pass, "backward": per_pass}
    got = {"forward": launches - backward, "backward": backward}
    finite = all(map(lambda v: v == v and abs(v) != float("inf"),
                     losses + norms))
    falls = len(losses) == t["steps"] and losses[-1] < losses[0]
    step_s = statistics.median(m["sec_per_step"] for m in log_[1:])
    tokens = t["batch"] * t["seq"]
    ok = finite and falls and got == want and int(state.step) == t["steps"]
    for m in log_:
        log(f"  step {m['step']}: loss {m['loss']:.4f}, grad norm "
            f"{m['grad_norm']:.4f}, {m['sec_per_step']:.3f} s (host clock)")
    log(f"  {cfg.name} {cfg.num_layers} layers, f32 parameters, "
        f"{cfg.compute_dtype} compute, remat {cfg.remat}: step "
        f"{step_s:.3f} s (median of steps 1-{t['steps'] - 1}), "
        f"{tokens / step_s:.0f} tokens/s; Trainer.run {run_s:.1f} s; final "
        f"checkpoint {ckpt_bytes / 2**30:.2f} GiB written in "
        f"{saves[-1]:.1f} s; peak memory {peak / 2**30:.2f} GiB; banded "
        f"mixer launches {got} (predicted {want}: {cfg.num_layers} layers x "
        f"{t['microbatches']} microbatches x {t['steps']} steps, forward "
        f"and remat recompute, and one dx); finite {finite}, last loss < "
        f"first {falls}{'' if ok else '  FAIL'}")
    if not ok:
        failures.append(f"train: finite={finite} falls={falls} launches="
                        f"{got}/{want} step={int(state.step)}")

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr._step(state, tr.pipeline.batch_at(t["steps"]))
        torch.cuda.synchronize()
    split = _train_split(prof)
    prof_s = time.perf_counter() - t0
    if split["total"] == 0.0:
        log("  profiled step: the profiler saw no device time: breakdown "
            "not measured")
    else:
        parts = ", ".join(f"{k} {v:.1f}" for k, v in split.items()
                          if k not in ("total", "kernels"))
        log(f"  profiled step: {split['kernels']} device kernels and copies,"
            f" device {split['total']:.1f} ms = {parts} ms; "
            f"device idle {max(0.0, 1 - split['total'] / (step_s * 1e3)):.1%}"
            f" of the unprofiled step (profiling and its read took "
            f"{prof_s:.1f} s)")
    del state, tr, prof
    torch.cuda.empty_cache()
    return {"launches": launches, "backward_launches": backward}


# ---------------------------------------------------------------------------
# phase 17: training correctness on the card
# ---------------------------------------------------------------------------

def train_consistency(device, failures: list) -> None:
    """Phase 17a: one f32-compute step of Hymba-1.5B at full width and
    depth (batch 1 x 1024): its loss and gradients with
    ``kernel_impl="cuda"`` (the banded mixer's kernel forward and
    backward) against ``"ref"`` (the shifted adds, autograd) on the same
    weights; the loss to a relative 1e-5, the global grad norm to 1e-4,
    each layer's ``conv_band`` gradient to 1e-3 x max|ref|."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import banded_mixer as bm
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.train_step import make_loss_fn

    c = TRAIN_CHECK
    cfg = dataclasses.replace(get_config("hymba_1_5b"),
                              compute_dtype="float32")
    model = tf.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device,
        trainable=True)
    batch = {k: torch.as_tensor(v).to(device) for k, v in SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=c["seq"],
                   global_batch=c["batch"], seed=c["seed"])).batch_at(0)
        .items()}
    res = {}
    for impl in ("cuda", "ref"):
        model.cfg = dataclasses.replace(cfg, kernel_impl=impl)
        for p in model.parameters():
            p.grad = None
        bm.banded_mixer_cuda_call.launches = 0
        bm.banded_mixer_cuda_call.backward_launches = 0
        loss, _ = make_loss_fn(model.cfg)(model, batch)
        loss.backward()
        torch.cuda.synchronize()
        res[impl] = {
            "loss": loss.item(),
            "norm": global_norm([p.grad for p in model.parameters()]).item(),
            "bands": [layer.ssm["conv_band"].grad.clone()
                      for layer in model.layers],
            "launches": (bm.banded_mixer_cuda_call.launches,
                         bm.banded_mixer_cuda_call.backward_launches)}
    model.cfg = cfg
    k, r = res["cuda"], res["ref"]
    tol = TRAIN_CHECK_REL_TOL
    loss_rel = abs(k["loss"] - r["loss"]) / abs(r["loss"])
    norm_rel = abs(k["norm"] - r["norm"]) / abs(r["norm"])
    band = max((a - b).abs().max().item() / b.abs().max().item()
               for a, b in zip(k["bands"], r["bands"]))
    # (all, backward): forward and remat recompute, and one dx, a layer
    want = (3 * cfg.num_layers, cfg.num_layers)
    ok = (loss_rel <= tol["loss"] and norm_rel <= tol["grad_norm"]
          and band <= tol["conv_band"] and r["launches"] == (0, 0)
          and k["launches"] == want)
    log(f"  f32, batch {c['batch']} x {c['seq']}, {cfg.num_layers} layers: "
        f"loss {k['loss']:.6f} (cuda) vs {r['loss']:.6f} (ref), relative "
        f"{loss_rel:.2e} (tol {tol['loss']:g}); grad norm {k['norm']:.6f} "
        f"vs {r['norm']:.6f}, relative {norm_rel:.2e} (tol "
        f"{tol['grad_norm']:g}); conv_band grads max|diff|/max|ref| over "
        f"layers {band:.2e} (tol {tol['conv_band']:g}); banded mixer "
        f"launches (all, backward) cuda {k['launches']} (expected {want}), "
        f"ref {r['launches']}{'' if ok else '  FAIL'}")
    if not ok:
        failures.append(f"train consistency: loss {loss_rel:.2e}, norm "
                        f"{norm_rel:.2e}, band {band:.2e}, launches "
                        f"{k['launches']}/{r['launches']}")
    del model, batch, res
    torch.cuda.empty_cache()


def _recovery_child(device="cuda") -> int:
    """Phase 17b's subprocess (``--train-recovery``): deterministic
    algorithms on (``CUBLAS_WORKSPACE_CONFIG`` set by the parent before
    the process starts); Hymba-1.5B at full width and depth 2 trained for
    6 steps uninterrupted, and again with a checkpoint every 2 steps and
    faults injected before steps 3 and 5.  Prints one JSON line."""
    import dataclasses
    import shutil

    import torch
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    r = RECOVERY
    cfg = dataclasses.replace(get_config("hymba_1_5b"),
                              num_layers=r["layers"],
                              local_global_period=r["period"])
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=r["seq"],
                      global_batch=r["batch"], seed=0)
    base = ROOT / "_chip" / "recovery"
    shutil.rmtree(base, ignore_errors=True)
    pending = set(r["faults"])
    hit = []

    def inject(step):
        if step in pending:
            pending.discard(step)
            hit.append(step)
            raise RuntimeError(f"injected@{step}")

    finals, secs = [], []
    for name, every, injector in (("plain", 10 ** 9, None),
                                  ("faulted", r["every"], inject)):
        t0 = time.perf_counter()
        tr = Trainer(cfg, dcfg, TrainerConfig(
            total_steps=r["steps"], checkpoint_every=every,
            checkpoint_dir=str(base / name), log_every=1,
            async_checkpoint=False), fault_injector=injector,
            device=device)
        finals.append(tr.run())
        secs.append(time.perf_counter() - t0)
    a, b = finals
    pairs = list(zip(a.params.parameters(), b.params.parameters()))
    pairs += [(a.opt.mu[k], b.opt.mu[k]) for k in a.opt.mu]
    pairs += [(a.opt.nu[k], b.opt.nu[k]) for k in a.opt.nu]
    identical = all(torch.equal(x, y) for x, y in pairs)
    diff = max((x - y).abs().max().item() for x, y in pairs)
    shutil.rmtree(base, ignore_errors=True)
    print(json.dumps({"identical": identical, "max_abs_diff": diff,
                      "faults_hit": hit, "steps": [int(a.step), int(b.step)],
                      "seconds": secs}))
    return 0


def train_recovery(device, failures: list) -> None:
    """Phase 17b: :func:`_recovery_child` in a subprocess, where
    ``CUBLAS_WORKSPACE_CONFIG`` is set before the first cuBLAS handle and
    deterministic algorithms are on; the faulted run's parameters and
    moments must equal the uninterrupted run's bit for bit."""
    import os

    import torch
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--train-recovery"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    took = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    try:
        res = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        log(f"  recovery subprocess exited {out.returncode}; stderr tail:\n"
            f"{out.stderr[-2000:]}  FAIL")
        failures.append(f"train recovery: subprocess exit {out.returncode}")
        return
    r = RECOVERY
    ok = (out.returncode == 0 and res["identical"]
          and res["faults_hit"] == list(r["faults"])
          and res["steps"] == [r["steps"], r["steps"]])
    log(f"  depth {r['layers']} (period {r['period']}), batch {r['batch']} x "
        f"{r['seq']}, {r['steps']} steps, checkpoint every {r['every']}, "
        f"faults before steps {res['faults_hit']}: final parameters and "
        f"moments bit-identical to the uninterrupted run {res['identical']} "
        f"(max|diff| {res['max_abs_diff']:.3e}; deterministic algorithms, "
        f"CUBLAS_WORKSPACE_CONFIG=:4096:8); runs {res['seconds'][0]:.1f} s "
        f"and {res['seconds'][1]:.1f} s, subprocess {took:.1f} s"
        f"{'' if ok else '  FAIL'}")
    if not ok:
        failures.append(f"train recovery: {res}")


def time_banded_backward(device, train: dict, failures: list) -> dict:
    """Phase 6's row for the banded mixer's backward at the train shape
    (2, 1024, 3200) f32 depthwise: ``dx`` by flip-mix-flip (CUDA events
    over 20 back-to-back backward calls of ``ops.banded_mix``, and the
    launch alone), its byte bound (g read, dx written), autograd through
    the plain version, and autograd of ``F.conv1d(groups=D)``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import banded_mixer as bm
    from repro_torch.kernels import ops

    shape, w = (2, 1024, 3200), 4
    d = shape[-1]
    x = seeded_normal(shape, 9300, device)
    band = seeded_normal((w, d), 9301, device) / w
    g = seeded_normal(shape, 9302, device)
    weight = band.flip(0).t().contiguous()[:, None, :]

    def graph(fn):
        xr = x.clone().requires_grad_()
        return xr, fn(xr)
    xk, yk = graph(lambda xr: ops.banded_mix(xr, band))
    xp, yp = graph(lambda xr: bm.banded_mixer_plain(xr, band))
    xl, yl = graph(lambda xr: F.conv1d(F.pad(xr.transpose(1, 2), (w - 1, 0)),
                                       weight, groups=d).transpose(1, 2))
    row = _time_row(
        "banded_mixer_backward",
        "src/repro_torch/kernels/csrc/banded_mixer.cu",
        "src/repro/kernels/banded_mixer.py:53", train["backward_launches"],
        failures,
        kernel=lambda: torch.autograd.grad(yk, xk, g, retain_graph=True)[0],
        plain=lambda: torch.autograd.grad(yp, xp, g, retain_graph=True)[0],
        library=lambda: torch.autograd.grad(yl, xl, g,
                                            retain_graph=True)[0],
        inputs=(g, band), flops_per_out=2 * w,
        desc=f"banded_mix backward dx (flip-mix-flip) x{shape} f32 "
             f"depthwise W={w}", library_name="F.conv1d(groups=D) autograd")
    gf = torch.flip(g, dims=(-2,))
    launch_ms = cuda_ms(lambda: bm.banded_mixer_cuda_call(gf, band), reps=20)
    device_ms = profiled_call_ms(
        lambda: torch.autograd.grad(yk, xk, g, retain_graph=True))
    log(f"  banded_mix backward: the dx launch alone {launch_ms:.4f} ms "
        f"(bound {row['bound_ms']:.4f} ms, {row['bound_ms'] / launch_ms:.1%}"
        f" of it); a backward call's device time (two flips and the "
        f"launch, torch.profiler, 20 calls) "
        f"{'not measured' if device_ms is None else f'{device_ms:.4f} ms'}"
        f", of the {row['ms']:.4f} ms a call takes back to back (the "
        f"host's autograd call)")
    row["launch_ms"] = launch_ms
    row["device_ms"] = device_ms
    del x, g, gf, xk, yk, xp, yp, xl, yl
    return row


# ---------------------------------------------------------------------------
# phase 18: the other families serve at full width and depth
# phase 19: their serving consistency at full width, f32
# ---------------------------------------------------------------------------

# GiB kept free beside a model's weights: its f32 draw of a layer, the
# embedding and head (cast once the model is built), and the activations
FAMILY_HEADROOM_GIB = 6.0


def _kernel_counters() -> dict:
    from repro_torch.kernels import banded_mixer as bm
    from repro_torch.kernels import flash_attention as fa
    return {**_stencil_counters(), "banded_mixer": bm.banded_mixer_cuda_call,
            "flash_attention": fa.flash_attention_cuda}


def _fitting_depth(cfg) -> int:
    """The largest depth (a multiple of the pattern) whose bf16 serving
    build fits in the card's free memory with ``FAMILY_HEADROOM_GIB``
    beside it: the full depth when it fits."""
    import dataclasses

    import torch
    from repro_torch.models import transformer as tf

    free = torch.cuda.mem_get_info()[0] - FAMILY_HEADROOM_GIB * 2**30
    whole = cfg.param_count() * 2
    if whole <= free:
        return cfg.num_layers
    outer = dataclasses.replace(cfg, num_layers=0).param_count() * 2
    period = len(tf.build_pattern(cfg))
    fits = int((free - outer) // ((whole - outer) / cfg.num_layers))
    return max(period, fits // period * period)


def _moe_recorder(seen: list):
    """Register a dispatch observer that keeps every group's tokens per
    expert and dropped assignments; returns the function that removes
    it."""
    from repro_torch.models import moe

    def observe(counts, dropped):
        seen.append((counts.detach().clone(), dropped.detach().clone()))
    moe.DISPATCH_OBSERVERS.append(observe)
    return lambda: moe.DISPATCH_OBSERVERS.remove(observe)


def serve_family(device, failures: list, case: dict) -> dict:
    """Phase 18, one architecture: build it at full width (full depth
    unless the card cannot hold it: the cut is printed) in the bf16
    serving build from seed 0, serve ``prefill_specs`` inputs (seed 1)
    through ``launch.serve.serve`` cold and warm, and profile one warm
    prefill and one decode step.  Every kernel counter is zeroed just
    before the cold run and read just after: no kernel is on these
    paths."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.launch.input_specs import prefill_specs, sample_from_specs
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tf
    from repro_torch.train.serve_step import (make_decode_step, make_prefill,
                                              pick)

    full = get_config(case["arch"])
    torch.cuda.empty_cache()
    depth = _fitting_depth(full)
    cfg = dataclasses.replace(full, num_layers=depth)
    cut = "" if depth == full.num_layers else \
        f" DEPTH CUT {full.num_layers} -> {depth} layers to fit the card"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tf.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    resident = torch.cuda.memory_allocated()
    build_peak = torch.cuda.max_memory_allocated()
    log(f"  {cfg.name}: {n_params} parameters (param_count() "
        f"{cfg.param_count()}) built on the card in {build_s:.1f} s, "
        f"{cfg.num_layers} layers{cut}, resident {resident / 2**30:.2f} "
        f"GiB, build peak {build_peak / 2**30:.2f} GiB")
    inputs = {k: v.to(device) for k, v in sample_from_specs(
        prefill_specs(cfg, case["batch"], case["prompt_len"]), cfg,
        seed=1).items()}
    kw = {k: inputs[k] for k in ("patch_embeds", "cond") if k in inputs}
    gen_len = case["gen_len"]
    counters = _kernel_counters()
    moe_seen: list = []
    remove = _moe_recorder(moe_seen) if cfg.moe is not None else None
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0                          # zeroed just before the path
    try:
        cold = serve(model, inputs["tokens"], gen_len, **kw)
    finally:
        if remove is not None:
            remove()
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    warm = serve(model, inputs["tokens"], gen_len, **kw)

    b, k = case["batch"], cfg.num_codebooks
    positions = inputs["tokens"].shape[-1] + (
        cfg.num_image_tokens if "patch_embeds" in kw else 0)
    want_ids = (b, k, gen_len) if k else (b, gen_len)
    want_logits = (b, k, cfg.vocab_size) if k else (b, cfg.vocab_size)
    finite = all(bool(torch.isfinite(l).all()) for l in cold["logits"])
    shapes_ok = (tuple(cold["ids"].shape) == want_ids
                 and tuple(cold["logits"][0].shape) == want_logits
                 and cold["state"].length == positions + gen_len)
    same = bool(torch.equal(cold["ids"], warm["ids"]))
    no_kernel = not any(launches.values())
    ok = finite and shapes_ok and same and no_kernel
    moe_note = ""
    if cfg.moe is not None:
        prefill_counts = torch.stack([c for c, _ in moe_seen[:cfg.num_layers]])
        dropped = int(sum(int(d) for _, d in moe_seen))
        tokens = b * inputs["tokens"].shape[-1]
        count_ok = bool((prefill_counts.sum(-1)
                         == tokens * cfg.moe.top_k).all())
        ok = ok and dropped == 0 and count_ok and \
            len(moe_seen) == cfg.num_layers * (1 + gen_len)
        moe_note = (f"; prefill tokens per expert min "
                    f"{int(prefill_counts.min())} max "
                    f"{int(prefill_counts.max())} (mean "
                    f"{tokens * cfg.moe.top_k / cfg.moe.num_experts:.0f}), "
                    f"dropped assignments {dropped} over prefill and decode")
    for run, out in (("cold", cold), ("warm", warm)):
        log(f"  serve {run}: prefill {b}x{positions} "
            f"{out['prefill_ms']:.1f} ms, decode {gen_len} tokens "
            f"{out['decode_ms']:.1f} ms ({out['decode_ms'] / gen_len:.2f} "
            f"ms/token) (host clock, synchronised)")
    log(f"  finite logits {finite}, shapes ok {shapes_ok}, warm ids == cold "
        f"ids {same}, kernel launches {launches}, peak memory "
        f"{peak / 2**30:.2f} GiB{moe_note}{'' if ok else '  FAIL'}")
    if not ok:
        failures.append(f"serve {cfg.name}: finite={finite} shapes="
                        f"{shapes_ok} same={same} launches={launches}"
                        f"{moe_note}")

    prefill = make_prefill(cfg, positions + gen_len + 1)
    decode = make_decode_step(cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    spans = ("attention", "moe_dispatch", "rwkv_chunks")
    splits = {}
    with torch.no_grad():
        with profile(activities=acts) as p_prefill:
            last, state = prefill(model, inputs["tokens"], **kw)
            torch.cuda.synchronize()
        tok = pick(cfg, last)
        last, state = decode(model, state, tok, cond=kw.get("cond"))
        torch.cuda.synchronize()
        with profile(activities=acts) as p_decode:
            decode(model, state, pick(cfg, last), cond=kw.get("cond"))
            torch.cuda.synchronize()
    for stage, prof, wall in (
            ("prefill", p_prefill, warm["prefill_ms"]),
            ("decode step", p_decode, warm["decode_ms"] / gen_len)):
        split = _device_split(prof, spans)
        n_kernels = sum(1 for ev in prof.events()
                        if ev.device_type == DeviceType.CUDA
                        and not ev.is_user_annotation)
        if split["total"] == 0.0:
            log(f"  {stage}: warm {wall:.3f} ms (host clock); the profiler "
                f"saw no device time: breakdown not measured")
            continue
        parts = ", ".join(f"{k} {v:.3f}" for k, v in split.items()
                          if k not in ("total", "banded_mixer"))
        idle = max(0.0, 1 - split["total"] / wall)
        splits[stage] = dict(split, wall=wall, idle=idle, kernels=n_kernels)
        log(f"  {stage}: warm {wall:.3f} ms (host clock); {n_kernels} device "
            f"kernels, device {split['total']:.3f} ms = {parts} ms; device "
            f"idle {idle:.1%} of the warm run")
    result = {"arch": case["arch"], "layers": cfg.num_layers,
              "launches": launches, "peak_gib": peak / 2**30,
              "prefill_ms": warm["prefill_ms"],
              "decode_ms_per_token": warm["decode_ms"] / gen_len,
              "splits": splits}
    del model, cold, warm, last, state, inputs, kw, p_prefill, p_decode
    torch.cuda.empty_cache()
    return result


def serve_families(device, failures: list) -> dict:
    """Phase 18: every case of ``FAMILY_SERVE``, one model at a time.
    Returns each kernel's launches summed over the phase."""
    total: dict = {}
    for case in FAMILY_SERVE:
        log(f"  -- {case['arch']}: batch {case['batch']} x "
            f"{case['prompt_len']}, {case['gen_len']} tokens generated")
        out = serve_family(device, failures, case)
        for k, v in out["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def family_consistency(device, failures: list, arch: str) -> None:
    """Phase 19, one architecture: full width, f32 compute, depth cut to
    one pattern cycle (at least two layers); the last logits of a
    ``prompt_len``-token prefill against a ``split``-token prefill
    followed by decode steps, both with ``max_len`` one past the prompt's
    positions; 1e-3 x max|logits|, phase 10's bar."""
    import dataclasses

    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.input_specs import prefill_specs, sample_from_specs
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models import transformer as tf
    from repro_torch.train.serve_step import make_decode_step, make_prefill

    c = FAMILY_CONSISTENCY
    full = get_config(arch)
    depth = max(len(tf.build_pattern(full)), 2)
    cfg = dataclasses.replace(full, compute_dtype="float32",
                              num_layers=depth)
    torch.cuda.empty_cache()
    model = tf.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    inputs = {k: v.to(device) for k, v in sample_from_specs(
        prefill_specs(cfg, c["batch"], c["prompt_len"] + cfg.num_image_tokens),
        cfg, seed=c["seed"]).items()}
    kw = {k: inputs[k] for k in ("patch_embeds", "cond") if k in inputs}
    tokens = inputs["tokens"]
    positions = tokens.shape[-1] + cfg.num_image_tokens
    prefill = make_prefill(cfg, positions + 1)
    decode = make_decode_step(cfg)
    moe_seen: list = []
    remove = _moe_recorder(moe_seen) if cfg.moe is not None else None
    try:
        with torch.no_grad():
            whole, _ = prefill(model, tokens, **kw)
            last, state = prefill(model, tokens[..., :c["split"]], **kw)
            for t in range(c["split"], tokens.shape[-1]):
                last, state = decode(model, state, tokens[..., t:t + 1],
                                     cond=kw.get("cond"))
    finally:
        if remove is not None:
            remove()
    rings = sum(isinstance(cache, kvc.RingKVCache)
                for cache in state.caches)
    dropped = sum(int(d) for _, d in moe_seen)
    scale = whole.abs().max().item()
    err = (last - whole).abs().max().item()
    tol = CONSISTENCY_REL_TOL * scale
    ok = err <= tol and bool(torch.isfinite(whole).all()) and dropped == 0 \
        and state.length == positions
    log(f"  {cfg.name} ({depth} layers, f32, batch {c['batch']}): prefill "
        f"{positions} vs prefill {positions - tokens.shape[-1] + c['split']}"
        f" + decode {tokens.shape[-1] - c['split']} ({rings} ring caches"
        f"{', dropped MoE assignments %d' % dropped if cfg.moe else ''}): "
        f"max|diff| of the last logits {err:.3e} (tol {tol:.3e} = "
        f"{CONSISTENCY_REL_TOL:g} x max|logits| {scale:.3f})"
        f"{'' if ok else '  FAIL'}")
    if not ok:
        failures.append(f"{cfg.name} consistency: {err:.3e} > {tol:.3e} "
                        f"(dropped={dropped}, length={state.length})")
    del model, whole, last, state, inputs, kw
    torch.cuda.empty_cache()


def lm_families(device, failures: list) -> dict:
    """Phases 18-19; returns phase 18's kernel launches by kernel."""
    t0 = time.perf_counter()
    log("phase 18: the other families serve at full width and depth, bf16: "
        + "; ".join(f"{c['arch']} {c['batch']} x {c['prompt_len']}, "
                    f"{c['gen_len']} tokens" for c in FAMILY_SERVE))
    launches = serve_families(device, failures)
    log("phase 19: prefill against prefill + decode, f32, full width, one "
        "pattern cycle deep, for every other architecture")
    for arch in FAMILY_ARCHS:
        family_consistency(device, failures, arch)
    log(f"  phases 18-19 took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 20: the distributed path on a mesh of slots of the card
# phase 21: mesh fault tolerance (rollout reshard, server mesh shrink)
# ---------------------------------------------------------------------------

def _named_axes(cell) -> int:
    return sum(1 for a in cell["grid_axes"] if a)


def dist_plan_launches(eplan, n_slots: int) -> dict:
    """Kernel launches one call of a distributed plan makes: each slot
    runs :func:`plan_launches`'s chunks on its block, and under
    Dirichlet-0 every chunk deeper than 1 re-evolves 2 strips per axis by
    ``t`` base steps (step-kernel launches)."""
    per = plan_launches(eplan)
    if eplan.boundary == "zero":
        per["stencil_step"] += sum(2 * eplan.spec.ndim * t
                                   for t in eplan.fuse_schedule if t > 1)
    return {k: v * n_slots for k, v in per.items()}


class _Recording:
    """Record one input of every distinct (kernel, plan, input shape) the
    kernel wrappers are handed, until :meth:`restore`.  ``ops`` reaches
    the wrappers through a stand-in of its ``stencil_mxu`` module; the
    wrappers themselves (and their launch counters) stay in place."""

    def __init__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels import stencil_mxu as sm
        self.seen: dict = {}
        rec = self

        class Module:
            def __getattr__(self, name):
                return getattr(sm, name)

            @staticmethod
            def stencil_cuda_call(x, plan, aux=()):
                rec._note("stencil_step", x, plan, aux)
                return sm.stencil_cuda_call(x, plan, aux)

            @staticmethod
            def sweep_cuda_call(x, plan, aux=()):
                rec._note("stencil_sweep", x, plan, aux)
                return sm.sweep_cuda_call(x, plan, aux)

        self._ops, self._sm = ops, sm
        ops.stencil_mxu = Module()

    def _note(self, name, x, plan, aux):
        key = (name, plan.spec.describe(), tuple(plan.block),
               getattr(plan, "steps", 1), tuple(x.shape), len(aux))
        if key not in self.seen:
            self.seen[key] = (x.clone(), plan, tuple(aux))

    def restore(self):
        self._ops.stencil_mxu = self._sm


def _dist_split(prof, wall_ms: float) -> str:
    """Device time of a profiled distributed run: the two stencil
    kernels, the strip copies (kernels under ``dist.exchange``), the
    haloed-buffer fills (under ``dist.halo_fill``), the Dirichlet-0 strip
    glue, everything else; idle share against ``wall_ms``."""
    from torch.autograd import DeviceType
    kernels, busy = 0.0, 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("dist."):
            continue
        ms = ev.self_device_time_total / 1e3
        busy += ms
        if "stencil_step_kernel" in ev.key or \
                "stencil_sweep_kernel" in ev.key:
            kernels += ms
    ranges = {"dist.exchange": 0.0, "dist.halo_fill": 0.0}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name in ranges:
            ranges[ev.name] += ev.device_time_total / 1e3
    if busy == 0.0:
        return "the profiler saw no device time: split not measured"
    other = busy - kernels - sum(ranges.values())
    return (f"device {busy:.3f} ms = kernels {kernels:.3f} + strip copies "
            f"{ranges['dist.exchange']:.3f} + haloed-buffer fills "
            f"{ranges['dist.halo_fill']:.3f} + other {other:.3f} ms; "
            f"device idle {max(0.0, 1 - busy / wall_ms):.1%} of the "
            f"{wall_ms:.1f} ms warm run")


def _warm_ms(fn, x, device, reps: int = 3) -> float:
    """Median host-clock ms of ``reps`` calls, each ending in a
    synchronize."""
    walls = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn(x)
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def distributed_cells(device, failures: list, cells=DIST_CELLS) -> dict:
    """Phase 20: every cell through ``api.plan`` -> ``api.compile`` on a
    mesh of slots of ``device``: the oracle at 1e-4, the same plan
    compiled on one device, ``overlap=False`` bit-identical, the exchange
    census and the kernel launches against the plan, every kernel
    configuration the path launched against its plain version at its
    shard shape, warm times and a profiled split."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import api
    from repro_torch.core import distributed as dist
    from repro_torch.core.time_stepper import reference_evolve
    from repro_torch.launch.mesh import make_mesh

    smi = nvidia_smi_line() if device.type == "cuda" else "no card"
    total = {"stencil_step": 0, "stencil_sweep": 0}
    want_total = {"stencil_step": 0, "stencil_sweep": 0}
    seen: dict = {}
    for i, cell in enumerate(cells):
        spec = api.PAPER_SUITE()[cell["name"]]
        n = int(np.prod(cell["mesh"]))
        mesh = make_mesh(cell["mesh"], ("x", "y")[:len(cell["mesh"])],
                         devices=[device] * n)
        batch = cell.get("batch", 1)
        problem = api.StencilProblem(spec, cell["grid"],
                                     boundary=cell["boundary"],
                                     steps=cell["steps"], batch=batch,
                                     mesh=mesh, grid_axes=cell["grid_axes"])
        t0 = time.perf_counter()
        p = api.plan(problem, backends=["cuda"],
                     fuse_strategy=cell["strategy"])
        run = api.compile(p, mesh=mesh)
        serial = api.compile(p, mesh=mesh, overlap=False)
        single = api.compile(dataclasses.replace(p, sharding=None,
                                                 halo_strategy="pad"),
                             device=device)
        log(f"  {cell['label']}: plan cover={p.option} block={p.block} "
            f"fuse={p.fuse_depth} strategy={p.fuse_strategy} schedule="
            f"{p.schedule_str()} halo={p.halo_strategy} width="
            f"{p.halo_width}, local block {problem.local_grid()} "
            f"({time.perf_counter() - t0:.2f}s to plan+compile)")
        shape = ((batch,) if batch > 1 else ()) + tuple(cell["grid"])
        x = seeded_normal(shape, 4000 + i, device)
        run(x)                                  # first call: builds plans
        _sync(device)
        rec = _Recording()
        try:
            _zero_counts()
            dist.reset_exchange_counts()
            y = run(x)
            _sync(device)
            counts = _read_counts()
            census = dict(dist.exchange_counts)
        finally:
            rec.restore()
        want = dist_plan_launches(p, n)
        for k in total:
            total[k] += counts[k]
            want_total[k] += want[k]
        chunks = len(p.fuse_schedule)
        ok_census = (census["exchanges"] == chunks * _named_axes(cell)
                     and census["permutes"] == 2 * census["exchanges"]
                     and counts == want)
        log(f"  {cell['label']}: census {census} ({chunks} chunks x "
            f"{_named_axes(cell)} named axes), launches {counts} (plan "
            f"implies {want}){'' if ok_census else '  FAIL'}")
        if not ok_census:
            failures.append(f"distributed census: {cell['label']}: "
                            f"{census}, {counts} vs {want}")
        oracle = reference_evolve(spec, x, cell["steps"], cell["boundary"])
        err = (y - oracle).abs().max().item()
        del oracle
        err_single = (y - single(x)).abs().max().item()
        same = torch.equal(y, serial(x))
        finite = bool(torch.isfinite(y).all())
        ok = (err <= E2E_ATOL and err_single <= E2E_ATOL and same and finite
              and y.shape == x.shape and y.dtype == x.dtype)
        log(f"  {cell['label']}: max|mesh-oracle| {err:.3e}, max|mesh-one "
            f"device| {err_single:.3e} (tol {E2E_ATOL:g}), overlap=False "
            f"bit-identical {same}, finite {finite}{'' if ok else '  FAIL'}")
        if not ok:
            failures.append(f"distributed: {cell['label']}: {err:.3e} / "
                            f"{err_single:.3e} / overlap {same}")
        for key, case in rec.seen.items():
            seen.setdefault(key, case)
        if device.type == "cuda":
            wall = _warm_ms(run, x, device)
            wall_serial = _warm_ms(serial, x, device)
            wall_single = _warm_ms(single, x, device)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run(x)
                _sync(device)
            log(f"  {cell['label']}: warm run {wall:.3f} ms (overlap), "
                f"{wall_serial:.3f} ms (overlap=False), same plan on one "
                f"device {wall_single:.3f} ms (host clock, median of 3; "
                f"{smi}); profiled run: {_dist_split(prof, wall)}")
            del prof
        del x, y
    # every kernel configuration the path launched, at its shard shape
    for (name, sdesc, block, steps, xshape, n_aux), (xin, kplan, aux) in \
            sorted(seen.items(), key=lambda kv: repr(kv[0])):
        from repro_torch.kernels import stencil_mxu as sm
        kernel = sm.sweep_cuda_call if name == "stencil_sweep" \
            else sm.stencil_cuda_call
        plain = sm.sweep_plain if name == "stencil_sweep" \
            else sm.stencil_step_plain
        got, want_ = kernel(xin, kplan, aux), plain(xin, kplan, aux)
        _sync(device)
        err = (got.float() - want_.float()).abs().max().item()
        tol = KERNEL_TOL[str(got.dtype).removeprefix("torch.")]
        ok = err <= tol and got.shape == want_.shape
        log(f"  {name} on the distributed path: {sdesc}, block {block}, "
            f"T={steps}, {n_aux} aux, input {xshape}: max|kernel-plain| "
            f"{err:.3e} (tol {tol:g}){'' if ok else '  FAIL'}")
        if not ok:
            failures.append(f"distributed kernel vs plain: {name} {xshape}: "
                            f"{err:.3e}")
        del got, want_
    for name, v in total.items():
        if v <= 0:
            failures.append(f"the distributed path never launched {name}")
    log(f"  launches over phase 20: {total} (plans imply {want_total})")
    return {"launches": total}


def dist_recovery(device, failures: list) -> dict:
    """Phase 21: (a) a star2d_r2 rollout at 8192^2 on a 4x1 mesh of slots
    with shard checkpoints, a seeded ``dist.exchange`` storm exhausting
    segment 1's retries, the reshard to 2x1 from the shard checkpoint,
    every emit and the final state bit-identical to the fault-free run;
    (b) ``StencilServer(mesh_shape=(2, 2))`` on four slots of the card
    serving 16 star2d_r2 4096^2 requests, one slot evicted by seeded
    settle faults and the group mesh shrunk, every result at the 1e-4
    oracle bar."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core.time_stepper import reference_evolve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import chaos
    from repro_torch.runtime.fault_tolerance import RestartPolicy

    cfg = DIST_RECOVERY
    spec = api.PAPER_SUITE()[cfg["cell"]]
    g = cfg["grid"]

    def program():
        mesh = make_mesh((4, 1), ("x", "y"), devices=[device] * 4)
        prob = api.StencilProblem(spec, (g, g), boundary="periodic",
                                  steps=1, mesh=mesh, grid_axes=("x", "y"))
        return api.RolloutProgram(prob, [
            api.Segment(cfg["segment"], emit=True),
            api.Segment(cfg["segment"],
                        api.UpdateOp("scale", {"factor": 0.5})),
            api.Segment(cfg["segment"], emit=True)])

    x = seeded_normal((g, g), 4100, device)
    _zero_counts()
    t0 = time.perf_counter()
    clean = api.run_checkpointed(
        api.compile_program(program(), backends=["cuda"], device=device), x)
    _sync(device)
    t_clean = time.perf_counter() - t0
    d = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        compiled = api.compile_program(program(), backends=["cuda"],
                                       device=device)
        plan = chaos.FaultPlan(seed=5).rule("dist.exchange", at=(1, 2, 3),
                                            match={"chunk": 0})
        t0 = time.perf_counter()
        with plan:
            res = api.run_checkpointed(
                compiled, x, directory=d,
                restart=RestartPolicy(max_failures=2, backoff_s=0.0))
        _sync(device)
        t_fault = time.perf_counter() - t0
        shards = sorted(p.name for p in Path(d).glob("step_*/shard_*"))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    same = (torch.equal(res.final, clean.final)
            and [t for t, _ in res.emits] == [t for t, _ in clean.emits]
            and all(torch.equal(a, b) for (_, a), (_, b)
                    in zip(res.emits, clean.emits)))
    ok = (same and res.resharded == 1 and res.attempts == (1, 4, 1)
          and plan.fired("dist.exchange") == 3)
    log(f"  {g}^2 rollout on 4x1 slots: fault-free {t_clean:.2f} s; the "
        f"dist.exchange storm: attempts {res.attempts}, resharded "
        f"{res.resharded} (4x1 -> 2x1), {t_fault:.2f} s with shard "
        f"checkpoints ({len(shards)} shard files written); emits and final "
        f"bit-identical to the fault-free run: {same}"
        f"{'' if ok else '  FAIL'}")
    if not ok:
        failures.append(f"mesh rollout reshard: {res.attempts}, "
                        f"{res.resharded}, bit-identical {same}")
    del clean, res, x
    rollout_counts = _read_counts()

    sg = cfg["serve_grid"]
    rng = np.random.default_rng(7)
    states = [rng.standard_normal((sg, sg), dtype=np.float32)
              for _ in range(cfg["requests"])]
    server = api.StencilServer(spec, cfg["steps"], backends=["cuda"],
                               max_batch=cfg["max_batch"],
                               devices=[device] * 4, mesh_shape=(2, 2),
                               evict_after=3, evict_cooldown_s=3600.0)
    _zero_counts()
    plan = chaos.FaultPlan(seed=0).rule("serve.settle", at=(0, 1, 2))
    t0 = time.perf_counter()
    with plan:
        outs = server.serve(states)
    _sync(device)
    t_serve = time.perf_counter() - t0
    serve_counts = _read_counts()
    st = server.stats()
    errs = [(o - reference_evolve(spec, torch.from_numpy(s).to(device),
                                  cfg["steps"], "periodic")).abs().max()
            .item() for o, s in zip(outs, states)]
    ok = (max(errs) <= E2E_ATOL and st["faults"]["evictions"] == 1
          and st["faults"]["mesh_shrinks"] == 1
          and st["meshes"] == {f"{sg}x{sg}": "2x1"})
    log(f"  StencilServer(mesh_shape=(2, 2)) on 4 slots of the card: "
        f"{len(states)} {sg}^2 requests x {cfg['steps']} steps in "
        f"{t_serve:.2f} s (host clock, faults and retries included); "
        f"evictions {st['faults']['evictions']}, mesh_shrinks "
        f"{st['faults']['mesh_shrinks']}, meshes {st['meshes']}; "
        f"max|result-oracle| {max(errs):.3e} (tol {E2E_ATOL:g})"
        f"{'' if ok else '  FAIL'}")
    if not ok:
        failures.append(f"mesh server eviction: {st['faults']}, "
                        f"{st['meshes']}, {max(errs):.3e}")
    log(f"  launches: rollouts {rollout_counts}, server {serve_counts}")
    return {"launches": {k: rollout_counts[k] + serve_counts[k]
                         for k in rollout_counts}}


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
    check_cases(device, failures, banded_grad_cases(device))
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
    serve_launches = lm["launches"]
    del lm                          # the serve model: ~3.3 GB of the card
    torch.cuda.empty_cache()

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
    t_planner = time.perf_counter()
    log("phase 14: the planner's calibration on the card, the four "
        "main-path cells at full size")
    calibrated = calibrate_cells(device, failures)
    log("phase 15: the differentiable stencil at full width, box2d_r1 "
        "8192^2 and star3d_r1 256^3")
    vjp = stencil_vjp_on_card(device, failures)
    log(f"  phases 14-15 took {time.perf_counter() - t_planner:.1f} s")
    t_train = time.perf_counter()
    log("phase 16: Hymba-1.5B trains at full width and depth, batch 4 x "
        "1024 tokens in 2 microbatches, 4 steps through Trainer.run")
    train = train_hymba(device, failures)
    log("phase 17a: one f32 train step at full width and depth, "
        "kernel_impl cuda against ref")
    train_consistency(device, failures)
    log("phase 17b: Trainer recovery at full width, depth 2, faults before "
        "steps 3 and 5")
    train_recovery(device, failures)
    log("phase 6 (train kernels): the banded mixer's backward at the train "
        "shape")
    rows.append(time_banded_backward(device, train, failures))
    log(f"  phases 16-17 took {time.perf_counter() - t_train:.1f} s")
    for row in rows:
        if row["name"] == "banded_mixer":
            row["launches_by_path"] = {
                "serve": serve_launches, "train": train["launches"],
                "train_backward": train["backward_launches"]}
        if row["name"] in main_run["launches"]:
            by_path = {"main": main_run["launches"][row["name"]],
                       "stencil_server": served["launches"][row["name"]],
                       "chaos": chaotic["launches"][row["name"]],
                       "rollouts": rolled["launches"][row["name"]],
                       "calibrate": calibrated["launches"][row["name"]],
                       "stencil_vjp": vjp["launches"][row["name"]]}
            row["launches_by_path"] = by_path
            # the server's plans run both kernels; the rollout's plans
            # are in-kernel chunks only (phase 13 prints them)
            if by_path["stencil_server"] <= 0 or (
                    row["name"] == "stencil_sweep"
                    and by_path["rollouts"] <= 0):
                failures.append(f"the serving paths never launched the "
                                f"{row['name']} kernel")
    # phase 18's largest model fills most of the card: drop what earlier
    # phases kept there
    del main_run, served, chaotic, rolled, calibrated, vjp, train
    gc.collect()
    torch.cuda.empty_cache()
    families = lm_families(device, failures)
    for row in rows:
        row.setdefault("launches_by_path", {})["lm_families"] = \
            families.get(row["name"], 0)
    gc.collect()
    torch.cuda.empty_cache()
    t_dist = time.perf_counter()
    log("phase 20: the distributed path on slots of the card, "
        "api.plan -> api.compile on a mesh")
    distributed = distributed_cells(device, failures)
    log("phase 21: mesh fault tolerance: a rollout resharded 4x1 -> 2x1, "
        "a mesh server shrinking over the surviving slots")
    recovery = dist_recovery(device, failures)
    log(f"  phases 20-21 took {time.perf_counter() - t_dist:.1f} s")
    for row in rows:
        if row["name"] in distributed["launches"]:
            row["launches_by_path"]["distributed"] = \
                distributed["launches"][row["name"]]
            row["launches_by_path"]["distributed_recovery"] = \
                recovery["launches"][row["name"]]
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
    if sys.argv[1:] == ["--train-recovery"]:
        sys.exit(_recovery_child())
    sys.exit(main())
