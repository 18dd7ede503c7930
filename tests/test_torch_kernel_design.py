"""Host-side design of the step and flash-attention kernels, on the CPU.

* the step kernel's tap order (rows: taps grouped by their leading-axis
  offsets, sorted along the last axis) keeps the plan's tap multiset, and
  its runs rebuild that order; the plain version in that order still
  matches the JAX package's ``stencil_pallas_call`` (interpret mode) at
  the kernel bar (f32 atol 2e-5, bf16 5e-2), fused operators included;
* each plan's tap table is built once per (plan, device) and reused;
* the constants and shared-memory formulas the CUDA sources define match
  the Python gates (parsed as ``test_sweep_residency_model_matches_kernel_source``
  parses the sweep kernel's);
* ``chip_smoke``'s roofline arithmetic for the shapes it times.
"""
import collections
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import coefficient_lines as ref_cl
from repro.core import stencil_spec as ref_ss
from repro.core import temporal as ref_temporal
from repro.kernels import stencil_mxu as ref_sm

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repository root's chip smoke test)
from repro_torch.core import coefficient_lines as cl
from repro_torch.core import matrixization as mx
from repro_torch.core import stencil_spec as ss
from repro_torch.core import temporal
from repro_torch.kernels import cuda_build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import stencil_mxu as sm

torch.set_num_threads(2)

ATOL = {"float32": 2e-5, "bfloat16": 5e-2}

# (suite name, fuse depth, cover, tile, output extent)
PLANS = [("star2d_r2", 1, "orthogonal", (8, 16), (16, 32)),
         ("box2d_r1", 2, "parallel", (8, 16), (16, 32)),
         ("star3d_r2", 1, "parallel", (4, 4, 8), (8, 8, 16)),
         ("box3d_r1", 1, "parallel", (4, 4, 8), (8, 4, 8)),
         ("star2d_r1", 3, "parallel", (8, 12), (16, 24))]


def _port_plan(name, depth, cover, block, batch=None):
    spec = ss.PAPER_SUITE()[name]
    if depth > 1:
        spec = temporal.fuse_steps(spec, depth)
    return sm.build_kernel_plan(spec, cl.make_cover(spec, cover), block,
                                batch=batch)


def _line_taps(plan):
    """Every tap the plan's lines carry, straight from its bands and point
    taps, as a multiset."""
    taps = collections.Counter()
    for a, band, fixed in plan.band_lines:
        fixed_d = dict(fixed)
        for s, c in enumerate(band):
            if c != 0.0:
                offs = [fixed_d.get(d, 0) for d in range(plan.spec.ndim)]
                offs[a] = s
                taps[(float(np.float32(c)), tuple(offs))] += 1
    for c, g in plan.point_taps:
        taps[(float(np.float32(c)), tuple(g))] += 1
    return taps


@pytest.mark.parametrize("name,depth,cover,block,out", PLANS)
def test_row_order_keeps_the_taps_and_runs_rebuild_it(name, depth, cover,
                                                      block, out):
    plan = _port_plan(name, depth, cover, block)
    taps = plan.taps
    assert collections.Counter(taps) == _line_taps(plan)
    keys = [(g[:-1], g[-1]) for _, g in taps]
    assert keys == sorted(keys)
    runs = sm.tap_runs(taps)
    rebuilt = [(c, lead + (start + i,)) for lead, start, cs in runs
               for i, c in enumerate(cs)]
    assert rebuilt == list(taps)
    for lead, start, cs in runs:
        assert 1 <= len(cs) <= mx.STEP_MAX_RUN
    # runs are maximal: two neighbours join unless a rule forbids it
    for (l0, s0, c0), (l1, s1, _) in zip(runs, runs[1:]):
        assert l0 != l1 or s0 + len(c0) != s1 or len(c0) == mx.STEP_MAX_RUN


def test_runs_split_at_the_width_limit_and_at_gaps():
    taps = [(1.0, (0, k)) for k in range(11)] + [(2.0, (0, 13)),
                                                  (3.0, (1, 0))]
    runs = sm.tap_runs(taps)
    assert [(lead, start, len(cs)) for lead, start, cs in runs] == [
        ((0,), 0, 9), ((0,), 9, 2), ((0,), 13, 1), ((1,), 0, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,depth,cover,block,out", PLANS)
def test_plain_in_row_order_matches_pallas(name, depth, cover, block, out,
                                           dtype):
    ref = ref_ss.PAPER_SUITE()[name]
    if depth > 1:
        ref = ref_temporal.fuse_steps(ref, depth)
    ref_plan = ref_sm.build_kernel_plan(ref, ref_cl.make_cover(ref, cover),
                                        block)
    plan = _port_plan(name, depth, cover, block)
    r = plan.spec.order
    x = np.random.default_rng(len(name) + depth).normal(
        size=tuple(n + 2 * r for n in out)).astype(np.float32)
    want = ref_sm.stencil_pallas_call(jnp.asarray(x, getattr(jnp, dtype)),
                                      ref_plan, interpret=True)
    got = sm.stencil_cuda_call(torch.from_numpy(x).to(getattr(torch, dtype)),
                               plan)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=ATOL[dtype])


def test_tap_table_is_built_once_per_plan_and_device(monkeypatch):
    built = []
    real = sm._step_table

    def counting(*args):
        built.append(args)
        return real(*args)

    monkeypatch.setattr(sm, "_step_table", counting)
    sm._device_table.cache_clear()
    plan = _port_plan("box2d_r1", 2, "parallel", (8, 16))
    assert plan.taps is plan.taps
    first, n_runs = sm.tap_table(plan, "cpu")
    again, _ = sm.tap_table(plan, torch.device("cpu"))
    twin, _ = sm.tap_table(_port_plan("box2d_r1", 2, "parallel", (8, 16)),
                           "cpu")
    assert again is first and twin is first
    assert len(built) == 1
    assert n_runs == 5                      # five rows of five taps
    assert first.dtype == torch.int32
    assert first.numel() == 4 * n_runs + len(plan.taps)
    sweep = sm.build_sweep_kernel_plan(plan.spec, plan_cover(plan), (8, 16),
                                       2)
    s_first, s_runs = sm.tap_table(sweep, "cpu")
    assert sm.tap_table(sweep, "cpu")[0] is s_first
    assert s_runs == n_runs                 # the same runs ...
    assert s_first.numel() == 4 * s_runs + len(sweep.taps)
    assert len(built) == 1                  # ... in the sweep's own frame


def plan_cover(plan):
    return cl.make_cover(plan.spec, "parallel")


def test_step_table_layout():
    """Each run header points at its first tap in the slab at the kernel's
    pitch, and the coefficients follow the headers in run order."""
    plan = _port_plan("star3d_r2", 1, "parallel", (4, 4, 8))
    table, n_runs = sm.tap_table(plan, "cpu")
    words = table.numpy()
    head = words[:4 * n_runs].reshape(n_runs, 4)
    coefs = words[4 * n_runs:].view(np.float32)
    r = plan.spec.order
    pitch = mx.step_slab_pitch(plan.block, r)
    s1 = plan.block[1] + 2 * r
    for (off, width, first, sh), (lead, start, cs) in zip(
            head, sm.tap_runs(plan.taps)):
        assert off == (lead[0] * s1 + lead[1]) * pitch + start
        assert sh == off % 4 and width == len(cs)
        np.testing.assert_array_equal(coefs[first:first + width],
                                      np.float32(cs))


def test_core_keeps_its_kernel_plan():
    spec = ss.PAPER_SUITE()["star2d_r1"]
    core = ops.cuda_backend_core(type("P", (), dict(
        spec=spec, cover=cl.make_cover(spec, "parallel"), block=(8, 16)))())
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 18, 34)).astype(np.float32))
    first = core(x)
    torch.testing.assert_close(core(x), first, rtol=0, atol=0)
    cache = core.keywords["plan_cache"]
    assert len(cache) == 1
    (plan,) = cache.values()
    assert plan.batch == 2 and plan.block == (8, 16)


def _constants(name: str) -> dict[str, int]:
    src = (cuda_build.CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_step_kernel_constants_match_the_residency_model():
    c = _constants("stencil_step.cu")
    assert c["kThreads"] == mx.STEP_THREADS
    assert c["kV"] == mx.STEP_V
    assert c["kMaxRun"] == mx.STEP_MAX_RUN
    src = (cuda_build.CSRC / "stencil_step.cu").read_text()
    assert "switch (run.y)" in src and \
        "default: apply_run<kMaxRun>" in src
    # the launcher's smem and its pitch check, restated
    assert "sizeof(float) * ((size_t)g.slab_words + 4 * n_runs + n_taps)" \
        in src
    assert "pitch < (g.s2 + 3) / 4 * 4 + (b2 % kV ? kV : 0) || " \
           "pitch % 8 != 4" in src
    for block in ((64, 128), (8, 16, 32), (16, 20), (4, 8, 12), (2, 6, 6),
                  (32, 128), (1, 1)):
        for h in (1, 2, 4):
            pitch = mx.step_slab_pitch(block, h)
            s2 = block[-1] + 2 * h
            assert pitch % 8 == 4
            assert pitch >= (s2 + 3) // 4 * 4 + (mx.STEP_V if block[-1]
                                                 % mx.STEP_V else 0)
            assert pitch < (s2 + 3) // 4 * 4 + mx.STEP_V + 8
            lead = int(np.prod([b + 2 * h for b in block[:-1]]))
            words = 37
            slab = -(-lead * pitch // 4) * 4
            assert mx.step_smem_bytes(block, h, words) == 4 * (slab + words)
            assert mx.step_smem_bytes(block, h) == \
                4 * (slab + 5 * (2 * h + 1) ** len(block))


def test_step_wrapper_table_fits_the_planner_bound():
    """The table a plan really ships is within the bound the planner
    prices (one header and one coefficient per tap of the full box)."""
    for name, depth, cover, block, _ in PLANS:
        plan = _port_plan(name, depth, cover, block)
        table, _ = sm.tap_table(plan, "cpu")
        r = plan.spec.order
        assert mx.step_smem_bytes(block, r, table.numel()) <= \
            mx.step_smem_bytes(block, r)


def test_flash_kernel_constants_match_the_wrapper():
    c = _constants("flash_attention.cu")
    assert c["kThreads"] == fa.THREADS
    assert c["kRows"] == fa.BLOCK_ROWS
    assert c["kKvTileWide"] == fa.KV_TILE
    assert c["kKvTileNarrow"] == fa.KV_TILE_NARROW
    assert c["kPadF32"] == fa.PAD[torch.float32]
    assert c["kPadBf16"] == fa.PAD[torch.bfloat16]
    assert c["kThreads"] // 32 * 16 == c["kRows"]          # 16 rows a warp
    assert c["kStages"] == fa.STAGES
    src = (cuda_build.CSRC / "flash_attention.cu").read_text()
    for dtype in (torch.float32, torch.bfloat16):
        for dh in fa.HEAD_DIMS:
            f32 = dtype == torch.float32
            # Cfg's formula, restated from the parsed constants
            bk = c["kKvTileNarrow"] if f32 and dh == 128 else c["kKvTileWide"]
            pad = c["kPadF32"] if f32 else c["kPadBf16"]
            dk = dh if f32 else max(dh, 16)
            q_rows = 0 if not (f32 and dh == 128) else c["kRows"]
            elems = c["kStages"] * bk * ((dk + pad) + (dh + pad)) \
                + q_rows * (dk + pad)
            assert fa.smem_bytes(dh, dtype) == elems * (4 if f32 else 2)
            assert fa.smem_bytes(dh, dtype) <= mx.SMEM_BYTES
    assert "static constexpr int kSmemElems = kStages * kStageElems + " \
           "(kQReg ? 0 : kRows * kKs);" in src
    assert "static constexpr int kStageElems = kBk * (kKs + kVs);" in src


def test_flash_wrapper_keeps_the_reference_contract_at_ragged_s():
    """S = 40: the wrapper's blocks become 40 (the reference's rule); the
    kernel's 64-row tiles mask the rest on the card."""
    q = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 2, 40, 8)).astype(np.float32))
    out = fa.flash_attention_cuda(q, q, q, causal=True)
    torch.testing.assert_close(out, fa.flash_attention_plain(q, q, q, True))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_cuda(q, q, q, block_q=16, block_k=16)


@pytest.mark.parametrize("rate,flops_per_s,label", [
    ("3xtf32", 495e12 / 3, "operations, 3xTF32"),
    ("bf16", 989e12, "operations, bf16 tensor cores"),
    ("f32", 67e12, "operations")])
def test_flash_bound_at_each_rate(rate, flops_per_s, label):
    shape = chip_smoke.FLASH_SHAPE
    flops = chip_smoke.flash_flops(shape)
    b, h, s, dh = shape
    assert flops == 2 * (s + 1) * b * h * s * dh
    assert flops == pytest.approx(3.022e10, rel=1e-3)
    elt = 2 if rate == "bf16" else 4
    n = b * h * s * dh
    ms, by = chip_smoke.bound(3 * n * elt, n * elt, flops, rate)
    assert by == label
    assert ms == pytest.approx(flops / flops_per_s * 1e3)
    want = {"3xtf32": 0.183, "bf16": 0.0306, "f32": 0.451}[rate]
    assert ms == pytest.approx(want, abs=1e-3)
    if rate == "bf16":       # bytes come close but do not bind
        assert 4 * n * 2 / 3.35e12 * 1e3 == pytest.approx(0.0235, abs=1e-4)


@pytest.mark.parametrize("grid,r,want", [((8192, 8192), 2, 0.1603),
                                         ((512, 512, 512), 2, 0.3243)])
def test_step_bound_is_the_bytes(grid, r, want):
    """The step kernel's chunks: the haloed input read once, the output
    written once; 2*taps flops per output stay far under the f32 rate."""
    n_in = int(np.prod([g + 2 * r for g in grid]))
    n_out = int(np.prod(grid))
    ms, by = chip_smoke.bound(4 * n_in, 4 * n_out, 2 * 25 * n_out)
    assert by == "bytes"
    assert ms == pytest.approx(want, abs=1e-4)
