"""The step kernel's wrap mode on the CPU: a periodic step chunk hands the
kernel the unpadded state, and its plain version (which the wrapper runs
on a CPU tensor) pads the periodic halo itself.

Held against the JAX package's ``stencil_pallas_call`` (interpret mode) on
the ``jnp.pad(mode="wrap")`` input and against the JAX oracle
``reference_evolve`` at 1e-4, and bit for bit against the padded path
(``halo.pad_halo``, then the valid-mode kernel on the tile-padded input):
both put the same values in the same order into every output.  Grids are
not tile multiples: the kernel masks the ragged tiles, so nothing is
padded to tiles in wrap mode.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp

from repro.core import coefficient_lines as ref_cl
from repro.core import stencil_spec as ref_ss
from repro.core import time_stepper as ref_ts
from repro.kernels import ops as ref_ops
from repro.kernels import stencil_mxu as ref_sm

from repro_torch import api
from repro_torch.core import coefficient_lines as cl
from repro_torch.core import engine
from repro_torch.core import halo
from repro_torch.core import matrixization as mx
from repro_torch.core import stencil_spec as ss
from repro_torch.core import temporal
from repro_torch.kernels import ops
from repro_torch.kernels import stencil_mxu as sm
from repro_torch.runtime import trace

torch.set_num_threads(2)

ATOL = 1e-4

# (suite name, tile, grid): grids that are not tile multiples
DIMS = {2: ("star2d_r2", (8, 16), (21, 35)),
        3: ("star3d_r2", (4, 4, 8), (9, 10, 13))}
CASES = [(nd, sc, b) for nd in (2, 3)
         for sc in ("constant", "varying+masked") for b in (None, 3)]


def _specs(name, grid, scenario):
    ref, port = ref_ss.PAPER_SUITE()[name], ss.PAPER_SUITE()[name]
    if scenario != "constant":
        field = ss.random_coeff_field(grid, seed=11)
        mask = ss.random_domain_mask(grid, seed=12)
        ref = ref.with_field(field, domain_mask=mask)
        port = port.with_field(field, domain_mask=mask)
    return ref, port


def _state(grid, batch, seed):
    lead = (batch,) if batch else ()
    return np.random.default_rng(seed).normal(
        size=lead + tuple(grid)).astype(np.float32)


def _aux(port, grid, seed):
    rng = np.random.default_rng(seed)
    if port.is_constant_dense:
        return ()
    return (rng.uniform(0.5, 1.5, size=grid).astype(np.float32),
            (rng.uniform(size=grid) < 0.8).astype(np.float32))


def _padded_call(x, port, cover, block, batch, aux):
    """The padded path: the periodic halo and the tile pad, the valid-mode
    kernel, the crop."""
    nd, r = port.ndim, port.order
    grid = x.shape[x.ndim - nd:]
    xp = ops._pad_to_multiple(halo.pad_halo(x, r, nd, "periodic"), block,
                              r, nd)
    out = tuple(s - 2 * r for s in xp.shape[xp.ndim - nd:])
    tiled = tuple(torch.nn.functional.pad(
        a, [p for g, o in zip(reversed(grid), reversed(out))
            for p in (0, o - g)]) for a in aux)
    plan = sm.build_kernel_plan(port, cover, block, batch=batch)
    y = sm.stencil_cuda_call(xp, plan, aux=tiled)
    return y[(Ellipsis,) + tuple(slice(0, g) for g in grid)]


@pytest.mark.parametrize("nd,scenario,batch", CASES)
def test_wrap_step_wrapper_matches_pallas_on_the_wrapped_input(
        nd, scenario, batch):
    name, block, grid = DIMS[nd]
    ref, port = _specs(name, grid, scenario)
    r = port.order
    x = _state(grid, batch, seed=nd + (batch or 0))
    plan = sm.build_kernel_plan(port, cl.make_cover(port, "parallel"),
                                block, batch=batch, wrap=True)
    assert plan.wrap
    aux = _aux(port, grid, 40 + nd)
    launches = sm.stencil_cuda_call.launches
    wraps = sm.stencil_cuda_call.wrap_launches
    got = sm.stencil_cuda_call(torch.from_numpy(x), plan,
                               aux=tuple(torch.from_numpy(a) for a in aux))
    # CPU: the plain version, which launches nothing
    assert sm.stencil_cuda_call.launches == launches
    assert sm.stencil_cuda_call.wrap_launches == wraps
    assert tuple(got.shape) == x.shape
    # the reference kernel takes the wrap-padded input at one tile per
    # state (its tiles must divide the grid)
    pads = [(0, 0)] * (x.ndim - nd) + [(r, r)] * nd
    xw = jnp.pad(jnp.asarray(x), pads, mode="wrap")
    ref_plan = ref_sm.build_kernel_plan(
        ref, ref_cl.make_cover(ref, "parallel"), grid, batch=batch)
    want = ref_sm.stencil_pallas_call(
        xw, ref_plan, interpret=True, aux=tuple(jnp.asarray(a) for a in aux))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("nd,scenario,batch", CASES)
def test_periodic_ops_step_matches_reference_and_oracle(nd, scenario, batch):
    name, block, grid = DIMS[nd]
    ref, port = _specs(name, grid, scenario)
    x = _state(grid, batch, seed=10 + nd + (batch or 0))
    got = ops.stencil_matrixized(torch.from_numpy(x), spec=port, block=block,
                                 boundary="periodic")
    want = ref_ops.stencil_matrixized(jnp.asarray(x), spec=ref, block=block,
                                      boundary="periodic")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    oracle = ref_ts.reference_evolve(ref, jnp.asarray(x), 1, "periodic")
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=ATOL)


@pytest.mark.parametrize("nd,scenario,batch", CASES)
def test_wrap_step_equals_the_padded_path_bit_for_bit(nd, scenario, batch):
    """The wrapper in wrap mode and ``ops`` at 'periodic' against the
    padded path they replace: equal to the bit."""
    name, block, grid = DIMS[nd]
    _, port = _specs(name, grid, scenario)
    cover = cl.make_cover(port, "parallel")
    x = torch.from_numpy(_state(grid, batch, seed=20 + nd + (batch or 0)))
    aux = tuple(torch.from_numpy(a) for a in _aux(port, grid, 50 + nd))
    padded = _padded_call(x, port, cover, block, batch, aux)
    plan = sm.build_kernel_plan(port, cover, block, batch=batch, wrap=True)
    assert torch.equal(sm.stencil_cuda_call(x, plan, aux=aux), padded)
    # the parent's ops path: the periodic pad, then the valid-mode core
    parent = ops.stencil_matrixized(
        halo.pad_halo(x, port.order, nd, "periodic"), spec=port,
        cover=cover, block=block)
    got = ops.stencil_matrixized(x, spec=port, cover=cover, block=block,
                                 boundary="periodic")
    assert got.dtype == parent.dtype and torch.equal(got, parent)


@pytest.mark.parametrize("depth", [1, 2])
def test_compiled_periodic_operator_plan_pads_nothing(depth, monkeypatch):
    """A compiled periodic operator plan hands every step chunk's kernel
    the unpadded state under a wrap-mode plan: no ``halo.pad`` span is
    entered, one ``kernel.stencil_step`` span a chunk, and the result is
    the JAX oracle's."""
    ref, port = ref_ss.PAPER_SUITE()["star3d_r1"], \
        ss.PAPER_SUITE()["star3d_r1"]
    grid, steps = (12, 10, 20), 5
    problem = api.StencilProblem(port, grid, boundary="periodic",
                                 steps=steps)
    call = api.compile(api.plan(problem, backends=["cuda"], fuse=depth,
                                fuse_strategy="operator",
                                block=(4, 8, 16)), device="cpu")
    schedule = call.plan.fuse_schedule
    assert max(schedule) == depth and sum(schedule) == steps
    seen = []
    real = sm.stencil_cuda_call

    def recording(x, plan, aux=()):
        seen.append((tuple(x.shape), plan.wrap, plan.spec.order))
        return real(x, plan, aux)

    monkeypatch.setattr(sm, "stencil_cuda_call", recording)
    x = torch.from_numpy(_state(grid, None, seed=7))
    with trace.span("untraced"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        y = call(x)
    s = trace.session()
    assert "halo.pad" not in s
    assert s["kernel.stencil_step"]["count"] == len(schedule)
    # the counted wrap launches: one a chunk, each on the state itself
    assert seen == [(grid, True, t * port.order) for t in schedule]
    want = ref_ts.reference_evolve(ref, jnp.asarray(x.numpy()), steps,
                                   "periodic")
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("nd", [2, 3])
def test_periodic_step_chunk_hands_the_kernel_the_unpadded_state(
        nd, monkeypatch):
    """The engine's periodic step runs the same ``ops`` code on the CPU as
    on a card: the wrapper receives the state itself (no halo and no tile
    padding) under a wrap-mode plan with state-shaped aux operands, and
    the only periodic pad is the plain version's own, inside the
    wrapper."""
    name, block, grid = DIMS[nd]
    _, port = _specs(name, grid, "varying+masked")
    seen = []
    real = sm.stencil_cuda_call

    def recording(x, plan, aux=()):
        seen.append((tuple(x.shape), plan.wrap, plan.batch,
                     tuple(tuple(a.shape) for a in aux)))
        return real(x, plan, aux)

    monkeypatch.setattr(sm, "stencil_cuda_call", recording)
    pads = []
    real_pad = halo._wrap_pad

    def counting_pad(x, p):
        pads.append(tuple(x.shape))
        return real_pad(x, p)

    monkeypatch.setattr(halo, "_wrap_pad", counting_pad)
    eng = engine.StencilEngine(port, backend="cuda", block=block,
                               boundary="periodic", device="cpu")
    x = torch.from_numpy(_state(grid, 2, seed=30 + nd))
    y = eng(x)
    assert y.shape == x.shape
    assert seen == [((2,) + grid, True, 2, (grid, grid))]
    assert pads == [(2,) + grid]
    # the engine's valid-mode core (zero strips, the distributed path)
    # still takes a haloed input
    r = port.order
    haloed = halo.pad_halo(x, r, nd, "periodic")
    seen.clear()
    assert torch.equal(eng._core(haloed), y)
    assert [s[1] for s in seen] == [False]


def test_valid_and_zero_boundaries_keep_the_haloed_launch(monkeypatch):
    """Only 'periodic' wraps: a zero-boundary engine pads and launches the
    valid-mode kernel, and so does the differentiable stencil, forward
    and adjoint."""
    spec = ss.PAPER_SUITE()["box2d_r1"]
    wraps = []
    real = sm.stencil_cuda_call

    def recording(x, plan, aux=()):
        wraps.append(plan.wrap)
        return real(x, plan, aux)

    monkeypatch.setattr(sm, "stencil_cuda_call", recording)
    eng = engine.StencilEngine(spec, backend="cuda", block=(8, 16),
                               boundary="zero", device="cpu")
    eng(torch.randn(20, 24))
    coeffs = torch.tensor(np.asarray(spec.gather_coeffs, np.float32),
                          requires_grad=True)
    x = torch.randn(2, 20, 24, requires_grad=True)
    ops.stencil_apply_vjp(x, coeffs).sum().backward()
    assert wraps == [False, False, False]


def test_step_launch_cost_prices_a_wrap_launch_as_the_padded_one():
    """A wrap launch reads every block's slab as the padded launch of the
    same output does, and writes the state's outputs: at tile multiples
    the two prices are equal to the byte, and on a ragged grid the wrap
    launch writes only the state's outputs of the padded launch's
    whole tiles."""
    spec = ss.PAPER_SUITE()["star3d_r2"]
    cover = cl.make_cover(spec, "hybrid")
    r = spec.order
    for grid, batch in (((16, 32, 64), None), ((16, 32, 64), 3),
                        ((9, 10, 13), 2)):
        block = (4, 8, 16) if grid[0] == 16 else (4, 4, 8)
        plan = sm.build_kernel_plan(spec, cover, block, batch=batch)
        wplan = sm.build_kernel_plan(spec, cover, block, batch=batch,
                                     wrap=True)
        lead = (batch,) if batch else ()
        tiled = [-(-g // b) * b for g, b in zip(grid, block)]
        padded = sm.step_launch_cost(plan, lead + tuple(t + 2 * r
                                                        for t in tiled), 4)
        got = sm.step_launch_cost(wplan, lead + grid, 4)
        extra = (batch or 1) * (int(np.prod(tiled)) - int(np.prod(grid))) * 4
        assert got.fmas == padded.fmas
        assert got.bytes == padded.bytes - extra
        if tiled == list(grid):
            assert got == padded


def test_step_table_offsets_carry_the_lead():
    """A wrap-mode plan's table is the haloed plan's with every run offset
    ``step_lead`` words further (its rows are stored that far into the
    pitch), and the two plans keep tables of their own."""
    spec = ss.PAPER_SUITE()["star3d_r2"]
    cover = cl.make_cover(spec, "parallel")
    plan = sm.build_kernel_plan(spec, cover, (4, 4, 8))
    wplan = sm.build_kernel_plan(spec, cover, (4, 4, 8), wrap=True)
    assert sm.step_lead(plan) == 0 and sm.step_lead(wplan) == 2
    table, n_runs = sm.tap_table(plan, "cpu")
    wtable, w_runs = sm.tap_table(wplan, "cpu")
    assert wtable is not table and w_runs == n_runs
    assert sm.tap_table(wplan, "cpu")[0] is wtable
    head = table.numpy()[:4 * n_runs].reshape(n_runs, 4)
    whead = wtable.numpy()[:4 * n_runs].reshape(n_runs, 4)
    np.testing.assert_array_equal(whead[:, 0], head[:, 0] + 2)
    np.testing.assert_array_equal(whead[:, 3], whead[:, 0] % 4)
    np.testing.assert_array_equal(whead[:, 1:3], head[:, 1:3])
    np.testing.assert_array_equal(wtable.numpy()[4 * n_runs:],
                                  table.numpy()[4 * n_runs:])
    pitch = mx.step_slab_pitch(plan.block, spec.order)
    assert pitch % 8 == 4 and sm.step_lead(wplan) < 4


def test_wrap_step_plan_checks_its_operands():
    port = ss.PAPER_SUITE()["star2d_r1"]
    port = port.with_field(np.ones((10, 12)), domain_mask=np.ones((10, 12),
                                                                  bool))
    plan = sm.build_kernel_plan(port, cl.make_cover(port, "parallel"),
                                (8, 8), wrap=True)
    assert plan.wrap and plan.n_aux == 2
    x = torch.zeros((10, 12))
    good = torch.ones((10, 12))
    assert sm.stencil_cuda_call(x, plan, (good, good)).shape == (10, 12)
    with pytest.raises(ValueError, match="aux"):
        sm.stencil_cuda_call(x, plan, (good[:-1], good))
    with pytest.raises(ValueError, match="aux"):
        sm.stencil_cuda_call(x, plan, (good,))
    with pytest.raises(ValueError, match="state"):
        sm.stencil_cuda_call(torch.zeros((3, 10, 12)), plan, (good, good))
    with pytest.raises(ValueError, match="state"):
        sm.stencil_cuda_call(torch.zeros((0, 12)), plan, (good, good))
    batched = sm.build_kernel_plan(port, cl.make_cover(port, "parallel"),
                                   (8, 8), batch=2, wrap=True)
    with pytest.raises(ValueError, match="state"):
        sm.stencil_cuda_call(torch.zeros((3, 10, 12)), batched,
                             (good, good))
    # a haloed input of a valid-mode plan keeps its own contract
    valid = sm.build_kernel_plan(port, cl.make_cover(port, "parallel"),
                                 (8, 8))
    with pytest.raises(ValueError, match="multiple"):
        sm.stencil_cuda_call(torch.zeros((12, 14)), valid, (good, good))


def test_periodic_core_keeps_the_shape_and_its_plans_apart():
    """``cuda_backend_core(plan, boundary="periodic")`` preserves the
    shape and keeps its wrap-mode plan beside the valid core's."""
    spec = ss.PAPER_SUITE()["star2d_r1"]
    plan = type("P", (), dict(spec=spec, cover=cl.make_cover(
        spec, "parallel"), block=(8, 16)))()
    wrap_core = ops.cuda_backend_core(plan, boundary="periodic")
    valid_core = ops.cuda_backend_core(plan)
    x = torch.randn(2, 18, 34)
    y = wrap_core(x)
    assert y.shape == x.shape
    assert torch.equal(y, valid_core(halo.pad_halo(x, 1, 2, "periodic")))
    (wplan,) = wrap_core.keywords["plan_cache"].values()
    (vplan,) = valid_core.keywords["plan_cache"].values()
    assert wplan.wrap and not vplan.wrap


def _wrap_slab_layout(block, r, lead):
    """The wrap-mode slab of ``csrc/stencil_step.cu``, restated: which
    storage words the loader writes (each unit of 4 storage words copies
    only the words of its own row's slab columns) and the storage words
    the tap loop reads for every chunk of every tile row, in 3-D."""
    b = sm._as3(block, 1)
    h = sm._as3((r,) * len(block), 0)
    s = [bb + 2 * hh for bb, hh in zip(b, h)]
    pitch = mx.step_slab_pitch(tuple(block), r)
    slab_words = (s[0] * s[1] * pitch + lead + 3) // 4 * 4
    rows = np.arange(s[0] * s[1])[:, None] * pitch + lead
    cols = np.arange(s[2])[None, :]
    written = (rows + cols).ravel()
    chunks = -(-b[2] // mx.STEP_V)
    out_rows = np.array([(p0 * s[1] + p1) * pitch for p0 in range(b[0])
                         for p1 in range(b[1])])
    return s, pitch, slab_words, written, out_rows, chunks


@pytest.mark.parametrize("name,depth,block", [
    ("star2d_r2", 1, (32, 128)), ("star2d_r2", 1, (64, 128)),
    ("star3d_r2", 1, (16, 32, 32)), ("box3d_r1", 1, (8, 8, 32)),
    ("star2d_r2", 1, (16, 20)), ("star3d_r2", 1, (4, 8, 12)),
    ("box2d_r1", 1, (8, 12)), ("star3d_r1", 1, (2, 6, 6)),
    ("box2d_r1", 2, (128, 128)), ("star2d_r1", 3, (32, 64)),
    ("star2d_r1", 4, (16, 36))])
def test_wrap_slab_stays_inside_its_words(name, depth, block):
    """Every slab word is written once and inside the slab, and every
    16-byte shared load of the tap loop (each run's table offset, its
    offset modulo 4, its width) stays inside the slab, aligned, and
    covers only written words with the values a stored output uses.
    The slab's size is the kernel's (one 16-byte unit more than the
    valid mode's when the lead is not 0)."""
    src = (sm.cuda_build.CSRC / "stencil_step.cu").read_text()
    assert "g.slab_words = (g.s0 * g.s1 * pitch + g.lead + 3) / 4 * 4;" in src
    spec = temporal.fuse_steps(ss.PAPER_SUITE()[name], depth)
    plan = sm.build_kernel_plan(spec, cl.make_cover(spec, "parallel"),
                                block, wrap=True)
    lead = sm.step_lead(plan)
    assert (lead + spec.order) % 4 == 0
    s, pitch, slab_words, written, out_rows, chunks = _wrap_slab_layout(
        block, spec.order, lead)
    assert len(np.unique(written)) == written.size
    assert written.min() >= 0 and written.max() < slab_words
    is_written = np.zeros(slab_words, bool)
    is_written[written] = True
    table, n_runs = sm.tap_table(plan, "cpu")
    head = table.numpy()[:4 * n_runs].reshape(n_runs, 4)
    b2 = block[-1]
    for off, width, _, sh in head:
        assert sh == off % 4
        n_loads = (sh + mx.STEP_V + width - 1 + 3) // 4
        for c in range(chunks):
            base = out_rows + c * mx.STEP_V + off
            first = base - sh
            assert (first % 4 == 0).all()
            assert first.min() >= 0
            assert (first + 4 * n_loads).max() <= slab_words
            used = min(mx.STEP_V, b2 - c * mx.STEP_V) + width - 1
            idx = base[:, None] + np.arange(used)[None, :]
            assert is_written[idx].all()
