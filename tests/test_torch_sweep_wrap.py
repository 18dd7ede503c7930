"""The sweep kernel's wrap mode on the CPU: the periodic in-kernel chunk
takes the unpadded state, and its plain version (which the wrapper runs on
a CPU tensor) pads the periodic halo itself.

Held against the JAX package's ``sweep_pallas_call`` (interpret mode) on
the ``jnp.pad(mode="wrap")`` input and against the JAX oracle
``reference_evolve``, at 1e-4 (the ROADMAP's parity bar; the f32 sums
differ from the oracle's only in rounding).  Grids are not tile
multiples: the kernel masks the ragged tiles, so nothing is padded to
tiles in wrap mode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import coefficient_lines as ref_cl
from repro.core import stencil_spec as ref_ss
from repro.core import time_stepper as ref_ts
from repro.kernels import ops as ref_ops
from repro.kernels import stencil_mxu as ref_sm

from repro_torch.core import coefficient_lines as cl
from repro_torch.core import engine
from repro_torch.core import matrixization as mx
from repro_torch.core import stencil_spec as ss
from repro_torch.kernels import ops
from repro_torch.kernels import stencil_mxu as sm

torch.set_num_threads(2)

ATOL = 1e-4

# (suite name, tile, grid, steps): grids that are not tile multiples
DIMS = {2: ("star2d_r2", (8, 16), (21, 35), 3),
        3: ("star3d_r1", (4, 4, 8), (9, 10, 13), 2)}
CASES = [(nd, sc, b, scratch) for nd in (2, 3)
         for sc in ("constant", "varying+masked") for b in (None, 3)
         for scratch in ("pingpong", "single")]


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


@pytest.mark.parametrize("nd,scenario,batch,scratch", CASES)
def test_wrap_sweep_wrapper_matches_pallas_on_the_wrapped_input(
        nd, scenario, batch, scratch):
    name, block, grid, steps = DIMS[nd]
    ref, port = _specs(name, grid, scenario)
    w = steps * port.order
    x = _state(grid, batch, seed=nd + (batch or 0))
    plan = sm.build_sweep_kernel_plan(port, cl.make_cover(port, "parallel"),
                                      block, steps, batch=batch,
                                      scratch=scratch, wrap=True)
    assert plan.wrap
    rng = np.random.default_rng(40 + nd)
    ashape = sm.sweep_aux_shape(grid, plan)
    assert ashape == tuple(-(-g // b) * b + 2 * w
                           for g, b in zip(grid, block))
    aux = () if port.is_constant_dense else (
        rng.uniform(0.5, 1.5, size=ashape).astype(np.float32),
        (rng.uniform(size=ashape) < 0.8).astype(np.float32))
    launches = sm.sweep_cuda_call.launches
    got = sm.sweep_cuda_call(torch.from_numpy(x), plan,
                             aux=tuple(torch.from_numpy(a) for a in aux))
    assert sm.sweep_cuda_call.launches == launches      # CPU: plain version
    assert tuple(got.shape) == x.shape
    # the reference kernel takes the wrap-padded input at one tile per
    # state (its tiles must divide the grid) and the aux cropped to it
    pads = [(0, 0)] * (x.ndim - nd) + [(w, w)] * nd
    xw = jnp.pad(jnp.asarray(x), pads, mode="wrap")
    ref_plan = ref_sm.build_sweep_kernel_plan(
        ref, ref_cl.make_cover(ref, "parallel"), grid, steps, batch=batch,
        scratch=scratch)
    crop = tuple(slice(0, g + 2 * w) for g in grid)
    want = ref_sm.sweep_pallas_call(
        xw, ref_plan, interpret=True,
        aux=tuple(jnp.asarray(a[crop]) for a in aux))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("nd,scenario,batch,scratch", CASES)
def test_periodic_ops_sweep_matches_reference_and_oracle(nd, scenario, batch,
                                                          scratch):
    name, block, grid, steps = DIMS[nd]
    ref, port = _specs(name, grid, scenario)
    x = _state(grid, batch, seed=10 + nd + (batch or 0))
    got = ops.stencil_sweep_matrixized(torch.from_numpy(x), spec=port,
                                       steps=steps, block=block,
                                       boundary="periodic", scratch=scratch)
    want = ref_ops.stencil_sweep_matrixized(jnp.asarray(x), spec=ref,
                                            steps=steps, block=block,
                                            boundary="periodic",
                                            scratch=scratch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    oracle = ref_ts.reference_evolve(ref, jnp.asarray(x), steps, "periodic")
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=ATOL)


@pytest.mark.parametrize("nd,scenario,batch,scratch", CASES)
def test_engine_periodic_inkernel_sweep_matches_oracle(nd, scenario, batch,
                                                       scratch):
    """A 2+1 / 3+1 schedule of in-kernel chunks and a step chunk."""
    name, block, grid, steps = DIMS[nd]
    ref, port = _specs(name, grid, scenario)
    x = _state(grid, batch, seed=20 + nd + (batch or 0))
    eng = engine.StencilEngine(port, backend="cuda", block=block,
                               boundary="periodic", scratch=scratch,
                               device="cpu")
    got = eng.sweep(torch.from_numpy(x), steps + 1, fuse=steps,
                    strategy="inkernel")
    want = ref_ts.reference_evolve(ref, jnp.asarray(x), steps + 1,
                                   "periodic")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("nd", [2, 3])
def test_periodic_inkernel_chunk_hands_the_kernel_the_unpadded_state(
        nd, monkeypatch):
    """The engine's periodic in-kernel chunk runs the same ``ops`` code on
    the CPU as on a card: the wrapper receives the state itself (its
    spatial shape, no halo and no tile padding) under a wrap-mode plan,
    and no periodic pad runs for the chunk."""
    name, block, grid, steps = DIMS[nd]
    _, port = _specs(name, grid, "varying+masked")
    seen = []
    real = sm.sweep_cuda_call

    def recording(x, plan, aux=()):
        seen.append((tuple(x.shape), plan.wrap, plan.steps,
                     tuple(tuple(a.shape) for a in aux)))
        return real(x, plan, aux)

    monkeypatch.setattr(sm, "sweep_cuda_call", recording)
    pads = []
    real_pad = ops.halo._wrap_pad

    def counting_pad(x, p):
        pads.append(tuple(x.shape))
        return real_pad(x, p)

    monkeypatch.setattr(ops.halo, "_wrap_pad", counting_pad)
    eng = engine.StencilEngine(port, backend="cuda", block=block,
                               boundary="periodic", device="cpu")
    x = torch.from_numpy(_state(grid, 2, seed=30 + nd))
    eng.sweep(x, steps, fuse=steps, strategy="inkernel")
    w = steps * port.order
    ashape = tuple(-(-g // b) * b + 2 * w for g, b in zip(grid, block))
    assert seen == [((2,) + grid, True, steps, (ashape, ashape))]
    # a second run: the aux operands are kept, and the only periodic pad
    # is the plain version's own, inside the wrapper
    pads.clear()
    eng.sweep(x, steps, fuse=steps, strategy="inkernel")
    assert len(seen) == 2 and seen[1] == seen[0]
    assert pads == [(2,) + grid]


def test_sweep_table_offsets_are_relative_to_the_output():
    """Each run header of the sweep's table points at its first tap from
    the output's own slab position, at the sweep kernel's pitch, so one
    table serves every step of the shrinking live window."""
    port = ss.PAPER_SUITE()["star3d_r2"]
    plan = sm.build_sweep_kernel_plan(port, cl.make_cover(port, "parallel"),
                                      (4, 4, 8), 2, wrap=True)
    table, n_runs = sm.tap_table(plan, "cpu")
    words = table.numpy()
    head = words[:4 * n_runs].reshape(n_runs, 4)
    coefs = words[4 * n_runs:].view(np.float32)
    r = port.order
    pitch = mx.sweep_slab_pitch(plan.block, plan.steps, r)
    s1 = plan.block[1] + 2 * plan.steps * r
    for (off, width, first, sh), (lead, start, cs) in zip(
            head, sm.tap_runs(plan.taps)):
        assert off == ((lead[0] - r) * s1 + (lead[1] - r)) * pitch \
            + (start - r)
        assert sh == off % 4 and width == len(cs)
        np.testing.assert_array_equal(coefs[first:first + width],
                                      np.float32(cs))


def test_wrap_plan_checks_its_operands():
    port = ss.PAPER_SUITE()["star2d_r1"]
    port = port.with_field(np.ones((10, 12)), domain_mask=np.ones((10, 12),
                                                                  bool))
    plan = sm.build_sweep_kernel_plan(port, cl.make_cover(port, "parallel"),
                                      (8, 8), 2, wrap=True)
    x = torch.zeros((10, 12))
    good = torch.ones(sm.sweep_aux_shape((10, 12), plan))
    assert tuple(good.shape) == (20, 20)
    sm.sweep_cuda_call(x, plan, (good, good))
    with pytest.raises(ValueError, match="aux"):
        sm.sweep_cuda_call(x, plan, (good[:-1], good))
    with pytest.raises(ValueError, match="state"):
        sm.sweep_cuda_call(torch.zeros((3, 10, 12)), plan, (good, good))
