"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels in interpret mode, on the same numpy inputs.

Bars: f32 atol 2e-5, bf16 atol 5e-2 (those of tests/test_kernels.py).  The
CUDA kernels themselves run only on a card: ``chip_smoke.py`` holds each
one against these plain versions there.
"""
import functools
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import coefficient_lines as ref_cl
from repro.core import stencil_spec as ref_ss
from repro.kernels import ops as ref_ops
from repro.kernels import stencil_mxu as ref_sm

from repro_torch.core import coefficient_lines as cl
from repro_torch.core import matrixization as mx
from repro_torch.core import stencil_spec as ss
from repro_torch.kernels import cuda_build
from repro_torch.kernels import ops
from repro_torch.kernels import stencil_mxu as sm

torch.set_num_threads(2)

# (suite name, cover, block, output extent per axis, sweep steps)
DIMS = {2: ("star2d_r2", "orthogonal", (16, 16), (32, 32), 3),
        3: ("box3d_r1", "parallel", (4, 8, 8), (8, 8, 16), 2)}
ATOL = {"float32": 2e-5, "bfloat16": 5e-2}
CASES = [(nd, dt, sc, b) for nd in (2, 3) for dt in ("float32", "bfloat16")
         for sc in ("constant", "varying+masked") for b in (None, 3)]


def _specs(nd, scenario, grid):
    name, cover, block, out, steps = DIMS[nd]
    ref, port = ref_ss.PAPER_SUITE()[name], ss.PAPER_SUITE()[name]
    if scenario != "constant":
        field = ss.random_coeff_field(grid, seed=5)
        mask = ss.random_domain_mask(grid, seed=6)
        ref = ref.with_field(field, domain_mask=mask)
        port = port.with_field(field, domain_mask=mask)
    return (ref, ref_cl.make_cover(ref, cover)), (port, cl.make_cover(port, cover))


def _inputs(nd, batch, halo, scenario, aux_shape_halo):
    _, _, block, out, _ = DIMS[nd]
    rng = np.random.default_rng(nd * 10 + (batch or 0))
    shape = tuple(n + 2 * halo for n in out)
    x = rng.normal(size=((batch,) if batch else ()) + shape).astype(np.float32)
    aux = ()
    if scenario != "constant":
        ashape = tuple(n + 2 * aux_shape_halo for n in out)
        aux = (rng.uniform(0.5, 1.5, size=ashape).astype(np.float32),
               (rng.uniform(size=ashape) < 0.8).astype(np.float32))
    return x, aux


def _jax_x(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _torch_x(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@functools.lru_cache(maxsize=None)
def _ref_step(nd, dtype, scenario, batch):
    (ref, rcover), _ = _specs(nd, scenario, DIMS[nd][3])
    r = ref.order
    x, aux = _inputs(nd, batch, r, scenario, 0)
    plan = ref_sm.build_kernel_plan(ref, rcover, DIMS[nd][2], batch=batch)
    out = ref_sm.stencil_pallas_call(_jax_x(x, dtype), plan, interpret=True,
                                     aux=tuple(jnp.asarray(a) for a in aux))
    return np.asarray(out.astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _ref_sweep(nd, dtype, scenario, batch):
    steps = DIMS[nd][4]
    (ref, rcover), _ = _specs(nd, scenario, DIMS[nd][3])
    w = steps * ref.order
    x, aux = _inputs(nd, batch, w, scenario, w)
    plan = ref_sm.build_sweep_kernel_plan(ref, rcover, DIMS[nd][2], steps,
                                          batch=batch)
    out = ref_sm.sweep_pallas_call(_jax_x(x, dtype), plan, interpret=True,
                                   aux=tuple(jnp.asarray(a) for a in aux))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("nd,dtype,scenario,batch", CASES)
def test_step_wrapper_matches_pallas(nd, dtype, scenario, batch):
    _, (port, cover) = _specs(nd, scenario, DIMS[nd][3])
    x, aux = _inputs(nd, batch, port.order, scenario, 0)
    plan = sm.build_kernel_plan(port, cover, DIMS[nd][2], batch=batch)
    launches = sm.stencil_cuda_call.launches
    out = sm.stencil_cuda_call(_torch_x(x, dtype), plan,
                               aux=tuple(torch.from_numpy(a) for a in aux))
    assert sm.stencil_cuda_call.launches == launches  # CPU: plain version
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.to(torch.float32).numpy(),
                               _ref_step(nd, dtype, scenario, batch),
                               atol=ATOL[dtype])


@pytest.mark.parametrize("scratch", ["pingpong", "single"])
@pytest.mark.parametrize("nd,dtype,scenario,batch", CASES)
def test_sweep_wrapper_matches_pallas(nd, dtype, scenario, batch, scratch):
    steps = DIMS[nd][4]
    _, (port, cover) = _specs(nd, scenario, DIMS[nd][3])
    w = steps * port.order
    x, aux = _inputs(nd, batch, w, scenario, w)
    plan = sm.build_sweep_kernel_plan(port, cover, DIMS[nd][2], steps,
                                      batch=batch, scratch=scratch)
    launches = sm.sweep_cuda_call.launches
    out = sm.sweep_cuda_call(_torch_x(x, dtype), plan,
                             aux=tuple(torch.from_numpy(a) for a in aux))
    assert sm.sweep_cuda_call.launches == launches  # CPU: plain version
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.to(torch.float32).numpy(),
                               _ref_sweep(nd, dtype, scenario, batch),
                               atol=ATOL[dtype])


@pytest.mark.parametrize("nd", [2, 3])
def test_batched_bit_exact_against_per_state(nd):
    _, (port, cover) = _specs(nd, "varying+masked", DIMS[nd][3])
    steps = DIMS[nd][4]
    for halo, call, build in (
            (port.order, sm.stencil_cuda_call,
             lambda b: sm.build_kernel_plan(port, cover, DIMS[nd][2], batch=b)),
            (steps * port.order, sm.sweep_cuda_call,
             lambda b: sm.build_sweep_kernel_plan(port, cover, DIMS[nd][2],
                                                  steps, batch=b))):
        x, aux = _inputs(nd, 3, halo, "varying+masked",
                         0 if call is sm.stencil_cuda_call else halo)
        aux_t = tuple(torch.from_numpy(a) for a in aux)
        xb = torch.from_numpy(x)
        batched = call(xb, build(3), aux=aux_t)
        for i in range(3):
            torch.testing.assert_close(batched[i], call(xb[i], build(None),
                                                        aux=aux_t),
                                       rtol=0, atol=0)


@pytest.mark.parametrize("name,boundary,lead", [
    ("star2d_r2", "periodic", ()), ("box2d_r1", "zero", (2,)),
    ("star3d_r1", "valid", ()), ("diag2d_r1", "periodic", (2, 1))])
def test_ops_wrappers_match_reference_ops(name, boundary, lead):
    """The padded, folded, boundary-lifted entry points over grids that
    are not block multiples."""
    ref, port = ref_ss.PAPER_SUITE()[name], ss.PAPER_SUITE()[name]
    grid = (21, 19) if port.ndim == 2 else (9, 11, 13)
    block = (8, 16) if port.ndim == 2 else (4, 4, 8)
    x = np.random.default_rng(3).normal(size=lead + grid).astype(np.float32)
    want = ref_ops.stencil_matrixized(jnp.asarray(x), spec=ref, block=block,
                                      boundary=boundary)
    got = ops.stencil_matrixized(torch.from_numpy(x), spec=port, block=block,
                                 boundary=boundary)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    want = ref_ops.stencil_sweep_matrixized(jnp.asarray(x), spec=ref, steps=2,
                                            block=block, boundary=boundary)
    got = ops.stencil_sweep_matrixized(torch.from_numpy(x), spec=port,
                                       steps=2, block=block,
                                       boundary=boundary)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card never reaches a
    plain version silently."""
    _, (port, cover) = _specs(2, "constant", DIMS[2][3])
    x = torch.empty((36, 36), device="meta")
    with pytest.raises(ValueError, match="device"):
        sm.stencil_cuda_call(x, sm.build_kernel_plan(port, cover, (16, 16)))


def _source_constant(src: str, name: str) -> int:
    """The value of ``constexpr int <name> = <digits>;`` in a kernel
    source; a missing definition fails naming the constant."""
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m is not None, f"{name} is not defined as a constexpr int"
    return int(m.group(1))


def test_sweep_residency_model_matches_kernel_source():
    """The planner's shared-memory model and the sweep kernel agree on the
    threads per block, the work item, the register slots of
    scratch='single' and the shared memory the launcher allocates."""
    src = (cuda_build.CSRC / "stencil_sweep.cu").read_text()
    assert _source_constant(src, "kThreads") == mx.SWEEP_THREADS
    assert _source_constant(src, "kSlots") == mx.SINGLE_SLOTS
    assert _source_constant(src, "kV") == mx.STEP_V
    assert _source_constant(src, "kMaxRun") == mx.STEP_MAX_RUN
    assert _source_constant(src, "kTx") == mx.SWEEP_ITEM_CHUNKS
    assert _source_constant(src, "kTy") == mx.SWEEP_ITEM_ROWS
    assert mx.sweep_feasible((16, 16), 4, 2, "single")
    assert not mx.sweep_feasible((128, 128), 4, 2, "single")
    # the launcher's allocation and its pitch check, restated
    assert "sizeof(float) * ((size_t)(kSingle ? 1 : 2) * g.slab_words + " \
           "4 * n_runs + n_taps)" in src
    assert "g.slab_words = (g.s0 * g.s1 * pitch + 3) / 4 * 4;" in src
    assert "pitch % 8 != 4 || pitch < lead + g.s2 + kV + 2" in src
    pitch = mx.sweep_slab_pitch((32, 128), 2, 1)
    assert pitch % 8 == 4 and pitch >= 3 + (128 + 4) + mx.STEP_V + 2
    words = -(-(32 + 4) * pitch // 4) * 4
    assert mx.sweep_smem_bytes((32, 128), 2, 1) == 4 * (2 * words + 5 * 9)
    assert mx.sweep_smem_bytes((32, 128), 2, 1, "single", 17) == \
        4 * (words + 17)
    for name in cuda_build.SOURCES:
        assert cuda_build.library_path(name).name.startswith(f"lib{name}-")


@pytest.mark.parametrize("boundary", ["periodic", "valid"])
def test_scenario_operands_match_reference_and_are_built_once(boundary):
    """The aux operands equal the JAX package's, and a backend core builds
    them once per input shape, not once per call."""
    grid, block, steps = (21, 19), (8, 16), 2
    (ref, _), (port, cover) = _specs(2, "varying+masked", grid)
    r = port.order
    out = tuple(n - 2 * steps * r for n in grid)
    want = ref_ops._scenario_aux_sweep(ref, out, steps * r, block, boundary)
    got = ops._scenario_aux_sweep(port, out, steps * r, block, boundary,
                                  torch.device("cpu"))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = ref_ops._scenario_aux_single(ref, out, block)
    got = ops._scenario_aux_single(port, out, block, torch.device("cpu"))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    from repro_torch.core.engine import StencilEngine
    eng = StencilEngine(port, backend="cuda", block=block,
                        boundary=boundary, device="cpu")
    core = eng.inkernel_core(steps)
    x = torch.from_numpy(
        np.random.default_rng(7).normal(size=grid).astype(np.float32))
    first = core(x)
    again = core(x)
    torch.testing.assert_close(again, first, rtol=0, atol=0)
    assert len(core.keywords["aux_cache"]) == 1
    assert all(a.is_contiguous()
               for a in next(iter(core.keywords["aux_cache"].values())))
