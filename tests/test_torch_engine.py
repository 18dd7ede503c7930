"""The port's engine against the JAX package's gather oracle.

``assert_sweep_parity`` is the port of ``tests/parity.py``'s harness with
the JAX ``reference_evolve`` as its oracle (atol 1e-4, the ROADMAP bar);
the engines run on the CPU, where the ``cuda`` backend's kernel wrappers
use their plain versions.  Illegal fusion pins must raise ``ValueError``
exactly where the JAX engine raises.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as ref_engine
from repro.core import stencil_spec as ref_ss
from repro.core import time_stepper as ref_ts

from repro_torch.core import engine
from repro_torch.core import stencil_spec as ss
from repro_torch.core import temporal
from repro_torch.core import time_stepper as ts

torch.set_num_threads(2)

SCENARIOS = ("constant", "varying", "masked", "varying+masked")
BOUNDARIES = ("valid", "zero", "periodic")
STRATEGIES = ("operator", "inkernel")


def _sample_suite(n=3, seed=2024):
    """A seeded sample of PAPER_SUITE within the test sizes (2-D any
    order, 3-D up to r=2), always holding one 2-D and one 3-D spec."""
    names = sorted(n for n in ss.PAPER_SUITE()
                   if not (n.endswith("r3") and "3d" in n))
    rng = np.random.default_rng(seed)
    two = [n for n in names if "2d" in n]
    three = [n for n in names if "3d" in n]
    pick = [rng.choice(two), rng.choice(three)]
    rest = [n for n in names if n not in pick]
    pick.append(rng.choice(rest))
    return sorted(pick[:n])


SAMPLE = _sample_suite()


def parity_grid(spec, steps=4):
    n = 40 if spec.ndim == 2 else max(20, 2 * spec.order * steps + 4)
    return (n,) * spec.ndim


def with_scenario(pair, grid, kind, seed=0):
    """The same seeded field/mask on the JAX and the port spec."""
    ref, port = pair
    if kind == "constant":
        return ref, port
    field = ss.random_coeff_field(grid, seed=seed) if "varying" in kind else None
    mask = ss.random_domain_mask(grid, seed=seed + 1) if "mask" in kind else None
    if field is not None:
        return (ref.with_field(field, domain_mask=mask),
                port.with_field(field, domain_mask=mask))
    return ref.with_mask(mask), port.with_mask(mask)


def assert_sweep_parity(ref_spec, spec, boundary, strategy="auto",
                        depth="auto", batch=0, *, steps=4, grid=None,
                        seed=0, backend="cuda", block=None, atol=1e-4):
    """Fused-sweep parity of the port for one (spec, boundary, strategy,
    depth, batch) against JAX ``reference_evolve``.

    ``batch>=1`` folds that many states and additionally requires
    bit-exactness against the per-state sweeps.  An illegal explicit
    (strategy, depth) pin must raise ``ValueError``; the harness asserts
    that and returns None.
    """
    grid = tuple(grid or parity_grid(spec, steps))
    if block is None:
        block = (16, 16) if spec.ndim == 2 else (4, 8, 8)
    eng = engine.StencilEngine(spec, backend=backend, block=block,
                               boundary=boundary, device="cpu")
    label = (f"{spec.describe()} boundary={boundary} strategy={strategy} "
             f"depth={depth} batch={batch} steps={steps}")
    pinned = strategy != "auto" and isinstance(depth, int)
    if pinned and not temporal.fusion_legal(spec, boundary, strategy, depth):
        with pytest.raises(ValueError):
            fn = eng.sweep_fn(steps, fuse=depth, grid=grid, strategy=strategy)
            fn(torch.zeros(grid))
        return None
    x = np.random.default_rng(seed).normal(
        size=((batch,) + grid) if batch else grid).astype(np.float32)
    fn = eng.sweep_fn(steps, fuse=depth, grid=grid, strategy=strategy)
    out = fn(torch.from_numpy(x))
    want = ref_ts.reference_evolve(ref_spec, jnp.asarray(x), steps, boundary)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=atol,
                               err_msg=f"sweep diverged from oracle: {label}")
    if batch:
        for i in range(batch):
            torch.testing.assert_close(out[i], fn(torch.from_numpy(x[i])),
                                       rtol=0, atol=0,
                                       msg=f"batched not bit-exact: {label}")
    return out


def _pair(name):
    return ref_ss.PAPER_SUITE()[name], ss.PAPER_SUITE()[name]


@pytest.mark.parametrize("kind", SCENARIOS)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", SAMPLE)
def test_sweep_parity_matrix(name, boundary, strategy, kind):
    pair = _pair(name)
    grid = parity_grid(pair[1])
    ref, port = with_scenario(pair, grid, kind, seed=7)
    assert_sweep_parity(ref, port, boundary, strategy, depth=2, grid=grid)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", ["box2d_r1", "star3d_r1"])
def test_batched_sweep_parity_and_remainder_chunk(name, strategy):
    """A folded batch with a 3+1 schedule (remainder chunk) under the
    Dirichlet-0 strip splice."""
    ref, port = _pair(name)
    assert_sweep_parity(ref, port, "zero", strategy, depth=3, batch=2)


@pytest.mark.parametrize("kind", SCENARIOS)
def test_auto_sweep_parity(kind):
    pair = _pair("star2d_r1")
    grid = parity_grid(pair[1])
    ref, port = with_scenario(pair, grid, kind, seed=3)
    assert_sweep_parity(ref, port, "periodic", grid=grid, steps=5)


@pytest.mark.parametrize("kind", SCENARIOS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_illegal_pins_raise_where_reference_raises(boundary, kind):
    pair = _pair("star2d_r1")
    grid = (24, 24)
    ref, port = with_scenario(pair, grid, kind, seed=11)
    ref_eng = ref_engine.StencilEngine(ref, backend="pallas", block=(8, 8),
                                       boundary=boundary)
    eng = engine.StencilEngine(port, backend="cuda", block=(8, 8),
                               boundary=boundary, device="cpu")
    for strategy in STRATEGIES:
        for depth in (1, 2, 3):
            outcomes = []
            for e in (ref_eng, eng):
                try:
                    e.sweep_fn(6, fuse=depth, grid=grid, strategy=strategy)
                    outcomes.append("ok")
                except ValueError:
                    outcomes.append("raise")
            assert outcomes[0] == outcomes[1], (kind, boundary, strategy,
                                                depth, outcomes)


def test_misuse_raises_like_reference():
    spec = ss.star(2, 1)
    eng = engine.StencilEngine(spec, backend="cuda", boundary="periodic",
                               device="cpu")
    x = torch.zeros(16, 16)
    for bad in (lambda: eng.sweep(x, 4, fuse=0),
                lambda: eng.sweep(x, -1),
                lambda: eng.sweep(x, 4, strategy="bogus"),
                lambda: engine.StencilEngine(spec, boundary="bogus",
                                             device="cpu"),
                lambda: engine.StencilEngine(spec, boundary="valid",
                                             device="cpu").run(x, 2),
                lambda: engine.StencilEngine(spec, backend="torch",
                                             device="cpu").sweep(
                                                 x, 4, strategy="inkernel"),
                lambda: eng(torch.zeros(16, 16, device="meta"))):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("backend,name", [
    (be, name) for be in ("torch", "separable", "codegen", "cuda")
    for name in ("box2d_r2", "star2d_r1", "diag2d_r1", "star3d_r1")
    if not (be == "separable" and "3d" in name)])   # separable is 2-D only
def test_every_backend_step_matches_oracle(backend, name):
    ref, port = _pair(name)
    assert engine.get_backend(backend).supports(port)
    grid = (23, 17) if port.ndim == 2 else (7, 9, 11)
    x = np.random.default_rng(1).normal(size=(2,) + grid).astype(np.float32)
    eng = engine.StencilEngine(port, backend=backend, boundary="zero",
                               block=(8, 8) if port.ndim == 2 else (4, 4, 8),
                               device="cpu")
    want = ref_ts.reference_evolve(ref, jnp.asarray(x), 3, "zero")
    np.testing.assert_allclose(eng.run(torch.from_numpy(x), 3).numpy(),
                               np.asarray(want), atol=1e-4)


def test_periodic_inkernel_chunk_pads_for_a_backend_without_wrap_mode(
        monkeypatch):
    """A backend whose sweep core ignores ``boundary`` (``wraps=False``)
    gets its valid-mode chunk lifted by the halo layer at 'periodic', as
    its single step does: the state keeps its shape."""
    from repro_torch.kernels import ops as kops

    def sweep_builder(plan, steps, *, scratch="pingpong", **_opts):
        return kops.cuda_sweep_core(plan, steps, scratch=scratch)

    monkeypatch.setitem(engine._BACKENDS, "valid_sweep", engine.Backend(
        name="valid_sweep", builder=engine._cuda_builder,
        sweep_builder=sweep_builder, wraps=False))
    ref, port = _pair("star2d_r1")
    x = np.random.default_rng(5).normal(size=(24, 20)).astype(np.float32)
    eng = engine.StencilEngine(port, backend="valid_sweep",
                               boundary="periodic", block=(8, 8),
                               device="cpu")
    y = eng.sweep(torch.from_numpy(x), 4, fuse=2, strategy="inkernel")
    assert y.shape == x.shape
    want = ref_ts.reference_evolve(ref, jnp.asarray(x), 4, "periodic")
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-4)


def test_codegen_emits_torch_source():
    from repro_torch.core.codegen import generate_update
    eng = engine.StencilEngine(ss.box(2, 1), backend="codegen", device="cpu")
    gen = generate_update(eng.plan)
    assert "torch.tensordot" in gen.source and "jnp" not in gen.source


def test_time_stepper_drivers():
    ref, port = _pair("star2d_r2")
    x = np.random.default_rng(4).normal(size=(24, 24)).astype(np.float32)
    xt = torch.from_numpy(x)
    eng = engine.StencilEngine(port, backend="cuda", boundary="periodic",
                               block=(8, 8), device="cpu")
    want = np.asarray(ref_ts.reference_evolve(ref, jnp.asarray(x), 5,
                                              "periodic"))
    res, recs = ts.evolve(eng.step_fn(), xt, 5, record_every=2)
    assert recs.shape == (2, 24, 24) and res.steps_run == 5
    np.testing.assert_allclose(res.state.numpy(), want, atol=1e-4)
    fused = ts.evolve_fused(eng, xt, 5, fuse=2)
    np.testing.assert_allclose(fused.state.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(
        ts.reference_evolve(port, xt, 5, "periodic").numpy(), want,
        atol=1e-4)
    assert float(fused.residual) == pytest.approx(float(res.residual),
                                                  rel=1e-4)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        engine.StencilEngine(ss.box(2, 1), backend="cuda")
