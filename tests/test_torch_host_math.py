"""Host math of the PyTorch port against the JAX package: specs, covers,
bands, operator fusion, fusion legality and fuse schedules must agree
exactly (they are decided without reference to hardware)."""
import itertools

import numpy as np
import pytest
import torch

from repro.core import coefficient_lines as ref_cl
from repro.core import engine as ref_engine
from repro.core import matrixization as ref_mx
from repro.core import stencil_spec as ref_ss
from repro.core import temporal as ref_temporal

from repro_torch.core import coefficient_lines as cl
from repro_torch.core import engine
from repro_torch.core import matrixization as mx
from repro_torch.core import stencil_spec as ss
from repro_torch.core import temporal

torch.set_num_threads(2)

SUITE = sorted(ss.PAPER_SUITE())


def _both(name):
    return ref_ss.PAPER_SUITE()[name], ss.PAPER_SUITE()[name]


@pytest.mark.parametrize("name", SUITE)
def test_gather_coeffs_match(name):
    ref, port = _both(name)
    np.testing.assert_array_equal(port.gather_coeffs, ref.gather_coeffs)
    assert (port.ndim, port.order, port.shape, port.taps) == \
        (ref.ndim, ref.order, ref.shape, ref.taps)


@pytest.mark.parametrize("name", SUITE)
def test_covers_and_bands_match(name):
    ref, port = _both(name)
    assert engine.legal_covers(port) == ref_engine.legal_covers(ref)
    for opt in engine.legal_covers(port):
        rc, pc = ref_cl.make_cover(ref, opt), cl.make_cover(port, opt)
        assert len(rc.lines) == len(pc.lines), opt
        for rl, pl in zip(rc.lines, pc.lines):
            assert (rl.axis, rl.fixed) == (pl.axis, pl.fixed)
            np.testing.assert_array_equal(pl.coeffs, rl.coeffs)
            if not pl.is_diagonal:
                rb, rf = ref_mx.line_to_gather_band(rl, ref)
                pb, pf = mx.line_to_gather_band(pl, port)
                np.testing.assert_array_equal(pb, rb)
                assert pf == rf
                np.testing.assert_array_equal(
                    mx.toeplitz_band_np(pb, 7), ref_mx.toeplitz_band_np(rb, 7))
        assert cl.cover_outer_product_count(pc, 64) == \
            ref_cl.cover_outer_product_count(rc, 64)
    assert engine.choose_cover(port, 32)[0] == ref_engine.choose_cover(ref, 32)[0]


@pytest.mark.parametrize("seed", range(6))
def test_minimal_cover_matches_on_random_taps(seed):
    """The port's own König construction against the reference's graph
    library on random 2-D tap patterns (sizes and line counts; the exact
    lines where the minimum cover is unique)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(size=(5, 5)) * (rng.uniform(size=(5, 5)) < 0.4)
    c[2, 2] = 1.0
    rc = ref_cl.make_cover(ref_ss.from_gather_coeffs(c), "minimal")
    pc = cl.make_cover(ss.from_gather_coeffs(c), "minimal")
    assert len(pc.lines) == len(rc.lines)
    pc.validate()


@pytest.mark.parametrize("name,steps", [(n, t) for n in SUITE
                                        if not n.startswith("box3d")
                                        for t in (2, 3)]
                         + [("box3d_r1", 2)])
def test_fuse_steps_match(name, steps):
    ref, port = _both(name)
    np.testing.assert_array_equal(temporal.fuse_steps(port, steps).gather_coeffs,
                                  ref_temporal.fuse_steps(ref, steps).gather_coeffs)


def test_fusion_legal_truth_table():
    grid = (12, 12)
    field = ss.random_coeff_field(grid, seed=3)
    mask = ss.random_domain_mask(grid, seed=4)
    base_p = ss.star(2, 1, seed=5)
    base_r = ref_ss.star(2, 1, seed=5)
    kinds = {
        "constant": (base_r, base_p),
        "varying": (base_r.with_field(field), base_p.with_field(field)),
        "masked": (base_r.with_mask(mask), base_p.with_mask(mask)),
        "varying+masked": (base_r.with_field(field, domain_mask=mask),
                           base_p.with_field(field, domain_mask=mask)),
    }
    for (kind, (r_spec, p_spec)), boundary, strategy, depth in itertools.product(
            kinds.items(), ("valid", "zero", "periodic"),
            ("operator", "inkernel"), (1, 2, 4)):
        assert temporal.fusion_legal(p_spec, boundary, strategy, depth) == \
            ref_temporal.fusion_legal(r_spec, boundary, strategy, depth), \
            (kind, boundary, strategy, depth)
        assert p_spec.scenario_digest() == r_spec.scenario_digest()


@pytest.mark.parametrize("steps,depth", [(0, 1), (1, 1), (7, 3), (8, 4),
                                         (16, 3), (5, 8)])
def test_fuse_schedule_matches(steps, depth):
    assert temporal.fuse_schedule(steps, depth) == \
        ref_temporal.fuse_schedule(steps, depth)


def test_fuse_schedule_rejects_like_reference():
    for steps, depth in ((-1, 1), (3, 0)):
        with pytest.raises(ValueError):
            ref_temporal.fuse_schedule(steps, depth)
        with pytest.raises(ValueError):
            temporal.fuse_schedule(steps, depth)


def test_scenario_generators_match():
    for grid in ((9, 11), (5, 6, 7)):
        np.testing.assert_array_equal(ss.random_coeff_field(grid, seed=2),
                                      ref_ss.random_coeff_field(grid, seed=2))
        np.testing.assert_array_equal(ss.random_domain_mask(grid, seed=2),
                                      ref_ss.random_domain_mask(grid, seed=2))
        mask = ss.random_domain_mask(grid, seed=7)
        for block in ((4,) * len(grid), (3,) * len(grid)):
            assert mx.active_block_fraction(mask, block) == \
                ref_mx.active_block_fraction(mask, block)


def test_from_numpy_carries_a_reference_spec():
    grid = (10, 12)
    ref = ref_ss.star(2, 2, seed=9).with_field(
        ref_ss.random_coeff_field(grid, seed=1),
        domain_mask=ref_ss.random_domain_mask(grid, seed=2))
    from repro.core.planner import StencilProblem as RefProblem
    serialized = RefProblem(ref, grid=grid).to_dict()["spec"]
    for desc in (serialized, {"gather_coeffs": ref.gather_coeffs,
                              "shape": ref.shape,
                              "coefficients": ref.coefficients,
                              "coeff_field": ref.coeff_field,
                              "domain_mask": ref.domain_mask}):
        port = ss.from_numpy(desc)
        np.testing.assert_array_equal(port.gather_coeffs, ref.gather_coeffs)
        np.testing.assert_array_equal(port.coeff_field, ref.coeff_field)
        np.testing.assert_array_equal(port.domain_mask, ref.domain_mask)
        assert port.scenario_digest() == ref.scenario_digest()
