"""The step kernel's axis-0 walk, on the CPU: the rule that picks how many
tiles a block walks, the ring's shared memory against the CUDA source,
the planner's tiles against the ring, a walk launch's price, and the ring
addressing of the tap table, which keeps every output's sum order.

A walk cannot run here (the kernel is CUDA only); chip_smoke phase 6b
holds it bit-equal to the slab path on the card.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core import coefficient_lines as cl
from repro_torch.core import matrixization as mx
from repro_torch.core import planner
from repro_torch.core import stencil_spec as ss
from repro_torch.core import temporal
from repro_torch.kernels import cuda_build
from repro_torch.kernels import stencil_mxu as sm

STAR3D = ss.PAPER_SUITE()["star3d_r2"]
TILE = (16, 32, 32)        # the star3d_r2 cell's tile at 1024^3 and 512^3


def _plan(spec=STAR3D, block=TILE, batch=None, wrap=True, cover="hybrid"):
    return sm.build_kernel_plan(spec, cl.make_cover(spec, cover), block,
                                batch=batch, wrap=wrap)


def _source() -> str:
    return (cuda_build.CSRC / "stencil_step.cu").read_text()


# (output shape, batch) -> the walk the rule picks on an H100 SXM (132 SMs)
WALKS = {((1024, 1024, 1024), 1): 4,
         ((512, 512, 512), 1): 2,
         ((512, 512, 512), 8): 4,
         ((250, 300, 270), 1): 1,
         ((16, 1024, 1024), 1): 1}


@pytest.mark.parametrize("shape,batch", sorted(WALKS))
def test_walk_rule_at_the_recorded_shapes(shape, batch):
    """The walks PERF.md records for the star3d_r2 tile; a state one tile
    deep along axis 0 walks one tile."""
    assert mx.step_walk(shape, TILE, 2, batch, mx.H100_SMS) \
        == WALKS[(shape, batch)]
    assert sm.step_walk_of(_plan(batch=None if batch == 1 else batch),
                           shape, mx.H100_SMS) == WALKS[(shape, batch)]


def test_walk_rule_is_a_function_of_shape_tile_batch_and_card():
    # deeper on a larger state or a larger batch, shallower on a larger card
    assert mx.step_walk((1024,) * 3, TILE, 2, 1, 132) \
        >= mx.step_walk((512,) * 3, TILE, 2, 1, 132)
    assert mx.step_walk((512,) * 3, TILE, 2, 8, 132) \
        >= mx.step_walk((512,) * 3, TILE, 2, 1, 132)
    assert mx.step_walk((1024,) * 3, TILE, 2, 1, 264) \
        <= mx.step_walk((1024,) * 3, TILE, 2, 1, 132)
    for shape in ((1024,) * 3, (512,) * 3, (250, 300, 270), (16, 64, 64)):
        for batch in (1, 3):
            k = mx.step_walk(shape, TILE, 2, batch, mx.H100_SMS)
            assert k in mx.STEP_WALKS
            assert k <= max(1, -(-shape[0] // TILE[0]))


@pytest.mark.parametrize("name,block", [("star2d_r2", (64, 128)),
                                        ("box2d_r1", (8, 16)),
                                        ("star2d_r1", (16, 36))])
def test_a_2d_launch_never_walks(name, block):
    """A 2-D problem reaches the kernel with a leading extent of 1 and no
    halo on it: the slab path, whatever its size."""
    spec = ss.PAPER_SUITE()[name]
    for depth in (1, 2):
        fspec = temporal.fuse_steps(spec, depth) if depth > 1 else spec
        plan = sm.build_kernel_plan(fspec, cl.make_cover(fspec, "parallel"),
                                    block, batch=64, wrap=True)
        assert sm.step_walk_of(plan, (32768, 32768), mx.H100_SMS) == 0
    assert mx.step_walk((1, 32768, 32768), (1, 64, 128), 0, 1, 132) == 0


def test_a_tile_one_plane_deep_does_not_walk():
    assert mx.step_walk_planes((1, 32, 32), 2)[0] == 0
    assert mx.step_walk((64, 1024, 1024), (1, 32, 32), 2, 1, 132) == 0


def test_ring_model_matches_the_kernel_source():
    """The launcher's walk geometry and its shared memory, restated from
    the CUDA source, equal :func:`mx.step_walk_planes` and
    :func:`mx.step_ring_smem_bytes`."""
    src = _source()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert "constexpr int kTy = kThreads / kTx;" in src
    assert "constexpr int kTx = 32 / kV;" in src
    k_ty = consts["kThreads"] // (32 // consts["kV"])
    assert k_ty == mx.STEP_ROWS
    assert "g.q = min((kTy + b1 - 1) / b1, b0 / 2);" in src
    assert "g.ahead = b0 >= 3 * g.q ? 2 : 1;" in src
    assert "g.ring = 2 * h0 + (1 + g.ahead) * g.q;" in src
    assert "if (walk) g.slab_words = (g.ring * g.s1 * pitch + g.lead + 3) " \
           "/ 4 * 4;" in src
    assert "sizeof(float) * ((size_t)g.slab_words + 4 * n_runs + n_taps)" \
        in src
    for block in ((16, 32, 32), (8, 16, 32), (4, 8, 12), (2, 6, 6),
                  (4, 32, 128), (16, 8, 64), (3, 10, 40)):
        for h in (1, 2, 4):
            b0, b1 = block[0], block[1]
            q = min((k_ty + b1 - 1) // b1, b0 // 2)
            ahead = 2 if b0 >= 3 * q else 1
            ring = 2 * h + (1 + ahead) * q
            assert mx.step_walk_planes(block, h) == (q, ahead, ring)
            pitch = mx.step_slab_pitch(block, h)
            for lead in (0, 1, 3):
                words = (ring * (b1 + 2 * h) * pitch + lead + 3) // 4 * 4
                # the wrapper adds one 16-byte unit for a lead, as for the
                # slab
                assert 4 * (words + 49) == mx.step_ring_smem_bytes(
                    block, h, 49) + (16 if lead else 0)
    # at the star3d_r2 cell's tile: 10 planes of 36 rows at a pitch of 36
    assert mx.step_walk_planes(TILE, 2) == (2, 2, 10)
    assert mx.step_ring_smem_bytes(TILE, 2, 49) == 4 * (10 * 36 * 36 + 49)
    # and a tile too shallow for two groups ahead keeps one
    assert mx.step_walk_planes((4, 32, 32), 2) == (2, 1, 8)


@pytest.mark.parametrize("depth", [1, 2])
def test_every_tile_the_planner_admits_fits_the_ring(depth):
    """At r = 2 and T <= 2 (the fused operator's halo), every tile the
    block search admits (its slab within TILE_SMEM_BUDGET) walks in a
    ring no larger than its slab."""
    spec = temporal.fuse_steps(STAR3D, depth) if depth > 1 else STAR3D
    h = spec.order
    seen = 0
    for grid in ((1024,) * 3, (512,) * 3, (250, 300, 270), (64,) * 3,
                 (20, 40, 72)):
        blocks, _ = planner._ranked_blocks(spec, grid, planner._default_hw(),
                                           4, h)
        for block in blocks:
            assert mx.step_smem_bytes(block, h) <= mx.TILE_SMEM_BUDGET
            if mx.step_walk_planes(block, h)[0] < 1:
                assert block[0] == 1
                continue
            assert mx.step_ring_smem_bytes(block, h) \
                <= mx.step_smem_bytes(block, h)
            seen += 1
    assert seen > 10


def _closed_form(grid, block, r, walk, itemsize=4, table=49, batch=1):
    """A walk launch's bytes, restated: every column of tiles on axes 1-2
    reads, walk by walk, the planes of its whole tiles and 2r more, and
    the table once a walk; the state is written once."""
    tiles = [-(-g // b) for g, b in zip(grid, block)]
    plane = (block[1] + 2 * r) * (block[2] + 2 * r)
    walks = [min(walk, tiles[0] - t) * block[0]
             for t in range(0, tiles[0], walk)]
    per_column = sum((n + 2 * r) * plane * itemsize + 4 * table
                     for n in walks)
    return batch * (tiles[1] * tiles[2] * per_column
                    + int(np.prod(grid)) * itemsize)


def test_walk_launch_price_at_1024_cubed():
    """k = 4 at 1024^3: 10,073,735,168 B a launch, 80.589881344 GB a call
    of 8 launches, against 88.820678656 GB on the slab path (a walk of 8
    tiles would read 79.218081792 GB)."""
    plan = _plan()
    assert sm.step_walk_of(plan, (1024,) * 3, mx.H100_SMS) == 4
    cost = sm.step_launch_cost(plan, (1024,) * 3, 4)
    assert cost.bytes == _closed_form((1024,) * 3, TILE, 2, 4)
    assert cost.bytes == 1024 * 16 * ((4 * 16 + 4) * 36 * 36 * 4 + 196) \
        + 4 * 1024 ** 3 == 10_073_735_168
    assert 8 * cost.bytes == 80_589_881_344
    assert 8 * _closed_form((1024,) * 3, TILE, 2, 8) == 79_218_081_792
    slab = sm.step_launch_cost(plan, (1024,) * 3, 4, sms=10 ** 6)
    assert sm.step_walk_of(plan, (1024,) * 3, 10 ** 6) == 1
    assert 8 * slab.bytes == 88_820_678_656
    assert cost.fmas == slab.fmas == 13 * 1024 ** 3


@pytest.mark.parametrize("walk", [1, 2, 4, 8, 16])
def test_walk_launch_price_on_a_ragged_state(walk, monkeypatch):
    """250x300x270 at the star3d_r2 tile: the last walk reads the planes
    of its whole tiles (the kernel walks whole tiles and stores only the
    state's planes); aux rows as the slab path prices them."""
    grid = (250, 300, 270)
    for scenario in ("constant", "varying+masked"):
        spec = STAR3D if scenario == "constant" else STAR3D.with_field(
            np.ones(grid), domain_mask=np.ones(grid, bool))
        plan = _plan(spec)
        # one tile a walk (a card too large for deeper walks) reads what
        # one tile a block does
        slab = sm.step_launch_cost(plan, grid, 4, sms=10 ** 6)
        with monkeypatch.context() as m:
            m.setattr(mx, "step_walk", lambda *a: walk)
            got = sm.step_launch_cost(plan, grid, 4)
        tiles = [-(-g // b) for g, b in zip(grid, TILE)]
        aux = plan.n_aux * int(np.prod(tiles)) * int(np.prod(TILE)) * 4
        table = sm._table_words(plan)
        assert got.bytes == _closed_form(grid, TILE, 2, walk,
                                         table=table) + aux
        if walk == 1:
            assert got == slab
        assert got.fmas == slab.fmas


def test_valid_and_wrap_walks_are_priced_alike():
    """A valid-mode walk on the haloed input and a wrap-mode walk on the
    state of the same output read the same planes; batch folds in."""
    for grid, batch in (((1024,) * 3, None), ((256,) * 3, 3),
                        ((512, 256, 128), 2)):
        lead = (batch,) if batch else ()
        valid = sm.step_launch_cost(_plan(batch=batch, wrap=False),
                                    lead + tuple(g + 4 for g in grid), 4)
        wrap = sm.step_launch_cost(_plan(batch=batch), lead + grid, 4)
        assert valid == wrap
        walk = sm.step_walk_of(_plan(batch=batch), grid, mx.H100_SMS)
        assert walk >= 1
        assert wrap.bytes == _closed_form(grid, TILE, 2, walk,
                                          batch=batch or 1)


def _ring_order(plan, slot, ring):
    """The kernel's ring addressing (``row_outputs``), restated: for an
    output on the plane in ring slot ``slot``, each run of the table in
    order, as (ring slot, storage offset inside the plane)."""
    table, n_runs = sm.tap_table(plan, "cpu")
    head = table.numpy()[:4 * n_runs].reshape(n_runs, 4)
    r = plan.spec.order
    plane_words = (plan.block[1] + 2 * r) * mx.step_slab_pitch(plan.block, r)
    ring_words = ring * plane_words
    wrap_at = (ring - slot) * plane_words
    out = []
    for off, *_ in head:
        off = int(off) if off < wrap_at else int(off) - ring_words
        out.append(divmod(slot * plane_words + off, plane_words))
    return out


@pytest.mark.parametrize("name,depth,block", [
    ("star3d_r2", 1, (16, 32, 32)), ("box3d_r1", 1, (8, 8, 32)),
    ("star3d_r2", 2, (8, 16, 32)), ("star3d_r1", 1, (4, 8, 12)),
    ("box3d_r1", 2, (2, 6, 6))])
@pytest.mark.parametrize("wrap", [False, True])
def test_ring_addressing_keeps_the_row_order(name, depth, block, wrap):
    """Every run of the table lands on ring slot ``(slot + d0) mod ring``
    at its offset inside the plane, in table order, for every slot: the
    runs, and so every output's sum, keep the plan's row order."""
    spec = ss.PAPER_SUITE()[name]
    if depth > 1:
        spec = temporal.fuse_steps(spec, depth)
    plan = _plan(spec, block, wrap=wrap, cover="parallel")
    q, _, ring = mx.step_walk_planes(block, spec.order)
    assert q >= 1
    runs = sm.tap_runs(plan.taps)
    pitch = mx.step_slab_pitch(block, spec.order)
    lead = sm.step_lead(plan)
    for slot in range(ring):
        got = _ring_order(plan, slot, ring)
        want = [((slot + lead_offs[0]) % ring,
                 lead_offs[1] * pitch + start + lead)
                for lead_offs, start, _ in runs]
        assert got == want
    # the table itself is the slab path's, runs in the plan's row order
    keys = [(lead_offs, start) for lead_offs, start, _ in runs]
    assert keys == sorted(keys)


def test_cpu_calls_count_no_walk_launch():
    plan = _plan()
    before = (sm.stencil_cuda_call.launches,
              sm.stencil_cuda_call.walk_launches)
    x = torch.randn(20, 33, 40)
    y = sm.stencil_cuda_call(x, plan)
    assert y.shape == x.shape
    assert (sm.stencil_cuda_call.launches,
            sm.stencil_cuda_call.walk_launches) == before
    assert sm.sm_count("cpu") == mx.H100_SMS == 132
