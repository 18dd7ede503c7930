"""The sweep kernel's axis-0 walk, on the CPU: the rule that picks how many
tiles a block walks, the rings' shared memory against the CUDA source,
the planner's tiles against the rings, a walk launch's price, and the
walk's schedule, restated in numpy with its rings, its slots and its tap
table, against the plain version bit for bit.

A walk cannot run here (the kernel is CUDA only); chip_smoke phase 6b
holds it bit-equal to the slab path on the card.
"""
import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import coefficient_lines as cl
from repro_torch.core import halo
from repro_torch.core import matrixization as mx
from repro_torch.core import stencil_spec as ss
from repro_torch.kernels import cuda_build
from repro_torch.kernels import stencil_mxu as sm

STAR2D = ss.PAPER_SUITE()["star2d_r2"]
TILE = (64, 128)           # the star2d_r2 cell's tile at 32768^2, T = 3
ROOT = Path(__file__).resolve().parents[1]


def _plan(spec=STAR2D, block=TILE, steps=3, batch=None, wrap=True,
          cover="minimal"):
    return sm.build_sweep_kernel_plan(spec, cl.make_cover(spec, cover),
                                      block, steps, batch=batch, wrap=wrap)


def _source() -> str:
    return (cuda_build.CSRC / "stencil_sweep.cu").read_text()


# (output shape, steps, batch) -> the walk the rule picks on an H100 SXM
# (132 SMs) at the star2d_r2 tile
WALKS = {((32768, 32768), 3, 1): 4,
         ((16384, 16384), 3, 1): 4,
         ((8192, 8192), 3, 1): 2,
         ((8192, 8192), 3, 4): 4,
         ((4096, 4096), 3, 1): 1,
         ((1000, 1300), 3, 1): 1,
         ((32768, 32768), 1, 1): 1,
         ((32768, 32768), 6, 1): 8}


@pytest.mark.parametrize("shape,steps,batch", sorted(WALKS))
def test_walk_rule_at_the_recorded_shapes(shape, steps, batch):
    """k = 4 at the cell's 32768^2 launch (32,768 blocks, 248 an SM);
    shallower where the launch would leave the card short of blocks."""
    want = WALKS[(shape, steps, batch)]
    assert mx.sweep_walk(shape, TILE, steps, 2, batch, mx.H100_SMS) == want
    plan = _plan(steps=steps, batch=None if batch == 1 else batch)
    assert sm.sweep_walk_of(plan, shape, mx.H100_SMS) == want


def test_the_cells_launch_has_248_blocks_an_sm():
    tiles = [-(-32768 // b) for b in TILE]
    blocks = tiles[1] * -(-tiles[0] // 4)
    assert blocks == 32768 and blocks // mx.H100_SMS == 248


def test_walk_rule_is_a_function_of_shape_tile_batch_and_card():
    for shape in ((32768,) * 2, (8192,) * 2, (1000, 1300), (64, 64)):
        for steps in (1, 3, 4):
            for batch in (1, 3):
                k = mx.sweep_walk(shape, TILE, steps, 2, batch, 132)
                assert k in mx.STEP_WALKS
                assert k <= max(1, -(-shape[0] // TILE[0]))
                # shallower on a larger card, deeper on a larger batch
                assert mx.sweep_walk(shape, TILE, steps, 2, batch, 264) <= k
                assert mx.sweep_walk(shape, TILE, steps, 2, 8 * batch,
                                     132) >= k
    # the halving: a launch short of STEP_WALK_BLOCKS blocks an SM
    assert mx.sweep_walk((8192, 8192), TILE, 3, 2, 1, 132) == 2
    assert 64 * (128 // 4) < mx.STEP_WALK_BLOCKS * 132 \
        <= 64 * (128 // 2)


@pytest.mark.parametrize("name,block,steps", [
    ("star3d_r2", (16, 32, 32), 2), ("box3d_r1", (8, 8, 32), 2),
    ("star3d_r1", (4, 4, 8), 4)])
def test_a_3d_launch_never_walks(name, block, steps):
    spec = ss.PAPER_SUITE()[name]
    plan = _plan(spec, block, steps, cover="parallel")
    for shape in ((1024,) * 3, (512,) * 3, (90, 90, 90)):
        assert mx.sweep_walk(shape, block, steps, spec.order, 1, 132) == 0
        assert sm.sweep_walk_of(plan, shape, mx.H100_SMS) == 0
    cost = sm.sweep_launch_cost(plan, (256,) * 3, 4)
    assert cost == sm.sweep_launch_cost(plan, (256,) * 3, 4, sms=1)


def test_no_walk_beyond_the_compiled_orders():
    assert mx.sweep_walk((8192, 8192), TILE, 2, 4, 1, 132) >= 1
    assert mx.sweep_walk((8192, 8192), TILE, 2, 5, 1, 132) == 0
    assert mx.sweep_walk((8192, 8192), TILE, 2, 0, 1, 132) == 0


def test_no_walk_for_two_taps_at_one_offset():
    """The walking kernel keeps one tap a position; a plan with two taps
    at one offset (a cover may split a coefficient between lines) keeps
    the slab, and is priced as the slab."""
    plan = _plan()
    assert sm.sweep_walk_of(plan, (32768, 32768), mx.H100_SMS) == 4
    c, g = plan.taps[0]
    split = dataclasses.replace(plan, point_taps=plan.point_taps + (
        (0.0 * c, g),))
    assert len(split.taps) == len(plan.taps) + 1
    assert sm.sweep_walk_of(split, (32768, 32768), mx.H100_SMS) == 0
    assert sm.sweep_launch_cost(split, (32768, 32768), 4).bytes \
        == sm.sweep_launch_cost(split, (32768, 32768), 4, sms=10 ** 6).bytes


def test_no_walk_where_the_rings_exceed_the_launch_limit():
    # 64 steps of order 4 on a wide tile: rings of 8 + 24 + 63 * 16 rows
    block, steps, order = (8, 1024), 64, 4
    assert mx.sweep_ring_smem_bytes(block, steps, order) > mx.SMEM_BYTES
    assert mx.sweep_walk((8192, 8192), block, steps, order, 1, 132) == 0
    assert mx.sweep_walk((8192, 8192), (8, 128), 4, order, 1, 132) >= 1


def test_ring_model_matches_the_kernel_source():
    """The launcher's rings and the walk's shared memory, restated from the
    CUDA source, equal :func:`mx.sweep_walk_rings` and
    :func:`mx.sweep_ring_smem_bytes`; the walking kernel's name holds the
    benchmark's kernel symbol, so its device time counts as the sweep's."""
    src = _source()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kWalkRows"] == mx.SWEEP_WALK_ROWS
    assert consts["kWalkAhead"] == mx.SWEEP_WALK_AHEAD
    assert "g.ring0 = 2 * h1 + (1 + kWalkAhead) * kWalkRows;" in src
    assert "g.ring1 = 2 * h1 + 2 * kWalkRows;" in src
    assert "if (walk) g.slab_words = ((g.ring0 + (steps - 1) * g.ring1) * " \
           "pitch + 3) / 4 * 4;" in src
    assert consts["kWalkMaxOrder"] == mx.SWEEP_WALK_MAX_ORDER
    # the walk's taps: a mask for each row of the (2r+1)-square and a
    # coefficient for each position, within the default table bound
    assert "sizeof(float) * ((size_t)g.slab_words + (2 * R + 1) * (2 * R + 2))" \
        in src
    for order in range(1, mx.SWEEP_WALK_MAX_ORDER + 1):
        side = 2 * order + 1
        assert side * (side + 1) <= 5 * side ** 2
    assert "__global__ void __launch_bounds__(kThreads, 4) " \
           "stencil_sweep_kernel_walk(" in src
    for order in range(1, mx.SWEEP_WALK_MAX_ORDER + 1):
        assert f"    case {order}: return launch_walk<T, {order}>(" in src
    symbols = json.loads((ROOT / "portbench" / "kernels" / "stencil.json")
                         .read_text())["symbols"]
    assert any(s in "stencil_sweep_kernel_walk" for s in symbols)
    q, ahead = consts["kWalkRows"], consts["kWalkAhead"]
    for block in ((64, 128), (8, 16), (32, 36), (16, 64), (128, 512)):
        for steps in (1, 2, 3, 4, 8):
            for order in (1, 2, 3, 4):
                ring0 = 2 * order + (1 + ahead) * q
                ring1 = 2 * order + 2 * q
                assert mx.sweep_walk_rings(steps, order) \
                    == (q, ahead, ring0, ring1)
                pitch = mx.sweep_slab_pitch(block, steps, order)
                words = ((ring0 + (steps - 1) * ring1) * pitch + 3) // 4 * 4
                assert 4 * (words + 29) == mx.sweep_ring_smem_bytes(
                    block, steps, order, 29)
    # at the star2d_r2 cell's tile: a 36-row input ring and two 36-row
    # step rings at the slab's 156-word pitch, 67 KB (the slab: 2 x 76
    # rows, 95 KB): three blocks an SM
    assert mx.sweep_walk_rings(3, 2) == (16, 1, 36, 36)
    assert mx.sweep_slab_pitch(TILE, 3, 2) == 156
    assert mx.sweep_ring_smem_bytes(TILE, 3, 2, 29) == 4 * (108 * 156 + 29)
    assert mx.sweep_smem_bytes(TILE, 3, 2, table_words=29) \
        == 4 * (2 * 76 * 156 + 29)


@pytest.mark.parametrize("name,grid,steps", [
    ("star2d_r2", (32768, 32768), 16), ("star2d_r2", (8192, 8192), 16),
    ("star2d_r1", (4096, 4096), 8), ("box2d_r1", (8192, 8192), 16),
    ("box2d_r3", (4096, 4096), 8), ("star2d_r2", (1000, 1300), 12)])
def test_every_sweep_tile_the_planner_admits_walks(name, grid, steps):
    """Every in-kernel candidate the planner admits (its slab within
    TILE_SMEM_BUDGET) walks in rings that fit the launch limit and, at
    the sweep's depths, take no more shared memory than its slab."""
    spec = ss.PAPER_SUITE()[name]
    p = api.plan(api.StencilProblem(spec, grid=grid, steps=steps),
                 backends=["cuda"], fuse_strategy="inkernel")
    seen = 0
    for c in p.candidates:
        if c.strategy != "inkernel" or c.depth < 2:
            continue
        assert mx.sweep_feasible(c.block, c.depth, spec.order,
                                 limit=mx.TILE_SMEM_BUDGET)
        rings = mx.sweep_ring_smem_bytes(c.block, c.depth, spec.order)
        assert rings <= mx.SMEM_BYTES
        assert mx.sweep_walk(grid, c.block, c.depth, spec.order, 1,
                             mx.H100_SMS) >= 1
        seen += 1
    assert seen >= 1


def _closed_form(grid, block, steps, r, walk, itemsize=4, table=29, batch=1,
                 n_aux=0):
    """A walk launch's bytes, restated: every strip of tiles reads, walk by
    walk, the rows of its whole tiles and 2Tr more at the slab's width,
    the table once a walk, and each aux operand once for every output the
    walk computes; the state is written once."""
    tiles = [-(-g // b) for g, b in zip(grid, block)]
    w = steps * r
    lens = [min(walk, tiles[0] - t) * block[0]
            for t in range(0, tiles[0], walk)]
    live = sum((n + 2 * (steps - 1 - s) * r) * (block[1] + 2 * (steps - 1 - s)
                                                * r)
               for n in lens for s in range(steps))
    per_strip = sum((n + 2 * w) * (block[1] + 2 * w) * itemsize + 4 * table
                    for n in lens) + n_aux * live * 4
    return batch * (tiles[1] * per_strip + int(np.prod(grid)) * itemsize)


def test_walk_launch_price_at_the_cells_size():
    """k = 4 at 32768^2: 9,216,589,824 B a launch, and with the call's one
    step launch 55,099,129,856 B a call of 5 sweeps, against 9,888,595,968
    and 58,459,160,576 on the slab path."""
    plan = _plan()
    grid = (32768, 32768)
    assert sm.sweep_walk_of(plan, grid, mx.H100_SMS) == 4
    cost = sm.sweep_launch_cost(plan, grid, 4)
    assert cost.bytes == _closed_form(grid, TILE, 3, 2, 4) == 9_216_589_824
    assert cost.bytes == 256 * 128 * ((256 + 12) * 140 * 4 + 116) \
        + 4 * 2 ** 30
    slab = sm.sweep_launch_cost(plan, grid, 4, sms=10 ** 6)
    assert sm.sweep_walk_of(plan, grid, 10 ** 6) == 1
    assert slab.bytes == 9_888_595_968
    step = sm.build_kernel_plan(STAR2D, cl.make_cover(STAR2D, "minimal"),
                                TILE, wrap=True)
    step_bytes = sm.step_launch_cost(step, grid, 4).bytes
    assert step_bytes == 9_016_180_736
    assert 5 * cost.bytes + step_bytes == 55_099_129_856
    assert 5 * slab.bytes + step_bytes == 58_459_160_576
    # each level's rows once along the walk: 3 x 9 taps for each output
    # and the column halo's rings
    assert cost.fmas == 9 * 256 * 128 * sum(
        (256 + 4 * (2 - s)) * (128 + 4 * (2 - s)) for s in range(3))
    assert cost.fmas < slab.fmas


@pytest.mark.parametrize("walk", [1, 2, 3, 4, 16])
def test_walk_launch_price_on_a_ragged_state(walk, monkeypatch):
    """1000x1300 at the cell's tile: the last walk reads the rows of its
    whole tiles (the kernel walks whole tiles and stores only the state's
    rows); a walk of one tile prices what one tile a block does."""
    grid = (1000, 1300)
    for scenario in ("constant", "varying+masked"):
        spec = STAR2D if scenario == "constant" else STAR2D.with_field(
            np.ones(grid), domain_mask=np.ones(grid, bool))
        for batch in (None, 3):
            plan = _plan(spec, batch=batch)
            lead = (batch,) if batch else ()
            slab = sm.sweep_launch_cost(plan, lead + grid, 4, sms=10 ** 6)
            with monkeypatch.context() as m:
                m.setattr(mx, "sweep_walk", lambda *a: walk)
                got = sm.sweep_launch_cost(plan, lead + grid, 4)
            assert got.bytes == _closed_form(
                grid, TILE, 3, 2, walk, table=sm._table_words(plan),
                batch=batch or 1, n_aux=plan.n_aux)
            if walk == 1:
                assert got == slab
            else:
                assert got.bytes < slab.bytes and got.fmas < slab.fmas


def test_valid_and_wrap_walks_are_priced_alike():
    for grid, batch in (((32768, 32768), None), ((8192, 4096), 3),
                        ((2048, 1024), 2)):
        lead = (batch,) if batch else ()
        valid = sm.sweep_launch_cost(_plan(batch=batch, wrap=False),
                                     lead + tuple(g + 12 for g in grid), 4)
        wrap = sm.sweep_launch_cost(_plan(batch=batch), lead + grid, 4)
        assert valid == wrap
        walk = sm.sweep_walk_of(_plan(batch=batch), grid, mx.H100_SMS)
        assert walk >= 1
        assert wrap.bytes == _closed_form(grid, TILE, 3, 2, walk,
                                          batch=batch or 1)


# ---------------------------------------------------------------------------
# The walk's schedule, restated
# ---------------------------------------------------------------------------

def _walk_model(x: torch.Tensor, plan, aux, walk: int) -> torch.Tensor:
    """``stencil_sweep_kernel_walk`` in numpy, block by block: the rings at
    the slab's pitch and their leads, the input groups loading kWalkAhead
    steps ahead, each level L's group j - L + 1 at step j, and the slab
    path's tap table laid out by position, each output's window read row
    by row through the rings' slots.
    Every ring slot carries the row it holds and the step that wrote it
    (an input slot the group that brought it), and every read checks
    them: a row read before it landed, in the step that wrote it, or after
    the row a ring further overwrote it, fails.  Arithmetic as the plain
    version's (f32 products, then sums), so the outputs equal
    :func:`sm.sweep_plain` bit for bit."""
    r, steps = plan.spec.order, plan.steps
    b1, b2 = plan.block
    w = steps * r
    q, ahead, ring0, ring1 = mx.sweep_walk_rings(steps, r)
    pitch = mx.sweep_slab_pitch(plan.block, steps, r)
    xs = x.numpy()
    n1, n2 = xs.shape[-2:]
    o1, o2 = (n1, n2) if plan.wrap else (n1 - 2 * w, n2 - 2 * w)
    tiles1, tiles2 = -(-o1 // b1), -(-o2 // b2)
    aligned = n2 % 4 == 0 and b2 % 4 == 0
    lead = (-w) % 4 if plan.wrap and aligned else 0
    # ring L > 0 stores its rows so that every level's window rows start at
    # the input ring's offset modulo 4

    def lead_of(ring):
        return (lead - ring * r) % 4
    table, n_runs = sm.tap_table(plan, "cpu")
    table = table.numpy()
    head = table[:4 * n_runs].reshape(n_runs, 4)
    coefs = table[4 * n_runs:].view(np.float32)
    # the table by position, as the kernel lays it out: the coefficient of
    # row d and column e of the (2r+1)-square, None where it holds no tap
    at_pos = [[None] * (2 * r + 1) for _ in range(2 * r + 1)]
    for off, width, ci, _ in head:
        dr = (int(off) + r * pitch + pitch // 2) // pitch - r
        dc = int(off) - dr * pitch
        for k in range(width):
            assert at_pos[dr + r][dc + r + k] is None   # one tap a position
            at_pos[dr + r][dc + r + k] = coefs[ci + k]
    auxs = [a.numpy() for a in aux]
    kv = mx.STEP_V
    ring_at = [0] + [(ring0 + i * ring1) * pitch for i in range(steps - 1)]
    ring_of = [ring0] + [ring1] * (steps - 1)
    out = np.full(xs.shape[:-2] + (o1, o2), np.nan, np.float32)

    def source(c, n):
        if 0 <= c < n:
            return c
        return c % n if plan.wrap else -1

    for state in np.ndindex(xs.shape[:-2]):
        xstate = xs[state]
        for t2 in range(tiles2):
            for t1 in range(0, tiles1, walk):
                g1, g2 = t1 * b1, t2 * b2
                length = min(walk * b1, tiles1 * b1 - g1)
                n_in = length + 2 * w
                org1 = g1 - w if plan.wrap else g1
                org2 = g2 - w if plan.wrap else g2
                smem = np.full(ring_at[-1] + ring_of[-1] * pitch + 2 * pitch,
                               np.nan, np.float32)
                tags = [[None] * n for n in ring_of]

                def load(p, n, group):
                    for i in range(p, p + min(n, n_in - p)):
                        r1 = source(org1 + i, n1)
                        row = np.zeros(b2 + 2 * w, np.float32)
                        if r1 >= 0:
                            cols = [source(org2 + c, n2)
                                    for c in range(b2 + 2 * w)]
                            row = np.array([xstate[r1, c] if c >= 0 else 0
                                            for c in cols], np.float32)
                        at = (i % ring0) * pitch + lead
                        smem[at:at + row.size] = row
                        tags[0][i % ring0] = (i, group)

                def hi(level, j):
                    extra = 2 * (steps - level) * r
                    return max(0, min((j + 1) * q + extra, length + extra))

                j0 = -((2 * (steps - 1) * r + q - 1) // q)

                def load_group(group):
                    start = 0 if group == j0 else hi(0, group - 1)
                    load(start, hi(0, group) - start, group)

                for a in range(ahead):
                    load_group(j0 + a)
                for j in range(j0, -(-length // q) + steps - 1):
                    # group j has landed; the group kWalkAhead steps
                    # further goes into the input rows step j - 1 read
                    # and step j does not
                    load_group(j + ahead)
                    for level in range(1, steps + 1):
                        group = j - level + 1
                        lo, top = hi(level, group - 1), hi(level, group)
                        e2 = b2 + 2 * (steps - level) * r
                        col0 = lead_of(level - 1) + level * r
                        nch = -(-e2 // kv)
                        src, ring = ring_at[level - 1], ring_of[level - 1]
                        last = level == steps
                        for pr in range(lo, top):
                            acc = np.zeros((nch, kv), np.float32)
                            for d in range(2 * r + 1):
                                slot = (pr + d) % ring
                                held = tags[level - 1][slot]
                                assert held is not None and held[0] == pr + d
                                # written at an earlier step (input rows:
                                # landed with group j or before)
                                assert held[1] <= j if level == 1 \
                                    else held[1] < j
                                # the window row: 2r + kV values a chunk
                                # from the column r left of its first output
                                row = src + slot * pitch + col0 - r
                                for pos, c in enumerate(at_pos[d]):
                                    if c is not None:
                                        at = row + pos + np.arange(nch)[
                                            :, None] * kv + np.arange(kv)
                                        acc = acc + c * smem[at]
                            row_a = g1 + level * r + pr
                            for c in range(nch):
                                n_valid = min(kv, e2 - c * kv)
                                if last:
                                    n_valid = min(n_valid, o2 - g2 - c * kv) \
                                        if g1 + pr < o1 else 0
                                if n_valid <= 0:
                                    continue
                                col_a = g2 + level * r + c * kv
                                v = acc[c, :n_valid]
                                for a in auxs:
                                    v = v * a[row_a, col_a:col_a + n_valid]
                                if last:
                                    out[state + (g1 + pr,)][
                                        g2 + c * kv:g2 + c * kv + n_valid] = v
                                else:
                                    slot = pr % ring_of[level]
                                    at = ring_at[level] + slot * pitch \
                                        + lead_of(level) + level * r + c * kv
                                    smem[at:at + n_valid] = v
                            if not last:
                                tags[level][pr % ring_of[level]] = (pr, j)
    return torch.from_numpy(out)


# (suite name, cover, tile, output extent, steps): walks long enough to go
# round every ring, ragged grids, a deep sweep whose levels start several
# steps apart, and boxes (several runs a row)
MODEL_CASES = [("star2d_r2", "minimal", (8, 16), (70, 45), 3),
               ("box2d_r1", "parallel", (4, 8), (37, 21), 4),
               ("star2d_r1", "parallel", (8, 12), (45, 30), 6),
               ("star2d_r2", "minimal", (16, 8), (33, 17), 1)]


@pytest.mark.parametrize("case", MODEL_CASES, ids=lambda c: c[0] + str(c[4]))
@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "halo"])
@pytest.mark.parametrize("scenario,batch", [("constant", None),
                                            ("varying+masked", 3)])
def test_ring_schedule_equals_the_plain_version(case, wrap, scenario, batch):
    name, cover, block, grid, steps = case
    spec = ss.PAPER_SUITE()[name]
    if not wrap:
        # a haloed input takes whole tiles
        grid = tuple(-(-g // b) * b for g, b in zip(grid, block))
    if scenario != "constant":
        spec = spec.with_field(ss.random_coeff_field(grid, seed=5),
                               domain_mask=ss.random_domain_mask(grid,
                                                                 seed=6))
    plan = _plan(spec, block, steps, batch=batch, wrap=wrap, cover=cover)
    w = steps * spec.order
    lead = (batch,) if batch else ()
    g = torch.Generator().manual_seed(sum(grid) + steps)
    x = torch.randn(lead + grid, generator=g)
    if not wrap:
        x = halo.pad_halo(x, w, 2, "periodic")
    shape = sm.sweep_aux_shape(grid, plan)
    aux = () if spec.is_constant_dense else (
        0.5 + torch.rand(shape, generator=g),
        (torch.rand(shape, generator=g) < 0.8).to(torch.float32))
    want = sm.sweep_plain(x, plan, aux)
    tiles0 = -(-grid[0] // block[0])
    for walk in sorted({1, 3, tiles0}):
        got = _walk_model(x, plan, aux, walk)
        assert torch.equal(got, want), walk


def test_cpu_calls_count_no_walk_launch():
    plan = _plan(block=(8, 16))
    before = (sm.sweep_cuda_call.launches, sm.sweep_cuda_call.walk_launches)
    x = torch.randn(40, 48)
    y = sm.sweep_cuda_call(x, plan)
    assert y.shape == x.shape
    assert (sm.sweep_cuda_call.launches,
            sm.sweep_cuda_call.walk_launches) == before
