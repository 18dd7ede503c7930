"""The plain reference against a direct loop and against the port on the
CPU, and the benchmark's imports."""
import ast
import itertools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import gather

HERE = Path(__file__).resolve().parents[1]
CONFIGS = ("star2d_r2", "star3d_r2")
SMALL = {"star2d_r2": (11, 14), "star3d_r2": (7, 6, 9)}


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def direct(x: np.ndarray, taps, steps: int) -> np.ndarray:
    """Every output point as its own sum over the taps, wrapping each
    index: the definition, point by point."""
    for _ in range(steps):
        y = np.zeros_like(x)
        for p in itertools.product(*(range(n) for n in x.shape)):
            y[p] = sum(c * x[tuple((i + o) % n for i, o, n
                                   in zip(p, offset, x.shape))]
                       for *offset, c in taps)
        x = y
    return x


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_is_the_direct_loop(name):
    taps = config(name)["taps"]
    x = np.random.default_rng(3).standard_normal(SMALL[name])
    got = gather.evolve(torch.from_numpy(x), taps, 3).numpy()
    np.testing.assert_allclose(got, direct(x, taps, 3), rtol=0, atol=1e-13)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_takes_leading_batch_axes(name):
    taps = config(name)["taps"]
    x = torch.randn((3,) + SMALL[name], dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    got = gather.evolve(x, taps, 2)
    for b in range(3):
        assert torch.equal(got[b], gather.evolve(x[b], taps, 2))


@pytest.mark.parametrize("name", CONFIGS)
def test_port_on_the_cpu_agrees_with_the_reference(name):
    """The configuration's problem through the port's plan and compile
    (the kernels' plain versions on the CPU) against the reference."""
    from repro_torch import api
    from portbench.drivers.common import port_spec
    from portbench.yardstick import max_rel_err
    cfg = config(name)
    grid = (48, 40) if cfg["ndim"] == 2 else (20, 16, 24)
    problem = api.StencilProblem(port_spec(cfg), grid, dtype=cfg["dtype"],
                                 boundary=cfg["boundary"],
                                 steps=cfg["steps_per_call"])
    run = api.compile(api.plan(problem, backends=cfg["backends"]),
                      device="cpu")
    x = torch.randn(grid, generator=torch.Generator().manual_seed(5))
    want = gather.evolve(x, cfg["taps"], cfg["steps_per_call"])
    assert max_rel_err(run(x), want) < 2e-6


@pytest.mark.parametrize("name", CONFIGS)
def test_config_taps_are_paper_suite(name):
    """The configuration's numbers are PAPER_SUITE's, copied whole."""
    from repro_torch.core.stencil_spec import PAPER_SUITE
    from portbench.drivers.common import port_spec
    np.testing.assert_array_equal(port_spec(config(name)).gather_coeffs,
                                  PAPER_SUITE()[name].gather_coeffs)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12, 1e-30])
    r = gather.tf32_round(x)
    assert r.tolist()[:4] == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9]
    assert r[4].item() == -3.0
    bits = r.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())


def test_tf32_evolve_departs_from_float64():
    taps = config("star2d_r2")["taps"]
    x = torch.randn((32, 32), generator=torch.Generator().manual_seed(2))
    ref = gather.evolve(x, taps, 4)
    rel = ((gather.evolve_tf32(x, taps, 4).double() - ref).abs().max()
           / ref.abs().max()).item()
    f32 = ((gather.evolve(x, taps, 4, torch.float32).double() - ref).abs()
           .max() / ref.abs().max()).item()
    assert rel > 30 * f32


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and isinstance(
                    node.args[0], ast.Constant):
            tops.add(node.args[0].value.split(".")[0])
    return tops


def test_nothing_imports_jax_or_the_jax_package():
    """By top-level name, compared whole: ``repro_torch`` is not
    ``repro``."""
    forbidden = {"jax", "jaxlib", "flax", "repro"}
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    found = {str(p.relative_to(HERE)): _imports(p) & forbidden
             for p in files}
    assert not {k: v for k, v in found.items() if v}
    assert "repro_torch" in set().union(*(_imports(p) for p in files))
