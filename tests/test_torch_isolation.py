"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points do not silently fall back to the CPU."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import api
from repro_torch.core import stencil_spec as ss

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))

torch.set_num_threads(2)


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert "repro_torch.kernels.stencil_mxu" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port pulled in: {out.stdout}"


_JAX_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
_REPRO_IMPORT = re.compile(
    r"^\s*(?:import\s+repro(?!_torch)\b|from\s+repro(?!_torch)\b)", re.M)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"] + EXAMPLES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_no_reference(path):
    text = path.read_text()
    assert not _JAX_IMPORT.search(text), path
    assert not _REPRO_IMPORT.search(text), path


def test_importing_every_port_example_loads_no_jax():
    assert len(EXAMPLES) == 5
    code = (
        "import importlib.util, sys\n"
        f"for i, p in enumerate({[str(p) for p in EXAMPLES]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"an example pulled in: {out.stdout}"


def test_compile_without_device_needs_a_card():
    p = api.plan(api.StencilProblem(ss.star(2, 1), grid=(16, 16), steps=2))
    if torch.cuda.is_available():
        assert api.compile(p).engine.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        api.compile(p)
    assert api.compile(p, device="cpu").engine.device.type == "cpu"


_NEW_SLICE = ["repro_torch.runtime.chaos", "repro_torch.runtime.fault_tolerance",
              "repro_torch.checkpoint.checkpointer",
              "repro_torch.rollout.program", "repro_torch.rollout.planning",
              "repro_torch.rollout.executor", "repro_torch.core.plan_cache",
              "repro_torch.launch.serve_stencil"]
_MSGPACK_IMPORT = re.compile(r"^\s*(import\s+msgpack\b|from\s+msgpack\b)",
                             re.M)


def test_serving_slice_modules_load_no_jax_no_reference_no_msgpack():
    mods = _port_modules()
    assert set(_NEW_SLICE) <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro', 'msgpack'))\n"
        "print(','.join(bad))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port pulled in: {out.stdout}"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_msgpack(path):
    assert not _MSGPACK_IMPORT.search(path.read_text()), path


@pytest.mark.parametrize("entry", ["PlanCache", "StencilServer",
                                   "compile_program"])
def test_serving_entry_points_need_a_card_by_default(entry):
    spec = ss.box(2, 1, seed=0)
    make = {
        "PlanCache": lambda **kw: api.PlanCache(**kw),
        "StencilServer": lambda **kw: api.StencilServer(
            spec, 2, **({"devices": [kw["device"]]} if kw else {})),
        "compile_program": lambda **kw: api.compile_program(
            api.RolloutProgram(api.StencilProblem(spec, (16, 16), steps=1),
                               [2]), backends=["cuda"], **kw),
    }[entry]
    if torch.cuda.is_available():
        make()
        return
    with pytest.raises(RuntimeError, match="cuda"):
        make()
    make(device="cpu")
