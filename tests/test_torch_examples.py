"""The port's examples (``examples/torch_*.py``) run on the CPU with
``--device cpu`` at their own sizes (the training example shortened), each
with the checks its script makes, and the numbers that do not depend on
a seed held against the JAX package's example run on the same inputs:
quickstart's conserved mass and fuse schedule, the halo exchange's
permute census and schedule, the rollout's emit steps and buckets.  The
two LM examples run on the JAX example's own weights, carried across
(``transformer.params_from_numpy`` in place of the port's draw): the
served tokens and last logits, and the trained losses and gradient
norms, against the JAX example's.
"""
import importlib.util
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as jax_tf
from repro_torch.models import transformer as tf

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

torch.set_num_threads(2)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_reference_example_has_a_port():
    ref = {p.stem for p in EXAMPLES.glob("*.py")
           if not p.stem.startswith("torch_")}
    port = {p.stem.removeprefix("torch_")
            for p in EXAMPLES.glob("torch_*.py")}
    assert ref == port == {"quickstart", "pde_halo_exchange",
                           "assimilation_rollout", "serve_lm", "train_lm"}


def _reference_output(name: str, capsys) -> str:
    capsys.readouterr()
    _load(name).main()
    return capsys.readouterr().out


def test_quickstart(capsys):
    out = _load("torch_quickstart").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert out["oracle_err"] <= 1e-4
    assert out["mass"] == pytest.approx(out["mass0"], rel=1e-5)
    ref = _reference_output("quickstart", capsys)
    line = r"fuse schedule (\S+)\): total mass ([\d.]+) \(conserved from " \
           r"([\d.]+)\), peak ([\d.]+)"
    want, got = re.search(line, ref), re.search(line, text)
    assert got.groups() == want.groups()
    assert "generated kernel (head):\ndef stencil_update(x):" in text


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_pde_halo_exchange(mesh, capsys):
    """The script's own 2x2 mesh, and the 4x1 mesh the reference's script
    picks on four devices, where the two runs are compared."""
    out = _load("torch_pde_halo_exchange").main(["--device", "cpu",
                                                 "--mesh", mesh])
    assert out["err"] < 1e-4
    assert out["census"]["permutes"] == out["chunks"] * 2 * 2
    assert out["census"]["exchanges"] == out["chunks"] * 2
    if mesh == "2x2":
        return
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.run([sys.executable,
                          str(EXAMPLES / "pde_halo_exchange.py")],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert "mesh=(4,1)" in ref.stdout
    n_pp = int(re.search(r"ppermutes in jaxpr: (\d+)", ref.stdout).group(1))
    assert out["census"]["permutes"] == n_pp
    sched = re.search(r"schedule (\([\d, ]+\))", ref.stdout).group(1)
    assert str(tuple(out["plans"][0].fuse_schedule)) == sched
    mass = float(re.search(r"mass=\s*([\d.]+)", ref.stdout).group(1))
    assert out["mass"] == pytest.approx(mass, abs=5e-3)


def test_assimilation_rollout(capsys):
    out = _load("torch_assimilation_rollout").main(["--device", "cpu"])
    out["server"].stop()
    assert out["bit_exact"]
    text = capsys.readouterr().out
    ref = _reference_output("assimilation_rollout", capsys)
    assert out["emit_steps"] == [8, 20, 32]
    assert f"emitted frames at steps {out['emit_steps']}" in ref
    assert out["final_steps"] == [32, 32, 32]
    buckets = r"server batched (\d+) segment buckets for (\d+) rollouts"
    assert re.search(buckets, text).groups() == \
        re.search(buckets, ref).groups()
    assert re.search(r"digest (\w+)", text).group(1) == \
        re.search(r"digest (\w+)", ref).group(1)


def _carry(monkeypatch, jcfg) -> None:
    """The port's ``transformer.init_params`` gives the JAX example's
    weights (``init_params(PRNGKey(0), jcfg)``) from here on."""
    tree = jax.tree.map(np.asarray, jax_tf.init_params(
        jax.random.PRNGKey(0), jcfg))
    monkeypatch.setattr(tf, "init_params", lambda cfg, gen, device, **kw:
                        tf.params_from_numpy(tree, cfg, device, **kw))


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "hymba_1_5b"])
def test_serve_lm(arch, capsys, monkeypatch):
    """The JAX example's weights and prompts: the same 32 greedy tokens,
    and its last logits (read where the JAX example waits for them)
    within 1e-5 of max|logits|."""
    _carry(monkeypatch, jax_smoke_config(arch))
    out = _load("torch_serve_lm").main(["--device", "cpu", "--arch", arch])
    assert out["finite"] and out["ids"].shape == (4, 32)
    text = capsys.readouterr().out
    waited = []
    wait = jax.block_until_ready
    monkeypatch.setattr(jax, "block_until_ready",
                        lambda x: waited.append(np.asarray(x)) or wait(x))
    monkeypatch.setattr(sys, "argv", ["serve_lm.py", "--arch", arch])
    ref = _reference_output("serve_lm", capsys)
    ids = r"first sequence token ids: (\[[\d, ]+\])"
    assert re.search(ids, text).group(1) == re.search(ids, ref).group(1)
    want = waited[-1]
    err = float(np.abs(out["last"].float().numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err


def test_train_lm(tmp_path, monkeypatch):
    """Four steps of the demo model on the JAX example's weights and
    data: every logged loss and gradient norm within 1e-4 relative of the
    JAX example's (f32 compute)."""
    ref = _load("train_lm")
    mod = _load("torch_train_lm")
    assert mod.CFG_100M.param_count() == ref.CFG_100M.param_count()
    _carry(monkeypatch, ref.CFG_100M)
    out = mod.main(["--device", "cpu", "--steps", "4", "--seq", "64",
                    "--batch", "2", "--ckpt-dir", str(tmp_path / "port")])
    assert out["step"] == 4
    assert all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in out["log"])
    assert [m["step"] for m in out["log"]] == [0, 3]
    assert out["trainer"].ckpt.latest() == 4
    made = []

    class Kept(ref.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    monkeypatch.setattr(ref, "Trainer", Kept)
    monkeypatch.setattr(sys, "argv", [
        "train_lm.py", "--steps", "4", "--seq", "64", "--batch", "2",
        "--ckpt-dir", str(tmp_path / "jax")])
    ref.main()
    want = made[0].metrics_log
    assert [m["step"] for m in want] == [0, 3]
    for a, b in zip(out["log"], want):
        for k in ("loss", "grad_norm"):
            assert a[k] == pytest.approx(float(b[k]), rel=1e-4), (k, a, b)


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_pde_halo_exchange",
                                  "torch_assimilation_rollout",
                                  "torch_serve_lm", "torch_train_lm"])
def test_examples_run_on_the_card_by_default(name, tmp_path):
    """No ``--device``: the card, or a RuntimeError naming it."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run there")
    with pytest.raises(RuntimeError, match="cuda"):
        _load(name).main(["--ckpt-dir", str(tmp_path)]
                         if name == "torch_train_lm" else [])
