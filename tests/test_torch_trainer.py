"""The port's fault-tolerant trainer (``train/trainer.py``) and training
launcher on the CPU, on Hymba SMOKE: the JAX package's
``tests/test_system.py`` (the loss falls; a resumed run equals the
uninterrupted one) and ``tests/test_substrate.py``'s trainer cases
(injected failures survived, the restart budget exhausted with a raise),
the launcher's two-step smoke run, and both on a mesh of CPU slots.

Bars: the mean loss of the last five of 40 steps at least 0.5 below the
first five's (the reference's bar); resume bit-identical (the reference
holds it to 1e-6; on one CPU thread order the port's run repeats exactly).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.adamw import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

ARCH = "hymba_1_5b"


def _trainer(tmp, total, every=100, inject=None, **kw):
    cfg = get_smoke_config(ARCH)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=kw.pop("seq", 16),
                      global_batch=kw.pop("batch", 4), seed=kw.pop("seed", 3))
    return Trainer(cfg, dcfg,
                   TrainerConfig(total_steps=total, checkpoint_every=every,
                                 checkpoint_dir=str(tmp), log_every=1,
                                 async_checkpoint=False, **kw),
                   fault_injector=inject, device="cpu",
                   optimizer=adamw(lr=1e-3))


def test_training_reduces_loss(tmp_path):
    tr = _trainer(tmp_path, 40, seq=32, batch=8, seed=11)
    tr.run()
    losses = [m["loss"] for m in tr.metrics_log]
    assert len(losses) == 40 and all(np.isfinite(losses))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.5, (first, last)


def test_resume_bitwise_equals_uninterrupted(tmp_path):
    final1 = _trainer(tmp_path / "run1", 8, every=4).run()
    # interrupted run: stop at 4 (total_steps=4), then resume to 8
    _trainer(tmp_path / "run2", 4, every=4).run()
    tr2b = _trainer(tmp_path / "run2", 8, every=4)
    final2 = tr2b.run()
    assert [m["step"] for m in tr2b.metrics_log] == [4, 5, 6, 7]
    assert int(final1.step) == int(final2.step) == 8
    assert int(final2.opt.step) == 8
    for a, b in zip(final1.params.parameters(), final2.params.parameters()):
        assert torch.equal(a, b)
    for k in final1.opt.mu:
        assert torch.equal(final1.opt.mu[k], final2.opt.mu[k])
        assert torch.equal(final1.opt.nu[k], final2.opt.nu[k])


def test_trainer_recovers_from_injected_failures(tmp_path):
    fails = {3, 7}

    def inject(step):
        if step in fails:
            fails.discard(step)
            raise RuntimeError(f"injected@{step}")

    tr = _trainer(tmp_path, 10, every=4, inject=inject)
    state = tr.run()
    assert int(state.step) == 10
    assert not fails           # both failures were hit and survived
    assert tr.ckpt.latest() == 10
    # steps 0-2 ran, step 3 failed, restart from the init (no checkpoint
    # yet) re-ran 0-2; step 7 failed after the step-4 checkpoint
    assert [m["step"] for m in tr.metrics_log] == [0, 1, 2, 0, 1, 2, 3, 4, 5,
                                                   6, 4, 5, 6, 7, 8, 9]


def test_trainer_restart_budget_exhausted(tmp_path):
    def always_fail(step):
        raise RuntimeError("hard failure")

    tr = _trainer(tmp_path, 5, inject=always_fail, max_failures=2,
                  seq=8, batch=2)
    with pytest.raises(RuntimeError, match="budget exhausted"):
        tr.run()


def test_trainer_needs_a_card_by_default(tmp_path):
    cfg = get_smoke_config(ARCH)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    # on a mesh of CPU slots: two steps, then a resumed run goes on from
    # the mesh-written checkpoint
    mesh = make_mesh((2, 1), ("data", "model"), devices="cpu")
    tcfg = TrainerConfig(total_steps=2, checkpoint_every=2, log_every=1,
                         checkpoint_dir=str(tmp_path / "mesh"),
                         async_checkpoint=False)
    tr = Trainer(cfg, dcfg, tcfg, mesh=mesh, device="cpu")
    state = tr.run()
    assert int(state.step) == 2 and [m["step"] for m in tr.metrics_log] \
        == [0, 1]
    assert np.isfinite([m["loss"] for m in tr.metrics_log]).all()
    tr2 = Trainer(cfg, dcfg, dataclasses.replace(tcfg, total_steps=3),
                  mesh=mesh)
    assert int(tr2.run().step) == 3
    assert [m["step"] for m in tr2.metrics_log] == [2]
    tcfg = TrainerConfig(total_steps=1, checkpoint_dir=str(tmp_path))
    if torch.cuda.is_available():
        Trainer(cfg, dcfg, tcfg)
        Trainer(cfg, dcfg, tcfg, mesh=make_mesh((2, 1), ("data", "model")))
        return
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, dcfg, tcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, dcfg, tcfg, mesh=make_mesh((2, 1), ("data", "model")))


def test_launcher_smoke_runs_two_steps(tmp_path, capsys):
    tr = launch_train.main(["--arch", ARCH, "--smoke", "--steps", "2",
                            "--batch", "2", "--seq", "16", "--device", "cpu",
                            "--ckpt-dir", str(tmp_path), "--ckpt-every",
                            "1"])
    out = capsys.readouterr().out
    assert "arch=hymba-smoke" in out and "step=1 loss=" in out
    assert [m["step"] for m in tr.metrics_log] == [0, 1]
    assert tr.ckpt.steps() == [1, 2]


def test_launcher_mesh_names_the_distributed_item(tmp_path, capsys):
    tr = launch_train.main(["--arch", ARCH, "--smoke", "--mesh", "2x1",
                            "--steps", "2", "--batch", "2", "--seq", "16",
                            "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "mesh=2x1 ('data', 'model')" in out and "step=1 loss=" in out
    assert tr.mesh.shape == (2, 1)
    assert [m["step"] for m in tr.metrics_log] == [0, 1]
    assert tr.ckpt.steps() == [2]
