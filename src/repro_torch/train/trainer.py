"""Fault-tolerant training loop.

The reference's ``repro.train.trainer`` on the port: the train step, the
resumable data pipeline, the async checkpoint manager (the JAX package's
format: a checkpoint crosses between the packages), the heartbeat /
straggler monitor and the restart policy.  ``Trainer.run`` survives
injected step failures by rebuilding the state from the latest
checkpoint and replaying the deterministic data stream.  There is no jit
and no donation; the step updates the state in place, so after a failure
the state is always rebuilt from the checkpoint (or from the seed).

On a slot mesh (``mesh=``, a ``launch.mesh.DeviceMesh``) the step is
``train_step``'s data-parallel step with FSDP placement: a fresh state
and a restored one are placed on the current mesh by ``shardings`` (a
``launch.cells._state_shardings`` tree; by default the sharding rules'),
whatever mesh wrote the checkpoint, and the restart path rebuilds the
placed state the same way.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.checkpointer import (CheckpointManager,
                                                 restore_checkpoint)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.launch.cells import _state_shardings
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.optim.adamw import adamw
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, RestartPolicy
from repro_torch.train.train_step import (init_train_state,
                                          load_state_tree, make_train_step,
                                          state_tree)

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt"))
    log_every: int = 10
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    seed: int = 0
    straggler_threshold: float = 3.0
    max_failures: int = 3
    microbatches: int = 1


class Trainer:
    """``Trainer(cfg, data_cfg, tcfg, optimizer).run()`` trains on
    ``device`` (the card unless ``device="cpu"``), or on the slots of
    ``mesh`` (whose slots are the card unless it was made with
    ``devices="cpu"``); ``fault_injector(step)`` is called before each
    step and may raise."""

    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig,
                 tcfg: TrainerConfig, optimizer: adamw | None = None,
                 mesh: Optional[DeviceMesh] = None,
                 shardings: Optional[dict] = None,
                 fault_injector: Optional[Callable[[int], None]] = None, *,
                 device="cuda"):
        if shardings is not None and mesh is None:
            raise ValueError("shardings= places a state on a mesh: pass "
                             "mesh= too")
        if mesh is not None:
            for d in dict.fromkeys(str(d) for d in mesh.devices.flat):
                resolve_device(d)
            device = mesh.devices.flat[0]
        self.device = resolve_device(device)
        self.mesh = mesh
        self.shardings = shardings
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.optimizer = optimizer or adamw(lr=3e-4)
        self.pipeline = make_pipeline(data_cfg)
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir,
                                      keep=tcfg.keep_checkpoints,
                                      async_save=tcfg.async_checkpoint)
        self.monitor = HeartbeatMonitor(threshold=tcfg.straggler_threshold)
        self.restart = RestartPolicy(max_failures=tcfg.max_failures)
        self.fault_injector = fault_injector
        self.metrics_log: list[dict] = []
        self._step = make_train_step(cfg, self.optimizer,
                                     microbatches=tcfg.microbatches,
                                     mesh=mesh)

    # -- state ---------------------------------------------------------------
    def _fresh_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        return init_train_state(gen, self.cfg, self.optimizer,
                                device=self.device, mesh=self.mesh,
                                shardings=self.shardings)

    def _restore_or_init(self):
        latest = self.ckpt.latest()
        state = self._fresh_state()
        if latest is None:
            return state
        target = state_tree(state, device="meta")
        shardings = None
        if self.mesh is not None:
            shardings = self.shardings or _state_shardings(self.mesh, target)
        restored, _ = restore_checkpoint(
            self.tcfg.checkpoint_dir, latest, target, shardings=shardings,
            device=self.device)
        return load_state_tree(state, restored)

    # -- loop ----------------------------------------------------------------
    def run(self):
        state = self._restore_or_init()
        while int(state.step) < self.tcfg.total_steps:
            step = int(state.step)
            try:
                self.monitor.start_step(step)
                if self.fault_injector is not None:
                    self.fault_injector(step)
                batch = self.pipeline.batch_at(step)
                state, metrics = self._step(state, batch)
                loss = float(metrics["loss"])     # waits for the device
                dt = self.monitor.end_step()
                self.restart.on_success()
                if step % self.tcfg.log_every == 0 or \
                        step == self.tcfg.total_steps - 1:
                    self.metrics_log.append(
                        {"step": step, "loss": loss,
                         "grad_norm": float(metrics["grad_norm"]),
                         "sec_per_step": dt})
                if (step + 1) % self.tcfg.checkpoint_every == 0:
                    self.ckpt.save(step + 1, state_tree(state),
                                   extra={"data_step": step + 1})
            except Exception as err:  # noqa: BLE001 — restart path
                time.sleep(self.restart.on_failure(err))
                state = None          # updated in place: not to be trusted
            if state is None:
                state = self._restore_or_init()
        self.ckpt.wait()
        self.ckpt.save(int(state.step), state_tree(state),
                       extra={"data_step": int(state.step)})
        self.ckpt.wait()
        return state
