"""Train-step factory: forward (hidden) -> chunked CE -> grads -> AdamW.

The reference's ``repro.train.train_step`` on the port's trainable model
(``transformer.init_params(..., trainable=True)``: f32 parameters, compute
in ``cfg.compute_dtype``).  There is no jit: the step runs eagerly, its
gradients accumulate in each parameter's ``.grad``, and the optimizer
updates the parameters and moments in place (``optim.adamw``), so the
state a step is given is the state it returns, advanced.

:func:`state_tree` is the reference's ``TrainState`` tree (``params/...``
and ``opt/mu|nu/...`` stacked by cycle, ``opt/step``, ``step``), so a
checkpoint of either package restores in the other.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWState, adamw
from repro_torch.train.loss import chunked_cross_entropy

__all__ = ["TrainState", "init_train_state", "make_loss_fn",
           "make_train_step", "state_tree", "load_state_tree"]


class TrainState(NamedTuple):
    params: tf.Transformer   # the trainable build
    opt: AdamWState          # moments keyed as ``params.named_parameters()``
    step: torch.Tensor       # int32 scalar


def _named(model: tf.Transformer) -> dict:
    return dict(model.named_parameters())


def _decayed(model: tf.Transformer) -> dict:
    """The leaves AdamW decays.  The reference's rule is ``ndim >= 2`` on
    its tree, where every layer leaf carries a leading cycle axis, so
    there every layer leaf is decayed, vectors (norm scales, ``d_skip``,
    ``dt_bias``) included; the port's per-layer leaves count that axis."""
    return {n: p.ndim + n.startswith("layers.") >= 2
            for n, p in model.named_parameters()}


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     optimizer: adamw, *, device) -> TrainState:
    """A fresh state: the trainable model drawn from ``generator`` (a
    generator of ``device``), zero moments, step 0."""
    model = tf.init_params(cfg, generator, device, trainable=True)
    return TrainState(params=model, opt=optimizer.init(_named(model)),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.embed.device))


def state_tree(state: TrainState, device=None) -> dict:
    """The reference's ``TrainState`` tree of ``state``: parameters and
    moments stacked by cycle (new tensors), the step counters.  With
    ``device="meta"`` only shapes and dtypes, a restore target that holds
    no memory."""
    cfg = state.params.cfg

    def stacked(named):
        return tf.stack_by_cycle(cfg, {
            n: t.detach() if device is None else t.detach().to(device)
            for n, t in named.items()})

    def scalar(t):
        return t if device is None else t.to(device)
    return {"params": stacked(_named(state.params)),
            "opt": {"step": scalar(state.opt.step),
                    "mu": stacked(state.opt.mu), "nu": stacked(state.opt.nu)},
            "step": scalar(state.step)}


def load_state_tree(state: TrainState, tree: dict) -> TrainState:
    """Copy a :func:`state_tree`-shaped tree (a restored checkpoint) into
    ``state``'s tensors in place; returns the state with its counters."""
    cfg = state.params.cfg
    tf.assign_from_tree(cfg, _named(state.params), tree["params"])
    tf.assign_from_tree(cfg, state.opt.mu, tree["opt"]["mu"])
    tf.assign_from_tree(cfg, state.opt.nu, tree["opt"]["nu"])
    device = state.step.device
    return TrainState(
        params=state.params,
        opt=AdamWState(step=torch.as_tensor(tree["opt"]["step"]).to(
            device=device, dtype=torch.int32),
            mu=state.opt.mu, nu=state.opt.nu),
        step=torch.as_tensor(tree["step"]).to(device=device,
                                              dtype=torch.int32))


def make_loss_fn(cfg: ModelConfig, ce_chunk: int = 512):
    """(model, batch) -> (loss, aux). batch: {tokens, labels[, mask,
    patch_embeds, cond]}, on the model's device.  Codebook models average
    the CE of their K heads; image positions carry no loss; MoE's aux
    loss is added."""

    def loss_fn(model: tf.Transformer, batch: dict):
        hidden, _, aux = model(batch["tokens"], mode="train", head=False,
                               patch_embeds=batch.get("patch_embeds"),
                               cond=batch.get("cond"))
        head_w = model.embed if cfg.tie_embeddings else model.lm_head
        labels, mask = batch["labels"], batch.get("mask")
        if cfg.num_codebooks:          # one CE per codebook head (K, D, V)
            ce = sum(chunked_cross_entropy(hidden, head_w[i], labels[:, i],
                                           mask=mask, chunk=ce_chunk)[0]
                     for i in range(cfg.num_codebooks)) / cfg.num_codebooks
        else:
            if cfg.num_image_tokens:
                # image positions are inputs only: no next-token loss there
                hidden = hidden[:, cfg.num_image_tokens:]
            ce, _ = chunked_cross_entropy(hidden, head_w, labels, mask=mask,
                                          chunk=ce_chunk,
                                          transpose_head=cfg.tie_embeddings)
        return ce + aux, aux

    return loss_fn


def make_train_step(cfg: ModelConfig, optimizer: adamw, ce_chunk: int = 512,
                    microbatches: int = 1):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` holds
    numpy or tensor arrays, moved to the model's device here.
    ``microbatches > 1`` splits the batch on its leading axis, sums the
    f32 grads over the splits and scales them by 1/m — the reference's
    arithmetic at 1/m the activation memory."""
    loss_fn = make_loss_fn(cfg, ce_chunk)

    def train_step(state: TrainState, batch: dict):
        model = state.params
        device = model.embed.device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        params = _named(model)
        for p in params.values():
            p.grad = None
        parts = [batch]
        if microbatches > 1:
            parts = [{k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + v.shape[1:])[i]
                      for k, v in batch.items()}
                     for i in range(microbatches)]
        loss = torch.zeros((), dtype=torch.float32, device=device)
        aux = torch.zeros((), dtype=torch.float32, device=device)
        for one in parts:
            l, a = loss_fn(model, one)
            l.backward()
            loss, aux = loss + l.detach(), aux + a.detach()
        grads = {n: p.grad for n, p in params.items()}
        if microbatches > 1:
            inv = 1.0 / microbatches
            for g in grads.values():
                g.mul_(inv)
            loss, aux = loss * inv, aux * inv
        with record_function("adamw"):
            _, opt, metrics = optimizer.update(grads, state.opt, params,
                                               _decayed(model))
        for p in params.values():
            p.grad = None
        metrics = dict(metrics, loss=loss, aux_loss=aux)
        return TrainState(params=model, opt=opt, step=state.step + 1), metrics

    return train_step
