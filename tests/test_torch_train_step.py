"""The port's train step (``train/train_step.py``) on the CPU against the
JAX package's ``repro.train.train_step``, on Hymba SMOKE (four layers, so
the pattern of period 2 runs two cycles) with the JAX weights carried
across (``params_from_numpy(..., trainable=True)``) and the reference's
synthetic batches.

Bars: loss and grad norm per step within a relative 1e-4; parameters (via
``params_to_numpy``) within 0.05 x lr x steps, since Adam moves an entry
whose gradient is near zero by up to lr a step; microbatching and remat
change the loss and the gradients the optimizer is given by nothing
beyond 1e-5.  A port train-state checkpoint restores in the
JAX package's ``restore_checkpoint`` against its ``TrainState`` tree (and
the reverse), leaves equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import checkpointer as ref_ckpt
from repro.configs import base as ref_base
from repro.data import pipeline as ref_pipe
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro.train import train_step as ref_ts

from repro_torch.checkpoint import checkpointer
from repro_torch.configs import base
from repro_torch.data import pipeline
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

ARCH = "hymba_1_5b"
LR, STEPS, SEQ, BATCH, CE_CHUNK = 1e-2, 3, 24, 4, 16
REL = 1e-4


def _port_cfg(ref_cfg):
    d = dataclasses.asdict(ref_cfg)
    d["ssm"] = base.SSMConfig(**d["ssm"])
    d["moe"] = None
    d["kernel_impl"] = {"pallas": "cuda"}.get(d["kernel_impl"],
                                              d["kernel_impl"])
    return base.ModelConfig(**d)


def _opts():
    return (ref_adamw.adamw(lr=ref_adamw.cosine_schedule(LR, 1, STEPS)),
            adamw.adamw(lr=adamw.cosine_schedule(LR, 1, STEPS)))


def _batches():
    kw = dict(vocab_size=256, seq_len=SEQ, global_batch=BATCH, seed=3)
    ref = ref_pipe.SyntheticLM(ref_pipe.DataConfig(**kw))
    port = pipeline.SyntheticLM(pipeline.DataConfig(**kw))
    return ([ref.batch_at(i) for i in range(STEPS)],
            [port.batch_at(i) for i in range(STEPS)])


def _port_state(cfg, p_np, opt):
    model = tf.params_from_numpy(p_np, cfg, "cpu", trainable=True)
    return ts.TrainState(params=model,
                         opt=opt.init(dict(model.named_parameters())),
                         step=torch.zeros((), dtype=torch.int32))


@pytest.fixture(scope="module")
def run():
    """The reference's three jitted train steps and the port's, from the
    same weights on the same batches."""
    ref_cfg = dataclasses.replace(ref_base.get_smoke_config(ARCH),
                                  num_layers=4)
    cfg = _port_cfg(ref_cfg)
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    p_np = jax.tree.map(np.asarray, params)
    ref_opt, opt = _opts()
    ref_b, port_b = _batches()
    r_state = ref_ts.TrainState(params=params, opt=ref_opt.init(params),
                                step=jnp.zeros((), jnp.int32))
    r_step = jax.jit(ref_ts.make_train_step(ref_cfg, ref_opt,
                                            ce_chunk=CE_CHUNK))
    r_metrics = []
    for b in ref_b:
        r_state, m = r_step(r_state, b)
        r_metrics.append({k: float(v) for k, v in m.items()})
    state = _port_state(cfg, p_np, opt)
    step = ts.make_train_step(cfg, opt, ce_chunk=CE_CHUNK)
    metrics = []
    for b in port_b:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(ref_cfg=ref_cfg, cfg=cfg, p_np=p_np, r_state=r_state,
                r_metrics=r_metrics, state=state, metrics=metrics,
                port_b=port_b)


def test_three_steps_match_the_reference(run):
    for got, want in zip(run["metrics"], run["r_metrics"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=REL)
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    assert int(run["state"].step) == STEPS
    assert int(run["state"].opt.step) == STEPS
    got = tf.params_to_numpy(run["state"].params)
    want = jax.tree.map(np.asarray, run["r_state"].params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=0.05 * LR * STEPS)


def test_grads_are_cleared_after_the_step(run):
    assert all(p.grad is None for p in run["state"].params.parameters())


def test_params_round_trip_through_numpy(run):
    model = tf.params_from_numpy(run["p_np"], run["cfg"], "cpu",
                                 trainable=True)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
    back = tf.params_to_numpy(model)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(run["p_np"])):
        np.testing.assert_array_equal(g, w)


class _Recording(adamw.adamw):
    """AdamW that keeps a copy of the gradients it is given."""

    def update(self, grads, state, params, decay=None):
        object.__setattr__(self, "grads",
                           {k: g.clone() for k, g in grads.items()})
        return super().update(grads, state, params, decay)


def _one_step(cfg, p_np, batch, **kw):
    opt = _Recording(lr=LR)
    state = _port_state(cfg, p_np, opt)
    _, m = ts.make_train_step(cfg, opt, ce_chunk=CE_CHUNK, **kw)(state,
                                                                 batch)
    return opt.grads, m


def _same_step(a, b):
    (g1, m1), (g2, m2) = a, b
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), atol=1e-5)
    assert sorted(g1) == sorted(g2)
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], rtol=0, atol=1e-5)


def test_microbatches_equal_one_batch(run):
    cfg, p_np, batch = run["cfg"], run["p_np"], run["port_b"][0]
    _same_step(_one_step(cfg, p_np, batch),
               _one_step(cfg, p_np, batch, microbatches=2))


def test_remat_full_equals_none(run):
    p_np, batch = run["p_np"], run["port_b"][1]
    _same_step(_one_step(dataclasses.replace(run["cfg"], remat="none"),
                         p_np, batch),
               _one_step(dataclasses.replace(run["cfg"], remat="full"),
                         p_np, batch))


def test_port_checkpoint_restores_in_the_reference(run, tmp_path):
    state = run["state"]
    checkpointer.save_checkpoint(str(tmp_path), STEPS, ts.state_tree(state),
                                 extra={"data_step": STEPS})
    target = run["r_state"]
    restored, extra = ref_ckpt.restore_checkpoint(str(tmp_path), STEPS,
                                                  target)
    assert extra == {"data_step": STEPS}
    assert int(restored.step) == STEPS and int(restored.opt.step) == STEPS
    want = {"params": tf.params_to_numpy(state.params),
            "mu": tf.stack_by_cycle(run["cfg"], state.opt.mu),
            "nu": tf.stack_by_cycle(run["cfg"], state.opt.nu)}
    got = {"params": restored.params, "mu": restored.opt.mu,
           "nu": restored.opt.nu}
    for k in want:
        w_leaves = jax.tree.leaves(jax.tree.map(np.asarray, want[k]))
        g_leaves = jax.tree.leaves(got[k])
        assert len(w_leaves) == len(g_leaves)
        for g, w in zip(g_leaves, w_leaves):
            np.testing.assert_array_equal(np.asarray(g), w)


def test_reference_checkpoint_restores_in_the_port(run, tmp_path):
    ref_ckpt.save_checkpoint(str(tmp_path), STEPS, run["r_state"])
    _, opt = _opts()
    fresh = _port_state(run["cfg"], run["p_np"], opt)
    restored, _ = checkpointer.restore_checkpoint(
        str(tmp_path), STEPS, ts.state_tree(fresh, device="meta"),
        device="cpu")
    state = ts.load_state_tree(fresh, restored)
    assert int(state.step) == STEPS and int(state.opt.step) == STEPS
    got = tf.params_to_numpy(state.params)
    want = jax.tree.map(np.asarray, run["r_state"].params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    mu = jax.tree.map(np.asarray, run["r_state"].opt.mu)
    for g, w in zip(jax.tree.leaves(tf.stack_by_cycle(run["cfg"],
                                                      state.opt.mu)),
                    jax.tree.leaves(mu)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_load_rejects_a_tree_of_another_shape(run):
    _, opt = _opts()
    state = _port_state(run["cfg"], run["p_np"], opt)
    tree = ts.state_tree(state)
    tree["params"]["final_norm"] = torch.zeros(3)
    with pytest.raises(ValueError, match="final_norm"):
        ts.load_state_tree(state, tree)
