"""Three train steps of the port against the JAX package's
``repro.train.train_step`` for the families whose loss differs from
Hymba's, on the CPU: Granite MoE (capacity drops and the aux loss),
MusicGen (one CE per codebook head, cross-attention to the conditioning)
and LLaVA-NeXT (no loss on the image positions).

SMOKE configs (Granite's capacity factor cut to 0.5 so train mode drops
assignments), the JAX weights carried across with
``params_from_numpy(..., trainable=True)``, and the port's synthetic
batches (with the stubbed conditioning and patch embeddings) fed to both
packages.  Bars as ``tests/test_torch_train_step.py``: loss, aux loss and
grad norm per step within a relative 1e-4; parameters within 0.05 x lr x
steps.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as ref_base
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro.train import train_step as ref_ts

from repro_torch.configs import base
from repro_torch.data import pipeline
from repro_torch.launch import train as train_launcher
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

LR, STEPS, SEQ, BATCH, CE_CHUNK = 1e-2, 3, 24, 4, 16
REL = 1e-4


def _configs(arch):
    ref_cfg = ref_base.get_smoke_config(arch)
    cfg = base.get_smoke_config(arch)
    if cfg.moe is not None:
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
            ref_cfg.moe, capacity_factor=0.5))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
    return ref_cfg, cfg


def _batches(cfg):
    data = pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=3,
        num_codebooks=cfg.num_codebooks,
        num_image_tokens=cfg.num_image_tokens, vision_dim=cfg.vision_dim,
        cond_len=cfg.cond_len if cfg.cross_attn else 0,
        cond_dim=cfg.cond_dim))
    return [data.batch_at(i) for i in range(STEPS)]


@pytest.fixture(scope="module", params=["granite_moe_3b_a800m",
                                        "musicgen_large", "llava_next_34b"])
def run(request):
    ref_cfg, cfg = _configs(request.param)
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    p_np = jax.tree.map(np.asarray, params)
    batches = _batches(cfg)
    ref_opt = ref_adamw.adamw(lr=ref_adamw.cosine_schedule(LR, 1, STEPS))
    opt = adamw.adamw(lr=adamw.cosine_schedule(LR, 1, STEPS))
    r_state = ref_ts.TrainState(params=params, opt=ref_opt.init(params),
                                step=jnp.zeros((), jnp.int32))
    r_step = jax.jit(ref_ts.make_train_step(ref_cfg, ref_opt,
                                            ce_chunk=CE_CHUNK))
    r_metrics = []
    for b in batches:
        r_state, m = r_step(r_state, {k: jnp.asarray(v) for k, v in b.items()})
        r_metrics.append({k: float(v) for k, v in m.items()})
    model = tf.params_from_numpy(p_np, cfg, "cpu", trainable=True)
    state = ts.TrainState(params=model,
                          opt=opt.init(dict(model.named_parameters())),
                          step=torch.zeros((), dtype=torch.int32))
    step = ts.make_train_step(cfg, opt, ce_chunk=CE_CHUNK)
    metrics, dropped = [], []
    moe.DISPATCH_OBSERVERS.append(lambda c, d: dropped.append(int(d)))
    try:
        for b in batches:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        moe.DISPATCH_OBSERVERS.clear()
    return dict(cfg=cfg, batches=batches, r_state=r_state,
                r_metrics=r_metrics, state=state, metrics=metrics,
                dropped=dropped)


def test_three_steps_match_the_reference(run):
    for got, want in zip(run["metrics"], run["r_metrics"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=REL)
        np.testing.assert_allclose(got["aux_loss"], want["aux_loss"],
                                   rtol=REL, atol=1e-7)
    got = tf.params_to_numpy(run["state"].params)
    want = jax.tree.map(np.asarray, run["r_state"].params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=0.05 * LR * STEPS)


def test_the_family_branch_ran(run):
    """Each run exercised what it is here for."""
    cfg, batch = run["cfg"], run["batches"][0]
    if cfg.moe is not None:
        assert sum(run["dropped"]) > 0          # capacity drops in train
        assert all(m["aux_loss"] > 0 for m in run["metrics"])
    if cfg.num_codebooks:
        assert batch["tokens"].shape == (BATCH, cfg.num_codebooks, SEQ)
    if cfg.cross_attn:
        assert batch["cond"].shape == (BATCH, cfg.cond_len, cfg.cond_dim)
    if cfg.num_image_tokens:
        assert batch["patch_embeds"].shape == (
            BATCH, cfg.num_image_tokens, cfg.vision_dim)


def test_stub_inputs_leave_the_token_stream_alone():
    kw = dict(vocab_size=64, seq_len=SEQ, global_batch=BATCH, seed=3)
    plain = pipeline.SyntheticLM(pipeline.DataConfig(**kw)).batch_at(2)
    stubbed = pipeline.SyntheticLM(pipeline.DataConfig(
        **kw, num_image_tokens=4, vision_dim=8, cond_len=3,
        cond_dim=5)).batch_at(2)
    for k in plain:
        np.testing.assert_array_equal(stubbed[k], plain[k])
    assert stubbed["patch_embeds"].shape == (BATCH, 4, 8)
    assert stubbed["cond"].shape == (BATCH, 3, 5)


@pytest.mark.parametrize("arch", ["llava_next_34b", "qwen3_moe_30b_a3b",
                                  "rwkv6_1_6b"])
def test_launcher_trains_each_family_on_the_cpu(arch, tmp_path, capsys):
    tr = train_launcher.main(["--arch", arch, "--smoke", "--steps", "2",
                              "--batch", "2", "--seq", "16", "--device",
                              "cpu", "--ckpt-dir", str(tmp_path)])
    assert len(tr.metrics_log) == 2
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_log)
    assert "step=1" in capsys.readouterr().out
