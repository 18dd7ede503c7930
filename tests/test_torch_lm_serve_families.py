"""Serving the nine architectures beyond Hymba in the port, on the CPU:
the reference's ``test_smoke_serve_consistency`` (a 20-token prefill
against 12 prefilled + 8 decoded tokens, at its ``atol=5e-5``), greedy
ids against the JAX package's, the serving build's leaf dtypes, and the
serve launcher on each family.

For a VLM the prompt is 20 text tokens after its image tokens, so its
decode steps run (the reference's test draws 20 positions in all, which
leaves it 12 text tokens and no decode step).  The reference's
``greedy_generate`` feeds a codebook model ``(B, 1, K)`` tokens, which
its decode reads through JAX's index clamping; MusicGen's greedy ids are
held against the reference's prefill and decode steps fed ``(B, K, 1)``
argmax tokens, as the reference's serve launcher feeds them.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as ref_base
from repro.models import transformer as ref_tf
from repro.train import serve_step as ref_serve

from repro_torch.configs import base
from repro_torch.launch import input_specs, serve
from repro_torch.models import transformer as tf
from repro_torch.train import serve_step

torch.set_num_threads(2)

ARCHS = [a for a in ref_base.ARCH_IDS if a != "hymba_1_5b"]


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_serve_consistency(arch):
    cfg = base.get_smoke_config(arch)
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = input_specs.sample_from_specs(
        input_specs.train_batch_specs(cfg, 2, 20 + cfg.num_image_tokens),
        cfg, seed=2)
    toks = batch["tokens"]
    kw = {k: batch[k] for k in ("patch_embeds", "cond") if k in batch}
    prefill = serve_step.make_prefill(cfg, max_len=24 + cfg.num_image_tokens)
    decode = serve_step.make_decode_step(cfg)
    last_full, _ = prefill(model, toks, **kw)
    last, st = prefill(model, toks[..., :12], **kw)
    for t in range(12, toks.shape[-1]):
        last, st = decode(model, st, toks[..., t:t + 1], cond=kw.get("cond"))
    assert st.length == 20 + cfg.num_image_tokens
    _close(last, last_full.numpy(), 5e-5)


def _ref_codebook_greedy(params, cfg, prompt, cond, steps, max_len):
    last, st = ref_serve.make_prefill(cfg, max_len)(params, prompt, cond=cond)
    decode = ref_serve.make_decode_step(cfg)
    ids = []
    for _ in range(steps):
        tok = jnp.argmax(last, axis=-1)[:, :, None]          # (B, K, 1)
        last, st = decode(params, st, tok, cond=cond)
        ids.append(tok[:, :, 0])
    return jnp.stack(ids, -1)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    ref_cfg = ref_base.get_smoke_config(arch)
    cfg = base.get_smoke_config(arch)
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    model = tf.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 "cpu")
    batch = input_specs.sample_from_specs(
        input_specs.prefill_specs(cfg, 2, 14 + cfg.num_image_tokens), cfg,
        seed=3)
    prompt = batch["tokens"]
    kw = {k: batch[k] for k in ("patch_embeds", "cond") if k in batch}
    jkw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
    max_len = 21 + cfg.num_image_tokens
    if cfg.num_codebooks:
        want = _ref_codebook_greedy(params, ref_cfg,
                                    jnp.asarray(prompt.numpy()),
                                    jkw["cond"], 6, max_len)
    else:
        want, _ = ref_serve.greedy_generate(params, ref_cfg,
                                            jnp.asarray(prompt.numpy()),
                                            steps=6, max_len=max_len, **jkw)
    got, state = serve_step.greedy_generate(model, cfg, prompt, steps=6,
                                            max_len=max_len, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert state.length == 14 + cfg.num_image_tokens + 6


@pytest.mark.parametrize("arch, leaves", [
    ("qwen3_moe_30b_a3b", {"router": torch.float32}),
    ("rwkv6_1_6b", {"u": torch.float32, "ln_out": torch.float32,
                    "mu_x": torch.bfloat16, "w_base": torch.bfloat16}),
    ("musicgen_large", {"ln_x": torch.float32, "cond_proj": torch.bfloat16}),
    ("llava_next_34b", {"w1": torch.bfloat16, "w2": torch.bfloat16})])
def test_serving_build_keeps_f32_where_the_reference_reads_f32(arch, leaves):
    """bf16 compute: every leaf the reference reads with
    ``.astype(float32)`` (norm weights, MoE's router, RWKV's u) stays f32;
    every other leaf (RWKV's ``mu_*`` and ``w_base``, the projections) is
    cast to bf16 once."""
    cfg = dataclasses.replace(base.get_smoke_config(arch),
                              compute_dtype="bfloat16")
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seen = {}
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        want = torch.float32 if leaf in tf._PARAM_DTYPE_LEAVES \
            else torch.bfloat16
        assert p.dtype == want, name
        seen[leaf] = p.dtype
    assert {k: seen[k] for k in leaves} == leaves
    batch = input_specs.sample_from_specs(
        input_specs.prefill_specs(cfg, 1, 8 + cfg.num_image_tokens), cfg,
        seed=4)
    logits, _, _ = model(batch["tokens"], mode="train",
                         patch_embeds=batch.get("patch_embeds"),
                         cond=batch.get("cond"))
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("arch", ["musicgen_large", "llava_next_34b",
                                  "granite_moe_3b_a800m", "rwkv6_1_6b"])
def test_serve_launcher_runs_each_family_on_the_cpu(arch, capsys):
    cfg = base.get_smoke_config(arch)
    prompt_len = 12 + cfg.num_image_tokens
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", str(prompt_len),
                      "--gen-len", "3"])
    want = (2, cfg.num_codebooks, 3) if cfg.num_codebooks else (2, 3)
    assert out["ids"].shape == want
    assert out["state"].length == prompt_len + 3
    assert all(torch.isfinite(l).all() for l in out["logits"])
    assert f"prefill 2x{prompt_len}" in capsys.readouterr().out


def test_serve_launcher_lists_every_arch_in_its_help(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    for arch in base.ARCH_IDS:
        assert arch in text
