"""The port's LM serving slice on the CPU against the JAX package, at smoke
size, on the same numpy inputs and the JAX model's weights carried across
(``transformer.params_from_numpy``).

Bars: layers, caches and attention 1e-5 (f32); the SSM and the Hymba
forward in every mode 1e-4 (f32: ``SMOKE`` computes in f32, where the two
frameworks' roundings agree closely; bf16 is checked only inside the
port, on the card); the serving consistency 5e-5, the reference's bar in
``tests/test_models.py::test_smoke_serve_consistency``; greedy ids equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as ref_base
from repro.launch import input_specs as ref_specs
from repro.models import attention_chunked as ref_ac
from repro.models import kv_cache as ref_kvc
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.train import serve_step as ref_serve

from repro_torch.configs import base
from repro_torch.kernels import banded_mixer as bm
from repro_torch.launch import input_specs, serve
from repro_torch.models import attention_chunked as ac
from repro_torch.models import kv_cache as kvc
from repro_torch.models import layers
from repro_torch.models import moe
from repro_torch.models import rwkv6
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.train import serve_step

torch.set_num_threads(2)

ARCH = "hymba_1_5b"


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _close(got: torch.Tensor, want, atol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=atol)


def _port_cfg(ref_cfg):
    """The port's config of a reference config (``pallas`` -> ``cuda``)."""
    d = dataclasses.asdict(ref_cfg)
    d["ssm"] = base.SSMConfig(**d["ssm"]) if d["ssm"] else None
    d["moe"] = base.MoEConfig(**d["moe"]) if d["moe"] else None
    d["kernel_impl"] = {"pallas": "cuda"}.get(d["kernel_impl"],
                                              d["kernel_impl"])
    return base.ModelConfig(**d)


def _smoke(**kw):
    """The reference's and the port's Hymba SMOKE, with ``kw`` replaced."""
    ref = dataclasses.replace(ref_base.get_smoke_config(ARCH), **kw)
    return ref, _port_cfg(ref)


# ---------------------------------------------------------------------------
# configs and inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_configs_are_the_reference_values(getter):
    ref = getattr(ref_base, getter)(ARCH)
    port = getattr(base, getter)(ARCH)
    assert port == _port_cfg(ref)
    assert port.kernel_impl == "cuda"
    assert port.param_count() == ref.param_count()
    for arch in ref_base.ARCH_IDS:         # every architecture loads
        assert getattr(base, getter)(arch) == \
            _port_cfg(getattr(ref_base, getter)(arch))
    with pytest.raises(ValueError, match="kernel_impl"):
        dataclasses.replace(port, kernel_impl="pallas")


def test_sample_from_specs_draws_the_reference_ids():
    ref_cfg, cfg = _smoke()
    for seed, (b, s) in ((1, (4, 24)), (2, (2, 20))):
        want = ref_specs.sample_from_specs(
            ref_specs.train_batch_specs(ref_cfg, b, s), ref_cfg, seed=seed)
        got = input_specs.sample_from_specs(
            input_specs.train_batch_specs(cfg, b, s), cfg, seed=seed)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert list(input_specs.prefill_specs(cfg, 2, 8)) == ["tokens"]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_rope_mlp_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32) * 0.1
    _close(layers.rms_norm(_t(w), _t(x)),
           ref_layers.rms_norm(jnp.asarray(w), jnp.asarray(x)), 1e-5)
    pos = np.arange(3, 10)
    _close(layers.rope(_t(x), _t(pos), 1e4),
           ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-5)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.2
         for k, s in (("wi_gate", (16, 24)), ("wi_up", (16, 24)),
                      ("wo", (24, 16)))}
    for act in ("silu", "gelu"):
        _close(layers.mlp({k: _t(v) for k, v in p.items()}, _t(x), act),
               ref_layers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), act), 1e-5)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def _check_view(cache, ref_cache):
    got, want = kvc.cache_view(cache), ref_kvc.cache_view(ref_cache)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert cache.length == int(ref_cache.length)


@pytest.mark.parametrize("window,prefill_len", [(5, 3), (5, 7), (None, 4)])
def test_kv_cache_writes_and_views_match_jax(window, prefill_len):
    """Full and ring caches; ring before and after the wrap (prefill
    shorter and longer than the window, then decode past it)."""
    rng = np.random.default_rng(prefill_len)
    b, max_len, kvh, dh = 2, 16, 2, 3
    cache = kvc.init_kv_cache(b, max_len, kvh, dh, window, torch.float32,
                              device="cpu")
    ref_cache = ref_kvc.init_kv_cache(b, max_len, kvh, dh, window,
                                      jnp.float32)
    assert type(cache).__name__ == type(ref_cache).__name__
    k, v = (rng.normal(size=(b, prefill_len, kvh, dh)).astype(np.float32)
            for _ in range(2))
    cache = kvc.prefill_write(cache, _t(k), _t(v))
    ref_cache = ref_kvc.prefill_write(ref_cache, jnp.asarray(k),
                                      jnp.asarray(v))
    _check_view(cache, ref_cache)
    for _ in range(max_len - prefill_len):
        k, v = (rng.normal(size=(b, 1, kvh, dh)).astype(np.float32)
                for _ in range(2))
        cache = kvc.decode_write(cache, _t(k), _t(v))
        ref_cache = ref_kvc.decode_write(ref_cache, jnp.asarray(k),
                                         jnp.asarray(v))
        _check_view(cache, ref_cache)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_PATHS = {
    # path: (Sq, window, causal, kv_scan)
    "attn_block": (8, 6, True, False),
    "banded_window": (21, 6, True, False),
    "dense_chunks": (21, None, True, False),
    "dense_chunks_full": (21, None, False, False),
    "flash": (21, 6, True, True),
    "flash_full": (21, None, False, True),
}


@pytest.mark.parametrize("path", sorted(ATTN_PATHS))
def test_chunked_attention_paths_match_jax(path):
    sq, window, causal, kv_scan = ATTN_PATHS[path]
    rng = np.random.default_rng(sq)
    b, h, kvh, dh = 2, 4, 2, 8
    q = rng.normal(size=(b, sq, h, dh)).astype(np.float32)
    k, v = (rng.normal(size=(b, sq, kvh, dh)).astype(np.float32)
            for _ in range(2))
    pos = np.arange(sq)
    kw = dict(causal=causal, window=window, q_chunk=8, kv_block=8,
              kv_scan=kv_scan)
    want = ref_ac.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos), **kw)
    got = ac.chunked_attention(_t(q), _t(k), _t(v), q_positions=_t(pos),
                               k_positions=_t(pos), **kw)
    _close(got, want, 1e-5)


def test_decode_attention_over_a_wrapped_ring_matches_jax():
    rng = np.random.default_rng(3)
    b, h, kvh, dh, w = 2, 4, 2, 8, 6
    cache = kvc.init_kv_cache(b, 20, kvh, dh, w, torch.float32,
                              device="cpu")
    ref_cache = ref_kvc.init_kv_cache(b, 20, kvh, dh, w, jnp.float32)
    for _ in range(9):     # past the window: the ring has wrapped
        k, v = (rng.normal(size=(b, 1, kvh, dh)).astype(np.float32)
                for _ in range(2))
        cache = kvc.decode_write(cache, _t(k), _t(v))
        ref_cache = ref_kvc.decode_write(ref_cache, jnp.asarray(k),
                                         jnp.asarray(v))
    q = rng.normal(size=(b, 1, h, dh)).astype(np.float32)
    kk, vv, kpos, kmask = kvc.cache_view(cache)
    rk, rv, rpos, rmask = ref_kvc.cache_view(ref_cache)
    qpos = np.array([cache.length - 1])
    got = ac.chunked_attention(_t(q), kk, vv, q_positions=_t(qpos),
                               k_positions=kpos, window=w, kv_mask=kmask)
    want = ref_ac.chunked_attention(jnp.asarray(q), rk, rv,
                                    q_positions=jnp.asarray(qpos),
                                    k_positions=rpos, window=w, kv_mask=rmask)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------

def _ssm_params(ref_cfg):
    p = ref_ssm.init_ssm(jax.random.PRNGKey(0), ref_cfg)
    return p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("conv_shared,impl", [(False, "pallas"),
                                              (True, "pallas"),
                                              (False, "ref")])
def test_ssm_forward_and_step_match_jax(conv_shared, impl):
    ref_cfg, cfg = _smoke(ssm=dataclasses.replace(
        ref_base.get_smoke_config(ARCH).ssm, conv_shared=conv_shared),
        kernel_impl=impl)
    p_ref, p = _ssm_params(ref_cfg)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 41, cfg.d_model)).astype(np.float32)
    # train mode (no state), then prefill from a zero state
    y_ref, _ = ref_ssm.ssm_forward(p_ref, jnp.asarray(x), ref_cfg)
    y, _ = ssm.ssm_forward(p, _t(x), cfg)
    _close(y, y_ref, 1e-4)
    st_ref = ref_ssm.init_ssm_state(2, ref_cfg)
    y_ref, st_ref = ref_ssm.ssm_forward(p_ref, jnp.asarray(x), ref_cfg,
                                        state=st_ref)
    y, st = ssm.ssm_forward(p, _t(x), cfg,
                            state=ssm.init_ssm_state(2, cfg, device="cpu"))
    _close(y, y_ref, 1e-4)
    _close(st.h, st_ref.h, 1e-4)
    _close(st.conv_tail, st_ref.conv_tail, 1e-6)
    for t in range(3):
        xt = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
        y_ref, st_ref = ref_ssm.ssm_step(p_ref, jnp.asarray(xt), ref_cfg,
                                         st_ref)
        y, st = ssm.ssm_step(p, _t(xt), cfg, st)
        _close(y, y_ref, 1e-4)
        _close(st.h, st_ref.h, 1e-4)


def test_ssm_chunked_equals_sequential():
    ref_cfg, cfg = _smoke()
    _, p = _ssm_params(ref_cfg)
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(2, 2 * ssm.CHUNK + 9, cfg.d_model)).astype(np.float32))
    y_par, st_par = ssm.ssm_forward(p, x, cfg)
    st = ssm.init_ssm_state(2, cfg, device="cpu")
    ys = []
    for t in range(x.shape[1]):
        y, st = ssm.ssm_step(p, x[:, t], cfg, st)
        ys.append(y)
    _close(y_par, torch.stack(ys, 1), 1e-4)
    _close(st_par.h, st.h, 1e-4)


# ---------------------------------------------------------------------------
# the Hymba smoke model: every mode, serving, greedy generation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hymba():
    """Reference and port models with the reference's weights; four layers,
    so the pattern (period 2) runs two cycles and a cycle/position mix-up
    in the carry-across shows."""
    ref_cfg, cfg = _smoke(num_layers=4)
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    model = tf.params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 "cpu")
    return ref_cfg, cfg, params, model


def test_params_from_numpy_layer_order(hymba):
    ref_cfg, cfg, params, model = hymba
    period = len(tf.build_pattern(cfg))
    for i, layer in enumerate(model.layers):
        want = np.asarray(params["layers"][i % period]["attn"]["wq"])[
            i // period]
        np.testing.assert_array_equal(layer.attn["wq"].numpy(), want)
        assert layer.window == tf.build_pattern(cfg)[i % period][1]
    assert not any(p.requires_grad for p in model.parameters())


def test_forward_every_mode_matches_jax(hymba):
    ref_cfg, cfg, params, model = hymba
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 20)).astype(np.int32)
    want, _, _ = ref_tf.forward(params, ref_cfg, jnp.asarray(toks),
                                mode="train")
    got, _, _ = model(_t(toks), mode="train")
    _close(got, want, 1e-4)
    hid_want, _, _ = ref_tf.forward(params, ref_cfg, jnp.asarray(toks),
                                    mode="train", head=False)
    hid, _, _ = model(_t(toks), mode="train", head=False)
    _close(hid, hid_want, 1e-4)

    max_len = 24       # > window 16: ring caches on the windowed layers
    last_ref, st_ref = ref_serve.make_prefill(ref_cfg, max_len)(
        params, jnp.asarray(toks))
    last, st = serve_step.make_prefill(cfg, max_len)(model, _t(toks))
    _close(last, last_ref, 1e-4)
    assert st.length == int(st_ref.length)
    decode_ref = ref_serve.make_decode_step(ref_cfg)
    decode = serve_step.make_decode_step(cfg)
    for t in range(3):
        tok = np.full((2, 1), 7 + t, np.int32)
        last_ref, st_ref = decode_ref(params, st_ref, jnp.asarray(tok))
        last, st = decode(model, st, _t(tok))
        _close(last, last_ref, 1e-4)
    # the caches themselves: layer c*P + i is the reference's [i][c]
    period = len(tf.build_pattern(cfg))
    for i, (attn_c, ssm_s) in enumerate(st.caches):
        ref_attn, ref_ssm_s = st_ref.caches[i % period]
        assert type(attn_c).__name__ == type(ref_attn).__name__
        _close(attn_c.k, np.asarray(ref_attn.k)[i // period], 1e-4)
        _close(ssm_s.h, np.asarray(ref_ssm_s.h)[i // period], 1e-4)


def test_smoke_serve_consistency():
    """The port's counterpart of the reference's test: a 20-token prefill
    against 12 prefilled + 8 decoded tokens (window 16 < max_len 24, so
    the windowed layers decode against ring caches)."""
    _, cfg = _smoke()
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = input_specs.sample_from_specs(
        input_specs.train_batch_specs(cfg, 2, 20), cfg, seed=2)["tokens"]
    prefill = serve_step.make_prefill(cfg, max_len=24)
    decode = serve_step.make_decode_step(cfg)
    last_full, _ = prefill(model, toks)
    last, st = prefill(model, toks[:, :12])
    for t in range(12, 20):
        last, st = decode(model, st, toks[:, t:t + 1])
    assert isinstance(st.caches[0][0], kvc.RingKVCache)
    _close(last, last_full.numpy(), 5e-5)


def test_greedy_generate_matches_jax(hymba):
    ref_cfg, cfg, params, model = hymba
    prompt = input_specs.sample_from_specs(
        input_specs.train_batch_specs(cfg, 2, 14), cfg, seed=3)["tokens"]
    want, _ = ref_serve.greedy_generate(params, ref_cfg,
                                        jnp.asarray(prompt.numpy()),
                                        steps=6, max_len=21)
    got, state = serve_step.greedy_generate(model, cfg, prompt, steps=6,
                                            max_len=21)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert state.length == 14 + 6


def test_serve_launcher_runs_on_the_cpu(capsys):
    launches = bm.banded_mixer_cuda_call.launches
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--gen-len", "4"])
    assert bm.banded_mixer_cuda_call.launches == launches   # CPU: plain
    assert out["ids"].shape == (2, 4)
    assert all(torch.isfinite(l).all() for l in out["logits"])
    text = capsys.readouterr().out
    assert "prefill 2x20" in text and "ms/tok" in text


def test_serve_launcher_defaults_to_the_card():
    """Hymba, a codebook config and an image-token config."""
    for arch in (ARCH, "musicgen_large", "llava_next_34b"):
        argv = ["--arch", arch, "--smoke", "--gen-len", "2"]
        if torch.cuda.is_available():
            assert serve.main(argv)["ids"].device.type == "cuda"
            continue
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(argv)


@pytest.mark.parametrize("part", ["transformer", "kv_cache", "ssm_state",
                                  "rwkv_state", "rwkv_layer", "moe",
                                  "caches"])
def test_model_parts_take_no_default_device(part):
    """Nothing quietly builds on the CPU: every public model part that
    allocates takes an explicit ``device``."""
    _, cfg = _smoke()
    build = {
        "transformer": lambda: tf.Transformer(cfg, np.zeros((4, 4)), [],
                                              np.zeros(4)),
        "kv_cache": lambda: kvc.init_kv_cache(1, 8, 1, 4, None,
                                              torch.float32),
        "ssm_state": lambda: ssm.init_ssm_state(1, cfg),
        "rwkv_state": lambda: rwkv6.init_rwkv_state(1, cfg),
        "rwkv_layer": lambda: rwkv6.init_rwkv_layer(torch.Generator(), cfg),
        "moe": lambda: moe.init_moe(torch.Generator(), 8,
                                    base.MoEConfig(4, 2, 8)),
        "caches": lambda: tf.init_caches(cfg, 1, 8),
    }[part]
    with pytest.raises(TypeError, match="device"):
        build()
