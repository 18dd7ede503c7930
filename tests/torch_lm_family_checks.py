"""Shared checks of the port's LM families against the JAX package, on
the CPU in f32 at SMOKE widths (used by ``tests/test_torch_lm_families*.py``).

:func:`build_family` carries an architecture's JAX SMOKE weights across
with ``params_from_numpy`` and draws its inputs (``sample_from_specs``,
with the config's patch embeddings and conditioning).  Bar: 1e-4 on
logits and caches; the parameter tree round-trips bit for bit.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as ref_base
from repro.launch import input_specs as ref_specs
from repro.models import transformer as ref_tf
from repro.train import serve_step as ref_serve

from repro_torch.configs import base
from repro_torch.models import transformer as tf
from repro_torch.train import serve_step

TOL = 1e-4


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=atol)


def build_family(arch: str) -> dict:
    ref_cfg = ref_base.get_smoke_config(arch)
    cfg = base.get_smoke_config(arch)
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    tree = jax.tree.map(np.asarray, params)
    model = tf.params_from_numpy(tree, cfg, "cpu")
    batch = ref_specs.sample_from_specs(
        ref_specs.prefill_specs(ref_cfg, 2, 20 + ref_cfg.num_image_tokens),
        ref_cfg, seed=1)
    return dict(arch=arch, ref_cfg=ref_cfg, cfg=cfg, params=params,
                tree=tree, model=model, batch=batch)


def _kw(batch, keys=("patch_embeds", "cond")):
    return ({k: batch[k] for k in keys if k in batch},
            {k: _t(batch[k]) for k in keys if k in batch})


def _layer_caches(caches, cfg):
    """The reference's caches stacked by cycle, as one list per layer."""
    period = len(tf.build_pattern(cfg))
    return [jax.tree.map(lambda a: np.asarray(a)[i // period],
                         caches[i % period]) for i in range(cfg.num_layers)]


def check_forward_every_mode(family):
    """Train (logits and hidden), prefill and three decode steps, and the
    caches, against ``repro.models.transformer.forward``."""
    ref_cfg, cfg = family["ref_cfg"], family["cfg"]
    params, model, batch = family["params"], family["model"], family["batch"]
    kw, tkw = _kw(batch)
    toks = batch["tokens"]
    for head in (True, False):
        want, _, aux_w = ref_tf.forward(params, ref_cfg, toks, mode="train",
                                        head=head, **kw)
        got, _, aux = model(_t(toks), mode="train", head=head, **tkw)
        assert got.shape == want.shape
        _close(got, want)
        _close(aux, aux_w, 1e-5)
    if cfg.num_codebooks:
        assert got.shape[2] == cfg.num_codebooks or not head

    max_len = 26 + cfg.num_image_tokens
    last_w, st_w = ref_serve.make_prefill(ref_cfg, max_len)(params, toks,
                                                            **kw)
    last, st = serve_step.make_prefill(cfg, max_len)(model, _t(toks), **tkw)
    _close(last, last_w)
    assert st.length == int(st_w.length)
    decode_w = ref_serve.make_decode_step(ref_cfg)
    decode = serve_step.make_decode_step(cfg)
    ckw, tckw = _kw(batch, ("cond",))
    for t in range(3):
        shape = (2, cfg.num_codebooks, 1) if cfg.num_codebooks else (2, 1)
        tok = np.full(shape, 7 + t, np.int32)
        last_w, st_w = decode_w(params, st_w, jnp.asarray(tok), **ckw)
        last, st = decode(model, st, _t(tok), **tckw)
        _close(last, last_w)
    # the caches themselves: layer c*P + i is the reference's [i][c]
    for got_c, want_c in zip(st.caches, _layer_caches(st_w.caches, cfg)):
        assert type(got_c).__name__ == type(want_c).__name__
        for g, w in zip(got_c, want_c):
            if isinstance(g, torch.Tensor):
                _close(g, w)


def check_params_round_trip(family):
    """``params_to_numpy(params_from_numpy(tree))`` is the tree, bit for
    bit; the trainable build takes it too."""
    tree, cfg = family["tree"], family["cfg"]
    back = tf.params_to_numpy(family["model"])
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    trained = tf.params_from_numpy(back, cfg, "cpu", trainable=True)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in trained.parameters())
