"""The port's optimizer and gradient compression (``optim/``) on the CPU
against the JAX package's ``repro.optim``, on the same numpy inputs:
AdamW over three steps with clipping, decay on matrices only and the
cosine schedule; the schedules; ``GradAccumulator``; the ``bf16`` and
``int8`` compressors with error feedback.

Bars: AdamW parameters and moments atol 1e-6 (f32); the grad norm and
the schedules 1e-6 relative; int8 codes exact, residuals and decompressed
grads 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp

from repro_torch.optim import adamw, compression

torch.set_num_threads(2)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
            "b": (rng.normal(size=(5,)) * scale).astype(np.float32),
            "blocks": [{"k": (rng.normal(size=(2, 3, 4)) * scale)
                        .astype(np.float32)}]}


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return adamw.tree_map(lambda a: torch.tensor(a), tree)


def _close(got_tree, want_tree, atol):
    got = adamw.tree_leaves(got_tree)
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


def test_tree_order_is_jax_order():
    tree = _tree(0)
    got = [t.shape for t in adamw.tree_leaves(_torch(tree))]
    assert got == [tuple(a.shape) for a in jax.tree.leaves(_jnp(tree))]


@pytest.mark.parametrize("clip", [1.0, 0.0, 100.0])
def test_adamw_three_steps_match(clip):
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=clip)
    ref = ref_adamw.adamw(lr=ref_adamw.cosine_schedule(1e-2, 2, 6), **kw)
    opt = adamw.adamw(lr=adamw.cosine_schedule(1e-2, 2, 6), **kw)
    p_ref = _jnp(_tree(1))
    p = _torch(_tree(1))
    s_ref, s = ref.init(p_ref), opt.init(p)
    for step in range(3):
        g = _tree(10 + step, scale=2.0)
        p_ref, s_ref, m_ref = ref.update(_jnp(g), s_ref, p_ref)
        p, s, m = opt.update(_torch(g), s, p)
        _close(p, p_ref, 1e-6)
        _close(s.mu, s_ref.mu, 1e-6)
        _close(s.nu, s_ref.nu, 1e-6)
        assert int(s.step) == int(s_ref.step) == step + 1
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(m_ref["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(m_ref["lr"]),
                                   rtol=1e-6)


def test_adamw_decays_matrices_only_by_default():
    opt = adamw.adamw(lr=0.1, weight_decay=0.5, clip_norm=0.0)
    p = {"m": torch.ones(2, 2), "v": torch.ones(2)}
    zeros = {"m": torch.zeros(2, 2), "v": torch.zeros(2)}
    opt.update(zeros, opt.init(p), p)
    assert torch.all(p["m"] == 1 - 0.1 * 0.5) and torch.all(p["v"] == 1)
    q = {"m": torch.ones(2, 2), "v": torch.ones(2)}
    opt.update(zeros, opt.init(q), q, decay={"m": False, "v": True})
    assert torch.all(q["m"] == 1) and torch.all(q["v"] == 1 - 0.1 * 0.5)


def test_clip_and_global_norm_match():
    g = _tree(3, scale=5.0)
    want, want_n = ref_adamw.clip_by_global_norm(_jnp(g), 1.0)
    got, got_n = adamw.clip_by_global_norm(_torch(g), 1.0)
    _close(got, want, 1e-6)
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-6)
    np.testing.assert_allclose(float(adamw.global_norm(_torch(g))),
                               float(ref_adamw.global_norm(_jnp(g))),
                               rtol=1e-6)


def test_schedules_match():
    cos_ref = ref_adamw.cosine_schedule(3e-4, 5, 40, final_frac=0.2)
    cos = adamw.cosine_schedule(3e-4, 5, 40, final_frac=0.2)
    lin_ref, lin = ref_adamw.linear_warmup(1e-3, 7), adamw.linear_warmup(
        1e-3, 7)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        for fr, fp in ((cos_ref, cos), (lin_ref, lin)):
            want = float(fr(jnp.asarray(step, jnp.int32)))
            got = float(fp(torch.tensor(step, dtype=torch.int32)))
            np.testing.assert_allclose(got, want, rtol=1e-6)


def test_grad_accumulator_matches():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    xs = rng.normal(size=(3, 5, 4)).astype(np.float32)

    def ref_loss(p, x):
        l = jnp.mean(jnp.tanh(x @ p["w"]) ** 2)
        return l, 0.5 * l
    want = ref_adamw.GradAccumulator.accumulate(
        ref_loss, {"w": jnp.asarray(w)}, jnp.asarray(xs))

    def loss(p, x):
        l = torch.mean(torch.tanh(x @ p["w"]) ** 2)
        return l, 0.5 * l
    got = adamw.GradAccumulator.accumulate(
        loss, {"w": torch.tensor(w, requires_grad=True)}, torch.tensor(xs))
    np.testing.assert_allclose(float(got[0]), float(want[0]), atol=1e-6)
    np.testing.assert_allclose(got[1]["w"].numpy(), np.asarray(want[1]["w"]),
                               atol=1e-6)
    np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-6)


@pytest.mark.parametrize("kind", ["none", "bf16", "int8"])
def test_compressors_with_error_feedback_match(kind):
    ref_init, ref_c, ref_d = ref_comp.make_compressor(kind)
    init, comp, decomp = compression.make_compressor(kind)
    g0 = _tree(5, scale=3.0)
    s_ref, s = ref_init(_jnp(g0)), init(_torch(g0))
    for step in range(3):
        g = _tree(20 + step, scale=3.0)
        w_ref, s_ref = ref_c(_jnp(g), s_ref)
        w, s = comp(_torch(g), s)
        if kind == "int8":
            got_q = [l for l in adamw.tree_leaves(w)
                     if l.dtype == torch.int8]
            want_q = [np.asarray(l) for l in jax.tree.leaves(w_ref)
                      if l.dtype == jnp.int8]
            assert len(got_q) == len(want_q) == 3
            for gq, wq in zip(got_q, want_q):
                np.testing.assert_array_equal(gq.numpy(), wq)
            _close(s.error, s_ref.error, 1e-6)
        _close(decomp(w), ref_d(w_ref), 1e-6)


def test_unknown_compressor_raises():
    with pytest.raises(ValueError, match="unknown compressor"):
        compression.make_compressor("fp8")
