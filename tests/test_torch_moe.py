"""The port's MoE FFN (``models/moe.py``) on the CPU against the JAX
package's ``repro.models.moe``, in f32, on the same numpy weights and
inputs.

Bars: output and aux loss within 1e-5; the dropped ``(token, k)``
assignments identical.  The dropped set is read from the port's
``route`` and held against an oracle computed from JAX's own top-k
(stable sort by expert, position = index - group start, kept below the
capacity); the oracle is first held against the reference's output, so
it is the set the reference drops.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as ref_base
from repro.models import moe as ref_moe

from repro_torch.configs import base
from repro_torch.models import moe

torch.set_num_threads(2)

D, B, S = 16, 2, 12


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _params(e, dff, seed=0):
    rng = np.random.default_rng(seed)
    return {"router": rng.normal(size=(D, e)).astype(np.float32),
            "wi_gate": rng.normal(size=(e, D, dff)).astype(np.float32) / 4,
            "wi_up": rng.normal(size=(e, D, dff)).astype(np.float32) / 4,
            "wo": rng.normal(size=(e, dff, D)).astype(np.float32) / 4}


def _cfgs(groups, capacity_factor=0.5):
    kw = dict(num_experts=4, top_k=2, d_ff_expert=8,
              capacity_factor=capacity_factor, groups=groups)
    return ref_base.MoEConfig(**kw), base.MoEConfig(**kw)


def _oracle_keep(xt, p, mcfg, dropless):
    """(keep (T*k,), gates (T, k), experts (T, k)) of one group from JAX's
    router and top-k."""
    probs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(p["router"]), -1)
    gates, experts = jax.lax.top_k(probs, mcfg.top_k)
    gates = np.asarray(gates / gates.sum(-1, keepdims=True))
    flat = np.asarray(experts).reshape(-1)
    t = xt.shape[0]
    cap = t if dropless else max(min(math.ceil(
        t * mcfg.top_k / mcfg.num_experts * mcfg.capacity_factor),
        t * mcfg.top_k), 1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=mcfg.num_experts)
    starts = np.cumsum(counts) - counts
    pos = np.empty_like(flat)
    pos[order] = np.arange(flat.size) - starts[flat[order]]
    return pos < cap, gates, np.asarray(experts)


def _dense_combine(xt, p, keep, gates, experts):
    """Every kept assignment's gated expert SwiGLU, summed per token."""
    y = np.zeros_like(xt)
    k = experts.shape[1]
    for i in range(xt.shape[0]):
        for j in range(k):
            if keep[i * k + j]:
                e = experts[i, j]
                g = xt[i] @ p["wi_gate"][e]
                a = g / (1 + np.exp(-g)) * (xt[i] @ p["wi_up"][e])
                y[i] += gates[i, j] * (a @ p["wo"][e])
    return y


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dropless", [True, False])
def test_moe_ffn_matches_jax_and_drops_the_same_assignments(groups,
                                                            dropless):
    ref_cfg, cfg = _cfgs(groups)
    p = _params(4, 8)
    x = np.random.default_rng(1).normal(size=(B, S, D)).astype(np.float32)
    want = ref_moe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), ref_cfg, dropless=dropless)
    got = moe.moe_ffn({k: _t(v) for k, v in p.items()}, _t(x), cfg,
                      dropless=dropless)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), atol=1e-5)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               atol=1e-5)
    dropped = 0
    for xt, yt in zip(x.reshape(groups, -1, D),
                      np.asarray(want.y).reshape(groups, -1, D)):
        keep, gates, experts = _oracle_keep(xt, p, ref_cfg, dropless)
        # the oracle is the set the reference keeps
        np.testing.assert_allclose(
            _dense_combine(xt, p, keep, gates, experts), yt, atol=1e-4)
        r = moe.route(_t(xt), _t(p["router"]), cfg, dropless)
        np.testing.assert_array_equal(r.experts.numpy(), experts)
        np.testing.assert_array_equal(r.keep.numpy(), keep)
        dropped += int((~keep).sum())
    assert (dropped == 0) == dropless


def test_observers_see_counts_and_drops():
    _, cfg = _cfgs(1)
    p = {k: _t(v) for k, v in _params(4, 8).items()}
    x = _t(np.random.default_rng(2).normal(size=(B, S, D)).astype(np.float32))
    seen = []
    moe.DISPATCH_OBSERVERS.append(lambda c, d: seen.append((c, int(d))))
    try:
        moe.moe_ffn(p, x, cfg, dropless=False)
        moe.moe_ffn(p, x, cfg, dropless=True)
    finally:
        moe.DISPATCH_OBSERVERS.clear()
    r = moe.route(x.reshape(-1, D), p["router"], cfg, False)
    (counts, dropped), (_, none) = seen
    assert int(counts.sum()) == B * S * cfg.top_k
    assert dropped == int((~r.keep).sum()) > 0 and none == 0


def test_capacity_mode_drops_tokens():
    """The reference's ``test_moe_capacity_drops_tokens`` in the port."""
    cfg = base.MoEConfig(num_experts=2, top_k=1, d_ff_expert=8,
                         capacity_factor=0.5)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, 4, cfg, "cpu")
    x = torch.randn((1, 16, 4), generator=gen)
    diff = (moe.moe_ffn(p, x, cfg).y
            - moe.moe_ffn(p, x, cfg, dropless=True).y).abs().max()
    assert float(diff) > 1e-6


def test_gradients_match_jax():
    ref_cfg, cfg = _cfgs(1)
    p = _params(4, 8)
    x = np.random.default_rng(3).normal(size=(B, S, D)).astype(np.float32)

    def ref_loss(pp, xx):
        out = ref_moe.moe_ffn(pp, xx, ref_cfg)
        return jnp.sum(jnp.sin(out.y)) + out.aux_loss
    gp, gx = jax.grad(ref_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tx = _t(x).requires_grad_(True)
    out = moe.moe_ffn(tp, tx, cfg)
    (torch.sum(torch.sin(out.y)) + out.aux_loss).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-5)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]),
                                   atol=1e-5, err_msg=k)


def test_init_draws_the_reference_shapes():
    ref_cfg, cfg = _cfgs(1)
    want = ref_moe.init_moe(jax.random.PRNGKey(0), D, ref_cfg)
    got = moe.init_moe(torch.Generator().manual_seed(0), D, cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    with pytest.raises(TypeError, match="device"):
        moe.init_moe(torch.Generator(), D, cfg)
