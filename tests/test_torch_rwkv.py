"""The port's RWKV-6 (``models/rwkv6.py``) on the CPU against the JAX
package's ``repro.models.rwkv6``, in f32 at the RWKV-6 SMOKE widths, on
the reference's initial weights carried across as numpy.

Bars: 1e-4 on outputs and states against the reference; the chunked
time mix equals the stepwise recurrence within 1e-4 inside the port.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as ref_base
from repro.models import rwkv6 as ref_rwkv

from repro_torch.configs import base
from repro_torch.models import rwkv6

torch.set_num_threads(2)

ARCH = "rwkv6_1_6b"
TOL = 1e-4


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol)


@pytest.fixture(scope="module")
def layer():
    ref_cfg = ref_base.get_smoke_config(ARCH)
    cfg = base.get_smoke_config(ARCH)
    p = ref_rwkv.init_rwkv_layer(jax.random.PRNGKey(0), ref_cfg)
    # a non-trivial decay: w_base spread over the clamp's range
    rng = np.random.default_rng(0)
    p = dict(p, w_base=jnp.asarray(rng.uniform(-6, 1.5, cfg.d_model),
                                   jnp.float32),
             ln_out=jnp.asarray(rng.normal(size=cfg.d_model) * 0.1,
                                jnp.float32))
    return ref_cfg, cfg, p, {k: _t(v) for k, v in p.items()}


def _state(cfg, seed, b=2):
    rng = np.random.default_rng(seed)
    h, c, d = cfg.num_heads, cfg.head_dim, cfg.d_model
    return (rng.normal(size=(b, h, c, c)).astype(np.float32) * 0.5,
            rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(b, d)).astype(np.float32))


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("t", [16, 20, 37])
def test_time_mix_matches_jax(layer, t, carried):
    ref_cfg, cfg, p, tp = layer
    x = np.random.default_rng(t).normal(size=(2, t, cfg.d_model)) \
        .astype(np.float32)
    ref_state = state = None
    if carried:
        s, xtm, xcm = _state(cfg, 10 + t)
        ref_state = ref_rwkv.RWKVState(*(jnp.asarray(a)
                                         for a in (s, xtm, xcm)))
        state = rwkv6.RWKVState(*(_t(a) for a in (s, xtm, xcm)))
    y_w, s_w = ref_rwkv.rwkv_time_mix(p, jnp.asarray(x), ref_cfg, ref_state)
    y, s = rwkv6.rwkv_time_mix(tp, _t(x), cfg, state)
    _close(y, y_w)
    _close(s, s_w)


def test_time_mix_step_matches_jax(layer):
    ref_cfg, cfg, p, tp = layer
    s, xtm, xcm = _state(cfg, 5)
    x = np.random.default_rng(6).normal(size=(2, cfg.d_model)) \
        .astype(np.float32)
    y_w, s_w = ref_rwkv.rwkv_time_mix_step(
        p, jnp.asarray(x), ref_cfg,
        ref_rwkv.RWKVState(*(jnp.asarray(a) for a in (s, xtm, xcm))))
    y, s_new = rwkv6.rwkv_time_mix_step(
        tp, _t(x), cfg, rwkv6.RWKVState(*(_t(a) for a in (s, xtm, xcm))))
    _close(y, y_w)
    _close(s_new, s_w)


@pytest.mark.parametrize("carried", [False, True])
def test_channel_mix_matches_jax(layer, carried):
    ref_cfg, cfg, p, tp = layer
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    prev = rng.normal(size=(2, cfg.d_model)).astype(np.float32) \
        if carried else None
    y_w, last_w = ref_rwkv.rwkv_channel_mix(
        p, jnp.asarray(x), ref_cfg,
        None if prev is None else jnp.asarray(prev))
    y, last = rwkv6.rwkv_channel_mix(tp, _t(x), cfg,
                                     None if prev is None else _t(prev))
    _close(y, y_w)
    _close(last, last_w)


@pytest.mark.parametrize("t", [16, 20, 37])
def test_chunked_equals_stepwise(layer, t):
    """The reference's ``test_rwkv_chunked_equals_sequential`` in the
    port, from a carried state; at 20 and 37 the tail chunk is padded, and
    its padded steps must neither contribute nor decay."""
    _, cfg, _, tp = layer
    x = torch.as_tensor(np.random.default_rng(8).normal(
        size=(2, t, cfg.d_model)).astype(np.float32))
    s0, xtm, xcm = (_t(a) for a in _state(cfg, 9))
    y_chunk, s_chunk = rwkv6.rwkv_time_mix(
        tp, x, cfg, rwkv6.RWKVState(s0, xtm, xcm))
    st = rwkv6.RWKVState(s0, xtm, xcm)
    ys = []
    for i in range(t):
        y, s_new = rwkv6.rwkv_time_mix_step(tp, x[:, i], cfg, st)
        st = rwkv6.RWKVState(s=s_new, x_tm=x[:, i], x_cm=st.x_cm)
        ys.append(y)
    _close(y_chunk, torch.stack(ys, 1).numpy())
    _close(s_chunk, st.s.numpy())


def test_init_matches_the_reference_layout():
    ref_cfg = ref_base.get_smoke_config(ARCH)
    cfg = base.get_smoke_config(ARCH)
    want = ref_rwkv.init_rwkv_layer(jax.random.PRNGKey(0), ref_cfg)
    got = rwkv6.init_rwkv_layer(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    for k in ("mu_x", "mu_rwkvg", "w_base", "cm_mu_k", "cm_mu_r", "ln_out"):
        _close(got[k], want[k], 0)
    st = rwkv6.init_rwkv_state(3, cfg, torch.bfloat16, device="cpu")
    ref_st = ref_rwkv.init_rwkv_state(3, ref_cfg, jnp.bfloat16)
    assert [tuple(a.shape) for a in st] == [tuple(a.shape) for a in ref_st]
    assert st.s.dtype == torch.float32 and st.x_tm.dtype == torch.bfloat16
