"""The port's differentiable SSM scan (``models.ssm._SelectiveScan``, used
by ``ssm_forward`` where a gradient is wanted) on the CPU against
``jax.grad`` of the JAX package's ``ssm_forward`` (the reference's
``@jax.checkpoint chunk_body`` scan), on the JAX weights carried across.

Bars: gradients atol 1e-5 + rtol 1e-4 (f32; the SSM's forward is held to
1e-4 in ``tests/test_torch_lm.py``); the scan Function against autograd
through an out-of-place loop at 1e-10 in f64, and ``gradcheck`` in f64;
the serve forward (no grad) bit-identical to the scan as it was written
before it had a backward, and to the Function's forward.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as ref_base
from repro.models import ssm as ref_ssm

from repro_torch.configs import base
from repro_torch.models import ssm

torch.set_num_threads(2)

ARCH = "hymba_1_5b"
ATOL, RTOL = 1e-5, 1e-4


def _port_cfg(ref_cfg):
    d = dataclasses.asdict(ref_cfg)
    d["ssm"] = base.SSMConfig(**d["ssm"])
    d["moe"] = None
    d["kernel_impl"] = {"pallas": "cuda"}.get(d["kernel_impl"],
                                              d["kernel_impl"])
    return base.ModelConfig(**d)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def smoke():
    ref_cfg = ref_base.get_smoke_config(ARCH)
    p_ref = ref_ssm.init_ssm(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, _port_cfg(ref_cfg), jax.tree.map(np.asarray, p_ref)


@pytest.mark.parametrize("t_len,with_state", [(45, False), (45, True),
                                              (70, True), (32, False)])
def test_grads_match_jax(smoke, t_len, with_state):
    ref_cfg, cfg, p_np = smoke
    rng = np.random.default_rng(t_len)
    x = rng.normal(size=(2, t_len, cfg.d_model)).astype(np.float32)
    di, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
    h0 = (0.5 * rng.normal(size=(2, di, n))).astype(np.float32)
    tail = rng.normal(size=(2, cfg.ssm.conv_width - 1, di)).astype(np.float32)
    r = rng.normal(size=(2, di, n)).astype(np.float32)

    def ref_loss(p, xx, h, tl):
        state = ref_ssm.SSMState(h=h, conv_tail=tl) if with_state else None
        y, st = ref_ssm.ssm_forward(p, xx, ref_cfg, state=state)
        return jnp.sum(jnp.sin(y)) + jnp.sum(st.h * r)
    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(x), jnp.asarray(h0),
        jnp.asarray(tail))

    p = {k: torch.tensor(v, requires_grad=True) for k, v in p_np.items()}
    xt = torch.tensor(x, requires_grad=True)
    ht = torch.tensor(h0, requires_grad=True)
    tt = torch.tensor(tail, requires_grad=True)
    state = ssm.SSMState(h=ht, conv_tail=tt) if with_state else None
    y, st = ssm.ssm_forward(p, xt, cfg, state=state)
    (torch.sin(y).sum() + (st.h * torch.tensor(r)).sum()).backward()
    for k in p_np:
        _close(p[k].grad, want[0][k])
    _close(xt.grad, want[1])
    if with_state:
        _close(ht.grad, want[2])
        _close(tt.grad, want[3])


def _loop(dtf, dtx, bbf, ccf, a, h):
    """The recurrence out of place, step by step (autograd records it)."""
    ys = []
    for i in range(dtf.shape[1]):
        h = h * torch.exp(dtf[:, i, :, None] * a) \
            + dtx[:, i, :, None] * bbf[:, i, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, ccf[:, i]))
    return torch.stack(ys, 1), h


def _scan_inputs(t_len, seed, dtype=torch.float64, b=2, di=3, n=2):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, dtype=dtype) * scale
                ).requires_grad_(True)
    dtf = (torch.rand((b, t_len, di), generator=g, dtype=dtype) * 0.5
           ).requires_grad_(True)
    a = (-torch.rand((di, n), generator=g, dtype=dtype) - 0.1
         ).requires_grad_(True)
    return [dtf, r(b, t_len, di), r(b, t_len, n), r(b, t_len, n), a,
            r(b, di, n, scale=0.5)]


@pytest.mark.parametrize("t_len", [ssm.CHUNK + 9, 2 * ssm.CHUNK, 7])
def test_scan_function_equals_autograd_of_a_loop(t_len):
    inputs = _scan_inputs(t_len, seed=t_len)
    gy = torch.randn(2, t_len, 3, dtype=torch.float64)
    gh = torch.randn(2, 3, 2, dtype=torch.float64)
    grads = []
    for fn in (ssm._SelectiveScan.apply, _loop):
        y, h = fn(*inputs)
        grads.append(torch.autograd.grad((y * gy).sum() + (h * gh).sum(),
                                         inputs))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-10)


def test_scan_gradcheck_f64():
    inputs = _scan_inputs(ssm.CHUNK + 3, seed=1, b=1, di=2, n=2)
    assert torch.autograd.gradcheck(ssm._SelectiveScan.apply, inputs)


def _scan_before(dtf, dtx, bbf, ccf, a, h, t):
    """The serve path's scan as it was written before it had a backward."""
    ys = []
    for c0 in range(0, t, ssm.CHUNK):
        sl = slice(c0, min(c0 + ssm.CHUNK, t))
        decay = torch.exp(dtf[:, sl].transpose(0, 1)[..., None] * a)
        hs = dtx[:, sl].transpose(0, 1)[..., None] \
            * bbf[:, sl].transpose(0, 1)[:, :, None, :]
        for i in range(hs.shape[0]):
            h = hs[i].addcmul_(h, decay[i])
        ys.append(torch.einsum("lbdn,lbn->bld", hs,
                               ccf[:, sl].transpose(0, 1)))
    return torch.cat(ys, dim=1), h.clone()


def test_serve_forward_is_bit_identical(smoke):
    _, cfg, p_np = smoke
    x = torch.tensor(np.random.default_rng(5).normal(
        size=(2, 2 * ssm.CHUNK + 5, cfg.d_model)).astype(np.float32))
    inputs = [t.detach().float() for t in _scan_inputs(x.shape[1], seed=2,
                                                       di=128, n=4)]
    want = _scan_before(*inputs, x.shape[1])
    with torch.no_grad():
        got = ssm._scan(*inputs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the Function's forward is the same loop
    got = ssm._SelectiveScan.apply(*[t.requires_grad_(True)
                                     for t in inputs])
    for g, w in zip(got, want):
        assert torch.equal(g.detach(), w)
    # ssm_forward: the no-grad path and the differentiable one agree
    p = {k: torch.tensor(v) for k, v in p_np.items()}
    with torch.no_grad():
        y0, st0 = ssm.ssm_forward(p, x, cfg)
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    y1, st1 = ssm.ssm_forward(p, x, cfg)
    assert torch.equal(y0, y1.detach()) and torch.equal(st0.h,
                                                        st1.h.detach())
