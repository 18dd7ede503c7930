"""The port's differentiable stencil (``kernels.ops.stencil_apply_vjp``)
against the JAX package's: ``jax.grad`` through the reference's
``custom_vjp`` (its Pallas forward in interpret mode) and the reference's
manual loss, on the same numpy inputs; ``dx`` at 1e-4 and ``dC`` at 1e-3,
the reference's bars."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as ref_ops

from repro_torch.core import stencil_spec as ss
from repro_torch.kernels import ops, stencil_mxu

torch.set_num_threads(2)

DX_ATOL, DC_ATOL = 1e-4, 1e-3


def _port_grads(x, c):
    xt = torch.tensor(x, requires_grad=True)
    ct = torch.tensor(c, requires_grad=True)
    torch.cos(ops.stencil_apply_vjp(xt, ct)).sum().backward()
    return xt.grad.numpy(), ct.grad.numpy()


def _jax_grads(x, c):
    def loss(x, c):
        return jnp.sum(jnp.cos(ref_ops.stencil_apply_vjp(x, c,
                                                         interpret=True)))
    gx, gc = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(c))
    return np.asarray(gx), np.asarray(gc)


def _manual_grads(x, c):
    """The reference test's manual loss: a sum of shifted windows."""
    def loss(x, c):
        nd = c.ndim
        out = [n - (c.shape[0] - 1) for n in x.shape[x.ndim - nd:]]
        acc = 0.0
        for off in np.ndindex(*c.shape):
            win = (Ellipsis,) + tuple(slice(o, o + n)
                                      for o, n in zip(off, out))
            acc = acc + c[off] * x[win]
        return jnp.sum(jnp.cos(acc))
    gx, gc = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(c))
    return np.asarray(gx), np.asarray(gc)


def _inputs(case):
    rng = np.random.default_rng(5)
    if case == "2d":
        x, c = rng.normal(size=(18, 18)), rng.normal(size=(3, 3))
    elif case == "batched":
        x, c = rng.normal(size=(2, 3, 18, 18)), rng.normal(size=(3, 3))
    elif case == "3d":
        x = rng.normal(size=(12, 12, 14))
        c = ss.PAPER_SUITE()["star3d_r1"].gather_coeffs
    else:                       # radius 2: the adjoint pads g by 4
        x, c = rng.normal(size=(20, 22)), rng.normal(size=(5, 5))
    return x.astype(np.float32), np.asarray(c, np.float32)


@pytest.mark.parametrize("case", ["2d", "batched", "3d", "r2"])
def test_stencil_vjp_matches_jax_grad(case):
    x, c = _inputs(case)
    gx, gc = _port_grads(x, c)
    rx, rc = _jax_grads(x, c)
    assert gx.shape == x.shape and gc.shape == c.shape
    np.testing.assert_allclose(gx, rx, atol=DX_ATOL)
    np.testing.assert_allclose(gc, rc, atol=DC_ATOL)


@pytest.mark.parametrize("case", ["2d", "batched", "3d"])
def test_stencil_vjp_matches_manual_loss(case):
    x, c = _inputs(case)
    gx, gc = _port_grads(x, c)
    mx_, mc = _manual_grads(x, c)
    np.testing.assert_allclose(gx, mx_, atol=DX_ATOL)
    np.testing.assert_allclose(gc, mc, atol=DC_ATOL)


def test_stencil_vjp_forward_is_the_valid_stencil():
    x, c = _inputs("2d")
    y = ops.stencil_apply_vjp(torch.tensor(x), torch.tensor(c))
    want = ref_ops.stencil_apply_vjp(jnp.asarray(x), jnp.asarray(c),
                                     interpret=True)
    assert tuple(y.shape) == (16, 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-5)


def test_stencil_vjp_runs_the_step_kernel_for_both_sides(monkeypatch):
    """Forward and adjoint both go through the step kernel's wrapper (its
    plain version on the CPU); the coefficient gradient needs no kernel."""
    calls = []
    real = stencil_mxu.stencil_cuda_call

    def spy(x, plan, aux=()):
        calls.append((tuple(x.shape), plan.spec.order))
        return real(x, plan, aux)

    monkeypatch.setattr(stencil_mxu, "stencil_cuda_call", spy)
    x, c = _inputs("2d")
    xt = torch.tensor(x, requires_grad=True)
    ct = torch.tensor(c, requires_grad=True)
    y = ops.stencil_apply_vjp(xt, ct)
    assert len(calls) == 1
    torch.cos(y).sum().backward()
    assert len(calls) == 2
    assert calls[1][1] == 1           # the adjoint keeps the radius


def test_stencil_vjp_coefficient_gradient_only():
    x, c = _inputs("2d")
    ct = torch.tensor(c, requires_grad=True)
    torch.cos(ops.stencil_apply_vjp(torch.tensor(x), ct)).sum().backward()
    _, rc = _jax_grads(x, c)
    np.testing.assert_allclose(ct.grad.numpy(), rc, atol=DC_ATOL)
