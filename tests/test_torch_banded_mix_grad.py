"""The banded mixer's backward in the port (``ops.banded_mix``, a
``torch.autograd.Function``) on the CPU against ``jax.grad`` of the JAX
package's ``ops.banded_mix`` (its ``custom_vjp``, Pallas in interpret
mode), on the same numpy inputs.

Bars: ``dx`` and ``dband`` atol 1e-5 (f32); ``gradcheck`` in f64 of the
Function's backward with the kernel wrapper standing in as the f64 oracle.
On a CUDA tensor ``dx`` is one more launch of ``csrc/banded_mixer.cu``
(chip_smoke phase 8 holds it against autograd through the plain version).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as ref_ops

from repro_torch.kernels import banded_mixer as bm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import banded_mixer_ref

torch.set_num_threads(2)

ATOL = 1e-5

# (band kind, W, leading axes, T, D): ragged against the 16x16 tile
CASES = [("shared", 4, (2,), 37, 24), ("depthwise", 4, (2,), 37, 24),
         ("depthwise", 3, (), 16, 40), ("shared", 2, (2, 3), 21, 16),
         ("depthwise", 4, (3, 2), 5, 33), ("depthwise", 6, (1,), 4, 8)]


def _inputs(kind, w, lead, t, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (t, d)).astype(np.float32)
    band = (rng.normal(size=(w, d) if kind == "depthwise" else (w,))
            / w).astype(np.float32)
    return x, band


@pytest.mark.parametrize("kind,w,lead,t,d", CASES)
def test_grads_match_jax_custom_vjp(kind, w, lead, t, d):
    x, band = _inputs(kind, w, lead, t, d, seed=w * 100 + t)

    def loss(xx, bb):
        return jnp.sum(jnp.sin(ref_ops.banded_mix(xx, bb, 16, 16)))
    want_dx, want_db = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(band))
    xt = torch.tensor(x, requires_grad=True)
    bt = torch.tensor(band, requires_grad=True)
    torch.sin(ops.banded_mix(xt, bt, 16, 16)).sum().backward()
    assert bt.grad.shape == band.shape
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               atol=ATOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want_db),
                               atol=ATOL * max(1.0, np.abs(want_db).max()))


def _f64_wrapper(monkeypatch, calls: list):
    """Stand the kernel wrapper in with the f64 oracle (recording each
    call's batch and ``backward`` flag)."""
    def call(x, band, block_t=bm.BLOCK_T, block_d=bm.BLOCK_D, *,
             backward=False):
        calls.append((x.shape[0], backward))
        return banded_mixer_ref(x, band)
    monkeypatch.setattr(ops, "banded_mixer", types.SimpleNamespace(
        MAX_BATCH=2, BLOCK_T=bm.BLOCK_T, BLOCK_D=bm.BLOCK_D,
        banded_mixer_cuda_call=call))


@pytest.mark.parametrize("kind", ["shared", "depthwise"])
def test_gradcheck_f64(kind, monkeypatch):
    calls: list = []
    _f64_wrapper(monkeypatch, calls)
    x, band = _inputs(kind, 3, (2,), 9, 5, seed=7)
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    bt = torch.tensor(band, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: ops.banded_mix(a, b),
                                    (xt, bt))


def test_backward_chunks_the_batch_and_flags_its_launches(monkeypatch):
    """dx runs flip-mix-flip through the wrapper, ``MAX_BATCH`` sequences
    a call, each call marked ``backward``; the forward's calls are not."""
    calls: list = []
    _f64_wrapper(monkeypatch, calls)
    x, band = _inputs("depthwise", 4, (5,), 11, 6, seed=3)
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    bt = torch.tensor(band, dtype=torch.float64, requires_grad=True)
    y = ops.banded_mix(xt, bt)
    assert calls == [(2, False), (2, False), (1, False)]
    g = torch.tensor(np.random.default_rng(4).normal(size=x.shape))
    dx, db = torch.autograd.grad(y, (xt, bt), g)
    assert calls[3:] == [(2, True), (2, True), (1, True)]
    # the anti-causal mix written out: dx[t] = sum_s band[s] g[t + s]
    want = torch.zeros_like(g)
    for s in range(band.shape[0]):
        want[:, :11 - s] += bt.detach()[s] * g[:, s:]
    torch.testing.assert_close(dx, want, rtol=0, atol=1e-12)


def test_cpu_backward_launches_nothing():
    x, band = _inputs("depthwise", 4, (2,), 12, 8, seed=1)
    xt = torch.tensor(x, requires_grad=True)
    bt = torch.tensor(band, requires_grad=True)
    before = (bm.banded_mixer_cuda_call.launches,
              bm.banded_mixer_cuda_call.backward_launches)
    ops.banded_mix(xt, bt).sum().backward()
    assert (bm.banded_mixer_cuda_call.launches,
            bm.banded_mixer_cuda_call.backward_launches) == before
    assert xt.grad is not None and bt.grad is not None


def test_band_grad_wider_than_sequence():
    """A band wider than T: the taps past T see no input, dband is 0."""
    x, band = _inputs("depthwise", 6, (1,), 4, 8, seed=9)
    xt = torch.tensor(x, requires_grad=True)
    bt = torch.tensor(band, requires_grad=True)
    ops.banded_mix(xt, bt).sum().backward()
    assert torch.all(bt.grad[4:] == 0)
