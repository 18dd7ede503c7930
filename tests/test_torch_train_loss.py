"""The port's cross-entropy (``train/loss.py``) on the CPU against the JAX
package's ``repro.train.loss``, on the same numpy inputs: the dense CE,
the chunked CE (with and without a mask, ragged chunks, ``transpose_head``)
and the gradients of the chunked CE.

Bar: atol 1e-5 (f32), values and gradients.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.train import loss as ref_loss

from repro_torch.train import loss

torch.set_num_threads(2)

ATOL = 1e-5


def _inputs(b, s, d, v, seed, masked):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(b, s, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.7).astype(np.float32) if masked else None
    return hidden, w, labels, mask


@pytest.mark.parametrize("masked", [False, True])
def test_dense_ce_matches(masked):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.5).astype(np.float32) if masked else None
    want = ref_loss.cross_entropy_dense(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = loss.cross_entropy_dense(
        torch.tensor(logits), torch.tensor(labels),
        None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("s,chunk", [(24, 8), (21, 8), (16, 512), (9, 4)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("transpose_head", [False, True])
def test_chunked_ce_and_grads_match(s, chunk, masked, transpose_head):
    hidden, w, labels, mask = _inputs(2, s, 16, 37, seed=s + chunk,
                                      masked=masked)
    if transpose_head:
        w = np.ascontiguousarray(w.T)

    def ref(h, ww):
        return ref_loss.chunked_cross_entropy(
            h, ww, jnp.asarray(labels),
            mask=None if mask is None else jnp.asarray(mask), chunk=chunk,
            transpose_head=transpose_head)
    (want, want_count), want_g = jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True)(jnp.asarray(hidden),
                                           jnp.asarray(w))
    ht = torch.tensor(hidden, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    got, count = loss.chunked_cross_entropy(
        ht, wt, torch.tensor(labels),
        mask=None if mask is None else torch.tensor(mask), chunk=chunk,
        transpose_head=transpose_head)
    got.backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    assert float(count) == float(want_count)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_g[0]),
                               atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_g[1]),
                               atol=ATOL)


def test_chunked_equals_dense():
    hidden, w, labels, mask = _inputs(2, 20, 8, 13, seed=3, masked=True)
    logits = torch.tensor(hidden) @ torch.tensor(w)
    dense = loss.cross_entropy_dense(logits, torch.tensor(labels),
                                     torch.tensor(mask))
    chunked, _ = loss.chunked_cross_entropy(
        torch.tensor(hidden), torch.tensor(w), torch.tensor(labels),
        mask=torch.tensor(mask), chunk=6)
    torch.testing.assert_close(chunked, dense, rtol=0, atol=1e-6)


def test_chunked_ce_without_grad_runs_no_checkpoint():
    hidden, w, labels, _ = _inputs(1, 10, 8, 13, seed=4, masked=False)
    with torch.no_grad():
        got, count = loss.chunked_cross_entropy(
            torch.tensor(hidden), torch.tensor(w), torch.tensor(labels),
            chunk=4)
    assert torch.isfinite(got) and float(count) == 10.0
