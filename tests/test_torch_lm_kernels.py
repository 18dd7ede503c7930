"""The port's LM kernels on the CPU (their plain versions) against the JAX
package: the banded mixer against ``kops.banded_mix`` (Pallas, interpret
mode) and the oracle ``banded_mixer_ref``; flash attention against
``flash_attention_pallas`` (interpret mode) and its gradients against
``jax.grad`` of the reference's ``flash_attention``.

Bars: banded mixer f32 atol 1e-5, bf16 5e-2; flash attention f32 2e-5,
bf16 3e-2 (tests/test_flash_kernel.py), gradients 1e-4.  The CUDA kernels
themselves run only on a card: ``chip_smoke.py`` holds each against these
plain versions there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro.kernels.flash_attention import (flash_attention as ref_flash,
                                           flash_attention_pallas)
from repro.kernels.ref import banded_mixer_ref as ref_banded_ref

from repro_torch.kernels import banded_mixer as bm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import banded_mixer_ref

torch.set_num_threads(2)

BANDED_ATOL = {"float32": 1e-5, "bfloat16": 5e-2}
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


# (band kind, W, dtype, leading axes, T, D): ragged against the 16x16 tile
BANDED_CASES = [(kind, w, dt, lead, t, d)
                for kind in ("shared", "depthwise")
                for w, lead, t, d in ((1, (2,), 37, 21), (3, (2, 3), 19, 16),
                                      (4, (3,), 33, 40))
                for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("kind,w,dtype,lead,t,d", BANDED_CASES)
def test_banded_mix_plain_matches_pallas_and_oracle(kind, w, dtype, lead, t,
                                                    d):
    rng = np.random.default_rng(w * 10 + len(lead))
    x = rng.normal(size=lead + (t, d)).astype(np.float32)
    band = (rng.normal(size=(w, d) if kind == "depthwise" else (w,))
            / w).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = ref_ops.banded_mix(jnp.asarray(x, jdt), jnp.asarray(band), 16, 16)
    want_ref = ref_banded_ref(jnp.asarray(x, jdt), jnp.asarray(band))

    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    launches = bm.banded_mixer_cuda_call.launches
    got = ops.banded_mix(xt, torch.as_tensor(band), 16, 16)
    assert bm.banded_mixer_cuda_call.launches == launches  # CPU: plain
    assert got.shape == xt.shape and got.dtype == xt.dtype
    atol = BANDED_ATOL[dtype]
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=atol)
    got_ref = banded_mixer_ref(xt, torch.as_tensor(band))
    np.testing.assert_allclose(_np(got_ref), np.asarray(want_ref, np.float32),
                               atol=atol)


def test_banded_mixer_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 8, 5))
    with pytest.raises(ValueError, match="band"):
        bm.banded_mixer_cuda_call(x, torch.zeros((3, 4)))
    with pytest.raises(ValueError, match=r"\(B, T, D\)"):
        bm.banded_mixer_cuda_call(torch.zeros((8, 5)), torch.zeros(3))
    # a tensor neither on the CPU nor on a card: no silent plain fallback
    with pytest.raises(ValueError, match="device"):
        bm.banded_mixer_cuda_call(x.to("meta"), torch.zeros(3))
    # the streaming design keeps no slab in shared memory
    assert bm.smem_bytes(4, bm.BLOCK_T, bm.BLOCK_D) == 0
    src = (bm.cuda_build.CSRC / "banded_mixer.cu").read_text()
    assert "__shared__" not in src and "<<<grid, threads, 0, stream>>>" in src


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,block", [((1, 2, 64, 16), 32),
                                         ((2, 3, 48, 8), 16)])
def test_flash_plain_matches_pallas(causal, dtype, shape, block):
    rng = np.random.default_rng(sum(shape) + causal)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    jdt = getattr(jnp, dtype)
    want = flash_attention_pallas(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                  block_q=block, block_k=block, causal=causal)
    tq, tk, tv = (torch.as_tensor(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    launches = fa.flash_attention_cuda.launches
    got = fa.flash_attention_cuda(tq, tk, tv, block_q=block, block_k=block,
                                  causal=causal)
    assert fa.flash_attention_cuda.launches == launches   # CPU: plain
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=FLASH_ATOL[dtype])
    np.testing.assert_allclose(
        _np(fa.flash_attention_plain(tq, tk, tv, causal)),
        np.asarray(want, np.float32), atol=FLASH_ATOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_match_jax(causal):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(1, 2, 64, 16)).astype(np.float32)
               for _ in range(3))

    def loss(q, k, v):
        return jnp.sum(jnp.sin(ref_flash(q, k, v, causal)))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in (q, k, v)]
    torch.sin(fa.flash_attention(*leaves, causal=causal)).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4)


def test_flash_raises_where_the_reference_raises():
    q = np.zeros((1, 1, 48, 8), np.float32)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_pallas(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                               block_q=32, block_k=32)
    t = torch.as_tensor(q)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_cuda(t, t, t, block_q=32, block_k=32)
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention_cuda(t, t[:, :, :16], t, block_q=16, block_k=16)
    with pytest.raises(ValueError, match="device"):
        m = t.to("meta")
        fa.flash_attention_cuda(m, m, m, block_q=16, block_k=16)
