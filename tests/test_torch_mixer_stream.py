"""The banded mixer's streaming design on the CPU: its plain version (which
the wrapper runs on a CPU tensor) against the JAX package's
``banded_mixer_pallas_call`` in interpret mode at the edges of the new
tile — fewer rows than the band (T < W), a decode call (T = W), channel
counts that are not a multiple of a thread's 16-byte group (4 f32, 8
bf16), a band wider than the kernel keeps in registers — and the host
side of the design: the tile arguments, the constants the CUDA source
defines, and the launcher bound once.

Bars: f32 atol 1e-5, bf16 5e-2 (those of tests/test_torch_lm_kernels.py).
"""
import ctypes
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.banded_mixer import banded_mixer_pallas_call

from repro_torch.kernels import banded_mixer as bm
from repro_torch.kernels import cuda_build
from repro_torch.kernels import ops

torch.set_num_threads(2)

ATOL = {"float32": 1e-5, "bfloat16": 5e-2}

# (W, T, D): T < W, T = W (decode), ragged D, a band past the register path
EDGES = [(4, 2, 16), (4, 4, 3200 // 100), (4, 4, 13), (3, 9, 21),
         (1, 5, 7), (bm.MAX_REGISTER_W + 2, 12, 12), (4, 17, 37)]


def _pallas(x, band, dtype):
    """The reference kernel per sequence, one tile per sequence (its tiles
    must divide T and D)."""
    t_len, d = x.shape[-2:]
    jx = jnp.asarray(x, getattr(jnp, dtype))
    outs = [banded_mixer_pallas_call(jx[b], jnp.asarray(band), t_len, d,
                                     interpret=True)
            for b in range(x.shape[0])]
    return np.stack([np.asarray(o, np.float32) for o in outs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["shared", "depthwise"])
@pytest.mark.parametrize("w,t,d", EDGES)
def test_plain_matches_pallas_at_the_tile_edges(w, t, d, kind, dtype):
    rng = np.random.default_rng(w * 100 + t * 10 + d)
    x = rng.normal(size=(2, t, d)).astype(np.float32)
    band = (rng.normal(size=(w, d) if kind == "depthwise" else (w,))
            / w).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    launches = bm.banded_mixer_cuda_call.launches
    got = ops.banded_mix(xt, torch.from_numpy(band))
    assert bm.banded_mixer_cuda_call.launches == launches  # CPU: plain
    assert got.shape == xt.shape and got.dtype == xt.dtype
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               _pallas(x, band, dtype), atol=ATOL[dtype])


def test_tile_follows_the_thread_group():
    assert bm.group(torch.float32) == 4 and bm.group(torch.bfloat16) == 8
    for dtype in (torch.float32, torch.bfloat16):
        g = bm.group(dtype)
        assert bm.BLOCK_D % g == 0 and bm.BLOCK_D // g <= bm.MAX_THREADS
    assert bm.smem_bytes(4, bm.BLOCK_T, bm.BLOCK_D) == 0


def _constant(src: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m is not None, f"{name} is not defined as a constexpr int"
    return int(m.group(1))


def test_kernel_constants_match_the_wrapper():
    src = (cuda_build.CSRC / "banded_mixer.cu").read_text()
    assert _constant(src, "kMaxThreads") == bm.MAX_THREADS
    assert _constant(src, "kMaxW") == bm.MAX_REGISTER_W
    assert "static constexpr int kGroup = 16 / sizeof(T);" in src
    # one instantiation per register width, then the generic band
    for w in range(1, bm.MAX_REGISTER_W + 1):
        assert f"BANDED_MIXER_W({w})" in src
    assert "launch_w<T, 0>" in src


def test_launcher_is_bound_once(monkeypatch):
    """The C launcher's argument types are set once, not on every call."""
    loads = []

    class Launch:        # a stand-in for the ctypes function
        pass

    class Lib:
        banded_mixer_launch = Launch()

    monkeypatch.setattr(bm.cuda_build, "load",
                        lambda name: loads.append(name) or Lib)
    bm._launcher.cache_clear()
    try:
        first, again = bm._launcher(), bm._launcher()
    finally:
        bm._launcher.cache_clear()
    assert first is again and loads == ["banded_mixer"]
    assert first.argtypes == [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    assert first.restype is ctypes.c_int
