"""Every mode of the port's ``forward`` and its parameter round trip
against the JAX package for the five families beyond the dense decoder:
MoE (Granite, Qwen3), RWKV-6, MusicGen (codebooks, cross-attention) and
LLaVA-NeXT (image tokens), in f32 at SMOKE widths
(``torch_lm_family_checks``: 1e-4 on logits and caches).
"""
import pytest
import torch

import torch_lm_family_checks as checks

torch.set_num_threads(2)

ARCHS = ["granite_moe_3b_a800m", "qwen3_moe_30b_a3b", "rwkv6_1_6b",
         "musicgen_large", "llava_next_34b"]


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    return checks.build_family(request.param)


def test_forward_every_mode_matches_jax(family):
    checks.check_forward_every_mode(family)


def test_params_round_trip_through_numpy(family):
    checks.check_params_round_trip(family)
