"""The port's LM stack on the CPU against the JAX package for the nine
architectures beyond Hymba: their configs field for field, their input
specs and seeded samples, and, for the dense four (TinyLlama, Yi, Gemma,
Gemma-3), every mode of ``forward`` and the parameter round trip
(``torch_lm_family_checks``; the other five are in
``test_torch_lm_families_nondense.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import base as ref_base
from repro.launch import input_specs as ref_specs

from repro_torch.configs import base
from repro_torch.launch import input_specs

import torch_lm_family_checks as checks

torch.set_num_threads(2)

ARCHS = [a for a in ref_base.ARCH_IDS if a != "hymba_1_5b"]
DENSE = ["tinyllama_1_1b", "yi_6b", "gemma_2b", "gemma3_12b"]


def _port_cfg(ref_cfg):
    d = dataclasses.asdict(ref_cfg)
    d["ssm"] = base.SSMConfig(**d["ssm"]) if d["ssm"] else None
    d["moe"] = base.MoEConfig(**d["moe"]) if d["moe"] else None
    d["kernel_impl"] = {"pallas": "cuda"}.get(d["kernel_impl"],
                                              d["kernel_impl"])
    return base.ModelConfig(**d)


def test_arch_ids_and_cells_are_the_reference_ones():
    assert base.ARCH_IDS == ref_base.ARCH_IDS
    assert base.LONG_CONTEXT_ARCHS == ref_base.LONG_CONTEXT_ARCHS
    for arch in base.ARCH_IDS:
        assert base.cells_for(arch) == ref_base.cells_for(arch)
    with pytest.raises(ValueError, match="unknown architecture"):
        base.get_config("gpt_2")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_values(arch):
    for getter in ("get_config", "get_smoke_config"):
        ref = getattr(ref_base, getter)(arch)
        port = getattr(base, getter)(arch)
        assert port == _port_cfg(ref)
        assert port.param_count() == ref.param_count()
    assert base.get_config(arch.replace("_", "-")) == base.get_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_samples_are_the_reference_ones(arch):
    """Every kind of cell's specs, and one seed's draws of them (token ids,
    codebook ids, patch embeddings, conditioning), equal the
    reference's."""
    ref_cfg, cfg = ref_base.get_smoke_config(arch), base.get_smoke_config(arch)
    for kind in ("train", "prefill", "decode"):
        seq = 12 + cfg.num_image_tokens
        want = ref_specs.specs_for_cell(
            ref_cfg, ref_base.ShapeCell("c", seq, 3, kind))
        got = input_specs.specs_for_cell(cfg, base.ShapeCell("c", seq, 3,
                                                             kind))
        assert list(got) == list(want)
        assert [tuple(v.shape) for v in got.values()] == \
            [tuple(v.shape) for v in want.values()]
        drawn = input_specs.sample_from_specs(got, cfg, seed=5)
        for k, v in ref_specs.sample_from_specs(want, ref_cfg,
                                                seed=5).items():
            assert drawn[k].is_floating_point() == \
                jnp.issubdtype(v.dtype, jnp.floating)
            np.testing.assert_array_equal(drawn[k].numpy(), np.asarray(v))


@pytest.fixture(scope="module", params=DENSE)
def family(request):
    return checks.build_family(request.param)


def test_forward_every_mode_matches_jax(family):
    checks.check_forward_every_mode(family)


def test_params_round_trip_through_numpy(family):
    checks.check_params_round_trip(family)
