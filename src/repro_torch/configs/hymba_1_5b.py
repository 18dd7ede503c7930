"""Hymba-1.5B [arXiv:2411.13676; hf] — parallel attention + Mamba heads in
every layer, ssm_state=16; sliding-window attention with periodic global
layers (period 8 here — the published 3-global-layer placement is not
periodic, noted in DESIGN.md).  Values as the reference's
``repro.configs.hymba_1_5b``."""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", num_layers=32, d_model=1600,
    num_heads=25, num_kv_heads=5, head_dim=64, d_ff=5504,
    vocab_size=32001, rope_theta=1e4, mlp_act="silu",
    sliding_window=1024, local_global_period=8,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    source="arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base",
)

SMOKE = dataclasses.replace(
    CONFIG, name="hymba-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    sliding_window=16, local_global_period=2,
    ssm=SSMConfig(state_dim=4, conv_width=4, expand=2),
    compute_dtype="float32")
