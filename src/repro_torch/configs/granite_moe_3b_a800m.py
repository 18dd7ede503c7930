"""Granite-3.0 3B-A800M MoE [hf:ibm-granite/granite-3.0-3b-a800m-base] —
40-expert top-8, GQA kv=8.  Values as the
reference's ``repro.configs.granite_moe_3b_a800m``."""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", num_layers=32, d_model=1536,
    num_heads=24, num_kv_heads=8, head_dim=64, d_ff=512,
    vocab_size=49155, rope_theta=1e4, mlp_act="silu", tie_embeddings=True,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512),
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
)

SMOKE = dataclasses.replace(
    CONFIG, name="granite-moe-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=256,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64),
    compute_dtype="float32")
