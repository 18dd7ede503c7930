"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128-expert top-8 MoE,
GQA kv=4, head_dim=128 with QK-norm.  Values as the
reference's ``repro.configs.qwen3_moe_30b_a3b``."""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe", num_layers=48, d_model=2048,
    num_heads=32, num_kv_heads=4, head_dim=128, d_ff=768,
    vocab_size=151936, rope_theta=1e6, mlp_act="silu", qk_norm=True,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    source="hf:Qwen/Qwen3-30B-A3B",
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-moe-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64),
    compute_dtype="float32")
