"""RWKV-6 Finch 1.6B [arXiv:2404.05892; unverified] — attention-free,
data-dependent decay. head_dim 64 -> 32 heads at d_model 2048.  Values as the
reference's ``repro.configs.rwkv6_1_6b``."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm", num_layers=24, d_model=2048,
    num_heads=32, num_kv_heads=32, head_dim=64, d_ff=7168,
    vocab_size=65536, rwkv_mode=True,
    source="arXiv:2404.05892; hf:RWKV/rwkv-6-world-1b6 (unverified)",
)

SMOKE = dataclasses.replace(
    CONFIG, name="rwkv6-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=160, vocab_size=256,
    compute_dtype="float32")
