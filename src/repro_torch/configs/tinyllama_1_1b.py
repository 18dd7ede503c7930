"""TinyLlama-1.1B [arXiv:2401.02385; hf] — llama2-arch small, GQA kv=4.  Values as the
reference's ``repro.configs.tinyllama_1_1b``."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense", num_layers=22, d_model=2048,
    num_heads=32, num_kv_heads=4, head_dim=64, d_ff=5632,
    vocab_size=32000, rope_theta=1e4, mlp_act="silu",
    source="arXiv:2401.02385; hf:TinyLlama/TinyLlama-1.1B",
)

SMOKE = dataclasses.replace(
    CONFIG, name="tinyllama-smoke", num_layers=2, d_model=64, num_heads=8,
    num_kv_heads=2, head_dim=8, d_ff=160, vocab_size=256,
    compute_dtype="float32")
