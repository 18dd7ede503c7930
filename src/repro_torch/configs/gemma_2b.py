"""Gemma-2B [arXiv:2403.08295; hf] — GeGLU, head_dim=256, MQA.  Values as the
reference's ``repro.configs.gemma_2b``."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense", num_layers=18, d_model=2048,
    num_heads=8, num_kv_heads=1, head_dim=256, d_ff=16384,
    vocab_size=256000, rope_theta=1e4, mlp_act="gelu", tie_embeddings=True,
    source="arXiv:2403.08295; hf:google/gemma-2b",
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma-2b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512,
    compute_dtype="float32")
