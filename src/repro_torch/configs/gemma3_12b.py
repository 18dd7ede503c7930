"""Gemma-3 12B [hf:google/gemma-3-12b-pt; unverified] — 5:1 local:global,
sliding window 1024, GeGLU, head_dim=256, 128k-class context.  Values as the
reference's ``repro.configs.gemma3_12b``."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense", num_layers=48, d_model=3840,
    num_heads=16, num_kv_heads=8, head_dim=256, d_ff=15360,
    vocab_size=262144, rope_theta=1e6, mlp_act="gelu",
    sliding_window=1024, local_global_period=6, qk_norm=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-12b-pt (assignment block); unverified",
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma3-smoke", num_layers=6, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
    sliding_window=8, compute_dtype="float32")
