"""LLaVA-NeXT-34B backbone [hf:llava-hf/llava-v1.6-34b-hf; unverified] —
Yi-34B-class dense decoder; anyres vision frontend STUBBED (precomputed
patch embeddings spliced before the text tokens).  Values as the
reference's ``repro.configs.llava_next_34b``."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm", num_layers=60, d_model=7168,
    num_heads=56, num_kv_heads=8, head_dim=128, d_ff=20480,
    vocab_size=64000, rope_theta=5e6, mlp_act="silu",
    num_image_tokens=576, vision_dim=1024,
    source="hf:llava-hf/llava-v1.6-34b-hf (assignment block); unverified",
)

SMOKE = dataclasses.replace(
    CONFIG, name="llava-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    num_image_tokens=8, vision_dim=32, compute_dtype="float32")
