"""Yi-6B [arXiv:2403.04652; hf] — llama-arch GQA dense decoder.  Values as the
reference's ``repro.configs.yi_6b``."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=4, head_dim=128, d_ff=11008,
    vocab_size=64000, rope_theta=5e6, mlp_act="silu",
    source="arXiv:2403.04652; hf:01-ai/Yi-6B",
)

SMOKE = dataclasses.replace(
    CONFIG, name="yi-6b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    compute_dtype="float32")
