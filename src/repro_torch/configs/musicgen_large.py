"""MusicGen-large [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens,
4 codebooks, cross-attention to (stubbed) text conditioning. MHA (kv=32).  Values as the
reference's ``repro.configs.musicgen_large``."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio", num_layers=48, d_model=2048,
    num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192,
    vocab_size=2048, rope_theta=1e4, mlp_act="gelu",
    num_codebooks=4, cross_attn=True, cond_len=64, cond_dim=2048,
    source="arXiv:2306.05284; hf:facebook/musicgen-large",
)

SMOKE = dataclasses.replace(
    CONFIG, name="musicgen-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=64,
    num_codebooks=2, cond_len=8, cond_dim=64, compute_dtype="float32")
