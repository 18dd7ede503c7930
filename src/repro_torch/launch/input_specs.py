"""Input specifications of the LM stack and seeded samples of them.

``train_batch_specs`` / ``prefill_specs`` / ``decode_specs`` (and
``specs_for_cell``) describe a batch as :class:`TensorSpec` (shape +
torch dtype, nothing allocated);
``sample_from_specs`` draws concrete tensors for them from
``np.random.default_rng(seed)`` in the reference's order and with the
reference's calls, so both packages draw identical token ids from one
seed.  Modality frontends are stubs as in the reference: MusicGen gets
precomputed conditioning embeddings, LLaVA precomputed vision patch
embeddings.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCell

__all__ = ["TensorSpec", "train_batch_specs", "prefill_specs",
           "decode_specs", "specs_for_cell", "sample_from_specs"]

TOKEN_DTYPE = torch.int32


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def _float_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def train_batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """{tokens, labels[, patch_embeds, cond]} specs."""
    specs = {}
    if cfg.num_codebooks:
        specs["tokens"] = TensorSpec((batch, cfg.num_codebooks, seq), TOKEN_DTYPE)
        specs["labels"] = TensorSpec((batch, cfg.num_codebooks, seq), TOKEN_DTYPE)
    elif cfg.num_image_tokens:
        text = seq - cfg.num_image_tokens
        specs["tokens"] = TensorSpec((batch, text), TOKEN_DTYPE)
        specs["labels"] = TensorSpec((batch, text), TOKEN_DTYPE)
        specs["patch_embeds"] = TensorSpec(
            (batch, cfg.num_image_tokens, cfg.vision_dim), _float_dtype(cfg))
    else:
        specs["tokens"] = TensorSpec((batch, seq), TOKEN_DTYPE)
        specs["labels"] = TensorSpec((batch, seq), TOKEN_DTYPE)
    if cfg.cross_attn:
        specs["cond"] = TensorSpec((batch, cfg.cond_len, cfg.cond_dim),
                                   _float_dtype(cfg))
    return specs


def prefill_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    specs = train_batch_specs(cfg, batch, seq)
    specs.pop("labels")
    return specs


def decode_specs(cfg: ModelConfig, batch: int) -> dict:
    """{token[, cond]} specs of one decode step: (B, 1) ids, or
    (B, K, 1) with codebooks."""
    specs = {}
    if cfg.num_codebooks:
        specs["token"] = TensorSpec((batch, cfg.num_codebooks, 1), TOKEN_DTYPE)
    else:
        specs["token"] = TensorSpec((batch, 1), TOKEN_DTYPE)
    if cfg.cross_attn:
        specs["cond"] = TensorSpec((batch, cfg.cond_len, cfg.cond_dim),
                                   _float_dtype(cfg))
    return specs


def specs_for_cell(cfg: ModelConfig, cell: ShapeCell) -> dict:
    if cell.kind == "train":
        return train_batch_specs(cfg, cell.global_batch, cell.seq_len)
    if cell.kind == "prefill":
        return prefill_specs(cfg, cell.global_batch, cell.seq_len)
    return decode_specs(cfg, cell.global_batch)


def sample_from_specs(specs: dict, cfg: ModelConfig, seed: int = 0) -> dict:
    """Concrete random CPU tensors matching a spec dict."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in specs.items():
        if not s.dtype.is_floating_point:
            out[k] = torch.as_tensor(
                rng.integers(0, cfg.vocab_size, size=s.shape)).to(s.dtype)
        else:
            out[k] = torch.as_tensor(
                rng.normal(size=s.shape).astype(np.float32)).to(s.dtype)
    return out
