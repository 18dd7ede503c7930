"""Serving steps: prefill (build caches from a prompt) and decode (one
token against the caches), and a greedy generation loop over them.

The caches are updated in place (see ``models.kv_cache``): a decode step
returns a state that shares its tensors with the state it was given, so a
state is consumed by the step it is passed to.

Codebook models take ``(B, K, S)`` prompts and ``(B, K, 1)`` decode
tokens, and give ``(B, K, V)`` last logits.  A VLM's ``patch_embeds``
go to the prefill only; a cross-attention model's ``cond`` goes to the
prefill and to every decode step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf

__all__ = ["ServeState", "make_prefill", "make_decode_step", "pick",
           "greedy_generate"]


class ServeState(NamedTuple):
    caches: list
    length: int    # positions consumed so far (image tokens included)


def make_prefill(cfg: ModelConfig, max_len: int):
    """``max_len`` counts every position: a VLM's image tokens too."""
    def prefill(model: tf.Transformer, tokens: torch.Tensor,
                patch_embeds: Optional[torch.Tensor] = None,
                cond: Optional[torch.Tensor] = None):
        """tokens: (B, S) ints, or (B, K, S) -> (last logits, ServeState)."""
        caches = tf.init_caches(cfg, tokens.shape[0], max_len,
                                model.embed.device)
        logits, new_caches, _ = model(tokens, caches=caches, mode="prefill",
                                      start_pos=0, patch_embeds=patch_embeds,
                                      cond=cond)
        return logits[:, -1], ServeState(caches=new_caches,
                                         length=logits.shape[1])
    return prefill


def make_decode_step(cfg: ModelConfig):
    def decode_step(model: tf.Transformer, state: ServeState,
                    token: torch.Tensor, cond: Optional[torch.Tensor] = None):
        """token: (B, 1) ints, or (B, K, 1) -> (logits, ServeState)."""
        logits, new_caches, _ = model(token, caches=state.caches,
                                      mode="decode", start_pos=state.length,
                                      cond=cond)
        return logits[:, -1], ServeState(caches=new_caches,
                                         length=state.length + 1)
    return decode_step


def pick(cfg: ModelConfig, last: torch.Tensor) -> torch.Tensor:
    """The greedy next token of last logits: (B, 1), or (B, K, 1) for a
    codebook model's (B, K, V)."""
    return torch.argmax(last, dim=-1)[..., None] if cfg.num_codebooks \
        else torch.argmax(last, dim=-1)[:, None]


def greedy_generate(model: tf.Transformer, cfg: ModelConfig,
                    prompt: torch.Tensor, steps: int, max_len: int,
                    cond: Optional[torch.Tensor] = None,
                    patch_embeds: Optional[torch.Tensor] = None):
    """Greedy decoding: prefill the prompt, then ``steps`` decode steps,
    each fed the argmax of the previous logits.  Returns the generated
    ids, (B, steps) or (B, K, steps), and the final state."""
    prefill = make_prefill(cfg, max_len)
    decode = make_decode_step(cfg)
    last, state = prefill(model, prompt, patch_embeds=patch_embeds,
                          cond=cond)
    toks = []
    for _ in range(steps):
        tok = pick(cfg, last)
        last, state = decode(model, state, tok, cond=cond)
        toks.append(tok[..., 0])
    return torch.stack(toks, dim=-1), state
