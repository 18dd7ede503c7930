"""Serving steps: prefill (build caches from a prompt) and decode (one
token against the caches), and a greedy generation loop over them.

The caches are updated in place (see ``models.kv_cache``): a decode step
returns a state that shares its tensors with the state it was given, so a
state is consumed by the step it is passed to.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf

__all__ = ["ServeState", "make_prefill", "make_decode_step",
           "greedy_generate"]


class ServeState(NamedTuple):
    caches: list
    length: int    # tokens consumed so far


def make_prefill(cfg: ModelConfig, max_len: int):
    def prefill(model: tf.Transformer, tokens: torch.Tensor):
        """tokens: (B, S) ints -> (last logits (B, V), ServeState)."""
        caches = tf.init_caches(cfg, tokens.shape[0], max_len,
                                model.embed.device)
        logits, new_caches, _ = model(tokens, caches=caches, mode="prefill",
                                      start_pos=0)
        return logits[:, -1], ServeState(caches=new_caches,
                                         length=tokens.shape[1])
    return prefill


def make_decode_step(cfg: ModelConfig):
    def decode_step(model: tf.Transformer, state: ServeState,
                    token: torch.Tensor):
        """token: (B, 1) ints -> (logits (B, V), ServeState)."""
        logits, new_caches, _ = model(token, caches=state.caches,
                                      mode="decode", start_pos=state.length)
        return logits[:, -1], ServeState(caches=new_caches,
                                         length=state.length + 1)
    return decode_step


def greedy_generate(model: tf.Transformer, cfg: ModelConfig,
                    prompt: torch.Tensor, steps: int, max_len: int):
    """Greedy decoding: prefill the prompt, then ``steps`` decode steps,
    each fed the argmax of the previous logits.  Returns the (B, steps)
    generated ids and the final state."""
    prefill = make_prefill(cfg, max_len)
    decode = make_decode_step(cfg)
    last, state = prefill(model, prompt)
    toks = []
    for _ in range(steps):
        tok = torch.argmax(last, dim=-1)[:, None]
        last, state = decode(model, state, tok)
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=-1), state
