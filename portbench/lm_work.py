"""Work of a language model's prefill, counted from the configuration's
shapes: what ``prefill_mfu`` holds the window's calls to.  Nothing here
reads the program.

A prefill of ``batch`` prompts of ``seq`` tokens does, for every token of
every layer, each matrix product once (2 flops a multiply-add), the
attention over the keys the layer's kind lets it see (causal, and within
the window where the layer is windowed), the SSM's short conv and its
recurrence; then the LM head for each prompt's last position only, since
only that position's logits are kept.  Elementwise work (norms, RoPE,
activations, softmax) is not counted.  Work a program does beyond this
(the head at every position, attention scores that a mask discards)
counts for nothing here, so cutting it shows as speed, not as less work.
"""
from __future__ import annotations

__all__ = ["keys_attended", "prefill_flops"]


def keys_attended(seq: int, window: int | None) -> int:
    """Query-key pairs of one causal attention head over ``seq``
    positions: query ``t`` sees ``t + 1`` keys, at most ``window``."""
    if window is None or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def prefill_flops(config: dict, batch: int, seq: int) -> float:
    """Flops of one prefill of ``batch`` prompts of ``seq`` tokens through
    the hybrid model of ``config`` (the keys of ``configs/<name>.json``)."""
    d = int(config["hidden_size"])
    h, kvh = int(config["num_attention_heads"]), \
        int(config["num_key_value_heads"])
    dh, ff = int(config["head_dim"]), int(config["intermediate_size"])
    di = int(config["mamba_expand"]) * d
    n, w = int(config["mamba_d_state"]), int(config["mamba_d_conv"])
    r = int(config["mamba_dt_rank"])
    layers = int(config["num_hidden_layers"])
    global_layers = {int(i) for i in config["global_attn_idx"]}
    window = int(config["attn_window_size"])
    tokens = batch * seq
    # a token's matrix products in one layer
    attn_proj = 2 * d * (h * dh + 2 * kvh * dh) + 2 * h * dh * d
    ssm_proj = 2 * d * 2 * di + 2 * di * (r + 2 * n) + 2 * r * di \
        + 2 * di * d
    # the conv: w multiply-adds a channel; the recurrence a state element:
    # dt * A, (dt x) * B, the update h * decay + u, the output C . h
    ssm_seq = 2 * w * di + 6 * di * n
    mlp = 3 * 2 * d * ff
    per_token = attn_proj + ssm_proj + ssm_seq + mlp
    total = float(layers * tokens * per_token)
    for i in range(layers):
        pairs = keys_attended(seq, None if i in global_layers else window)
        total += batch * h * pairs * 4 * dh        # q.k and p.v
    return total + 2.0 * batch * d * int(config["vocab_size"])
