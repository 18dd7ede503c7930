"""The plain reference of Hymba's forward pass, and its comparison.

Hymba (arXiv:2411.13676) runs attention heads and SSM heads in parallel
in every layer: each layer reads ``h = norm(x)`` into both, and adds the
mean of their normalised outputs to the residual, then a gated MLP.  Most
layers attend within a sliding window, a few globally.  This file writes
the forward pass out in plain ``torch``, in float32 with TF32 off: every
product a matrix product of two float32 operands, attention as masked
scores and a softmax over all keys, the SSM's recurrence a loop over
time.  No cache, no kernel, nothing of the program.

It follows the published description, with the departures the port has
(and the configuration's ``assumed`` lists), each as the port has it:

* no meta tokens (``num_memory_tokens`` 0, published 128): the prompt is
  the input, nothing is prepended;
* no cross-layer KV sharing (``kv_reuse_group`` empty, published pairs
  of consecutive layers): every layer projects its own keys and values;
* global attention in the layers ``global_attn_idx`` lists (7, 15, 23,
  31, the port's period of 8), not the published 0, 15, 31;
* each branch has its own output projection (attention's ``wo``, the
  SSM's ``out_proj``), and the two projected outputs are RMS-normed and
  averaged: ``0.5 * (norm_attn(attn) + norm_ssm(ssm))``, the norms'
  scales standing in for the published ``beta`` vectors.  The published
  block normalises before one shared output projection;
* the SSM's short causal conv has no bias;
* the LM head is a matrix of its own, not the embedding's transpose.

Norms are RMS norms with the scale ``1 + w`` and ``eps`` 1e-6; RoPE
rotates the two halves of each head (theta 1e4); the SSM is Mamba's
selective scan: ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``y_t =
C_t . h_t + D x_t``, gated by ``silu(z)``.

:func:`init_weights` draws a model's weights from a generator on the
device, in a few large calls, in the configuration's compute dtype: the
benchmark builds the program from one draw and, once the program's state
is freed, :func:`checks` draws them again from the same seed.  :func:`forward_last` is the forward pass,
returning each prompt's last-position logits.  :func:`checks` is the
comparison the harness holds to the cell's limits; with ``control="fp8"``
the reference stands in the program's place with every matrix product's
operands rounded to float8 e4m3 (per-tensor scale), one precision below
the configuration's bfloat16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["CONTROLS", "ROWS", "init_weights", "forward_last", "checks",
           "fp8_round", "layer_is_global", "weight_dtype"]

#: the lower precisions that can stand in the program's place
CONTROLS = ("fp8",)

#: prompts the reference computes at once
ROWS = 48
#: queries a block of attention scores holds
QUERY_BLOCK = 256
#: time steps whose decays and inputs the scan forms at once
SCAN_BLOCK = 64
_FP8_MAX = 448.0          # the largest finite float8 e4m3fn


def _sizes(config: dict) -> dict:
    d = int(config["hidden_size"])
    di = int(config["mamba_expand"]) * d
    return {"d": d, "di": di, "h": int(config["num_attention_heads"]),
            "kvh": int(config["num_key_value_heads"]),
            "dh": int(config["head_dim"]),
            "ff": int(config["intermediate_size"]),
            "v": int(config["vocab_size"]),
            "n": int(config["mamba_d_state"]),
            "w": int(config["mamba_d_conv"]),
            "r": int(config["mamba_dt_rank"]),
            "layers": int(config["num_hidden_layers"])}


def layer_is_global(config: dict, i: int) -> bool:
    """Whether layer ``i`` attends over every earlier position: one of
    ``global_attn_idx``."""
    return i in config["global_attn_idx"]


def weight_dtype(config: dict) -> torch.dtype:
    """The type the weights are drawn in: the configuration's compute
    dtype, the one the program serves its matrices in."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[config["compute_dtype"]]


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def init_weights(config: dict, generator: torch.Generator,
                 device) -> dict:
    """Seeded weights in :func:`weight_dtype`, drawn on ``device`` one
    kind of leaf at a time for all layers at once.

    The tree is the port's parameter tree by name: ``embed`` (V, D),
    ``lm_head`` (D, V), ``final_norm`` (D,), and ``layers``, a list with a
    dict a layer: ``ln1``, ``ln2``, ``norm_attn``, ``norm_ssm`` (D,);
    ``attn``: ``wq``, ``wk``, ``wv``, ``wo``; ``ssm``: ``in_proj`` (D,
    2 DI), ``conv_band`` (W, DI), ``x_proj`` (DI, R + 2N), ``dt_proj``
    (R, DI), ``dt_bias``, ``d_skip`` (DI,), ``a_log`` (DI, N),
    ``out_proj`` (DI, D); ``ffn``: ``wi_gate``, ``wi_up`` (D, FF), ``wo``
    (FF, D).  Matrices map ``x @ w``, each drawn N(0, 1/d_in); the norms'
    ``w`` N(0, 0.1^2), so each scale ``1 + w`` matters; ``a_log`` is
    Mamba's ``log(1..N)`` with N(0, 0.1^2) noise; ``dt_bias`` puts
    ``softplus`` of it uniform in [0.001, 0.1]; ``d_skip`` 1 + N(0, 0.1^2).
    The matrices are drawn in the dtype itself; the small leaves in
    float32, then rounded to it.
    """
    s = _sizes(config)
    dtype = weight_dtype(config)
    d, di, n, L = s["d"], s["di"], s["n"], s["layers"]
    hd, kvd = s["h"] * s["dh"], s["kvh"] * s["dh"]

    def normal(shape, std, dt=dtype):
        t = torch.randn(shape, generator=generator, device=device, dtype=dt)
        return t.mul_(std)

    def dense(*shape):              # (L, d_in, d_out) or (d_in, d_out)
        return normal(shape, 1.0 / math.sqrt(shape[-2]))

    def small(shape, std):
        return normal(shape, std, torch.float32)

    stacked = {
        "ln1": small((L, d), 0.1), "ln2": small((L, d), 0.1),
        "norm_attn": small((L, d), 0.1), "norm_ssm": small((L, d), 0.1),
        "attn.wq": dense(L, d, hd), "attn.wk": dense(L, d, kvd),
        "attn.wv": dense(L, d, kvd), "attn.wo": dense(L, hd, d),
        "ssm.in_proj": dense(L, d, 2 * di),
        "ssm.conv_band": small((L, s["w"], di), 1.0 / s["w"]),
        "ssm.x_proj": dense(L, di, s["r"] + 2 * n),
        "ssm.dt_proj": dense(L, s["r"], di),
        "ssm.out_proj": dense(L, di, d),
        "ffn.wi_gate": dense(L, d, s["ff"]), "ffn.wi_up": dense(L, d, s["ff"]),
        "ffn.wo": dense(L, s["ff"], d),
    }
    u = torch.rand((L, di), generator=generator, device=device) \
        .mul_(0.1 - 1e-3).add_(1e-3)
    stacked["ssm.dt_bias"] = torch.log(torch.expm1(u))
    stacked["ssm.d_skip"] = small((L, di), 0.1).add_(1.0)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device).log()
    stacked["ssm.a_log"] = small((L, di, n), 0.1).add_(a)
    for name in ("ln1", "ln2", "norm_attn", "norm_ssm", "ssm.conv_band",
                 "ssm.dt_bias", "ssm.d_skip", "ssm.a_log"):
        stacked[name] = stacked[name].to(dtype)
    layers = []
    for i in range(L):
        layer: dict = {}
        for name, t in stacked.items():
            group, _, leaf = name.rpartition(".")
            (layer.setdefault(group, {}) if group else layer)[
                leaf or group] = t[i]
        layers.append(layer)
    return {"embed": normal((s["v"], d), 0.02), "layers": layers,
            "final_norm": small((d,), 0.1).to(dtype),
            "lm_head": dense(d, s["v"])}


# ---------------------------------------------------------------------------
# The forward pass
# ---------------------------------------------------------------------------

def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude maps to 448), returned in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _matmul(a, b):
    return a @ b


def _matmul_fp8(a, b):
    return fp8_round(a) @ fp8_round(b)


def _rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x, theta):
    """x: (B, S, heads, dh), positions 0..S-1."""
    s, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p, h, s, config, window, mm):
    """Causal self-attention of ``h`` (B, S, D); keys within ``window``
    positions of the query when it is given."""
    b, t, _ = h.shape
    dh = s["dh"]
    theta = float(config["rope_theta"])
    q = _rope(mm(h, p["wq"]).view(b, t, s["h"], dh), theta)
    k = _rope(mm(h, p["wk"]).view(b, t, s["kvh"], dh), theta)
    v = mm(h, p["wv"]).view(b, t, s["kvh"], dh)
    group = s["h"] // s["kvh"]      # query head j reads key head j // group
    q = q.transpose(1, 2)                                   # (B, H, S, dh)
    k = k.repeat_interleave(group, dim=2).transpose(1, 2)
    v = v.repeat_interleave(group, dim=2).transpose(1, 2)
    pos = torch.arange(t, device=h.device)
    out = torch.empty_like(q)
    for q0 in range(0, t, QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, t)
        scores = mm(q[:, :, q0:q1], k.transpose(-1, -2)) / math.sqrt(dh)
        qp = pos[q0:q1, None]
        keep = pos[None, :] <= qp
        if window is not None:
            keep &= pos[None, :] > qp - window
        scores = scores.masked_fill(~keep, float("-inf"))
        out[:, :, q0:q1] = mm(torch.softmax(scores, dim=-1), v)
        del scores
    return mm(out.transpose(1, 2).reshape(b, t, s["h"] * dh), p["wo"])


def _scan(dt, u, bm, cm, a):
    """The selective scan as a loop over time: ``h_t = exp(dt_t A) h_{t-1}
    + u_t B_t``, ``y_t = C_t . h_t``.  dt, u: (B, S, DI); bm, cm: (B, S,
    N); a: (DI, N)."""
    b, t, di = dt.shape
    h = torch.zeros((b, di, a.shape[1]), dtype=torch.float32,
                    device=dt.device)
    y = torch.empty_like(dt)
    for t0 in range(0, t, SCAN_BLOCK):
        t1 = min(t0 + SCAN_BLOCK, t)
        decay = torch.exp(dt[:, t0:t1, :, None] * a)        # (B, L, DI, N)
        states = u[:, t0:t1, :, None] * bm[:, t0:t1, None, :]
        for i in range(t1 - t0):
            h = states[:, i].addcmul_(decay[:, i], h)       # kept as h_t
        y[:, t0:t1] = (states * cm[:, t0:t1, None, :]).sum(-1)
        del decay, states
    return y


def _ssm(p, h, s, mm):
    t = h.shape[1]
    x, z = mm(h, p["in_proj"]).chunk(2, dim=-1)
    conv = torch.zeros_like(x)
    for j in range(s["w"]):         # y[t] = sum_j band[j] * x[t - j]
        conv[:, j:] += p["conv_band"][j] * x[:, :t - j]
    x = F.silu(conv)
    dbc = mm(x, p["x_proj"])
    dt_low, bm, cm = dbc.split([s["r"], s["n"], s["n"]], dim=-1)
    dt = F.softplus(mm(dt_low, p["dt_proj"]) + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y = _scan(dt, dt * x, bm, cm, a) + p["d_skip"] * x
    return mm(y * F.silu(z), p["out_proj"])


def _mlp(p, h, mm):
    return mm(F.silu(mm(h, p["wi_gate"])) * mm(h, p["wi_up"]), p["wo"])


def forward_last(config: dict, weights: dict, tokens: torch.Tensor,
                 control: str | None = None) -> torch.Tensor:
    """The last-position logits (B, V), float32, of prompts ``tokens``
    (B, S), computed whole on ``tokens``' device.  With ``control="fp8"``
    every matrix product's operands are rounded to float8 e4m3 first."""
    s = _sizes(config)
    eps = float(config["rms_norm_eps"])
    window = int(config["attn_window_size"])
    mm = _matmul_fp8 if control == "fp8" else _matmul
    f32 = {"dtype": torch.float32}
    x = weights["embed"].to(**f32)[tokens]
    for i, p in enumerate(weights["layers"]):
        p = {k: ({kk: vv.to(**f32) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(**f32))
             for k, v in p.items()}
        h = _rms_norm(x, p["ln1"], eps)
        attn = _attention(p["attn"], h, s, config,
                          None if layer_is_global(config, i) else window, mm)
        ssm = _ssm(p["ssm"], h, s, mm)
        x = x + 0.5 * (_rms_norm(attn, p["norm_attn"], eps)
                       + _rms_norm(ssm, p["norm_ssm"], eps))
        del h, attn, ssm
        x = x + _mlp(p["ffn"], _rms_norm(x, p["ln2"], eps), mm)
    last = _rms_norm(x[:, -1], weights["final_norm"].to(**f32), eps)
    return mm(last, weights["lm_head"].to(**f32))


def checks(config: dict, answers: list, control: str | None,
           device) -> tuple[dict, dict]:
    """``({"max_rel_logit_err": widest gap}, info)`` over ``answers``,
    each ``(label, tokens (B, S), last logits (B, V), seed)``: for every
    prompt of every answer, ``max|logits - reference| / max|reference|``
    over its last position, the reference computed here from the prompt
    and the weights :func:`init_weights` draws from the seed on
    ``device``, ``ROWS`` prompts at a time.  With ``control`` (one of
    :data:`CONTROLS`) the reference in that precision stands in the
    program's place.  ``info`` records how often the program's first
    token (its logits' argmax) is the reference's, and the widest gap by
    which that token's reference logit lies below the reference's best,
    over ``max|reference|``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(answers[0][3]) % (1 << 63))
    weights = init_weights(config, g, device)
    worst, agree, gap, prompts = 0.0, 0, 0.0, 0
    for _label, tokens, logits, _seed in answers:
        tokens = torch.as_tensor(tokens).to(device)
        got = torch.as_tensor(logits).to(device, torch.float32)
        prompts += tokens.shape[0]
        for r0 in range(0, tokens.shape[0], ROWS):
            rows = tokens[r0:r0 + ROWS]
            want = forward_last(config, weights, rows)
            have = got[r0:r0 + ROWS] if control is None else \
                forward_last(config, weights, rows, control)
            if have.shape != want.shape:
                return {"max_rel_logit_err": math.inf}, {}
            scale = want.abs().amax(dim=-1)
            err = ((have - want).abs().amax(dim=-1) / scale).max().item()
            if not math.isnan(worst) and (math.isnan(err) or err > worst):
                worst = err
            first = have.argmax(dim=-1, keepdim=True)
            agree += int((first[:, 0] == want.argmax(dim=-1)).sum())
            lost = (want.amax(dim=-1) - want.gather(-1, first)[:, 0]) / scale
            gap = max(gap, lost.max().item())
            del want, have
    return {"max_rel_logit_err": worst}, {
        "prompts_checked": prompts,
        "first_token_agrees": agree, "first_token_gap": gap}
