"""The decoder stack of the LM stack, covering all ten architectures.

Layer kinds: ``attn`` (dense or MoE FFN, optional sliding window),
``attn_cross`` (MusicGen's cross-attention to the conditioning),
``rwkv`` (RWKV-6) and ``hybrid`` (Hymba's parallel attention + SSM
heads).  Inputs: token ids, or ``(B, K, S)`` codebook ids summed over
``K`` embeddings (logits ``(B, S, K, V)``); LLaVA's image patch
embeddings projected by ``mm_proj`` and prepended in train and prefill;
MusicGen's conditioning projected by ``cond_proj``.

A config maps to a *layer pattern* (one cycle of layer kinds, e.g.
Hymba's seven windowed + one global hybrid layer); the reference scans
that cycle ``num_layers / len(pattern)`` times over parameters stacked by
cycle.  Here :class:`Transformer` is an ``nn.Module`` holding one
:class:`Layer` per layer in an ``nn.ModuleList`` (layer ``c*P + i`` is
cycle ``c``, pattern position ``i``), and the scan is a loop over them.

Two builds.  The serving build (the default) holds each weight in the
dtype it is read in — the compute dtype for every matrix, the embedding
and the SSM's ``dt_bias``/``d_skip``; the parameter dtype for the norms,
the conv band, ``a_log``, MoE's ``router`` and RWKV's ``u``, which the
reference reads in f32 — so the
reference's cast at every ``dense`` call is a no-op; its parameters do
not require grad.  The trainable build (``trainable=True``) holds every
leaf in ``cfg.param_dtype`` with ``requires_grad=True`` and casts at each
use, as the reference does.  Trained (``mode="train"`` with grad
enabled) with ``cfg.remat != "none"``, each of its layers runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
cycle body).
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import kv_cache as kvc
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention_chunked import (chunked_attention,
                                                  head_slots)
from repro_torch.models.layers import (dense, dense_init, embed_init,
                                       init_attention, mlp, mlp_init,
                                       rms_norm, rms_norm_init, rope)
from repro_torch.runtime import trace
from repro_torch.sharding.rules import axis_size, shard

__all__ = ["build_pattern", "Layer", "Transformer", "init_params",
           "params_from_numpy", "params_to_numpy", "stack_by_cycle",
           "assign_from_tree", "init_caches", "stack_caches", "apply_layer",
           "dtype_of"]

#: leaves the reference reads as f32 (``.astype(float32)``); every other
#: leaf is read in the compute dtype
_PARAM_DTYPE_LEAVES = frozenset({"ln1", "ln2", "ln_x", "norm_attn",
                                 "norm_ssm", "final_norm", "q_norm",
                                 "k_norm", "ln_out", "conv_band", "a_log",
                                 "router", "u"})


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def build_pattern(cfg: ModelConfig):
    if cfg.rwkv_mode:
        return [("rwkv", None)]
    if cfg.family == "hybrid":
        p = cfg.local_global_period or 1
        if p > 1:
            return [("hybrid", cfg.sliding_window)] * (p - 1) + [("hybrid", None)]
        return [("hybrid", cfg.sliding_window)]
    if cfg.local_global_period and cfg.local_global_period > 1:
        p = cfg.local_global_period
        return [("attn", cfg.sliding_window)] * (p - 1) + [("attn", None)]
    kind = "attn_cross" if cfg.cross_attn else "attn"
    return [(kind, cfg.sliding_window)]


def _checked_pattern(cfg: ModelConfig) -> list:
    pattern = build_pattern(cfg)
    if cfg.num_layers % len(pattern):
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} % "
                         f"pattern {len(pattern)}")
    return pattern


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _leaf(name: str, value: torch.Tensor, cfg: ModelConfig, device,
          trainable: bool):
    t = torch.as_tensor(value).to(device=device,
                                  dtype=dtype_of(cfg.param_dtype))
    if not trainable and name not in _PARAM_DTYPE_LEAVES:
        t = t.to(dtype_of(cfg.compute_dtype))
    return nn.Parameter(t, requires_grad=trainable)


def _leaves(name: str, value, cfg: ModelConfig, device, trainable: bool):
    """A leaf, or an ``nn.ParameterDict`` of a dict of leaves."""
    if isinstance(value, dict):
        return nn.ParameterDict({k: _leaf(k, v, cfg, device, trainable)
                                 for k, v in value.items()})
    return _leaf(name, value, cfg, device, trainable)


class Layer(nn.Module):
    """One decoder layer with the reference's leaf names: ``ln1``/``ln2``
    and ``rwkv`` for ``rwkv``; otherwise ``ln1``/``ln2``, ``attn``, and
    ``ffn`` or ``moe``, plus ``ln_x``/``xattn`` for ``attn_cross`` and
    ``ssm``/``norm_attn``/``norm_ssm`` for ``hybrid``."""

    def __init__(self, kind: str, window: Optional[int], tree: dict,
                 cfg: ModelConfig, device, trainable: bool = False):
        super().__init__()
        if kind not in ("attn", "attn_cross", "rwkv", "hybrid"):
            raise ValueError(f"unknown layer kind {kind!r}")
        self.kind, self.window = kind, window
        for name, value in tree.items():
            setattr(self, name, _leaves(name, value, cfg, device, trainable))


class Transformer(nn.Module):
    """The decoder: ``embed`` ((V, D), or (K, V, D) with codebooks),
    ``mm_proj`` ({w1, w2}, image tokens) and ``cond_proj``
    (cross-attention) when the config has them, ``layers`` (one
    :class:`Layer` each), ``final_norm`` and ``lm_head`` ((D, V), or
    (K, D, V); absent with tied embeddings).  ``trainable``: f32 leaves
    that require grad (see the module's docstring)."""

    def __init__(self, cfg: ModelConfig, embed, layers: Iterable[dict],
                 final_norm, lm_head=None, *, device,
                 trainable: bool = False, mm_proj: Optional[dict] = None,
                 cond_proj=None):
        super().__init__()
        pattern = _checked_pattern(cfg)
        self.cfg = cfg
        self.embed = _leaf("embed", embed, cfg, device, trainable)
        for name, value, wanted in (
                ("mm_proj", mm_proj, bool(cfg.num_image_tokens)),
                ("cond_proj", cond_proj,
                 cfg.cross_attn and bool(cfg.cond_dim))):
            if (value is not None) != wanted:
                raise ValueError(f"{cfg.name}: {name} "
                                 f"{'missing' if wanted else 'not expected'}")
            setattr(self, name, None if value is None else
                    _leaves(name, value, cfg, device, trainable))
        self.layers = nn.ModuleList()
        for i, tree in enumerate(layers):   # one at a time: f32 leaves drop
            kind, window = pattern[i % len(pattern)]
            self.layers.append(Layer(kind, window, tree, cfg, device,
                                     trainable))
        if len(self.layers) != cfg.num_layers:
            raise ValueError(f"{len(self.layers)} layers given, config has "
                             f"{cfg.num_layers}")
        self.final_norm = _leaf("final_norm", final_norm, cfg, device,
                                trainable)
        self.lm_head = None if cfg.tie_embeddings else \
            _leaf("lm_head", lm_head, cfg, device, trainable)

    def forward(self, tokens: torch.Tensor, caches: Optional[list] = None,
                mode: str = "train", start_pos: int = 0, head: bool = True,
                patch_embeds: Optional[torch.Tensor] = None,
                cond: Optional[torch.Tensor] = None):
        """Returns (logits_or_hidden, new_caches, aux_loss).

        mode: "train" (no cache) | "prefill" (write caches) | "decode" (1
        token).  ``start_pos``: absolute position of the first token
        (decode: the cache length).  ``head=False`` returns the final-norm
        hidden states instead of logits.  ``tokens``: (B, S) ids, or
        (B, K, S) with codebooks.  ``patch_embeds`` (B, N, vision_dim):
        image tokens prepended in train and prefill (positions count
        them).  ``cond`` (B, L, cond_dim): what ``attn_cross`` layers
        attend to, passed at every step.
        """
        cfg = self.cfg
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mode must be train, prefill or decode, got "
                             f"{mode!r}")
        if (caches is None) != (mode == "train"):
            raise ValueError(f"mode {mode!r} {'needs' if caches is None else 'takes no'}"
                             f" caches")
        dtype = dtype_of(cfg.compute_dtype)
        x = self._embed_inputs(tokens, patch_embeds, mode)
        positions = start_pos + torch.arange(x.shape[1], device=x.device)
        x = shard(x, "dp", None, None)
        if cond is not None and self.cond_proj is not None:
            cond = dense(self.cond_proj, cond.to(dtype))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = None if caches is None else []
        remat = (mode == "train" and cfg.remat != "none"
                 and torch.is_grad_enabled() and self.embed.requires_grad)
        for i, layer in enumerate(self.layers):
            if remat:
                x, nc, a = checkpoint(apply_layer, layer, cfg, x, positions,
                                      None, mode, cond, use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                x, nc, a = apply_layer(layer, cfg, x, positions,
                                       None if caches is None else caches[i],
                                       mode, cond)
            aux = aux + a
            if caches is not None:
                new_caches.append(nc)
        x = rms_norm(self.final_norm, x, cfg.norm_eps)
        if not head:
            return x, new_caches, aux
        head_w = self.embed if cfg.tie_embeddings else self.lm_head
        head_w = head_w.to(x.dtype)
        if cfg.num_codebooks:          # (K, D, V) -> logits (B, S, K, V)
            logits = torch.einsum("bsd,kdv->bskv", x, head_w)
        elif cfg.tie_embeddings:
            logits = x @ head_w.T
        else:
            logits = x @ head_w
        return logits, new_caches, aux

    def _embed_inputs(self, tokens, patch_embeds, mode):
        cfg = self.cfg
        dtype = dtype_of(cfg.compute_dtype)
        embed = self.embed.to(dtype)
        if cfg.num_codebooks:      # (B, K, S) -> sum of codebook embeddings
            x = sum(embed[i][tokens[:, i]] for i in range(cfg.num_codebooks))
        else:
            x = embed[tokens]
        if cfg.family in ("dense", "vlm") and "gemma" in cfg.name:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
        if cfg.num_image_tokens and patch_embeds is not None \
                and mode != "decode":
            pe = patch_embeds.to(dtype)
            img = dense(self.mm_proj["w2"], F.gelu(
                dense(self.mm_proj["w1"], pe), approximate="tanh"))
            x = torch.cat([img, x], dim=1)
        return x


# ---------------------------------------------------------------------------
# Parameters: seeded init on the device, or carried across from JAX
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str,
                device) -> dict:
    d = cfg.d_model
    p = {"ln1": rms_norm_init(d, device), "ln2": rms_norm_init(d, device)}
    if kind == "rwkv":
        p["rwkv"] = rwkv6.init_rwkv_layer(gen, cfg, device)
        return p
    p["attn"] = init_attention(gen, cfg, device)
    if kind == "attn_cross":
        p["ln_x"] = rms_norm_init(d, device)
        p["xattn"] = init_attention(gen, cfg, device, cross=True)
    if kind == "hybrid":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, device)
        p["norm_attn"] = rms_norm_init(d, device)
        p["norm_ssm"] = rms_norm_init(d, device)
    if cfg.moe is not None:
        p["moe"] = moe_mod.init_moe(gen, d, cfg.moe, device)
    else:
        p["ffn"] = mlp_init(gen, d, cfg.d_ff, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                trainable: bool = False) -> Transformer:
    """A model with the reference's initial distributions, drawn on
    ``device`` from ``generator`` (a generator of that device).  No weight
    file is read; the values differ from JAX's for the same seed.
    ``trainable``: the trainable build (f32 leaves that require grad).
    Layers are drawn one at a time, so each layer's f32 draw is dropped
    once its leaves are cast."""
    pattern = _checked_pattern(cfg)
    d, v, k = cfg.d_model, cfg.vocab_size, cfg.num_codebooks
    embed = torch.stack([embed_init(generator, v, d, device)
                         for _ in range(k)]) if k else \
        embed_init(generator, v, d, device)
    mm_proj = {"w1": dense_init(generator, cfg.vision_dim, d, device),
               "w2": dense_init(generator, d, d, device)} \
        if cfg.num_image_tokens else None
    cond_proj = dense_init(generator, cfg.cond_dim, cfg.cond_dim, device) \
        if cfg.cross_attn and cfg.cond_dim else None
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = torch.stack([dense_init(generator, d, v, device)
                               for _ in range(k)]) if k else \
            dense_init(generator, d, v, device)
    layers = (_init_layer(generator, cfg, pattern[i % len(pattern)][0], device)
              for i in range(cfg.num_layers))
    return Transformer(cfg, embed, layers, rms_norm_init(d, device),
                       lm_head, device=device, trainable=trainable,
                       mm_proj=mm_proj, cond_proj=cond_proj)


def params_from_numpy(tree: dict, cfg: ModelConfig, device,
                      trainable: bool = False) -> Transformer:
    """Load the reference's parameter pytree, as numpy
    (``jax.tree.map(np.asarray, tf.init_params(key, cfg))``), into a model
    (the trainable build with ``trainable``).

    The reference stacks each pattern position over cycles: layer
    ``c*P + i`` is ``tree["layers"][i][...][c]``.  ``dense`` weights keep
    their ``(d_in, d_out)`` layout (the port applies ``x @ w`` too).
    """
    pattern = _checked_pattern(cfg)
    period = len(pattern)

    def take(node, c):
        if isinstance(node, dict):
            return {k: take(v, c) for k, v in node.items()}
        return np.array(node[c])       # a writable copy of one cycle

    def top(name):
        node = tree.get(name)
        if isinstance(node, dict):
            return {k: np.array(v) for k, v in node.items()}
        return None if node is None else np.array(node)

    layers = (take(tree["layers"][i % period], i // period)
              for i in range(cfg.num_layers))
    return Transformer(cfg, top("embed"), layers, top("final_norm"),
                       top("lm_head"), device=device, trainable=trainable,
                       mm_proj=top("mm_proj"), cond_proj=top("cond_proj"))


def _tree_index(name: str, period: int) -> tuple[tuple, Optional[int]]:
    """(path in the reference's tree, cycle) of a parameter name of
    :class:`Transformer`: ``layers.<c*P+i>.<a>.<b>`` is
    ``("layers", i, a, b)`` at cycle ``c``; a top-level leaf has none."""
    parts = name.split(".")
    if parts[0] != "layers":
        return tuple(parts), None
    layer = int(parts[1])
    return ("layers", layer % period) + tuple(parts[2:]), layer // period


def stack_by_cycle(cfg: ModelConfig, named: dict) -> dict:
    """The reference's parameter tree of ``named`` — tensors keyed as
    ``Transformer.named_parameters()`` names them (parameters, or moments
    of them) — with each pattern position's leaves stacked over cycles."""
    period = len(_checked_pattern(cfg))
    layers = tuple({} for _ in range(period))    # the reference's tuple
    tree: dict = {"layers": layers}
    groups: dict = {}
    for name, t in named.items():
        path, cycle = _tree_index(name, period)
        if cycle is None:           # a top-level leaf, or mm_proj's
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        else:
            groups.setdefault(path, {})[cycle] = t
    for path, by_cycle in groups.items():
        node = layers[path[1]]
        for k in path[2:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.stack([by_cycle[c]
                                      for c in sorted(by_cycle)])
    return tree


def assign_from_tree(cfg: ModelConfig, named: dict, tree: dict) -> None:
    """Copy the reference's tree (stacked by cycle, as
    :func:`stack_by_cycle` builds it) into the tensors of ``named`` in
    place; a shape that differs raises."""
    period = len(_checked_pattern(cfg))
    with torch.no_grad():
        for name, t in named.items():
            path, cycle = _tree_index(name, period)
            src = tree
            for k in path:
                src = src[k]
            src = torch.as_tensor(src if cycle is None else src[cycle])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: tree leaf of shape "
                                 f"{tuple(src.shape)}, model {tuple(t.shape)}")
            t.copy_(src)


def params_to_numpy(model: Transformer) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's parameter
    tree (stacked by cycle) as numpy, in ``cfg.param_dtype``."""
    dtype = dtype_of(model.cfg.param_dtype)
    named = {n: p.detach().to(dtype) for n, p in model.named_parameters()}

    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(host(v) for v in node)
        return node.cpu().numpy()
    return host(stack_by_cycle(model.cfg, named))


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int, device) -> list:
    """One cache per layer: the RWKV state for ``rwkv`` layers; otherwise
    a KV cache (ring when the layer's window is shorter than ``max_len``),
    and for hybrid layers with the SSM state."""
    pattern = _checked_pattern(cfg)
    dtype = dtype_of(cfg.compute_dtype)
    caches = []
    for i in range(cfg.num_layers):
        kind, window = pattern[i % len(pattern)]
        if kind == "rwkv":
            caches.append(rwkv6.init_rwkv_state(batch, cfg, dtype,
                                                device=device))
            continue
        attn_c = kvc.init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                   cfg.head_dim, window, dtype,
                                   device=device)
        caches.append((attn_c, ssm_mod.init_ssm_state(batch, cfg, dtype,
                                                      device=device))
                      if kind == "hybrid" else attn_c)
    return caches


def stack_caches(cfg: ModelConfig, caches: list) -> tuple:
    """The reference's cache tree of per-layer ``caches`` (as
    :func:`init_caches` builds them): one entry per pattern position, each
    cache field stacked over cycles (a ring or full cache's ``length``
    becomes a ``(cycles,)`` int32 tensor).  ``caches`` built on the
    ``meta`` device give a tree of shapes for ``rules.cache_shardings``."""
    period = len(_checked_pattern(cfg))

    def stack(items):
        first = items[0]
        if isinstance(first, tuple):
            fields = [stack([it[j] for it in items])
                      for j in range(len(first))]
            return type(first)(*fields) if hasattr(first, "_fields") \
                else tuple(fields)
        if isinstance(first, torch.Tensor):
            return torch.stack(items)
        return torch.tensor(items, dtype=torch.int32)
    return tuple(stack(caches[i::period]) for i in range(period))


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _qkv(p, x, cfg, positions):
    """q, k, v of the heads whose columns ``p``'s ``wq``/``wk``/``wv``
    hold, qk-normed and rotated."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = dense(p["wq"], x).reshape(b, s, -1, dh)
    k = dense(p["wk"], x).reshape(b, s, -1, dh)
    v = dense(p["wv"], x).reshape(b, s, -1, dh)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _project_qkv(p, x, cfg, positions):
    s = x.shape[1]
    q, k, v = _qkv(p, x, cfg, positions)
    if cfg.num_kv_heads % max(axis_size("tp"), 1) == 0 or s > 1:
        q = shard(q, "dp", None, "tp", None)
        k = shard(k, "dp", None, "tp", None)
        v = shard(v, "dp", None, "tp", None)
    else:
        # decode with TP > KV heads: head_dim over tp, as the cache is
        q = shard(q, "dp", None, None, "tp")
        k = shard(k, "dp", None, None, "tp")
        v = shard(v, "dp", None, None, "tp")
    return q, k, v


def _self_attention(p, x, cfg, positions, cache, window, mode):
    b, s, _ = x.shape
    if cache is None:       # train, or a prefill that writes no cache
        nbytes = x.numel() * x.element_size()
        slots = head_slots(cfg.num_heads, cfg.num_kv_heads, nbytes, nbytes)
        if slots is not None:
            return _split_attention(p, x, cfg, positions, window,
                                    slots), None
    q, k, v = _project_qkv(p, x, cfg, positions)
    with trace.span("attention"):
        if mode == "decode":
            new_cache = kvc.decode_write(cache, k, v)
            kk, vv, kpos, kmask = kvc.cache_view(new_cache)
            out = chunked_attention(q, kk.to(x.dtype), vv.to(x.dtype),
                                    q_positions=positions, k_positions=kpos,
                                    window=window, softcap=cfg.attn_softcap,
                                    kv_mask=kmask)
        else:
            new_cache = None if cache is None else \
                kvc.prefill_write(cache, k, v)
            out = chunked_attention(q, k, v, q_positions=positions,
                                    k_positions=positions, window=window,
                                    softcap=cfg.attn_softcap)
    return dense(p["wo"], out.reshape(b, s, -1)), new_cache


def _split_attention(p, x, cfg, positions, window, slots):
    """Self-attention split by heads over ``model`` slots
    (``attention_chunked.head_slots``): slot ``m`` projects its heads
    from its columns of ``wq``/``wk``/``wv``, rotates and attends them,
    and multiplies by its rows of ``wo`` on its own device; the partials
    are summed in f32 on ``x``'s device."""
    b, s, _ = x.shape
    dh, group = cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    repeat = slots[0][3]
    # a slot's range of a weight is one chunk of it, so the backward
    # writes the weight's gradient once; two slots may read one repeated
    # K/V head, so those ranges are slices
    chunks = {n: p[n].chunk(len(slots), 0 if n == "wo" else -1)
              for n in ("wq", "wo") + (() if repeat else ("wk", "wv"))}
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for m, (dev, (q_lo, q_hi), (kv_lo, kv_hi), _) in enumerate(slots):
        w = {n: c[m] for n, c in chunks.items()}
        if repeat:
            kv = slice(kv_lo * dh, kv_hi * dh)
            w.update(wk=p["wk"][:, kv], wv=p["wv"][:, kv])
        w.update((n, p[n]) for n in ("q_norm", "k_norm") if n in p)
        w = {n: t.to(dev) for n, t in w.items()}
        pos = positions.to(dev)
        q, k, v = _qkv(w, x.to(dev), cfg, pos)
        if repeat:      # one K/V head a query head, the slot's heads
            heads = slice(q_lo - kv_lo * group, q_hi - kv_lo * group)
            k = torch.repeat_interleave(k, group, dim=2)[:, :, heads]
            v = torch.repeat_interleave(v, group, dim=2)[:, :, heads]
        with trace.span("attention"):
            out = chunked_attention(q, k, v, q_positions=pos,
                                    k_positions=pos, window=window,
                                    softcap=cfg.attn_softcap)
        part = dense(w["wo"], out.reshape(b, s, -1))
        y = y + part.to(x.device, torch.float32)
    return y.to(x.dtype)


def _cross_attention(p, x, cfg, cond):
    """Attention from ``x`` to the (projected) conditioning: no rope, no
    qk-norm, no mask."""
    b, s, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(p["wq"], x).reshape(b, s, kvh, h // kvh, dh)
    k = dense(p["wk"], cond).reshape(b, cond.shape[1], kvh, dh)
    v = dense(p["wv"], cond).reshape(b, cond.shape[1], kvh, dh)
    with trace.span("attention"):
        scores = torch.einsum("bskgd,btkd->bkgst", q.to(torch.float32),
                              k.to(torch.float32)) / math.sqrt(dh)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(x.dtype))
    return dense(p["wo"], out.reshape(b, s, h * dh))


def _ffn(layer, x, cfg, mode):
    """The dense MLP, or the MoE FFN (dropping over capacity only in train
    mode); returns (y, aux_loss)."""
    if cfg.moe is not None:
        out = moe_mod.moe_ffn(layer.moe, x, cfg.moe, cfg.mlp_act,
                              dropless=(mode != "train"))
        return out.y, out.aux_loss
    return mlp(layer.ffn, x, cfg.mlp_act), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def _rwkv_layer(layer, cfg, x, cache, mode):
    """An RWKV-6 layer; the carried token shifts are the normed inputs
    (``ln1``'s last row, ``ln2``'s last row)."""
    h = rms_norm(layer.ln1, x, cfg.norm_eps)
    if mode == "decode":
        y, s_new = rwkv6.rwkv_time_mix_step(layer.rwkv, h[:, 0], cfg, cache)
        y = y[:, None]
    else:
        y, s_new = rwkv6.rwkv_time_mix(
            layer.rwkv, h, cfg, state=cache if mode == "prefill" else None)
    x = x + y
    h2 = rms_norm(layer.ln2, x, cfg.norm_eps)
    y2, cm_tail = rwkv6.rwkv_channel_mix(
        layer.rwkv, h2, cfg,
        x_prev=cache.x_cm if (cache is not None and mode != "train") else None)
    new_cache = None
    if cache is not None:
        new_cache = rwkv6.RWKVState(s=s_new,
                                    x_tm=h[:, -1].to(cache.x_tm.dtype),
                                    x_cm=cm_tail.to(cache.x_cm.dtype))
    return x + y2, new_cache


def apply_layer(layer: Layer, cfg: ModelConfig, x, positions, cache, mode,
                cond=None):
    """One layer; returns (x, new_cache, aux_loss)."""
    if layer.kind == "rwkv":
        x, new_cache = _rwkv_layer(layer, cfg, x, cache, mode)
        return x, new_cache, torch.zeros((), dtype=torch.float32,
                                         device=x.device)
    h = rms_norm(layer.ln1, x, cfg.norm_eps)
    if layer.kind == "hybrid":
        attn_cache, ssm_state = cache if cache is not None else (None, None)
        attn_out, new_attn_cache = _self_attention(
            layer.attn, h, cfg, positions, attn_cache, layer.window, mode)
        if mode == "decode":
            ssm_out, new_ssm = ssm_mod.ssm_step(layer.ssm, h[:, 0], cfg,
                                                ssm_state)
            ssm_out = ssm_out[:, None]
        else:
            ssm_out, new_ssm = ssm_mod.ssm_forward(
                layer.ssm, h, cfg,
                state=ssm_state if mode == "prefill" else None)
        mixed = 0.5 * (rms_norm(layer.norm_attn, attn_out, cfg.norm_eps)
                       + rms_norm(layer.norm_ssm, ssm_out, cfg.norm_eps))
        x = x + mixed
        new_cache = None if cache is None else (new_attn_cache, new_ssm)
    else:
        y, new_cache = _self_attention(layer.attn, h, cfg, positions, cache,
                                       layer.window, mode)
        x = x + y
        if layer.kind == "attn_cross" and cond is not None:
            hx = rms_norm(layer.ln_x, x, cfg.norm_eps)
            x = x + _cross_attention(layer.xattn, hx, cfg, cond)
    h2 = rms_norm(layer.ln2, x, cfg.norm_eps)
    y, aux = _ffn(layer, h2, cfg, mode)
    return x + y, new_cache, aux
