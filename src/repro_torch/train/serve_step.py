"""Serving steps: prefill (build caches from a prompt) and decode (one
token against the caches), and a greedy generation loop over them.

The caches are updated in place (see ``models.kv_cache``): a decode step
returns a state that shares its tensors with the state it was given, so a
state is consumed by the step it is passed to.

Codebook models take ``(B, K, S)`` prompts and ``(B, K, 1)`` decode
tokens, and give ``(B, K, V)`` last logits.  A VLM's ``patch_embeds``
go to the prefill only; a cross-attention model's ``cond`` goes to the
prefill and to every decode step.

On a slot mesh (``mesh=``; ``launch.mesh.DeviceMesh``, one process
driving every slot) the steps take the reference's parameter tree
placed by the sharding rules (:func:`place_params`: FSDP blocks, as the
train step's ``MeshTrainState`` holds them).  A call gathers the
compute copy of each distinct device among the groups it runs
(``train_step._gather``, counted in ``train_step.sync_counts``), then
runs every data-parallel group (the ``pod`` x ``data`` coordinates,
``train_step.dp_groups``) on its slice of the batch, on the device of
the group's first slot, under
``sharding.rules.activate(mesh, group=g)``: the MLP's ``d_ff`` (and
MoE's experts) split over the group's ``model`` slots as in training,
attention with a cache whole on the group's device (its decode-time
``head_dim`` constraint counted in ``rules.constraint_counts``).  The
state's ``caches`` is then one list of layer caches a group, each on its
group's device; the last logits are gathered onto the lead slot's
device.  A batch that does not split over the groups is replicated over
them, as the rules place it, and run once, by group 0.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import transformer as tf
from repro_torch.sharding import rules
from repro_torch.train import train_step as ts

__all__ = ["ServeState", "make_prefill", "make_decode_step", "pick",
           "greedy_generate", "place_params", "serving_groups"]


class ServeState(NamedTuple):
    caches: list   # per-layer caches; on a mesh, one such list a dp group
    length: int    # positions consumed so far (image tokens included)


def place_params(model: tf.Transformer, mesh: DeviceMesh,
                 shardings: Optional[dict] = None) -> dict:
    """``model``'s parameters as the reference's tree (stacked by cycle,
    in ``cfg.param_dtype``) placed on ``mesh`` by ``shardings`` (by
    default the rules': ``rules.param_shardings``)."""
    dtype = tf.dtype_of(model.cfg.param_dtype)
    tree = tf.stack_by_cycle(model.cfg, {
        n: p.detach().to(dtype) for n, p in model.named_parameters()})
    sh = shardings or rules.param_shardings(mesh, tree)
    return rules.tree_map(lambda t, s: s.place(t), tree, sh)


def make_prefill(cfg: ModelConfig, max_len: int,
                 mesh: Optional[DeviceMesh] = None):
    """``max_len`` counts every position: a VLM's image tokens too.  With
    ``mesh`` the prefill of a :func:`place_params` tree (module
    docstring)."""
    if mesh is not None:
        return _mesh_step(cfg, mesh, make_prefill(cfg, max_len))

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


def make_decode_step(cfg: ModelConfig, mesh: Optional[DeviceMesh] = None):
    """With ``mesh`` the decode step of a :func:`place_params` tree and a
    mesh prefill's state (module docstring)."""
    if mesh is not None:
        return _mesh_step(cfg, mesh, make_decode_step(cfg))

    def decode_step(model: tf.Transformer, state: ServeState,
                    token: torch.Tensor, cond: Optional[torch.Tensor] = None):
        """token: (B, 1) ints, or (B, K, 1) -> (logits, ServeState)."""
        logits, new_caches, _ = model(token, caches=state.caches,
                                      mode="decode", start_pos=state.length,
                                      cond=cond)
        return logits[:, -1], ServeState(caches=new_caches,
                                         length=state.length + 1)
    return decode_step


def serving_groups(mesh: DeviceMesh, rows: int) -> int:
    """The data-parallel groups a mesh step of a batch of ``rows`` runs:
    every group, or only group 0 when the batch does not split."""
    n = rules.axis_size_of(mesh, "dp")
    return n if rows % n == 0 else 1


def _mesh_step(cfg: ModelConfig, mesh: DeviceMesh, one_group):
    """``one_group`` (a one-device prefill or decode step) run by every
    data-parallel group of ``mesh`` from its compute copy."""
    groups = ts.dp_groups(mesh)
    keys = [ts._device_key(d) for d in groups]
    compute: dict = {}          # device key -> the gathered trainable copy
    lead = torch.device(mesh.devices.flat[0])

    def step(params: dict, first, *rest, **kw):
        """``first``: the prompt (prefill) or a :class:`ServeState`
        (decode, then the token)."""
        decode = isinstance(first, ServeState)
        rows = (rest[0] if decode else first).shape[0]
        n = serving_groups(mesh, rows)
        w = rows // n
        for d, k in zip(groups[:n], keys[:n]):
            if k not in compute:
                compute[k] = ts._compute_copy(cfg, d)
        leaves = rules.tree_items(params)
        names = ts._leaf_names(cfg, compute[keys[0]])

        def part(x, g):
            return None if x is None else x[g * w:(g + 1) * w].to(groups[g])
        lasts, caches = [], []
        with torch.no_grad():
            for k in dict.fromkeys(keys[:n]):      # once a distinct device
                ts._gather(compute[k], leaves, names)
            for g in range(n):
                head = ServeState(first.caches[g], first.length) if decode \
                    else part(first, g)
                with rules.activate(mesh, group=g):
                    last, state = one_group(
                        compute[keys[g]], head, *(part(a, g) for a in rest),
                        **{k: part(v, g) for k, v in kw.items()})
                lasts.append(last.to(lead))
                caches.append(state.caches)
        return torch.cat(lasts), ServeState(caches=caches,
                                            length=state.length)
    return step


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
