"""Cell construction: (architecture x shape cell) -> a function to count.

The reference's ``repro.launch.cells`` over the port's slot mesh.  Its
first part is the placements its cells attach to a train state and to
the KV/SSM caches.  A state is the reference's tree
(``train_step.state_tree``: ``params``, ``opt/{step, mu, nu}``, ``step``;
caches as ``transformer.stack_caches`` lays them out), of tensors or of
anything with a ``.shape``.

:func:`build_cell` gives what the dry run (``launch/dryrun.py``) counts
for one of the 40 assignment cells: the train step, the prefill or the
decode step on the mesh, its arguments as ``meta`` tensors in the
reference's trees (so a full-size config needs no memory), and their
placements by the sharding rules.  The function takes the arguments as
global tensors and takes each slot's block of them as a view
(``placement.place_views``): on ``meta`` no data moves, as the
reference's jitted function receives its arguments already placed.
:func:`MODEL_FLOPS` is the roofline's analytic model-flops term.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, SHAPE_CELLS, ShapeCell, \
    get_config
from repro_torch.launch import input_specs as ispec
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import kv_cache as kvc
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWState, adamw
from repro_torch.sharding import rules
from repro_torch.sharding.placement import NamedPlacement, P, place_views

__all__ = ["CellSpec", "build_cell", "MODEL_FLOPS", "_replicated",
           "_state_shardings", "_cache_shardings"]


class CellSpec(NamedTuple):
    fn: Any                 # callable to count
    args: tuple             # meta tensors in the reference's trees
    in_shardings: Any       # NamedPlacement trees beside ``args``
    out_shardings: Any
    donate: tuple           # argnums
    meta: dict


def _replicated(mesh: DeviceMesh) -> NamedPlacement:
    return NamedPlacement(mesh, P())


def _state_shardings(mesh: DeviceMesh, state_sds: dict) -> dict:
    """Placements beside a ``state_tree``-shaped train state: parameters
    and both AdamW moments by the parameter rules, the counters
    replicated."""
    opt = state_sds["opt"]
    return {"params": rules.param_shardings(mesh, state_sds["params"]),
            "opt": {"step": _replicated(mesh),
                    "mu": rules.param_shardings(mesh, opt["mu"]),
                    "nu": rules.param_shardings(mesh, opt["nu"])},
            "step": _replicated(mesh)}


def _cache_shardings(mesh: DeviceMesh, caches_sds, seq_shard: bool):
    return rules.cache_shardings(mesh, caches_sds, seq_axis_shard=seq_shard)


def _meta(spec) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def _views(tree, shardings):
    return rules.tree_map(lambda t, s: place_views(t, s.mesh, s.spec), tree,
                          shardings)


def _layer_caches(cfg: ModelConfig, tree: tuple, lo: int, hi: int,
                  length: int) -> list:
    """Per-layer caches (as ``transformer.init_caches`` builds them) of
    batch rows ``[lo, hi)`` of a ``stack_caches`` tree, as views, every
    cache ``length`` positions long."""
    period = len(tree)

    def take(node, c):
        if isinstance(node, (kvc.FullKVCache, kvc.RingKVCache)):
            return type(node)(k=node.k[c, lo:hi], v=node.v[c, lo:hi],
                              length=length)
        if isinstance(node, tuple):
            vals = [take(v, c) for v in node]
            return type(node)(*vals) if hasattr(node, "_fields") else \
                tuple(vals)
        return node[c, lo:hi]
    return [take(tree[i % period], i // period)
            for i in range(cfg.num_layers)]


def build_cell(arch: str, cell_name: str, mesh: DeviceMesh,
               cfg: ModelConfig | None = None, ce_chunk: int = 512,
               microbatches: int = 1) -> CellSpec:
    """The cell ``cell_name`` of ``arch`` (or of ``cfg``) on ``mesh``.

    The reference's dry-run posture: the SSM's plain path
    (``kernel_impl="ref"``) and MoE dispatch grouped by the
    data-parallel degree.  A decode cell runs one token against caches of
    ``seq_len`` positions, ``seq_len - 1`` of them written.
    """
    from repro_torch.train import serve_step as ss
    from repro_torch.train import train_step as ts

    cfg = cfg or get_config(arch)
    cell = SHAPE_CELLS[cell_name]
    dp = rules.axis_size_of(mesh, "dp")
    overrides: dict = {"kernel_impl": "ref"}
    if cfg.moe is not None:
        overrides["moe"] = dataclasses.replace(cfg.moe, groups=dp)
    cfg = dataclasses.replace(cfg, **overrides)
    model = tf.init_params(cfg, torch.Generator(), "meta", trainable=True)
    params_sds = tf.stack_by_cycle(cfg, dict(model.named_parameters()))
    meta = {"arch": arch, "cell": cell_name, "kind": cell.kind}

    if cell.kind == "train":
        state_sds = ts._meta_state(params_sds)
        batch_sds = {k: _meta(s) for k, s in ispec.train_batch_specs(
            cfg, cell.global_batch, cell.seq_len).items()}
        step = ts.make_train_step(cfg, adamw(lr=3e-4), ce_chunk=ce_chunk,
                                  microbatches=microbatches, mesh=mesh)
        state_sh = _state_shardings(mesh, state_sds)
        batch_sh = rules.batch_shardings(mesh, batch_sds)

        def train(state, batch):
            placed = ts.MeshTrainState(
                params=_views(state["params"], state_sh["params"]),
                opt=AdamWState(
                    step=state["opt"]["step"],
                    mu=_views(state["opt"]["mu"], state_sh["opt"]["mu"]),
                    nu=_views(state["opt"]["nu"], state_sh["opt"]["nu"])),
                step=state["step"], compute={}, sync={})
            new, metrics = step(placed, batch)
            return ts.state_tree(new), metrics
        return CellSpec(fn=train, args=(state_sds, batch_sds),
                        in_shardings=(state_sh, batch_sh),
                        out_shardings=(state_sh, None), donate=(0,),
                        meta=meta)

    params_sds = rules.tree_map(
        lambda t: torch.empty(t.shape, dtype=tf.dtype_of(cfg.param_dtype),
                              device="meta"), params_sds)
    params_sh = rules.param_shardings(mesh, params_sds)

    if cell.kind == "prefill":
        batch_sds = {k: _meta(s) for k, s in ispec.prefill_specs(
            cfg, cell.global_batch, cell.seq_len).items()}
        prefill = ss.make_prefill(cfg, max_len=cell.seq_len, mesh=mesh)

        def fn(params, batch):
            return prefill(_views(params, params_sh), batch["tokens"],
                           patch_embeds=batch.get("patch_embeds"),
                           cond=batch.get("cond"))

        batch_sh = rules.batch_shardings(mesh, batch_sds)
        return CellSpec(fn=fn, args=(params_sds, batch_sds),
                        in_shardings=(params_sh, batch_sh),
                        out_shardings=None, donate=(), meta=meta)

    # decode: one token against a cache of cell.seq_len
    seq_shard = cell_name == "long_500k"
    caches_sds = tf.stack_caches(cfg, tf.init_caches(
        cfg, cell.global_batch, cell.seq_len, "meta"))
    state_sds = ss.ServeState(
        caches=caches_sds,
        length=torch.empty((), dtype=torch.int32, device="meta"))
    tok_sds = {k: _meta(s) for k, s in ispec.decode_specs(
        cfg, cell.global_batch).items()}
    decode = ss.make_decode_step(cfg, mesh=mesh)
    n = ss.serving_groups(mesh, cell.global_batch)
    w = cell.global_batch // n
    length = cell.seq_len - 1

    def fn(params, state, batch):
        caches = [_layer_caches(cfg, state.caches, g * w, (g + 1) * w,
                                length) for g in range(n)]
        return decode(_views(params, params_sh),
                      ss.ServeState(caches=caches, length=length),
                      batch["token"], cond=batch.get("cond"))

    cache_sh = ss.ServeState(
        caches=_cache_shardings(mesh, caches_sds, seq_shard),
        length=_replicated(mesh))
    tok_sh = rules.batch_shardings(mesh, tok_sds)
    return CellSpec(fn=fn, args=(params_sds, state_sds, tok_sds),
                    in_shardings=(params_sh, cache_sh, tok_sh),
                    out_shardings=(None, cache_sh), donate=(1,), meta=meta)


# ---------------------------------------------------------------------------
# Analytic model FLOPs (roofline's MODEL_FLOPS term)
# ---------------------------------------------------------------------------

def MODEL_FLOPS(cfg: ModelConfig, cell: ShapeCell) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) for train; 2*N_active*D for
    forward-only cells.  D = processed tokens per step; N excludes
    embedding tables (standard convention)."""
    n_params = cfg.param_count()
    emb = cfg.vocab_size * cfg.d_model * max(cfg.num_codebooks, 1)
    head = 0 if cfg.tie_embeddings else emb
    n_body = n_params - emb - head
    if cfg.moe is not None:
        m = cfg.moe
        expert_params = cfg.num_layers * m.num_experts * 3 * cfg.d_model * m.d_ff_expert
        active = n_body - expert_params + expert_params * (m.top_k / m.num_experts)
    else:
        active = n_body
    # head matmul is real compute: add 2*D*V per token (forward)
    head_flops_per_tok = 2 * cfg.d_model * cfg.vocab_size * max(cfg.num_codebooks, 1)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * active * tokens + 3.0 * head_flops_per_tok * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * active * tokens + head_flops_per_tok * cell.global_batch
    tokens = cell.global_batch  # decode: 1 token per sequence
    return 2.0 * active * tokens + head_flops_per_tok * tokens
