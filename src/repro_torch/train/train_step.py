"""Train-step factory: forward (hidden) -> chunked CE -> grads -> AdamW.

The reference's ``repro.train.train_step`` on the port's trainable model
(``transformer.init_params(..., trainable=True)``: f32 parameters, compute
in ``cfg.compute_dtype``).  There is no jit: the step runs eagerly, its
gradients accumulate in each parameter's ``.grad``, and the optimizer
updates the parameters and moments in place (``optim.adamw``), so the
state a step is given is the state it returns, advanced.

:func:`state_tree` is the reference's ``TrainState`` tree (``params/...``
and ``opt/mu|nu/...`` stacked by cycle, ``opt/step``, ``step``), so a
checkpoint of either package restores in the other.

On a slot mesh (``launch.mesh.DeviceMesh``, one process driving every
slot) the step is data parallel with FSDP placement
(:class:`MeshTrainState`): the f32 parameters and the AdamW moments live
as blocks placed by the sharding rules (``launch.cells._state_shardings``:
split over ``pod``/``data`` and ``model`` where the rules say so), so
each distinct device holds one copy of the state in total.  A step

1. gathers each distinct compute device's full copy of the parameters
   (slots that share a device share one copy);
2. runs forward and backward for every dp group (the ``pod`` x ``data``
   coordinates) on its slice of the batch, on the device of the group's
   first slot, under ``sharding.rules.activate(mesh, group=g)``: tensor
   parallel along ``model`` — the MLP's ``d_ff``, the attention heads
   and the cross-entropy's vocabulary each split over the group's
   ``model`` slots where they divide (``rules.tp_slots``), slot ``m``
   computing its range on its own device from that range of the group's
   compute copy, the partials combined in f32 on the group's device,
   the rest (norms, the SSM, the embedding) on the group's device — and
   MoE's expert-parallel branch runs each ``model`` slot's experts on
   that slot's device; autograd carries each slot's gradients back
   through the copies into the group's compute copy;
3. reduces the groups' gradients to their mean in f32 — each group's
   gradient through ``optim.compression``'s compressor first when the
   step compresses (error feedback per group);
4. scatters the mean to the parameters' blocks;
5. runs one AdamW update on the blocks (the reference's decay rule).

:data:`sync_counts` is the census of those gathers, reductions and
scatters; ``rules.tp_counts`` is the census of the tensor-parallel
splits (a caller zeroes both before a step and reads both after it).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.cells import _state_shardings
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWState, adamw
from repro_torch.optim.compression import make_compressor
from repro_torch.runtime import trace
from repro_torch.sharding import rules
from repro_torch.sharding.placement import NamedPlacement, Placed, as_tensor
from repro_torch.train.loss import chunked_cross_entropy

__all__ = ["TrainState", "MeshTrainState", "init_train_state",
           "place_train_state", "make_loss_fn", "make_train_step",
           "state_tree", "load_state_tree", "dp_groups", "sync_mean",
           "sync_counts", "reset_sync_counts"]

#: The sync census of the mesh step, summed over steps (zero it with
#: :func:`reset_sync_counts`): ``gathers``, a leaf of the state's tree
#: copied whole into one device's compute copy; ``reductions``, a leaf's
#: gradient averaged over the dp groups; ``scatters``, a leaf's mean
#: gradient cut into its blocks; ``broadcasts``, an updated block copied
#: into a replica on another device; and the bytes each moved
#: (``*_bytes``; a reduction counts every group's wire bytes, compressed
#: when the sync compresses).
sync_counts = dict.fromkeys(
    ("gathers", "gather_bytes", "reductions", "reduction_bytes",
     "scatters", "scatter_bytes", "broadcasts"), 0)


def reset_sync_counts() -> None:
    for k in sync_counts:
        sync_counts[k] = 0


class TrainState(NamedTuple):
    params: tf.Transformer   # the trainable build
    opt: AdamWState          # moments keyed as ``params.named_parameters()``
    step: torch.Tensor       # int32 scalar


def _named(model: tf.Transformer) -> dict:
    return dict(model.named_parameters())


def _decayed(model: tf.Transformer) -> dict:
    """The leaves AdamW decays.  The reference's rule is ``ndim >= 2`` on
    its tree, where every layer leaf carries a leading cycle axis, so
    there every layer leaf is decayed, vectors (norm scales, ``d_skip``,
    ``dt_bias``) included; the port's per-layer leaves count that axis."""
    return {n: p.ndim + n.startswith("layers.") >= 2
            for n, p in model.named_parameters()}


class MeshTrainState(NamedTuple):
    """A train state on a slot mesh (see the module's docstring)."""
    params: dict     # the reference's params tree: Placed f32 blocks
    opt: AdamWState  # step on the lead slot's device; mu, nu like params
    step: torch.Tensor
    compute: dict    # device key -> trainable model: the compute copies
    sync: dict       # dp group -> CompressionState (error feedback)


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     optimizer: adamw, *, device=None,
                     mesh: Optional[DeviceMesh] = None,
                     shardings: Optional[dict] = None):
    """A fresh state: the trainable model drawn from ``generator`` (a
    generator of ``device``), zero moments, step 0.  On a ``mesh`` (draw
    on its lead slot's device) a :class:`MeshTrainState`: the drawn
    parameters placed by ``shardings`` (a ``_state_shardings`` tree; by
    default the rules'), the moments placed as zeros block by block, the
    drawn model kept as that device's compute copy."""
    if device is None:
        if mesh is None:
            raise ValueError("init_train_state needs device= or mesh=")
        device = mesh.devices.flat[0]
    model = tf.init_params(cfg, generator, device, trainable=True)
    if mesh is not None:
        return place_train_state(model, mesh, shardings)
    return TrainState(params=model, opt=optimizer.init(_named(model)),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.embed.device))


def place_train_state(model: tf.Transformer, mesh: DeviceMesh,
                      shardings: Optional[dict] = None) -> MeshTrainState:
    """A fresh :class:`MeshTrainState` of ``model``'s parameters (a
    trainable build on the mesh's lead slot's device, kept as that
    device's compute copy): the parameters placed by ``shardings`` (a
    ``_state_shardings`` tree; by default the rules'), zero moments made
    block by block, step 0."""
    params = tf.stack_by_cycle(model.cfg, {n: p.detach()
                                           for n, p in _named(model).items()})
    sh = shardings or _state_shardings(mesh, _meta_state(params))
    mu, nu = (rules.tree_map(lambda t, s: s.zeros(t.shape), params,
                             sh["opt"][k]) for k in ("mu", "nu"))
    params = rules.tree_map(lambda t, s: s.place(t), params, sh["params"])
    step = torch.zeros((), dtype=torch.int32, device=model.embed.device)
    return MeshTrainState(params=params,
                          opt=AdamWState(step=step.clone(), mu=mu, nu=nu),
                          step=step, compute={_device_key(step.device): model},
                          sync={})


def _meta_state(params: dict) -> dict:
    """A ``state_tree`` of ``meta`` tensors beside a parameter tree."""
    def meta(t):
        return torch.empty(t.shape, dtype=torch.float32, device="meta")
    scalar = torch.empty((), dtype=torch.int32, device="meta")
    return {"params": rules.tree_map(meta, params),
            "opt": {"step": scalar, "mu": rules.tree_map(meta, params),
                    "nu": rules.tree_map(meta, params)},
            "step": scalar}


def state_tree(state, device=None) -> dict:
    """The reference's ``TrainState`` tree of ``state``: parameters and
    moments stacked by cycle (new tensors; on a mesh the placed leaves
    themselves), the step counters.  With ``device="meta"`` only shapes
    and dtypes, a restore target that holds no memory."""
    if isinstance(state, MeshTrainState):
        def leaf(x):
            if device is None:
                return x
            if torch.device(device).type == "meta":
                return torch.empty(x.shape, dtype=x.dtype, device="meta")
            return as_tensor(x, device)
        return {"params": rules.tree_map(leaf, state.params),
                "opt": {"step": leaf(state.opt.step),
                        "mu": rules.tree_map(leaf, state.opt.mu),
                        "nu": rules.tree_map(leaf, state.opt.nu)},
                "step": leaf(state.step)}
    cfg = state.params.cfg

    def stacked(named):
        return tf.stack_by_cycle(cfg, {
            n: t.detach() if device is None else t.detach().to(device)
            for n, t in named.items()})

    def scalar(t):
        return t if device is None else t.to(device)
    return {"params": stacked(_named(state.params)),
            "opt": {"step": scalar(state.opt.step),
                    "mu": stacked(state.opt.mu), "nu": stacked(state.opt.nu)},
            "step": scalar(state.step)}


def load_state_tree(state, tree: dict):
    """Copy a :func:`state_tree`-shaped tree (a restored checkpoint) into
    ``state``'s tensors in place; returns the state with its counters.
    A :class:`MeshTrainState` takes the tree's leaves as they are where
    they are placed as its own are (a restore with ``shardings=``), else
    places them so."""
    if isinstance(state, MeshTrainState):
        def put(old: Placed, new):
            return NamedPlacement(old.mesh, old.spec).place(new)

        def counter(x):
            return torch.as_tensor(as_tensor(x)).to(
                device=state.step.device, dtype=torch.int32)
        return MeshTrainState(
            params=rules.tree_map(put, state.params, tree["params"]),
            opt=AdamWState(step=counter(tree["opt"]["step"]),
                           mu=rules.tree_map(put, state.opt.mu,
                                             tree["opt"]["mu"]),
                           nu=rules.tree_map(put, state.opt.nu,
                                             tree["opt"]["nu"])),
            step=counter(tree["step"]), compute=state.compute, sync={})
    cfg = state.params.cfg
    tf.assign_from_tree(cfg, _named(state.params), tree["params"])
    tf.assign_from_tree(cfg, state.opt.mu, tree["opt"]["mu"])
    tf.assign_from_tree(cfg, state.opt.nu, tree["opt"]["nu"])
    device = state.step.device
    return TrainState(
        params=state.params,
        opt=AdamWState(step=torch.as_tensor(tree["opt"]["step"]).to(
            device=device, dtype=torch.int32),
            mu=state.opt.mu, nu=state.opt.nu),
        step=torch.as_tensor(tree["step"]).to(device=device,
                                              dtype=torch.int32))


def make_loss_fn(cfg: ModelConfig, ce_chunk: int = 512):
    """(model, batch) -> (loss, aux). batch: {tokens, labels[, mask,
    patch_embeds, cond]}, on the model's device.  Codebook models average
    the CE of their K heads; image positions carry no loss; MoE's aux
    loss is added."""

    def loss_fn(model: tf.Transformer, batch: dict):
        hidden, _, aux = model(batch["tokens"], mode="train", head=False,
                               patch_embeds=batch.get("patch_embeds"),
                               cond=batch.get("cond"))
        head_w = model.embed if cfg.tie_embeddings else model.lm_head
        labels, mask = batch["labels"], batch.get("mask")
        if cfg.num_codebooks:          # one CE per codebook head (K, D, V)
            ce = sum(chunked_cross_entropy(hidden, head_w[i], labels[:, i],
                                           mask=mask, chunk=ce_chunk)[0]
                     for i in range(cfg.num_codebooks)) / cfg.num_codebooks
        else:
            if cfg.num_image_tokens:
                # image positions are inputs only: no next-token loss there
                hidden = hidden[:, cfg.num_image_tokens:]
            ce, _ = chunked_cross_entropy(hidden, head_w, labels, mask=mask,
                                          chunk=ce_chunk,
                                          transpose_head=cfg.tie_embeddings)
        return ce + aux, aux

    return loss_fn


def make_train_step(cfg: ModelConfig, optimizer: adamw, ce_chunk: int = 512,
                    microbatches: int = 1, *,
                    mesh: Optional[DeviceMesh] = None,
                    compression: Optional[str] = None):
    """``train_step(state, batch) -> (state, metrics)``; ``batch`` holds
    numpy or tensor arrays, moved to the model's device here.
    ``microbatches > 1`` splits the batch on its leading axis, sums the
    f32 grads over the splits and scales them by 1/m — the reference's
    arithmetic at 1/m the activation memory.  With ``mesh`` the step of a
    :class:`MeshTrainState` (module docstring): ``microbatches`` splits
    each dp group's slice, ``compression`` (``None``, ``"bf16"`` or
    ``"int8"``) compresses each group's gradient before the reduction."""
    if mesh is not None:
        return _make_mesh_train_step(cfg, optimizer, mesh, ce_chunk,
                                     microbatches, compression)
    if compression is not None:
        raise ValueError("compression applies to a mesh's gradient sync; "
                         "pass mesh=")
    loss_fn = make_loss_fn(cfg, ce_chunk)

    def train_step(state: TrainState, batch: dict):
        model = state.params
        device = model.embed.device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        params = _named(model)
        grads, loss, aux = _accumulate(model, loss_fn, batch, microbatches)
        with trace.span("adamw"):
            _, opt, metrics = optimizer.update(grads, state.opt, params,
                                               _decayed(model))
        metrics = dict(metrics, loss=loss, aux_loss=aux)
        return TrainState(params=model, opt=opt, step=state.step + 1), metrics

    return train_step


def _accumulate(model: tf.Transformer, loss_fn, batch: dict,
                microbatches: int):
    """Forward and backward of ``batch`` (on the model's device) in
    ``microbatches`` splits: the f32 grads summed over the splits and
    scaled by 1/m, taken out of ``.grad``; the mean loss and aux."""
    device = model.embed.device
    params = _named(model)
    for p in params.values():
        p.grad = None
    parts = [batch]
    if microbatches > 1:
        parts = [{k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + v.shape[1:])[i]
                  for k, v in batch.items()}
                 for i in range(microbatches)]
    loss = torch.zeros((), dtype=torch.float32, device=device)
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for one in parts:
        l, a = loss_fn(model, one)
        l.backward()
        loss, aux = loss + l.detach(), aux + a.detach()
    grads = {n: p.grad for n, p in params.items()}
    for p in params.values():
        p.grad = None
    if microbatches > 1:
        inv = 1.0 / microbatches
        for g in grads.values():
            g.mul_(inv)
        loss, aux = loss * inv, aux * inv
    return grads, loss, aux


# ---------------------------------------------------------------------------
# The step on a slot mesh
# ---------------------------------------------------------------------------

def dp_groups(mesh: DeviceMesh) -> list[torch.device]:
    """The device of each data-parallel group's first slot, in the order
    the batch splits over the groups (the ``("pod", "data")`` coordinate,
    pod major, as ``rules.batch_shardings`` places a batch)."""
    return [torch.device(rules.group_slots(mesh, g)[0])
            for g in range(rules.axis_size_of(mesh, "dp"))]


def _device_key(device) -> str:
    """A device's key in ``MeshTrainState.compute``: ``"cuda"`` and the
    current card's ``"cuda:<i>"`` are one device."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def _leaf_names(cfg: ModelConfig, model: tf.Transformer) -> dict:
    """Each key of the reference's parameter tree -> ``[(cycle, name)]``:
    the model's parameters stacked in that leaf (``cycle`` ``None`` for a
    leaf outside the layers)."""
    period = len(tf.build_pattern(cfg))
    out: dict = {}
    for name in _named(model):
        path, cycle = tf._tree_index(name, period)
        out.setdefault("/".join(map(str, path)), []).append((cycle, name))
    return out


def _compute_copy(cfg: ModelConfig, device) -> tf.Transformer:
    """A trainable model on ``device`` with no values yet: a gather fills
    it."""
    return tf.init_params(cfg, torch.Generator(), "meta",
                          trainable=True).to_empty(device=device)


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _wire_bytes(wire: dict) -> int:
    """Bytes of a wire tree (an int8 leaf is ``(codes, scale)``)."""
    return sum(_bytes(t) for v in wire.values()
               for t in (v if isinstance(v, tuple) else (v,)))


def sync_mean(group_grads, device, compression: Optional[str] = None,
              residuals: Optional[dict] = None) -> dict:
    """The data-parallel gradient reduction: the f32 mean, on ``device``,
    of the groups' gradients (an iterable of ``{name: tensor}``, one per
    group, consumed as it is drawn).  With ``compression`` (``"bf16"``,
    ``"int8"``) each group's gradient is compressed first — the wire
    tree is what a reduction across cards would move — with its error
    feedback residual in ``residuals[group]``."""
    init, compress, decompress = make_compressor(compression or "none")
    residuals = {} if residuals is None else residuals
    acc: dict = {}
    n = 0
    for g, grads in enumerate(group_grads):
        with torch.no_grad(), trace.span("sync_reduce"):
            if g not in residuals:
                residuals[g] = init(grads)
            wire, residuals[g] = compress(grads, residuals[g])
            sync_counts["reduction_bytes"] += _wire_bytes(wire)
            del grads
            for name, t in decompress(wire).items():
                t = t.to(device)
                if name in acc:
                    acc[name].add_(t)
                else:
                    acc[name] = t
            del wire
        n += 1
    with torch.no_grad(), trace.span("sync_reduce"):
        for t in acc.values():
            t.mul_(1.0 / n)
    return acc


def _make_mesh_train_step(cfg: ModelConfig, optimizer: adamw,
                          mesh: DeviceMesh, ce_chunk: int,
                          microbatches: int, compression: Optional[str]):
    loss_fn = make_loss_fn(cfg, ce_chunk)
    groups = dp_groups(mesh)

    def train_step(state: MeshTrainState, batch: dict):
        n = len(groups)
        lead = state.step.device
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        width = next(iter(batch.values())).shape[0]
        if width % n:
            raise ValueError(f"a batch of {width} does not split over the "
                             f"mesh's {n} data-parallel groups")
        width //= n
        for d in groups:
            if _device_key(d) not in state.compute:
                state.compute[_device_key(d)] = _compute_copy(cfg, d)
        leaves = rules.tree_items(state.params)
        names = _leaf_names(cfg, state.compute[_device_key(groups[0])])
        losses = []

        def group_grads():
            for g, dev in enumerate(groups):
                part = {k: v[g * width:(g + 1) * width].to(dev)
                        for k, v in batch.items()}
                with rules.activate(mesh, group=g):
                    grads, l, a = _accumulate(
                        state.compute[_device_key(dev)], loss_fn, part,
                        microbatches)
                losses.append((l.to(lead), a.to(lead)))
                yield grads

        with rules.activate(mesh):
            with torch.no_grad(), trace.span("sync_gather"):
                for dev in dict.fromkeys(_device_key(d) for d in groups):
                    _gather(state.compute[dev], leaves, names)
            acc = sync_mean(group_grads(), lead, compression, state.sync)
            sync_counts["reductions"] += len(leaves)
            with torch.no_grad(), trace.span("sync_scatter"):
                blocks = _scatter(acc, leaves, names)
        pb, gb, mb, vb, db = {}, {}, {}, {}, {}
        mu = dict(rules.tree_items(state.opt.mu))
        nu = dict(rules.tree_items(state.opt.nu))
        for key, placed in leaves:
            for c, _, block in placed.unique_blocks():
                k = f"{key}@{c}"
                pb[k], gb[k] = block, blocks.pop((key, c))
                mb[k], vb[k] = mu[key].blocks[c], nu[key].blocks[c]
                db[k] = placed.ndim >= 2       # the reference's rule
        with trace.span("adamw"):
            _, opt, metrics = optimizer.update(
                gb, AdamWState(step=state.opt.step, mu=mb, nu=vb), pb, db)
        del gb
        with torch.no_grad():
            for tree in (state.params, state.opt.mu, state.opt.nu):
                for _, placed in rules.tree_items(tree):
                    sync_counts["broadcasts"] += placed.sync_replicas()
        metrics = dict(metrics,
                       loss=torch.stack([l for l, _ in losses]).mean(),
                       aux_loss=torch.stack([a for _, a in losses]).mean())
        return MeshTrainState(
            params=state.params,
            opt=AdamWState(step=opt.step, mu=state.opt.mu, nu=state.opt.nu),
            step=state.step + 1, compute=state.compute,
            sync=state.sync), metrics

    return train_step


def _gather(model: tf.Transformer, leaves: list, names: dict) -> None:
    """Copy every leaf's blocks into ``model``'s parameters."""
    params = _named(model)
    for key, placed in leaves:
        for _, idx, block in placed.unique_blocks():
            for cycle, name in names[key]:
                if cycle is None:
                    params[name][idx].copy_(block)
                else:
                    params[name][idx[1:]].copy_(block[cycle])
        sync_counts["gathers"] += 1
        sync_counts["gather_bytes"] += int(np.prod(placed.shape)) * \
            placed.blocks.flat[0].element_size()


def _scatter(acc: dict, leaves: list, names: dict) -> dict:
    """The mean gradient ``acc`` (by parameter name; consumed) cut into
    each leaf's unique blocks, on the blocks' devices:
    ``{(key, coord): block}``."""
    out = {}
    for key, placed in leaves:
        cycles = names[key]
        for c, idx, block in placed.unique_blocks():
            if cycles[0][0] is None:
                g = acc[cycles[0][1]][idx]
            else:
                g = torch.stack([acc[name][idx[1:]]
                                 for _, name in sorted(cycles)])
            out[(key, c)] = g.to(block.device)
            sync_counts["scatter_bytes"] += _bytes(g)
        for _, name in cycles:
            del acc[name]
        sync_counts["scatters"] += 1
    return out
